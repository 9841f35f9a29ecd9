// MatrixFlow streaming GEMM for Hopper (sm_90a): C = A * B.  Replaces the
// Pallas kernel _gemm_kernel of src/repro/kernels/streaming_gemm.py.
//
// On the H100 every main-path shape is bound by bytes (decode M <= 8
// reads each weight byte for a handful of rows); what holds a kernel
// back at these sizes is memory-level parallelism: enough CTAs, and
// enough bytes in flight in each, to cover the memory latency.
//
// Two kernels:
//  * gemm_bf16 — bf16 inputs, fp32 accumulation on the tensor cores
//    through mma.sync m16n8k16, split-K inside a thread-block cluster.
//    The product is computed transposed, C^T = B^T A^T: the weight's N
//    fills the mma's 16-row dimension and the tokens fill its n8
//    dimension, so a decode tile of 8 tokens stages 8 rows of A and
//    wastes no mma work on zero rows.  A cluster of S CTAs (S <= 8,
//    grid z) shares one BM x BN output tile; CTA r walks k-tiles
//    [r*nk/S, (r+1)*nk/S) of 64 (128-byte rows along K) through a
//    cp.async ring of 3-8 stages (as many as 64 KB holds), with ldmatrix
//    fragments (ldmatrix.trans for row-major B).  Each CTA parks its
//    fp32 partial in its own shared memory; after a cluster barrier, CTA
//    r sums slice r of the tile over ranks 0..S-1 in that fixed order,
//    read through distributed shared memory, and stores it once in bf16.
//    One launch, no workspace, no atomics: the result is the same bits
//    on every run.  B is read either row-major (K x N, N contiguous) or
//    K-contiguous (element (k, n) at B[n*ldb + k]), so the tied lm_head
//    reads embed^T in place.  Needs 16-byte aligned rows along the
//    contiguous dimension; ragged M / N / K edges are zero-filled by
//    cp.async's src-size operand.  The tile (BM, BN) and the split S
//    come from the caller (``plan`` in streaming_gemm.py).
//  * gemm_simt — any strides, fp32 / bf16 / int8 inputs, scalar FMA
//    with an fp32 (int32 for int8) accumulator: full fp32 for fp32
//    inputs (no TF32) and exact int8 sums that wrap on the int8 store.
//
// The expert-grouped products of the MoE layers run on a kernel of their
// own (grouped_gemm.cu).
//
// Each launcher returns cudaGetLastError() of its launch.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 64, PAD = 8, MMA_THREADS = 128, MAX_SPLITS = 8;
constexpr int RING_BUDGET = 64 * 1024;  // bytes of cp.async ring per CTA

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Tile geometry of gemm_bf16<BM, BN, B_KCONTIG>.  Four warps: WM along
// the tokens, WN along the weight's N, and WK over the four k16 steps of
// a k-tile (small tiles give each warp every other k16 step instead of
// idling warps); the WK partials are summed with the cluster's.
template <int BM, int BN, bool B_KCONTIG>
struct Geo {
  static constexpr int WM = BM >= 32 ? 2 : 1;
  static constexpr int WN = BN / 16 < 4 / WM ? BN / 16 : 4 / WM;
  static constexpr int WK = 4 / (WM * WN);
  static constexpr int TM = BM / WM, TN = BN / WN;  // tokens, n per warp
  static constexpr int FM = TM / 8, FN = TN / 16;   // mma tiles per warp
  static constexpr int A_LD = BK + PAD;
  // K-contiguous B is staged as [n][k]; row-major B as [k][n]
  static constexpr int B_ROWS = B_KCONTIG ? BN : BK;
  static constexpr int B_LD = B_KCONTIG ? BK + PAD : BN + PAD;
  static constexpr int A_ELEMS = BM * A_LD, B_ELEMS = B_ROWS * B_LD;
  static constexpr int STAGE_BYTES = 2 * (A_ELEMS + B_ELEMS);
  static constexpr int S_RAW = RING_BUDGET / STAGE_BYTES;
  static constexpr int STAGES = S_RAW < 3 ? 3 : (S_RAW > 8 ? 8 : S_RAW);
  static constexpr int RED_LD = BN + 4;  // fp32 partial [WK][BM][RED_LD]
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int RED_BYTES = 4 * WK * BM * RED_LD;
  static constexpr int SMEM = RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
  static_assert(WM * WN * WK == 4 && TN % 16 == 0 && TM % 8 == 0, "tile");
};

// One output tile of C = A * B.
template <int BM, int BN, bool B_KCONTIG>
__device__ __forceinline__ void gemm_tile(const __nv_bfloat16* __restrict__ A,
                                          const __nv_bfloat16* __restrict__ B,
                                          __nv_bfloat16* __restrict__ C,
                                          int M, int N, int K, int64_t lda,
                                          int64_t ldb, int64_t ldc) {
  using G = Geo<BM, BN, B_KCONTIG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + G::STAGES * G::A_ELEMS;
  float* red = reinterpret_cast<float*>(smem_raw);  // after the main loop

  const int mt = blockIdx.y;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int wk = warp % G::WK, wn = (warp / G::WK) % G::WN,
            wm = warp / (G::WK * G::WN);
  const int m0 = mt * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  const int kt0 = rank * nk / splits, kt1 = (rank + 1) * nk / splits;
  const int nt = kt1 - kt0;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    __nv_bfloat16* as = As + stage * G::A_ELEMS;
    __nv_bfloat16* bs = Bs + stage * G::B_ELEMS;
    for (int c = tid; c < BM * (BK / 8); c += MMA_THREADS) {
      const int row = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const int gm = m0 + row, gk = k0 + col;
      const bool ok = gm < M && gk < K;
      cp_async16(as + row * G::A_LD + col, ok ? A + gm * lda + gk : A, ok);
    }
    if constexpr (B_KCONTIG) {  // BN n-rows x 8 chunks of 8 along k
      for (int c = tid; c < BN * (BK / 8); c += MMA_THREADS) {
        const int row = c / (BK / 8), col = (c % (BK / 8)) * 8;
        const int gn = n0 + row, gk = k0 + col;
        const bool ok = gn < N && gk < K;
        cp_async16(bs + row * G::B_LD + col, ok ? B + gn * ldb + gk : B, ok);
      }
    } else {                    // BK k-rows x BN/8 chunks of 8 along n
      for (int c = tid; c < BK * (BN / 8); c += MMA_THREADS) {
        const int row = c / (BN / 8), col = (c % (BN / 8)) * 8;
        const int gk = k0 + row, gn = n0 + col;
        const bool ok = gk < K && gn < N;
        cp_async16(bs + row * G::B_LD + col, ok ? B + gk * ldb + gn : B, ok);
      }
    }
  };

  float acc[G::FN][G::FM][4];
#pragma unroll
  for (int i = 0; i < G::FN; ++i)
#pragma unroll
    for (int j = 0; j < G::FM; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < nt) load_tile(s, kt0 + s);
    cp_async_commit();  // possibly empty: keeps the group count uniform
  }
  for (int it = 0; it < nt; ++it) {
    cp_async_wait<G::STAGES - 2>();  // tile it has landed
    __syncthreads();                 // ... for every thread; stage
                                     // (it - 1) % STAGES is free again
    const int nx = it + G::STAGES - 1;
    if (nx < nt) load_tile(nx % G::STAGES, kt0 + nx);
    cp_async_commit();
    const __nv_bfloat16* as = As + (it % G::STAGES) * G::A_ELEMS;
    const __nv_bfloat16* bs = Bs + (it % G::STAGES) * G::B_ELEMS;
#pragma unroll
    for (int ks = wk; ks < BK / 16; ks += G::WK) {
      const int kk = ks * 16;
      uint32_t wf[G::FN][4], tf[G::FM][2];
#pragma unroll
      for (int i = 0; i < G::FN; ++i) {  // B^T rows n, cols k: mma A
        const int nb = wn * G::TN + i * 16;
        if constexpr (B_KCONTIG) {
          ldsm_x4(wf[i], bs + (nb + (lane & 15)) * G::B_LD + kk +
                             (lane >> 4) * 8);
        } else {
          const int mat = lane >> 3;
          ldsm_x4_t(wf[i], bs + (kk + (lane & 7) + (mat >> 1) * 8) * G::B_LD +
                               nb + (mat & 1) * 8);
        }
      }
#pragma unroll
      for (int j = 0; j < G::FM; ++j)  // A^T cols = tokens: mma B
        ldsm_x2(tf[j], as + (wm * G::TM + j * 8 + (lane & 7)) * G::A_LD +
                           kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < G::FN; ++i)
#pragma unroll
        for (int j = 0; j < G::FM; ++j) mma_bf16(acc[i][j], wf[i], tf[j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is dead: reuse it for the partials

  // acc[i][j]: rows n (g, g + 8) x cols tokens (2 tig, 2 tig + 1)
  float* mine = red + wk * BM * G::RED_LD;
#pragma unroll
  for (int i = 0; i < G::FN; ++i)
#pragma unroll
    for (int j = 0; j < G::FM; ++j) {
      const int n = wn * G::TN + i * 16 + g, t = wm * G::TM + j * 8 + 2 * tig;
      mine[t * G::RED_LD + n] = acc[i][j][0];
      mine[(t + 1) * G::RED_LD + n] = acc[i][j][1];
      mine[t * G::RED_LD + n + 8] = acc[i][j][2];
      mine[(t + 1) * G::RED_LD + n + 8] = acc[i][j][3];
    }
  cluster.sync();  // every CTA's partial is written and visible

  // CTA `rank` finishes pairs [rank*P/S, (rank+1)*P/S) of the tile,
  // summing ranks 0..S-1 (and their WK warp partials) in fixed order.
  constexpr int P = BM * BN / 2;
  const int p0 = rank * P / splits, p1 = (rank + 1) * P / splits;
  for (int p = p0 + tid; p < p1; p += MMA_THREADS) {
    const int t = (2 * p) / BN, n = (2 * p) % BN;
    float2 v[MAX_SPLITS][G::WK];  // all loads in flight before the sums
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) {
        const float* peer = r == rank ? red : cluster.map_shared_rank(red, r);
#pragma unroll
        for (int w = 0; w < G::WK; ++w)
          v[r][w] = *reinterpret_cast<const float2*>(
              peer + (w * BM + t) * G::RED_LD + n);
      }
    float2 sum = make_float2(0.f, 0.f);
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) {
#pragma unroll
        for (int w = 0; w < G::WK; ++w) {
          sum.x += v[r][w].x;
          sum.y += v[r][w].y;
        }
      }
    const int gm = m0 + t, gn = n0 + n;
    if (gm >= M || gn >= N) continue;
    __nv_bfloat16* c = C + gm * ldc + gn;
    if (gn + 1 < N && (reinterpret_cast<uintptr_t>(c) & 3) == 0) {
      *reinterpret_cast<__nv_bfloat162*>(c) = __floats2bfloat162_rn(sum.x,
                                                                    sum.y);
    } else {
      c[0] = __float2bfloat16(sum.x);
      if (gn + 1 < N) c[1] = __float2bfloat16(sum.y);
    }
  }
  cluster.sync();  // no CTA leaves while a peer still reads its partial
}

template <int BM, int BN, bool B_KCONTIG>
__global__ void __launch_bounds__(MMA_THREADS)
    gemm_bf16(const __nv_bfloat16* __restrict__ A,
              const __nv_bfloat16* __restrict__ B,
              __nv_bfloat16* __restrict__ C, int M, int N, int K,
              int64_t lda, int64_t ldb, int64_t ldc) {
  gemm_tile<BM, BN, B_KCONTIG>(A, B, C, M, N, K, lda, ldb, ldc);
}

// Launch a cluster kernel of `splits` CTAs along z with `smem` bytes of
// dynamic shared memory; returns the launch's error code.
template <typename Kern, typename... Args>
int launch_cluster(Kern kern, int smem, dim3 grid, int splits,
                   cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(MMA_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = splits;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, bool B_KCONTIG>
int launch_bf16(const void* A, const void* B, void* C, int M, int N, int K,
                int64_t lda, int64_t ldb, int64_t ldc, int splits,
                cudaStream_t st) {
  using G = Geo<BM, BN, B_KCONTIG>;
  auto kern = gemm_bf16<BM, BN, B_KCONTIG>;
  // once per instantiation and process (the port drives one card)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return launch_cluster(
      kern, G::SMEM, dim3((N + BN - 1) / BN, (M + BM - 1) / BM, splits),
      splits, st, static_cast<const __nv_bfloat16*>(A),
      static_cast<const __nv_bfloat16*>(B), static_cast<__nv_bfloat16*>(C),
      M, N, K, lda, ldb, ldc);
}

template <int BM, bool KC>
int dispatch_bn(int bn, const void* A, const void* B, void* C, int M, int N,
                int K, int64_t lda, int64_t ldb, int64_t ldc, int splits,
                cudaStream_t st) {
  switch (bn) {
    case 32: return launch_bf16<BM, 32, KC>(A, B, C, M, N, K, lda, ldb, ldc, splits, st);
    case 64: return launch_bf16<BM, 64, KC>(A, B, C, M, N, K, lda, ldb, ldc, splits, st);
    case 128: return launch_bf16<BM, 128, KC>(A, B, C, M, N, K, lda, ldb, ldc, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool KC>
int dispatch_bm(int bm, int bn, const void* A, const void* B, void* C, int M,
                int N, int K, int64_t lda, int64_t ldb, int64_t ldc,
                int splits, cudaStream_t st) {
  switch (bm) {
    case 8: return dispatch_bn<8, KC>(bn, A, B, C, M, N, K, lda, ldb, ldc, splits, st);
    case 16: return dispatch_bn<16, KC>(bn, A, B, C, M, N, K, lda, ldb, ldc, splits, st);
    case 32: return dispatch_bn<32, KC>(bn, A, B, C, M, N, K, lda, ldb, ldc, splits, st);
    case 64: return dispatch_bn<64, KC>(bn, A, B, C, M, N, K, lda, ldb, ldc, splits, st);
    case 128: return dispatch_bn<128, KC>(bn, A, B, C, M, N, K, lda, ldb, ldc, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------------ SIMT path
__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ int to_acc(int8_t x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(int8_t* p, int v) {
  *p = static_cast<int8_t>(v & 0xff);  // wraps like astype(int8)
}

constexpr int TM = 64, TN = 64, TK = 16, SIMT_THREADS = 256;

template <typename T, typename Acc>
__global__ void __launch_bounds__(SIMT_THREADS)
    gemm_simt(const T* __restrict__ A, const T* __restrict__ B,
              T* __restrict__ C, int M, int N, int K, int64_t sam,
              int64_t sak, int64_t sbk, int64_t sbn, int64_t ldc) {
  __shared__ Acc As[TK][TM + 1];
  __shared__ Acc Bs[TK][TN + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  Acc acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int i = threadIdx.x; i < TM * TK; i += SIMT_THREADS) {
      const int m = i / TK, k = i % TK, gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? to_acc(A[gm * sam + gk * sak]) : Acc(0);
    }
    for (int i = threadIdx.x; i < TK * TN; i += SIMT_THREADS) {
      const int k = i / TN, n = i % TN, gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? to_acc(B[gk * sbk + gn * sbn]) : Acc(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      Acc a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[k][ty + 16 * i];
        b[i] = Bs[k][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) store(&C[gm * ldc + gn], acc[i][j]);
    }
}

}  // namespace

// The tile (bm x bn, bk), the split and the layout come from the caller;
// bk must be 64 and 1 <= splits <= 8.
extern "C" int sg_gemm_bf16(const void* A, const void* B, void* C, int M,
                            int N, int K, int64_t lda, int64_t ldb,
                            int b_kcontig, int64_t ldc, int bm, int bn,
                            int bk, int splits, void* stream) {
  if (bk != BK || splits < 1 || splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_kcontig)
    return dispatch_bm<true>(bm, bn, A, B, C, M, N, K, lda, ldb, ldc, splits,
                             st);
  return dispatch_bm<false>(bm, bn, A, B, C, M, N, K, lda, ldb, ldc, splits,
                            st);
}

// dtype: 0 = float32, 1 = bfloat16, 2 = int8
extern "C" int sg_gemm_simt(int dtype, const void* A, const void* B, void* C,
                            int M, int N, int K, int64_t sam, int64_t sak,
                            int64_t sbk, int64_t sbn, int64_t ldc,
                            void* stream) {
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    gemm_simt<float, float><<<grid, SIMT_THREADS, 0, st>>>(
        static_cast<const float*>(A), static_cast<const float*>(B),
        static_cast<float*>(C), M, N, K, sam, sak, sbk, sbn, ldc);
  else if (dtype == 1)
    gemm_simt<__nv_bfloat16, float><<<grid, SIMT_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(A),
        static_cast<const __nv_bfloat16*>(B), static_cast<__nv_bfloat16*>(C),
        M, N, K, sam, sak, sbk, sbn, ldc);
  else if (dtype == 2)
    gemm_simt<int8_t, int><<<grid, SIMT_THREADS, 0, st>>>(
        static_cast<const int8_t*>(A), static_cast<const int8_t*>(B),
        static_cast<int8_t*>(C), M, N, K, sam, sak, sbk, sbn, ldc);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
