// One output tile of C = A * B on the tensor cores through mma.sync
// m16n8k16 (bf16 in, fp32 accumulation): the streaming GEMM's
// (streaming_gemm.cu: gemm_bf16, split-K inside a thread-block cluster,
// forward and both backward products of training).
//
// The product is computed transposed, C^T = B^T A^T: the weight's N fills
// the mma's 16-row dimension and the tokens its n8 dimension.  A cluster
// of S CTAs shares one BM x BN tile; CTA r walks k-tiles [r*nk/S,
// (r+1)*nk/S) of 64 through a cp.async ring of 3-8 stages, parks its fp32
// partial in shared memory, and after a cluster barrier CTA r sums slice r
// of the tile over ranks 0..S-1 in that fixed order (distributed shared
// memory) and stores it once in bf16.  No atomics: the same bits on every
// run.  A launch without a cluster is a cluster of one CTA.
//
// Layouts: A row-major (element (m, k) at A[m*lda + k]) or M-contiguous
// (at A[k*lda + m]); B row-major (B[k*ldb + n]) or K-contiguous
// (B[n*ldb + k]).  Each operand is staged in chunks of 8 values along its
// contiguous dimension, copied by cp.async in pieces of `vb` bytes (16, 8
// or 4; the operand's base and its leading stride in bytes must be
// multiples of vb).  The default tile makes one 16-byte copy a chunk,
// which needs 16-byte aligned rows and a contiguous extent that is a
// multiple of 8 (an M-contiguous A: any M); the NARROW tile, a separate
// instantiation so that the default's loop stays as lean, copies in 16-,
// 8- or 4-byte pieces and takes a ragged contiguous extent: the MoE
// router's 60 columns (120 bytes).  Every edge of M, N and K is
// zero-filled by cp.async's src-size operand, so no row, column or k
// beyond the extents is ever read.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

namespace cg = cooperative_groups;

constexpr int BK = 64, PAD = 8, MMA_THREADS = 128, MAX_SPLITS = 8;
constexpr int RING_BUDGET = 64 * 1024;  // bytes of cp.async ring per CTA

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the first n of 16 bytes from gmem, the rest zero-filled (0 <= n <= 16)
__device__ __forceinline__ void cp_async16n(void* smem, const void* gmem,
                                            int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async8n(void* smem, const void* gmem,
                                           int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4n(void* smem, const void* gmem,
                                           int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ int clamp8(int n) { return min(max(n, 0), 8); }

// Stage the n (0 <= n <= 8) values at base + off into the 8-value chunk
// at smem, the rest zero-filled, in copies of vb bytes.  A copy of no
// value reads nothing (src-size 0) and is pointed at `base`.
__device__ __forceinline__ void cp_chunk(__nv_bfloat16* smem,
                                         const __nv_bfloat16* base,
                                         int64_t off, int n, int vb) {
  const __nv_bfloat16* g = base + off;
  if (vb == 16) {
    cp_async16n(smem, n ? g : base, 2 * n);
  } else if (vb == 8) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = min(max(n - 4 * j, 0), 4);
      cp_async8n(smem + 4 * j, e ? g + 4 * j : base, 2 * e);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = min(max(n - 2 * j, 0), 2);
      cp_async4n(smem + 2 * j, e ? g + 2 * j : base, 2 * e);
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Tile geometry of gemm_tile<BM, BN, B_KCONTIG, A_MCONTIG>.  Four warps:
// WM along the tokens, WN along the weight's N, and WK over the four k16
// steps of a k-tile (small tiles give each warp every other k16 step
// instead of idling warps); the WK partials are summed with the cluster's.
template <int BM, int BN, bool B_KCONTIG, bool A_MCONTIG = false>
struct Geo {
  static constexpr int WM = BM >= 32 ? 2 : 1;
  static constexpr int WN = BN / 16 < 4 / WM ? BN / 16 : 4 / WM;
  static constexpr int WK = 4 / (WM * WN);
  static constexpr int TM = BM / WM, TN = BN / WN;  // tokens, n per warp
  static constexpr int FM = TM / 8, FN = TN / 16;   // mma tiles per warp
  // row-major A is staged as [m][k]; M-contiguous A as [k][m]
  static constexpr int A_ROWS = A_MCONTIG ? BK : BM;
  static constexpr int A_LD = A_MCONTIG ? BM + PAD : BK + PAD;
  // K-contiguous B is staged as [n][k]; row-major B as [k][n]
  static constexpr int B_ROWS = B_KCONTIG ? BN : BK;
  static constexpr int B_LD = B_KCONTIG ? BK + PAD : BN + PAD;
  static constexpr int A_ELEMS = A_ROWS * A_LD, B_ELEMS = B_ROWS * B_LD;
  static constexpr int STAGE_BYTES = 2 * (A_ELEMS + B_ELEMS);
  static constexpr int S_RAW = RING_BUDGET / STAGE_BYTES;
  static constexpr int STAGES = S_RAW < 3 ? 3 : (S_RAW > 8 ? 8 : S_RAW);
  static constexpr int RED_LD = BN + 4;  // fp32 partial [WK][BM][RED_LD]
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int RED_BYTES = 4 * WK * BM * RED_LD;
  static constexpr int SMEM = RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
  static_assert(WM * WN * WK == 4 && TN % 16 == 0 && TM % 8 == 0, "tile");
};

// The output tile (blockIdx.y, blockIdx.x), BM x BN, of C = A * B (M x
// N, K deep), ldc the row stride of C; with NARROW, a_vb / b_vb are the
// copy widths of A and B.  The cluster's CTAs (along z) split K.  The
// caller's kernel declares its pointers __restrict__, as these are.
template <int BM, int BN, bool B_KCONTIG, bool A_MCONTIG, bool NARROW>
__device__ __forceinline__ void gemm_tile(const __nv_bfloat16* __restrict__ A,
                                          const __nv_bfloat16* __restrict__ B,
                                          __nv_bfloat16* __restrict__ C,
                                          int M, int N, int K, int64_t lda,
                                          int64_t ldb, int64_t ldc, int a_vb,
                                          int b_vb) {
  using G = Geo<BM, BN, B_KCONTIG, A_MCONTIG>;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(tile_smem);
  __nv_bfloat16* Bs = As + G::STAGES * G::A_ELEMS;
  float* red = reinterpret_cast<float*>(tile_smem);  // after the main loop

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

  // NARROW stages both operands through cp_chunk in copies of a_vb /
  // b_vb bytes, which also take a ragged contiguous extent; otherwise one
  // 16-byte copy a chunk, which needs 16-byte aligned rows and a
  // contiguous extent that is a multiple of 8 (an M-contiguous A: any M).
  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    __nv_bfloat16* as = As + stage * G::A_ELEMS;
    __nv_bfloat16* bs = Bs + stage * G::B_ELEMS;
    if constexpr (A_MCONTIG) {  // BK k-rows x BM/8 chunks of 8 along m
      for (int c = tid; c < BK * (BM / 8); c += MMA_THREADS) {
        const int row = c / (BM / 8), col = (c % (BM / 8)) * 8;
        const int gk = k0 + row, gm = m0 + col;
        const int n = gk < K ? clamp8(M - gm) : 0;
        if constexpr (NARROW)
          cp_chunk(as + row * G::A_LD + col, A, gk * lda + gm, n, a_vb);
        else
          cp_async16n(as + row * G::A_LD + col, n ? A + gk * lda + gm : A,
                      2 * n);
      }
    } else {                    // BM m-rows x 8 chunks of 8 along k
      for (int c = tid; c < BM * (BK / 8); c += MMA_THREADS) {
        const int row = c / (BK / 8), col = (c % (BK / 8)) * 8;
        const int gm = m0 + row, gk = k0 + col;
        if constexpr (NARROW) {
          cp_chunk(as + row * G::A_LD + col, A, gm * lda + gk,
                   gm < M ? clamp8(K - gk) : 0, a_vb);
        } else {
          const bool ok = gm < M && gk < K;
          cp_async16n(as + row * G::A_LD + col, ok ? A + gm * lda + gk : A,
                      ok ? 16 : 0);
        }
      }
    }
    if constexpr (B_KCONTIG) {  // BN n-rows x 8 chunks of 8 along k
      for (int c = tid; c < BN * (BK / 8); c += MMA_THREADS) {
        const int row = c / (BK / 8), col = (c % (BK / 8)) * 8;
        const int gn = n0 + row, gk = k0 + col;
        if constexpr (NARROW) {
          cp_chunk(bs + row * G::B_LD + col, B, gn * ldb + gk,
                   gn < N ? clamp8(K - gk) : 0, b_vb);
        } else {
          const bool ok = gn < N && gk < K;
          cp_async16n(bs + row * G::B_LD + col, ok ? B + gn * ldb + gk : B,
                      ok ? 16 : 0);
        }
      }
    } else {                    // BK k-rows x BN/8 chunks of 8 along n
      for (int c = tid; c < BK * (BN / 8); c += MMA_THREADS) {
        const int row = c / (BN / 8), col = (c % (BN / 8)) * 8;
        const int gk = k0 + row, gn = n0 + col;
        if constexpr (NARROW) {
          cp_chunk(bs + row * G::B_LD + col, B, gk * ldb + gn,
                   gk < K ? clamp8(N - gn) : 0, b_vb);
        } else {
          const bool ok = gk < K && gn < N;
          cp_async16n(bs + row * G::B_LD + col, ok ? B + gk * ldb + gn : B,
                      ok ? 16 : 0);
        }
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
      for (int j = 0; j < G::FM; ++j) {  // A^T cols = tokens: mma B
        if constexpr (A_MCONTIG)
          ldsm_x2_t(tf[j], as + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                    G::A_LD + wm * G::TM + j * 8);
        else
          ldsm_x2(tf[j], as + (wm * G::TM + j * 8 + (lane & 7)) * G::A_LD +
                             kk + ((lane >> 3) & 1) * 8);
      }
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

// Launch `kern` with MMA_THREADS threads, `smem` bytes of dynamic shared
// memory and clusters of `splits` CTAs along z; returns the launch's
// error code.
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

}  // namespace tile
