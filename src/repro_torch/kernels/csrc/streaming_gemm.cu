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
//    reads embed^T in place.  A is read either row-major (M x K, K
//    contiguous) or M-contiguous (element (m, k) at A[k*lda + m]), the
//    mirror of the K-contiguous B: staged as [k][m] and fragmented by
//    ldmatrix.trans, so the weight gradient dW = X^T dY reads the layer
//    input X in place (the backward products of the autograd Function in
//    ops.py).  The M-contiguous A goes with a row-major B only.  Each
//    operand is staged in cp.async copies of 16 bytes where its rows are
//    16-byte aligned, else of 8 or 4 (the MoE router's 60-wide rows of
//    120 bytes take 8-byte copies: its forward product and both backward
//    products run here); ragged M / N / K edges are zero-filled by
//    cp.async's src-size operand.  The tile code is shared with the
//    grouped GEMM's backward kernels (mma_tile.cuh).  The tile (BM, BN)
//    and the split S come from the caller (``plan`` in
//    streaming_gemm.py).
//  * gemm_simt — any strides, fp32 / bf16 / int8 inputs, scalar FMA
//    with an fp32 (int32 for int8) accumulator: full fp32 for fp32
//    inputs (no TF32) and exact int8 sums that wrap on the int8 store.
//    bf16 reaches it only with rows not even 4-byte aligned, and never
//    from the autograd Function.
//
// The expert-grouped products of the MoE layers run on a kernel of their
// own (grouped_gemm.cu).
//
// Each launcher returns cudaGetLastError() of its launch.
#include "mma_tile.cuh"

namespace {

using tile::BK;
using tile::Geo;
using tile::MAX_SPLITS;
using tile::MMA_THREADS;

// One call's operands and launch parameters.
struct Call {
  const __nv_bfloat16* A;
  const __nv_bfloat16* B;
  __nv_bfloat16* C;
  int M, N, K;
  int64_t lda, ldb, ldc;
  int a_vb, b_vb, splits;
  cudaStream_t st;
};

template <int BM, int BN, bool B_KCONTIG, bool A_MCONTIG, bool NARROW>
__global__ void __launch_bounds__(MMA_THREADS)
    gemm_bf16(const __nv_bfloat16* __restrict__ A,
              const __nv_bfloat16* __restrict__ B,
              __nv_bfloat16* __restrict__ C, int M, int N, int K,
              int64_t lda, int64_t ldb, int64_t ldc, int a_vb, int b_vb) {
  tile::gemm_tile<BM, BN, B_KCONTIG, A_MCONTIG, NARROW>(
      A, B, C, M, N, K, lda, ldb, ldc, a_vb, b_vb);
}

template <int BM, int BN, bool B_KCONTIG, bool A_MCONTIG, bool NARROW>
int launch_bf16(const Call& c) {
  using G = Geo<BM, BN, B_KCONTIG, A_MCONTIG>;
  auto kern = gemm_bf16<BM, BN, B_KCONTIG, A_MCONTIG, NARROW>;
  // once per instantiation and process (the port drives one card)
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return tile::launch_cluster(
      kern, G::SMEM,
      dim3((c.N + BN - 1) / BN, (c.M + BM - 1) / BM, c.splits), c.splits,
      c.st, c.A, c.B, c.C, c.M, c.N, c.K, c.lda, c.ldb, c.ldc, c.a_vb,
      c.b_vb);
}

// The M-contiguous A mode (MC) and the narrow copies (NW) take the
// plan's 64- and 128-wide tiles only: their products need no more.
template <int BM, bool KC, bool MC, bool NW>
int dispatch_bn(int bn, const Call& c) {
  switch (bn) {
    case 32:
      if constexpr (MC || NW) return static_cast<int>(cudaErrorInvalidValue);
      else return launch_bf16<BM, 32, KC, MC, NW>(c);
    case 64: return launch_bf16<BM, 64, KC, MC, NW>(c);
    case 128: return launch_bf16<BM, 128, KC, MC, NW>(c);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool KC, bool MC, bool NW>
int dispatch_bm(int bm, int bn, const Call& c) {
  switch (bm) {
    case 8: return dispatch_bn<8, KC, MC, NW>(bn, c);
    case 16: return dispatch_bn<16, KC, MC, NW>(bn, c);
    case 32: return dispatch_bn<32, KC, MC, NW>(bn, c);
    case 64: return dispatch_bn<64, KC, MC, NW>(bn, c);
    case 128: return dispatch_bn<128, KC, MC, NW>(bn, c);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool NW>
int dispatch_mode(int a_mcontig, int b_kcontig, int bm, int bn,
                  const Call& c) {
  if (a_mcontig) return dispatch_bm<false, true, NW>(bm, bn, c);
  if (b_kcontig) return dispatch_bm<true, false, NW>(bm, bn, c);
  return dispatch_bm<false, false, NW>(bm, bn, c);
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

// The tile (bm x bn, bk), the split, the layouts and the copy widths come
// from the caller; bk must be 64, 1 <= splits <= 8, a_vb and b_vb each 16,
// 8 or 4 (bytes that divide the operand's base address and its leading
// stride in bytes; 16 only with a contiguous extent that is a multiple of
// 8, an M-contiguous A's any M); an M-contiguous A (a_mcontig) needs a
// row-major B; a width under 16 takes the narrow tile, 64 or 128 wide.
extern "C" int sg_gemm_bf16(const void* A, const void* B, void* C, int M,
                            int N, int K, int64_t lda, int64_t ldb,
                            int a_mcontig, int b_kcontig, int64_t ldc,
                            int bm, int bn, int bk, int splits, int a_vb,
                            int b_vb, void* stream) {
  auto width_ok = [](int vb) { return vb == 16 || vb == 8 || vb == 4; };
  if (bk != BK || splits < 1 || splits > MAX_SPLITS ||
      (a_mcontig && b_kcontig) || !width_ok(a_vb) || !width_ok(b_vb))
    return static_cast<int>(cudaErrorInvalidValue);
  const Call c{static_cast<const __nv_bfloat16*>(A),
               static_cast<const __nv_bfloat16*>(B),
               static_cast<__nv_bfloat16*>(C), M, N, K, lda, ldb, ldc,
               a_vb, b_vb, splits, static_cast<cudaStream_t>(stream)};
  // 16-byte copies of both operands take the default tile, any narrower
  // copy the narrow one
  if (a_vb == 16 && b_vb == 16)
    return dispatch_mode<false>(a_mcontig, b_kcontig, bm, bn, c);
  return dispatch_mode<true>(a_mcontig, b_kcontig, bm, bn, c);
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
