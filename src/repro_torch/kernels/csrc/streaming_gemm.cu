// MatrixFlow streaming GEMM for Hopper (sm_90a): C = A * B.
//
// Two kernels:
//  * gemm_bf16_mma — bf16 inputs, fp32 accumulation on the tensor cores
//    through mma.sync m16n8k16.  A 64x64 output tile per CTA walks K in
//    32-deep tiles; a cp.async double buffer (stages 0/1 = the paper's
//    A0/A1, B0/B1) loads tile k+1 while tile k is multiplied.  B is read
//    either row-major (K x N, N contiguous) or K-contiguous (element
//    (k, n) at B[n*ldb + k]), so the tied lm_head reads embed^T in place.
//    Needs 16-byte aligned rows along the contiguous dimension; ragged
//    M / N / K tile edges are zero-filled by cp.async's src-size operand.
//  * gemm_simt — any strides, fp32 / bf16 / int8 inputs, scalar FMA
//    with an fp32 (int32 for int8) accumulator: full fp32 for fp32
//    inputs (no TF32) and exact int8 sums that wrap on the int8 store.
//
// Each launcher returns cudaGetLastError() of its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32, PAD = 8, MMA_THREADS = 128;

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

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

template <bool B_KCONTIG>
struct BTile {
  // K-contiguous B is staged as [n][k]; row-major B as [k][n]
  static constexpr int ROWS = B_KCONTIG ? BN : BK;
  static constexpr int COLS = B_KCONTIG ? BK + PAD : BN + PAD;
};

template <bool B_KCONTIG>
__global__ void __launch_bounds__(MMA_THREADS)
    gemm_bf16_mma(const __nv_bfloat16* __restrict__ A,
                  const __nv_bfloat16* __restrict__ B,
                  __nv_bfloat16* __restrict__ C, int M, int N, int K,
                  int64_t lda, int64_t ldb, int64_t ldc) {
  __shared__ __align__(16) __nv_bfloat16 As[2][BM][BK + PAD];
  __shared__ __align__(16)
      __nv_bfloat16 Bs[2][BTile<B_KCONTIG>::ROWS][BTile<B_KCONTIG>::COLS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;      // mma fragment coordinates
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // A: 64 rows x 4 chunks of 8
      int c = tid + i * MMA_THREADS;
      int row = c >> 2, col = (c & 3) * 8;
      int gm = m0 + row, gk = k0 + col;
      bool ok = gm < M && gk < K;
      cp_async16(&As[stage][row][col], ok ? A + gm * lda + gk : A, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int c = tid + i * MMA_THREADS;
      if constexpr (B_KCONTIG) {  // 64 n-rows x 4 chunks of 8 along k
        int row = c >> 2, col = (c & 3) * 8;
        int gn = n0 + row, gk = k0 + col;
        bool ok = gn < N && gk < K;
        cp_async16(&Bs[stage][row][col], ok ? B + gn * ldb + gk : B, ok);
      } else {          // 32 k-rows x 8 chunks of 8 along n
        int row = c >> 3, col = (c & 7) * 8;
        int gk = k0 + row, gn = n0 + col;
        bool ok = gk < K && gn < N;
        cp_async16(&Bs[stage][row][col], ok ? B + gk * ldb + gn : B, ok);
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  const int nk = (K + BK - 1) / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk) load_tile(s ^ 1, (kt + 1) * BK);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait1();   // tile kt has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + g, c = kk + tig * 2;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[s][r][c]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[s][r + 8][c]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[s][r][c + 8]);
        af[mi][3] =
            *reinterpret_cast<const uint32_t*>(&As[s][r + 8][c + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + g, k = kk + tig * 2;
        if constexpr (B_KCONTIG) {
          bfr[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[s][n][k]);
          bfr[ni][1] =
              *reinterpret_cast<const uint32_t*>(&Bs[s][n][k + 8]);
        } else {
          bfr[ni][0] = pack2(Bs[s][k][n], Bs[s][k + 1][n]);
          bfr[ni][1] = pack2(Bs[s][k + 8][n], Bs[s][k + 9][n]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();  // stage s is refilled by the next iteration's load
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = m0 + wm + mi * 16 + g;
      const int c = n0 + wn + ni * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + h * 8;
        if (rr >= M) continue;
        if (c < N) C[rr * ldc + c] = __float2bfloat16(acc[mi][ni][2 * h]);
        if (c + 1 < N)
          C[rr * ldc + c + 1] = __float2bfloat16(acc[mi][ni][2 * h + 1]);
      }
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

extern "C" int sg_gemm_bf16_mma(const void* A, const void* B, void* C, int M,
                                int N, int K, int64_t lda, int64_t ldb,
                                int b_kcontig, int64_t ldc, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const __nv_bfloat16*>(A);
  auto b = static_cast<const __nv_bfloat16*>(B);
  auto c = static_cast<__nv_bfloat16*>(C);
  if (b_kcontig)
    gemm_bf16_mma<true><<<grid, MMA_THREADS, 0, st>>>(a, b, c, M, N, K, lda,
                                                      ldb, ldc);
  else
    gemm_bf16_mma<false><<<grid, MMA_THREADS, 0, st>>>(a, b, c, M, N, K, lda,
                                                       ldb, ldc);
  return static_cast<int>(cudaGetLastError());
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
