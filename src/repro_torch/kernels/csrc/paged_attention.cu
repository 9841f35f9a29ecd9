// Paged decode attention for Hopper (sm_90a): one query token per
// sequence against K/V held in a global page pool, reached through a
// per-sequence page table (the paper's SMMU translation step).
//
// One CTA of 128 threads per (sequence, KV head) serves all G = H / KH
// query heads of that group, so each K/V page is read from device memory
// once.  The CTA reads its own table row and length, and loops only over
// the ceil(len / page) pages that hold tokens: pages past len are never
// loaded.  Each page is staged in shared memory as fp32; scores, the
// online-softmax statistics and the output accumulator stay fp32, and
// probabilities are not rounded before PV (as in the Pallas kernel).
// Positions >= len score -1e30; len = 0 gives zeros.  G need not be a
// power of two: heads and output elements are spread over the threads
// by flat index.
//
// Each launcher returns cudaGetLastError() of its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_E = 16;  // output elements per thread: G * D <= 2048
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    paged_fwd(const T* __restrict__ q, const T* __restrict__ kp,
              const T* __restrict__ vp, const int* __restrict__ table,
              const int* __restrict__ lens, T* __restrict__ o, int H, int KH,
              int D, int page, int max_pages, float scale) {
  extern __shared__ float smem[];
  const int G = H / KH;
  float* qs = smem;                   // [G][D]
  float* ks = qs + G * D;             // [page][D+1]
  float* vs = ks + page * (D + 1);    // [page][D]
  float* ss = vs + page * D;          // [G][page] scores, then p
  float* mi = ss + G * page;          // [G]
  float* li = mi + G;                 // [G]
  float* corr = li + G;               // [G]

  const int tid = threadIdx.x, kh = blockIdx.x, b = blockIdx.y;
  const int len = lens[b];
  const int n_pages = (len + page - 1) / page;
  const T* qb = q + (static_cast<int64_t>(b) * H + kh * G) * D;

  for (int i = tid; i < G * D; i += THREADS) qs[i] = to_f(qb[i]);
  for (int g = tid; g < G; g += THREADS) {
    mi[g] = NEG_INF;
    li[g] = 0.f;
  }
  float acc[MAX_E];
#pragma unroll
  for (int i = 0; i < MAX_E; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int p = 0; p < n_pages; ++p) {
    const int64_t pid = table[static_cast<int64_t>(b) * max_pages + p];
    const int64_t base = pid * page * KH * D;
    for (int i = tid; i < page * D; i += THREADS) {
      const int t = i / D, d = i % D;
      const int64_t src = base + (static_cast<int64_t>(t) * KH + kh) * D + d;
      ks[t * (D + 1) + d] = to_f(kp[src]);
      vs[t * D + d] = to_f(vp[src]);
    }
    __syncthreads();
    for (int i = tid; i < G * page; i += THREADS) {
      const int g = i / page, t = i % page;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += qs[g * D + d] * ks[t * (D + 1) + d];
      ss[i] = p * page + t < len ? dot * scale : NEG_INF;
    }
    __syncthreads();
    for (int g = tid; g < G; g += THREADS) {
      float* sg = ss + g * page;
      float mx = NEG_INF;
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, sg[t]);
      const float m_new = fmaxf(mi[g], mx);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float e = expf(sg[t] - m_new);
        sg[t] = e;
        sum += e;
      }
      const float c = expf(mi[g] - m_new);
      corr[g] = c;
      li[g] = li[g] * c + sum;
      mi[g] = m_new;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAX_E; ++j) {
      const int e = tid + j * THREADS;
      if (e < G * D) {
        const int g = e / D, d = e % D;
        const float* pg = ss + g * page;
        float a = acc[j] * corr[g];
        for (int t = 0; t < page; ++t) a += pg[t] * vs[t * D + d];
        acc[j] = a;
      }
    }
    __syncthreads();  // ks / vs / ss are refilled by the next page
  }

  T* ob = o + (static_cast<int64_t>(b) * H + kh * G) * D;
#pragma unroll
  for (int j = 0; j < MAX_E; ++j) {
    const int e = tid + j * THREADS;
    if (e < G * D) store(&ob[e], acc[j] / fmaxf(li[e / D], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* lens, void* o, int B, int H, int KH, int D, int page,
           int max_pages, cudaStream_t stream) {
  const int G = H / KH;
  const size_t bytes =
      (G * D + page * (D + 1) + page * D + G * page + 3 * G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(KH, B);
  paged_fwd<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lens, static_cast<T*>(o), H, KH, D,
      page, max_pages, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, H, D); pools: (P, page, KH, D); table: (B, max_pages) int32;
// lens: (B,) int32; o: (B, H, D) — all contiguous and on the device.
// dtype: 0 = float32, 1 = bfloat16.  Needs (H / KH) * D <= 2048.
extern "C" int pa_forward(int dtype, const void* q, const void* kp,
                          const void* vp, const void* table,
                          const void* lens, void* o, int B, int H, int KH,
                          int D, int page, int max_pages, void* stream) {
  if ((H / KH) * D > MAX_E * THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto tb = static_cast<const int*>(table);
  auto ln = static_cast<const int*>(lens);
  if (dtype == 0)
    return launch<float>(q, kp, vp, tb, ln, o, B, H, KH, D, page, max_pages,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kp, vp, tb, ln, o, B, H, KH, D, page,
                                 max_pages, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
