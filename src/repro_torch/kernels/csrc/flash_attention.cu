// Flash attention forward for Hopper (sm_90a): softmax(Q K^T / sqrt(D)) V
// with an online softmax, causal or full, over the (B, T, H, D) layout.
//
// One CTA of 128 threads owns a 32-row query block of one (batch, head)
// and walks 64-key K/V tiles staged in shared memory as fp32.  Four
// threads share a query row: each scores 16 keys and owns D/4 output
// columns.  Under the causal mask the key loop stops at the block's
// diagonal (tiles above it are never loaded).  Query head h reads KV head
// h / (H / KH), so GQA needs no repeated K/V.  Masked scores are -1e30,
// probabilities are rounded to V's dtype before the PV product (as the
// Pallas kernel does), and l is floored at 1e-30.
//
// Each launcher returns cudaGetLastError() of its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32, BKV = 64, THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int Tq, int Tk,
              int H, int KH, int64_t sqb, int64_t sqt, int64_t sqh,
              int64_t skb, int64_t skt, int64_t skh, int64_t svb,
              int64_t svt, int64_t svh, float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][D+1]
  float* Ks = Qs + BQ * (D + 1);       // [BKV][D+1]
  float* Vs = Ks + BKV * (D + 1);      // [BKV][D]
  float* Ps = Vs + BKV * D;            // [BQ][BKV+1]

  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + kh * skh;
  const T* vb = v + b * svb + kh * svh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, d = i % D, t = q0 + rr;
    Qs[rr * (D + 1) + d] = t < Tq ? to_f(qb[t * sqt + d]) : 0.f;
  }

  const int t = q0 + r;  // this thread's query position
  float m_i = NEG_INF, l_i = 0.f, acc[D / 4];
#pragma unroll
  for (int e = 0; e < D / 4; ++e) acc[e] = 0.f;

  const int kv_end = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // previous tile fully consumed (and Qs written)
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int j = i / D, d = i % D, key = k0 + j;
      const bool ok = key < Tk;
      Ks[j * (D + 1) + d] = ok ? to_f(kb[key * skt + d]) : 0.f;
      Vs[j * D + d] = ok ? to_f(vb[key * svt + d]) : 0.f;
    }
    __syncthreads();

    float s[BKV / 4];
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i) s[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = Qs[r * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < BKV / 4; ++i)
        s[i] += qd * Ks[(sub + 4 * i) * (D + 1) + d];
    }
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i) {
      const int key = k0 + sub + 4 * i;
      s[i] *= scale;
      if (key >= Tk || (causal && key > t)) s[i] = NEG_INF;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    const float corr = expf(m_i - m_new);
    float ps = 0.f;
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i) {
      const float p = expf(s[i] - m_new);
      ps += p;
      Ps[r * (BKV + 1) + sub + 4 * i] = round_as(p, T());
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l_i = l_i * corr + ps;
    m_i = m_new;
    __syncwarp();  // the row's four threads share one warp
#pragma unroll
    for (int e = 0; e < D / 4; ++e) acc[e] *= corr;
    for (int j = 0; j < BKV; ++j) {
      const float p = Ps[r * (BKV + 1) + j];
#pragma unroll
      for (int e = 0; e < D / 4; ++e) acc[e] += p * Vs[j * D + sub + 4 * e];
    }
  }

  if (t < Tq) {
    const float inv = 1.f / fmaxf(l_i, 1e-30f);
    T* ob = o + ((static_cast<int64_t>(b) * Tq + t) * H + h) * D;
#pragma unroll
    for (int e = 0; e < D / 4; ++e) store(&ob[sub + 4 * e], acc[e] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Tq, int Tk, int H, int KH, const int64_t* st, int causal,
           cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tq, Tk, H, KH, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      1.0f / sqrtf(static_cast<float>(D)), causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int Tq, int Tk, int H, int KH, const int64_t* st,
               int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Tq, Tk, H, KH, st, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Tq, Tk, H, KH, st, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Tq, Tk, H, KH, st, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Tq, Tk, H, KH, st, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides (elements, unit stride on D):
// [q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h]; o is contiguous
// (B, Tq, H, D).  dtype: 0 = float32, 1 = bfloat16.
extern "C" int fa_forward(int dtype, const void* q, const void* k,
                          const void* v, void* o, int B, int Tq, int Tk,
                          int H, int KH, int D, const int64_t* strides,
                          int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, Tq, Tk, H, KH, strides,
                             causal, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Tq, Tk, H, KH,
                                     strides, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
