// Fused INT8 KV quantize-and-append for Hopper (sm_90a): one decode
// step's (n, KH, D) bf16 K and V, or a prompt's rows, quantized per
// (token, KV head) and written at their flat pool rows, codes and fp16
// scales of both K and V in one launch.  No Pallas original: the
// reference quantizes in XLA (src/repro/models/layers.py:264-277 at
// decode, models/decoding.py:275-292 at prefill) and scatters into its
// contiguous cache; without this kernel each layer of a decode step
// would take about a dozen small torch ops (abs, amax, the scale's
// arithmetic, the quotient, round, cast and four scatters).
//
// What bounds it on the H100: bytes, and at decode sizes latency.  At
// qwen1.5-32b's decode step (8 tokens of 40 KV heads of 128) it reads
// 160 KB of bf16 and writes 80 KB of codes and 1.3 KB of scales; one
// launch of 640 groups is a few microseconds of fixed cost.  The design
// is one pass: a group of D / 8 lanes takes one (tensor, token, KV head)
// row, each lane loading 16 bytes (8 values), so a row's max |x| is a
// shuffle reduction inside the group and every lane writes its 8 codes
// as one 8-byte store; the group's first lane writes the scale.
//
// Arithmetic, bit for bit as the plain version (kernels/ref.py
// kv_quantize_ref) and the jitted reference compute it:
//   s  = bf16(bf16(max|x| * fp32(1/127)) + fp32(bf16(1e-8)))
//   q  = saturate_int8(rint(bf16(x / s)))      (IEEE division, no FMA)
//   scale = fp16(s)
// Scale pools are (P, KH, page): each KV head's scales of a page are
// contiguous, so the paged kernel fetches them with 16-byte cp.async.
//
// The launcher returns cudaGetLastError() of its launch.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float INV127 = 0.007874015718698502f;   // fp32(1 / 127)
constexpr float EPS = 1.0011717677116394e-08f;    // fp32(bf16(1e-8))

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// grid: ceil(2 · n · KH / (THREADS / (D / 8))) blocks; group g takes row
// (tensor g / (n · KH): 0 = K, 1 = V; token (g / KH) % n; head g % KH)
template <int D>
__global__ void __launch_bounds__(THREADS)
    kv_quant_append(const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const int64_t* __restrict__ rows, int8_t* __restrict__ kp,
                    int8_t* __restrict__ vp, __half* __restrict__ ks,
                    __half* __restrict__ vs, int n, int KH, int page) {
  constexpr int TPG = D / 8;  // lanes a row
  static_assert(TPG >= 1 && TPG <= 32 && (TPG & (TPG - 1)) == 0,
                "a row's lanes are a power of two inside one warp");
  const int total = 2 * n * KH;
  const int g = blockIdx.x * (THREADS / TPG) + threadIdx.x / TPG;
  const int sub = threadIdx.x % TPG;
  // groups past the end compute on row 0 and store nothing, so every
  // lane of the warp takes part in the shuffles
  const bool live = g < total;
  const int gg = live ? g : 0;
  const int which = gg / (n * KH), i = (gg / KH) % n, kh = gg % KH;
  const __nv_bfloat16* src = (which ? v : k) +
                             (static_cast<int64_t>(i) * KH + kh) * D + sub * 8;
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  float x[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // a bf16 is the high half of its fp32
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(x[j]));
#pragma unroll
  for (int off = 1; off < TPG; off <<= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float s = bf16_round(bf16_round(__fmul_rn(m, INV127)) + EPS);
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float c = rintf(bf16_round(__fdiv_rn(x[j], s)));
    c = fminf(fmaxf(c, -128.f), 127.f);
    const uint32_t b = static_cast<uint32_t>(static_cast<int>(c)) & 0xffu;
    packed[j / 4] |= b << (8 * (j % 4));
  }
  if (!live) return;
  const int64_t row = rows[i];
  int8_t* dst = (which ? vp : kp) + (row * KH + kh) * D + sub * 8;
  *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
  if (sub == 0) {
    const int64_t pid = row / page, t = row % page;
    (which ? vs : ks)[(pid * KH + kh) * page + t] = __float2half_rn(s);
  }
}

template <int D>
int launch(const void* k, const void* v, const void* rows, void* kp,
           void* vp, void* ks, void* vs, int n, int KH, int page,
           cudaStream_t stream) {
  constexpr int per_block = THREADS / (D / 8);
  const int total = 2 * n * KH;
  const int blocks = (total + per_block - 1) / per_block;
  kv_quant_append<D><<<blocks, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const int64_t*>(rows), static_cast<int8_t*>(kp),
      static_cast<int8_t*>(vp), static_cast<__half*>(ks),
      static_cast<__half*>(vs), n, KH, page);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k, v: (n, KH, D) bf16; rows: (n,) int64 flat pool rows (page id ·
// page + token); kp, vp: (P, page, KH, D) int8 pools; ks, vs: (P, KH,
// page) fp16 scale pools — all contiguous, on the device, k and v
// 16-byte aligned.  Needs D in {16, 32, 64, 128}, n >= 1, KH >= 1.
extern "C" int kvq_append(const void* k, const void* v, const void* rows,
                          void* kp, void* vp, void* ks, void* vs, int n,
                          int KH, int D, int page, void* stream) {
  if (n < 1 || KH < 1 || page < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(k, v, rows, kp, vp, ks, vs, n, KH, page, st);
    case 32: return launch<32>(k, v, rows, kp, vp, ks, vs, n, KH, page, st);
    case 64: return launch<64>(k, v, rows, kp, vp, ks, vs, n, KH, page, st);
    case 128:
      return launch<128>(k, v, rows, kp, vp, ks, vs, n, KH, page, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
