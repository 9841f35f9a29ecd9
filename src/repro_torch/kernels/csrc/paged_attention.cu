// Paged decode attention for Hopper (sm_90a): one query token per
// sequence against K/V held in a global page pool, reached through a
// per-sequence page table (the paper's SMMU translation step).  Replaces
// the Pallas kernel _paged_kernel of src/repro/kernels/paged_attention.py.
//
// What bounds it on the H100: neither bytes nor operations at decode
// sizes.  A token's K and V for one KV head are 256 B in bf16 (D = 64),
// and the G query heads of the group do 4·G·D operations on them, about
// 7 per byte at G = 7, under even the fp32 CUDA-core ridge; at 8
// sequences of 272 tokens all of it is under a microsecond.  What holds a
// simple kernel back is latency: one CTA per (sequence, KV head) walks
// its pages one after the other.  So the design buys memory-level
// parallelism and fewer serial steps:
//
//  * The pages of a sequence are split over a thread-block cluster of S
//    CTAs (S <= 8 from the caller, grid (S, KH · groups, B)).  Each CTA reads
//    lens[b] itself and takes pages [rank·c, min(n, (rank+1)·c)) with
//    n = ceil(len / page) (at most the table's width) and c = ceil(n / S),
//    so the split needs no host read of lens.  A CTA with no page keeps
//    m = -1e30, l = 0, acc = 0 and still reaches both cluster barriers.
//  * Inside a CTA the warps take the CTA's pages round-robin (all four,
//    or two where four rings would not fit in shared memory), each
//    with its own online-softmax state (m, l per head in shared memory,
//    acc in registers), so the page loop has no block-wide barrier.  Each
//    warp streams its pages through its own two-slot ring with 16-byte
//    cp.async, the next page in flight; K and V stay in the
//    pool's dtype in shared memory, rows padded by 16 bytes so that the
//    16-byte row reads of eight lanes hit eight distinct bank quads.
//  * Scores: lane = part · page + t takes token t and the part-th of
//    32 / page slices of D, for 8 heads at once; the slices are summed,
//    and the page's max and sum taken, with warp shuffles, one level for
//    all 8 heads at a time.  PV: a lane owns pairs of output elements
//    (flat over G·D, so G need not be a power of two; Qwen2-0.5B has
//    G = 7) and walks the page's tokens, reading their probabilities
//    from the warp's shared scratch.  With one warp per scheduler there
//    is no other warp to hide a stall, so the page loop is written
//    without a branch between its loads: heads past G and pairs past
//    G·D are computed on clamped indices and never stored, and every
//    lane updates (m, l) itself rather than one lane per head.
//  * Merge in a fixed order, in one launch: the four warps' states
//    through shared memory, then the S CTAs' states in rank order 0..S-1
//    through distributed shared memory, each CTA finishing 1/S of the
//    output elements.  No workspace, no atomics: the same bits on every
//    run.
//  * A CTA keeps its heads' G·D query values and fp32 state in registers
//    and shared memory, at most 2,048 of them.  Where a KV head has more
//    (granite-20b: 48 query heads of 128 over one KV head), the caller
//    splits its G query heads into `groups` equal groups of at most
//    2,048 values, and grid row y = kh · groups + group takes the query
//    heads [y · G', (y + 1) · G') with G' = H / (KH · groups), walking
//    KV head kh's pages.  Each group reads those pages again (512 B a
//    token under MQA at D 128, mostly from L2).  groups = 1 is the
//    launch of before.
//
// What still bounds it: about 7 us of fixed cost per launch (the
// cluster launch, two dependent round trips to device memory for the
// length and table row and then the first pages, and the merge), and
// the serial chain of a page inside one warp (QK, shuffles, PV).
//
// Head dims 16, 32, 64, 112 and 128 are compiled.  D 112 (zamba2-7b's
// shared attention) is not a power of two: a lane's slice of D is 112 /
// (32 / page) elements, 28 at page 8, which bf16 reads 8 bytes at a time
// (VEC 4) instead of 16; pair_head / pair_col take the general division
// (their shortcut is for D <= 64); rows are 240 B (bf16) or 464 B (fp32)
// with the pad, 16-byte multiples.
//
// Arithmetic is fp32 FMA throughout, in the log2 domain (q is scaled by
// log2(e)/sqrt(D) once; ex2.approx); probabilities are not rounded
// before PV (the Pallas kernel does p.astype(f32)); positions >= len
// score -1e30; len = 0 gives zeros; l is floored at 1e-30; output in
// q's dtype.
//
// INT8 pools (the reference's Tuning.kv_cache_quant, whose int8 decode
// is XLA's decode_attention with k_scale / v_scale, models/layers.py:
// 148-177): paged_fwd<bf16, int8_t, D, MP> reads int8 K/V pools and
// their fp16 scale pools, one scale per (token, KV head), with bf16 q
// and output.  The scale pools are laid out (P, KH, page), so one KV
// head's scales of a page are contiguous (16, 32 or 64 bytes) and come
// by the same 16-byte cp.async as the rows, into two slots after the
// page's V rows in the warp's ring.  Rows are D + 16 bytes.  The K
// scale is folded into each token's score after the slices are summed;
// the V scale into each probability stored for PV (l sums the
// unscaled probabilities), so PV multiplies int8 codes by fp32 weights
// and P stays fp32, as in the bf16 kernel (the reference rounds
// p · v_scale to bf16 before PV).  At 8 x 272 tokens of qwen1.5-32b
// (40 KV heads of 128) the pools and scales are 22.6 MB, half the bf16
// pools' bytes.
//
// Each launcher returns cudaGetLastError() of its launch.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int MAX_SPLITS = 8;      // portable thread-block cluster size
constexpr int HB = 8;              // heads scored together (ILP)
constexpr int STAGES = 2;          // ring slots per walking warp
constexpr int MAX_SMEM = 227 * 1024;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Shared memory, in bytes from the start: fp32 scratch, then the
// sequence's row of the page table, then (16-byte aligned) the warps'
// K/V rings, which the warps' partial states take over after the loop.
struct Layout {
  int qs, ps, cs, wm, wl, cm, cl, cacc, fw, inv_l, ids, ring, row, slot,
      bytes;
};

__host__ __device__ inline Layout layout(int G, int D, int page,
                                         int max_pages, int walkers,
                                         int esz) {
  Layout L;
  int f = 0;  // in 4-byte words
  L.qs = f;    f += G * D;             // q · log2(e)/sqrt(D)   [G][D]
  L.ps = f;    f += WARPS * G * page;  // each warp's p         [W][G][page]
  L.cs = f;    f += WARPS * G;         // corrections, then warp weights
  L.wm = f;    f += WARPS * G;         // each warp's m         [W][G]
  L.wl = f;    f += WARPS * G;         // each warp's l         [W][G]
  L.cm = f;    f += G;                 // the CTA's m, l, acc
  L.cl = f;    f += G;
  L.cacc = f;  f += G * D;
  L.fw = f;    f += MAX_SPLITS * G;    // cluster merge weights [S][G]
  L.inv_l = f; f += G;
  L.ids = f;   f += max_pages;         // the sequence's table row
  L.qs *= 4; L.ps *= 4; L.cs *= 4; L.wm *= 4; L.wl *= 4; L.cm *= 4;
  L.cl *= 4; L.cacc *= 4; L.fw *= 4; L.inv_l *= 4; L.ids *= 4;
  L.ring = cdiv(4 * f, 16) * 16;
  L.row = D * esz + 16;
  // a ring slot: the page's K rows, its V rows, and for int8 pools
  // (esz 1) the page's fp16 K and V scales of this KV head
  L.slot = 2 * page * L.row + (esz == 1 ? 2 * page * 2 : 0);
  const int ring = walkers * STAGES * L.slot;
  const int part = WARPS * G * D * 4;
  L.bytes = L.ring + (ring > part ? ring : part);
  return L;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x, flushing results below 2^-126 to 0 (scores 30 binades under the
// running max are dropped, as an fp32 softmax drops them anyway).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// VEC consecutive elements of a K row in shared memory, as fp32.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* f) {
#pragma unroll
  for (int v = 0; v < VEC; v += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + v);
    f[v] = x.x; f[v + 1] = x.y; f[v + 2] = x.z; f[v + 3] = x.w;
  }
}
template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  static_assert(VEC == 4 || VEC == 8, "bf16 rows are read 8 or 16 B");
  uint32_t w[VEC / 2];
  if constexpr (VEC == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x; w[1] = x.y;
  }
  // a bf16 is the high half of its fp32: exact, and no address taken
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const int8_t* p, float* f) {
  static_assert(VEC == 4 || VEC == 8 || VEC == 16,
                "int8 rows are read 4, 8 or 16 B");
  uint32_t w[VEC / 4];
  if constexpr (VEC == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (VEC == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x; w[1] = x.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
  // byte b of a word, sign-extended: exact in fp32
#pragma unroll
  for (int i = 0; i < VEC / 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[4 * i + b] = static_cast<float>(
          static_cast<int>(w[i] << (24 - 8 * b)) >> 24);
}

// s[h] += q[g0 + h] · k over this lane's slice of D (pe elements) for
// all HB heads of the chunk; heads past G are computed as copies of head
// G - 1, so no guard splits the unrolled code.  q: the slice's start in
// the first head's row; rows are D apart.
template <int VEC, typename T>
__device__ __forceinline__ void qk_slice(const T* k, const float* q, int g0,
                                         int G, int D, int pe, float* s) {
  for (int e = 0; e < pe; e += VEC) {
    float kf[VEC];
    load_vec<VEC>(k + e, kf);
#pragma unroll
    for (int h = 0; h < HB; ++h) {
      const float* qh = q + min(g0 + h, G - 1) * D + e;
      float a = s[h];
#pragma unroll
      for (int v = 0; v < VEC; v += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qh + v);
        a = fmaf(qv.x, kf[v], a);
        a = fmaf(qv.y, kf[v + 1], a);
        a = fmaf(qv.z, kf[v + 2], a);
        a = fmaf(qv.w, kf[v + 3], a);
      }
      s[h] = a;
    }
  }
}

// A lane's pair j covers output elements e = 2·lane + 64·j and e + 1 of
// the flat [G][D] block: head e / D, column e % D.  Pairs past G·D read
// head G - 1 and are never stored.
__device__ __forceinline__ int pair_e(int lane, int j) {
  return 2 * lane + 64 * j;
}
template <int D>
__device__ __forceinline__ int pair_head(int lane, int j, int G) {
  const int h = D <= 64 ? 2 * lane / D + j * (64 / D) : pair_e(lane, j) / D;
  return min(h, G - 1);
}
template <int D>
__device__ __forceinline__ int pair_col(int lane, int j) {
  return D <= 64 ? 2 * lane % D : pair_e(lane, j) % D;  // D <= 64: no j
}

// T: q and output dtype; KV: pool dtype (T, or int8_t with fp16 scale
// pools ksc / vsc of (P, KH, page); nullptr otherwise); D: head dim;
// MP: output element pairs a lane holds (ceil(G·D / 64) <= MP, G the
// CTA's query heads).
template <typename T, typename KV, int D, int MP>
__global__ void __launch_bounds__(THREADS, 1)
    paged_fwd(const T* __restrict__ q, const KV* __restrict__ kp,
              const KV* __restrict__ vp, const __half* __restrict__ ksc,
              const __half* __restrict__ vsc, const int* __restrict__ table,
              const int* __restrict__ lens, T* __restrict__ o, int H, int KH,
              int groups, int page, int max_pages, int splits, int walkers,
              float qscale) {
  constexpr bool QUANT = sizeof(KV) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  // this CTA's query heads: G of them, from head blockIdx.y · G
  const int G = H / (KH * groups), GD = G * D;
  const Layout L = layout(G, D, page, max_pages, walkers, sizeof(KV));
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* cm = reinterpret_cast<float*>(smem + L.cm);
  float* cl = reinterpret_cast<float*>(smem + L.cl);
  float* cacc = reinterpret_cast<float*>(smem + L.cacc);
  float* fw = reinterpret_cast<float*>(smem + L.fw);
  float* inv_l = reinterpret_cast<float*>(smem + L.inv_l);
  int* ids = reinterpret_cast<int*>(smem + L.ids);

  const int rank = blockIdx.x, kh = blockIdx.y / groups, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = lens[b];
  const int n = len > 0 ? min(cdiv(len, page), max_pages) : 0;
  const int c = cdiv(n, splits);
  const int lo = min(n, rank * c), np = min(n, lo + c) - lo;

  // q, the length and the whole table row are loaded together (none
  // waits for another); the CTA's range then indexes the row
  const T* qb = q + (static_cast<int64_t>(b) * H + blockIdx.y * G) * D;
  for (int i = tid; i < GD; i += THREADS) qs[i] = to_f(qb[i]) * qscale;
  for (int i = tid; i < max_pages; i += THREADS)
    ids[i] = table[static_cast<int64_t>(b) * max_pages + i];

  // this warp's state and scratch: p of the page as [page][G]
  float* ps = reinterpret_cast<float*>(smem + L.ps) + warp * page * G;
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  float* wm = reinterpret_cast<float*>(smem + L.wm);
  float* wl = reinterpret_cast<float*>(smem + L.wl);
  float* my_cs = cs + warp * G;
  float* my_m = wm + warp * G;
  float* my_l = wl + warp * G;
  for (int g = lane; g < G; g += 32) {
    my_m[g] = NEG_INF;
    my_l[g] = 0.f;
  }
  float2 acc[MP];
#pragma unroll
  for (int j = 0; j < MP; ++j) acc[j] = make_float2(0.f, 0.f);
  __syncthreads();  // q and the page ids are in place

  unsigned char* ring = smem + L.ring + warp * STAGES * L.slot;
  const int split = 32 / page, t = lane % page, part = lane / page;
  const int pe = D / split;                    // elements per slice
  // the first `walkers` warps walk the pages (all four unless their
  // rings would not fit); the others keep an empty state
  const int nw =
      warp < walkers && np > warp ? cdiv(np - warp, walkers) : 0;
  const int chunks = D * static_cast<int>(sizeof(KV)) / 16;  // per row
  const int schunks = QUANT ? page * 2 / 16 : 0;  // per scale slot
  const size_t kh_off = static_cast<size_t>(kh) * D;

  // the warp's i-th page (local page warp + i·walkers) into its ring slot
  auto load = [&](int i) {
    if (i < nw) {
      const int64_t pid = ids[lo + warp + i * walkers];
      unsigned char* ks = ring + (i % STAGES) * L.slot;
      unsigned char* vs = ks + page * L.row;
      for (int x = lane; x < page * chunks; x += 32) {
        const int r = x / chunks, cc = x % chunks;
        const size_t src = (static_cast<size_t>(pid) * page + r) * KH * D +
                           kh_off + cc * (16 / sizeof(KV));
        cp_async16(ks + r * L.row + cc * 16, kp + src);
        cp_async16(vs + r * L.row + cc * 16, vp + src);
      }
      if constexpr (QUANT) {
        // this KV head's page of K scales, then of V scales
        const size_t so = (static_cast<size_t>(pid) * KH + kh) * page;
        for (int x = lane; x < 2 * schunks; x += 32) {
          const int which = x / schunks, cc = x % schunks;
          cp_async16(ks + 2 * page * L.row + which * page * 2 + cc * 16,
                     (which ? vsc : ksc) + so + cc * 8);
        }
      }
    }
    cp_async_commit();  // an empty group keeps the wait counts uniform
  };
  load(0);

  for (int i = 0; i < nw; ++i) {
    load(i + 1);
    cp_async_wait<STAGES - 1>();
    __syncwarp();  // page i has landed for every lane of the warp
    const unsigned char* ks = ring + (i % STAGES) * L.slot;
    const unsigned char* vs = ks + page * L.row;
    const int pos = (lo + warp + i * walkers) * page + t;
    const KV* krow = reinterpret_cast<const KV*>(ks + t * L.row) + part * pe;
    // this lane's token's dequantization scales (int8 pools only)
    float kscale = 1.f, vscale = 1.f;
    if constexpr (QUANT) {
      const __half* ss =
          reinterpret_cast<const __half*>(ks + 2 * page * L.row);
      kscale = __half2float(ss[t]);
      vscale = __half2float(ss[page + t]);
    }

    for (int g0 = 0; g0 < G; g0 += HB) {
      const int nh = min(HB, G - g0);
      // the heads' m and l before this page, read by every lane before
      // the lanes write the new ones below
      float s[HB], m_old[HB], l_old[HB];
#pragma unroll
      for (int h = 0; h < HB; ++h) {
        s[h] = 0.f;
        m_old[h] = my_m[min(g0 + h, G - 1)];
        l_old[h] = my_l[min(g0 + h, G - 1)];
      }
      __syncwarp();
      const float* qrow = qs + part * pe;
      if constexpr (QUANT) {
        if (pe % 16 == 0)
          qk_slice<16>(krow, qrow, g0, G, D, pe, s);
        else if (pe % 8 == 0)
          qk_slice<8>(krow, qrow, g0, G, D, pe, s);
        else
          qk_slice<4>(krow, qrow, g0, G, D, pe, s);
      } else if (sizeof(KV) == 4 || pe % 8 == 0) {
        qk_slice<sizeof(KV) == 4 ? 4 : 8>(krow, qrow, g0, G, D, pe, s);
      } else {
        qk_slice<4>(krow, qrow, g0, G, D, pe, s);
      }
      // each reduction level is taken for all heads of the chunk at once,
      // so the heads' shuffles overlap: the slices' sum, then the page's
      // max and, after the exponentials, its sum
#pragma unroll
      for (int off = 8; off < 32; off <<= 1)
        if (off >= page)
#pragma unroll
          for (int h = 0; h < HB; ++h)
            s[h] += __shfl_xor_sync(0xffffffffu, s[h], off);
      float mx[HB], sum[HB];
#pragma unroll
      for (int h = 0; h < HB; ++h) {
        if constexpr (QUANT) s[h] *= kscale;
        s[h] = pos < len ? s[h] : NEG_INF;
        mx[h] = s[h];
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        if (off < page)
#pragma unroll
          for (int h = 0; h < HB; ++h)
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
#pragma unroll
      for (int h = 0; h < HB; ++h) {
        mx[h] = fmaxf(m_old[h], mx[h]);  // the new m
        s[h] = exp2_ftz(s[h] - mx[h]);  // p
        sum[h] = s[h];
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        if (off < page)
#pragma unroll
          for (int h = 0; h < HB; ++h)
            sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], off);
      // every lane now holds every head's new (m, l): lane h stores head
      // g0 + h, without a branch per head
      float m_out = 0.f, l_out = 0.f, c_out = 0.f;
#pragma unroll
      for (int h = 0; h < HB; ++h) {
        const float corr = exp2_ftz(m_old[h] - mx[h]);
        // PV's weight: p, times the token's V scale for int8 pools
        if (part == 0 && h < nh)
          ps[t * G + g0 + h] = QUANT ? s[h] * vscale : s[h];
        if (lane == h) {
          m_out = mx[h];
          l_out = l_old[h] * corr + sum[h];
          c_out = corr;
        }
      }
      if (lane < nh) {
        my_m[g0 + lane] = m_out;
        my_l[g0 + lane] = l_out;
        my_cs[g0 + lane] = c_out;
      }
    }
    __syncwarp();  // p and the corrections are visible to the warp

    // PV token by token, all of the lane's pairs at once (independent
    // FMA chains, no guard between them)
#pragma unroll
    for (int j = 0; j < MP; ++j) {
      const float corr = my_cs[pair_head<D>(lane, j, G)];
      acc[j].x *= corr;
      acc[j].y *= corr;
    }
#pragma unroll 4
    for (int tt = 0; tt < page; ++tt) {
      const KV* vrow = reinterpret_cast<const KV*>(vs + tt * L.row);
      const float* prow = ps + tt * G;
#pragma unroll
      for (int j = 0; j < MP; ++j) {
        const float pp = prow[pair_head<D>(lane, j, G)];
        const float2 v = load2(vrow + pair_col<D>(lane, j));
        acc[j].x = fmaf(pp, v.x, acc[j].x);
        acc[j].y = fmaf(pp, v.y, acc[j].y);
      }
    }
    __syncwarp();  // the slot and the scratch are free for the next page
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done: the rings take the warps' acc

  // merge the four warps in order 0..3 into the CTA's state
  float* pacc = reinterpret_cast<float*>(smem + L.ring);  // [W][GD]
#pragma unroll
  for (int j = 0; j < MP; ++j) {
    const int e = pair_e(lane, j);
    if (e < GD) store2(pacc + warp * GD + e, acc[j].x, acc[j].y);
  }
  for (int g = tid; g < G; g += THREADS) {
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(wm[w * G + g] - mx);
      cs[w * G + g] = f;
      l += wl[w * G + g] * f;
    }
    cm[g] = mx;
    cl[g] = l;
  }
  __syncthreads();
  for (int e = tid; e < GD; e += THREADS) {
    const int g = e / D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      a = fmaf(pacc[w * GD + e], cs[w * G + g], a);
    cacc[e] = a;
  }
  cluster.sync();  // every CTA's state is written and visible

  // CTA `rank` finishes elements [rank·GD/S, (rank+1)·GD/S), merging the
  // S states in rank order; its own state is read locally, the peers'
  // through distributed shared memory
  auto peer = [&](float* p, int r) {
    return r == rank ? p : cluster.map_shared_rank(p, r);
  };
  for (int g = tid; g < G; g += THREADS) {
    float mr[MAX_SPLITS], mx = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) {
        mr[r] = peer(cm, r)[g];
        mx = fmaxf(mx, mr[r]);
      }
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) {
        const float f = exp2f(mr[r] - mx);
        fw[r * G + g] = f;
        l += peer(cl, r)[g] * f;
      }
    inv_l[g] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const int e0 = rank * GD / splits, e1 = (rank + 1) * GD / splits;
  T* ob = o + (static_cast<int64_t>(b) * H + blockIdx.y * G) * D;
  for (int e = e0 + tid; e < e1; e += THREADS) {
    const int g = e / D;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) a = fmaf(peer(cacc, r)[e], fw[r * G + g], a);
    store(ob + e, a * inv_l[g]);
  }
  cluster.sync();  // no CTA leaves while a peer still reads its state
}

template <typename T, typename KV, int D, int MP>
int launch(const void* q, const void* kp, const void* vp, const void* ksc,
           const void* vsc, const int* table, const int* lens, void* o,
           int B, int H, int KH, int groups, int page, int max_pages,
           int splits, int walkers, cudaStream_t stream) {
  auto kern = paged_fwd<T, KV, D, MP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Layout L = layout(H / (KH * groups), D, page, max_pages, walkers,
                          sizeof(KV));
  if (L.bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KH * groups, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), static_cast<const __half*>(ksc),
      static_cast<const __half*>(vsc), table, lens, static_cast<T*>(o), H,
      KH, groups, page, max_pages, splits, walkers,
      LOG2E / sqrtf(static_cast<float>(D)));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// MP, the pairs a lane holds, is the least of 8, 16, 32 that covers the
// CTA's G·D: every pair is computed, so a tier sized to G·D keeps the
// waste small.
template <typename T, typename KV, int D>
int launch_d(const void* q, const void* kp, const void* vp, const void* ksc,
             const void* vsc, const int* tb, const int* ln, void* o, int B,
             int H, int KH, int gr, int page, int mp, int splits,
             int walkers, cudaStream_t st) {
  const int gd = (H / (KH * gr)) * D;
  if (gd <= 8 * 64)
    return launch<T, KV, D, 8>(q, kp, vp, ksc, vsc, tb, ln, o, B, H, KH, gr,
                               page, mp, splits, walkers, st);
  if (gd <= 16 * 64)
    return launch<T, KV, D, 16>(q, kp, vp, ksc, vsc, tb, ln, o, B, H, KH, gr,
                                page, mp, splits, walkers, st);
  return launch<T, KV, D, 32>(q, kp, vp, ksc, vsc, tb, ln, o, B, H, KH, gr,
                              page, mp, splits, walkers, st);
}

template <typename T>
int launch_t(const void* q, const void* kp, const void* vp, const int* tb,
             const int* ln, void* o, int B, int H, int KH, int gr, int D,
             int page, int mp, int splits, int walkers, cudaStream_t st) {
  switch (D) {
    case 16: return launch_d<T, T, 16>(q, kp, vp, nullptr, nullptr, tb, ln,
                                       o, B, H, KH, gr, page, mp, splits,
                                       walkers, st);
    case 32: return launch_d<T, T, 32>(q, kp, vp, nullptr, nullptr, tb, ln,
                                       o, B, H, KH, gr, page, mp, splits,
                                       walkers, st);
    case 64: return launch_d<T, T, 64>(q, kp, vp, nullptr, nullptr, tb, ln,
                                       o, B, H, KH, gr, page, mp, splits,
                                       walkers, st);
    case 112: return launch_d<T, T, 112>(q, kp, vp, nullptr, nullptr, tb,
                                         ln, o, B, H, KH, gr, page, mp,
                                         splits, walkers, st);
    case 128: return launch_d<T, T, 128>(q, kp, vp, nullptr, nullptr, tb,
                                         ln, o, B, H, KH, gr, page, mp,
                                         splits, walkers, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 q and output over int8 pools with fp16 scale pools
int launch_int8(const void* q, const void* kp, const void* vp,
                const void* ksc, const void* vsc, const int* tb,
                const int* ln, void* o, int B, int H, int KH, int gr, int D,
                int page, int mp, int splits, int walkers, cudaStream_t st) {
  using BF = __nv_bfloat16;
  switch (D) {
    case 16: return launch_d<BF, int8_t, 16>(q, kp, vp, ksc, vsc, tb, ln, o,
                                             B, H, KH, gr, page, mp, splits,
                                             walkers, st);
    case 32: return launch_d<BF, int8_t, 32>(q, kp, vp, ksc, vsc, tb, ln, o,
                                             B, H, KH, gr, page, mp, splits,
                                             walkers, st);
    case 64: return launch_d<BF, int8_t, 64>(q, kp, vp, ksc, vsc, tb, ln, o,
                                             B, H, KH, gr, page, mp, splits,
                                             walkers, st);
    case 128: return launch_d<BF, int8_t, 128>(q, kp, vp, ksc, vsc, tb, ln,
                                               o, B, H, KH, gr, page, mp,
                                               splits, walkers, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}


// ------------------------------------------- the latent form (MLA decode)
//
// Multi-head latent attention decodes in the absorbed form: the H query
// heads (128 for deepseek-v3) of one token attend over ONE latent KV
// head of DK = 576 columns (the 512-wide compressed ckv, then the 64
// RoPE columns kr), and V is the first DV = 512 columns of the same
// rows.  The head-group kernel above would split 128 heads of 576 into
// 43 groups that each walk and re-read every page; instead a CTA holds a
// block of query heads and stages each latent page once in shared
// memory, where both QK^T and PV read it.  Grid (S, head blocks, B), the
// pages of a sequence split over a cluster of S CTAs as above and merged
// in rank order through distributed shared memory (one launch, no
// workspace, no atomics).  The scale is the caller's (deepseek-v3:
// 1/sqrt(192), the q/k head dim of the un-absorbed form), not
// 1/sqrt(DK).
//
// What bounds it: at 8 sequences of 272 tokens the latent rows are 2.5
// MB (0.75 us at 3.35 TB/s) and the scores and PV 2·128·(576 + 512)
// operations a token (0.6 us at the bf16 tensor-core peak): neither.
// What is left is the serial walk of a CTA's pages and the fixed cost of
// a launch (the length and table row, then the first pages; the merge).
//
// bf16 (the served path), paged_latent_tc: 64 query heads a CTA (so at H
// 128 each page is staged by 2 CTAs per (sequence, split), not 8), both
// products on tensor cores through wgmma rather than mma.sync: one
// warpgroup instruction covers all 64 heads, reads q and the page from
// the swizzled shared memory TMA fills with no ldmatrix, and its QK^T
// accumulator is already laid out as PV's register A fragment.
//  * Each slot of 32 tokens (four 8-token pages, two of 16 or one of 32)
//    comes by TMA onto an mbarrier, in a ring of 3 slots: boxes of 64
//    columns x the page's rows, 128-byte swizzled, so the 16-byte chunks
//    of 8 consecutive rows fall in 8 distinct bank quads without the FMA
//    kernel's padded rows.  Thread 0 issues them (no producer warp: with
//    one, registers are allotted for 384 threads, too few for the
//    accumulators and ptxas serialises the wgmmas).  q is staged once by
//    cp.async in the same swizzled layout, issued before the length and
//    table row are read.  A slot's pages past the CTA's share repeat its
//    last page and are masked.
//  * S = Q K^T on wgmma m64n16k16 over 36 k16 steps (exact bf16 products,
//    fp32 sums): warpgroup g takes tokens [16 g, 16 g + 16) of the slot,
//    and the two trade halves through shared memory (two buffers, one
//    block barrier a slot: the walk's only one, after which slot i - 1's
//    ring slot is free and thread 0 loads slot i + 2 into it).  Each then
//    runs the online softmax of all 32 tokens on its registers (a row's
//    stats across the 4 lanes of a quad), fp32 in the log2 domain.
//  * PV on tensor cores without rounding P to bf16: P = hi + lo, hi =
//    bf16(P), lo = bf16(P - hi) (16 significant bits, relative error
//    below 2^-16), two wgmma m64n256k16 a 16 tokens with A from registers
//    (the QK^T accumulator's layout is the A fragment's) and V, MN-major,
//    from the same swizzled slot.  Warpgroup g owns output columns [256
//    g, 256 g + 256): 128 fp32 accumulators a thread, so 64 x 512 stays in
//    registers.
//  * Heads of the block past H (H = 16 or 32) are zero queries, never
//    stored.
//  * The merge: each CTA parks its fp32 partial (unnormalised, 64 x 512,
//    rows padded by 8 floats) and its m and l in its shared memory; after
//    a cluster barrier rank o sums 1/S of the block's outputs over the S
//    ranks in rank order, read through distributed shared memory, all S
//    loads of an element issued before the sums (S is a template
//    argument).  Pushing the partials to the owners by remote stores
//    instead measured slower (and took 254 registers).
// fp32 (on no served path), paged_latent: an FMA kernel, 16 heads a CTA,
// eight warps:
//  * QK^T: lane l of warp w takes head 4·(w % 4) + l / 8 and the
//    16-byte chunks l % 8 + 8j of the row (144 fp32 chunks: 18 a lane),
//    its q slice (scaled by log2(e)·scale) held in registers for the whole
//    walk; warps w and w + 4 take the even and the odd tokens.  The eight
//    lanes of a head read consecutive chunks and the warp's four heads
//    the same ones, so a page row is read once per warp, conflict-free.
//  * The online softmax of a page: a half-warp per head, fp32 in the
//    log2 domain; P is kept in fp32 (token-major in shared memory).
//  * PV: thread t owns output columns 2t, 2t + 1 of all 16 heads (32 fp32
//    accumulators), reading each token's V pair once and the 16 heads'
//    probabilities as broadcast float4s.
//  * fp32 FMA throughput and three block barriers a page bound it.
constexpr int LH = 16;                  // query heads per CTA
constexpr int LTHREADS = 256;           // eight warps
constexpr int SC_LD = 33;               // score rows, padded

struct LatentLayout {
  int sc, pt, corr, cm, cl, fw, inv_l, ids, ring, row, bytes;
};

__host__ __device__ inline LatentLayout latent_layout(int DK, int DV,
                                                      int page,
                                                      int max_pages,
                                                      int esz) {
  LatentLayout L;
  int f = 0;  // in 4-byte words
  L.sc = f;    f += LH * SC_LD;         // scores             [LH][SC_LD]
  L.pt = f;    f += 32 * LH;            // probabilities      [page][LH]
  L.corr = f;  f += LH;                 // the page's corrections
  L.cm = f;    f += LH;                 // the CTA's m and l
  L.cl = f;    f += LH;
  L.fw = f;    f += MAX_SPLITS * LH;    // cluster merge weights [S][LH]
  L.inv_l = f; f += LH;
  L.ids = f;   f += max_pages;          // the sequence's table row
  L.sc *= 4; L.pt *= 4; L.corr *= 4; L.cm *= 4; L.cl *= 4; L.fw *= 4;
  L.inv_l *= 4; L.ids *= 4;
  L.ring = cdiv(4 * f, 16) * 16;
  L.row = DK * esz + 16;                // 16-byte pad: 73 quads (bf16)
  const int ring = 2 * page * L.row;    // two page slots
  const int part = LH * DV * 4;         // the CTA's acc after the walk
  L.bytes = L.ring + (ring > part ? ring : part);
  return L;
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(LTHREADS, 1)
    paged_latent(const T* __restrict__ q, const T* __restrict__ pool,
                 const int* __restrict__ table, const int* __restrict__ lens,
                 T* __restrict__ o, int H, int page, int max_pages,
                 int splits, float qscale) {
  constexpr int CE = 16 / sizeof(T);    // elements of a 16-byte chunk
  constexpr int CHR = DK / CE;          // chunks of a pool row
  constexpr int NCH = CHR / 8;          // chunks of a lane (8 lanes a head)
  constexpr int DVP = DV / (2 * LTHREADS);  // column pairs of a thread
  static_assert(CHR % 8 == 0, "lane slices of a row");
  static_assert(DV % (2 * LTHREADS) == 0, "PV column pairs");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const LatentLayout L = latent_layout(DK, DV, page, max_pages, sizeof(T));
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* pt = reinterpret_cast<float*>(smem + L.pt);
  float* corr = reinterpret_cast<float*>(smem + L.corr);
  float* cm = reinterpret_cast<float*>(smem + L.cm);
  float* cl = reinterpret_cast<float*>(smem + L.cl);
  float* fw = reinterpret_cast<float*>(smem + L.fw);
  float* inv_l = reinterpret_cast<float*>(smem + L.inv_l);
  int* ids = reinterpret_cast<int*>(smem + L.ids);
  unsigned char* ring = smem + L.ring;

  const int rank = blockIdx.x, hb = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = lens[b];
  const int n = len > 0 ? min(cdiv(len, page), max_pages) : 0;
  const int c = cdiv(n, splits);
  const int lo = min(n, rank * c), np = min(n, lo + c) - lo;
  for (int i = tid; i < max_pages; i += LTHREADS)
    ids[i] = table[static_cast<int64_t>(b) * max_pages + i];

  // QK role: head qh of the block, chunks sub + 8j, tokens of parity par
  const int qh = 4 * (warp % 4) + lane / 8, sub = lane % 8, par = warp / 4;
  float qr[NCH][CE];
  const T* qrow = q + (static_cast<int64_t>(b) * H + hb * LH + qh) * DK;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    load_vec<CE>(qrow + (sub + 8 * j) * CE, qr[j]);
#pragma unroll
    for (int e = 0; e < CE; ++e) qr[j][e] *= qscale;
  }
  // softmax role: head sh, tokens st and st + 16; (m, l) in registers
  const int sh = 2 * warp + lane / 16, st = lane % 16;
  float m_run = NEG_INF, l_run = 0.f;
  float2 acc[DVP][LH];
#pragma unroll
  for (int j = 0; j < DVP; ++j)
#pragma unroll
    for (int h = 0; h < LH; ++h) acc[j][h] = make_float2(0.f, 0.f);

  // the CTA's i-th page into ring slot i % 2, every thread a share
  auto load = [&](int i) {
    if (i < np) {
      const int64_t pid = ids[lo + i];
      unsigned char* dst = ring + (i % 2) * page * L.row;
      const T* src = pool + pid * page * DK;
      for (int x = tid; x < page * CHR; x += LTHREADS) {
        const int r = x / CHR, cc = x % CHR;
        cp_async16(dst + r * L.row + cc * 16, src + r * DK + cc * CE);
      }
    }
    cp_async_commit();
  };
  __syncthreads();  // the page ids are in place
  load(0);

  for (int i = 0; i < np; ++i) {
    cp_async_wait<0>();  // page i has landed (the only group in flight)
    __syncthreads();     // for every thread; page i - 1 is fully used
    load(i + 1);         // into page i - 1's slot, behind this page
    const unsigned char* pg = ring + (i % 2) * page * L.row;
    const int pos0 = (lo + i) * page;

    for (int t = par; t < page; t += 2) {
      const T* krow = reinterpret_cast<const T*>(pg + t * L.row);
      float s2[2] = {0.f, 0.f};  // two chains over the lane's chunks
#pragma unroll
      for (int j = 0; j < NCH; ++j) {
        float kf[CE];
        load_vec<CE>(krow + (sub + 8 * j) * CE, kf);
#pragma unroll
        for (int e = 0; e < CE; ++e)
          s2[j & 1] = fmaf(qr[j][e], kf[e], s2[j & 1]);
      }
      float s = s2[0] + s2[1];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if (sub == 0) sc[qh * SC_LD + t] = pos0 + t < len ? s : NEG_INF;
    }
    __syncthreads();  // the page's scores

    {
      const float x0 = st < page ? sc[sh * SC_LD + st] : NEG_INF;
      const float x1 = st + 16 < page ? sc[sh * SC_LD + st + 16] : NEG_INF;
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);
      const float p0 = exp2_ftz(x0 - m_new), p1 = exp2_ftz(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float cr = exp2_ftz(m_run - m_new);
      l_run = l_run * cr + sum;
      m_run = m_new;
      if (st < page) pt[st * LH + sh] = p0;
      if (st + 16 < page) pt[(st + 16) * LH + sh] = p1;
      if (st == 0) corr[sh] = cr;
    }
    __syncthreads();  // the page's probabilities and corrections

    {
      float cr[LH];
#pragma unroll
      for (int h = 0; h < LH; h += 4) {
        const float4 x = *reinterpret_cast<const float4*>(corr + h);
        cr[h] = x.x; cr[h + 1] = x.y; cr[h + 2] = x.z; cr[h + 3] = x.w;
      }
#pragma unroll
      for (int j = 0; j < DVP; ++j)
#pragma unroll
        for (int h = 0; h < LH; ++h) {
          acc[j][h].x *= cr[h];
          acc[j][h].y *= cr[h];
        }
    }
#pragma unroll 2
    for (int t = 0; t < page; ++t) {
      const T* vrow = reinterpret_cast<const T*>(pg + t * L.row);
      float p[LH];
#pragma unroll
      for (int h = 0; h < LH; h += 4) {
        const float4 x = *reinterpret_cast<const float4*>(pt + t * LH + h);
        p[h] = x.x; p[h + 1] = x.y; p[h + 2] = x.z; p[h + 3] = x.w;
      }
#pragma unroll
      for (int j = 0; j < DVP; ++j) {
        const float2 v = load2(vrow + 2 * (tid + j * LTHREADS));
#pragma unroll
        for (int h = 0; h < LH; ++h) {
          acc[j][h].x = fmaf(p[h], v.x, acc[j][h].x);
          acc[j][h].y = fmaf(p[h], v.y, acc[j][h].y);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is dead: it takes the CTA's acc

  float* cacc = reinterpret_cast<float*>(ring);  // [LH][DV]
#pragma unroll
  for (int j = 0; j < DVP; ++j)
#pragma unroll
    for (int h = 0; h < LH; ++h)
      store2(cacc + h * DV + 2 * (tid + j * LTHREADS), acc[j][h].x,
             acc[j][h].y);
  if (st == 0) {
    cm[sh] = m_run;
    cl[sh] = l_run;
  }
  cluster.sync();  // every CTA's state is written and visible

  auto peer = [&](float* p, int r) {
    return r == rank ? p : cluster.map_shared_rank(p, r);
  };
  for (int g = tid; g < LH; g += LTHREADS) {
    float mr[MAX_SPLITS], mx = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) {
        mr[r] = peer(cm, r)[g];
        mx = fmaxf(mx, mr[r]);
      }
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) {
        const float f = exp2f(mr[r] - mx);
        fw[r * LH + g] = f;
        l += peer(cl, r)[g] * f;
      }
    inv_l[g] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  constexpr int E = LH * DV;
  const int e0 = rank * E / splits, e1 = (rank + 1) * E / splits;
  T* ob = o + (static_cast<int64_t>(b) * H + hb * LH) * DV;
  for (int e = e0 + tid; e < e1; e += LTHREADS) {
    const int g = e / DV;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      if (r < splits) a = fmaf(peer(cacc, r)[e], fw[r * LH + g], a);
    store(ob + e, a * inv_l[g]);
  }
  cluster.sync();  // no CTA leaves while a peer still reads its state
}

template <typename T, int DK, int DV>
int launch_latent(const void* q, const void* pool, const int* table,
                  const int* lens, void* o, int B, int H, int page,
                  int max_pages, int splits, float qscale,
                  cudaStream_t stream) {
  auto kern = paged_latent<T, DK, DV>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const LatentLayout L = latent_layout(DK, DV, page, max_pages, sizeof(T));
  if (L.bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, H / LH, B);
  cfg.blockDim = dim3(LTHREADS);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const T*>(pool),
      table, lens, static_cast<T*>(o), H, page, max_pages, splits, qscale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------- the latent form on tensor cores (bf16)
constexpr int TH = 64;                   // query heads a CTA
constexpr int TC_THREADS = 256;          // two warpgroups
constexpr int LDK = 576, LDV = 512;      // the latent row; its V columns
constexpr int KB = LDK / 64;             // 128-byte column blocks of a row
constexpr int TOK = 32;                  // tokens a slot
constexpr int TC_STAGES = 3;             // slots in the ring
constexpr int SLOT = KB * TOK * 128;     // 36 KB
constexpr int Q_BYTES = KB * TH * 128;   // q, swizzled: 72 KB
constexpr int X_BYTES = 2 * TC_THREADS * 8 * 4;  // S halves, two buffers
constexpr int ACC_LD = LDV + 8;          // fp32 merge rows, padded
constexpr int ACC_BYTES = TH * ACC_LD * 4;

// Shared memory, in bytes from a 1,024-byte aligned base: q, the ring of
// slots (each nine column blocks of 32 rows of 128 B), the exchange of
// S halves between the warpgroups; the CTA's fp32 [TH][ACC_LD]
// accumulator takes these over after the walk.  Then the slots'
// barriers, the CTA's m and l, merge weights, 1 / l and the table row.
struct TcLayout {
  int ring, xs, full, cm, cl, fw, inv_l, ids, bytes;
};

__host__ __device__ inline TcLayout tc_layout(int max_pages) {
  TcLayout L;
  L.ring = Q_BYTES;
  L.xs = L.ring + TC_STAGES * SLOT;
  const int main = L.xs + X_BYTES;
  L.full = main > ACC_BYTES ? main : ACC_BYTES;
  L.cm = L.full + 8 * TC_STAGES;
  L.cl = L.cm + 4 * TH;
  L.fw = L.cl + 4 * TH;
  L.inv_l = L.fw + 4 * MAX_SPLITS * TH;
  L.ids = L.inv_l + 4 * TH;
  L.bytes = 1024 + L.ids + 4 * max_pages;
  return L;
}

// The cluster's merge of the latent kernel, S ranks: rank r's weights
// 2^(m_r - max m) and 1 / l for each head, then CTA `rank` finishes
// 1/S of the block's 64 x 512 outputs, summing the ranks' fp32 partials
// in rank order.  S is a template argument so that every rank's load
// (distributed shared memory) of an element is issued before the sums:
// with a runtime S each conditional load waited for the one before it.
struct LatentState {
  float *cm, *cl, *cacc, *fw, *inv_l;  // as the kernel's layout names them
};

template <int S>
__device__ __forceinline__ void latent_merge(cg::cluster_group& cluster,
                                             const LatentState& st,
                                             __nv_bfloat16* __restrict__ o,
                                             int H, int b, int hb) {
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  float* fw = st.fw;
  float* inv_l = st.inv_l;
  const float* pm[S];
  const float* pl[S];
  const float* pa[S];
#pragma unroll
  for (int r = 0; r < S; ++r) {
    pm[r] = cluster.map_shared_rank(st.cm, r);
    pl[r] = cluster.map_shared_rank(st.cl, r);
    pa[r] = cluster.map_shared_rank(st.cacc, r);
  }
  for (int g = tid; g < TH; g += TC_THREADS) {
    float mr[S], lr[S], mx = NEG_INF;
#pragma unroll
    for (int r = 0; r < S; ++r) {
      mr[r] = pm[r][g];
      lr[r] = pl[r][g];
    }
#pragma unroll
    for (int r = 0; r < S; ++r) mx = fmaxf(mx, mr[r]);
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const float f = exp2f(mr[r] - mx);
      fw[r * TH + g] = f;
      l += lr[r] * f;
    }
    inv_l[g] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  constexpr int Q4 = TH * LDV / 4, U = 4;  // float4s of the block's output
  const int e0 = rank * Q4 / S, e1 = (rank + 1) * Q4 / S;
  for (int e = e0 + tid; e < e1; e += U * TC_THREADS) {
    float4 v[U][S];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int x = min(e + u * TC_THREADS, e1 - 1);
      const int off = (x / (LDV / 4)) * ACC_LD + 4 * (x % (LDV / 4));
#pragma unroll
      for (int r = 0; r < S; ++r)
        v[u][r] = *reinterpret_cast<const float4*>(pa[r] + off);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int x = e + u * TC_THREADS, g = x / (LDV / 4);
      const int c4 = x % (LDV / 4), head = hb * TH + g;
      if (x >= e1 || head >= H) continue;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < S; ++r) {
        const float f = fw[r * TH + g];
        a.x = fmaf(v[u][r].x, f, a.x);
        a.y = fmaf(v[u][r].y, f, a.y);
        a.z = fmaf(v[u][r].z, f, a.z);
        a.w = fmaf(v[u][r].w, f, a.w);
      }
      const float il = inv_l[g];
      const __nv_bfloat162 lo2 = __floats2bfloat162_rn(a.x * il, a.y * il),
                           hi2 = __floats2bfloat162_rn(a.z * il, a.w * il);
      *reinterpret_cast<uint2*>(
          o + (static_cast<int64_t>(b) * H + head) * LDV + 4 * c4) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo2),
                     *reinterpret_cast<const uint32_t*>(&hi2));
    }
  }
}

__global__ void __launch_bounds__(TC_THREADS, 1)
    paged_latent_tc(const __grid_constant__ CUtensorMap pool_map,
                    const __nv_bfloat16* __restrict__ q,
                    const int* __restrict__ table,
                    const int* __restrict__ lens,
                    __nv_bfloat16* __restrict__ o, int H, int page,
                    int max_pages, int splits, float qscale) {
  using hopper::desc_sw128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const TcLayout L = tc_layout(max_pages);
  unsigned char* qs = base;
  unsigned char* ring = base + L.ring;
  float* xs = reinterpret_cast<float*>(base + L.xs);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.full);
  float* cm = reinterpret_cast<float*>(base + L.cm);
  float* cl = reinterpret_cast<float*>(base + L.cl);
  float* fw = reinterpret_cast<float*>(base + L.fw);
  float* inv_l = reinterpret_cast<float*>(base + L.inv_l);
  int* ids = reinterpret_cast<int*>(base + L.ids);
  float* cacc = reinterpret_cast<float*>(base);  // after the walk
  cg::cluster_group cluster = cg::this_cluster();

  const int rank = blockIdx.x, hb = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // q of the block's heads first (it does not wait for the length),
  // swizzled like the slots; heads past H zero
  for (int x = tid; x < TH * (LDK / 8); x += TC_THREADS) {
    const int h = x / (LDK / 8), ch = x % (LDK / 8), head = hb * TH + h;
    unsigned char* dst =
        qs + (ch / 8) * TH * 128 + h * 128 + ((ch % 8) ^ (h % 8)) * 16;
    if (head < H)
      cp_async16(dst, q + (static_cast<int64_t>(b) * H + head) * LDK + ch * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
  const int len = lens[b];
  const int n = len > 0 ? min(cdiv(len, page), max_pages) : 0;
  const int c = cdiv(n, splits);
  const int lo = min(n, rank * c), np = min(n, lo + c) - lo;
  const int pps = TOK / page;                  // pages a slot
  const int nslots = cdiv(np, pps);
  const int end = min(len, (lo + np) * page);  // this CTA's tokens end
  for (int i = tid; i < np; i += TC_THREADS)
    ids[i] = table[static_cast<int64_t>(b) * max_pages + lo + i];
  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // slot i into ring slot i % 3 (thread 0): pages past the CTA's share
  // repeat its last page
  auto load_slot = [&](int i) {
    const int s = i % TC_STAGES;
    hopper::mbar_expect_tx(&full[s], TOK * LDK * 2);
    unsigned char* dst = ring + s * SLOT;
    for (int u = 0; u < pps; ++u) {
      const int pid = ids[min(i * pps + u, np - 1)];
      for (int j = 0; j < KB; ++j)
        hopper::tma_load_2d(dst + j * TOK * 128 + u * page * 128, &pool_map,
                            64 * j, pid * page, &full[s]);
    }
  };
  if (tid == 0 && nslots) {
    hopper::prefetch_tmap(&pool_map);
    for (int i = 0; i < TC_STAGES && i < nslots; ++i) load_slot(i);
  }

  // consumer roles: warpgroup wg, rows (heads) r0 and r0 + 8 of the
  // block; the quad lane qd holds tokens / columns 2 qd, 2 qd + 1 of
  // each 8
  const int wg = warp / 4, r0 = 16 * (warp % 4) + lane / 4, qd = lane % 4;
  float oacc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) oacc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  cp_async_wait<0>();
  hopper::fence_proxy_async();
  __syncthreads();  // q is in place

  for (int i = 0; i < nslots; ++i) {
    const int s = i % TC_STAGES;
    hopper::mbar_wait(&full[s], (i / TC_STAGES) & 1);
    const unsigned char* slot = ring + s * SLOT;
    // S for this warpgroup's 16 tokens: rows r0, r0 + 8; tokens 16 wg +
    // 8j + 2qd + {0, 1}
    float own[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) own[k] = 0.f;
    hopper::fence_regs<8>(own);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < LDK / 16; ++ks) {
      const int blk = ks / 4, off = (ks % 4) * 32;
      hopper::wgmma_ss<16, 0, 0>(
          own, desc_sw128(qs + blk * TH * 128 + off, 16, 1024),
          desc_sw128(slot + blk * TOK * 128 + wg * 16 * 128 + off, 16,
                     1024), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<8>(own);
    // trade halves with the other warpgroup's same thread (two buffers:
    // a warpgroup writes buffer i % 2 only after both passed slot i - 1)
    float* mine = xs + ((i % 2) * TC_THREADS + tid) * 8;
    float* theirs = xs + ((i % 2) * TC_THREADS + (tid ^ 128)) * 8;
    *reinterpret_cast<float4*>(mine) =
        make_float4(own[0], own[1], own[2], own[3]);
    *reinterpret_cast<float4*>(mine + 4) =
        make_float4(own[4], own[5], own[6], own[7]);
    // both warpgroups are past slot i - 1: its ring slot takes slot
    // i + 2
    __syncthreads();
    if (tid == 0 && i >= 1 && i - 1 + TC_STAGES < nslots)
      load_slot(i - 1 + TC_STAGES);
    float oth[8];
    {
      const float4 x = *reinterpret_cast<const float4*>(theirs);
      const float4 y = *reinterpret_cast<const float4*>(theirs + 4);
      oth[0] = x.x; oth[1] = x.y; oth[2] = x.z; oth[3] = x.w;
      oth[4] = y.x; oth[5] = y.y; oth[6] = y.z; oth[7] = y.w;
    }
    // sc[4j + {0,1}]: row r0, tokens 8j + 2qd + {0,1}; sc[4j + {2,3}]:
    // row r0 + 8; j = 0..3 over the slot's 32 tokens
    float sc[16];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        sc[4 * j + k] = (j >> 1) == wg ? own[4 * (j & 1) + k]
                                       : oth[4 * (j & 1) + k];

    // the slot's online softmax, in the log2 domain
    const int tok0 = (lo + i * pps) * page;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int dt = 0; dt < 2; ++dt) {
        const bool ok = tok0 + 8 * j + 2 * qd + dt < end;
        sc[4 * j + dt] = ok ? sc[4 * j + dt] * qscale : NEG_INF;
        sc[4 * j + 2 + dt] = ok ? sc[4 * j + 2 + dt] * qscale : NEG_INF;
        mx0 = fmaxf(mx0, sc[4 * j + dt]);
        mx1 = fmaxf(mx1, sc[4 * j + 2 + dt]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2_ftz(m0 - mn0), c1 = exp2_ftz(m1 - mn1);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int dt = 0; dt < 2; ++dt) {
        sc[4 * j + dt] = exp2_ftz(sc[4 * j + dt] - mn0);
        sc[4 * j + 2 + dt] = exp2_ftz(sc[4 * j + 2 + dt] - mn1);
        s0 += sc[4 * j + dt];
        s1 += sc[4 * j + 2 + dt];
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    l0 = l0 * c0 + s0;
    l1 = l1 * c1 + s1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      oacc[4 * j] *= c0;
      oacc[4 * j + 1] *= c0;
      oacc[4 * j + 2] *= c1;
      oacc[4 * j + 3] *= c1;
    }
    // P as A fragments of each 16 tokens, hi and lo bf16 halves: a0
    // (r0, 2qd), a1 (r0 + 8, 2qd), a2 (r0, 8 + 2qd), a3 (r0 + 8, 8 + 2qd)
    uint32_t ph[TOK / 16][4], pl[TOK / 16][4];
#pragma unroll
    for (int t = 0; t < TOK / 16; ++t)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int at = 4 * (2 * t + (k >> 1)) + 2 * (k & 1);
        const float x = sc[at], y = sc[at + 1];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(x, y);
        const __nv_bfloat162 l2 = __floats2bfloat162_rn(
            x - __low2float(h2), y - __high2float(h2));
        ph[t][k] = *reinterpret_cast<const uint32_t*>(&h2);
        pl[t][k] = *reinterpret_cast<const uint32_t*>(&l2);
      }
    hopper::fence_regs<128>(oacc);
#pragma unroll
    for (int t = 0; t < TOK / 16; ++t) {
      hopper::fence_regs<4>(ph[t]);
      hopper::fence_regs<4>(pl[t]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < TOK / 16; ++t) {
      // V: columns [256 wg, 256 wg + 256) are column blocks 4wg..4wg+3
      // (MN atoms TOK * 128 B apart), tokens 16t.. (groups of 8 rows)
      const uint64_t dv = desc_sw128(slot + 4 * wg * TOK * 128 + t * 2048,
                                     TOK * 128, 1024);
      hopper::wgmma_rs<256, 1>(oacc, ph[t], dv, 1);
      hopper::wgmma_rs<256, 1>(oacc, pl[t], dv, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<128>(oacc);
  }
  hopper::fence_proxy_async();
  __syncthreads();  // q and the ring are dead: they take the accumulator

#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = 256 * wg + 8 * j + 2 * qd;
    *reinterpret_cast<float2*>(cacc + r0 * ACC_LD + col) =
        make_float2(oacc[4 * j], oacc[4 * j + 1]);
    *reinterpret_cast<float2*>(cacc + (r0 + 8) * ACC_LD + col) =
        make_float2(oacc[4 * j + 2], oacc[4 * j + 3]);
  }
  if (wg == 0 && qd == 0) {
    cm[r0] = m0;
    cl[r0] = l0;
    cm[r0 + 8] = m1;
    cl[r0 + 8] = l1;
  }
  cluster.sync();  // every CTA's state is written and visible
  const LatentState st{cm, cl, cacc, fw, inv_l};
  switch (splits) {
    case 1: latent_merge<1>(cluster, st, o, H, b, hb); break;
    case 2: latent_merge<2>(cluster, st, o, H, b, hb); break;
    case 3: latent_merge<3>(cluster, st, o, H, b, hb); break;
    case 4: latent_merge<4>(cluster, st, o, H, b, hb); break;
    case 5: latent_merge<5>(cluster, st, o, H, b, hb); break;
    case 6: latent_merge<6>(cluster, st, o, H, b, hb); break;
    case 7: latent_merge<7>(cluster, st, o, H, b, hb); break;
    default: latent_merge<8>(cluster, st, o, H, b, hb);
  }
  cluster.sync();  // no CTA leaves while a peer still reads its state
}

// The latent kernel's launch: grid (splits, head blocks, B), a cluster
// of `splits` along x; the pool as (P * page) rows of 576, boxes of 64
// columns x page rows.
cudaLaunchConfig_t latent_tc_config(int B, int H, int max_pages,
                                    int splits, cudaStream_t stream,
                                    cudaLaunchAttribute* at) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, cdiv(H, TH), B);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = tc_layout(max_pages).bytes;
  cfg.stream = stream;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

int latent_tc_attr() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_latent_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  return static_cast<int>(attr);
}

int launch_latent_tc(const void* q, const void* pool, int pool_pages,
                     const int* table, const int* lens, void* o, int B,
                     int H, int page, int max_pages, int splits,
                     float qscale, cudaStream_t stream) {
  if (const int attr = latent_tc_attr()) return attr;
  if (tc_layout(max_pages).bytes > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap pool_map;
  const uint64_t dims[2] = {LDK, static_cast<uint64_t>(pool_pages) * page};
  const uint64_t strides[1] = {LDK * 2};
  const uint32_t box[2] = {64, static_cast<uint32_t>(page)};
  const int err = hopper::encode_cached(
      &pool_map, hopper::map_shape(pool, 2, dims, strides, box));
  if (err) return err;
  cudaLaunchAttribute at[1];
  const cudaLaunchConfig_t cfg =
      latent_tc_config(B, H, max_pages, splits, stream, at);
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, paged_latent_tc, pool_map, static_cast<const __nv_bfloat16*>(q),
      table, lens, static_cast<__nv_bfloat16*>(o), H, page, max_pages,
      splits, qscale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of dynamic shared memory the kernel takes for a CTA of G query
// heads (the wrapper's check); esz is the pools' element size, 1 for
// int8 pools with their scales.
extern "C" int pa_smem_bytes(int G, int D, int page, int max_pages,
                             int walkers, int esz) {
  return layout(G, D, page, max_pages, walkers, esz).bytes;
}

// q: (B, H, D); pools: (P, page, KH, D); table: (B, max_pages) int32;
// lens: (B,) int32; o: (B, H, D) — all contiguous, on the device, pools
// 16-byte aligned.  dtype: 0 = float32, 1 = bfloat16.  Each KV head's
// H / KH query heads are split into `groups` groups of CTAs.  Needs D in
// {16, 32, 64, 112, 128}, page in {8, 16, 32}, KH · groups dividing H,
// (H / (KH · groups)) * D <= 2048, 1 <= splits <= 8 and
// 1 <= walkers <= 4.
extern "C" int pa_forward(int dtype, const void* q, const void* kp,
                          const void* vp, const void* table,
                          const void* lens, void* o, int B, int H, int KH,
                          int groups, int D, int page, int max_pages,
                          int splits, int walkers, void* stream) {
  if (KH < 1 || groups < 1 || H % (KH * groups) ||
      (H / (KH * groups)) * D > 2048 || splits < 1 ||
      splits > MAX_SPLITS || walkers < 1 || walkers > WARPS ||
      (page != 8 && page != 16 && page != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto tb = static_cast<const int*>(table);
  auto ln = static_cast<const int*>(lens);
  if (dtype == 0)
    return launch_t<float>(q, kp, vp, tb, ln, o, B, H, KH, groups, D, page,
                           max_pages, splits, walkers, st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, kp, vp, tb, ln, o, B, H, KH, groups,
                                   D, page, max_pages, splits, walkers, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The int8-pool form: q, o: (B, H, D) bf16; kp, vp: (P, page, KH, D)
// int8; ksc, vsc: (P, KH, page) fp16 scales; table, lens as above — all
// contiguous, on the device, the pools and the scale pools 16-byte
// aligned.  Needs D in {16, 32, 64, 128} and what pa_forward needs.
extern "C" int pa_forward_int8(const void* q, const void* kp, const void* vp,
                               const void* ksc, const void* vsc,
                               const void* table, const void* lens, void* o,
                               int B, int H, int KH, int groups, int D,
                               int page, int max_pages, int splits,
                               int walkers, void* stream) {
  if (KH < 1 || groups < 1 || H % (KH * groups) ||
      (H / (KH * groups)) * D > 2048 || splits < 1 ||
      splits > MAX_SPLITS || walkers < 1 || walkers > WARPS ||
      (page != 8 && page != 16 && page != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_int8(q, kp, vp, ksc, vsc, static_cast<const int*>(table),
                     static_cast<const int*>(lens), o, B, H, KH, groups, D,
                     page, max_pages, splits, walkers,
                     static_cast<cudaStream_t>(stream));
}

// Bytes of dynamic shared memory the latent kernel takes (the wrapper's
// check).
extern "C" int pa_latent_smem_bytes(int DK, int DV, int page, int max_pages,
                                    int esz) {
  return esz == 2 ? tc_layout(max_pages).bytes
                  : latent_layout(DK, DV, page, max_pages, esz).bytes;
}

// How many clusters of `splits` bf16 latent CTAs the card runs at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error code: what one
// wave of the latent kernel holds.
extern "C" int pa_latent_max_clusters(int max_pages, int splits) {
  if (const int attr = latent_tc_attr()) return -attr;
  cudaLaunchAttribute at[1];
  const cudaLaunchConfig_t cfg =
      latent_tc_config(1, TH, max_pages, splits, nullptr, at);
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&n, paged_latent_tc, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// The latent (MLA) form: q: (B, H, DK); pool: (P, page, DK), V its
// first DV columns; table: (B, max_pages) int32; lens: (B,) int32; o:
// (B, H, DV) — all contiguous, on the device, q and the pool 16-byte
// aligned.  dtype: 0 = float32 (the FMA kernel), 1 = bfloat16 (the
// tensor-core kernel).  Scores are scaled by `scale`.  Needs (DK, DV) =
// (576, 512), H a multiple of 16, page in {8, 16, 32} and 1 <= splits <=
// 8.
extern "C" int pa_latent_forward(int dtype, const void* q, const void* pool,
                                 const void* table, const void* lens,
                                 void* o, int B, int H, int DK, int DV,
                                 int pool_pages, int page, int max_pages,
                                 int splits, float scale, void* stream) {
  if (DK != LDK || DV != LDV || H < LH || H % LH || splits < 1 ||
      splits > MAX_SPLITS || (page != 8 && page != 16 && page != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto tb = static_cast<const int*>(table);
  auto ln = static_cast<const int*>(lens);
  const float qscale = scale * LOG2E;
  if (dtype == 0)
    return launch_latent<float, 576, 512>(q, pool, tb, ln, o, B, H, page,
                                          max_pages, splits, qscale, st);
  if (dtype == 1)
    return launch_latent_tc(q, pool, pool_pages, tb, ln, o, B, H, page,
                            max_pages, splits, qscale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
