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
//    CTAs (S <= 8 from the caller, grid (S, KH, B)).  Each CTA reads
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
//
// What still bounds it: about 7 us of fixed cost per launch (the
// cluster launch, two dependent round trips to device memory for the
// length and table row and then the first pages, and the merge), and
// the serial chain of a page inside one warp (QK, shuffles, PV).
//
// Arithmetic is fp32 FMA throughout, in the log2 domain (q is scaled by
// log2(e)/sqrt(D) once; ex2.approx); probabilities are not rounded
// before PV (the Pallas kernel does p.astype(f32)); positions >= len
// score -1e30; len = 0 gives zeros; l is floored at 1e-30; output in
// q's dtype.
//
// Each launcher returns cudaGetLastError() of its launch.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  int qs, ps, cs, wm, wl, cm, cl, cacc, fw, inv_l, ids, ring, row, bytes;
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
  const int ring = walkers * STAGES * 2 * page * L.row;
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

// T: pool dtype; D: head dim; MP: output element pairs a lane holds
// (ceil(G·D / 64) <= MP).
template <typename T, int D, int MP>
__global__ void __launch_bounds__(THREADS, 1)
    paged_fwd(const T* __restrict__ q, const T* __restrict__ kp,
              const T* __restrict__ vp, const int* __restrict__ table,
              const int* __restrict__ lens, T* __restrict__ o, int H, int KH,
              int page, int max_pages, int splits, int walkers,
              float qscale) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = H / KH, GD = G * D;
  const Layout L = layout(G, D, page, max_pages, walkers, sizeof(T));
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* cm = reinterpret_cast<float*>(smem + L.cm);
  float* cl = reinterpret_cast<float*>(smem + L.cl);
  float* cacc = reinterpret_cast<float*>(smem + L.cacc);
  float* fw = reinterpret_cast<float*>(smem + L.fw);
  float* inv_l = reinterpret_cast<float*>(smem + L.inv_l);
  int* ids = reinterpret_cast<int*>(smem + L.ids);

  const int rank = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = lens[b];
  const int n = len > 0 ? min(cdiv(len, page), max_pages) : 0;
  const int c = cdiv(n, splits);
  const int lo = min(n, rank * c), np = min(n, lo + c) - lo;

  // q, the length and the whole table row are loaded together (none
  // waits for another); the CTA's range then indexes the row
  const T* qb = q + (static_cast<int64_t>(b) * H + kh * G) * D;
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

  unsigned char* ring = smem + L.ring + warp * STAGES * 2 * page * L.row;
  const int split = 32 / page, t = lane % page, part = lane / page;
  const int pe = D / split;                    // elements per slice
  // the first `walkers` warps walk the pages (all four unless their
  // rings would not fit); the others keep an empty state
  const int nw =
      warp < walkers && np > warp ? cdiv(np - warp, walkers) : 0;
  const int chunks = D * static_cast<int>(sizeof(T)) / 16;  // per row
  const size_t kh_off = static_cast<size_t>(kh) * D;

  // the warp's i-th page (local page warp + i·walkers) into its ring slot
  auto load = [&](int i) {
    if (i < nw) {
      const int64_t pid = ids[lo + warp + i * walkers];
      unsigned char* ks = ring + (i % STAGES) * 2 * page * L.row;
      unsigned char* vs = ks + page * L.row;
      for (int x = lane; x < page * chunks; x += 32) {
        const int r = x / chunks, cc = x % chunks;
        const size_t src = (static_cast<size_t>(pid) * page + r) * KH * D +
                           kh_off + cc * (16 / sizeof(T));
        cp_async16(ks + r * L.row + cc * 16, kp + src);
        cp_async16(vs + r * L.row + cc * 16, vp + src);
      }
    }
    cp_async_commit();  // an empty group keeps the wait counts uniform
  };
  load(0);

  for (int i = 0; i < nw; ++i) {
    load(i + 1);
    cp_async_wait<STAGES - 1>();
    __syncwarp();  // page i has landed for every lane of the warp
    const unsigned char* ks = ring + (i % STAGES) * 2 * page * L.row;
    const unsigned char* vs = ks + page * L.row;
    const int pos = (lo + warp + i * walkers) * page + t;
    const T* krow = reinterpret_cast<const T*>(ks + t * L.row) + part * pe;

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
      if (sizeof(T) == 4 || pe % 8 == 0)
        qk_slice<sizeof(T) == 4 ? 4 : 8>(krow, qrow, g0, G, D, pe, s);
      else
        qk_slice<4>(krow, qrow, g0, G, D, pe, s);
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
        if (part == 0 && h < nh) ps[t * G + g0 + h] = s[h];
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
      const T* vrow = reinterpret_cast<const T*>(vs + tt * L.row);
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
  T* ob = o + (static_cast<int64_t>(b) * H + kh * G) * D;
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

template <typename T, int D, int MP>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* lens, void* o, int B, int H, int KH, int page,
           int max_pages, int splits, int walkers, cudaStream_t stream) {
  auto kern = paged_fwd<T, D, MP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Layout L = layout(H / KH, D, page, max_pages, walkers, sizeof(T));
  if (L.bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KH, B);
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
      &cfg, kern, static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lens, static_cast<T*>(o), H, KH, page,
      max_pages, splits, walkers, LOG2E / sqrtf(static_cast<float>(D)));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// MP, the pairs a lane holds, is the least of 8, 16, 32 that covers G·D:
// every pair is computed, so a tier sized to G·D keeps the waste small.
template <typename T, int D>
int launch_d(const void* q, const void* kp, const void* vp, const int* tb,
             const int* ln, void* o, int B, int H, int KH, int page, int mp,
             int splits, int walkers, cudaStream_t st) {
  const int gd = (H / KH) * D;
  if (gd <= 8 * 64)
    return launch<T, D, 8>(q, kp, vp, tb, ln, o, B, H, KH, page, mp, splits,
                           walkers, st);
  if (gd <= 16 * 64)
    return launch<T, D, 16>(q, kp, vp, tb, ln, o, B, H, KH, page, mp, splits,
                            walkers, st);
  return launch<T, D, 32>(q, kp, vp, tb, ln, o, B, H, KH, page, mp, splits,
                          walkers, st);
}

template <typename T>
int launch_t(const void* q, const void* kp, const void* vp, const int* tb,
             const int* ln, void* o, int B, int H, int KH, int D, int page,
             int mp, int splits, int walkers, cudaStream_t st) {
  switch (D) {
    case 16: return launch_d<T, 16>(q, kp, vp, tb, ln, o, B, H, KH, page, mp,
                                    splits, walkers, st);
    case 32: return launch_d<T, 32>(q, kp, vp, tb, ln, o, B, H, KH, page, mp,
                                    splits, walkers, st);
    case 64: return launch_d<T, 64>(q, kp, vp, tb, ln, o, B, H, KH, page, mp,
                                    splits, walkers, st);
    case 128: return launch_d<T, 128>(q, kp, vp, tb, ln, o, B, H, KH, page,
                                      mp, splits, walkers, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Bytes of dynamic shared memory the kernel takes (the wrapper's check).
extern "C" int pa_smem_bytes(int G, int D, int page, int max_pages,
                             int walkers, int esz) {
  return layout(G, D, page, max_pages, walkers, esz).bytes;
}

// q: (B, H, D); pools: (P, page, KH, D); table: (B, max_pages) int32;
// lens: (B,) int32; o: (B, H, D) — all contiguous, on the device, pools
// 16-byte aligned.  dtype: 0 = float32, 1 = bfloat16.  Needs D in {16,
// 32, 64, 128}, page in {8, 16, 32}, (H / KH) * D <= 2048, 1 <= splits
// <= 8 and 1 <= walkers <= 4.
extern "C" int pa_forward(int dtype, const void* q, const void* kp,
                          const void* vp, const void* table,
                          const void* lens, void* o, int B, int H, int KH,
                          int D, int page, int max_pages, int splits,
                          int walkers, void* stream) {
  if ((H / KH) * D > 2048 || splits < 1 || splits > MAX_SPLITS ||
      walkers < 1 || walkers > WARPS ||
      (page != 8 && page != 16 && page != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto tb = static_cast<const int*>(table);
  auto ln = static_cast<const int*>(lens);
  if (dtype == 0)
    return launch_t<float>(q, kp, vp, tb, ln, o, B, H, KH, D, page,
                           max_pages, splits, walkers, st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, kp, vp, tb, ln, o, B, H, KH, D, page,
                                   max_pages, splits, walkers, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
