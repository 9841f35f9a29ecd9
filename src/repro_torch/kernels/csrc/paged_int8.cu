// Paged decode attention over the INT8 KV cache for Hopper (sm_90a): one
// query token per sequence against int8 K/V pools (P, page, KH, D) and
// their fp16 scale pools (P, KH, page), one scale per (token, KV head),
// reached through a per-sequence page table.  Replaces the Pallas kernel
// _paged_kernel of src/repro/kernels/paged_attention.py over the pools
// of the reference's Tuning.kv_cache_quant, whose int8 decode is XLA's
// decode_attention with k_scale / v_scale (src/repro/models/layers.py:
// 148-177): bf16 q and output, the K scale folded into each score, the
// V scale into each stored probability (P kept in fp32), positions >= len
// masked at -1e30, len = 0 giving zeros.
//
// The same launch can also append the decode step's token (the
// pa_append_forward_int8 entry): it takes the step's bf16 K and V rows
// (B, KH, D) and their flat pool rows, quantizes them with exactly the
// arithmetic of kv_quant.cu (fp32 product by 1/127, IEEE quotient, the
// bf16 roundings, saturation), attends over them, and stores the codes
// and scales, so a decode step has no quantize launch of its own.
//
// What bounds it on the H100: bytes.  At qwen1.5-32b's decode step (8
// sequences of 272 tokens, 40 / 40 heads of 128) the pools and scales
// are 22.6 MB, 6.8 us at 3.35 TB/s, and each code meets one FMA a query
// head.  What held the first int8 kernel (paged_fwd over int8 pools) at
// 12% of that bound was arithmetic done for nothing: 8 heads scored
// where G = 1 needs one, 8 output pairs a lane where 2 do, every code
// through an I2F (16 a clock an SM), and each warp's pages brought by
// 512 cp.async each.  The design:
//
//  * A compile-time tier GB in {1, 2, 4, 8} of query heads a CTA; the
//    caller cuts a KV head's G query heads into head groups of at most 8
//    (grid row y = kh * groups + group; int8_plan takes one head a group
//    where the grid is small).  The QK and PV loops do only the CTA's
//    heads: a tier's heads past the live ones are skipped by a uniform
//    branch.  Where GB times a lane's slice of D is at most 32 values
//    (always at GB 1), q's slice lives in registers.
//  * Dequantization without I2F: four codes of a 32-bit word become fp32
//    by one XOR (c ^ 0x80 is c + 128 as an unsigned byte), one
//    __byte_perm each into 0x4B0000uu (2^23 + u) and one FADD of
//    -(2^23 + 128), exact.  QK reads 4, 8 or 16 codes a lane at a time,
//    PV 4 (one 32-bit word: a lane owns 4 columns of every head).
//  * Each warp walks its own pages (the CTA's pages dealt round-robin)
//    through its own ring of 2-4 slots.  A slot is one (page, KV head)
//    box of K and one of V brought by one TMA load each, through a
//    tensor map over the pool as (P * page, KH, D) with box (page, 1,
//    D), swizzled by D (128-, 64- or 32-byte rows, none at D 16), plus a
//    1-D bulk copy of each scale page; all four complete on the slot's
//    mbarrier.  One lane issues a page's loads, no thread spends a
//    register on them, and the warp waits on the barrier's phase.
//  * QK: a lane takes a slice of at most 32 codes of D for one token of
//    each pass of 8-32 tokens over the page (lane = part * TP + t); the
//    swizzle keeps the 8 tokens a quarter-warp reads in 8 distinct bank
//    quads.  The slices are summed and the page's max taken by warp
//    shuffles; every lane keeps every head's m, and its own share of l,
//    summed over the warp once after the walk.  PV: lane = group * (D /
//    4) + column quad; the token groups (D < 128) are summed once after
//    the walk.
//  * The pages of a sequence split over a thread-block cluster of S CTAs
//    (int8_plan in paged_attention.py; no cluster attribute at S = 1),
//    merged in rank order through distributed shared memory after the
//    warps' states are merged in order: one launch, no workspace, no
//    atomics, the same bits on every run.  The launch bounds ask for
//    registers for three CTAs an SM (four at GB <= 2 and D <= 64).
//  * The append: the CTA (every head group of it) whose page range holds
//    position len - 1 quantizes that row of its KV head at the start,
//    writes those codes and scales over the staged copy once the page
//    has landed (never reading them back from the pool), and head group
//    0 of that rank alone stores them to the pools.  No CTA depends on
//    another's global write, so no fence across CTAs is needed.
//
// What still bounds it: a fixed cost a launch, the dependent chain of
// the length, the table row and the first pages, then the merge; a
// development variant that only streamed the pages (no QK or PV) took
// most of the kernel's time at qwen1.5-32b's 8 x 272.
//
// Each launcher returns cudaGetLastError() of its launch, or the tensor
// map's encoding error.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <utility>
#include <vector>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NW = 4, NT = 32 * NW;  // warps, threads a CTA

// CTAs an SM the launch bounds ask registers for: four for the one- and
// two-head tiers at D <= 64, three else (int8_plan's wave is this many
// CTAs an SM).
__host__ __device__ constexpr int min_ctas(int GB, int D) {
  return GB <= 2 && D <= 64 ? 4 : 3;
}
constexpr int MAX_SPLITS = 8;     // portable thread-block cluster size
constexpr int MIN_RING = 2, MAX_RING = 4;  // page slots a warp
constexpr int MAX_SMEM = 227 * 1024;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MAGIC = 8388736.f;               // 2^23 + 128
constexpr float INV127 = 0.007874015718698502f;  // fp32(1 / 127)
constexpr float EPS = 1.0011717677116394e-08f;   // fp32(bf16(1e-8))

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Take `bytes` at offset o, keeping every region 16-byte aligned.
__host__ __device__ inline int take(int& o, int bytes) {
  const int at = o;
  o += (bytes + 15) / 16 * 16;
  return at;
}

// Shared memory, in bytes from the CTA's 1,024-aligned base: the warps'
// rings of K and V boxes (which the warps' partial outputs take over
// after the walk), the slots' scale pages, a barrier a slot, q, each
// warp's probabilities, the warps' and the CTA's states, the merge
// weights, the appended row and the CTA's page ids.
struct Layout {
  int ring, scales, bars, qs, ps, wm, wl, wf, cm, cl, cacc, fw, inv_l,
      stash, ids, bytes;
};

__host__ __device__ inline Layout layout(int GB, int D, int page,
                                         int max_pages, int ring) {
  Layout L;
  const int slots = NW * ring, box = page * D;
  const int boxes = slots * 2 * box, part = NW * GB * D * 4;
  int o = 0;
  L.ring = take(o, boxes > part ? boxes : part);
  L.scales = take(o, slots * 2 * page * 2);   // [slot][K, V][page] fp16
  L.bars = take(o, slots * 8);
  L.qs = take(o, GB * D * 4);                 // q * log2(e)/sqrt(D)
  L.ps = take(o, NW * page * GB * 4);         // [warp][page][GB]
  L.wm = take(o, NW * GB * 4);
  L.wl = take(o, NW * GB * 4);
  L.wf = take(o, NW * GB * 4);
  L.cm = take(o, GB * 4);
  L.cl = take(o, GB * 4);
  L.cacc = take(o, GB * D * 4);
  L.fw = take(o, MAX_SPLITS * GB * 4);
  L.inv_l = take(o, GB * 4);
  L.stash = take(o, 2 * D + 4);               // K, V codes; their scales
  L.ids = take(o, max_pages * 4);
  L.bytes = 1024 + o;                         // with the aligning slack
  return L;
}

// A box byte's place in shared memory under the TMA's swizzle of D-byte
// rows: the 16-byte chunk index XORed with the row's place in its atom
// (CUTLASS Swizzle<3|2|1, 4, 3>).
template <int D>
__device__ __forceinline__ int swz(int off) {
  if constexpr (D == 128) return off ^ ((off >> 3) & 0x70);
  else if constexpr (D == 64) return off ^ ((off >> 3) & 0x30);
  else if constexpr (D == 32) return off ^ ((off >> 3) & 0x10);
  else return off;
}

// Four int8 codes of a word as exact fp32 values, without I2F.
__device__ __forceinline__ void dequant4(uint32_t w, float* f) {
  const uint32_t x = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440)) - MAGIC;
  f[1] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7441)) - MAGIC;
  f[2] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7442)) - MAGIC;
  f[3] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7443)) - MAGIC;
}

// 2^x, flushing results below 2^-126 to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A 1-D bulk copy from global memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(hopper::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(hopper::smem_addr(bar))
      : "memory");
}

struct Args {
  const __nv_bfloat16* q;     // (B, H, D)
  __nv_bfloat16* o;           // (B, H, D)
  __half* ksc;                // (P, KH, page) fp16 scale pools
  __half* vsc;
  const int* table;           // (B, max_pages)
  const int* lens;            // (B,)
  // the append (null without it): the step's rows (B, KH, D), their flat
  // pool rows (B,), and the int8 pools they are stored in
  const __nv_bfloat16* knew;
  const __nv_bfloat16* vnew;
  const int64_t* rows;
  int8_t* kp;
  int8_t* vp;
  int H, KH, groups, max_pages, splits, ring;
  float qscale;               // log2(e) / sqrt(D)
};

// Grid (S, KH * groups, B), a cluster of S along x (no cluster at S 1).
template <int D, int PAGE, int GB>
__global__ void __launch_bounds__(NT, min_ctas(GB, D))
    paged_int8_fwd(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const Args a) {
  // QK: a lane takes PE codes of a token, SPLIT lanes a token, TP tokens
  // a pass, NPASS passes a page
  constexpr int PE = D * PAGE / 32 < 32 ? D * PAGE / 32 : 32;
  constexpr int SPLIT = D / PE, TP = 32 / SPLIT, NPASS = PAGE / TP;
  constexpr int VEC = PE < 16 ? PE : 16;    // codes a load
  constexpr int NA = GB >= 4 ? 1 : 4 / GB;  // partial sums a head (ILP)
  constexpr bool QREG = GB * PE <= 32;      // q's slice in registers
  constexpr int L = D / 4;                  // lanes of a V row (PV)
  constexpr int TG = 32 / L;                // token groups (PV)
  constexpr int BOX = PAGE * D;
  constexpr unsigned FULL = 0xffffffffu;
  static_assert(VEC == 4 || VEC == 8 || VEC == 16, "QK reads 4-16 codes");
  static_assert(NPASS * TP == PAGE && TP >= 8, "whole passes of 8+ tokens");
  static_assert(L <= 32 && 32 % L == 0, "a V row within a warp");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  cg::cluster_group cluster = cg::this_cluster();
  const Layout Lo = layout(GB, D, PAGE, a.max_pages, a.ring);
  const int gh = a.H / (a.KH * a.groups);   // this CTA's query heads
  const int rank = blockIdx.x, y = blockIdx.y, kh = y / a.groups;
  const int b = blockIdx.z, h0 = y * gh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = a.lens[b];
  const int n = len > 0 ? min(cdiv(len, PAGE), a.max_pages) : 0;
  const int c = cdiv(n, a.splits);
  const int lo = min(n, rank * c), np = min(n, lo + c) - lo;
  const int nw = np > warp ? cdiv(np - warp, NW) : 0;

  uint64_t* bars = reinterpret_cast<uint64_t*>(base + Lo.bars) + warp * a.ring;
  unsigned char* kring = base + Lo.ring + warp * a.ring * 2 * BOX;
  __half* sring =
      reinterpret_cast<__half*>(base + Lo.scales) + warp * a.ring * 2 * PAGE;
  // the warp's i-th page (local page warp + i * NW, pool page pid) into
  // its slot
  auto issue = [&](int i, int pid) {
    const int s = i % a.ring;
    uint64_t* bar = bars + s;
    unsigned char* kd = kring + s * 2 * BOX;
    __half* sd = sring + s * 2 * PAGE;
    const int64_t so = (static_cast<int64_t>(pid) * a.KH + kh) * PAGE;
    hopper::mbar_expect_tx(bar, 2 * BOX + 4 * PAGE);
    hopper::tma_load_3d(kd, &kmap, 0, kh, pid * PAGE, bar);
    hopper::tma_load_3d(kd + BOX, &vmap, 0, kh, pid * PAGE, bar);
    bulk_load(sd, a.ksc + so, 2 * PAGE, bar);
    bulk_load(sd + PAGE, a.vsc + so, 2 * PAGE, bar);
  };
  // lane 0 of each warp starts its first pages at once, their ids read
  // from the table itself; the CTA's ids reach shared memory meanwhile
  const int* trow = a.table + static_cast<int64_t>(b) * a.max_pages + lo;
  if (lane == 0) {
    for (int s = 0; s < a.ring; ++s) hopper::mbar_init(bars + s, 1);
    hopper::fence_barrier_init();
    if (nw) {
      hopper::prefetch_tmap(&kmap);
      hopper::prefetch_tmap(&vmap);
      for (int i = 0; i < nw && i < a.ring; ++i) issue(i, trow[warp + i * NW]);
    }
  }
  int* ids = reinterpret_cast<int*>(base + Lo.ids);
  for (int i = tid; i < np; i += NT) ids[i] = trow[i];
  float* qs = reinterpret_cast<float*>(base + Lo.qs);
  const __nv_bfloat16* qb = a.q + (static_cast<int64_t>(b) * a.H + h0) * D;
  if constexpr (!QREG)
    for (int i = tid; i < gh * D; i += NT)
      qs[i] = __bfloat162float(qb[i]) * a.qscale;

  // The append: the rank whose range holds page (len - 1) / page (rank 0
  // where there is none), and the local page to patch (-1: none here).
  const bool append = a.knew != nullptr;
  int hold = 0, patch = -1;
  if (n > 0) {
    const int pg = (len - 1) / PAGE;
    hold = min(pg, n - 1) / c;
    if (append && pg < n && hold == rank) patch = pg - lo;
  }
  unsigned char* stash = base + Lo.stash;     // [K, V][D] codes, 2 scales
  __half* stash_sc = reinterpret_cast<__half*>(stash + 2 * D);
  if (append && rank == hold && warp < 2) {
    // warp 0 quantizes the K row, warp 1 the V row: a group of D / 8
    // lanes, 8 values a lane, exactly as kv_quant.cu
    constexpr int TPG = D / 8;
    const int sub = lane % TPG;
    const __nv_bfloat16* src = (warp ? a.vnew : a.knew) +
                               (static_cast<int64_t>(b) * a.KH + kh) * D +
                               sub * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    float x[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[2 * j] = __uint_as_float(w[j] << 16);
      x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(x[j]));
#pragma unroll
    for (int off = 1; off < TPG; off <<= 1)
      m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    const float s = bf16_round(bf16_round(__fmul_rn(m, INV127)) + EPS);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float cc = rintf(bf16_round(__fdiv_rn(x[j], s)));
      cc = fminf(fmaxf(cc, -128.f), 127.f);
      const uint32_t bb = static_cast<uint32_t>(static_cast<int>(cc)) & 0xffu;
      packed[j / 4] |= bb << (8 * (j % 4));
    }
    const __half hs = __float2half_rn(s);
    if (lane < TPG) {
      *reinterpret_cast<uint2*>(stash + warp * D + sub * 8) =
          make_uint2(packed[0], packed[1]);
      if (sub == 0) stash_sc[warp] = hs;
      if (y % a.groups == 0) {     // head group 0 alone stores the row
        const int64_t row = a.rows[b];
        int8_t* dst = (warp ? a.vp : a.kp) + (row * a.KH + kh) * D + sub * 8;
        *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
        if (sub == 0)
          (warp ? a.vsc : a.ksc)[(row / PAGE * a.KH + kh) * PAGE +
                                 row % PAGE] = hs;
      }
    }
  }
  __syncthreads();  // page ids, q and the appended row in place

  const int t = lane % TP, part = lane / TP;  // QK
  const int cl = lane % L, tg = lane / L;     // PV
  float qr[QREG ? GB : 1][QREG ? PE : 1];
  if constexpr (QREG) {
#pragma unroll
    for (int h = 0; h < GB; ++h)
#pragma unroll
      for (int e = 0; e < PE; e += 2) {
        float2 v = make_float2(0.f, 0.f);
        if (h < gh)
          v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              qb + h * D + part * PE + e));
        qr[h][e] = v.x * a.qscale;
        qr[h][e + 1] = v.y * a.qscale;
      }
  }
  // the warp's state: every lane holds every head's m; l is this lane's
  // share (summed over the warp after the walk); acc its 4 columns
  float m[GB], l[GB], acc[GB][4];
#pragma unroll
  for (int h = 0; h < GB; ++h) {
    m[h] = NEG_INF;
    l[h] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[h][j] = 0.f;
  }
  float* ps = reinterpret_cast<float*>(base + Lo.ps) + warp * PAGE * GB;

  for (int i = 0; i < nw; ++i) {
    const int s = i % a.ring;
    hopper::mbar_wait(bars + s, (i / a.ring) & 1);
    unsigned char* kb = kring + s * 2 * BOX;
    unsigned char* vb = kb + BOX;
    __half* sb = sring + s * 2 * PAGE;
    if (warp + i * NW == patch) {
      // the appended row: this CTA's own codes and scales over the copy
      // the TMA brought (what the pool held before this step)
      const int t0 = (len - 1) % PAGE;
      if (lane < L) {
        *reinterpret_cast<uint32_t*>(kb + swz<D>(t0 * D + 4 * lane)) =
            reinterpret_cast<const uint32_t*>(stash)[lane];
        *reinterpret_cast<uint32_t*>(vb + swz<D>(t0 * D + 4 * lane)) =
            reinterpret_cast<const uint32_t*>(stash + D)[lane];
      }
      if (lane == 0) {
        sb[t0] = stash_sc[0];
        sb[PAGE + t0] = stash_sc[1];
      }
      hopper::fence_proxy_async();  // before a later TMA refills the slot
      __syncwarp();
    }

    // QK: tokens p * TP + t of the passes p, slice `part` of D, every
    // head of the CTA
    float sacc[NPASS][GB][NA];
#pragma unroll
    for (int p = 0; p < NPASS; ++p)
#pragma unroll
      for (int h = 0; h < GB; ++h)
#pragma unroll
        for (int u = 0; u < NA; ++u) sacc[p][h][u] = 0.f;
#pragma unroll
    for (int e = 0; e < PE; e += VEC) {
#pragma unroll
      for (int p = 0; p < NPASS; ++p) {
        const unsigned char* src =
            kb + swz<D>((p * TP + t) * D + part * PE + e);
        float f[VEC];
        if constexpr (VEC == 16) {
          const uint4 w = *reinterpret_cast<const uint4*>(src);
          dequant4(w.x, f);
          dequant4(w.y, f + 4);
          dequant4(w.z, f + 8);
          dequant4(w.w, f + 12);
        } else if constexpr (VEC == 8) {
          const uint2 w = *reinterpret_cast<const uint2*>(src);
          dequant4(w.x, f);
          dequant4(w.y, f + 4);
        } else {
          dequant4(*reinterpret_cast<const uint32_t*>(src), f);
        }
#pragma unroll
        for (int h = 0; h < GB; ++h) {
          if (GB > 1 && h >= gh) continue;
#pragma unroll
          for (int v = 0; v < VEC; v += 4) {
            float4 q4;
            if constexpr (QREG) {
              q4 = make_float4(qr[h][e + v], qr[h][e + v + 1],
                               qr[h][e + v + 2], qr[h][e + v + 3]);
            } else {
              q4 = *reinterpret_cast<const float4*>(qs + h * D + part * PE +
                                                    e + v);
            }
            float* sa = sacc[p][h];
            sa[(v + 0) % NA] = fmaf(q4.x, f[v], sa[(v + 0) % NA]);
            sa[(v + 1) % NA] = fmaf(q4.y, f[v + 1], sa[(v + 1) % NA]);
            sa[(v + 2) % NA] = fmaf(q4.z, f[v + 2], sa[(v + 2) % NA]);
            sa[(v + 3) % NA] = fmaf(q4.w, f[v + 3], sa[(v + 3) % NA]);
          }
        }
      }
    }
    // the slices' sums, then the page's max (each level for every pass and
    // head at once); the sum of p stays per lane until the walk ends
    float sc[NPASS][GB], mx[GB], corr[GB];
#pragma unroll
    for (int p = 0; p < NPASS; ++p)
#pragma unroll
      for (int h = 0; h < GB; ++h) {
        sc[p][h] = 0.f;
#pragma unroll
        for (int u = 0; u < NA; ++u) sc[p][h] += sacc[p][h][u];
      }
#pragma unroll
    for (int off = TP; off < 32; off <<= 1)
#pragma unroll
      for (int p = 0; p < NPASS; ++p)
#pragma unroll
        for (int h = 0; h < GB; ++h)
          sc[p][h] += __shfl_xor_sync(FULL, sc[p][h], off);
    float kst[NPASS], vst[NPASS];
#pragma unroll
    for (int p = 0; p < NPASS; ++p) {
      kst[p] = __half2float(sb[p * TP + t]);
      vst[p] = __half2float(sb[PAGE + p * TP + t]);
    }
    const int pos0 = (lo + warp + i * NW) * PAGE + t;
#pragma unroll
    for (int h = 0; h < GB; ++h) {
      mx[h] = NEG_INF;
#pragma unroll
      for (int p = 0; p < NPASS; ++p) {
        sc[p][h] = pos0 + p * TP < len ? sc[p][h] * kst[p] : NEG_INF;
        mx[h] = fmaxf(mx[h], sc[p][h]);
      }
    }
#pragma unroll
    for (int off = 1; off < TP; off <<= 1)
#pragma unroll
      for (int h = 0; h < GB; ++h)
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], off));
#pragma unroll
    for (int h = 0; h < GB; ++h) {
      const float mn = fmaxf(m[h], mx[h]);
      corr[h] = exp2_ftz(m[h] - mn);
      m[h] = mn;
      float sum = 0.f;
#pragma unroll
      for (int p = 0; p < NPASS; ++p) {
        sc[p][h] = exp2_ftz(sc[p][h] - mn);
        sum += sc[p][h];
      }
      l[h] = l[h] * corr[h] + (part == 0 ? sum : 0.f);
    }
    if (part == 0)   // PV's weight: p times the token's V scale
#pragma unroll
      for (int p = 0; p < NPASS; ++p)
#pragma unroll
        for (int h = 0; h < GB; ++h)
          ps[(p * TP + t) * GB + h] = sc[p][h] * vst[p];
    __syncwarp();    // p is visible to the warp

    // PV: this lane's 4 columns of every head over its token group
#pragma unroll
    for (int h = 0; h < GB; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[h][j] *= corr[h];
#pragma unroll
    for (int k = 0; k < PAGE / TG; ++k) {
      const int tt = tg + k * TG;
      float f[4];
      dequant4(*reinterpret_cast<const uint32_t*>(vb + swz<D>(tt * D + 4 * cl)),
               f);
      const float* pr = ps + tt * GB;
#pragma unroll
      for (int h = 0; h < GB; ++h) {
        if (GB > 1 && h >= gh) continue;
        const float pp = pr[h];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[h][j] = fmaf(pp, f[j], acc[h][j]);
      }
    }
    __syncwarp();    // the slot and the scratch are free
    if (lane == 0 && i + a.ring < nw)
      issue(i + a.ring, ids[warp + (i + a.ring) * NW]);
  }

  // the lanes' shares of l and the token groups' sums (D < 128), then
  // the warps' states in order
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
#pragma unroll
    for (int h = 0; h < GB; ++h) l[h] += __shfl_xor_sync(FULL, l[h], off);
#pragma unroll
  for (int off = L; off < 32; off <<= 1)
#pragma unroll
    for (int h = 0; h < GB; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[h][j] += __shfl_xor_sync(FULL, acc[h][j], off);
  __syncthreads();  // every warp has left the ring: it takes the warps' acc
  float* pacc = reinterpret_cast<float*>(base + Lo.ring);  // [W][GB][D]
  float* wm = reinterpret_cast<float*>(base + Lo.wm);
  float* wl = reinterpret_cast<float*>(base + Lo.wl);
  float* wf = reinterpret_cast<float*>(base + Lo.wf);
  float* cm = reinterpret_cast<float*>(base + Lo.cm);
  float* clv = reinterpret_cast<float*>(base + Lo.cl);
  float* cacc = reinterpret_cast<float*>(base + Lo.cacc);
  float* fw = reinterpret_cast<float*>(base + Lo.fw);
  float* inv_l = reinterpret_cast<float*>(base + Lo.inv_l);
#pragma unroll
  for (int h = 0; h < GB; ++h) {
    if (h >= gh) continue;
    if (tg == 0)
      *reinterpret_cast<float4*>(pacc + (warp * GB + h) * D + 4 * cl) =
          make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
    if (lane == 0) {
      wm[warp * GB + h] = m[h];
      wl[warp * GB + h] = l[h];
    }
  }
  __syncthreads();
  for (int g = tid; g < gh; g += NT) {
    float mw = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mw = fmaxf(mw, wm[w * GB + g]);
    float lw = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = exp2f(wm[w * GB + g] - mw);
      wf[w * GB + g] = f;
      lw += wl[w * GB + g] * f;
    }
    cm[g] = mw;
    clv[g] = lw;
  }
  __syncthreads();
  for (int e = tid; e < gh * D; e += NT) {
    const int g = e / D, d = e % D;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      v = fmaf(pacc[(w * GB + g) * D + d], wf[w * GB + g], v);
    cacc[e] = v;
  }
  cluster.sync();  // every CTA's state is written and visible

  // CTA `rank` finishes elements [rank·E/S, (rank+1)·E/S) of the E = gh·D,
  // merging the S states in rank order.  Every one of the 8 rank slots is
  // read (ranks past S read rank S - 1 and weigh 0), so no load waits on a
  // branch.
  const int last = a.splits - 1;
  for (int g = tid; g < gh; g += NT) {
    float mr[MAX_SPLITS], lr[MAX_SPLITS], mx = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      const int rr = min(r, last);
      mr[r] = cluster.map_shared_rank(cm, rr)[g];
      lr[r] = cluster.map_shared_rank(clv, rr)[g];
    }
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) mx = fmaxf(mx, mr[r]);
    float lsum = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      const float f = r <= last ? exp2f(mr[r] - mx) : 0.f;
      fw[r * GB + g] = f;
      lsum += lr[r] * f;
    }
    inv_l[g] = 1.f / fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  const int E = gh * D;
  const int e0 = rank * E / a.splits, e1 = (rank + 1) * E / a.splits;
  __nv_bfloat16* ob = a.o + (static_cast<int64_t>(b) * a.H + h0) * D;
  for (int e = e0 + tid; e < e1; e += NT) {
    const int g = e / D;
    float v[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      v[r] = cluster.map_shared_rank(cacc, min(r, last))[e];
    float sacc2 = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r)
      sacc2 = fmaf(v[r], fw[r * GB + g], sacc2);
    ob[e] = __float2bfloat16(sacc2 * inv_l[g]);
  }
  cluster.sync();  // no CTA leaves while a peer still reads its state
}

// A tensor map over an int8 pool (P, page, KH, D) seen as (P * page, KH,
// D), innermost first (D, KH, P * page), whose box (D, 1, page) is one KV
// head's rows of a page; rows swizzled by D bytes (none at D 16).  Pools
// stay put, so each is encoded once and kept (the oldest of 256 dropped
// first).
struct PoolKey {
  const void* ptr;
  int P, page, KH, D;
};

int pool_map(CUtensorMap* m, const void* pool, int P, int page, int KH,
             int D) {
  static std::vector<std::pair<PoolKey, CUtensorMap>> cache;
  for (const auto& e : cache)
    if (e.first.ptr == pool && e.first.P == P && e.first.page == page &&
        e.first.KH == KH && e.first.D == D) {
      *m = e.second;
      return 0;
    }
  static thread_local const cudaError_t bound = cudaFree(nullptr);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  const hopper::EncodeTiled fn = hopper::encoder();
  if (fn == nullptr) return hopper::ENCODE_MISSING;
  const cuuint64_t gd[3] = {static_cast<cuuint64_t>(D),
                            static_cast<cuuint64_t>(KH),
                            static_cast<cuuint64_t>(P) * page};
  const cuuint64_t gs[2] = {static_cast<cuuint64_t>(D),
                            static_cast<cuuint64_t>(KH) * D};
  const cuuint32_t bx[3] = {static_cast<cuuint32_t>(D), 1u,
                            static_cast<cuuint32_t>(page)};
  const cuuint32_t es[3] = {1u, 1u, 1u};
  const CUtensorMapSwizzle sw =
      D == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : D == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : D == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                        const_cast<void*>(pool), gd, gs, bx, es,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return hopper::ENCODE_FAILED + static_cast<int>(r);
  if (cache.size() >= 256) cache.erase(cache.begin());
  cache.emplace_back(PoolKey{pool, P, page, KH, D}, *m);
  return 0;
}

template <int D, int PAGE, int GB>
int launch(const CUtensorMap& km, const CUtensorMap& vm, const Args& a,
           int B, cudaStream_t stream) {
  auto kern = paged_int8_fwd<D, PAGE, GB>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Layout L = layout(GB, D, PAGE, a.max_pages, a.ring);
  if (L.bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.KH * a.groups, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = a.splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = a.splits > 1;  // S 1: the implicit cluster of one CTA
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, km, vm, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many CTAs of the instantiation an SM holds at once with the
// layout's shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or minus a CUDA error code.
template <int D, int PAGE, int GB>
int resident(int max_pages, int ring) {
  auto kern = paged_int8_fwd<D, PAGE, GB>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return -static_cast<int>(attr);
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kern, NT, layout(GB, D, PAGE, max_pages, ring).bytes);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

template <int D, int PAGE>
int resident_gb(int gb, int max_pages, int ring) {
  switch (gb) {
    case 1: return resident<D, PAGE, 1>(max_pages, ring);
    case 2: return resident<D, PAGE, 2>(max_pages, ring);
    case 4: return resident<D, PAGE, 4>(max_pages, ring);
    case 8: return resident<D, PAGE, 8>(max_pages, ring);
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int resident_page(int page, int gb, int max_pages, int ring) {
  switch (page) {
    case 8: return resident_gb<D, 8>(gb, max_pages, ring);
    case 16: return resident_gb<D, 16>(gb, max_pages, ring);
    case 32: return resident_gb<D, 32>(gb, max_pages, ring);
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

template <int D, int PAGE>
int launch_gb(int gb, const CUtensorMap& km, const CUtensorMap& vm,
              const Args& a, int B, cudaStream_t st) {
  switch (gb) {
    case 1: return launch<D, PAGE, 1>(km, vm, a, B, st);
    case 2: return launch<D, PAGE, 2>(km, vm, a, B, st);
    case 4: return launch<D, PAGE, 4>(km, vm, a, B, st);
    case 8: return launch<D, PAGE, 8>(km, vm, a, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_page(int page, int gb, const CUtensorMap& km,
                const CUtensorMap& vm, const Args& a, int B,
                cudaStream_t st) {
  switch (page) {
    case 8: return launch_gb<D, 8>(gb, km, vm, a, B, st);
    case 16: return launch_gb<D, 16>(gb, km, vm, a, B, st);
    case 32: return launch_gb<D, 32>(gb, km, vm, a, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int forward(Args a, const void* kp, const void* vp, int B, int gb, int D,
            int P, int page, void* stream) {
  const int G = a.KH > 0 ? a.H / a.KH : 0;
  if (B < 1 || P < 1 || a.KH < 1 || a.groups < 1 || a.H % a.KH ||
      G % a.groups || G / a.groups > gb || a.splits < 1 ||
      a.splits > MAX_SPLITS || a.ring < MIN_RING || a.ring > MAX_RING ||
      a.max_pages < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap km, vm;
  if (const int e = pool_map(&km, kp, P, page, a.KH, D)) return e;
  if (const int e = pool_map(&vm, vp, P, page, a.KH, D)) return e;
  a.qscale = LOG2E / sqrtf(static_cast<float>(D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_page<16>(page, gb, km, vm, a, B, st);
    case 32: return launch_page<32>(page, gb, km, vm, a, B, st);
    case 64: return launch_page<64>(page, gb, km, vm, a, B, st);
    case 128: return launch_page<128>(page, gb, km, vm, a, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

Args args(const void* q, void* o, void* ksc, void* vsc, const void* table,
          const void* lens, int H, int KH, int groups, int max_pages,
          int splits, int ring) {
  Args a;
  std::memset(&a, 0, sizeof a);
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.ksc = static_cast<__half*>(ksc);
  a.vsc = static_cast<__half*>(vsc);
  a.table = static_cast<const int*>(table);
  a.lens = static_cast<const int*>(lens);
  a.H = H;
  a.KH = KH;
  a.groups = groups;
  a.max_pages = max_pages;
  a.splits = splits;
  a.ring = ring;
  return a;
}

}  // namespace

// Bytes of dynamic shared memory the kernel takes for a heads tier `gb`
// and `ring` page slots a warp (the wrapper's check).
extern "C" int pa_int8_smem_bytes(int gb, int D, int page, int max_pages,
                                  int ring) {
  return layout(gb, D, page, max_pages, ring).bytes;
}

// CTAs of a heads tier an SM holds at once (the card tests hold
// int8_plan's wave to it), or minus a CUDA error code.
extern "C" int pa_int8_resident_ctas(int gb, int D, int page, int max_pages,
                                     int ring) {
  switch (D) {
    case 16: return resident_page<16>(page, gb, max_pages, ring);
    case 32: return resident_page<32>(page, gb, max_pages, ring);
    case 64: return resident_page<64>(page, gb, max_pages, ring);
    case 128: return resident_page<128>(page, gb, max_pages, ring);
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

// q, o: (B, H, D) bf16; kp, vp: (P, page, KH, D) int8; ksc, vsc: (P, KH,
// page) fp16 scales; table: (B, max_pages) int32; lens: (B,) int32 — all
// contiguous, on the device, the pools and the scale pools 16-byte
// aligned.  Each KV head's H / KH query heads are split into `groups`
// head groups of at most `gb` (the heads tier: 1, 2, 4 or 8) heads.
// Needs D in {16, 32, 64, 128}, page in {8, 16, 32}, 1 <= splits <= 8
// and 2 <= ring <= 4 page slots a warp.
extern "C" int pa_forward_int8(const void* q, const void* kp, const void* vp,
                               void* ksc, void* vsc, const void* table,
                               const void* lens, void* o, int B, int H,
                               int KH, int groups, int gb, int D, int P,
                               int page, int max_pages, int splits,
                               int ring, void* stream) {
  return forward(args(q, o, ksc, vsc, table, lens, H, KH, groups, max_pages,
                      splits, ring),
                 kp, vp, B, gb, D, P, page, stream);
}

// The same with the decode step's append: k, v: (B, KH, D) bf16 rows
// (16-byte aligned) of the token at position lens[b] - 1 of each
// sequence, which lands at flat pool row rows[b] (int64, page id · page +
// token: the row position lens[b] - 1 of sequence b's table names).
// The row is quantized as kv_quant.cu quantizes, attended over, and its
// codes and scales are stored into kp / vp and ksc / vsc.
extern "C" int pa_append_forward_int8(
    const void* q, const void* k, const void* v, const void* rows, void* kp,
    void* vp, void* ksc, void* vsc, const void* table, const void* lens,
    void* o, int B, int H, int KH, int groups, int gb, int D, int P,
    int page, int max_pages, int splits, int ring, void* stream) {
  Args a = args(q, o, ksc, vsc, table, lens, H, KH, groups, max_pages,
                splits, ring);
  a.knew = static_cast<const __nv_bfloat16*>(k);
  a.vnew = static_cast<const __nv_bfloat16*>(v);
  a.rows = static_cast<const int64_t*>(rows);
  a.kp = static_cast<int8_t*>(kp);
  a.vp = static_cast<int8_t*>(vp);
  return forward(a, kp, vp, B, gb, D, P, page, stream);
}
