// Expert-grouped GEMM for Hopper (sm_90a): C[e] = A[e] * B[e] for every
// expert e of an MoE layer in one launch, only the rows below each
// expert's count, and the two backward products of training.  No Pallas
// original: the reference computes these products as an XLA einsum
// (src/repro/models/moe.py:115-118) and differentiates it with jax.grad;
// this is the streaming GEMM (_gemm_kernel of
// src/repro/kernels/streaming_gemm.py) applied per expert, and the
// forward also runs multi-head latent attention's absorbed per-head
// products (the heads as groups).
//
// What bounds it on the H100: bytes.  Each touched expert's weight (K x N
// bf16) is read once; its kept rows are few (8 tokens at decode; about 8
// of deepseek-v3's 256-token prefill and 34 of qwen2-moe's 512-token one),
// so the tensor work, 2 * rows * K * N, stays far under the weight bytes'
// time.  What held the first kernel back (an m-tile x expert grid, 128
// token rows a tile at prefill, mma.sync) was CTAs scheduled for experts
// no token chose and tensor work on padding rows.
//
// The forward (grouped_wgmma):
//  * Persistent: a grid of one CTA per SM (the caller's `grid`).  Each
//    CTA reads counts (E ints) into shared memory and builds the work
//    list itself, nothing synced to the host: work item = (touched
//    expert, chunk of up to 64 of its kept rows, 128 columns of N),
//    expert-major, so the CTAs working on one expert at a time share its
//    token rows in L2.  CTA i takes items i, i + grid, ...; an expert with
//    no row has no item.
//  * The product runs transposed, C^T = B^T A^T: 64 weight columns fill
//    the M side of wgmma.m64nNk16 (the weight, N-contiguous, is an
//    MN-major operand) and the chunk's rows its N side, rounded up to 8:
//    N in {8, 16, ..., 64} is instantiated, so at most 7 padding rows of
//    tensor work an item.  Rows beyond 64 take further chunks, each
//    streaming the weight tile again (from L2: the chunks of one expert
//    are neighbouring items).  The main path's counts average 8
//    (deepseek-v3) and 34 (qwen2-moe's 512-token prefill).
//  * One producer warp issues TMA loads (cp.async.bulk.tensor) into a ring
//    of 3-6 stages on mbarriers: per stage the two 64 x 64 weight boxes
//    of the item's 128 columns (16 KB) and the chunk's token rows in
//    boxes of 8 rows x 64 (1 KB each), all 128-byte swizzled.  The
//    weight's (E, K, N) map is encoded once per tensor and cached; the
//    activations' map is encoded per call.  Ragged N and K edges are
//    zero-filled by TMA; nothing is padded on the host.
//  * Two consumer warpgroups, one per 64 weight columns, run the wgmmas of
//    a stage (four k16 steps, fp32 accumulators in registers), release the
//    stage to the producer one stage behind, and store bf16 rows below the
//    count; rows at or beyond it are never written.
//  * Deterministic: no atomics and no split of K; each output element is
//    summed in one fixed order by one thread.
//
// The backward products, one launch for all experts each, persistent walks
// of the same shape (every count read on the card, work items built
// there, no sync to the host, no atomics and no split of a reduction: the
// same bits every run).  A producer warpgroup (one thread issues TMA
// loads; the warpgroup hands its registers over by setmaxnreg) feeds a
// ring of stages on mbarriers; two consumer warpgroups of 232 registers
// each hold an fp32 tile of 128 rows, two wgmma.m64 a k16 step.  Every
// such walk is fed at about the same bytes a cycle an SM (17-20 B on the
// H100, the forward and 128-row backward tiles alike; sharing a tile
// across a cluster of 2 by TMA multicast did not raise it), so what
// decides the time at training's counts is the bytes a multiply-add:
// 256-row output tiles take a third fewer than 128-row ones.
//  * grouped_bwd_da: dA[e] = dC[e] * B[e]^T over rows [0, counts[e]),
//    the forward's walk with the weight K-major.  It runs transposed,
//    dA^T = B[e] * dC[e]^T: B's K rows fill wgmma's M side and the
//    reduction runs over N, contiguous in both B (E, K, N) and dC, so both
//    operands are K-major (the forward's weight map, read at swapped
//    coordinates).  Work item = (touched expert, chunk of kept rows, 256
//    output columns of K; 128 where no chunk passes 64 rows), expert-
//    major.  An expert's count is split evenly into ceil(count / 160)
//    chunks (160 token columns of fp32 for each of two 64-row blocks is
//    what 232 registers hold), so qwen2-moe's ~273 rows an expert pass
//    over its weight twice, not five times.  A chunk's rows round up to 8
//    up to 64 and to 32 beyond (wgmma N in {8, ..., 64, 96, 128, 160}: at
//    most 31 padding rows an item), loaded in boxes of 8 or 32 rows.  A
//    row past the count that TMA brings in (NaN included) only feeds an
//    output column the epilogue never writes: rows at or beyond the count
//    are never written.  The epilogue turns the tile token-major through
//    a 4 KB slab a warpgroup (32 tokens x 64 columns), and the warpgroup
//    writes each kept row in 16-byte pieces (value by value at a K that
//    is no multiple of 8).
//  * grouped_bwd_db: dB[e] = A[e]^T * dC[e] summed over rows [0,
//    counts[e]).  Work item = (expert, 256 rows of K, 128 columns of N),
//    expert-major so that one expert's A and dC stay in L2 while its
//    tiles are walked; every expert has items (an expert at count 0 loads
//    nothing and stores a zero tile).  A[e] (K contiguous) is the M side
//    and dC[e] (N contiguous) the N side, both MN-major, the reduction in
//    stages of 64 rows.  TMA cannot mask at a count held on the card: in
//    the one stage that holds the count, the consumers zero the rows at
//    or beyond it in both operands' tiles (0 * NaN is NaN) before the
//    wgmma.  The epilogue writes bf16 into a swizzled staging tile and
//    stores it by TMA, which overlaps the next item's loads and wgmmas:
//    deepseek-v3's dB writes 7.5 GB and is bound by that store.
//
// The launchers return cudaGetLastError() of their launch, or an encoding
// error of hopper.cuh.
#include "hopper.cuh"

namespace {

using hopper::desc_sw128;

constexpr int BK = 64;             // k a stage: one 128-byte swizzled row
constexpr int WN = 64;             // weight columns of a consumer warpgroup
constexpr int TILE_N = 2 * WN;     // weight columns of a work item
constexpr int CHUNK = 64;          // token rows of a work item, at most
constexpr int W_BOX = WN * BK * 2;  // bytes of one weight box (8 KB)
constexpr int THREADS = 288;       // two consumer warpgroups + producer warp
constexpr int CONSUMER_WARPS = 8;
constexpr int MIN_STAGES = 3, MAX_STAGES = 6, MAX_E = 1024;
constexpr int SMEM_LIMIT = 227 * 1024;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Shared memory, in bytes from a 1,024-byte aligned base: the weight ring
// (stages x 16 KB), the token ring (stages x nt_max rows of 128 B), the
// full and empty barriers, the clamped counts and each expert's first
// item.  `bytes` adds the alignment slack.
struct Layout {
  int w, t, full, empty, cnt, start, bytes;
};

__host__ __device__ inline Layout layout(int E, int stages, int nt_max) {
  Layout L;
  L.w = 0;
  L.t = L.w + stages * 2 * W_BOX;
  L.full = L.t + stages * nt_max * 128;
  L.empty = L.full + 8 * stages;
  L.cnt = L.empty + 8 * stages;
  L.start = L.cnt + 4 * E;
  L.bytes = 1024 + L.start + 4 * (E + 1);
  return L;
}

struct Problem {
  __nv_bfloat16* c;
  const int* counts;
  int E, rows, N, K;   // rows: the buffer's C
  int64_t ldc, sc;
  int stages, nt_max;
  int a_e_inner;       // the token map's dims are (K, E, C), not (K, C, E)
};

struct Item {
  int e, row0, rows, nt, n0;  // rows: kept rows of the chunk; nt: rounded
};

// start[e] = the first work item of expert e, start[E] = all items, for
// ceil(cnt[e] / CH) row chunks of `tiles` tiles an expert: an exclusive
// scan by one warp, each lane over a range of experts.
template <int CH>
__device__ __forceinline__ void scan_items(const int* cnt, int* start, int E,
                                           int tiles) {
  const int lane = threadIdx.x % 32;
  const int per = cdiv(E, 32), e0 = min(E, lane * per), e1 = min(E, e0 + per);
  int sum = 0;
  for (int e = e0; e < e1; ++e) sum += cdiv(cnt[e], CH) * tiles;
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  int run = incl - sum;
  for (int e = e0; e < e1; ++e) {
    start[e] = run;
    run += cdiv(cnt[e], CH) * tiles;
  }
  if (lane == 31) start[E] = incl;
}

// The expert whose items hold item i: the last e with start[e] <= i.
__device__ __forceinline__ int expert_of(int i, const int* start, int E) {
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (start[mid] <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Item i of the list: its expert, then its chunk and 128-column tile.
__device__ __forceinline__ Item item(int i, const int* start, const int* cnt,
                                     int E, int n_tiles) {
  const int lo = expert_of(i, start, E);
  Item t;
  t.e = lo;
  const int local = i - start[lo];
  t.row0 = (local / n_tiles) * CHUNK;
  t.rows = min(CHUNK, cnt[lo] - t.row0);
  t.nt = (t.rows + 7) & ~7;
  t.n0 = (local % n_tiles) * TILE_N;
  return t;
}

// One item's k walk and epilogue for a consumer warpgroup (weight columns
// [n0 + 64 wg, n0 + 64 wg + 64)) at NT token columns.  `it` counts the
// CTA's stages across items, as the producer does.
template <int NT>
__device__ __forceinline__ void consume(const Item& t, const Problem& p,
                                        unsigned char* w_ring,
                                        unsigned char* t_ring,
                                        uint64_t* full, uint64_t* empty,
                                        int nk, int& it) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  int prev = -1;
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int s = it % p.stages;
    hopper::mbar_wait(&full[s], (it / p.stages) & 1);
    const unsigned char* w = w_ring + s * 2 * W_BOX + wg * W_BOX;
    const unsigned char* x = t_ring + s * p.nt_max * 128;
    hopper::fence_regs<NT / 2>(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)  // 16 k-rows of 128 B; 32 B of k
      hopper::wgmma_ss<NT, 1, 0>(acc, desc_sw128(w + ks * 2048, W_BOX, 1024),
                                 desc_sw128(x + ks * 32, 16, 1024), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the previous stage's wgmmas are done
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[prev]);
    }
    prev = s;
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs<NT / 2>(acc);
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(&empty[prev]);

  // acc[4j + {0, 1}]: weight column r, tokens 8j + 2q + {0, 1};
  // acc[4j + {2, 3}]: column r + 8, the same tokens
  const int r = t.n0 + wg * WN + 16 * (warp % 4) + lane / 4, q = lane % 4;
  __nv_bfloat16* c = p.c + t.e * p.sc + static_cast<int64_t>(t.row0) * p.ldc;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j)
#pragma unroll
    for (int dt = 0; dt < 2; ++dt) {
      const int tok = 8 * j + 2 * q + dt;
      if (tok >= t.rows) continue;
      __nv_bfloat16* row = c + tok * p.ldc;
      if (r < p.N) row[r] = __float2bfloat16(acc[4 * j + dt]);
      if (r + 8 < p.N) row[r + 8] = __float2bfloat16(acc[4 * j + 2 + dt]);
    }
}

__global__ void __launch_bounds__(THREADS, 1)
    grouped_wgmma(const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap amap, Problem p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L = layout(p.E, p.stages, p.nt_max);
  unsigned char* w_ring = base + L.w;
  unsigned char* t_ring = base + L.t;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(base + L.empty);
  int* cnt = reinterpret_cast<int*>(base + L.cnt);
  int* start = reinterpret_cast<int*>(base + L.start);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = cdiv(p.N, TILE_N), nk = cdiv(p.K, BK);

  for (int e = tid; e < p.E; e += THREADS)
    cnt[e] = min(max(p.counts[e], 0), p.rows);
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (warp == 0) scan_items<CHUNK>(cnt, start, p.E, n_tiles);
  __syncthreads();
  const int total = start[p.E];

  if (warp == CONSUMER_WARPS) {  // the producer warp: one lane issues
    if (lane != 0) return;
    hopper::prefetch_tmap(&wmap);
    hopper::prefetch_tmap(&amap);
    int it = 0;
    for (int i = blockIdx.x; i < total; i += gridDim.x) {
      const Item t = item(i, start, cnt, p.E, n_tiles);
      const int bytes = 2 * W_BOX + t.nt * 128;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % p.stages;
        hopper::mbar_wait(&empty[s], ((it / p.stages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], bytes);
        unsigned char* w = w_ring + s * 2 * W_BOX;
        unsigned char* x = t_ring + s * p.nt_max * 128;
        const int k0 = kt * BK;
        hopper::tma_load_3d(w, &wmap, t.n0, k0, t.e, &full[s]);
        hopper::tma_load_3d(w + W_BOX, &wmap, t.n0 + WN, k0, t.e, &full[s]);
        for (int b = 0; b < t.nt / 8; ++b) {
          const int row = t.row0 + 8 * b;
          if (p.a_e_inner)
            hopper::tma_load_3d(x + b * 1024, &amap, k0, t.e, row, &full[s]);
          else
            hopper::tma_load_3d(x + b * 1024, &amap, k0, row, t.e, &full[s]);
        }
      }
    }
    return;
  }

  int it = 0;
  for (int i = blockIdx.x; i < total; i += gridDim.x) {
    const Item t = item(i, start, cnt, p.E, n_tiles);
    switch (t.nt) {
      case 8: consume<8>(t, p, w_ring, t_ring, full, empty, nk, it); break;
      case 16: consume<16>(t, p, w_ring, t_ring, full, empty, nk, it); break;
      case 24: consume<24>(t, p, w_ring, t_ring, full, empty, nk, it); break;
      case 32: consume<32>(t, p, w_ring, t_ring, full, empty, nk, it); break;
      case 40: consume<40>(t, p, w_ring, t_ring, full, empty, nk, it); break;
      case 48: consume<48>(t, p, w_ring, t_ring, full, empty, nk, it); break;
      case 56: consume<56>(t, p, w_ring, t_ring, full, empty, nk, it); break;
      default: consume<64>(t, p, w_ring, t_ring, full, empty, nk, it); break;
    }
  }
}

// ------------------------------------------------- backward products
// Both backward kernels run a producer warpgroup (one thread issues the
// TMA loads; the warpgroup gives its registers up, setmaxnreg) beside two
// consumer warpgroups of 232 registers each, which hold fp32 tiles of MW
// x 64 rows by NT (dA) or 128 (dB) columns.  The bigger tile is what
// moves the kernels: every one of these walks is fed from L2 at about the
// same bytes a cycle an SM, so the bytes a multiply-add decide the time.
constexpr int BWD_THREADS = 384;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int DA_CHUNK = 160;      // token rows of a dA item, at most

// A consumer warp's release of a ring stage, one stage behind its wgmmas.
__device__ __forceinline__ void release(uint64_t* empty, int prev) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&empty[prev]);
}

// A TMA load of an (E, R, X) operand's box at (x, row r, expert e): the
// map's outer dims are (R, E), or (E, R) where the expert stride is the
// smaller one (`e_inner`).
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* m,
                                          int e_inner, int x, int r, int e,
                                          uint64_t* bar) {
  if (e_inner)
    hopper::tma_load_3d(dst, m, x, e, r, bar);
  else
    hopper::tma_load_3d(dst, m, x, r, e, bar);
}

// ------------------------------------------------------------------ dA
// dA's tile: MW x 128 rows of the output's K (MW 64-row weight boxes a
// consumer warpgroup), two where a chunk can pass 64 rows.
__host__ __device__ inline int da_mw(int nt_max) { return nt_max > 64 ? 2 : 1; }

// dA's shared memory: the weight ring (stages x MW x 16 KB), the token
// ring (stages x nt_max rows of 128 B), a 4 KB staging slab for each
// consumer warpgroup's epilogue, the barriers, the clamped counts and
// each expert's first item, plus the alignment slack.
constexpr int DA_SLAB = 32;        // token rows of an epilogue slab
__host__ __device__ inline Layout da_layout(int E, int stages, int nt_max) {
  Layout L;
  L.w = 0;
  L.t = L.w + stages * da_mw(nt_max) * 2 * W_BOX;
  L.full = L.t + stages * nt_max * 128 + 2 * DA_SLAB * 128;
  L.empty = L.full + 8 * stages;
  L.cnt = L.empty + 8 * stages;
  L.start = L.cnt + 4 * E;
  L.bytes = 1024 + L.start + 4 * (E + 1);
  return L;
}

struct DaProblem {
  __nv_bfloat16* c;    // dA (E, C, K)
  const int* counts;
  int E, rows, K, N;   // rows: the buffer's C; K: dA's width; N: the depth
  int64_t ldc, sc;
  int stages, nt_max;
  int x_e_inner, w_e_inner;  // dC's, B's map has the outer dims (E, rows)
  int vec;             // dA's rows are 16-byte aligned: K % 8 == 0
};

// Item i of dA's list: its expert, its chunk (the count split into
// ceil(count / 160) chunks, the first count mod chunks one row longer)
// and its tile of MW x 128 output columns (`n0` here: rows of B).
template <int MW>
__device__ __forceinline__ Item da_item(int i, const int* start,
                                        const int* cnt, int E, int tiles) {
  const int lo = expert_of(i, start, E);
  Item t;
  t.e = lo;
  const int local = i - start[lo], j = local / tiles;
  const int c = cnt[lo], n = cdiv(c, DA_CHUNK), base = c / n, rem = c % n;
  t.row0 = j * base + min(j, rem);
  t.rows = base + (j < rem ? 1 : 0);
  t.nt = t.rows <= 64 ? (t.rows + 7) & ~7 : (t.rows + 31) & ~31;
  t.n0 = (local % tiles) * MW * 2 * WN;
  return t;
}

// One dA item for a consumer warpgroup: dA^T rows [n0 + 64 (MW wg + h),
// + 64) for h < MW, by NT token columns, the reduction over N in stages
// of 64.  Both operands K-major: a k16 step is 32 B into each 128-byte
// row of the weight box and of the token rows.
template <int NT, int MW>
__device__ __forceinline__ void da_consume(const Item& t, const DaProblem& p,
                                           unsigned char* w_ring,
                                           unsigned char* t_ring,
                                           unsigned char* slab,
                                           uint64_t* full, uint64_t* empty,
                                           int nk, int& it) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4;
  float acc[MW][NT / 2];
#pragma unroll
  for (int h = 0; h < MW; ++h)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[h][i] = 0.f;
  int prev = -1;
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int s = it % p.stages;
    hopper::mbar_wait(&full[s], (it / p.stages) & 1);
    const unsigned char* w = w_ring + (s * 2 + wg) * MW * W_BOX;
    const unsigned char* x = t_ring + s * p.nt_max * 128;
#pragma unroll
    for (int h = 0; h < MW; ++h) hopper::fence_regs<NT / 2>(acc[h]);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint64_t dx = desc_sw128(x + ks * 32, 16, 1024);
#pragma unroll
      for (int h = 0; h < MW; ++h)
        hopper::wgmma_ss<NT, 0, 0>(
            acc[h], desc_sw128(w + h * W_BOX + ks * 32, 16, 1024), dx, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the previous stage's wgmmas are done
    if (prev >= 0) release(empty, prev);
    prev = s;
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < MW; ++h) hopper::fence_regs<NT / 2>(acc[h]);
  release(empty, prev);

  // epilogue, a 64-column block h and 32 tokens at a time: acc[h][4j +
  // {0, 1}] is output column c = 16 (warp % 4) + lane / 4 of the block
  // and tokens 8j + 2q + {0, 1}, acc[h][4j + {2, 3}] column c + 8.  Lanes
  // lane and lane ^ 4 (columns c, c + 1) swap halves, so each holds two
  // column pairs of one token; the slab takes them token-major (128 B a
  // token, 16-byte piece u at u ^ (token % 8)), and the warpgroup writes
  // its rows below the count in 16-byte pieces.  Rows at or beyond the
  // count are never written.
  const int q = lane % 4, odd = (lane >> 2) & 1;
  const int pc = 16 * (warp % 4) + (lane / 4 & ~1);  // the pair's column
  __nv_bfloat16* c = p.c + t.e * p.sc + static_cast<int64_t>(t.row0) * p.ldc;
#pragma unroll
  for (int h = 0; h < MW; ++h) {
    const int col0 = t.n0 + (wg * MW + h) * 64;
#pragma unroll
    for (int j0 = 0; j0 < NT / 8; j0 += DA_SLAB / 8) {
      hopper::bar_sync(2 + wg, 128);  // the slab's last readers are done
#pragma unroll
      for (int jj = 0; jj < DA_SLAB / 8; ++jj) {
        const int j = j0 + jj;
        if (j < NT / 8) {
          const float a0 = acc[h][4 * j], a1 = acc[h][4 * j + 1];
          const float a2 = acc[h][4 * j + 2], a3 = acc[h][4 * j + 3];
          const float y0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : a1, 4);
          const float y1 = __shfl_xor_sync(0xffffffffu, odd ? a2 : a3, 4);
          const int ts = 8 * jj + 2 * q + odd;
          unsigned char* row = slab + ts * 128 + (pc % 8) * 2;
          *reinterpret_cast<__nv_bfloat162*>(
              row + (((pc / 8) ^ (ts % 8)) << 4)) =
              odd ? __floats2bfloat162_rn(y0, a1)
                  : __floats2bfloat162_rn(a0, y0);
          *reinterpret_cast<__nv_bfloat162*>(
              row + (((pc / 8 + 1) ^ (ts % 8)) << 4)) =
              odd ? __floats2bfloat162_rn(y1, a3)
                  : __floats2bfloat162_rn(a2, y1);
        }
      }
      hopper::bar_sync(2 + wg, 128);
      const int tokens = min(DA_SLAB, t.rows - 8 * j0);
      for (int u = threadIdx.x % 128; u < tokens * 8; u += 128) {
        const int ts = u / 8, col = col0 + 8 * (u % 8);
        const uint4 v = *reinterpret_cast<const uint4*>(
            slab + ts * 128 + (((u % 8) ^ (ts % 8)) << 4));
        __nv_bfloat16* out = c + static_cast<int64_t>(8 * j0 + ts) * p.ldc;
        if (p.vec && col + 8 <= p.K) {
          *reinterpret_cast<uint4*>(out + col) = v;
        } else {  // the ragged edge of K
          const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&v);
          for (int k = 0; k < 8 && col + k < p.K; ++k) out[col + k] = x[k];
        }
      }
    }
  }
}

// dA[e] = dC[e] * B[e]^T, run as dA^T = B[e] * dC[e]^T: a persistent walk
// over (touched expert, chunk of kept rows, MW x 128 columns of K).
// wmap: B (E, K, N) in 64 (N) x 64 (K rows) boxes, the forward's map;
// xmap / xmap32: dC's rows in boxes of 8 and of 32.
template <int MW>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    grouped_bwd_da(const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap xmap32, DaProblem p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L = da_layout(p.E, p.stages, p.nt_max);
  unsigned char* w_ring = base + L.w;
  unsigned char* t_ring = base + L.t;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(base + L.empty);
  int* cnt = reinterpret_cast<int*>(base + L.cnt);
  int* start = reinterpret_cast<int*>(base + L.start);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles = cdiv(p.K, MW * 2 * WN), nk = cdiv(p.N, BK);

  for (int e = tid; e < p.E; e += BWD_THREADS)
    cnt[e] = min(max(p.counts[e], 0), p.rows);
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (warp == 0) scan_items<DA_CHUNK>(cnt, start, p.E, tiles);
  __syncthreads();
  const int total = start[p.E];

  if (warp >= CONSUMER_WARPS) {  // the producer warpgroup: one thread
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      hopper::prefetch_tmap(&wmap);
      hopper::prefetch_tmap(&xmap);
      hopper::prefetch_tmap(&xmap32);
      int it = 0;
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        const Item t = da_item<MW>(i, start, cnt, p.E, tiles);
        const int bytes = MW * 2 * W_BOX + t.nt * 128;
        // token boxes of 8 rows (1 KB), or of 32 (4 KB) past 64 rows
        const int box = t.nt > 64 ? 32 : 8;
        const CUtensorMap* tmap = t.nt > 64 ? &xmap32 : &xmap;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % p.stages;
          hopper::mbar_wait(&empty[s], ((it / p.stages) & 1) ^ 1);
          hopper::mbar_expect_tx(&full[s], bytes);
          unsigned char* w = w_ring + s * MW * 2 * W_BOX;
          unsigned char* x = t_ring + s * p.nt_max * 128;
          const int k0 = kt * BK;
          for (int b = 0; b < MW * 2; ++b)  // 64 N (the depth) x 64 K rows
            load_rows(w + b * W_BOX, &wmap, p.w_e_inner, k0, t.n0 + WN * b,
                      t.e, &full[s]);
          for (int b = 0; b < t.nt / box; ++b)
            load_rows(x + b * box * 128, tmap, p.x_e_inner, k0,
                          t.row0 + box * b, t.e, &full[s]);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    unsigned char* slab = t_ring + p.stages * p.nt_max * 128 +
                          (warp / 4) * DA_SLAB * 128;
    int it = 0;
    for (int i = blockIdx.x; i < total; i += gridDim.x) {
      const Item t = da_item<MW>(i, start, cnt, p.E, tiles);
#define GG_DA(n)                                                        \
  case n:                                                               \
    da_consume<n, MW>(t, p, w_ring, t_ring, slab, full, empty, nk, it);     \
    break;
      if constexpr (MW == 2) {
        switch (t.nt) {
          GG_DA(8) GG_DA(16) GG_DA(24) GG_DA(32) GG_DA(40) GG_DA(48)
          GG_DA(56) GG_DA(64) GG_DA(96) GG_DA(128)
          default: da_consume<160, MW>(t, p, w_ring, t_ring, slab, full,
                                       empty, nk, it);
        }
      } else {
        switch (t.nt) {
          GG_DA(8) GG_DA(16) GG_DA(24) GG_DA(32) GG_DA(40) GG_DA(48)
          GG_DA(56)
          default: da_consume<64, MW>(t, p, w_ring, t_ring, slab, full,
                                      empty, nk, it);
        }
      }
#undef GG_DA
    }
  }
}

// ------------------------------------------------------------------ dB
constexpr int DB_BM = 4 * 64;      // K rows of an item: 128 a warpgroup
constexpr int DB_BN = 128;         // N columns of an item
constexpr int DB_ROWS = 64;        // reduction rows a stage
constexpr int DB_BOX = 64 * DB_ROWS * 2;  // 64 columns x 64 rows (8 KB)
constexpr int DB_STAGE = 6 * DB_BOX;  // A's four boxes, then dC's two
constexpr int DB_OUT = 4 * DB_BOX;  // a warpgroup's 128 x 128 bf16 tile
constexpr int DB_MIN_STAGES = 2, DB_MAX_STAGES = 3;

// dB's shared memory: the ring (stages x 48 KB), a staging tile for each
// warpgroup, the barriers and the clamped counts, plus the slack.
struct DbLayout {
  int ring, out, full, empty, cnt, bytes;
};

__host__ __device__ inline DbLayout db_layout(int E, int stages) {
  DbLayout L;
  L.ring = 0;
  L.out = stages * DB_STAGE;
  L.full = L.out + 2 * DB_OUT;
  L.empty = L.full + 8 * stages;
  L.cnt = L.empty + 8 * stages;
  L.bytes = 1024 + L.cnt + 4 * E;
  return L;
}

struct DbProblem {
  const int* counts;
  int E, rows, K, N, stages;  // rows: the buffer's C
  int a_e_inner, x_e_inner;   // A's, dC's map has the outer dims (E, rows)
};

// dB[e] = A[e]^T * dC[e] over the kept rows: a persistent walk over
// (expert, 256 rows of K, 128 columns of N).  amap: A (E, C, K), xmap:
// dC (E, C, N), both in 64 x 64-row boxes; omap: dB (E, K, N) in 64 x
// 64 boxes, written by TMA.
__global__ void __launch_bounds__(BWD_THREADS, 1)
    grouped_bwd_db(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap omap, DbProblem p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const DbLayout L = db_layout(p.E, p.stages);
  unsigned char* ring = base + L.ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(base + L.empty);
  int* cnt = reinterpret_cast<int*>(base + L.cnt);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = cdiv(p.N, DB_BN);
  const int per_e = cdiv(p.K, DB_BM) * n_tiles, total = p.E * per_e;

  for (int e = tid; e < p.E; e += BWD_THREADS)
    cnt[e] = min(max(p.counts[e], 0), p.rows);
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {  // the producer warpgroup: one thread
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      hopper::prefetch_tmap(&amap);
      hopper::prefetch_tmap(&xmap);
      int it = 0;
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        const int e = i / per_e, local = i % per_e;
        const int k0 = (local / n_tiles) * DB_BM;
        const int n0 = (local % n_tiles) * DB_BN;
        const int ns = cdiv(cnt[e], DB_ROWS);  // 0: nothing to load
        for (int s = 0; s < ns; ++s, ++it) {
          const int slot = it % p.stages;
          hopper::mbar_wait(&empty[slot], ((it / p.stages) & 1) ^ 1);
          hopper::mbar_expect_tx(&full[slot], DB_STAGE);
          unsigned char* st = ring + slot * DB_STAGE;
          const int r0 = s * DB_ROWS;
          for (int b = 0; b < 4; ++b)
            load_rows(st + b * DB_BOX, &amap, p.a_e_inner, k0 + 64 * b, r0,
                      e, &full[slot]);
          for (int b = 0; b < 2; ++b)
            load_rows(st + (4 + b) * DB_BOX, &xmap, p.x_e_inner,
                          n0 + 64 * b, r0, e, &full[slot]);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp / 4, wtid = tid % 128;
    unsigned char* o = base + L.out + wg * DB_OUT;
    int it = 0;
    for (int i = blockIdx.x; i < total; i += gridDim.x) {
      const int e = i / per_e, local = i % per_e;
      const int k0 = (local / n_tiles) * DB_BM;
      const int n0 = (local % n_tiles) * DB_BN;
      const int count = cnt[e], ns = cdiv(count, DB_ROWS);
      float acc[2][DB_BN / 2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < DB_BN / 2; ++j) acc[h][j] = 0.f;
      int prev = -1;
      for (int s = 0; s < ns; ++s, ++it) {
        const int slot = it % p.stages;
        hopper::mbar_wait(&full[slot], (it / p.stages) & 1);
        unsigned char* st = ring + slot * DB_STAGE;
        // the stage that holds the count: rows [keep, stop) of the six
        // boxes are zeroed (row r of a box is bytes [128 r, 128 r + 128),
        // whatever the swizzle); rows at or beyond C are TMA's zeros
        const int keep = count - s * DB_ROWS;
        if (keep < DB_ROWS) {
          const int stop = min(DB_ROWS, p.rows - s * DB_ROWS);
          const int n16 = (stop - keep) * 8;  // 16-byte pieces a box
          for (int j = tid; j < 6 * n16; j += CONSUMER_WARPS * 32)
            *reinterpret_cast<uint4*>(st + (j / n16) * DB_BOX + keep * 128 +
                                      (j % n16) * 16) = make_uint4(0, 0, 0, 0);
          hopper::fence_proxy_async();
          hopper::bar_sync(1, CONSUMER_WARPS * 32);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) hopper::fence_regs<DB_BN / 2>(acc[h]);
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < DB_ROWS / 16; ++ks) {  // 16 rows of 128 B
          const uint64_t dx =
              desc_sw128(st + 4 * DB_BOX + ks * 2048, DB_BOX, 1024);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            hopper::wgmma_ss<DB_BN, 1, 1>(
                acc[h],
                desc_sw128(st + (2 * wg + h) * DB_BOX + ks * 2048, DB_BOX,
                           1024),
                dx, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous stage's wgmmas are done
        if (prev >= 0) release(empty, prev);
        prev = slot;
      }
      // waited for on every path (an expert at count 0 issued none), so
      // the compiler need not serialise the wgmmas
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < 2; ++h) hopper::fence_regs<DB_BN / 2>(acc[h]);
      if (prev >= 0) release(empty, prev);

      // epilogue: acc[h][4j + {0, 1}] is K row 64 h + r, N columns 8j + 2q
      // + {0, 1}; acc[h][4j + {2, 3}] row 64 h + r + 8.  The staging tile is
      // four 64 x 64 boxes (K rows 64 h.., N columns 64 b..: box 2h + b) in
      // the 128-byte swizzle (16-byte piece c of row r at c ^ (r % 8)),
      // the previous item's store done reading it first.
      if (wtid == 0) hopper::bulk_wait_read<0>();
      hopper::bar_sync(2 + wg, 128);
      const int r = 16 * (warp % 4) + lane / 4, q = lane % 4;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < DB_BN / 8; ++j)
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            const int row = r + 8 * d;
            *reinterpret_cast<__nv_bfloat162*>(
                o + (2 * h + j / 8) * DB_BOX + row * 128 +
                (((j % 8) ^ (row % 8)) << 4) + 4 * q) =
                __floats2bfloat162_rn(acc[h][4 * j + 2 * d],
                                      acc[h][4 * j + 2 * d + 1]);
          }
      hopper::fence_proxy_async();
      hopper::bar_sync(2 + wg, 128);
      if (wtid == 0) {  // a box past the output's edge is clipped
#pragma unroll
        for (int b = 0; b < 4; ++b)
          hopper::tma_store_3d(&omap, o + b * DB_BOX, n0 + 64 * (b % 2),
                               k0 + 128 * wg + 64 * (b / 2), e);
        hopper::bulk_commit();
      }
    }
    if (wtid == 0) hopper::bulk_wait<0>();
  }
}

// Allow a backward kernel the shared memory the card has.
template <typename Kern>
cudaError_t allow_smem(Kern kern) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
}

// The map of an (E, R, X) bf16 operand, X contiguous, with row stride ld
// and expert stride se (values), a box of 64 X x `box_rows` R: its outer
// dims in increasing stride, (R, E) or (E, R) (`*e_inner` 1).
int rows_map(CUtensorMap* m, const void* ptr, int E, int R, int X, int64_t ld,
             int64_t se, uint32_t box_rows, bool cached, int* e_inner) {
  *e_inner = se < ld;
  const uint64_t d[3] = {static_cast<uint64_t>(X),
                         static_cast<uint64_t>(*e_inner ? E : R),
                         static_cast<uint64_t>(*e_inner ? R : E)};
  const uint64_t s[2] = {static_cast<uint64_t>(*e_inner ? se : ld) * 2,
                         static_cast<uint64_t>(*e_inner ? ld : se) * 2};
  const uint32_t box[3] = {64, *e_inner ? 1u : box_rows,
                           *e_inner ? box_rows : 1u};
  const hopper::MapShape shape = hopper::map_shape(ptr, 3, d, s, box);
  return cached ? hopper::encode_cached(m, shape) : hopper::encode(m, shape);
}

}  // namespace

// Bytes of dynamic shared memory the kernel takes (the wrapper's check).
extern "C" int gg_smem_bytes(int E, int stages, int nt_max) {
  return layout(E, stages, nt_max).bytes;
}

// C[e] = A[e] * B[e] for e < E: A (E, C, K) with row stride lda and
// expert stride sa; B[e] row-major (K x N) with ldb and sb; C (E, C, N)
// with ldc and sc; counts (E,) int32 on the device, the rows of each
// expert (clamped to [0, C]).  All bf16, 16-byte aligned, K and N
// multiples of 8.  grid CTAs (persistent), a ring of `stages` (3-6), a
// token ring of nt_max rows (a multiple of 8, at most 64, at least the
// largest chunk: min(64, C) rounded up to 8).  E <= 1,024.
extern "C" int gg_grouped_gemm(const void* A, const void* B, void* C,
                               const void* counts, int E, int rows, int N,
                               int K, int64_t lda, int64_t sa, int64_t ldb,
                               int64_t sb, int64_t ldc, int64_t sc, int grid,
                               int stages, int nt_max, void* stream) {
  if (E < 1 || E > MAX_E || rows < 1 || N < 8 || K < 8 || N % 8 ||
      K % 8 || grid < 1 || stages < MIN_STAGES || stages > MAX_STAGES ||
      nt_max < 8 || nt_max > CHUNK || nt_max % 8 ||
      nt_max < (((rows < CHUNK ? rows : CHUNK) + 7) & ~7) ||
      counts == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(E, stages, nt_max);
  if (L.bytes > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      grouped_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_LIMIT);
  if (attr != cudaSuccess) return static_cast<int>(attr);

  CUtensorMap wmap, amap;
  const uint64_t wd[3] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K),
                          static_cast<uint64_t>(E)};
  const uint64_t ws[2] = {static_cast<uint64_t>(ldb) * 2,
                          static_cast<uint64_t>(sb) * 2};
  const uint32_t wbox[3] = {WN, BK, 1};
  int err = hopper::encode_cached(&wmap, hopper::map_shape(B, 3, wd, ws, wbox));
  if (err) return err;
  // the token map's outer dims in increasing stride: (K, C, E) for a
  // buffer of experts, (K, E, C) for the heads of a token-major tensor
  const int e_inner = sa < lda;
  const uint64_t ad[3] = {static_cast<uint64_t>(K),
                          static_cast<uint64_t>(e_inner ? E : rows),
                          static_cast<uint64_t>(e_inner ? rows : E)};
  const uint64_t as[2] = {static_cast<uint64_t>(e_inner ? sa : lda) * 2,
                          static_cast<uint64_t>(e_inner ? lda : sa) * 2};
  const uint32_t abox[3] = {BK, e_inner ? 1u : 8u, e_inner ? 8u : 1u};
  err = hopper::encode(&amap, hopper::map_shape(A, 3, ad, as, abox));
  if (err) return err;

  const Problem p{static_cast<__nv_bfloat16*>(C), static_cast<const int*>(
                      counts), E, rows, N, K, ldc, sc, stages, nt_max,
                  e_inner};
  grouped_wgmma<<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      wmap, amap, p);
  return static_cast<int>(cudaGetLastError());
}


// The same for the backward kernels: which 0, dA (a ring of `stages`
// with nt_max token rows a stage; the 256-row tile past 64 rows); which
// 1, dB (nt_max unused).
extern "C" int gg_bwd_smem_bytes(int which, int E, int stages, int nt_max) {
  return which ? db_layout(E, stages).bytes
               : da_layout(E, stages, nt_max).bytes;
}

// dA[e] = dC[e] * B[e]^T over rows [0, counts[e]) for e < E: dC (E, C, N)
// with row stride ldx and expert stride sx; B (E, K, N) with ldw and sw;
// out (E, C, K) with ldc and sc, rows at or beyond a count left
// unwritten; counts (E,) int32 on the device.  All bf16, 16-byte
// aligned, N a multiple of 8, strides multiples of 8 values.  grid CTAs
// (persistent), a ring of `stages` (3-6) with nt_max token rows a stage
// (the largest chunk: min(160, C) rounded up to 8 up to 64 and to 32
// beyond).  E <= 1,024.  Rows are written in 16-byte pieces where K is a
// multiple of 8, value by value otherwise.
extern "C" int gg_grouped_bwd_da(const void* dC, const void* B, void* out,
                                 const void* counts, int E, int rows, int N,
                                 int K, int64_t ldx, int64_t sx, int64_t ldw,
                                 int64_t sw, int64_t ldc, int64_t sc,
                                 int grid, int stages, int nt_max,
                                 void* stream) {
  const int largest = rows < DA_CHUNK ? rows : DA_CHUNK;
  const int need = largest <= 64 ? (largest + 7) & ~7 : (largest + 31) & ~31;
  if (E < 1 || E > MAX_E || rows < 1 || N < 8 || N % 8 || K < 1 ||
      grid < 1 || stages < MIN_STAGES || stages > MAX_STAGES || nt_max < need ||
      nt_max > DA_CHUNK || nt_max % 8 || counts == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = da_layout(E, stages, nt_max);
  if (L.bytes > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr[2] = {allow_smem(grouped_bwd_da<1>),
                                      allow_smem(grouped_bwd_da<2>)};
  for (const cudaError_t a : attr)
    if (a != cudaSuccess) return static_cast<int>(a);

  CUtensorMap wmap, xmap, xmap32;
  int w_inner, x_inner;
  int err = rows_map(&wmap, B, E, K, N, ldw, sw, BK, true, &w_inner);
  if (!err) err = rows_map(&xmap, dC, E, rows, N, ldx, sx, 8, false, &x_inner);
  if (!err)
    err = rows_map(&xmap32, dC, E, rows, N, ldx, sx, 32, false, &x_inner);
  if (err) return err;
  const int vec = K % 8 == 0 && ldc % 8 == 0 && sc % 8 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const DaProblem p{static_cast<__nv_bfloat16*>(out),
                    static_cast<const int*>(counts), E, rows, K, N, ldc, sc,
                    stages, nt_max, x_inner, w_inner, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (da_mw(nt_max) == 2)
    grouped_bwd_da<2><<<grid, BWD_THREADS, L.bytes, st>>>(wmap, xmap, xmap32,
                                                          p);
  else
    grouped_bwd_da<1><<<grid, BWD_THREADS, L.bytes, st>>>(wmap, xmap, xmap32,
                                                          p);
  return static_cast<int>(cudaGetLastError());
}

// dB[e] = A[e]^T * dC[e] summed over rows [0, counts[e]) for e < E: A
// (E, C, K) with row stride lda and expert stride sa; dC (E, C, N) with
// ldx and sx; out (E, K, N) contiguous, zeros for an expert at count 0;
// counts (E,) int32 on the device.  All bf16, 16-byte aligned, N a
// multiple of 8, strides multiples of 8 values.  grid CTAs (persistent),
// a ring of `stages` (2-3).  E <= 1,024.
extern "C" int gg_grouped_bwd_db(const void* A, const void* dC, void* out,
                                 const void* counts, int E, int rows, int K,
                                 int N, int64_t lda, int64_t sa, int64_t ldx,
                                 int64_t sx, int grid, int stages,
                                 void* stream) {
  if (E < 1 || E > MAX_E || rows < 1 || K < 1 || N < 8 || N % 8 ||
      grid < 1 || stages < DB_MIN_STAGES || stages > DB_MAX_STAGES ||
      counts == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const DbLayout L = db_layout(E, stages);
  if (L.bytes > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = allow_smem(grouped_bwd_db);
  if (attr != cudaSuccess) return static_cast<int>(attr);

  CUtensorMap amap, xmap, omap;
  int a_inner, x_inner, o_inner;
  int err = rows_map(&amap, A, E, rows, K, lda, sa, DB_ROWS, false, &a_inner);
  if (!err)
    err = rows_map(&xmap, dC, E, rows, N, ldx, sx, DB_ROWS, false, &x_inner);
  if (!err)
    err = rows_map(&omap, out, E, K, N, N, static_cast<int64_t>(K) * N, 64,
                   false, &o_inner);
  if (err) return err;
  const DbProblem p{static_cast<const int*>(counts), E, rows, K, N, stages,
                    a_inner, x_inner};
  grouped_bwd_db<<<grid, BWD_THREADS, L.bytes,
                   static_cast<cudaStream_t>(stream)>>>(amap, xmap, omap, p);
  return static_cast<int>(cudaGetLastError());
}
