// Expert-grouped GEMM for Hopper (sm_90a): C[e] = A[e] * B[e] for every
// expert e of an MoE layer in one launch, only the rows below each
// expert's count.  No Pallas original: the reference computes these
// products as an XLA einsum (src/repro/models/moe.py:115-118); this is
// the streaming GEMM (_gemm_kernel of src/repro/kernels/streaming_gemm.py)
// applied per expert, and it also runs multi-head latent attention's
// absorbed per-head products (the heads as groups).
//
// What bounds it on the H100: bytes.  Each touched expert's weight (K x N
// bf16) is read once; its kept rows are few (8 tokens at decode; about 8
// of deepseek-v3's 256-token prefill and 34 of qwen2-moe's 512-token one),
// so the tensor work, 2 * rows * K * N, stays far under the weight bytes'
// time.  What held the first kernel back (an m-tile x expert grid, 128
// token rows a tile at prefill, mma.sync) was CTAs scheduled for experts
// no token chose and tensor work on padding rows.
//
// The design:
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
// The launcher returns cudaGetLastError() of its launch, or an encoding
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

// Item i of the list: the expert whose items hold i (the last e with
// start[e] <= i), then its chunk and 128-column tile.
__device__ __forceinline__ Item item(int i, const int* start, const int* cnt,
                                     int E, int n_tiles) {
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (start[mid] <= i) lo = mid; else hi = mid - 1;
  }
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
  if (warp == 0) {  // exclusive scan of items per expert: lane ranges
    const int per = cdiv(p.E, 32), e0 = min(p.E, lane * per),
              e1 = min(p.E, e0 + per);
    int sum = 0;
    for (int e = e0; e < e1; ++e) sum += cdiv(cnt[e], CHUNK) * n_tiles;
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    int run = incl - sum;
    for (int e = e0; e < e1; ++e) {
      start[e] = run;
      run += cdiv(cnt[e], CHUNK) * n_tiles;
    }
    if (lane == 31) start[p.E] = incl;
  }
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
