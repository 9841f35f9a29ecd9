// Flash attention forward for Hopper (sm_90a): softmax(Q K^T / sqrt(D)) V
// with an online softmax, causal or full, over the (B, T, H, D) layout.
// Replaces the Pallas kernel _flash_kernel of
// src/repro/kernels/flash_attention.py.  Both kernels stop the causal key
// loop at the block's diagonal (tiles above it are never loaded), give
// masked scores -1e30, round the probabilities to V's dtype before the
// PV product (as the Pallas kernel does) and floor l at 1e-30.  Query
// head h reads KV head h / (H / KH), so GQA needs no repeated K/V.
//
// On the H100, at prefill lengths of 64-512 tokens, neither bytes nor
// tensor-core operations bound the kernel (both under a microsecond):
// the serial walk of the diagonal block over its key tiles and the
// latency of each tile do.
//
//  * flash_bf16 — bf16, tensor cores.  One CTA of four warps serves the
//    G = H / KH query heads of one KV head: its 64 rows are (position,
//    head) pairs, flat row R = t * G + g, so each K/V tile is loaded once
//    per KV head and query block, whatever G is (7 for Qwen2-0.5B; the
//    row map divides by G and assumes no power of two).  The block's key
//    tiles are split over a thread-block cluster of S CTAs (S from the
//    caller, grid x = blocks * S): CTA r walks its share, parks its
//    partial (m, l, acc) in shared memory, and after a cluster barrier
//    finishes 1/S of the rows by merging the S states in rank order
//    through distributed shared memory (one launch, no atomics).  K/V
//    stay bf16 in a 2-3 stage cp.async ring, the next tile in flight
//    while the current one is multiplied.  QK^T and PV run as mma.sync
//    m16n8k16 bf16 with fp32 accumulation (products of bf16 values are
//    exact in fp32, so only the summation order differs from the
//    reference's fp32 dot); K fragments come from ldmatrix, V fragments
//    from ldmatrix.trans.  The online softmax stays in registers, in the
//    log2 domain, with quad shuffles for the row max; P is rounded to
//    bf16 in registers and fed straight in as the A fragment of PV.
//    Under the causal mask the heaviest query blocks are scheduled
//    first.  Q, K and V rows must be 16-byte aligned.
//  * flash_f32 — float32, scalar FMA (no TF32, for the 3e-5 contract).
//    One CTA of 128 threads owns a 32-row query block of one (batch,
//    head); four threads share a query row.
//
// Each launcher returns cudaGetLastError() of its launch.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;

// ---------------------------------------------------------- bf16 path
constexpr int BR = 64, BKV = 64;  // flat query rows, keys per tile
constexpr int MAX_SPLITS = 8;     // portable thread-block cluster size
constexpr float LOG2E = 1.4426950408889634f;

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
struct FlashGeo {
  static constexpr int LD = D + 8;  // 16-byte pad: conflict-free ldmatrix
  static constexpr int STAGES = D <= 64 ? 3 : 2;
  static constexpr int Q_ELEMS = BR * LD, KV_ELEMS = BKV * LD;
  // after the key loop the K/V ring holds this CTA's partial softmax
  // state: acc [BR][ACC_LD] then m [BR] and l [BR], fp32
  static constexpr int ACC_LD = D + 4;
  static constexpr int RING_BYTES = 2 * 2 * STAGES * KV_ELEMS;
  static constexpr int PART_BYTES = 4 * (BR * ACC_LD + 2 * BR);
  static constexpr int SMEM =
      2 * Q_ELEMS + (RING_BYTES > PART_BYTES ? RING_BYTES : PART_BYTES);
  // the merge's per-row weights and 1/l reuse the Q tile
  static_assert(4 * (MAX_SPLITS + 1) * BR <= 2 * Q_ELEMS, "merge scratch");
};

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int Tq, int Tk, int H, int KH,
               int64_t sqb, int64_t sqt, int64_t sqh, int64_t skb,
               int64_t skt, int64_t skh, int64_t svb, int64_t svt,
               int64_t svh, float scale_log2, int causal) {
  using F = FlashGeo<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + F::Q_ELEMS;
  __nv_bfloat16* Vs = Ks + F::STAGES * F::KV_ELEMS;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int G = H / KH, rows = Tq * G;
  const int nblk = gridDim.x / splits, raw = blockIdx.x / splits;
  const int blk = causal ? nblk - 1 - raw : raw;  // heaviest blocks first
  const int R0 = blk * BR, kh = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = q + b * sqb;
  const __nv_bfloat16* kb = k + b * skb + kh * skh;
  const __nv_bfloat16* vb = v + b * svb + kh * svh;
  constexpr int CH = D / 8;  // 16-byte chunks per row

  for (int c = tid; c < BR * CH; c += THREADS) {
    const int r = c / CH, d = (c % CH) * 8, R = R0 + r;
    const bool ok = R < rows;
    const int t = R / G, h = kh * G + R % G;
    cp_async16(Qs + r * F::LD + d, ok ? qb + t * sqt + h * sqh + d : q, ok);
  }
  const int last = min(R0 + BR, rows) - 1;
  const int kv_end = causal ? min(Tk, last / G + 1) : Tk;
  const int nt_all = (kv_end + BKV - 1) / BKV;  // this block's key tiles
  // the cluster's CTAs split them: this one walks [t0, t0 + nt)
  const int t0 = rank * nt_all / splits;
  const int nt = (rank + 1) * nt_all / splits - t0;
  auto load_kv = [&](int stage, int tile) {
    __nv_bfloat16* ks = Ks + stage * F::KV_ELEMS;
    __nv_bfloat16* vs = Vs + stage * F::KV_ELEMS;
    for (int c = tid; c < BKV * CH; c += THREADS) {
      const int j = c / CH, d = (c % CH) * 8, key = tile * BKV + j;
      const bool ok = key < kv_end;
      cp_async16(ks + j * F::LD + d, ok ? kb + key * skt + d : k, ok);
      cp_async16(vs + j * F::LD + d, ok ? vb + key * svt + d : v, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < F::STAGES - 1; ++s) {  // Q rides with tile 0
    if (s < nt) load_kv(s, t0 + s);
    cp_async_commit();
  }

  // this thread's rows: Ra (fragment row g) and Ra + 8 of warp's 16
  const int Ra = R0 + warp * 16 + g;
  const int ta = Ra / G, tb = (Ra + 8) / G;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[D / 16][4];

  for (int it = 0; it < nt; ++it) {
    cp_async_wait<F::STAGES - 2>();  // tile it (and Q) has landed
    __syncthreads();                 // stage (it - 1) % STAGES is free
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        ldsm_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * F::LD + ks * 16 +
                            (lane >> 4) * 8);
    }
    const int nx = it + F::STAGES - 1;
    if (nx < nt) load_kv(nx % F::STAGES, t0 + nx);
    cp_async_commit();
    const __nv_bfloat16* kt = Ks + (it % F::STAGES) * F::KV_ELEMS;
    const __nv_bfloat16* vt = Vs + (it % F::STAGES) * F::KV_ELEMS;

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 n8 tiles
    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t kf[BKV / 16][4];  // b-fragments of key tiles 2jj, 2jj + 1
#pragma unroll
      for (int jj = 0; jj < BKV / 16; ++jj)
        ldsm_x4(kf[jj], kt + (jj * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) *
                                 F::LD + ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int jj = 0; jj < BKV / 16; ++jj) {
        mma_bf16(s[2 * jj], qf[ks], kf[jj]);
        mma_bf16(s[2 * jj + 1], qf[ks], kf[jj] + 2);
      }
    }

    // mask, scale (log2 domain), online softmax per row
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = (t0 + it) * BKV + j * 8 + 2 * tig + (e & 1);
        const int t = e < 2 ? ta : tb;
        float x = s[j][e] * scale_log2;
        if (key >= Tk || (causal && key > t)) x = NEG_INF;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      corr[r] = exp2f(m_i[r] - m_new);
      m_i[r] = m_new;
      l_i[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_i[e >> 1]);
        l_i[e >> 1] += p;  // this thread's columns; quad-summed at the end
        s[j][e] = p;
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += bf16(P) V: P's accumulator layout is PV's A-fragment layout
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      uint32_t vf[D / 16][4];  // b-fragments of d tiles 2dd, 2dd + 1
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd)
        ldsm_x4_t(vf[dd], vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   F::LD + dd * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        mma_bf16(acc[2 * dd], pa, vf[dd]);
        mma_bf16(acc[2 * dd + 1], pa, vf[dd] + 2);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the K/V ring is dead: it takes the partial state

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
  }
  float* pacc = reinterpret_cast<float*>(Ks);
  float* pm = pacc + BR * F::ACC_LD;
  float* pl = pm + BR;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    if (tig == 0) {
      pm[row] = m_i[r];
      pl[row] = l_i[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(pacc + row * F::ACC_LD + j * 8 + 2 * tig) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
  }
  cluster.sync();  // every CTA's partial state is written and visible

  // CTA `rank` finishes rows [rank*BR/S, (rank+1)*BR/S) of the block,
  // merging the S partial states in rank order 0..S-1 (for S = 1 this is
  // acc / max(l, 1e-30)).  First each row's weights exp2(m_c - max m),
  // then the rows' elements, four at a time; the own rank's state is
  // read locally, the peers' through distributed shared memory.
  const int r0 = rank * BR / splits, nr = (rank + 1) * BR / splits - r0;
  float* wts = reinterpret_cast<float*>(Qs);  // [MAX_SPLITS][BR]: Q is dead
  float* inv_l = wts + MAX_SPLITS * BR;
  auto peer = [&](float* p, int c) {
    return c == rank ? p : cluster.map_shared_rank(p, c);
  };
  if (tid < nr) {
    const int row = r0 + tid;
    float mc[MAX_SPLITS], lc[MAX_SPLITS], mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < MAX_SPLITS; ++c)
      if (c < splits) {
        mc[c] = peer(pm, c)[row];
        lc[c] = peer(pl, c)[row];
        mx = fmaxf(mx, mc[c]);
      }
    float l = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_SPLITS; ++c)
      if (c < splits) {
        const float w = exp2f(mc[c] - mx);
        wts[c * BR + tid] = w;
        l += lc[c] * w;
      }
    inv_l[tid] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < nr * (D / 4); i += THREADS) {
    const int rr = i / (D / 4), d = (i % (D / 4)) * 4, R = R0 + r0 + rr;
    if (R >= rows) continue;
    float4 a[MAX_SPLITS];
#pragma unroll
    for (int c = 0; c < MAX_SPLITS; ++c)
      if (c < splits)
        a[c] = *reinterpret_cast<const float4*>(
            peer(pacc, c) + (r0 + rr) * F::ACC_LD + d);
    float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < MAX_SPLITS; ++c)
      if (c < splits) {
        const float w = wts[c * BR + rr];
        out.x += a[c].x * w;
        out.y += a[c].y * w;
        out.z += a[c].z * w;
        out.w += a[c].w * w;
      }
    const float inv = inv_l[rr];
    const int t = R / G, h = kh * G + R % G;
    __nv_bfloat16* ob = o + ((static_cast<int64_t>(b) * Tq + t) * H + h) * D + d;
    *reinterpret_cast<__nv_bfloat162*>(ob) =
        __floats2bfloat162_rn(out.x * inv, out.y * inv);
    *reinterpret_cast<__nv_bfloat162*>(ob + 2) =
        __floats2bfloat162_rn(out.z * inv, out.w * inv);
  }
  cluster.sync();  // no CTA leaves while a peer still reads its state
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Tq, int Tk, int H, int KH, const int64_t* st, int causal,
                int splits, cudaStream_t stream) {
  using F = FlashGeo<D>;
  auto kern = flash_bf16<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int rows = Tq * (H / KH);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + BR - 1) / BR * splits, KH, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = F::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Tq, Tk, H, KH, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], LOG2E / sqrtf(static_cast<float>(D)), causal);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------- fp32 path
constexpr int BQ = 32;

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * (BKV + 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Tq,
              int Tk, int H, int KH, int64_t sqb, int64_t sqt, int64_t sqh,
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
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + kh * skh;
  const float* vb = v + b * svb + kh * svh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, d = i % D, t = q0 + rr;
    Qs[rr * (D + 1) + d] = t < Tq ? qb[t * sqt + d] : 0.f;
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
      Ks[j * (D + 1) + d] = ok ? kb[key * skt + d] : 0.f;
      Vs[j * D + d] = ok ? vb[key * svt + d] : 0.f;
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
      Ps[r * (BKV + 1) + sub + 4 * i] = p;
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
    float* ob = o + ((static_cast<int64_t>(b) * Tq + t) * H + h) * D;
#pragma unroll
    for (int e = 0; e < D / 4; ++e) ob[sub + 4 * e] = acc[e] * inv;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Tq, int Tk, int H, int KH, const int64_t* st, int causal,
               cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_f32<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Tq, Tk, H, KH,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      1.0f / sqrtf(static_cast<float>(D)), causal);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int Tq, int Tk, int H, int KH, const int64_t* st,
               int causal, int sp, cudaStream_t s) {
  switch (D) {
    case 16: return BF16 ? launch_bf16<16>(q, k, v, o, B, Tq, Tk, H, KH, st, causal, sp, s)
                         : launch_f32<16>(q, k, v, o, B, Tq, Tk, H, KH, st, causal, s);
    case 32: return BF16 ? launch_bf16<32>(q, k, v, o, B, Tq, Tk, H, KH, st, causal, sp, s)
                         : launch_f32<32>(q, k, v, o, B, Tq, Tk, H, KH, st, causal, s);
    case 64: return BF16 ? launch_bf16<64>(q, k, v, o, B, Tq, Tk, H, KH, st, causal, sp, s)
                         : launch_f32<64>(q, k, v, o, B, Tq, Tk, H, KH, st, causal, s);
    case 128: return BF16 ? launch_bf16<128>(q, k, v, o, B, Tq, Tk, H, KH, st, causal, sp, s)
                          : launch_f32<128>(q, k, v, o, B, Tq, Tk, H, KH, st, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides (elements, unit stride on D):
// [q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h]; o is contiguous
// (B, Tq, H, D).  dtype: 0 = float32, 1 = bfloat16 (whose strides must
// be multiples of 8 and pointers 16-byte aligned).  splits (bf16 only,
// 1-8): the CTAs of one cluster that share a query block's key tiles.
extern "C" int fa_forward(int dtype, const void* q, const void* k,
                          const void* v, void* o, int B, int Tq, int Tk,
                          int H, int KH, int D, const int64_t* strides,
                          int causal, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_d<false>(D, q, k, v, o, B, Tq, Tk, H, KH, strides,
                             causal, splits, st);
  if (dtype == 1)
    return dispatch_d<true>(D, q, k, v, o, B, Tq, Tk, H, KH, strides, causal,
                            splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
