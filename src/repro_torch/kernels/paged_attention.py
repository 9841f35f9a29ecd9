"""Paged decode attention on Hopper — launcher of
``csrc/paged_attention.cu``.

Replaces the TPU kernel ``repro/kernels/paged_attention.py``
(``_paged_kernel`` / ``paged_attention_raw``): one query token per
sequence against a K/V page pool reached through a per-sequence page
table (the paper's SMMU step), with an online softmax across pages,
positions >= len masked at −1e30, ``lens = 0`` giving zeros, fp32
scores, probabilities and PV, and output in ``q.dtype``.

What bounds it on the H100: at decode sizes, latency.  Each cached
token's K and V (2·D values of a KV head) is read once per step for the
G = H/KH query heads of its group, about 7 operations per byte at G = 7,
under even the fp32 CUDA-core ridge, and at 8 sequences of 272 tokens
the bytes take a fraction of a microsecond; what a simple kernel pays
for is one CTA per (sequence, KV head) walking its pages one by one.

What the design does about it:

- ``plan(B, KH, max_pages)`` splits each sequence's pages over a
  thread-block cluster of S CTAs (S <= 8), so that B·KH·S reaches the
  card's 132 SMs where the table is wide enough.  It reads only the
  table's width: each CTA reads its sequence's length on the device and
  takes its own contiguous share of the ⌈len/page⌉ pages.
- Inside a CTA the warps take pages round-robin, each with its own
  online-softmax state, streaming pages through a two-slot ``cp.async``
  ring per warp (``walkers`` of them: four, or two where four rings do
  not fit), so four pages are in flight per CTA with no block barrier
  in the page loop; scores, max and sum use warp shuffles.
- The warps' and then the cluster's states are merged in a fixed order
  through shared and distributed shared memory: one launch, no
  workspace, no atomics, the same bits on every run.

- A CTA holds its heads' G·D query values and fp32 state in registers
  and shared memory, at most ``MAX_GROUP_ELEMS`` (2,048) of them.  Where
  G·D is larger (granite-20b's MQA: 48 heads of 128 over one KV head,
  6,144), ``head_groups`` splits the G query heads of a KV head into
  equal groups of at most 2,048 values, and each group gets its own CTAs
  (grid y = KH · groups) in the same launch.  Each group walks its KV
  head's pages again: under MQA a token's K and V are 512 B, so three
  groups read 1 KB more a token, mostly from L2.  Shapes with G·D <=
  2,048 take one group and launch as before.

INT8 pools (``Tuning.kv_cache_quant``): with fp16 scale pools
``k_scale`` / ``v_scale``, ``paged_cuda`` hands over to
``paged_int8_cuda``, the kernel ``paged_int8_fwd`` of
``csrc/paged_int8.cu`` (entries ``pa_forward_int8`` and, with the decode
step's quantize-and-append folded in, ``pa_append_forward_int8``), bf16
q and output.  The scale pools are (P, KH, page), not the reference's
(…, seq, KH): one KV head's 16 scales of a page are then 32 contiguous
bytes, one bulk copy.  Scores take the token's K scale after the slices
are summed; each probability stored for PV takes its V scale (the sum l
does not), so P stays fp32 as in the bf16 kernel, where the reference
rounds ``p · v_scale`` to bf16.  The pools and scales are about half the
bf16 pools' bytes (22.6 MB against 42 MB at qwen1.5-32b's 8 x 272).
``int8_plan`` picks its heads tier, head groups, split and ring depth.

The latent form (``paged_latent_cuda``, the ``pa_latent_forward`` entry
of the same source) serves multi-head latent attention's absorbed
decode (deepseek-v3-671b): 128 query heads of 576 over ONE latent KV
head of 576 columns whose first 512 are also V, in one pool (P, page,
1, 576), with the caller's scale (1/√192).  ``head_groups`` would cut
128 heads of 576 into 43 groups that each walk the same pages; instead
a CTA holds a block of query heads and stages each page once in shared
memory, where QKᵀ and PV both read it; the pages of a sequence split
over a cluster of ``latent_plan`` CTAs and merge as above.  P stays
fp32.  In bf16 (the served path) a CTA holds ``LATENT_HEADS`` = 64
heads and runs both products on tensor cores (``wgmma``; PV as bf16 hi
and lo halves of P), its pages brought by TMA into a ring of 3 slots of
32 tokens; in fp32 (on no served path) an FMA kernel holds 16.

What still bounds it: the serial walk of a CTA's pages (a slot's QKᵀ,
softmax and PV) and a fixed cost per launch (the cluster launch, the
length and table row, then the first pages; the merge through
distributed shared memory).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 112, 128)
INT8_HEAD_DIMS = (16, 32, 64, 128)   # int8 pools (no int8 arch has D 112)
PAGE_SIZES = (8, 16, 32)
MAX_GROUP_ELEMS = 2048      # a CTA's heads x D: 32 fp32 pairs per lane
MAX_SMEM_BYTES = 227 * 1024
SMS = 132                   # H100 SXM streaming multiprocessors
SM_SMEM_BYTES = 228 * 1024  # an SM's shared memory, 1 KB of it kept a CTA
MAX_SPLITS = 8              # portable thread-block cluster size
WARPS = 4                   # warps per CTA, each walking its own pages
_VP, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGS = [_I32, _VP, _VP, _VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32,
         _I32, _I32, _I32, _I32, _VP]
_INT8_ARGS = [_VP] * 8 + [_I32] * 11 + [_VP]
_INT8_APPEND_ARGS = [_VP] * 11 + [_I32] * 11 + [_VP]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def head_groups(G: int, D: int) -> int:
    """How many groups of CTAs share the G query heads of a KV head: one
    while G·D <= ``MAX_GROUP_ELEMS``, else the fewest count of at least
    ⌈G·D / MAX_GROUP_ELEMS⌉ that divides G (3 groups of 16 heads at G
    48, D 128)."""
    n = _cdiv(G * D, MAX_GROUP_ELEMS)
    while G % n:
        n += 1
    return n


def plan(B: int, KH: int, max_pages: int) -> int:
    """How many CTAs (one cluster) share each grid row's pages: the
    fewest for which the grid B·KH·S covers the card's SMs, at most
    ``MAX_SPLITS`` and at most half the table's width (so a full table
    gives every CTA at least two pages).  ``KH`` counts the grid's rows
    per sequence, KV heads times ``head_groups``: take both from
    ``launch_plan``.  Reads only the table's width, never ``lens``,
    which lives on the device."""
    return max(1, min(MAX_SPLITS, _cdiv(max_pages, 2),
                      _cdiv(SMS, max(B * KH, 1))))


def launch_plan(B: int, H: int, KH: int, D: int,
                max_pages: int) -> tuple[int, int]:
    """The launch's ``(groups, splits)`` for B sequences of H query heads
    of D over KH KV heads: the ``head_groups`` of a KV head's H / KH
    query heads, and the ``plan`` of the B · KH · groups grid rows."""
    groups = head_groups(H // KH, D)
    return groups, plan(B, KH * groups, max_pages)


def smem_bytes(G: int, D: int, page: int, max_pages: int, walkers: int,
               esz: int) -> int:
    """The kernel's dynamic shared memory for a CTA of G query heads (a
    head group's), as ``layout`` in the source computes it: fp32 scratch
    (q, each warp's p and (m, l), the CTA's state, the merge weights),
    the sequence's table row, then the walking warps' two-slot K/V rings
    of rows padded by 16 bytes, which the warps' fp32 partial states take
    over after the page loop."""
    words = (2 * G * D + WARPS * G * page + 3 * WARPS * G + 3 * G
             + MAX_SPLITS * G + max_pages)
    slot = 2 * page * (D * esz + 16)
    ring = walkers * 2 * slot
    return _cdiv(4 * words, 16) * 16 + max(ring, WARPS * G * D * 4)


def walkers(G: int, D: int, page: int, max_pages: int, esz: int) -> int:
    """How many of the four warps walk pages: all four, or two where four
    rings of the largest pages (32 tokens of fp32 at D 128: 264 KB) would
    not fit."""
    fits = smem_bytes(G, D, page, max_pages, WARPS, esz) <= MAX_SMEM_BYTES
    return WARPS if fits else 2


# ---------------------------------------------- the int8 kernel's plan
INT8_TIERS = (1, 2, 4, 8)   # query heads a CTA is compiled for
INT8_RING = (2, 4)          # page slots a warp: the least, the most
# bytes the card must have in flight to keep 3.35 TB/s busy across ~1 us
# of memory latency (Little's law): ~25 KB an SM
INFLIGHT_BYTES = 3.35e12 * 1e-6
# a grid whose full tables' distinct bytes take 12 us at 3.35 TB/s is
# bound by them: more splits would add CTAs and merges, not bandwidth
BANDWIDTH_BOUND_BYTES = 3.35e12 * 12e-6


class Int8Plan(NamedTuple):
    tier: int      # GB: query heads a CTA is compiled for (1, 2, 4, 8)
    groups: int    # head groups (CTAs) a KV head: G / groups <= tier
    splits: int    # S: CTAs of one cluster that share a sequence's pages
    ring: int      # page slots each of the CTA's warps keeps in flight


def int8_head_groups(G: int, kv_rows: int) -> int:
    """How many head groups share a KV head's G query heads, for a grid
    of ``kv_rows`` = B · KH (sequence, KV head) rows: the fewest groups
    of at most ``INT8_TIERS[-1]`` heads that divide G equally and give
    the grid at least one row an SM; where none does, one head a group.
    A group's CTAs walk its KV head's pages again (from L2 after the
    first), but a small grid gains CTAs that walk in parallel and fewer
    heads a page: at qwen2-0.5b's 8 x 2 rows its 7 heads take 7 groups
    (on the H100, ``launch/kernel_sweep.py --only int8``: 0.0077 device
    ms at 8 x 272 against 0.0097 in one group of the 8-head tier), at
    qwen1.5-32b's 320 rows one, at granite-20b's 8 rows of 48 heads 24
    groups of 2."""
    divisors = [n for n in range(_cdiv(G, INT8_TIERS[-1]), G + 1)
                if G % n == 0]
    return next((n for n in divisors if kv_rows * n >= SMS), G)


def int8_ctas_per_sm(tier: int, D: int, page: int, max_pages: int,
                     ring: int) -> int:
    """CTAs of the int8 kernel an SM holds at once: as many as its launch
    bounds ask registers for (``min_ctas`` in the source: four for the
    one- and two-head tiers at D <= 64, three else), fewer where their
    shared memory (``int8_smem_bytes`` and 1 KB each) does not fit the
    SM's 228 KB."""
    smem = int8_smem_bytes(tier, D, page, max_pages, ring) + 1024
    return max(1, min(4 if tier <= 2 and D <= 64 else 3,
                      SM_SMEM_BYTES // smem))


def int8_smem_bytes(tier: int, D: int, page: int, max_pages: int,
                    ring: int) -> int:
    """The int8 kernel's dynamic shared memory, as ``layout`` in
    ``csrc/paged_int8.cu`` computes it: 1 KB of alignment slack, then the
    warps' rings of (page, D) K and V boxes (which the warps' fp32
    partial outputs take over after the walk), the slots' scale pages, a
    barrier a slot, q, each warp's probabilities, the warps' and the
    CTA's states, the merge weights, the appended row and the table row;
    each region rounded up to 16 bytes."""
    slots = WARPS * ring
    regions = (max(slots * 2 * page * D, WARPS * tier * D * 4),
               slots * 4 * page, slots * 8, tier * D * 4,
               WARPS * page * tier * 4, WARPS * tier * 4, WARPS * tier * 4,
               WARPS * tier * 4, tier * 4, tier * 4,
               tier * D * 4, MAX_SPLITS * tier * 4, tier * 4, 2 * D + 4,
               max_pages * 4)
    return 1024 + sum(_cdiv(r, 16) * 16 for r in regions)


def int8_plan(B: int, H: int, KH: int, D: int, max_pages: int,
              page: int = 16) -> Int8Plan:
    """The int8 kernel's launch for B sequences of H query heads of D
    over KH KV heads and a table ``max_pages`` wide, from the shapes alone
    (never ``lens``, which lives on the device):

    - the head groups of a KV head's G = H / KH query heads
      (``int8_head_groups``) and the least tier that holds a group;
    - the split S, within 1..8 and half the table's width: at least one
      CTA an SM, and beyond that as many splits as the card holds in one
      wave (``int8_ctas_per_sm`` CTAs an SM) while the grid is bound by
      latency rather than by its bytes, i.e. while S times the distinct
      bytes of full tables (B · KH · max_pages · page · (2D + 4)) stays
      within ``BANDWIDTH_BOUND_BYTES``.  Each CTA keeps its warps' rings
      in flight (8 slots, 33 KB at D 128; qwen1.5-32b's 320 rows hold
      10.6 MB at S = 1, ``INFLIGHT_BYTES`` is 3.35 MB) and shortens every
      warp's walk, but a bandwidth-bound grid gains nothing from it: on
      the H100 (``kernel_sweep.py --only int8``) qwen1.5-32b takes
      0.0182 device ms at S = 1 against 0.0252 at S = 2, qwen2-0.5b's
      112 rows 0.0077 at S = 4 against 0.0084 at S = 1;
    - the ring: two slots a warp where the grid has more CTAs than the
      card has SMs (deeper rings would only cost CTAs an SM); on a smaller
      grid the slots a warp needs to have all its pages of a full table
      in flight, within 2..4, fewer while the CTA would not fit 227 KB."""
    G = H // KH
    groups = int8_head_groups(G, B * KH)
    tier = next(t for t in INT8_TIERS if t >= G // groups)
    rows = B * KH * groups
    cap = max(1, min(MAX_SPLITS, _cdiv(max_pages, 2)))
    wave = SMS * int8_ctas_per_sm(tier, D, page, max_pages, INT8_RING[0])
    nbytes = B * KH * max_pages * page * (2 * D + 4)
    by_bytes = int(BANDWIDTH_BOUND_BYTES // max(nbytes, 1))
    splits = max(1, min(cap, max(_cdiv(SMS, max(rows, 1)),
                                 min(wave // max(rows, 1), by_bytes))))
    ring = INT8_RING[0]
    if rows * splits <= SMS:
        ring = min(INT8_RING[1], max(ring, _cdiv(_cdiv(max_pages, splits),
                                                  WARPS)))
    while ring > INT8_RING[0] and int8_smem_bytes(
            tier, D, page, max_pages, ring) > MAX_SMEM_BYTES:
        ring -= 1
    return Int8Plan(tier, groups, splits, ring)


def paged_int8_cuda(q, k_pages, v_pages, table, lens, k_scale, v_scale,
                    append=None) -> torch.Tensor:
    """The int8 kernel: q (B, H, D) bf16; int8 pools (P, page, KH, D);
    fp16 scale pools (P, KH, page); table (B, max_pages) int32; lens (B,)
    int32 — contiguous CUDA tensors on one device, the pools and scale
    pools 16-byte aligned.  Returns (B, H, D) bf16.

    ``append = (k, v, rows)``: the decode step's new bf16 rows (B, KH, D)
    (16-byte aligned) and their flat pool rows (B,) int64, row b being
    where position ``lens[b] - 1`` of sequence b lands.  The same launch
    quantizes them as ``kv_quant_cuda`` does, attends over them and
    stores their codes and scales (the ``pa_append_forward_int8``
    entry)."""
    B, H, D = q.shape
    P, page, KH, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D or H % KH:
        raise ValueError(f"paged int8 shapes q{tuple(q.shape)} "
                         f"pool{tuple(k_pages.shape)}")
    if table.dim() != 2 or table.shape[0] != B or tuple(lens.shape) != (B,):
        raise ValueError(f"paged table{tuple(table.shape)} "
                         f"lens{tuple(lens.shape)} for batch {B}")
    if D not in INT8_HEAD_DIMS or page not in PAGE_SIZES:
        raise ValueError(f"paged int8: head dim {D} not in "
                         f"{INT8_HEAD_DIMS} or page {page} not in "
                         f"{PAGE_SIZES}")
    if q.dtype != torch.bfloat16 or k_pages.dtype != torch.int8 \
            or v_pages.dtype != torch.int8 or k_scale is None \
            or v_scale is None or k_scale.dtype != torch.float16 \
            or v_scale.dtype != torch.float16:
        raise TypeError("paged int8: bf16 q, int8 pools and fp16 scale "
                        "pools")
    if k_scale.shape != (P, KH, page) or v_scale.shape != (P, KH, page):
        raise ValueError(f"paged int8 scale pools {tuple(k_scale.shape)}, "
                         f"want {(P, KH, page)}")
    if table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("paged table and lens must be int32")
    ts = [q, k_pages, v_pages, k_scale, v_scale, table, lens]
    if append is not None:
        k, v, rows = append
        if k.shape != (B, KH, D) or v.shape != k.shape \
                or tuple(rows.shape) != (B,):
            raise ValueError(f"paged int8 append: k{tuple(k.shape)} "
                             f"rows{tuple(rows.shape)}, want "
                             f"{(B, KH, D)} and {(B,)}")
        if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16 \
                or rows.dtype != torch.int64:
            raise TypeError("paged int8 append: bf16 k, v and int64 rows")
        if k.data_ptr() % 16 or v.data_ptr() % 16:
            raise ValueError("paged int8 append: 16-byte loads need "
                             "aligned k, v")
        ts += [k, v, rows]
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("paged_int8_cuda needs every operand on q's CUDA "
                         "device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_int8_cuda needs contiguous operands")
    if any(t.data_ptr() % 16 for t in ts[1:5]):
        raise ValueError("paged_int8_cuda: TMA and bulk copies need "
                         "16-byte aligned pools")
    max_pages = table.shape[1]
    plan = int8_plan(B, H, KH, D, max_pages, page)
    smem = int8_smem_bytes(plan.tier, D, page, max_pages, plan.ring)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"paged int8: {smem} B of shared memory for D "
                         f"{D}, page {page}, table width {max_pages}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    dims = (B, H, KH, plan.groups, plan.tier, D, P, page, max_pages,
            plan.splits, plan.ring, _build.stream(q.device))
    pools = (_build.ptr(k_pages), _build.ptr(v_pages), _build.ptr(k_scale),
             _build.ptr(v_scale), _build.ptr(table), _build.ptr(lens),
             _build.ptr(out))
    if append is None:
        code = _build.function("paged_int8", "pa_forward_int8", _INT8_ARGS)(
            _build.ptr(q), *pools, *dims)
        _build.check(code, "paged_attention_int8")
    else:
        code = _build.function("paged_int8", "pa_append_forward_int8",
                               _INT8_APPEND_ARGS)(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(rows),
            *pools, *dims)
        _build.check(code, "paged_attention_int8_append")
    return out


LATENT_DIMS = ((576, 512),)  # (q/k dim, v dim) of the latent form
LATENT_HEADS = 64               # query heads per CTA, bf16 (tensor cores)
LATENT_HEADS_F32 = 16           # query heads per CTA, fp32 (FMA)
LATENT_TOKENS = 32              # tokens a slot of the bf16 kernel's walk
LATENT_FIXED_SLOTS = 4          # a CTA's fixed cost, in slots walked
# clusters of S bf16 latent CTAs (one an SM, ~205 KB of shared memory) the
# H100 runs at once, S = 1..8: cudaOccupancyMaxActiveClusters through
# ``pa_latent_max_clusters`` (an 8-CTA cluster needs 8 free SMs of one
# GPC, so 15 fit, not 132 / 8)
LATENT_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)
_LATENT_ARGS = [_I32, _VP, _VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32,
                _I32, _I32, _I32, ctypes.c_float, _VP]


def latent_plan(B: int, H: int, max_pages: int, page: int = 16,
                esz: int = 2) -> int:
    """How many CTAs (one cluster) share a sequence's pages in the latent
    form.  A CTA walks its share of a full table, ⌈max_pages / S⌉ pages
    (in bf16, slots of 32 tokens), after a fixed cost of about
    ``LATENT_FIXED_SLOTS`` slots; the B · ⌈H / heads⌉ clusters run in
    waves of as many as the card holds at once (``LATENT_CLUSTERS``;
    fp32: 132 / S).  The plan is the S of 1..``MAX_SPLITS`` (at most the
    table's width) with the least waves · (walk + fixed cost), the
    fewest CTAs on a tie: a wide table buys splits until a cluster size
    no longer fits one wave.  ``esz``: the element size (2: bf16, 64
    heads a CTA; 4: fp32, 16 heads, page by page)."""
    bf16 = esz == 2
    rows = B * _cdiv(H, LATENT_HEADS if bf16 else LATENT_HEADS_F32)

    def cost(s):
        walk = _cdiv(max_pages, s)
        if bf16:
            walk = _cdiv(walk * page, LATENT_TOKENS)
            waves = _cdiv(rows, LATENT_CLUSTERS[s - 1])
        else:
            waves = _cdiv(rows * s, SMS)
        return waves * (walk + LATENT_FIXED_SLOTS)

    return min(range(1, max(1, min(MAX_SPLITS, max_pages)) + 1),
               key=lambda s: (cost(s), s))


def latent_smem_bytes(D: int, dv: int, page: int, max_pages: int,
                      esz: int) -> int:
    """The latent kernel's dynamic shared memory, as ``tc_layout`` (bf16)
    or ``latent_layout`` (fp32) in the source computes it.  bf16: 1 KB of
    alignment slack, q (64 heads x 576, 72 KB), a ring of 3 slots of 32
    tokens of 1,152 B rows and two buffers of S halves (16 KB), which the
    CTA's fp32 (64, dv + 8) accumulator takes over after the walk; a
    barrier a slot, the CTA's m and l, the merge weights, 1 / l and the
    table row.  fp32: fp32 scratch (scores, probabilities, corrections, m
    and l, merge weights), the table row, then two page slots of rows
    padded by 16 bytes, which the CTA's fp32 (16, dv) accumulator takes
    over after the walk."""
    if esz == 2:
        main = max(9 * LATENT_HEADS * 128 + 3 * 9 * 32 * 128 + 16384,
                   LATENT_HEADS * (dv + 8) * 4)
        return 1024 + main + 8 * 3 + 4 * LATENT_HEADS * 3 \
            + 4 * MAX_SPLITS * LATENT_HEADS + 4 * max_pages
    words = 16 * 33 + 32 * 16 + 3 * 16 + MAX_SPLITS * 16 + 16 + max_pages
    ring = 2 * page * (D * esz + 16)
    return _cdiv(4 * words, 16) * 16 + max(ring, 16 * dv * 4)


def paged_latent_cuda(q, pool, table, lens, dv: int,
                      scale: float) -> torch.Tensor:
    """The latent form: q (B, H, D); one pool (P, page, 1, D) whose first
    ``dv`` columns are V; table (B, max_pages) int32; lens (B,) int32 —
    contiguous CUDA tensors on one device, the pool 16-byte aligned.
    Scores are scaled by ``scale``.  Returns (B, H, dv) in ``q.dtype``."""
    B, H, D = q.shape
    if pool.dim() != 4 or pool.shape[2] != 1 or pool.shape[3] != D:
        raise ValueError(f"paged latent shapes q{tuple(q.shape)} "
                         f"pool{tuple(pool.shape)}")
    P, page = pool.shape[:2]
    if (D, dv) not in LATENT_DIMS or H % LATENT_HEADS_F32 or H == 0 \
            or page not in PAGE_SIZES:
        raise ValueError(f"paged latent: dims ({D}, {dv}) not in "
                         f"{LATENT_DIMS}, {H} heads not a multiple of "
                         f"{LATENT_HEADS_F32} or page {page} not in "
                         f"{PAGE_SIZES}")
    if table.dim() != 2 or table.shape[0] != B or tuple(lens.shape) != (B,):
        raise ValueError(f"paged table{tuple(table.shape)} "
                         f"lens{tuple(lens.shape)} for batch {B}")
    if q.dtype != pool.dtype or q.dtype not in _DTYPES:
        raise TypeError(f"paged latent dtypes {q.dtype}, {pool.dtype}")
    if table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("paged table and lens must be int32")
    ts = (q, pool, table, lens)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("paged_latent_cuda needs every operand on q's "
                         "CUDA device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_latent_cuda needs contiguous operands")
    if pool.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("paged_latent_cuda: 16-byte loads need aligned "
                         "q and pool")
    max_pages = table.shape[1]
    smem = latent_smem_bytes(D, dv, page, max_pages, q.element_size())
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"paged latent: {smem} B of shared memory for "
                         f"page {page}, table width {max_pages}")
    out = torch.empty((B, H, dv), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    code = _build.function("paged_attention", "pa_latent_forward",
                           _LATENT_ARGS)(
        _DTYPES[q.dtype], _build.ptr(q), _build.ptr(pool), _build.ptr(table),
        _build.ptr(lens), _build.ptr(out), B, H, D, dv, P, page, max_pages,
        latent_plan(B, H, max_pages, page, q.element_size()), float(scale),
        _build.stream(q.device))
    _build.check(code, "paged_latent_attention")
    return out


def paged_cuda(q, k_pages, v_pages, table, lens, k_scale=None,
               v_scale=None) -> torch.Tensor:
    """q: (B, H, D); pools: (P, page, KH, D); table: (B, max_pages)
    int32; lens: (B,) int32 — contiguous CUDA tensors on one device, the
    pools 16-byte aligned.  Returns (B, H, D) in ``q.dtype``.

    int8 pools take fp16 scale pools ``k_scale`` / ``v_scale`` of (P,
    KH, page), also 16-byte aligned, with bf16 q: ``paged_int8_cuda``;
    pools of q's dtype take none."""
    if k_pages.dtype == torch.int8:
        return paged_int8_cuda(q, k_pages, v_pages, table, lens, k_scale,
                               v_scale)
    B, H, D = q.shape
    P, page, KH, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D or H % KH:
        raise ValueError(f"paged shapes q{tuple(q.shape)} "
                         f"pool{tuple(k_pages.shape)}")
    if table.dim() != 2 or table.shape[0] != B or tuple(lens.shape) != (B,):
        raise ValueError(f"paged table{tuple(table.shape)} "
                         f"lens{tuple(lens.shape)} for batch {B}")
    if D not in HEAD_DIMS or page not in PAGE_SIZES:
        raise ValueError(f"paged: head dim {D} not in {HEAD_DIMS} or page "
                         f"{page} not in {PAGE_SIZES}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype) \
            or q.dtype not in _DTYPES or k_scale is not None \
            or v_scale is not None:
        raise TypeError(f"paged dtypes {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("paged table and lens must be int32")
    ts = (q, k_pages, v_pages, table, lens)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("paged_cuda needs every operand on q's CUDA device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_cuda needs contiguous operands")
    if any(t.data_ptr() % 16 for t in ts[1:3]):
        raise ValueError("paged_cuda: cp.async needs 16-byte aligned pools")
    max_pages = table.shape[1]
    groups, splits = launch_plan(B, H, KH, D, max_pages)
    G = H // (KH * groups)                  # query heads per CTA
    esz = k_pages.element_size()
    n_walk = walkers(G, D, page, max_pages, esz)
    smem = smem_bytes(G, D, page, max_pages, n_walk, esz)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"paged: {smem} B of shared memory for G {G}, D "
                         f"{D}, page {page}, table width {max_pages}")
    out = torch.empty_like(q)
    if B == 0:
        return out
    code = _build.function("paged_attention", "pa_forward", _ARGS)(
        _DTYPES[q.dtype], _build.ptr(q), _build.ptr(k_pages),
        _build.ptr(v_pages), _build.ptr(table), _build.ptr(lens),
        _build.ptr(out), B, H, KH, groups, D, page, max_pages, splits,
        n_walk, _build.stream(q.device))
    _build.check(code, "paged_attention")
    return out
