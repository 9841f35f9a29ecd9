"""Functional StreamPlan execution (Algorithm 1 + Fig. 6), on a card.

``execute_plan`` walks a ``core.plan.StreamPlan`` event graph, fetching
pages through a ``PageStore`` (DM / DC / DevMem traffic semantics),
running W×W×depth systolic tile products on ``DMA_IN`` pages, host ops
(softmax / layernorm / gelu / ...) on materialized tensors, and
assembling ``DMA_OUT`` tiles into outputs.  ``gemm_streamed`` builds
the Algorithm-1 plan and executes it.

Where each part runs: the store's pages and every systolic-array
(``sa``) tile step live on the store's device (the card unless the
caller passes ``device="cpu"``), and the drained output buffers too;
host ops run on CPU tensors, as the paper keeps them on the CPU.  In
DM and DC every ``DMA_IN`` is one host-to-device copy of one page from
pinned memory.

Precision follows the reference executor: tile products accumulate in
float32 (int32 for int8 plans), drained outputs are float64, and every
2-byte plan is a float16 plan (``plan.np_dtype_for``), so bfloat16
operands are cast to float16 when they are paged.  An int8 tile step is
an fp32 product of int8 values (``torch.matmul`` has no integer path on
CUDA): one step sums at most 256 products of magnitude ≤ 128·128, so
every partial sum is an integer below 2²⁴ and exact in fp32 — with TF32
off, which ``execute_plan`` checks on a card.  Each step is rounded to
int32 before the steps are summed.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import paging
from repro_torch.core import plan as P
from repro_torch.core.modes import MemoryMode, PageStore
from repro_torch.device import resolve_device
from repro_torch.models.ssm import scan_chunk_2d

_TORCH_DTYPE = {"int8": torch.int8, "float16": torch.float16,
                "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TileOp:
    """One inner-loop step of Algorithm 1 (i, j output tile; k depth)."""
    i: int
    j: int
    k: int
    a_page: int
    b_page: int
    first_k: bool
    last_k: bool


def schedule(M: int, N: int, K: int, dtype,
             page_bytes: int = paging.PAGE_BYTES,
             order: str = "jik") -> Iterator[TileOp]:
    """Generator view of ``plan.gemm_tile_steps``, the single source of
    the paper's loop nest and its cache-aware ``jik`` order."""
    for st in P.gemm_tile_steps(M, N, K, dtype, page_bytes, order):
        yield TileOp(st.i, st.j, st.k, st.a_page, st.b_page,
                     st.first_k, st.last_k)


# ------------------------------------------------------------- host ops
def _slice_cols(x, meta):
    out = x[:, meta["start"]:meta["stop"]]
    return out.T if meta.get("transpose") else out


def _layernorm(x, eps: float = 1e-5):
    x = x.double()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


_ACTS = {"silu": F.silu, "gelu": _gelu}


def _act_mul(xs, m):
    return _ACTS[m["act"]](xs[0].float()) * xs[1].float()


def _moe_route(logits, k: int, C: int):
    """The reference's global dispatch: softmax -> top-k -> stable sort
    by expert -> capacity-C keep mask.  Returns (e_sorted, tok_sorted,
    pos_in_e, keep, sorted normalized probs).  Top-k ties go to the
    lower expert index, as ``lax.top_k`` breaks them: a stable
    descending sort keeps equal probabilities in index order."""
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    n, E = logits.shape
    flat_e = top_e.reshape(-1)
    flat_tok = torch.arange(n).repeat_interleave(k)
    flat_p = top_p.double().reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    e_sorted = flat_e[order]
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(n * k) - starts[e_sorted]
    return (e_sorted, flat_tok[order], pos_in_e, pos_in_e < C,
            flat_p[order])


def _moe_dispatch(xs, m):
    x = xs[0].double()
    e_sorted, tok_sorted, pos, keep, _ = _moe_route(xs[1], m["k"], m["C"])
    bufs = torch.zeros((m["E"], m["C"], x.shape[1]), dtype=torch.float64)
    bufs[e_sorted[keep], pos[keep]] = x[tok_sorted[keep]]
    return tuple(bufs.unbind(0))


def _moe_combine(xs, m):
    e_sorted, tok_sorted, pos, keep, p_sorted = \
        _moe_route(xs[0], m["k"], m["C"])
    ys = torch.stack([y.double() for y in xs[1:]])
    out = torch.zeros((xs[0].shape[0], ys.shape[2]), dtype=torch.float64)
    # sums each token's experts in sorted order, as the reference loop
    out.index_add_(0, tok_sorted[keep],
                   p_sorted[keep, None] * ys[e_sorted[keep], pos[keep]])
    return out


def _ssm_scan(xs, m):
    t0, t1 = m["t0"], m["t1"]
    r, k, v, logw, state = xs
    return scan_chunk_2d(r[t0:t1], k[t0:t1], v[t0:t1], logw[t0:t1],
                         state, m["H"], m["N"], inclusive=m["inclusive"])


def _masked_softmax(xs, m):
    s = xs[0].double() * m["scale"]
    valid = m["valid"]
    s[:, valid:] = -torch.inf
    e = torch.exp(s - s.max(-1, keepdim=True).values)
    e[:, valid:] = 0.0
    return e / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)


_HOST_OPS = {
    "softmax": lambda xs, m: torch.softmax(xs[0].float(), dim=-1),
    "gelu": lambda xs, m: _gelu(xs[0].float()),
    "layernorm": lambda xs, m: _layernorm(xs[0]),
    "add": lambda xs, m: xs[0] + xs[1],
    "slice_cols": lambda xs, m: _slice_cols(xs[0], m),
    "concat_cols": lambda xs, m: torch.cat(xs, dim=1),
    "concat_rows": lambda xs, m: torch.cat(xs, dim=0),
    "transpose": lambda xs, m: xs[0].T,
    "act_mul": _act_mul,
    "moe_dispatch": _moe_dispatch,
    "moe_combine": _moe_combine,
    "ssm_scan": _ssm_scan,
    "masked_softmax": _masked_softmax,
}


def _as_tensor(x) -> torch.Tensor:
    return x.detach() if isinstance(x, torch.Tensor) else \
        torch.from_numpy(np.asarray(x))


# -------------------------------------------------------------- executor
def execute_plan(plan: P.StreamPlan, tensors: dict, mode: MemoryMode,
                 cache_pages: int = 512, paged: dict = None,
                 device="cuda"):
    """Run a StreamPlan numerically through a mode-aware PageStore on
    ``device``.

    ``tensors`` maps input/weight tensor names to tensors (or numpy
    arrays); returns ``(outputs, store)``, where ``outputs`` maps every
    produced tensor name to its materialized CPU tensor and the store's
    TrafficStats carry the metered host-to-device traffic.

    ``paged`` maps pre-paged pool tensor names (role "P", e.g. a KV
    cache) to ``{page_id: page}``: those pages stream through the
    store under their pool page ids, exactly as the page table names
    them, instead of being re-packed from a dense matrix.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "execute_plan needs exact fp32 tile products: turn TF32 off "
            "(torch.backends.cuda.matmul.allow_tf32 = False)")
    el_dt = _TORCH_DTYPE[plan.dtype]
    integer = not el_dt.is_floating_point
    store = PageStore({}, mode, cache_pages=cache_pages, device=dev)
    paged = paged or {}
    packed: set = set()
    mats: dict = {n: _as_tensor(x).cpu() for n, x in tensors.items()}
    out_bufs: dict = {}            # C-tile assembly buffers (padded)
    acc: dict = {}                 # (c, i, j) -> on-device accumulator
    buf: dict = {}                 # fetched pages awaiting their compute
    produced: set = set()

    def ensure_packed(name: str) -> None:
        if name in packed:
            return
        if name in paged:          # pool tensor: pages come pre-cut
            store.add_pages({(name, int(pid)): _as_tensor(arr)
                             for pid, arr in paged[name].items()})
            packed.add(name)
            return
        spec = plan.tensors[name]
        if "P" in spec.roles:
            # pool page ids come verbatim from a page table; a dense
            # repack would index a different page grid entirely
            raise ValueError(
                f"pool tensor {name!r} must be supplied via `paged=`")
        if {"A", "B"} <= spec.roles:
            raise NotImplementedError(
                f"tensor {name!r} is consumed as both an A and a B "
                "operand; give the B-side consumer its own tensor name")
        role = "A" if "A" in spec.roles else "B"
        lay = paging.layout_for((spec.rows, spec.cols), plan.dtype, role,
                                plan.page_bytes)
        pages = paging.pack_pages(materialize(name).to(el_dt), lay)
        store.add_pages({(name, i): pages[i] for i in range(lay.n_pages)})
        packed.add(name)

    def materialize(name: str) -> torch.Tensor:
        if name not in mats:
            spec = plan.tensors[name]
            mats[name] = out_bufs.pop(name)[:spec.rows, :spec.cols].cpu()
        return mats[name]

    kv_heads: dict = {}            # (q0, heads, group) -> kv head ids

    def kv_page(m, key_pg):
        # GQA: pass g covers q heads [q0, q0 + heads), q head h reading
        # kv head h // group; the page is fetched once per (slot, page)
        # and the LAST pass pops it
        q0, grp = m.get("q0", 0), m.get("group", 1)
        page = buf.pop(key_pg) if m.get("g", 0) == grp - 1 \
            else buf[key_pg]
        hk = (q0, m["heads"], grp)
        if hk not in kv_heads:
            kv_heads[hk] = ((q0 + torch.arange(m["heads"])) // grp).to(dev)
        return page.float()[:, kv_heads[hk], :], q0

    for ev in plan.events:
        if ev.kind is P.EventKind.DMA_IN:
            ensure_packed(ev.page[0])
            buf[ev.page] = store.get(ev.page)
        elif ev.kind is P.EventKind.COMPUTE and ev.unit == "sa":
            m = ev.meta
            if ev.op == "attn_qk":     # q_b x one K page -> score block
                page, q0 = kv_page(m, (m["k"], m["page"]))
                qb = materialize(m["q"])[m["slot"]] \
                    .reshape(m.get("n_q", m["heads"]), m["head_dim"]) \
                    [q0:q0 + m["heads"]].float().to(dev)
                acc[(m["scores"], m.get("g", 0), m["page_idx"])] = \
                    torch.einsum("hd,thd->ht", qb, page)
            elif ev.op == "attn_pv":   # prob block x one V page, accum
                page, q0 = kv_page(m, (m["v"], m["page"]))
                pt = m["pt"]
                pb = materialize(m["p"])[
                    q0:q0 + m["heads"],
                    m["page_idx"] * pt:(m["page_idx"] + 1) * pt
                ].float().to(dev)
                part = torch.einsum("ht,thd->hd", pb, page)
                key = (m["out"], m["slot"], m.get("g", 0))
                acc[key] = part if m["first"] else acc[key] + part
            elif ev.op in ("prefill_qk", "prefill_pv"):
                raise NotImplementedError(
                    "prefill plans are timing-only: chunked prefill "
                    "attention has no functional executor")
            else:                      # gemm: one W×W×depth tile step
                at = buf.pop((m["a"], m["a_page"]))
                bt = buf.pop((m["b"], m["b_page"]))
                key = (m["c"], m["i"], m["j"])
                part = torch.matmul(at.float(), bt.float())
                if integer:            # exact: every sum is below 2**24
                    part = part.round().to(torch.int32)
                acc[key] = part if m["first_k"] else acc[key] + part
        elif ev.kind is P.EventKind.COMPUTE:
            m = ev.meta
            ins = [materialize(n) for n in m["inputs"]]
            res = _HOST_OPS[ev.op](ins, m)
            for name, r in zip(m.get("outs") or (m["out"],),
                               res if "outs" in m else (res,)):
                mats[name] = r
                produced.add(name)
        elif ev.kind is P.EventKind.COLLECTIVE:
            # inter-device exchange hop: timing-only
            continue
        else:                       # DMA_OUT: drain one accumulated tile
            if not isinstance(ev.page[1], tuple):
                raise NotImplementedError(
                    f"DMA_OUT to pool page {ev.page!r} (e.g. a prefill "
                    "kv_write) is timing-only — no functional executor")
            name, (i, j) = ev.page
            spec = plan.tensors[name]
            w = paging.SA_DIM
            if name not in out_bufs:
                gr, gc = -(-spec.rows // w), -(-spec.cols // w)
                out_bufs[name] = torch.zeros((gr * w, gc * w),
                                             dtype=torch.float64,
                                             device=dev)
            tile = acc.pop((name, i, j))
            r0, c0 = ev.meta.get("at", (i * w, j * w))
            out_bufs[name][r0:r0 + tile.shape[0],
                           c0:c0 + tile.shape[1]] = tile
            produced.add(name)
    outputs = {n: materialize(n) for n in produced}
    return outputs, store


def gemm_streamed(a, b, mode: MemoryMode,
                  page_bytes: int = paging.PAGE_BYTES,
                  cache_pages: int = 512, order: str = "jik",
                  device="cuda"):
    """Run Algorithm 1 tile by tile through a mode-aware PageStore, by
    executing the ``StreamPlan`` of ``plan.gemm_plan`` (cache-aware
    ``jik`` order included).

    Returns (result as float64 CPU tensor, PageStore); the store's
    TrafficStats carry the metered host-to-device traffic and cache
    behaviour of the mode.
    """
    a, b = _as_tensor(a), _as_tensor(b)
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"inner dimensions differ: {a.shape} @ {b.shape}")
    plan = P.gemm_plan(M, N, K, a.dtype, page_bytes=page_bytes,
                       order=order)
    outs, store = execute_plan(plan, {"a": a, "b": b}, mode,
                               cache_pages=cache_pages, device=device)
    return outs["c"], store


def tile_counts(M: int, N: int, K: int, dtype,
                page_bytes: int = paging.PAGE_BYTES) -> dict:
    """Closed-form tile/page statistics of the Algorithm-1 walk."""
    la = paging.layout_for((M, K), dtype, "A", page_bytes)
    lb = paging.layout_for((K, N), dtype, "B", page_bytes)
    W, L = la.tile_r, la.tile_c
    out_tiles = (-(-M // W)) * (-(-N // W))
    k_steps = -(-K // L)
    return {
        "w": W, "l": L,
        "out_tiles": out_tiles,
        "k_steps": k_steps,
        "inner_steps": out_tiles * k_steps,
        "a_pages": la.n_pages, "b_pages": lb.n_pages,
        "a_page_loads": out_tiles * k_steps,
        "b_page_loads": out_tiles * k_steps,
        "c_page_stores": out_tiles,
        "macs": M * N * K,
    }
