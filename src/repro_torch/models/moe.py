"""Mixture-of-Experts FFN with sort-based grouped-GEMM dispatch, as in
the reference:

  1. router softmax -> top-k (probs, expert ids)
  2. stable argsort of the flat assignments groups tokens by expert
  3. scatter into an (E, C, d) buffer (capacity C, overflow dropped)
  4. one grouped GEMM per FFN product over the stacked expert weights
  5. gather back and combine with the routing probabilities

The three expert products go through ``ops.grouped_streaming_gemm``:
one launch for all experts, reading the (E, d, f) weights in place, with
each expert's kept row count (``min(count, C)``, on the device) so that
the kernel skips the rows, and the experts, that no token reached.  On
the card the rows at or beyond the count are left unwritten, so every
step after the GEMMs selects them away (``torch.where``) and never
scales them.  The router and the shared experts go through
``ops.streaming_gemm``.

JAX semantics the port keeps by hand:

- ``jax.lax.top_k`` puts the lower expert index first among equal
  probabilities; the port takes the top k of a stable descending sort.
- The reference scatters every dropped assignment as zeros into cell
  (E-1, C-1) in sorted order, after expert E-1's own kept row there;
  the port writes the kept rows into the buffer and the dropped ones
  into one spare row after it (sliced away, never read: no scatter of
  duplicate indices into a cell that is read, whose order CUDA does not
  fix) and then zeroes that cell when expert E-1 overflowed, which is
  the same result.  The dispatch needs no value on the host (no
  boolean-mask index, which ``nonzero`` would need), so it also runs on
  ``meta`` tensors.
- The combine adds each token's k contributions in bf16 one by one, in
  the order of their expert ids, as the reference's scatter-add does,
  without atomics.

Training differentiates the same code: the router's softmax, the top-k
(a sort's values), the renormalisation, the aux loss's ``me`` term, the
dispatch (an ``index_put`` whose backward reads the kept rows only),
the three grouped products (``ops._GroupedGemm``, whose backward
kernels read and sum only the kept rows), the SiLU and the combine.
The rows at or beyond a count, which hold whatever the memory held on
the card, pass through elementwise ops (``_act``, ``gate·up``) in both
directions but never into a kept value or a weight gradient.  The
zeroed (E-1, C-1) cell passes no gradient to the row it replaced, as
the reference's ``mode="drop"`` scatter (whose last write wins) does.

On a mesh whose train step splits the batch rows over ranks
(``sharding.context.batch_group``), each rank holds only its rows: the
row-local dispatch (``Tuning.moe_local_dispatch``) is the one that runs
there, since a row's capacity and drops do not depend on other rows.
Global dispatch sizes its capacity and drop order over all B·T tokens,
which no rank holds, and raises.  The load-balancing loss takes its
``me`` and ``ce`` means over the whole batch: the rank's sums are
all-reduced over the batch ranks, and the gradient of ``me`` reaches
the rank's own router probabilities.

Under a train step that splits the layer's leaves over ``model``
(``launch.steps``; ``sharding.tensor_parallel``), the leaves' shapes
give one of two forms, as the reference's placements (``expert``
outranks ``mlp`` for ``model``):

- **Expert split** (``wi_gate`` holds E / m of the E experts: rank r
  those of ``model_range``).  The router holds their E / m columns and
  reads the input through ``copy_to_model``; its logits are gathered
  whole (``gather_from_model``) before the softmax, so the top-k, the
  aux loss, the sort, the capacity and the drops are those of one rank
  on every rank.  Each rank builds only its experts' rows of the
  buffer (the assignments to other experts go to the spare row, as the
  dropped ones do), the (E-1, C-1) cell zeroed by the rank that holds
  expert E-1, and runs the three grouped GEMMs over its experts; the
  combine sums each token's contributions from them (zeros for the
  experts held elsewhere).
- **Column split** (every expert, its ``d_ff_expert`` / m columns of
  the rank: E does not divide over ``model``).  The router is whole and
  reads the input itself, not through ``copy_to_model``, since its
  gradient of the input is then whole on every rank; the gate and up
  products are column-parallel and ``wo`` row-parallel inside the
  grouped GEMM.

The shared experts split by columns, as the dense MLP.  The experts'
and the shared experts' input goes through one ``copy_to_model``, and
their partial outputs are added in fp32 and summed by one
``reduce_from_model``: one all-reduce forward and one backward a layer
for the input, plus, in the expert split, the logits' all-gather.  The
routing weights enter the combine through ``copy_to_model``, since a
rank's combine reads only its experts' weights (expert split) or
scales its partial outputs by them (column split): one more all-reduce
backward, of B·T·k fp32 values.  With these, every rank's gradient of
whatever is whole (the router in the column split, the norms) is the
whole one.

Rounding: a token's contributions are summed in bf16 over the rank's
experts only, and the ranks' partials in fp32, rounded once, where one
rank sums all k in bf16; in the column split each expert's output is
also a sum of bf16-rounded partials.  Against one rank that moves a
layer's output by about one bf16 rounding, and a route whose top-k is a
near tie can change with it: the CPU tests hold a split run's losses
within 1e-3 relative of one rank's every step and its gradients within
5e-2 relative L2 (``tests/test_torch_tensor_parallel_moe.py``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import tuning as TU
from repro_torch.models.params import PSpec
from repro_torch.sharding import blocks as BL
from repro_torch.sharding import context as SC
from repro_torch.sharding import tensor_parallel as TP


def routed_capacity(n_assignments: int, n_experts: int,
                    capacity: int | None,
                    capacity_factor: float = 1.25,
                    multiple: int = 8) -> int:
    """Per-expert buffer capacity C for ``n_assignments`` (= tokens x
    top_k) routed slots: capacity-factor sized (or explicit), rounded up
    to ``multiple`` and clamped to the assignment count.  The plan IR
    sizes each expert's routed buffer with it too
    (``core.plan.moe_layer_plan``)."""
    C = capacity if capacity is not None else \
        max(int(n_assignments / n_experts * capacity_factor), multiple)
    return min(-(-C // multiple) * multiple, n_assignments)


def moe_pspecs(cfg: ModelConfig):
    m, d, f = cfg.moe, cfg.d_model, cfg.moe.d_ff_expert
    E = m.n_routed_experts
    p = {
        "router": PSpec((d, E), ("embed", "expert"), scale=d ** -0.5),
        "wi_gate": PSpec((E, d, f), ("expert", "embed", "mlp")),
        "wi_up": PSpec((E, d, f), ("expert", "embed", "mlp")),
        "wo": PSpec((E, f, d), ("expert", "mlp", "embed")),
    }
    if m.n_shared_experts:
        fs = f * m.n_shared_experts
        p["shared_wi_gate"] = PSpec((d, fs), ("embed", "mlp"))
        p["shared_wi_up"] = PSpec((d, fs), ("embed", "mlp"))
        p["shared_wo"] = PSpec((fs, d), ("mlp", "embed"))
    return p


def _count(idx, n: int, dtype=torch.int64):
    """Occurrences of each value in [0, n) among ``idx``: a scatter-add,
    exact in either dtype, which unlike ``torch.bincount`` on a CUDA
    tensor does not wait for the card to learn the largest value."""
    flat = idx.reshape(-1)
    return torch.zeros(n, dtype=dtype, device=idx.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=dtype))


def _route(p, x, cfg: ModelConfig):
    """x (..., d) -> (top_p (..., k) fp32, top_e (..., k) int64, aux
    loss).  Logits are rounded to the activation dtype before the fp32
    softmax, as the reference's ``(x @ router).astype(f32)``; a router
    of the rank's experts' columns makes theirs, gathered whole over
    ``model`` (module docstring)."""
    m = cfg.moe
    E, k = m.n_routed_experts, m.top_k
    logits = L._gemm(x, p["router"])
    if TP.parallel(p["router"].shape[1], E):
        logits = TP.gather_from_model(logits)
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # load-balancing aux loss (Switch-style)
    group = SC.batch_group()
    if group is None:
        me = probs.reshape(-1, E).mean(0)
        ce = _count(top_e, E, torch.float32) / top_e.numel()
    else:       # means over the whole batch (module docstring)
        flat = probs.reshape(-1, E)
        local = flat.sum(0)
        stats = torch.cat([local.detach(), _count(top_e, E, torch.float32),
                           local.new_tensor([flat.shape[0]])])
        BL.all_reduce(stats, group)
        n = stats[-1]
        me = (stats[:E] + (local - local.detach())) / n
        ce = stats[E:2 * E] / (n * k)
    aux = E * torch.sum(me * ce) * m.router_aux_coef
    return top_p, top_e, aux


def _act(x, cfg: ModelConfig):
    """SiLU as the reference's ``jax.nn.silu`` computes it called
    eagerly, op by op (``x * (1 / (1 + exp(-x)))``, each op rounded in
    bf16): each MoE layer is bitwise the reference's on equal inputs.
    The dense path keeps ``F.silu``, which rounds once; with it here,
    ``chip_smoke.py``'s card-against-CPU check on an H100 found the two
    routing alike on 0.963 of the expert sets, under its 0.97 floor
    (0.985 with this SiLU)."""
    if cfg.act != "silu":
        return L.apply_act(x, cfg)
    return x * L.sigmoid_op_by_op(x)


def _experts(p, buf, kept, cfg: ModelConfig):
    """The routed FFN over the (E, R, d) buffer, rows below ``kept`` (E,)
    int32 valid: three grouped GEMMs, one launch each."""
    h = _act(ops.grouped_streaming_gemm(buf, p["wi_gate"], kept), cfg) \
        * ops.grouped_streaming_gemm(buf, p["wi_up"], kept)
    return ops.grouped_streaming_gemm(h, p["wo"], kept)


def _shared(p, x, cfg: ModelConfig):
    h = _act(L._gemm(x, p["shared_wi_gate"]), cfg) \
        * L._gemm(x, p["shared_wi_up"])
    return L._gemm(h, p["shared_wo"])


class _Split:
    """How ``model`` splits an MoE layer's leaves (module docstring):
    ``experts`` and ``shared`` tell whether the routed and the shared
    experts are split; ``lo`` / ``hi`` bound the experts the rank holds
    (all of them unless the split is by expert)."""

    def __init__(self, p, cfg: ModelConfig):
        m = cfg.moe
        E, f = m.n_routed_experts, m.d_ff_expert
        by_expert = TP.parallel(p["wi_gate"].shape[0], E)
        self.experts = by_expert or TP.parallel(p["wi_gate"].shape[2], f)
        self.lo, self.hi = TP.model_range(p["wi_gate"].shape[0]) \
            if by_expert else (0, E)
        self.shared = bool(m.n_shared_experts) and TP.parallel(
            p["shared_wo"].shape[0], f * m.n_shared_experts)
        self.by_expert = by_expert

    def inputs(self, x):
        """(the router's input, the routed experts', the shared
        experts'): x, or x through one ``copy_to_model`` where the work
        that reads it is split."""
        xc = TP.copy_to_model(x) if self.experts or self.shared else x
        return (xc if self.by_expert else x,
                xc if self.experts else x, xc if self.shared else x)

    def weights(self, top_p):
        """The routing weights as the combine reads them."""
        return TP.copy_to_model(top_p) if self.experts else top_p

    def output(self, p, y, xs, cfg: ModelConfig, dtype):
        """The layer's output from the routed experts' ``y`` and the
        shared experts over ``xs``: the split partials added in fp32 and
        summed over ``model`` in one all-reduce, rounded to ``dtype``
        once."""
        s = _shared(p, xs, cfg) if cfg.moe.n_shared_experts else None
        if not (self.experts or self.shared):
            return (y if s is None else y + s).to(dtype)
        part = y.float() if self.experts else None
        if self.shared:
            part = s.float() if part is None else part + s.float()
        out = TP.reduce_from_model(part).to(dtype)
        if not self.experts:
            out = out + y.to(dtype)
        elif s is not None and not self.shared:
            out = out + s
        return out


def _combine(contrib, order, n: int, k: int):
    """Sum each token's k contributions (rows of ``contrib``, in sorted
    order ``order``) in the activation dtype, one add at a time in the
    order of the token's expert ids: the reference's sequential
    scatter-add, without atomics."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    rows = contrib[inv.view(n, k).sort(dim=1).values]      # (n, k, d)
    y = rows[:, 0]
    for j in range(1, k):
        y = y + rows[:, j]
    return y


def apply_moe(p, x, cfg: ModelConfig, capacity_factor: float = 1.25,
              capacity: int | None = None):
    """x: (B, T, d) -> (y: (B, T, d), aux_loss: scalar).

    ``capacity`` overrides the capacity-factor sizing; pass ``capacity=n``
    (token count) for lossless routing.  Global dispatch (one sort over
    all B*T tokens) unless ``Tuning.moe_local_dispatch`` picks the
    row-local one for T > 1, as in the reference."""
    if TU.get().moe_local_dispatch and x.shape[1] > 1:
        return _apply_moe_local(p, x, cfg, capacity_factor, capacity)
    if SC.batch_group() is not None:
        raise ValueError(
            f"{cfg.name}: global MoE dispatch sizes capacity and drops over "
            "all B*T tokens, and this rank holds only its rows of the "
            "batch: train on a batch split with moe_local_dispatch=True")
    m = cfg.moe
    B, T, d = x.shape
    E, k = m.n_routed_experts, m.top_k
    n = B * T
    dev = x.device
    sp = _Split(p, cfg)
    lo, hi = sp.lo, sp.hi
    El = hi - lo
    x_router, xt, xs = (t.reshape(n, d) for t in sp.inputs(x))

    top_p, top_e, aux = _route(p, x_router, cfg)
    flat_e = top_e.reshape(-1)                                # (n*k,)
    flat_p = sp.weights(top_p).reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok_sorted = order // k                                   # token ids
    counts = _count(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(n * k, device=dev) - starts[e_sorted]
    C = routed_capacity(n * k, E, capacity, capacity_factor)
    keep = pos_in_e < C
    if El < E:          # the rank's experts only
        keep = keep & (e_sorted >= lo) & (e_sorted < hi)

    # dispatch: (El, C, d), the dropped rows (and those of experts held
    # elsewhere) to the spare row El·C
    flat = torch.zeros((El * C + 1, d), dtype=x.dtype, device=dev)
    flat[torch.where(keep, (e_sorted - lo) * C + pos_in_e, El * C)] = \
        xt[tok_sorted]
    buf = flat[:El * C].view(El, C, d)
    if C < n and hi == E:   # else no expert can overflow (a token picks
        # it once), or the rank does not hold expert E-1; the reference's
        # dropped zeros land on (E-1, C-1) last
        buf[El - 1, C - 1] = torch.where(counts[E - 1] > C, 0.0,
                                         buf[El - 1, C - 1])
    kept = torch.clamp(counts[lo:hi], max=C).to(torch.int32)
    y_e = _experts(p, buf, kept, cfg)                         # (El, C, d)

    # combine: gather expert outputs back to token order, weight by probs
    gathered = y_e[torch.clamp(e_sorted - lo, 0, El - 1),
                   torch.clamp(pos_in_e, max=C - 1)]
    gathered = torch.where(keep[:, None], gathered, 0.0)
    contrib = gathered * flat_p[order][:, None].to(gathered.dtype)
    y = _combine(contrib, order, n, k)
    return sp.output(p, y, xs, cfg, x.dtype).reshape(B, T, d), aux


def _apply_moe_local(p, x, cfg: ModelConfig, capacity_factor: float,
                     capacity):
    """Row-local dispatch: tokens compete for capacity within their own
    batch row (the reference's collective-free variant, and the dispatch
    a batch split over ranks runs: module docstring).  The (B, E, C,
    d) buffer is held expert-major as (E, B·C, d), so each expert's rows
    of all batch rows are one grouped-GEMM operand; its row count is the
    end of its last non-empty batch row (rows between are zeros)."""
    m = cfg.moe
    B, T, d = x.shape
    E, k = m.n_routed_experts, m.top_k
    dev = x.device
    sp = _Split(p, cfg)
    lo, hi = sp.lo, sp.hi
    El = hi - lo
    x_router, x, xs = sp.inputs(x)

    top_p, top_e, aux = _route(p, x_router, cfg)             # (B, T, k)
    nk = T * k
    flat_e = top_e.reshape(B, nk)
    flat_p = sp.weights(top_p).reshape(B, nk)
    order = torch.argsort(flat_e, dim=-1, stable=True)        # (B, nk)
    e_sorted = torch.gather(flat_e, -1, order)
    tok_sorted = order // k
    counts = torch.zeros((B, E), dtype=torch.int64, device=dev) \
        .scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, -1) - counts                # (B, E)
    pos_in_e = torch.arange(nk, device=dev)[None] \
        - torch.gather(starts, -1, e_sorted)
    C = routed_capacity(nk, E, capacity, capacity_factor, multiple=4)
    keep = pos_in_e < C
    if El < E:          # the rank's experts only
        keep = keep & (e_sorted >= lo) & (e_sorted < hi)

    bidx = torch.arange(B, device=dev)[:, None].expand(B, nk)
    x_sorted = x[bidx, tok_sorted]                            # (B, nk, d)
    # the dropped rows (and those of experts held elsewhere) to the
    # spare row El·B·C
    flat = torch.zeros((El * B * C + 1, d), dtype=x.dtype, device=dev)
    flat[torch.where(keep, ((e_sorted - lo) * B + bidx) * C + pos_in_e,
                     El * B * C)] = x_sorted
    buf = flat[:El * B * C].view(El, B, C, d)
    if C < T and hi == E:   # the reference's dropped zeros land on each
        # row's (E-1, C-1) cell after its kept row there
        over = counts[:, E - 1] > C                           # (B,)
        buf[El - 1, :, C - 1] = torch.where(over[:, None], 0.0,
                                            buf[El - 1, :, C - 1])
    kept_row = torch.clamp(counts[:, lo:hi], max=C)           # (B, El)
    ends = (torch.arange(B, device=dev)[:, None] * C + kept_row) \
        * (kept_row > 0)
    kept = ends.amax(0).to(torch.int32)                       # (El,)
    y_e = _experts(p, buf.view(El, B * C, d), kept, cfg).view(El, B, C, d)

    gathered = y_e[torch.clamp(e_sorted - lo, 0, El - 1), bidx,
                   torch.clamp(pos_in_e, max=C - 1)]
    gathered = torch.where(keep[..., None], gathered, 0.0)   # (B, nk, d)
    contrib = gathered * torch.gather(flat_p, -1, order)[..., None] \
        .to(gathered.dtype)
    flat_order = (order + torch.arange(B, device=dev)[:, None] * nk)
    y = _combine(contrib.reshape(B * nk, d), flat_order.reshape(-1),
                 B * T, k).reshape(B, T, d)
    return sp.output(p, y, xs, cfg, x.dtype), aux
