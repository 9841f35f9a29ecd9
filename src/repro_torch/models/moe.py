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
  the port writes the kept rows only and then zeroes that cell when
  expert E-1 overflowed, which is the same result without a scatter of
  duplicate indices (whose order CUDA does not fix).
- The combine adds each token's k contributions in bf16 one by one, in
  the order of their expert ids, as the reference's scatter-add does,
  without atomics.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import tuning as TU
from repro_torch.models.params import PSpec


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
    softmax, as the reference's ``(x @ router).astype(f32)``."""
    m = cfg.moe
    E, k = m.n_routed_experts, m.top_k
    probs = torch.softmax(L._gemm(x, p["router"]).float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # load-balancing aux loss (Switch-style)
    me = probs.reshape(-1, E).mean(0)
    ce = _count(top_e, E, torch.float32) / top_e.numel()
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
    m = cfg.moe
    B, T, d = x.shape
    E, k = m.n_routed_experts, m.top_k
    n = B * T
    xt = x.reshape(n, d)
    dev = x.device

    top_p, top_e, aux = _route(p, xt, cfg)
    flat_e = top_e.reshape(-1)                                # (n*k,)
    flat_p = top_p.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok_sorted = order // k                                   # token ids
    counts = _count(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(n * k, device=dev) - starts[e_sorted]
    C = routed_capacity(n * k, E, capacity, capacity_factor)
    keep = pos_in_e < C

    # dispatch: (E, C, d); only kept rows are written
    buf = torch.zeros((E, C, d), dtype=x.dtype, device=dev)
    if C >= n:          # no expert can overflow (a token picks it once)
        buf[e_sorted, pos_in_e] = xt[tok_sorted]
    else:
        buf[e_sorted[keep], pos_in_e[keep]] = xt[tok_sorted[keep]]
        # the reference's dropped zeros land on (E-1, C-1) last
        buf[E - 1, C - 1] = torch.where(counts[E - 1] > C, 0.0,
                                        buf[E - 1, C - 1])
    kept = torch.clamp(counts, max=C).to(torch.int32)
    y_e = _experts(p, buf, kept, cfg)                         # (E, C, d)

    # combine: gather expert outputs back to token order, weight by probs
    gathered = y_e[e_sorted, torch.clamp(pos_in_e, max=C - 1)]
    gathered = torch.where(keep[:, None], gathered, 0.0)
    contrib = gathered * flat_p[order][:, None].to(gathered.dtype)
    y = _combine(contrib, order, n, k)

    if m.n_shared_experts:
        y = y + _shared(p, xt, cfg)
    return y.reshape(B, T, d).to(x.dtype), aux


def _apply_moe_local(p, x, cfg: ModelConfig, capacity_factor: float,
                     capacity):
    """Row-local dispatch: tokens compete for capacity within their own
    batch row (the reference's collective-free variant).  The (B, E, C,
    d) buffer is held expert-major as (E, B·C, d), so each expert's rows
    of all batch rows are one grouped-GEMM operand; its row count is the
    end of its last non-empty batch row (rows between are zeros)."""
    m = cfg.moe
    B, T, d = x.shape
    E, k = m.n_routed_experts, m.top_k
    dev = x.device

    top_p, top_e, aux = _route(p, x, cfg)                    # (B, T, k)
    nk = T * k
    flat_e = top_e.reshape(B, nk)
    flat_p = top_p.reshape(B, nk)
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

    bidx = torch.arange(B, device=dev)[:, None].expand(B, nk)
    x_sorted = x[bidx, tok_sorted]                            # (B, nk, d)
    buf = torch.zeros((E, B, C, d), dtype=x.dtype, device=dev)
    buf[e_sorted[keep], bidx[keep], pos_in_e[keep]] = x_sorted[keep]
    if C < T:           # the reference's dropped zeros land on each
        # row's (E-1, C-1) cell after its kept row there
        over = counts[:, E - 1] > C                           # (B,)
        buf[E - 1, :, C - 1] = torch.where(over[:, None], 0.0,
                                           buf[E - 1, :, C - 1])
    kept_row = torch.clamp(counts, max=C)                     # (B, E)
    ends = (torch.arange(B, device=dev)[:, None] * C + kept_row) \
        * (kept_row > 0)
    kept = ends.amax(0).to(torch.int32)                       # (E,)
    y_e = _experts(p, buf.view(E, B * C, d), kept, cfg).view(E, B, C, d)

    gathered = y_e[e_sorted, bidx, torch.clamp(pos_in_e, max=C - 1)]
    gathered = torch.where(keep[..., None], gathered, 0.0)   # (B, nk, d)
    contrib = gathered * torch.gather(flat_p, -1, order)[..., None] \
        .to(gathered.dtype)
    flat_order = (order + torch.arange(B, device=dev)[:, None] * nk)
    y = _combine(contrib.reshape(B * nk, d), flat_order.reshape(-1),
                 B * T, k).reshape(B, T, d)

    if m.n_shared_experts:
        y = y + _shared(p, x, cfg)
    return y.to(x.dtype), aux
