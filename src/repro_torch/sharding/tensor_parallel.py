"""Tensor parallelism over the mesh's ``model`` axis: the port's
counterpart of what GSPMD inserts where the reference's placements split
a weight over ``model`` (``sharding/logical.py``: ``expert``,
``heads``, ``kv_heads``, ``mlp`` and ``vocab`` go to ``model``).

A layer reads its leaves as this rank's blocks and learns from their
shapes whether they are split (``parallel``): a dim of ``local`` extent
where the model has ``whole`` is this rank's block over ``model`` when
the two differ, and then ``local`` x the model extent must be ``whole``.

- A column-parallel product (q, k, v; the MLP's gate and up or ``wi``;
  the lm_head over its vocabulary block; MLA's ``wuq`` / ``wuk`` /
  ``wuv`` over the rank's heads; the router over its experts' columns;
  the experts' gate and up over their columns) reads its replicated
  input through ``copy_to_model``: the identity forward, the input's
  gradient summed over ``model`` backward (each rank's holds only its
  columns' share).  Given several tensors, ``copy_to_model`` sums all
  their gradients in one all-reduce (MLA's three latents).  A
  replicated value that a rank's share of the work reads only in part
  goes through it too: the MoE's routing weights, of which each rank's
  combine reads its experts' (or scales its partial outputs by them).
- A row-parallel product (attention's ``wo`` over the rank's heads, the
  MLP's ``wo`` over its columns) ends in ``reduce_from_model``: the
  partial outputs summed over ``model`` forward, the identity backward.
  The streaming GEMM hands back its output in bf16, so each partial is
  rounded to bf16 once, then the partials are summed in fp32 and the sum
  rounded to bf16 once (``_sum``): against the whole product rounded
  once, an error of at most one bf16 rounding of each partial.
- ``gather_from_model``: the rank's last-dim blocks of a value that
  everything after it computes alike on every rank (the router's
  logits over the rank's experts, before the softmax), concatenated in
  rank order by one all-gather forward; backward, the rank's slice of
  the gradient, not summed, since every rank's gradient of the whole
  is the same.  ``model_range(n)`` is the rank's ``[start, stop)`` of a
  dim split in blocks of ``n`` (the experts it holds).
- Two compositions of these, which the ssm and hybrid layers use
  (``models.ssm``):

  - the sum-then-slice gather, ``copy_to_model(gather_from_model(y))``:
    forward, the rank's last-dim blocks gathered whole (one all-gather);
    backward, the whole gradient summed over ``model`` (one all-reduce,
    fp32, rounded once) and the rank's slice of it taken, which is a
    reduce-scatter.  It is right where the ranks read *different* parts
    of the gathered value (Mamba2's fused ``in_proj`` output, of which
    each rank takes its heads' channels; ``conv_w``'s taps; RWKV6's
    projections where a column block cuts a head): each rank's gradient
    of the whole is then only its share.  ``gather_from_model`` alone is
    right only where everything after it is computed alike on every
    rank (RWKV6's channel gate, multiplied by a row-parallel output
    already summed; the router's logits).
  - the two-way sum, ``copy_to_model(reduce_from_model(s))``: forward,
    ``s`` summed over ``model``; backward, its gradient summed over
    ``model`` too, since every rank's share of the layer reads the sum
    (Mamba2's gated RMSNorm: each rank's fp32 sum of squares over its
    d_in / m channels, the mean over the whole d_in).  An fp32 ``s``
    stays fp32 both ways (``_sum`` rounds to the input's dtype).

  A whole leaf that a rank reads in part, or whose use feeds a rank's
  share only (Mamba2's ``norm_scale``; its per-head leaves and RWKV6's
  ``u`` / ``w_bias`` where the heads do not divide the extent), passes
  ``copy_to_model`` in the layer: its gradient comes out summed, whole
  on every rank.
- ``embedding``: the rows of the rank's vocabulary block, zero for ids
  outside it, summed over ``model``.
- ``cross_entropy``: the softmax over the vocabulary split in blocks:
  the global max by an all-reduce MAX (no gradient: the log-sum-exp
  does not depend on it), then the sum of exponentials and the gold
  logit by one all-reduce SUM; the padding columns are masked by their
  global index.

Every collective, backward ones too, goes through
``sharding.blocks.all_reduce`` (the gather through
``sharding.blocks.all_gather``), which records it with its group's size
for the cost counter.  Outside a mesh context, or with ``model`` of one
rank, nothing is split and none of these is called.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.sharding import blocks as BL
from repro_torch.sharding import context as C

NEG_INF = -1e30


def model_size() -> int:
    """Ranks of the active ``model`` group (1 without one)."""
    g = C.model_group()
    return 1 if g is None else BL.group_size(g)


def parallel(local: int, whole: int) -> bool:
    """True when a leaf dim of ``local`` extent is this rank's block of
    one of ``whole`` over ``model``; False when it is whole.  Raises
    where ``local`` x the model extent is not ``whole``."""
    if local == whole:
        return False
    m = model_size()
    if m == 1 or local * m != whole:
        raise ValueError(f"a block of {local} of a dim of {whole} over a "
                         f"model extent of {m}")
    return True


def _sum(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """``t`` reduced over the ``model`` group (or ``group``) in fp32 (a
    copy; ``t`` is left as it is), rounded to ``t``'s dtype once."""
    s = t.to(torch.float32, copy=True)
    BL.all_reduce(s, group or C.model_group(), op)
    return s.to(t.dtype)


def model_range(n: int) -> tuple:
    """This rank's ``[start, stop)`` of a dim split over ``model`` in
    blocks of ``n``."""
    i = C.model_index()
    return i * n, (i + 1) * n


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        # the backward pass may run on another thread (a CUDA device's),
        # which does not see the mesh context: keep the group
        ctx.group = C.model_group()
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        """Every gradient summed over ``model`` in one fp32 all-reduce
        (one rounding to each gradient's dtype); a missing one is 0."""
        if len(gs) == 1:
            return (_sum(gs[0], group=ctx.group),)
        flat = torch.cat([g.reshape(-1).float() for g in gs])
        BL.all_reduce(flat, ctx.group)
        out, at = [], 0
        for g in gs:
            out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
            at += g.numel()
        return tuple(out)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _sum(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.range = model_range(x.shape[-1])
        parts = BL.all_gather(x, C.model_group())       # (m, ..., n)
        return parts.movedim(0, -2).flatten(-2)

    @staticmethod
    def backward(ctx, g):
        start, stop = ctx.range
        return g[..., start:stop]


def copy_to_model(*xs: torch.Tensor):
    """The input of a column-parallel product (module docstring); given
    several tensors, a tuple of them, whose gradients are summed in one
    all-reduce."""
    if C.model_group() is not None:
        xs = _Copy.apply(*xs)
    return xs[0] if len(xs) == 1 else tuple(xs)


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    """x (..., n), this rank's block of the last dim, -> (..., n x the
    model extent), every rank's blocks in rank order (module
    docstring)."""
    return _Gather.apply(x) if C.model_group() is not None else x


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The output of a row-parallel product (module docstring)."""
    return _Reduce.apply(x) if C.model_group() is not None else x


def kv_for_heads(k, v, n_q: int, n_heads: int, n_kv: int):
    """k, v (..., KH, D) of every KV head (the K/V leaves are whole: KH
    does not split over ``model``) cut to what this rank's ``n_q`` query
    heads of ``n_heads`` read, head h reading KV head h // (H / KH):
    the KV heads of the rank's range in order where each serves an
    equal run of its query heads (the range starts and ends on group
    boundaries, or lies in one group), else one KV head per query head.
    The KV leaves' gradients are then each rank's share, summed over
    ``model`` by the step."""
    group = n_heads // n_kv
    heads = range(C.model_index() * n_q, (C.model_index() + 1) * n_q)
    first, last = heads[0] // group, heads[-1] // group
    if first == last or (heads[0] % group == 0 and n_q % group == 0):
        idx = list(range(first, last + 1))
    else:
        idx = [h // group for h in heads]
    if idx == list(range(n_kv)):
        return k, v
    idx = torch.tensor(idx, device=k.device)
    return k.index_select(-2, idx), v.index_select(-2, idx)


def embedding(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``tokens`` from the vocabulary split over ``model``:
    ``table`` is this rank's block of rows, in bf16 (module
    docstring)."""
    n = table.shape[0]
    local = tokens.long() - C.model_index() * n
    outside = (local < 0) | (local >= n)
    rows = table[local.clamp(0, n - 1)].to(torch.bfloat16)
    return reduce_from_model(rows.masked_fill(outside[..., None], 0))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int):
    """(log-sum-exp, gold logit), each (n,) fp32, of fp32 ``logits`` (n,
    this rank's vocabulary block) against ``labels`` (n,) (any id; an
    ignored one's gold is 0), the columns at or past ``vocab_size``
    (global index) masked out (module docstring)."""
    n_local = logits.shape[1]
    first = C.model_index() * n_local
    cols = torch.arange(first, first + n_local, device=logits.device)
    if first + n_local > vocab_size:
        logits = logits.masked_fill(cols >= vocab_size, NEG_INF)
    top = _sum(logits.detach().amax(-1), dist.ReduceOp.MAX)
    local = labels.long() - first
    inside = (local >= 0) & (local < n_local)
    gold = logits.gather(-1, local.clamp(0, n_local - 1)[:, None])[:, 0]
    parts = torch.stack([torch.exp(logits - top[:, None]).sum(-1),
                         torch.where(inside, gold, torch.zeros_like(gold))],
                        dim=-1)
    parts = reduce_from_model(parts)
    return torch.log(parts[:, 0]) + top, parts[:, 1]
