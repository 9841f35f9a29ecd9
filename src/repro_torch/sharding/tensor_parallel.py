"""Tensor parallelism over the mesh's ``model`` axis: the port's
counterpart of what GSPMD inserts where the reference's placements split
a weight over ``model`` (``sharding/logical.py``: ``heads``,
``kv_heads``, ``mlp`` and ``vocab`` go to ``model``).

A layer reads its leaves as this rank's blocks and learns from their
shapes whether they are split (``parallel``): a dim of ``local`` extent
where the model has ``whole`` is this rank's block over ``model`` when
the two differ, and then ``local`` x the model extent must be ``whole``.

- A column-parallel product (q, k, v; the MLP's gate and up or ``wi``;
  the lm_head over its vocabulary block) reads its replicated input
  through ``copy_to_model``: the identity forward, the input's gradient
  summed over ``model`` backward (each rank's holds only its columns'
  share).
- A row-parallel product (attention's ``wo`` over the rank's heads, the
  MLP's ``wo`` over its columns) ends in ``reduce_from_model``: the
  partial outputs summed over ``model`` forward, the identity backward.
  The streaming GEMM hands back its output in bf16, so each partial is
  rounded to bf16 once, then the partials are summed in fp32 and the sum
  rounded to bf16 once (``_sum``): against the whole product rounded
  once, an error of at most one bf16 rounding of each partial.
- ``embedding``: the rows of the rank's vocabulary block, zero for ids
  outside it, summed over ``model``.
- ``cross_entropy``: the softmax over the vocabulary split in blocks:
  the global max by an all-reduce MAX (no gradient: the log-sum-exp
  does not depend on it), then the sum of exponentials and the gold
  logit by one all-reduce SUM; the padding columns are masked by their
  global index.

Every collective, backward ones too, goes through
``sharding.blocks.all_reduce``, which records it with its group's size
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


def _sum(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the ``model`` group in fp32 (a copy; ``t`` is
    left as it is), rounded to ``t``'s dtype once."""
    s = t.to(torch.float32, copy=True)
    BL.all_reduce(s, C.model_group(), op)
    return s.to(t.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _sum(x)

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product (module docstring)."""
    return _Copy.apply(x) if C.model_group() is not None else x


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
