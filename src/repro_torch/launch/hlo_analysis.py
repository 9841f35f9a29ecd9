"""The cost counter: one count of a step's work, the same whether the
step runs on the card, on the CPU or on ``meta`` tensors.

The reference's module walks the HLO text of a compiled step and
multiplies loop bodies by their trip counts.  An eager torch step has no
HLO and no loop to multiply: it dispatches every op it runs, each trip
of a Python loop again.  So ``analyze(fn, *args, **kwargs)`` runs
``fn`` under a ``TorchDispatchMode`` (active through the backward pass
that ``fn`` runs, on the calling thread) and counts what is dispatched.

Operation costs follow the reference's conventions:

- a product (``mm``, ``addmm``, ``bmm``, ``baddbmm``) counts 2 x
  |result| x K flops;
- an elementwise op or a reduction counts |result| flops (a reduction
  to one value counts one, as the reference counts an HLO ``reduce``);
- the reference's ``ZERO_FLOP`` ops (a copy or cast, a concatenation, a
  pad, a flip, a ``where`` / ``masked_fill``, a gather) count no flops;
  a sort counts n log2 n;
- views, ``empty`` and other metadata ops count nothing at all.

Bytes differ from the reference on purpose.  The reference counts no
bytes for an elementwise op, because XLA fuses it into its neighbours on
the TPU.  The port runs every op as a kernel of its own, so every op
that is not a view counts |result| + sum of |operands|: that unfused
traffic is what the port's decode profiles show as "other torch ops".
As in the reference, a gather counts the slices it moves (2 x |result|),
a scatter its updates twice and its indices once, and a copy into a
tensor its source and its destination once each; a factory that writes
values (``zeros``, ``full``, ``arange``) counts its result.  A copy
between devices (a host tensor moved to the card: a cache's page rows)
counts nothing: it is no device op, and on the CPU no copy at all.

Each kernel wrapper of ``kernels/ops.py`` is one op of the count: it
records its own flops and bytes, from its operands' shapes only, where
it would launch its kernel on the card (``kernel``), and the ops it
dispatches inside (the plain version on the CPU, the allocations of a
``meta`` dry run) are not counted (``quiet``); so is every op inside an
autograd Function's backward, whose products record themselves.  On the
card the wrapper calls a ctypes kernel that the dispatcher never sees;
with this rule a step counts the same on the card, the CPU and
``meta``, and each wrapper's op count equals its ``LAUNCHES``
increment.  The kernels' work:

- the streaming GEMM (and each backward product): 2·M·N·K flops; A, B
  and C once;
- flash attention: 2·B·H·(D + Dv)·pairs flops, pairs = Tq·Tk, or the
  query-key pairs the causal mask keeps; q, k, v and the output once;
- paged attention (bf16 and int8 pools) and the latent form: at the
  table's capacity, n_tok = B x max_pages x page tokens, 4·H·D·n_tok
  flops (latent: 2·H·(D + dv)·n_tok), each pool's n_tok rows (and an
  int8 pool's scales) once, q, the table, the lengths and the output
  once; the decode step's int8 append adds its rows read and written;
- the grouped GEMM and its two backward products: at capacity,
  2·E·C·K·N flops, whole operands and output;
- the quantize-and-append: |k| + |v| flops, k and v read, codes and
  scales written.

``chip_smoke.py`` phase 2 bounds its kernels by the live tokens of a
table and the kept rows of the grouped GEMM, so its bounds are lower
than these counts; a shape-only count is what the reference's static HLO
counts are too.

Collectives record themselves (``collective``) where the port makes
them (``sharding.blocks.all_reduce`` / ``all_gather`` / ``gather``):
the result's bytes, the group's size and the reference's ring model
(``ring_bytes``).  A collective over one rank makes no call and records
nothing.

Memory: the bytes of live storages.  The arguments' storages are live
from the start; each storage an op makes is counted once when it
appears (views share it) and subtracted when it is freed (a
``weakref.finalize`` on ``untyped_storage()``).  The highest total is
``peak_bytes``, the torch analogue of ``memory_analysis()``'s arguments
+ temporaries.  Allocations inside a wrapper count here: a ``meta``
wrapper makes those of the card's launcher and no other, so ``meta``
and the card agree where the CPU's plain versions do not.

Counting adds Python work to every op: never time a step under it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the count ``analyze`` runs, or None
_ACTIVE = None
# what ``quiet`` gives outside a count: nothing to enter or leave
NULL = contextlib.nullcontext()

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")

_MATMUL = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}   # A's position
# views and metadata: nothing at all
_NOTHING = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "_local_scalar_dense", "lift_fresh",
            "detach", "alias", "_unsafe_view", "_reshape_alias",
            "resize_", "set_", "sym_size", "sym_stride", "sym_numel",
            "record_stream"}
# the reference's ZERO_FLOP ops (copies, casts, layout, select)
_ZERO_FLOP = {"_to_copy", "clone", "contiguous", "cat", "stack",
              "constant_pad_nd", "flip", "roll", "where", "masked_fill",
              "masked_fill_", "expand_copy", "permute_copy",
              "slice_scatter", "select_scatter", "repeat", "tril", "triu"}
_GATHERS = {"index", "index_select", "gather", "embedding", "take"}
# scatters: the position of their updates
_SCATTERS = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
             "scatter": 3, "scatter_": 3, "scatter_add": 3,
             "scatter_add_": 3, "index_add": 3, "index_add_": 3,
             "index_copy": 3, "index_copy_": 3}
# factories that write values
_FILLS = {"zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
          "new_zeros", "new_ones", "new_full", "arange", "scalar_tensor",
          "fill_", "zero_", "linspace"}
_SORTS = {"sort", "argsort"}


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0        # raw per-device payload
    coll_effective: float = 0.0    # ring-model wire bytes
    coll_by_op: dict = dataclasses.field(default_factory=dict)
    coll_count: int = 0
    peak_bytes: float = 0.0        # live storages' peak (module docstring)
    # wrapper ops by their ``ops.LAUNCHES`` counter
    kernel_ops: dict = dataclasses.field(default_factory=dict)

    def __iadd__(self, o: "Costs"):
        self.flops += o.flops
        self.bytes += o.bytes
        self.coll_bytes += o.coll_bytes
        self.coll_effective += o.coll_effective
        for k, v in o.coll_by_op.items():
            self.coll_by_op[k] = self.coll_by_op.get(k, 0.0) + v
        self.coll_count += o.coll_count
        self.peak_bytes = max(self.peak_bytes, o.peak_bytes)
        for k, v in o.kernel_ops.items():
            self.kernel_ops[k] = self.kernel_ops.get(k, 0) + v
        return self

    def scaled(self, k: float) -> "Costs":
        """``k`` runs in turn: every count times ``k``, the peak as it
        is."""
        return Costs(self.flops * k, self.bytes * k, self.coll_bytes * k,
                     self.coll_effective * k,
                     {a: b * k for a, b in self.coll_by_op.items()},
                     int(self.coll_count * k), self.peak_bytes,
                     {a: int(b * k) for a, b in self.kernel_ops.items()})


def ring_bytes(op: str, nbytes: float, group_size: int) -> float:
    """The wire bytes a rank moves for collective ``op`` whose result is
    ``nbytes`` over ``group_size`` ranks: the reference's ring model
    (``hlo_analysis.py:218-231``)."""
    g = group_size
    ring = (g - 1) / g if g > 1 else 0.0
    if op == "all-reduce":
        return 2 * nbytes * ring          # reduce-scatter + all-gather
    if op == "reduce-scatter":
        return nbytes * g * ring          # operand = result x g
    if op == "collective-permute":
        return float(nbytes)
    return nbytes * ring                  # all-gather, all-to-all


# ------------------------------------------------------------ the hooks
def counting() -> bool:
    return _ACTIVE is not None


def kernel(name: str, flops: float, nbytes: float) -> None:
    """One launch of the kernel counted as ``ops.LAUNCHES[name]``."""
    c = _ACTIVE
    if c is None:
        return
    c.costs.flops += flops
    c.costs.bytes += nbytes
    c.costs.kernel_ops[name] = c.costs.kernel_ops.get(name, 0) + 1


def quiet():
    """A context in which the ops dispatched are not counted (their
    allocations still are); ``NULL`` outside a count, so that a wrapper
    call pays next to nothing for it."""
    return NULL if _ACTIVE is None else _ACTIVE.hush()


def collective(op: str, nbytes: float, group_size: int) -> None:
    """One collective ``op`` of ``nbytes`` result bytes over
    ``group_size`` ranks (none over one rank)."""
    c = _ACTIVE
    if c is None or group_size <= 1:
        return
    if op not in COLLECTIVE_OPS:
        raise ValueError(f"collective {op!r} not in {COLLECTIVE_OPS}")
    c.costs.coll_bytes += nbytes
    c.costs.coll_effective += ring_bytes(op, nbytes, group_size)
    c.costs.coll_by_op[op] = c.costs.coll_by_op.get(op, 0.0) + nbytes
    c.costs.coll_count += 1


# ---------------------------------------------------- the kernels' work
def _nb(t) -> int:
    return t.numel() * t.element_size()


def gemm_cost(a, b) -> tuple:
    """(flops, bytes) of C = A·B, a (M, K), b (K, N), C in a's dtype."""
    M, K = a.shape
    N = b.shape[1]
    return 2 * M * N * K, _nb(a) + _nb(b) + M * N * a.element_size()


def causal_pairs(Tq: int, Tk: int) -> int:
    """Query-key pairs the causal mask keeps (query i sees keys 0..i)."""
    n = min(Tq, Tk)
    return n * (n + 1) // 2 + (Tq - n) * Tk


def flash_cost(q, k, v, causal: bool) -> tuple:
    B, Tq, H, D = q.shape
    Tk, Dv = k.shape[1], v.shape[3]
    pairs = causal_pairs(Tq, Tk) if causal else Tq * Tk
    return (2 * B * H * (D + Dv) * pairs,
            _nb(q) + _nb(k) + _nb(v) + B * Tq * H * Dv * q.element_size())


def paged_cost(q, k_pages, v_pages, table, lens, k_scale=None,
               v_scale=None) -> tuple:
    """At the table's capacity (module docstring)."""
    n, H, D = q.shape
    page, KH = k_pages.shape[1:3]
    n_tok = n * table.shape[1] * page
    pools = n_tok * KH * D * (k_pages.element_size()
                              + v_pages.element_size())
    if k_scale is not None:
        pools += n_tok * KH * (k_scale.element_size()
                               + v_scale.element_size())
    return 4 * H * D * n_tok, 2 * _nb(q) + _nb(table) + _nb(lens) + pools


def append_cost(k, v, rows, k_pages, k_scale) -> tuple:
    """The rows one quantize-and-append reads and writes."""
    n, KH, D = k.shape
    return (k.numel() + v.numel(),
            _nb(k) + _nb(v) + _nb(rows)
            + 2 * n * KH * (D * k_pages.element_size()
                            + k_scale.element_size()))


def latent_cost(q, pool, table, lens, dv: int) -> tuple:
    B, H, D = q.shape
    n_tok = B * table.shape[1] * pool.shape[1]
    return (2 * H * (D + dv) * n_tok,
            _nb(q) + n_tok * D * pool.element_size() + _nb(table)
            + _nb(lens) + B * H * dv * q.element_size())


def grouped_cost(x, y, out_shape, contracted: int, counts) -> tuple:
    """A grouped product at capacity, x and y to an (E, ., .) output in
    x's dtype over the ``contracted`` extent: 2 x |out| x contracted
    flops (2·E·C·K·N), whole operands and output."""
    out = math.prod(out_shape)
    return (2 * out * contracted,
            _nb(x) + _nb(y) + out * x.element_size() + _nb(counts))


# ------------------------------------------------------------ the count
def storage_bytes(tree) -> dict:
    """{storage key: bytes} of the tensors in ``tree`` (tuples, lists and
    dicts), each storage once."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in _tensors(tree, [])}


def _tensors(x, out):
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def op_costs(func, args, ins, outs) -> tuple:
    """(flops, bytes) of one dispatched aten op (module docstring) of
    positional ``args``, tensor operands ``ins`` and results ``outs``."""
    name = func.overloadpacket.__name__
    if func.is_view or name in _NOTHING or func.namespace != "aten":
        return 0, 0
    res = sum(_nb(t) for t in outs)
    n_res = sum(t.numel() for t in outs)
    if name in _MATMUL:
        K = args[_MATMUL[name]].shape[-1]
        return 2 * n_res * K, res + sum(_nb(t) for t in ins)
    if name in _GATHERS:
        return 0, 2 * res
    if name in _SCATTERS:
        upd = _tensors(args[_SCATTERS[name]:_SCATTERS[name] + 1], [])
        idx = _tensors(args[1:_SCATTERS[name]], [])
        return 0, 2 * sum(_nb(t) for t in upd) + sum(_nb(t) for t in idx)
    if name in ("_to_copy", "copy_") and ins[-1].device != outs[0].device:
        return 0, 0
    if name == "copy_":
        return 0, res + _nb(args[1])
    if name in _FILLS:
        return 0, res
    if name in _SORTS:
        n = max(n_res, 2)
        return n * math.log2(n), res + sum(_nb(t) for t in ins)
    flops = 0 if name in _ZERO_FLOP else n_res
    return flops, res + sum(_nb(t) for t in ins)


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self.quiet = 0
        self.live: dict = {}           # storage key -> bytes
        self.now = 0
        self.finalizers: list = []

    @contextlib.contextmanager
    def hush(self):
        self.quiet += 1
        try:
            yield
        finally:
            self.quiet -= 1

    def track(self, tensors):
        """Count each storage of ``tensors`` not yet live once, until it
        is freed."""
        for t in tensors:
            s = t.untyped_storage()
            key = s._cdata
            if key in self.live:
                continue
            self.live[key] = s.nbytes()
            self.now += self.live[key]
            self.costs.peak_bytes = max(self.costs.peak_bytes, self.now)
            self.finalizers.append(weakref.finalize(s, self._free, key))

    def _free(self, key):
        self.now -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out, [])
        ins = _tensors(args, _tensors(kwargs, []))
        # a view's or an in-place op's result, or an operand handed back,
        # holds an operand's storage: not this op's allocation
        if outs and not (func.is_view or func._schema.is_mutable):
            self.track([t for t in outs
                        if not any(t is i for i in ins)])
        if not self.quiet:
            flops, nbytes = op_costs(func, args, ins, outs)
            self.costs.flops += flops
            self.costs.bytes += nbytes
        return out

    def close(self):
        for f in self.finalizers:
            f.detach()
        self.finalizers.clear()


def analyze(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), Costs)``: the ops ``fn`` dispatches
    counted (module docstring).  The tensors among the arguments (in
    tuples, lists and dicts) are live from the start; ``fn`` runs its
    backward passes on this thread."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("analyze: a count is already running")
    counter = _Counter()
    counter.track(_tensors((args, kwargs), []))
    _ACTIVE = counter
    try:
        with torch.autograd.set_multithreading_enabled(False), counter:
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE = None
        counter.close()
    return out, counter.costs
