"""Which device kernels a wrapper call launches, read from a CUDA graph.

A call captured into a CUDA graph runs nothing on the card; each kernel
it would launch becomes one kernel node, and the node's function names
the kernel.  Counting nodes, unlike reading a profiler window, cannot
lose a launch, and the names show that a wrapper launched its own
kernel and not a library's.  ``chip_smoke.py`` and the card tests count
launches with these functions; they need a card and its driver.
"""
from __future__ import annotations

import ctypes
import re

import torch

# the wrappers of ``ops`` whose calls ``step_calls`` captures
OPS_WRAPPERS = ("streaming_gemm", "grouped_streaming_gemm", "flash_attention",
                "paged_attention", "paged_latent_attention",
                "paged_attention_append", "kv_quantize_append")

# each hand-written kernel's function name, and the ``ops.LAUNCHES``
# counter it belongs to
KERNEL_GROUPS = (("grouped_wgmma", "streaming_gemm_grouped"),
                 ("grouped_bwd_da", "streaming_gemm_grouped"),
                 ("grouped_bwd_db", "streaming_gemm_grouped"),
                 ("gemm_bf16", "streaming_gemm"),
                 ("gemm_simt", "streaming_gemm"),
                 ("flash_bf16", "flash_attention"),
                 ("flash_f32", "flash_attention"),
                 ("kv_quant_append", "kv_quantize"),
                 ("paged_int8_fwd", "paged_attention_int8"),
                 ("paged_latent", "paged_latent_attention"),
                 ("paged_latent_tc", "paged_latent_attention"),
                 ("paged_fwd", "paged_attention"))
# counters whose calls launch another counter's kernel: the int8 paged
# kernel's append entry is the same ``paged_int8_fwd`` with a flag
SHARED_KERNELS = {"paged_attention_int8_append": "paged_attention_int8"}
NOT_A_KERNEL = "not a kernel"
OTHER = "other (torch ops)"
# a demangled function's own name: the first identifier that opens its
# template arguments or its parameters, after a scope or the return type
_FUNC = re.compile(r"(?:^|[\s:])([A-Za-z_]\w*)[<(]")


def kernel_group(name) -> str:
    """The launch counter a device kernel's (demangled) name belongs to,
    by the kernel function's own name, not a substring of it (a
    library's ``sm90_xmma_gemm_bf16...`` is no ``gemm_bf16``);
    ``NOT_A_KERNEL`` for a node that is no kernel (``name`` None),
    ``OTHER`` for a kernel of none of the wrappers."""
    if name is None:
        return NOT_A_KERNEL
    m = _FUNC.search(name)
    func = m.group(1) if m else name
    return dict(KERNEL_GROUPS).get(func, OTHER)


class _KernelNodeParams(ctypes.Structure):
    # CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h
    _fields_ = [("func", ctypes.c_void_p),
                ("dims", ctypes.c_uint * 7),
                ("kernelParams", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


_LIBS: dict = {}


def _libs():
    if not _LIBS:
        cu = ctypes.CDLL("libcuda.so.1")
        cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_size_t)]
        cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_int)]
        cu.cuGraphKernelNodeGetParams_v2.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(_KernelNodeParams)]
        for fn in (cu.cuFuncGetName, cu.cuKernelGetName):
            fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p]
        cxx = ctypes.CDLL("libstdc++.so.6")
        cxx.__cxa_demangle.restype = ctypes.c_void_p
        cxx.__cxa_demangle.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                       ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int)]
        libc = ctypes.CDLL("libc.so.6")
        libc.free.argtypes = [ctypes.c_void_p]
        _LIBS.update(cu=cu, cxx=cxx, libc=libc)
    return _LIBS["cu"], _LIBS["cxx"], _LIBS["libc"]


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUresult {rc}")


def _kernel_name(cu, cxx, libc, node) -> str:
    """A kernel node's function name, demangled."""
    p = _KernelNodeParams()
    _check(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)),
           "cuGraphKernelNodeGetParams")
    raw = ctypes.c_char_p()
    if p.func:
        _check(cu.cuFuncGetName(ctypes.byref(raw), p.func), "cuFuncGetName")
    else:
        _check(cu.cuKernelGetName(ctypes.byref(raw), p.kern),
               "cuKernelGetName")
    status = ctypes.c_int(-1)
    out = cxx.__cxa_demangle(raw.value, None, None, ctypes.byref(status))
    if status.value != 0 or not out:     # not a mangled C++ name
        return raw.value.decode()
    name = ctypes.string_at(out).decode()
    libc.free(out)
    return name


def captured_nodes(fn, reps: int = 1) -> list:
    """The nodes of the CUDA graph that ``reps`` calls of ``fn`` capture:
    each kernel node's demangled function name, None for a node of
    another type (a memset or a copy).  Capturing runs nothing."""
    cu, cxx, libc = _libs()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)),
           "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)),
           "cuGraphGetNodes")
    names = []
    for node in nodes:
        t = ctypes.c_int(-1)
        _check(cu.cuGraphNodeGetType(node, ctypes.byref(t)),
               "cuGraphNodeGetType")
        names.append(_kernel_name(cu, cxx, libc, node) if t.value == 0
                     else None)
    g.reset()
    return names


def captured_groups(fn, reps: int = 1) -> list:
    """``kernel_group`` of each node ``captured_nodes`` reads."""
    return [kernel_group(n) for n in captured_nodes(fn, reps)]


def _signature(args, kwargs):
    """A wrapper call's argument shapes, dtypes and strides, and its
    other arguments: calls alike capture alike graphs."""
    def one(a):
        if isinstance(a, torch.Tensor):
            return (tuple(a.shape), str(a.dtype), tuple(a.stride()))
        return repr(a)
    return (tuple(one(a) for a in args),
            tuple((k, one(v)) for k, v in sorted(kwargs.items())))


def step_calls(step, wrappers=OPS_WRAPPERS) -> dict:
    """Run ``step`` once with the given wrappers of ``ops`` watched: each
    call runs as usual, and a call that launched is captured once more
    (once per wrapper and argument signature; the capture's own count
    is taken back).  Returns {counter the call moved: [the call's
    ``captured_nodes``, for each call in order]}."""
    from repro_torch.kernels import ops
    calls: dict = {}
    seen: dict = {}
    orig = {name: getattr(ops, name) for name in wrappers}

    def watch(name, fn):
        def call(*a, **kw):
            before = dict(ops.LAUNCHES)
            out = fn(*a, **kw)
            moved = [k for k in ops.LAUNCHES if ops.LAUNCHES[k] != before[k]]
            if moved:
                key = (name, _signature(a, kw))
                if key not in seen:
                    after = dict(ops.LAUNCHES)
                    seen[key] = captured_nodes(lambda: fn(*a, **kw))
                    ops.LAUNCHES.update(after)
                calls.setdefault(moved[0], []).append(seen[key])
            return out
        return call

    for name, fn in orig.items():
        setattr(ops, name, watch(name, fn))
    try:
        step()
        torch.cuda.synchronize()
    finally:
        for name, fn in orig.items():
            setattr(ops, name, fn)
    return calls


def strays(calls) -> list:
    """(counter, node name) of every node in ``step_calls``' result that
    is not a kernel of the counter its call moved (for a counter of
    ``SHARED_KERNELS``, of the counter whose kernel it launches)."""
    return [(c, n) for c, per_call in calls.items() for nodes in per_call
            for n in nodes if kernel_group(n) != SHARED_KERNELS.get(c, c)]
