"""Layer-pipelined weight streaming (host → device): the model-level use
of the paper's DM/DC/DevMem modes.  A model whose weights live in host
memory is served by fetching layer ℓ+1 while layer ℓ computes (double
buffering at layer granularity, as A0/A1 are at page granularity).

In DM and DC each layer's weights are packed into one host row (every
leaf at a 256-byte aligned offset), pinned on a card, so that a fetch is
ONE asynchronous host-to-device copy, one DMA descriptor per layer as
one page is one descriptor in the paper; the layer's leaves are views
into the fetched buffer.  (Issuing a copy per leaf costs the host tens
of microseconds each, and the layer streamer is host-bound.)  The copies
run on a side CUDA stream, under the compute of earlier layers.  One
CUDA event per fetched layer is recorded on that stream, and the compute
stream waits on it before the layer runs.  The fetched buffer is marked
as used by the compute stream (``record_stream``), so the caching
allocator does not hand its memory out again before the layer's kernels
are done.  The wall time is read after the card has finished
(``synchronize``).  DevMem keeps the stacked leaves on the device and
hands out views of them.

Traffic is metered as the reference meters it: each leaf's bytes divided
by the layer count (integer division per leaf), without the alignment
padding of the packed rows (at most 255 bytes a leaf).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.core.modes import (MemoryMode, TrafficStats,
                                    device_placement, tensor_bytes)
from repro_torch.device import resolve_device


@dataclasses.dataclass
class StreamReport:
    mode: str
    layers: int
    bytes_streamed: int
    wall_s: float


def _flatten(tree, path=()):
    """[(path, leaf)] of a tree of dicts, in insertion order."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in _flatten(v, path + (k,))]
    return [(path, tree)]


def _unflatten(paths, leaves):
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def stack_layers(layers: list):
    """A list of per-layer parameter trees (the port's layer stack) ->
    one tree whose leaves carry a leading layer axis, the layout
    ``LayerStreamer`` streams from."""
    if isinstance(layers[0], dict):
        return {k: stack_layers([lp[k] for lp in layers])
                for k in layers[0]}
    return torch.stack(layers)


class LayerStreamer:
    """Holds stacked per-layer params (a tree of dicts whose leaves have a
    leading layer axis) in host memory (DM/DC, packed one row per layer,
    pinned on a card) or device memory (DevMem) and applies a layer
    function over them with layer-ahead prefetch.

    DC keeps the first ``cache_layers`` layers it fetches on the device
    and never evicts them (unlike ``PageStore``'s LRU), as the
    reference does."""

    ALIGN = 256

    def __init__(self, stacked_params, n_layers: int, mode: MemoryMode,
                 cache_layers: int = 0, device="cuda"):
        self.mode = mode
        self.n_layers = n_layers
        self.device = resolve_device(device)
        flat = _flatten(stacked_params)
        self._paths = [p for p, _ in flat]
        leaves = [a.detach() for _, a in flat]
        # each leaf's bytes divided by the layer count separately, as
        # the reference counts them
        self._layer_bytes = sum(tensor_bytes(a) // n_layers for a in leaves)
        self._on_card = self.device.type == "cuda"
        if mode is MemoryMode.DEVMEM:
            self._stacked = [device_placement(a, self.device)
                             for a in leaves]
        else:
            self._host = self._pack(leaves)
        self._cache: dict = {}
        self._cache_layers = cache_layers if mode is MemoryMode.DC else 0
        self._copy_stream = torch.cuda.Stream(self.device) \
            if self._on_card and mode is not MemoryMode.DEVMEM else None
        self.stats = TrafficStats()

    def _pack(self, leaves) -> torch.Tensor:
        """(n_layers, row bytes) uint8 host rows, pinned on a card; one
        (offset, bytes, dtype, shape) slot per leaf."""
        self._slots, off = [], 0
        for a in leaves:
            nb = tensor_bytes(a[0])
            self._slots.append((off, nb, a.dtype, tuple(a.shape[1:])))
            off = -(-(off + nb) // self.ALIGN) * self.ALIGN
        rows = torch.empty((self.n_layers, off), dtype=torch.uint8,
                           pin_memory=self._on_card)
        for a, (o, nb, _, _) in zip(leaves, self._slots):
            rows[:, o:o + nb].copy_(
                a.contiguous().reshape(self.n_layers, -1).view(torch.uint8))
        return rows

    def _unpack(self, row: torch.Tensor):
        return _unflatten(self._paths, [
            row[o:o + nb].view(dt).view(shape)
            for o, nb, dt, shape in self._slots])

    def _fetch(self, idx: int):
        """(layer ``idx``'s params on the device, the event the compute
        stream must wait on before using them, or None)."""
        self.stats.lookups += 1
        if self.mode is MemoryMode.DEVMEM:
            return _unflatten(self._paths,
                              [a[idx] for a in self._stacked]), None
        if idx in self._cache:
            self.stats.cache_hits += 1
            return self._cache[idx]
        self.stats.cache_misses += 1
        if self._copy_stream is None:
            fetched = (self._unpack(device_placement(self._host[idx],
                                                     self.device)), None)
        else:
            with torch.cuda.stream(self._copy_stream):
                row = device_placement(self._host[idx], self.device)
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
            row.record_stream(torch.cuda.current_stream(self.device))
            fetched = (self._unpack(row), ready)
        self.stats.host_to_device_bytes += self._layer_bytes
        if len(self._cache) < self._cache_layers:
            self._cache[idx] = fetched
        return fetched

    def run(self, layer_fn: Callable, x, prefetch: int = 1):
        """x -> layer_fn(params_i, x) for i in layers, fetching
        ``prefetch`` layers ahead of the one computing."""
        t0 = time.perf_counter()
        pending = [self._fetch(i) for i in range(min(prefetch + 1,
                                                     self.n_layers))]
        for i in range(self.n_layers):
            params_i, ready = pending.pop(0)
            nxt = i + prefetch + 1
            if nxt < self.n_layers:
                pending.append(self._fetch(nxt))   # async H2D
            if ready is not None:
                torch.cuda.current_stream(self.device).wait_event(ready)
            x = layer_fn(params_i, x)
        if self._on_card:
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        return x, StreamReport(self.mode.value, self.n_layers,
                               self.stats.host_to_device_bytes, wall)
