"""Memory-access modes (paper Fig. 1): DM / DC / DevMem, on a CUDA card.

  DM     — weights live in HOST memory; every use streams them to the
           device, no reuse cache (paper: DMA straight to DRAM, arrows
           3,5 — bypasses the LLC).
  DC     — like DM plus a device-side LRU page cache (the "LLC",
           arrows 2,4,5): hot tiles are served at device speed.
  DevMem — weights resident in device memory (arrow 6): no host traffic
           during compute.

On a card, host pages are pinned (page-locked) CPU tensors, so each
fetch is a real asynchronous host-to-device copy over PCIe
(``.to(device, non_blocking=True)``), issued on the current stream: the
tile step that consumes a page is stream-ordered after its copy.  (The
layer streamer of ``core.offload``, whose fetches run a layer ahead,
copies on a side stream instead.)  A store made with
``device="cpu"`` keeps its host pages as plain CPU tensors (pinning
needs CUDA) and its "device" is the CPU too; the traffic is metered the
same way in both cases, exactly as the reference meters it.
"""
from __future__ import annotations

import collections
import dataclasses
import enum

import torch

from repro_torch.device import resolve_device


class MemoryMode(enum.Enum):
    DM = "DM"
    DC = "DC"
    DEVMEM = "DevMem"


def host_placement(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` in host memory for a store on ``device``: pinned when the
    store is on a card (so copies from it are asynchronous DMA), a plain
    CPU tensor otherwise."""
    x = x.detach().cpu()
    return x.pin_memory() if device.type == "cuda" else x


def device_placement(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x.to(device, non_blocking=True)


def tensor_bytes(x: torch.Tensor) -> int:
    return int(x.numel() * x.element_size())


@dataclasses.dataclass
class TrafficStats:
    host_to_device_bytes: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    lookups: int = 0

    @property
    def hit_rate(self) -> float:
        return self.cache_hits / max(self.lookups, 1)


class PageStore:
    """Mode-aware page provider: the software half of the co-design.

    ``get(page_id)`` returns the page on the device, metering the
    traffic the mode implies.  DevMem: everything resident.  DM: every
    access streams host→device.  DC: an LRU cache of ``cache_pages``
    device pages (the LLC).
    """

    def __init__(self, pages: dict, mode: MemoryMode,
                 cache_pages: int = 512, device="cuda"):
        self.mode = mode
        self.device = resolve_device(device)
        self.stats = TrafficStats()
        self._page_bytes: dict = {}
        self._resident: dict = {} if mode is MemoryMode.DEVMEM else None
        self._host: dict = None if mode is MemoryMode.DEVMEM else {}
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._cache_pages = cache_pages
        self.add_pages(pages)

    def add_pages(self, pages: dict) -> None:
        """Register pages after construction: intermediates produced
        mid-plan land host-side in DM/DC and resident in DevMem.  Pages
        of one shape and dtype are placed as one block (one pinned
        buffer, or one copy to the card) and registered as its views."""
        groups: dict = {}
        for k, v in pages.items():
            self._page_bytes[k] = tensor_bytes(v)
            groups.setdefault((tuple(v.shape), v.dtype), []).append(k)
        place = device_placement if self.mode is MemoryMode.DEVMEM \
            else host_placement
        target = self._resident if self.mode is MemoryMode.DEVMEM \
            else self._host
        for keys in groups.values():
            block = torch.stack([pages[k].detach() for k in keys])
            target.update(zip(keys, place(block, self.device).unbind(0)))

    def get(self, page_id):
        self.stats.lookups += 1
        if self.mode is MemoryMode.DEVMEM:
            return self._resident[page_id]
        if self.mode is MemoryMode.DC:
            if page_id in self._cache:
                self.stats.cache_hits += 1
                self._cache.move_to_end(page_id)
                return self._cache[page_id]
            self.stats.cache_misses += 1
        arr = device_placement(self._host[page_id], self.device)
        self.stats.host_to_device_bytes += self._page_bytes[page_id]
        if self.mode is MemoryMode.DC:
            self._cache[page_id] = arr
            while len(self._cache) > self._cache_pages:
                self._cache.popitem(last=False)
        return arr
