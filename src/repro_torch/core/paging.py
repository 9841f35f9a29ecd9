"""Page-aligned tiling (paper §3.3), on torch tensors.

The runtime partitions matrices into page-sized tiles: one tile = one OS
page = one DMA descriptor = at most one TLB lookup.  Tile geometry
follows the paper: W = 16 rows and L columns with W·L·S = page_bytes
(INT8 16×256, FP16/BF16/INT16 16×128, FP32/INT32 16×64 for 4 KB pages).

A is stored row-major per tile; B is stored row-striped (row-major
within an L×W tile, tiles laid out so the k-walk of B is contiguous),
which avoids the strided column walk of the paper's Fig. 5.

Element sizes come from a name table (``dtype_bytes``), so numpy
dtypes, torch dtypes and strings, ``"bfloat16"`` included, resolve
without a bfloat16-aware numpy extension.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

PAGE_BYTES = 4096
SA_DIM = 16                     # paper's systolic array width W

_ITEMSIZE = {
    "bool": 1, "int8": 1, "uint8": 1, "float8_e4m3fn": 1,
    "float8_e5m2": 1, "int16": 2, "uint16": 2, "float16": 2,
    "bfloat16": 2, "int32": 4, "uint32": 4, "float32": 4, "int64": 8,
    "uint64": 8, "float64": 8,
}


def dtype_bytes(dtype) -> int:
    """Element size in bytes of a torch dtype, a numpy dtype (or scalar
    type) or a dtype name."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    if name not in _ITEMSIZE:
        raise TypeError(f"no element size known for dtype {dtype!r}")
    return _ITEMSIZE[name]


def tile_shape(dtype, page_bytes: int = PAGE_BYTES,
               rows: int = SA_DIM) -> tuple[int, int]:
    """(rows, cols) so one tile fills exactly one page."""
    s = dtype_bytes(dtype)
    cols = page_bytes // (rows * s)
    if rows * cols * s != page_bytes:
        raise ValueError(f"{rows}-row tiles of {dtype} do not fill a "
                         f"{page_bytes}-byte page")
    return rows, cols


@dataclasses.dataclass(frozen=True)
class PageLayout:
    """Blocked layout of an (R, C) matrix in page tiles."""
    rows: int
    cols: int
    tile_r: int
    tile_c: int
    row_striped: bool = False      # B-operand layout

    @property
    def grid(self) -> tuple[int, int]:
        return (-(-self.rows // self.tile_r), -(-self.cols // self.tile_c))

    @property
    def n_pages(self) -> int:
        g = self.grid
        return g[0] * g[1]

    @property
    def padded(self) -> tuple[int, int]:
        g = self.grid
        return (g[0] * self.tile_r, g[1] * self.tile_c)

    def page_of(self, r: int, c: int) -> int:
        """Linear page id holding element (r, c)."""
        ti, tj = r // self.tile_r, c // self.tile_c
        gr, gc = self.grid
        # row-striped B: pages laid out column-of-tiles-major so a k-walk
        # (down a tile column) is contiguous
        return (tj * gr + ti) if self.row_striped else (ti * gc + tj)

    def page_offset(self, r: int, c: int) -> int:
        """Offset in elements of (r, c) inside its page: row-major within
        the tile in both layouts."""
        return (r % self.tile_r) * self.tile_c + (c % self.tile_c)


def layout_for(shape, dtype, operand: str = "A",
               page_bytes: int = PAGE_BYTES) -> PageLayout:
    """A pages are (W × L); B pages are the transposed (L × W), so one A
    page times one B page yields a full W×W output block."""
    tr, tc = tile_shape(dtype, page_bytes)
    if operand.upper() == "B":
        return PageLayout(shape[0], shape[1], tc, tr, row_striped=True)
    return PageLayout(shape[0], shape[1], tr, tc, row_striped=False)


def pack_pages(x: torch.Tensor, layout: PageLayout) -> torch.Tensor:
    """(R, C) -> (n_pages, tile_r, tile_c), zero-padded at the ragged
    edges: the streaming order the DMA engine sees; each [i] is one
    contiguous page."""
    pr, pc = layout.padded
    xp = x.new_zeros((pr, pc))
    xp[:layout.rows, :layout.cols] = x
    gr, gc = layout.grid
    t = xp.reshape(gr, layout.tile_r, gc, layout.tile_c)
    if layout.row_striped:
        t = t.permute(2, 0, 1, 3)          # (gc, gr, tr, tc): k-contiguous
    else:
        t = t.permute(0, 2, 1, 3)          # (gr, gc, tr, tc)
    return t.reshape(layout.n_pages, layout.tile_r, layout.tile_c)


def unpack_pages(pages: torch.Tensor, layout: PageLayout) -> torch.Tensor:
    gr, gc = layout.grid
    if layout.row_striped:
        t = pages.reshape(gc, gr, layout.tile_r, layout.tile_c) \
            .permute(1, 2, 0, 3)
    else:
        t = pages.reshape(gr, gc, layout.tile_r, layout.tile_c) \
            .permute(0, 2, 1, 3)
    x = t.reshape(layout.padded)
    return x[:layout.rows, :layout.cols]
