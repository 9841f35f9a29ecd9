"""Performance-tuning context (the hillclimbing knobs), as in the
reference: model code reads chunk sizes from here so a launcher can
sweep them without touching architecture configs.

``moe_local_dispatch`` picks the row-local MoE dispatch
(``models.moe._apply_moe_local``).

The paged INT8 KV cache (``kv_cache_quant``) is not ported yet: setting
it raises ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class Tuning:
    q_chunk: int = 512             # chunked-attention query page
    kv_chunk: int = 1024           # chunked-attention KV page
    ssm_chunk: int = 16            # linear-attention chunk
    kv_cache_quant: bool = False   # INT8 paged KV (not ported yet)
    moe_local_dispatch: bool = False   # row-local MoE dispatch

    def __post_init__(self):
        if self.kv_cache_quant:
            raise NotImplementedError(
                "INT8 KV cache (kv_cache_quant) is not ported yet")


DEFAULT = Tuning()


def get() -> Tuning:
    return getattr(_STATE, "tuning", DEFAULT)


@contextlib.contextmanager
def tuning_context(t: Tuning):
    prev = get()
    _STATE.tuning = t
    try:
        yield
    finally:
        _STATE.tuning = prev
