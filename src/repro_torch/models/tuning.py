"""Performance-tuning context (the hillclimbing knobs), as in the
reference: model code reads chunk sizes from here so a launcher can
sweep them without touching architecture configs.  ``ce_chunk`` is the
T page of the chunked cross-entropy of training
(``transformer.chunked_ce_loss``).

``moe_local_dispatch`` picks the row-local MoE dispatch
(``models.moe._apply_moe_local``), the one a batch split over ranks
runs.

``moe_cap_axis`` names the mesh axis the reference shards the MoE
capacity dim over (``launch.steps._ctx_wrap`` sets it from
``RunConfig.moe_cap_axis``).  It is carried and inert: the port splits
no activation across ranks (``sharding.context``), so no MoE buffer is
sharded by it.

``kv_cache_quant`` makes ``Model.init_cache`` build int8 K/V pools with
fp16 per-(token, KV head) scales for the families the reference
quantizes (dense, vlm, MoE without MLA, and whisper's self-attention);
from then on the pool's dtype carries the decision, as ``"k_scale" in
cache`` does in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class Tuning:
    q_chunk: int = 512             # chunked-attention query page
    kv_chunk: int = 1024           # chunked-attention KV page
    ce_chunk: int = 512            # chunked cross-entropy T page
    ssm_chunk: int = 16            # linear-attention chunk
    kv_cache_quant: bool = False   # INT8 paged KV (per-token scales)
    moe_cap_axis: Optional[str] = None   # shard the MoE capacity dim
    moe_local_dispatch: bool = False     # row-local (batch-split) dispatch


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
