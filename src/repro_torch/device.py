"""Where the port's entry points run: on the card unless told otherwise.

``Model``, ``PagedKVCache`` and everything built on them default to
``"cuda"`` and raise without a card unless the caller passes
``device="cpu"``, where every kernel wrapper runs its plain PyTorch
version.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the host")
    return dev
