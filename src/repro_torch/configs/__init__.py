"""Architecture registry of the port.

``get_config(arch_id)`` returns the published full config and
``get_reduced(arch_id)`` a same-family tiny config for CPU tests, as in
the reference registry.  Only the architectures in ``ARCH_IDS`` are
ported; the reference's other ids raise a "not yet ported" error.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig  # noqa: F401

ARCH_IDS = ["qwen2_0_5b"]

# the reference registry's ids that have no port yet
NOT_PORTED = [
    "qwen2_moe_a2_7b", "deepseek_v3_671b", "qwen1_5_32b", "chatglm3_6b",
    "granite_20b", "internvl2_2b", "whisper_tiny", "zamba2_7b",
    "rwkv6_7b",
]

ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS + NOT_PORTED}
ALIASES.update({
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "qwen1.5-32b": "qwen1_5_32b",
    "qwen2-0.5b": "qwen2_0_5b",
})


def _module(arch: str):
    arch = ALIASES.get(arch, arch)
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not yet ported to repro_torch; "
            f"ported: {ARCH_IDS}")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(ALIASES) + ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()
