"""Architecture registry of the port.

``get_config(arch_id)`` returns the published full config and
``get_reduced(arch_id)`` a same-family tiny config for CPU tests, as in
the reference registry.  Every architecture of the reference registry
is in ``ARCH_IDS``; an id listed in ``NOT_PORTED`` would raise a "not
yet ported" error.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    MLAConfig,
    ModelConfig,
    MoEConfig,
    RunConfig,
    SHAPES,
    ShapeConfig,
    SSMConfig,
    shapes_for,
    skip_reason,
)

# in the reference registry's order: the simulator's registry and its
# smoke matrix (one scenario per family, the first arch of each) follow it
ARCH_IDS = ["qwen2_moe_a2_7b", "deepseek_v3_671b", "qwen1_5_32b",
            "qwen2_0_5b", "chatglm3_6b", "granite_20b", "internvl2_2b",
            "whisper_tiny", "zamba2_7b", "rwkv6_7b"]

# the reference registry's ids that have no port yet
NOT_PORTED: list = []

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


FAMILIES = ("dense", "vlm", "moe", "audio", "ssm", "hybrid")


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot build
    yet: a family outside ``FAMILIES``."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not yet ported")
