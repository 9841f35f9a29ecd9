"""The port imports neither JAX nor any module of the JAX package."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"


def _port_modules() -> list:
    root = SRC / "repro_torch"
    mods = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax():
    mods = _port_modules()
    assert "repro_torch.kernels.ops" in mods and len(mods) >= 15
    assert {"repro_torch.models.moe",
            "repro_torch.configs.qwen2_moe_a2_7b",
            "repro_torch.configs.internvl2_2b",
            "repro_torch.configs.chatglm3_6b",
            "repro_torch.configs.granite_20b",
            "repro_torch.configs.qwen1_5_32b",
            "repro_torch.configs.whisper_tiny",
            "repro_torch.configs.rwkv6_7b",
            "repro_torch.configs.zamba2_7b",
            "repro_torch.serving.state_cache"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes',"
        " 'repro') or m.startswith(('jax.', 'ml_dtypes.', 'repro.')))\n"
        "print(','.join(bad))\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "", f"port imported: {out.stdout}"
