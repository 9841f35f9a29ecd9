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
            "repro_torch.serving.state_cache",
            "repro_torch.configs.paper_models",
            "repro_torch.accesys",
            "repro_torch.accesys.components",
            "repro_torch.accesys.pipeline",
            "repro_torch.accesys.system",
            "repro_torch.accesys.workloads",
            "repro_torch.accesys.calibration",
            "repro_torch.sharding.logical",
            "repro_torch.core.multidev",
            "repro_torch.core.design_space",
            "repro_torch.core.scenario",
            "repro_torch.serving.sim_report",
            "repro_torch.serving.invariants",
            "repro_torch.serving.faults",
            "repro_torch.launch.simulate",
            "repro_torch.optim", "repro_torch.optim.optimizers",
            "repro_torch.runtime.compression",
            "repro_torch.runtime.train_loop",
            "repro_torch.data.pipeline",
            "repro_torch.checkpoint.checkpoint",
            "repro_torch.launch.steps",
            "repro_torch.launch.train",
            "repro_torch.launch.phase_ab",
            "repro_torch.kernels.grouped_gemm",
            "repro_torch.kernels.streaming_gemm",
            "repro_torch.kernels.kernel_nodes",
            "repro_torch.models.transformer"} <= set(mods)
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


# the port's examples, each with ``--device cpu`` at reduced width (the
# training ones also with a fresh checkpoint directory)
EXAMPLES = {
    "train_lm_torch.py": ["--device", "cpu", "--steps", "6", "--seq", "32",
                          "--batch", "2"],
    "quickstart_torch.py": ["--device", "cpu"],
    "paged_serving_torch.py": ["--device", "cpu", "--int8"],
    "serve_batched_torch.py": ["--device", "cpu", "--requests", "4",
                               "--new-tokens", "3", "--kv-cache-quant"],
    "offload_streaming_torch.py": ["--device", "cpu", "--layers", "4",
                                   "--width", "64"],
}


TRAINING_EXAMPLES = ("train_lm_torch.py", "quickstart_torch.py")


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu_and_loads_no_jax(name, tmp_path):
    """Each of the port's examples (serving, training, the quickstart)
    runs to its end with ``--device cpu`` at reduced width, and loads
    neither JAX nor any module of the JAX package."""
    path = SRC.parent / "examples" / name
    argv = EXAMPLES[name] + (["--ckpt-dir", str(tmp_path)]
                             if name in TRAINING_EXAMPLES else [])
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{str(path)!r}] + {argv!r}\n"
        f"runpy.run_path({str(path)!r}, run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes',"
        " 'repro') or m.startswith(('jax.', 'ml_dtypes.', 'repro.')))\n"
        "print('loaded:' + ','.join(bad))\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "loaded:", out.stdout


def test_distribution_modules_are_ported():
    """The mesh layer's modules are in the port (and so are imported,
    without JAX, by ``test_port_imports_no_jax``), as are the helpers
    the reference's step builders and trainer read."""
    assert {"repro_torch.sharding", "repro_torch.sharding.context",
            "repro_torch.sharding.blocks",
            "repro_torch.core", "repro_torch.launch.mesh",
            "repro_torch.launch.steps"} <= set(_port_modules())
    code = (
        "from repro_torch.launch import mesh, steps\n"
        "from repro_torch.sharding.context import current, mesh_context,"
        " shard\n"
        "from repro_torch.runtime.compression import compressed_psum\n"
        "from repro_torch.models import decoding, layers, ssm\n"
        "from repro_torch.models.model import Model, batch_axes\n"
        "from repro_torch.models.params import axes_tree\n"
        "from repro_torch.optim import AdamW, Adafactor\n"
        "for f in (mesh.make_host_mesh, mesh.make_production_mesh,"
        " mesh.mesh_shape_dict, steps.build_train_step,"
        " steps.build_prefill_step, steps.build_decode_step,"
        " steps.build_step, steps.make_rules, decoding.cache_axes,"
        " layers.cache_axes, layers.mla_cache_axes, ssm.rwkv_state_axes,"
        " ssm.mamba_state_axes, Model.param_axes, Model.cache_axes,"
        " AdamW.state_axes, Adafactor.state_axes):\n"
        "    assert callable(f), f\n"
        "import sys\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or"
        " m.startswith(('jax.', 'repro.'))))\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout
