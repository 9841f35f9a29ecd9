"""The reference's first train step for ``tests/test_torch_mesh.py``, in a
process of its own that runs while the test's gloo ranks do.

``start(tmp, cases)`` saves ``cases`` ({name: (arch, batch, run
settings)}, the batch as torch tensors; the settings' ``overrides``, a
dict, replace fields of the reduced config on both sides) into ``tmp``
and starts
``python -m torch_mesh_reference <tmp>`` with
``XLA_FLAGS=--xla_allow_excess_precision=false``, one XLA thread and the
CPU platform; ``result()`` waits for it (with a timeout) and returns
{name: {"metrics", "grad"}}: the step's metrics, and the gradient the
optimizer is handed, in the port's tree.

The step is the first step of the reference's train step
(``launch/steps.py``, with the ``Trainer``'s gradient compression when
the run has it) from ``PRNGKey(0)`` weights: the loss and its gradients
under the run's ``Tuning`` (one jitted ``value_and_grad`` for the runs
of one arch and batch), INT8 compression with fresh error feedback,
the global norm the optimizer clips by, and ``lr(0)``.  Without excess
precision XLA rounds every bf16 op of a fused computation, as the port
does and as the reference run op by op does, so an MoE route does not
move between the two near a router tie (``tests/test_torch_train_moe.py``
runs the reference op by op for that).
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import torch


class Reference:
    def __init__(self, proc, tmp: Path, timeout: float):
        self.proc, self.tmp, self.timeout = proc, tmp, timeout
        self.deadline = time.monotonic() + timeout

    def result(self) -> dict:
        try:
            self.proc.wait(max(self.deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            raise TimeoutError(f"the reference outlived {self.timeout} s")
        err = self.proc.stderr.read().decode()
        if self.proc.returncode != 0:
            raise RuntimeError(f"the reference exited {self.proc.returncode}"
                               f": {err[-3000:]}")
        return torch.load(self.tmp / "reference.pt", weights_only=False)


def start(tmp: Path, cases: dict, timeout: float = 240.0) -> Reference:
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(cases, tmp / "reference_inputs.pt")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false "
                        "--xla_backend_optimization_level=0 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1",
           "PYTHONPATH": os.pathsep.join(
               [str(Path(__file__).parent)] + sys.path)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch_mesh_reference", str(tmp)], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    return Reference(proc, tmp, timeout)


def _to_jax(v):
    import jax.numpy as jnp
    if v.dtype == torch.bfloat16:
        return jnp.asarray(v.float().numpy(), jnp.bfloat16)
    return jnp.asarray(v.numpy())


def main(tmp: Path) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_reduced as ref_reduced
    from repro.configs.base import RunConfig, ShapeConfig
    from repro.launch import steps as ref_steps
    from repro.models.model import Model
    from repro.optim import cosine_schedule
    from repro.optim.optimizers import _global_norm
    from repro.runtime import compression as GC
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.params import from_reference
    from torch_mesh_ranks import LR

    lr0 = cosine_schedule(LR["lr_base"], LR["lr_warmup"], LR["lr_total"])(
        jnp.zeros((), jnp.int32))
    grads, out = {}, {}
    for name, (arch, batch, kw) in torch.load(
            tmp / "reference_inputs.pt", weights_only=False).items():
        overrides = kw.get("overrides", {})
        rcfg = dataclasses.replace(ref_reduced(arch), **overrides)
        run = RunConfig(model=rcfg, shape=ShapeConfig(
            "t", "train", kw.get("seq", 32), kw.get("batch", 4)),
            remat="none", optimizer=kw.get("opt", "adamw"),
            gradient_compression=kw.get("compression", False),
            moe_local_dispatch=kw.get("local", False))
        key = (arch, tuple(sorted(overrides.items())),
               run.moe_local_dispatch,
               tuple((k, tuple(v.shape)) for k, v in batch.items()))
        if key not in grads:
            model = Model(rcfg, remat="none")
            p = model.init(jax.random.PRNGKey(0))
            b = {k: _to_jax(v) for k, v in batch.items()}
            with ref_steps._run_tuning(run):
                grads[key] = p, jax.jit(jax.value_and_grad(
                    lambda q: model.loss(q, b), has_aux=True))(p)
        p, ((loss, metrics), g) = grads[key]
        if run.gradient_compression:
            g, _ = jax.jit(GC.apply_compression)(g, GC.init_ef(p))
        out[name] = {
            "metrics": {k: float(v) for k, v in {
                **metrics, "loss": loss, "lr": lr0,
                "grad_norm": _global_norm(g)}.items()},
            "grad": T.trainable(from_reference(
                jax.tree.map(np.asarray, g),
                dataclasses.replace(get_reduced(arch), **overrides)))}
    torch.save(out, tmp / "reference.pt")


if __name__ == "__main__":
    main(Path(sys.argv[1]))
