"""The train step builder, the reference's ``build_train_step`` without
a mesh: the step runs on one device.

``train_step(state, batch) -> (state, metrics)`` takes the loss and its
gradients by autograd (every GEMM's backward products on the streaming
GEMM kernel), passes the gradients through INT8 compression with error
feedback when ``run.gradient_compression`` (``state["ef"]``, the
reference trainer's wrapped step), and applies the optimizer, whose
update writes the parameters and its state in place.  The gradients,
the optimizer state and the error feedback hold the reference's leaves
only (``transformer.trainable``): an MLA model's absorbed copies of
``wuk`` / ``wuv`` (``transformer.DERIVED``) are made again from the
updated weights after every update (``transformer.add_derived``), so
that a model trained and then served decodes with its trained weights.
``metrics`` holds ``ce``, ``aux`` (and ``mtp`` for a config with an MTP
head), ``loss``, ``lr`` and ``grad_norm`` as scalar tensors on the
device.  The run's chunk knobs are the model's ``Tuning`` while the
step runs.

The reference's prefill and decode step builders are lowering helpers
for its dry-run; they wait for the port's mesh code (ROADMAP Queue A
item 14).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models import tuning as TU
from repro_torch.models.model import Model
from repro_torch.models.params import tree_map
from repro_torch.optim import cosine_schedule, get_optimizer
from repro_torch.runtime import compression as GC


def loss_and_grads(model: Model, params, batch):
    """((loss, metrics), grads): the gradients congruent with
    ``transformer.trainable(params)`` (the reference's leaves, without
    the decode path's derived copies), in the parameters' dtypes (zeros
    for a leaf the loss does not reach)."""
    leaves = []

    def watch(p):
        p = p.detach().requires_grad_(True)
        leaves.append(p)
        return p

    params = T.trainable(params)
    loss, metrics = model.loss(tree_map(watch, params), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        tree_map(lambda _: next(it), params)


def build_train_step(run: RunConfig, device="cuda", lr_base: float = 3e-4,
                     lr_warmup: int = 200, lr_total: int = 10000):
    """``train_step(state, batch)`` for ``state = {"params", "opt"}`` (and
    ``"ef"`` with gradient compression) on ``device``."""
    resolve_device(device)
    model = Model(run.model, device=device, remat=run.remat)
    opt = get_optimizer(run.optimizer)
    lr_fn = cosine_schedule(lr_base, lr_warmup, lr_total)
    tuning = TU.Tuning(q_chunk=run.q_chunk, kv_chunk=run.kv_chunk,
                       ce_chunk=run.ce_chunk, ssm_chunk=run.ssm_chunk,
                       kv_cache_quant=run.kv_cache_quant,
                       moe_local_dispatch=run.moe_local_dispatch)

    def train_step(state, batch):
        with TU.tuning_context(tuning):
            (loss, metrics), grads = loss_and_grads(model, state["params"],
                                                    batch)
        new_state = dict(state)
        if run.gradient_compression:
            grads, new_state["ef"] = GC.apply_compression(grads, state["ef"])
        lr = lr_fn(state["opt"]["step"])
        _, new_state["opt"], om = opt.update(
            grads, state["opt"], T.trainable(state["params"]), lr)
        new_state["params"] = T.add_derived(state["params"], run.model)
        return new_state, {**metrics, **om, "loss": loss, "lr": lr}

    return train_step
