"""Fault-tolerant training loop, the reference's ``Trainer`` on one
device (no mesh).

Composes the substrate: deterministic data (resume = pure function of
step), atomic + async checkpoints, a step watchdog (straggler
detection), and optional INT8 + error-feedback gradient compression in
the step (the state then carries ``ef``).  The optimizer state, the
error feedback and the checkpoints hold the reference's leaves only
(``transformer.trainable``); an MLA model's absorbed copies are made
again after every update and after a restore.

Failure model:
  * crash/restart — a new trainer restores the latest checkpoint and
    replays from the step after it (a checkpoint already handed to the
    writer thread is finished before the failure propagates);
  * straggler — a step slower than ``watchdog_factor`` x the trailing
    median (of the last 20, once 5 are in) is logged and counted.

The trainer runs on the card by default and raises without one unless
built with ``device="cpu"``, where every kernel wrapper runs its plain
PyTorch version.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Optional

import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import make_loader
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_train_step
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.optim import get_optimizer
from repro_torch.runtime import compression as GC


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 20
    keep: int = 3
    watchdog_factor: float = 3.0
    log_every: int = 10
    seed: int = 0
    lr_base: float = 3e-4
    lr_warmup: int = 200
    lr_total: int = 10000


class Trainer:
    def __init__(self, run: RunConfig, tcfg: TrainerConfig,
                 inject_failure_at: Optional[int] = None, device="cuda"):
        self.run = run
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.inject_failure_at = inject_failure_at
        self.model = Model(run.model, device=self.device, remat=run.remat)
        self.opt = get_optimizer(run.optimizer)
        self.step_fn = build_train_step(
            run, self.device, lr_base=tcfg.lr_base,
            lr_warmup=tcfg.lr_warmup, lr_total=tcfg.lr_total)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.straggler_events: list = []
        self.metrics_log: list = []

    # ------------------------------------------------------------ state
    def _state(self, params):
        weights = T.trainable(params)
        state = {"params": params, "opt": self.opt.init(weights)}
        if self.run.gradient_compression:
            state["ef"] = GC.init_ef(weights)
        return state

    def init_state(self):
        """Random weights from ``seed`` (torch's draws on the device) and
        a fresh optimizer state."""
        g = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        return self._state(self.model.init(g))

    def restore_or_init(self):
        """(state, first step to run): the latest checkpoint and the step
        after it, or a fresh state and 0."""
        if self.ckpt.latest_step() is None:
            return self.init_state(), 0
        template = self._state(self.model.abstract_params())
        state, step = self.ckpt.restore(template, device=self.device)
        T.add_derived(state["params"], self.run.model)
        return state, step + 1

    # ------------------------------------------------------------- run
    def train(self, num_steps: int) -> dict:
        """Run steps up to ``num_steps`` (exclusive) from the latest
        checkpoint.  Returns the losses, the last one and the straggler
        steps."""
        state, start = self.restore_or_init()
        loader = make_loader(self.run.model, self.run.shape, self.device,
                             start_step=start, seed=self.tcfg.seed)
        durations: list = []
        losses = []
        try:
            for step, batch in loader:
                if step >= num_steps:
                    break
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                loss = float(metrics["loss"])      # waits for the step
                dt = time.perf_counter() - t0
                losses.append(loss)
                self.metrics_log.append({
                    "step": step, "loss": loss, "s": dt,
                    **{k: float(metrics[k]) for k in ("ce", "aux", "mtp")
                       if k in metrics}})
                # --------------- straggler watchdog
                if len(durations) >= 5:
                    med = statistics.median(durations[-20:])
                    if dt > self.tcfg.watchdog_factor * med:
                        self.straggler_events.append(step)
                durations.append(dt)
                # --------------- checkpoint + injected failure
                if (step + 1) % self.tcfg.ckpt_every == 0:
                    self.ckpt.save(state, step)
                if self.inject_failure_at is not None and \
                        step == self.inject_failure_at:
                    raise RuntimeError(
                        f"injected node failure at step {step}")
        finally:
            loader.close()
            self.ckpt.wait()       # a save handed to the writer lands
        return {"final_loss": losses[-1] if losses else float("nan"),
                "losses": losses, "stragglers": self.straggler_events}
