"""Quickstart of the PyTorch/CUDA port: build a small LM, train a few
steps on the synthetic corpus, serve the trained weights, then simulate
the model on the streaming accelerator through the Scenario API.  On
the card (the default) training and serving run through the
hand-written kernels; ``--device cpu`` runs their plain versions.  The
model is the reduced qwen2-0.5b either way; the simulator runs on the
host.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs import get_reduced
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core.design_space import DesignSpace
from repro_torch.core.scenario import Scenario, simulate, tune
from repro_torch.models.params import n_elements
from repro_torch.runtime.train_loop import Trainer, TrainerConfig
from repro_torch.serving.engine import Request, ServingEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default="build/quickstart_torch")
    args = ap.parse_args()

    cfg = get_reduced("qwen2_0_5b")
    run = RunConfig(model=cfg, shape=ShapeConfig("quick", "train", 64, 4),
                    remat="none")
    trainer = Trainer(run, TrainerConfig(ckpt_dir=args.ckpt_dir,
                                         ckpt_every=10, lr_base=5e-3,
                                         lr_warmup=2, lr_total=100),
                      device=args.device)
    out = trainer.train(20)
    if out["losses"]:
        print(f"[train] loss {out['losses'][0]:.3f} -> "
              f"{out['final_loss']:.3f} on {trainer.device}")

    # reuse the trained weights for serving
    state, _ = trainer.restore_or_init()
    print(f"[train] {n_elements(state['params'])} parameter elements")
    eng = ServingEngine(cfg, state["params"], slots=2, max_seq=64,
                        device=trainer.device)
    rng = np.random.default_rng(0)
    for i in range(4):
        eng.submit(Request(uid=i,
                           prompt=rng.integers(1, 250, 8).astype(np.int32),
                           max_new_tokens=8))
    stats = eng.run_until_drained()
    print(f"[serve] {stats.tokens_out} tokens at "
          f"{stats.tokens_per_s:.1f} tok/s "
          f"({stats.prefills} prefills, {stats.decode_steps} decode steps)")

    # what-if simulation: the same model on the paper's streaming
    # accelerator, per memory mode
    for mode in ("DM", "DC", "DevMem"):
        res = simulate(Scenario(model=cfg.name, mode=mode, seq=64),
                       device=trainer.device)
        b = res.buckets()
        print(f"[simulate] {res.label} {mode:7s} "
              f"total={res.total_s*1e6:8.1f}us "
              f"compute={b['compute']:.1%} host={b['host']:.1%}")

    # co-design search over a knob space, Pareto front included
    space = DesignSpace(sa_w=(8, 16), page_bytes=(4096,),
                        buffer_kb=(20, 72), tlb_entries=(16, 64),
                        mode=("DM", "DC", "DevMem"))
    res = tune(Scenario(model=cfg.name, seq=64), space)
    best = res.best
    print(f"[tune] {len(res.points)} points at "
          f"{res.configs_per_s:.0f} configs/s -> "
          f"best {best.point.label()} "
          f"({best.total_s*1e6:.1f}us, "
          f"{len(res.pareto)} on the latency/area Pareto front)")


if __name__ == "__main__":
    main()
