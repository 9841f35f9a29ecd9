"""Train an LM on the synthetic corpus with checkpoints and restart, in
the PyTorch/CUDA port: every projection, the MLP and the lm_head run
through the streaming GEMM kernel, forward and backward.  On the card
the config trains at full width (``--layers`` cuts its depth), on the
CPU (``--device cpu``) the reduced config through the kernels' plain
versions.  Weights are random.

    PYTHONPATH=src python examples/train_lm_torch.py --layers 4 --steps 50
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""
import argparse
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import RunConfig, ShapeConfig, depth_cut
from repro_torch.device import resolve_device
from repro_torch.models.params import n_elements
from repro_torch.runtime.train_loop import Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="build/train_lm_torch")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if dev.type == "cuda" \
        else get_reduced(args.arch)
    if args.layers:
        cfg = depth_cut(cfg, args.layers)
    run = RunConfig(model=cfg,
                    shape=ShapeConfig("train", "train", args.seq,
                                      args.batch),
                    remat="none",
                    gradient_compression=args.compress_grads)
    tr = Trainer(run, TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=20,
                                    lr_base=3e-3, lr_warmup=10,
                                    lr_total=max(args.steps, 100)),
                 device=dev)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu"
    n = n_elements(tr.model.abstract_params())
    print(f"training {cfg.name} on {where}: {n / 1e6:.1f}M parameter "
          f"elements, seq={args.seq} batch={args.batch}")
    out = tr.train(args.steps)
    if out["losses"]:
        print(f"loss: {out['losses'][0]:.4f} -> {out['final_loss']:.4f} "
              f"({len(out['losses'])} steps; "
              f"{len(out['stragglers'])} straggler events)")
    print(f"checkpoints: {tr.ckpt.all_steps()} (restart resumes exactly)")


if __name__ == "__main__":
    main()
