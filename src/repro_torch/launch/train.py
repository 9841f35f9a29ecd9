"""Training launcher: the synthetic corpus, checkpoints and restart, on
the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 30 --seq 512 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --reduced --device cpu --steps 30 --seq 128 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen2-moe-a2.7b --layers 4 --steps 20 --seq 512 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-v3-671b --layers 3 --steps 20 --seq 512 --batch 8 \
        --remat full
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \
        --layers 10 --steps 20 --seq 512 --batch 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \
        --layers 7 --steps 20 --seq 512 --batch 8

Trains the dense and vlm families (qwen2-0.5b, internvl2-2b,
chatglm3-6b, granite-20b, qwen1.5-32b) and the MoE family with GQA
(qwen2-moe-a2.7b; its aux loss is printed beside the loss; at full
width 4 layers, ~2.9 G values and ~35 GB of weights, gradients and
AdamW moments, fit one 80 GB card) or MLA (deepseek-v3-671b, whose
multi-token-prediction loss is printed too; at full width its 3 dense
layers and the MTP head, ``configs.deepseek_v3_671b.TRAINING``, ~2.9 G
values, fit one card; a MoE layer beside them does not), the ssm family
(rwkv6-7b; at full width 10 layers, ``configs.rwkv6_7b.TRAINING``,
~2.9 G values) and the hybrid family (zamba2-7b; 7 layers,
``configs.zamba2_7b.TRAINING``, ~1.9 G values, the shared block run
twice).  The audio family (whisper-tiny) raises ``ValueError``: the
synthetic corpus yields token ids and labels and no ``audio_frames``
(the reference's Trainer fails on it with a ``KeyError``); it trains
through ``launch.steps.build_train_step`` with batches that carry
frames.  ``--remat`` is ``none``, ``dots`` or ``full``.  Weights are
random, drawn from ``--seed``.  A run resumes from the latest checkpoint in
``--ckpt-dir``.  ``--layers N`` keeps the first N layers of the config
at full width.  ``--device cpu`` runs the plain PyTorch versions of the
kernels on the host (use ``--reduced`` there); without a card and
without it, the launcher raises.

``--mesh host`` (the default) trains on ``make_host_mesh(1, 1)``: the
mesh train step of ``launch.steps`` on one rank (NCCL on the card, gloo
with ``--device cpu``), which computes what the meshless step does, bit
for bit.  A mesh of more ranks is built
by ranks that start their own process group and call ``Trainer`` with
``make_host_mesh``; ``--mesh production`` and ``production-multi`` (the
reference's 256- and 512-rank meshes) raise ``ValueError`` naming the
ranks they need and the world size there is.
"""
import argparse
import statistics

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import RunConfig, ShapeConfig, depth_cut
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     mesh_shape_dict)
from repro_torch.runtime.train_loop import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep only the first N layers (0: all)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="build/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "production", "production-multi"])
    args = ap.parse_args(argv)

    if args.mesh.startswith("production"):
        plan = make_production_mesh(multi_pod=args.mesh.endswith("multi"))
        world = dist.get_world_size() if dist.is_initialized() else 1
        raise ValueError(
            f"--mesh {args.mesh} is a {plan.shape} mesh of {plan.size} "
            f"ranks; this launch has a world size of {world}")

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.name}: the data loader yields token ids and labels, no "
            "audio_frames; train it through launch.steps.build_train_step "
            "with batches that carry frames")
    if args.layers:
        cfg = depth_cut(cfg, args.layers)
    run = RunConfig(model=cfg,
                    shape=ShapeConfig("train", "train", args.seq,
                                      args.batch),
                    remat=args.remat, optimizer=args.optimizer,
                    gradient_compression=args.compress_grads)
    mesh = make_host_mesh(1, 1, device=args.device)
    tr = Trainer(run, TrainerConfig(
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, seed=args.seed,
        lr_base=args.lr, lr_warmup=max(args.steps // 10, 2),
        lr_total=max(args.steps, 100)), device=args.device, mesh=mesh)
    out = tr.train(args.steps)
    if not out["losses"]:
        print(f"[{cfg.name}] nothing to run: {args.ckpt_dir} is at step "
              f"{tr.ckpt.latest_step()} of {args.steps}")
        return
    last = tr.metrics_log[-1]
    mtp = f", mtp {last['mtp']:.4f}" if "mtp" in last else ""
    step_ms = statistics.median(r["s"] for r in tr.metrics_log) * 1e3
    peak = f", peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB" \
        if tr.device.type == "cuda" else ""
    print(f"[{cfg.name}] {len(out['losses'])} steps on {tr.device}, "
          f"loss {out['losses'][0]:.4f} -> {out['final_loss']:.4f} "
          f"(aux {last['aux']:.6f}{mtp}), median step {step_ms:.1f} ms"
          f"{peak}, stragglers={len(out['stragglers'])}, "
          f"checkpoints={tr.ckpt.all_steps()}, mesh {mesh_shape_dict(mesh)}")


if __name__ == "__main__":
    main()
