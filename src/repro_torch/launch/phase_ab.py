"""Phase 16a (or all of phase 16, or phase 2's INT8 KV cache kernels)
of ``chip_smoke.py`` from two checkouts, in turns on one card: parent,
change, change, parent.

    python -m repro_torch.launch.phase_ab --parent build/parent \\
        --change . [--phase 16a | 16 | 2i] [--out build/phase_ab.json]

Unpack the parent with ``git archive <commit> | tar -x -C build/parent``
(a directory ``.gitignore`` lists).  Each run is a process of its own
that puts its checkout's ``src`` and root first on ``sys.path``, builds
that checkout's kernels (into the checkout's own ``build/``) and calls
its ``chip_smoke._moe_train_kernels`` (16a: the router, the grouped
forward and both grouped backward products at qwen2-moe's training and
decode counts and deepseek-v3's, each timed beside ``bmm``) or
``phase_moe_training`` (16: 16a, then 16b and 16c), or
``phase_int8_kernels`` (2i: the int8 paged kernel and the quantize
kernel at their phase-2 shapes) followed by the bf16 paged kernel
(``paged_entry``) at qwen2-0.5b's and qwen1.5-32b's 8 x 272 and mixed
64-1,024 shapes on inputs from their own seeded generator.  One line a
run gives each timed shape's ms (16a / 16: each grouped product's and
``bmm``'s); ``--out`` keeps every run's results and the card line.  It needs a card: comparing two
commits means one card, one call, turns.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# the child: argv = checkout root, phase, output file, label
_CHILD = r'''
import argparse, json, os, sys
root, phase, out, label = os.path.abspath(sys.argv[1]), *sys.argv[2:5]
sys.path[:0] = [os.path.join(root, "src"), root]
import torch
import chip_smoke as cs
from repro_torch.kernels import _build
if not torch.cuda.is_available():
    sys.exit("phase_ab: no CUDA device")
_build.build_all()
dev = torch.device("cuda")
rows = {"streaming_gemm": {"max_abs_err": 0.0},
        "streaming_gemm_grouped": {"max_abs_err": 0.0}}
args = argparse.Namespace(seed=0)
if phase == "2i":
    timer = cs.Timer(torch, dev)
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, g=g):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            torch.bfloat16)

    res = {"int8": cs.phase_int8_kernels(torch, timer, randn, g)}
    gb = torch.Generator(device=dev).manual_seed(1)
    B, page, mp = 8, 16, 64
    P = B * mp + 16
    table = torch.randperm(P, generator=gb, device=dev)[:B * mp].reshape(
        B, mp).to(torch.int32)
    mixed = torch.randint(64, 1025, (B,), generator=gb, device=dev).to(
        torch.int32)
    mixed[0] = 1024
    fixed = torch.full((B,), 272, dtype=torch.int32, device=dev)
    res["bf16"] = []
    for arch, H, KH, D in (("qwen2-0.5b", 14, 2, 64),
                           ("qwen1.5-32b", 40, 40, 128)):
        q = randn(B, H, D, g=gb)
        kp, vp = randn(P, page, KH, D, g=gb), randn(P, page, KH, D, g=gb)
        for what, ln in (("8 x 272", fixed), ("mixed 64-1024", mixed)):
            res["bf16"].append(cs.paged_entry(torch, timer, f"{arch} {what}",
                                              q, kp, vp, table, ln, False))
    brief = {name: [[r["what"], r.get("entry", ""), r["ms"]]
                    for r in rows_["per_shape"]]
             for name, rows_ in res["int8"].items()}
    brief["bf16"] = [[r["what"], r["ms"]] for r in res["bf16"]]
elif phase == "16a":
    res = {"kernels": cs._moe_train_kernels(torch, args, dev,
                                            cs.Timer(torch, dev), rows)}
else:
    res = cs.phase_moe_training(torch, args, rows, cs.card_line(), dev)
if phase != "2i":
    brief = {w: [[r["what"], r["ms"], r["library_ms"]]
                 for r in res["kernels"][w]]
             for w in ("grouped_forward", "da", "db")}
print("[phase_ab] " + json.dumps({"run": label, **brief}), flush=True)
json.dump({"run": label, "card": cs.card_line(), "res": res},
          open(out, "w"), default=str)
'''


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the parent checkout")
    ap.add_argument("--change", default=".", help="the changed checkout")
    ap.add_argument("--phase", choices=("16a", "16", "2i"), default="16a")
    ap.add_argument("--out", default="build/phase_ab.json")
    args = ap.parse_args()
    runs = []
    for n, (who, root) in enumerate((("parent", args.parent),
                                     ("change", args.change),
                                     ("change", args.change),
                                     ("parent", args.parent)), 1):
        part = f"{args.out}.{n}"
        rc = subprocess.run([sys.executable, "-c", _CHILD, root, args.phase,
                             part, f"{who} {n}"]).returncode
        if rc:
            sys.exit(f"phase_ab: the {who} run {n} failed ({rc})")
        with open(part) as f:
            runs.append(json.load(f))
        os.remove(part)
    with open(args.out, "w") as f:
        json.dump(runs, f, default=str)


if __name__ == "__main__":
    main()
