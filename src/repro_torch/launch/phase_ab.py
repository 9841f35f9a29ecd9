"""Phase 16a (or all of phase 16) of ``chip_smoke.py`` from two
checkouts, in turns on one card: parent, change, change, parent.

    python -m repro_torch.launch.phase_ab --parent build/parent \\
        --change . [--phase 16a | 16] [--out build/phase_ab.json]

Unpack the parent with ``git archive <commit> | tar -x -C build/parent``
(a directory ``.gitignore`` lists).  Each run is a process of its own
that puts its checkout's ``src`` and root first on ``sys.path``, builds
that checkout's kernels (into the checkout's own ``build/``) and calls
its ``chip_smoke._moe_train_kernels`` (16a: the router, the grouped
forward and both grouped backward products at qwen2-moe's training and
decode counts and deepseek-v3's, each timed beside ``bmm``) or
``phase_moe_training`` (16: 16a, then 16b and 16c).  One line a run
gives each grouped product's ms and ``bmm`` ms; ``--out`` keeps every
run's results and the card line.  It needs a card: comparing two
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
if phase == "16a":
    res = {"kernels": cs._moe_train_kernels(torch, args, dev,
                                            cs.Timer(torch, dev), rows)}
else:
    res = cs.phase_moe_training(torch, args, rows, cs.card_line(), dev)
brief = {w: [[r["what"], r["ms"], r["library_ms"]] for r in res["kernels"][w]]
         for w in ("grouped_forward", "da", "db")}
print("[phase_ab] " + json.dumps({"run": label, **brief}), flush=True)
json.dump({"run": label, "card": cs.card_line(), "res": res},
          open(out, "w"), default=str)
'''


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the parent checkout")
    ap.add_argument("--change", default=".", help="the changed checkout")
    ap.add_argument("--phase", choices=("16a", "16"), default="16a")
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
