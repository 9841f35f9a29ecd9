"""Render a dry-run directory (``launch.dryrun``'s records) into the
roofline tables, as the reference's ``launch/report.py``.

    PYTHONPATH=src python -m repro_torch.launch.report build/dryrun

The "fits HBM" column compares a rank's memory (arguments + outputs +
temporaries - aliased) with ``roofline.HBM_BYTES``, the H100 80GB
HBM3's device memory, where the reference compares with the TPU's
16 GiB.  Every time in the tables is a roofline term from datasheet
peaks (``launch.roofline``), not a measurement.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from repro_torch.launch.roofline import HBM_BYTES


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def fmt_b(x):
    if x is None:
        return "-"
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.2f}{unit}"
    return f"{x:.0f}B"


def load(outdir, mesh="single", tag="baseline"):
    recs = {}
    for p in sorted(Path(outdir).glob(f"*.{mesh}.{tag}.json")):
        r = json.loads(p.read_text())
        recs[(r["arch"], r["shape"])] = r
    return recs


def roofline_table(outdir, mesh="single", tag="baseline") -> str:
    recs = load(outdir, mesh, tag)
    lines = [
        "| arch | shape | compute | memory | collective | bound | "
        "bytes/dev | fits HBM | useful/HLO | roofline |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape), r in sorted(recs.items()):
        if r["status"] == "skipped":
            lines.append(f"| {arch} | {shape} | — | — | — | *skip* "
                         f"| — | — | — | — |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {arch} | {shape} | ERROR | | | | | | | |")
            continue
        rl = r["roofline"]
        mem = r.get("memory_analysis", {})
        per_dev = (mem.get("argument_bytes", 0) + mem.get("temp_bytes", 0)
                   + mem.get("output_bytes", 0) - mem.get("alias_bytes", 0))
        fits = "✓" if per_dev <= HBM_BYTES else "✗"
        lines.append(
            f"| {arch} | {shape} | {fmt_s(rl['compute_s'])} | "
            f"{fmt_s(rl['memory_s'])} | {fmt_s(rl['collective_s'])} | "
            f"{rl['bottleneck']} | {fmt_b(per_dev)} | {fits} | "
            f"{rl['useful_ratio']:.3f} | {rl['roofline_fraction']:.4f} |")
    return "\n".join(lines)


def summary(outdir, tag="baseline") -> str:
    out = []
    for mesh in ("single", "multi"):
        recs = load(outdir, mesh, tag)
        ok = sum(r["status"] == "ok" for r in recs.values())
        sk = sum(r["status"] == "skipped" for r in recs.values())
        er = sum(r["status"] == "error" for r in recs.values())
        out.append(f"{mesh}: {ok} ok / {sk} skipped / {er} errors "
                   f"({len(recs)} cells)")
    return "\n".join(out)


if __name__ == "__main__":
    outdir = sys.argv[1] if len(sys.argv) > 1 else "build/dryrun"
    tag = sys.argv[2] if len(sys.argv) > 2 else "baseline"
    print(summary(outdir, tag))
    print()
    print(roofline_table(outdir, "single", tag))
