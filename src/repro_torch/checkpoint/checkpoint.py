"""Atomic, async checkpoints with the reference's layout.

Layout: ``<dir>/step_<n:08d>/{meta.json, arrays.npz}``, written to a
``.tmp_step_<n>`` directory and published by ``os.replace``: a crash
mid-save never corrupts the latest checkpoint, and a tmp directory never
counts as one.  ``keep`` checkpoints are kept.  Async mode copies the
state to the host at ``save`` and hands the disk write to a writer
thread, so the next steps overlap it; ``wait`` joins it.

Keys are the tree paths joined by ``/`` (a list index is a path
element: ``params/layers/3/attn/wq``).  npz has no bfloat16: bf16
leaves are widened to float32 on disk and the true dtype is kept in
``meta.json`` (``"bfloat16"``, as the reference writes it), so the port
needs no bfloat16-aware numpy extension.  ``restore`` rebuilds the
template's tree on the template's device (or ``device``) with the
template's dtypes; it also reads the reference's stacked layer leaves
(``params/layers/attn/wq`` of (L, ...)), taking layer i for the port's
``params/layers/i/attn/wq``.

Only the reference's leaves are written (``transformer.trainable``): an
MLA model's absorbed copies of ``wuk`` / ``wuv``
(``transformer.DERIVED``) are no parameters; ``restore`` makes them
again from the restored weights wherever the template holds them.

On a mesh (``mesh`` and the state's ``placement``, ``launch.steps``),
``save`` gathers the whole leaves from every rank's blocks (every rank
calls it) and rank 0 alone writes them, in the same layout; ``restore``
reads whole leaves, makes the derived copies from them (never split),
and keeps this rank's blocks under the *current* mesh's placement, so a
checkpoint saved on one mesh restores onto another and back (the
reference's elastic restore).
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import shutil
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.sharding import blocks as BL

SEP = "/"


def _flatten(tree, prefix=()):
    """[(path tuple, leaf)] of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _flatten(v, prefix + (str(k),))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, prefix + (str(i),))]
    return [(prefix, tree)]


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = cf.ThreadPoolExecutor(max_workers=1) if async_save \
            else None
        self._pending: Optional[cf.Future] = None

    # ------------------------------------------------------------ save
    def save(self, state, step: int, mesh=BL.ONE_RANK, placement=None):
        """Copy ``state`` (a tree of tensors) to the host now and write it
        as checkpoint ``step``, on the writer thread in async mode.  The
        copy is made even for host tensors (``.cpu()`` would return the
        same storage), since the optimizers update the state in place
        while the write is in flight.  On a ``mesh`` the whole leaves are
        gathered first and rank 0 writes (module docstring)."""
        state = T.trainable(state)
        if placement is not None:
            state = BL.gather_tree(state, T.trainable(placement), mesh)
        if BL.mesh_rank(mesh) != 0:
            return
        host = {SEP.join(path): leaf.detach().to("cpu", copy=True)
                for path, leaf in _flatten(state)}
        if self._pool is not None:
            self.wait()
            self._pending = self._pool.submit(self._write, host, step)
        else:
            self._write(host, step)

    def _write(self, host: dict, step: int):
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        def disk(t):
            if t.dtype == torch.bfloat16:
                t = t.float()
            return t.numpy()
        np.savez(tmp / "arrays.npz",
                 **{k.replace("/", "__"): disk(v) for k, v in host.items()})
        (tmp / "meta.json").write_text(json.dumps({
            "step": step,
            "keys": sorted(host.keys()),
            "shapes": {k: list(v.shape) for k, v in host.items()},
            "dtypes": {k: _dtype_name(v) for k, v in host.items()},
        }))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)            # atomic publish
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # --------------------------------------------------------- restore
    def all_steps(self) -> list:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "meta.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template_state, step: Optional[int] = None,
                device=None, mesh=BL.ONE_RANK, placement=None):
        """(state, step): checkpoint ``step`` (default the latest) in the
        structure, shapes and dtypes of ``template_state``, a tree of
        whole tensors (``meta``-device ones will do, with ``device``
        given), on ``device`` or else each template leaf's device.  The
        derived copies the template holds are made from the restored
        weights.  With a ``placement`` (a tree congruent with the
        template), each leaf is this rank's block under it on ``mesh``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        saved = T.trainable(template_state)
        with np.load(self.dir / f"step_{step:08d}" / "arrays.npz") as data:
            host = [self._leaf(data, path, t) for path, t in _flatten(saved)]
        whole = dict(_flatten(T.remake_derived(_rebuild(saved, iter(host)),
                                               template_state)))
        specs = dict(_flatten(placement)) if placement is not None else {}
        leaves = []
        for path, t in _flatten(template_state):
            block = BL.local_slice(whole.pop(path), specs.get(path, ()),
                                   mesh)
            leaves.append(block.to(device or t.device, copy=True))
        return _rebuild(template_state, iter(leaves)), step

    @staticmethod
    def _leaf(data, path, template: torch.Tensor) -> torch.Tensor:
        """The whole leaf at ``path`` on the host, in the template's
        dtype."""
        key = "__".join(path)
        if key in data:
            arr = data[key]
        else:       # the reference's stacked leaf: take this layer's row
            i = next((j for j, e in enumerate(path) if e.isdigit()), None)
            stacked_key = "__".join(path[:i] + path[i + 1:]) \
                if i is not None else None
            if stacked_key not in data:
                raise KeyError(f"checkpoint has no {SEP.join(path)!r}")
            arr = data[stacked_key][int(path[i])]
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{SEP.join(path)}: checkpoint shape "
                             f"{arr.shape}, template {tuple(template.shape)}")
        return torch.from_numpy(np.array(arr)).to(dtype=template.dtype)
