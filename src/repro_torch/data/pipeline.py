"""Deterministic synthetic data pipeline, the reference's.

- ``SyntheticCorpus.batch(step)`` is a pure function of (seed, step),
  numpy, bit for bit the reference's batches: after a restart the stream
  resumes from the checkpointed step with no loader state to save.
- ``DeviceLoader`` makes the batches ahead on a host thread and puts each
  on the trainer's device.  With a mesh and its batch placement
  (``launch.steps``; the reference's ``ShardedLoader``) each rank takes
  its block of every array: its rows, over the ``batch`` axes
  ``("pod", "data")``; the ``model`` ranks of one data index take the
  same rows, and a batch that the placement does not split (a batch the
  data extent does not divide) is whole on every rank, not padded.

The corpus is a Zipf-distributed token stream with injected
(copy/induction) structure so that small models learn something
measurable.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.sharding.blocks import ONE_RANK, local_slice


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.2
    induction: bool = True     # repeat-structure so loss can fall


class SyntheticCorpus:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> dict:
        """Deterministic (tokens, labels), int32 (B, T), for this global
        step."""
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step]))
        v = max(c.vocab_size - 2, 2)
        z = rng.zipf(c.zipf_a, size=(c.global_batch, c.seq_len + 1))
        toks = (z % v).astype(np.int32) + 1
        if c.induction and c.seq_len >= 8:
            # copy structure: second half repeats the first half
            half = (c.seq_len + 1) // 2
            toks[:, half:2 * half] = toks[:, :half]
        return {"tokens": toks[:, :-1],
                "labels": toks[:, 1:].astype(np.int32)}


class DeviceLoader:
    """Iterates ``(step, batch)`` from ``start_step`` on, each batch's
    arrays as tensors on ``device`` (with a ``placement``, {key: spec},
    this rank's blocks of them on ``mesh``); a host thread keeps up to
    ``prefetch`` batches ready, and an error it meets is raised by the
    next ``next()``.  ``close()`` stops the thread."""

    def __init__(self, corpus: SyntheticCorpus, device, start_step: int = 0,
                 prefetch: int = 2, mesh=ONE_RANK, placement=None):
        self.corpus = corpus
        self.device = torch.device(device)
        self.mesh, self.placement = mesh, placement
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, args=(start_step,),
                                        daemon=True)
        self._thread.start()

    def _fill(self, step: int):
        while not self._stop.is_set():
            try:
                host = self.corpus.batch(step)
                if self.placement is not None:
                    host = {k: np.ascontiguousarray(local_slice(
                        v, self.placement[k], self.mesh))
                        for k, v in host.items()}
                item = (step, {k: torch.from_numpy(v).to(self.device)
                               for k, v in host.items()})
            except Exception as e:     # raised again by __next__
                item = e
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple]:
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        self._thread.join()


def make_loader(model_cfg: ModelConfig, shape: ShapeConfig, device,
                start_step: int = 0, seed: int = 1234, mesh=ONE_RANK,
                placement=None) -> DeviceLoader:
    corpus = SyntheticCorpus(DataConfig(
        vocab_size=model_cfg.vocab_size, seq_len=shape.seq_len,
        global_batch=shape.global_batch, seed=seed))
    return DeviceLoader(corpus, device, start_step, mesh=mesh,
                        placement=placement)
