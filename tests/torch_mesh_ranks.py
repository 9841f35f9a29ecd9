"""Rank bodies of ``tests/test_torch_mesh.py``.

``start(job, world, tmp, inputs)`` saves ``inputs`` (a dict) into
``tmp`` and starts ``world`` processes (``spawn``, not ``fork``), each of
which joins a gloo group through a ``FileStore`` in ``tmp`` (a
rendezvous of the test's own), runs ``job(rank, **inputs)`` with one
intra-op thread and leaves the group; ``result()`` of what it returns
waits for them and hands back rank 0's return value (``spawn`` does
both).  A rank that raises fails ``result()`` with its traceback, and a
run that outlives ``timeout`` seconds from its start is killed and
fails.  This module imports no JAX: the test holds what the ranks
return against the reference, which it runs while they do.
"""
from __future__ import annotations

import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

LR = dict(lr_base=3e-3, lr_warmup=2, lr_total=100)


def _entry(rank, world, tmp, job):
    torch.set_num_threads(1)
    tmp = Path(tmp)
    dist.init_process_group("gloo",
                            store=dist.FileStore(str(tmp / "store"), world),
                            rank=rank, world_size=world)
    try:
        res = job(rank, **torch.load(tmp / "inputs.pt", weights_only=False))
        if rank == 0:
            torch.save(res, tmp / "rank0.pt")
    finally:
        dist.destroy_process_group()


class Ranks:
    """Ranks started by ``start``."""

    def __init__(self, ctx, tmp: Path, what: str, timeout: float):
        self.ctx, self.tmp, self.what = ctx, tmp, what
        self.timeout = timeout
        self.deadline = time.monotonic() + timeout

    def result(self):
        while not self.ctx.join(timeout=1.0):
            if time.monotonic() > self.deadline:
                for p in self.ctx.processes:
                    p.kill()
                raise TimeoutError(f"{self.what} outlived {self.timeout} s")
        return torch.load(self.tmp / "rank0.pt", weights_only=False)


def start(job, world: int, tmp: Path, inputs: dict,
          timeout: float = 240.0) -> Ranks:
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, tmp / "inputs.pt")
    ctx = mp.start_processes(_entry, args=(world, str(tmp), job),
                             nprocs=world, join=False, start_method="spawn")
    return Ranks(ctx, tmp, f"{job.__name__} on {world} ranks", timeout)


def spawn(job, world: int, tmp: Path, inputs: dict,
          timeout: float = 240.0):
    return start(job, world, tmp, inputs, timeout).result()


# ------------------------------------------------------------- helpers
def _run(cfg, opt="adamw", compression=False, local=False, seq=32,
         batch=4, remat="none"):
    from repro_torch.configs.base import RunConfig, ShapeConfig
    return RunConfig(model=cfg, shape=ShapeConfig("t", "train", seq, batch),
                     remat=remat, optimizer=opt,
                     gradient_compression=compression,
                     moe_local_dispatch=local)


def _local_batch(batch, built):
    from repro_torch.sharding.blocks import local_slice
    pl = built.in_shardings[1]
    return {k: local_slice(v, pl[k], built.mesh).contiguous()
            for k, v in batch.items()}


def _meshless_state(run, params):
    from repro_torch.models import transformer as T
    from repro_torch.optim import get_optimizer
    from repro_torch.runtime import compression as GC
    w = T.trainable(params)
    state = {"params": params,
             "opt": get_optimizer(run.optimizer).init(w)}
    if run.gradient_compression:
        state["ef"] = GC.init_ef(w)
    return state


def _bytes(tree) -> int:
    from repro_torch.models.params import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _expected_bytes(built) -> tuple:
    """(the bytes of this rank's blocks of the state's leaves, the bytes
    of the whole leaves), the derived copies left out."""
    from repro_torch.launch.steps import per_rank_bytes
    from repro_torch.models import transformer as T
    return (per_rank_bytes(built),
            _bytes(T.trainable(built.abstract_inputs[0])))


def _adamw_gradient(opt, grad_norm):
    """The gradient an AdamW step reduced, read from its state ``opt``
    after its first step: the first moment over (1 - b1) times the
    clipping factor of ``grad_norm``."""
    from repro_torch.models.params import tree_map
    from repro_torch.optim import AdamW
    clip = min(1.0, AdamW.clip_norm / grad_norm)
    return tree_map(lambda m: m / ((1 - AdamW.b1) * clip), opt["m"])


def _first_gradients(rank, run, mesh, params, batch):
    """(the whole gradient the mesh's step reduced, on rank 0 the
    one-rank step's) of ``batch`` from ``params``, each read from an
    AdamW step's state (``_adamw_gradient``): the gradient does not
    depend on the optimizer, which an Adafactor run's state does not
    show."""
    import dataclasses
    from repro_torch.launch import steps as S
    from repro_torch.sharding.blocks import gather_tree
    run = dataclasses.replace(run, optimizer="adamw")
    built = S.build_train_step(run, mesh, **LR)
    state, m = built.fn(S.init_sharded_state(built, _clone(params)),
                        _local_batch(batch, built))
    got = _adamw_gradient(gather_tree(
        state["opt"], built.in_shardings[0]["opt"], mesh),
        float(m["grad_norm"]))
    if rank != 0:
        return got, None
    state, m = S.build_train_step(run, "cpu", **LR)(
        _meshless_state(run, _clone(params)), batch)
    return got, _adamw_gradient(state["opt"], float(m["grad_norm"]))


def train_against_meshless(rank, cfg, shape, params, batches, run_kw):
    """Steps of the train step on a ``shape`` mesh and, on rank 0, of the
    one-rank step, from the same weights and batches.  Returns the
    per-step metrics of both, the whole weights after each step of both
    runs, the whole optimizer state after the mesh's first step, the
    gradient of the first batch the mesh reduced and the one-rank
    step's (``_first_gradients``), the ``model`` extent the step split
    its layers over, and each rank's state bytes beside its blocks' due
    bytes."""
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.sharding.blocks import gather_tree
    run = _run(cfg, **run_kw)
    mesh = make_host_mesh(*shape, device="cpu")
    built = S.build_train_step(run, mesh, **LR)
    w_pl = T.trainable(built.in_shardings[0]["params"])
    state = S.init_sharded_state(built, _clone(params))
    got, whole = [], []
    for b in batches:
        state, m = built.fn(state, _local_batch(b, built))
        got.append({k: float(v) for k, v in m.items()})
        whole.append(_clone(gather_tree(T.trainable(state["params"]), w_pl,
                                        mesh)))
        if len(got) == 1:
            opt0 = _clone(gather_tree(state["opt"],
                                      built.in_shardings[0]["opt"], mesh))
    mine = (_bytes(T.trainable(state)),) + _expected_bytes(built)
    grads = _first_gradients(rank, run, mesh, params, batches[0])
    sizes = [None] * dist.get_world_size()
    dist.all_gather_object(sizes, mine)
    if rank != 0:
        return None
    step = S.build_train_step(run, "cpu", **LR)
    ref_state = _meshless_state(run, _clone(params))
    want, meshless = [], []
    for b in batches:
        ref_state, m = step(ref_state, b)
        want.append({k: float(v) for k, v in m.items()})
        meshless.append(_clone(T.trainable(ref_state["params"])))
    return {"got": got, "want": want, "sizes": sizes, "params": whole,
            "meshless": meshless, "opt0": opt0, "grad0": grads,
            "tensor_parallel": built.tensor_parallel}


def _clone(tree):
    from repro_torch.models.params import tree_map
    return tree_map(lambda t: t.clone(), tree)


def meshes_and_psum(rank, cases, psum_inputs):
    """Job of the four-rank tests: each (name, cfg, shape, params,
    batches) case against meshless, then ``compressed_psum`` of rank r's
    ``psum_inputs[r]`` over ``data`` on a (4, 1) mesh, every rank's
    result kept."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.compression import compressed_psum
    out = {name: train_against_meshless(rank, cfg, shape, params, batches,
                                        {})
           for name, cfg, shape, params, batches in cases}
    mesh = make_host_mesh(4, 1, device="cpu")
    y = compressed_psum(psum_inputs[rank], "data", mesh)
    ys = [None] * dist.get_world_size()
    dist.all_gather_object(ys, y)
    out["psum"] = ys
    return out


def batch_split(rank, cases, moe_global):
    """Job of the two-rank tests: each (name, cfg, params, batches,
    run_kw) case on a (2, 1) mesh against meshless; then the MoE model
    ``moe_global`` (cfg, params, batch) with global dispatch, whose step
    must raise."""
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    out = {name: train_against_meshless(rank, cfg, (2, 1), params, batches,
                                        run_kw)
           for name, cfg, params, batches, run_kw in cases}
    cfg, params, batch = moe_global
    built = S.build_train_step(_run(cfg), make_host_mesh(2, 1, device="cpu"),
                               **LR)
    state = S.init_sharded_state(built, params)
    try:
        built.fn(state, _local_batch(batch, built))
        out["moe_global"] = None
    except ValueError as e:
        out["moe_global"] = str(e)
    return out


def elastic(rank, cfg, ckpt_dir):
    """The reference's elastic test (``tests/test_system.py``): a Trainer
    on (2, 2) for 8 steps with a checkpoint every 4, then one on (4, 1)
    that restores step 7 and runs to 12, then one on (2, 2) again that
    restores step 11.  Returns the losses and each restore's gathered
    state; rank 0 also restores step 11 with no mesh."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.sharding.blocks import gather_tree
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    run = RunConfig(model=cfg, shape=ShapeConfig("t", "train", 32, 4),
                    remat="none")
    tc = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=4, lr_base=5e-3,
                       lr_warmup=2)

    def trainer(shape):
        return Trainer(run, tc, device="cpu",
                       mesh=make_host_mesh(*shape, device="cpu"))

    def restored(tr):
        state, start = tr.restore_or_init()
        pl = T.trainable(tr.placement[0])
        return start, gather_tree(T.trainable(state), pl, tr.mesh)

    out = {"a": trainer((2, 2)).train(8)}
    tr_b = trainer((4, 1))
    out["b_start"], out["b_state"] = restored(tr_b)
    out["b"] = tr_b.train(12)
    out["c_start"], out["c_state"] = restored(trainer((2, 2)))
    if rank == 0:
        tr = Trainer(run, tc, device="cpu")
        state, out["meshless_start"] = tr.restore_or_init()
        out["meshless_state"] = T.trainable(state)
    return out
