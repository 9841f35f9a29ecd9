"""The placement of every leaf against the reference's logical-axis
rules, in process, at full width (abstract shapes: the port's ``meta``
tensors, the reference's ``jax.eval_shape``).

For each of the ten arch ids and the mesh shapes {data 16, model 16},
{pod 2, data 16, model 16}, {data 2, model 2} and {data 4, model 1}, with
``fsdp`` on and off and ``moe_cap_axis`` "" and "data":

- every parameter leaf's placement (``build_train_step``'s on a
  ``MeshPlan``) equals the reference's ``spec_for`` over its stacked leaf
  less the leading ``layers`` entry (which never shards); the reference's
  rules come from its own ``launch.steps.make_rules`` on a stand-in mesh
  of that shape, as ``tests/test_sharding.py`` resolves specs from shape
  dicts without 256 devices;
- AdamW's per-layer moments the same way, Adafactor's stacked slots
  leaf for leaf, and each step counter replicated;
- the batch of train, prefill and decode steps;
- the per-rank bytes of bf16 weights plus AdamW state that chip_smoke's
  phase 19d prints for the production plans equal the count from the
  reference's specs.

Also ``shard`` (identity under a context, a wrong rank refused, a no-op
outside one), ``mesh_shape_dict`` of the production plans, and the
cache axes naming each pool dim as the reference names its cache dims.
"""
import functools
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs.base import RunConfig as RefRun  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import get_optimizer as ref_optimizer  # noqa: E402
from repro.sharding import logical as RLG  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.configs.base import SHAPES, RunConfig  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch.mesh import (MeshPlan, make_production_mesh,  # noqa: E402,E501
                                     mesh_shape_dict)
from repro_torch.models import decoding as D  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.sharding import context as SC  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model"))}
VARIANTS = [(fsdp, cap) for fsdp in (True, False) for cap in ("", "data")]


def _ref_mesh(shape, names):
    """What the reference's ``make_rules`` / ``mesh_shape_dict`` read of
    a mesh: its axis names and device array's shape."""
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch):
    model = RM.Model(ref_config(arch))
    aparams = model.abstract_params()
    opts = {n: jax.eval_shape(ref_optimizer(n).init, aparams)
            for n in ("adamw", "adafactor")}
    return model.param_axes(), aparams, opts


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _ref_specs(axes, abstract, rules, ms) -> dict:
    """{path: spec tuple} of the reference's leaves."""
    specs = RLG.tree_specs(axes, jax.tree.map(lambda a: tuple(a.shape),
                                              abstract), rules, ms)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}


def _port_specs(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() if key not in T.DERIVED
                for k, v in _port_specs(sub, prefix + (str(key),)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _port_specs(sub, prefix + (str(i),)).items()}
    return {"/".join(prefix): tuple(tree)}


def _assert_same(port: dict, ref: dict, stacked: bool):
    """Each port leaf's spec against the reference's: a per-layer leaf
    (a path with a layer index) against its stacked leaf less the
    leading ``layers`` entry, which must be replicated."""
    seen = set()
    for path, spec in port.items():
        parts = path.split("/")
        idx = [i for i, p in enumerate(parts) if p.isdigit()]
        if stacked and idx:
            key = "/".join(parts[:idx[0]] + parts[idx[0] + 1:])
            want = ref[key]
            assert want[0] is None, (key, want)
            want = want[1:]
        else:
            key, want = path, ref[path]
        assert spec == want, (path, spec, want)
        seen.add(key)
    assert seen == set(ref), set(ref) ^ seen


def _runs(arch, fsdp, cap, shape="train_4k", optimizer="adamw"):
    kw = dict(fsdp=fsdp, moe_cap_axis=cap, optimizer=optimizer)
    return (RunConfig(model=get_config(arch), shape=SHAPES[shape], **kw),
            RefRun(model=ref_config(arch), shape=REF_SHAPES[shape], **kw))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placements_match_reference(arch, mesh):
    shape, names = MESHES[mesh]
    plan, rmesh = MeshPlan(shape, names), _ref_mesh(shape, names)
    ms = mesh_shape_dict(plan)
    p_axes, aparams, aopts = _ref_abstract(arch)
    for fsdp, cap in VARIANTS:
        for opt in ("adamw", "adafactor"):
            run, rrun = _runs(arch, fsdp, cap, optimizer=opt)
            rules = ref_steps.make_rules(rrun, rmesh)
            assert S.make_rules(run, plan) == rules
            built = S.build_train_step(run, plan)
            state = built.in_shardings[0]
            if opt == "adamw":
                _assert_same(_port_specs(state["params"]),
                             _ref_specs(p_axes, aparams, rules, ms), True)
                ref_m = _ref_specs(p_axes, aopts[opt]["m"], rules, ms)
                for k in ("m", "v"):
                    _assert_same(_port_specs(state["opt"][k]), ref_m, True)
            else:
                ref_axes = ref_optimizer(opt).state_axes(p_axes)["slots"]
                _assert_same(_port_specs(state["opt"]["slots"]),
                             _ref_specs(ref_axes, aopts[opt]["slots"],
                                        rules, ms), False)
            assert state["opt"]["step"] == ()
            rcfg = rrun.model
            want = {k: tuple(RLG.spec_for(a, tuple(v.shape), rules, ms))
                    for k, a in RM.batch_axes(rcfg, rrun.shape).items()
                    for v in [RM.input_specs(rcfg, rrun.shape)[k]]}
            got = {k: v for k, v in built.in_shardings[1].items()
                   if k in want}
            assert got == want
        for kind in ("prefill_32k", "decode_32k"):
            run, rrun = _runs(arch, fsdp, cap, shape=kind)
            rules = ref_steps.make_rules(rrun, rmesh)
            rcfg = rrun.model
            built = S.build_step(run, plan)
            specs = RM.input_specs(rcfg, rrun.shape)
            want = {k: tuple(RLG.spec_for(a, tuple(specs[k].shape), rules,
                                          ms))
                    for k, a in RM.batch_axes(rcfg, rrun.shape).items()}
            if kind.startswith("decode"):
                assert {"tokens": built.in_shardings[2]} == want
            else:
                assert built.in_shardings[1] == want


def _ref_bytes(arch, multi_pod):
    """Per-rank bytes of bf16 weights + AdamW state from the reference's
    specs on its production mesh shape."""
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    ms = dict(zip(names, shape))
    rrun = RefRun(model=ref_config(arch), shape=REF_SHAPES["train_4k"])
    rules = ref_steps.make_rules(rrun, _ref_mesh(shape, names))
    p_axes, aparams, aopts = _ref_abstract(arch)
    total = 0
    for axes, tree in ((p_axes, aparams), (p_axes, aopts["adamw"]["m"]),
                       (p_axes, aopts["adamw"]["v"])):
        specs = _ref_specs(axes, tree, rules, ms)
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        for path, a in leaves:
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            per = math.prod(n // math.prod(ms[x] for x in
                                           ((e,) if isinstance(e, str)
                                            else e or ()))
                            for n, e in zip(a.shape, specs[key]))
            total += per * a.dtype.itemsize
    return total + 4            # the step counter


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_rank_bytes_of_the_production_plans(arch, multi_pod):
    plan = make_production_mesh(multi_pod=multi_pod)
    run = RunConfig(model=get_config(arch), shape=SHAPES["train_4k"])
    assert S.per_rank_bytes(S.build_train_step(run, plan)) == \
        _ref_bytes(arch, multi_pod)


def test_production_plans():
    assert mesh_shape_dict(make_production_mesh()) == \
        {"data": 16, "model": 16}
    plan = make_production_mesh(multi_pod=True)
    assert mesh_shape_dict(plan) == {"pod": 2, "data": 16, "model": 16}
    assert plan.size == 512


def test_shard_is_identity_and_checks_rank():
    x = torch.zeros(4, 8)
    assert SC.shard(x, ("batch",)) is x          # no context: a no-op
    plan = MeshPlan((2, 2), ("data", "model"))
    run = RunConfig(model=get_reduced("qwen2_0_5b"),
                    shape=SHAPES["train_4k"])
    with SC.mesh_context(plan, S.make_rules(run, plan)):
        assert SC.shard(x, ("batch", "embed_act")) is x
        assert SC.current()[2] == {"data": 2, "model": 2}
        with pytest.raises(ValueError, match="rank 2"):
            SC.shard(x, ("batch",))
        assert SC.batch_group() is None
    assert SC.current() is None


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axes_cover_the_cache(arch):
    """``Model.cache_axes`` has one entry per dim of every cache tensor,
    naming the KV-head and head dims as the reference's cache does."""
    cfg = get_reduced(arch)
    model = Model(cfg, device="cpu")
    cache = model.init_cache(2, 32, enc_seq=16 if cfg.family == "audio"
                             else 0)
    tensors, axes = _port_specs(D.cache_tree(cache)), {}
    flat = []

    def walk(t, a, path=()):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], a[k], path + (k,))
        else:
            flat.append((path, t, a))
    walk(D.cache_tree(cache), model.cache_axes())
    assert flat and len(flat) == len(tensors)
    for path, t, a in flat:
        assert len(a) == t.ndim, (path, a, tuple(t.shape))
        axes[path[-1]] = a
    if "v_pages" in axes:
        assert axes["v_pages"][-2:] == ("kv_heads", "head_dim")
    if cfg.mla:
        assert axes["k_pages"][-1] == "lora"
