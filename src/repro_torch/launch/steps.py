"""Step builders: the train step, and the prefill and decode steps, with
the placement of every input leaf derived from its logical axes, as the
reference's ``launch/steps.py``.

``build_train_step(run, mesh)``, ``build_prefill_step(run, mesh)`` and
``build_decode_step(run, mesh)`` return a ``BuiltStep``: ``fn``, the
placement trees of its inputs and outputs (per leaf,
``sharding.logical.spec_for``'s tuple over the leaf's per-layer shape,
under ``make_rules``), and ``meta``-device stand-ins of its whole
inputs.  With a plan of more than one rank (the production mesh) only
the placements are real, and calling ``fn`` raises.  Called with a
device instead of a mesh, ``build_train_step(run, device)`` returns the
bare ``fn`` of the same step on the local one-rank layout
(``sharding.blocks.ONE_RANK``: nothing split, no process group).

The train step is sharded data parallelism over the placements, with
tensor parallelism over ``model`` in the dense and vlm families: each
rank holds its block of every parameter, optimizer-state and
error-feedback leaf (``state = {"params", "opt"}``, and ``"ef"`` with
gradient compression), and its rows of the batch (split over the axes
the ``batch`` placement gives, ``("pod", "data")`` by default; the
``model`` ranks of one data index take the same rows).

In the dense and vlm families a weight leaf whose placement splits a
dim over a ``model`` of more than one rank (``heads`` / ``kv_heads`` of
the attention, ``mlp``, ``vocab``) is read by a tensor-parallel layer
(``sharding.tensor_parallel``): the rank computes with its ``model``
block, and the layers' all-reduces over ``model`` make the activations
and the loss those of the whole model on every rank
(``tensor_parallel_leaves``).  A layer whose leaves no placement splits
over ``model`` (14 heads on 16 ranks) runs whole on every rank.  Every
other family gathers every leaf whole, and every rank runs every GEMM
whole.  A step

1. gathers the bf16 weights on each rank (``blocks.gather``; a leaf no
   placement splits is used as it is): with AdamW a tensor-parallel
   leaf over the placement's other axes only (its ``model`` block,
   whole over ``data`` / ``pod``), every other leaf whole;
2. takes the loss and its gradients by autograd (``loss_and_grads``;
   every GEMM's backward products on the streaming GEMM kernel).  When
   the batch rows are split over more than one rank, what is
   differentiated is the rank's share of the global loss: its summed
   token cross-entropy over the global count of valid labels (and so
   for the MTP loss), plus the MoE aux term, whose means the MoE layers
   take over the whole batch (``models.moe``); the gradients are then
   summed over the batch ranks in fp32 (one ``all_reduce`` of one flat
   buffer), which gives the gradient of the whole batch.  On one rank
   no collective runs and the gradients stay in the weights' dtypes.
   The K/V leaves of an attention whose query heads ``model`` splits
   and whose KV heads it does not (``partial_kv_leaves``) get each
   rank's share of their gradient, summed over ``model`` in fp32 (one
   more ``all_reduce``);
3. runs INT8 compression with error feedback, when
   ``run.gradient_compression``, on the whole gradient with the gathered
   error feedback, so its codes are those of one device (the
   tensor-parallel leaves' gradients gathered whole over ``model``
   before the batch ranks' sum, one ``all_gather``);
4. updates: AdamW each rank's blocks in place, with the clipping factor
   of the whole gradient (the squares of ``model`` blocks summed over
   ``model``); Adafactor whole leaves from the gathered slots (its
   factored statistics and update clipping reduce over whole stacked
   leaves; the weights are gathered whole at step 1 and a
   tensor-parallel layer reads its ``model`` block as a view, the
   gradients gathered whole over ``model`` as for compression), each
   rank keeping its blocks;
5. makes an MLA model's absorbed copies of ``wuk`` / ``wuv``
   (``transformer.DERIVED``) again from the gathered updated weights,
   so that a model trained and then served decodes with its trained
   weights; the copies are never split, and the gradients, optimizer
   state and error feedback hold the reference's leaves only
   (``transformer.trainable``).

``metrics`` holds ``ce``, ``aux`` (and ``mtp`` for a config with an MTP
head), ``loss``, ``lr`` and ``grad_norm`` as scalar tensors on the
device, the global values on every rank.  The run's chunk knobs are the
model's ``Tuning`` while the step runs.  The state's placements are the
same with and without tensor parallelism, so checkpoints and their
restore onto another mesh do not change.

The prefill and decode steps run ``Model.prefill`` / ``decode_step``
over a paged cache the prefill step makes (slots ``arange(B)``, room
for ``shape.seq_len`` tokens a slot, 16-token pages); the decode step
returns the greedy next token over the real vocabulary.  They run on
one rank (serving on more ranks is not in the port).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import tuning as TU
from repro_torch.models.model import Model, batch_axes, input_specs
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import cosine_schedule, get_optimizer
from repro_torch.optim.optimizers import clip_scale
from repro_torch.runtime import compression as GC
from repro_torch.sharding import blocks as BL
from repro_torch.sharding import logical as LG
from repro_torch.sharding.context import mesh_context

SERVE_PAGE_TOKENS = 16      # the serving engine's page: 4 KB at KH 2, hd 64


@dataclasses.dataclass
class BuiltStep:
    fn: Callable                 # the step
    in_shardings: Any            # placement trees of fn's inputs
    out_shardings: Any           # ... and of its outputs (None: replicated)
    abstract_inputs: tuple       # meta tensors of the whole inputs
    donate_argnums: tuple = ()
    mesh: Any = None
    cfg: Any = None              # the model's config
    # the model extent a tensor-parallel layer splits its leaves over
    # (``tensor_parallel_leaves``), or 1
    tensor_parallel: int = 1


def run_tuning(run: RunConfig) -> TU.Tuning:
    """The model's ``Tuning`` for ``run`` (the reference's
    ``_run_tuning``)."""
    return TU.Tuning(q_chunk=run.q_chunk, kv_chunk=run.kv_chunk,
                     ce_chunk=run.ce_chunk, ssm_chunk=run.ssm_chunk,
                     kv_cache_quant=run.kv_cache_quant,
                     moe_cap_axis=run.moe_cap_axis or None,
                     moe_local_dispatch=run.moe_local_dispatch)


def _ctx_wrap(fn, mesh, rules, run=None, batch_group=None):
    """``fn`` run under the mesh context (``sharding.context``) and the
    run's ``Tuning``."""
    t = run_tuning(run) if run is not None else TU.Tuning()

    @functools.wraps(fn)
    def wrapper(*a, **k):
        with mesh_context(mesh, rules, batch_group), TU.tuning_context(t):
            return fn(*a, **k)
    return wrapper


def make_rules(run: RunConfig, mesh):
    """The reference's rule table for ``run`` on ``mesh`` (a
    ``DeviceMesh``, a ``MeshPlan`` or a shape mapping): long-context
    overrides for ``long_500k`` and for decode batches smaller than the
    data extent, ``moe_cap`` over ``run.moe_cap_axis``, and no FSDP
    ``embed`` split without ``run.fsdp``."""
    ms = BL.mesh_shape_dict(mesh)
    long_ctx = run.shape.name == "long_500k" or (
        run.shape.is_decode and run.shape.global_batch < ms.get("data", 1))
    overrides = {}
    if run.moe_cap_axis:
        overrides["moe_cap"] = (run.moe_cap_axis,)
    if not run.fsdp:
        overrides["embed"] = ()
    return LG.make_rules("pod" in ms, long_context=long_ctx,
                         overrides=overrides)


def shapes_of(tree):
    return tree_map(lambda t: tuple(t.shape), tree)


def placements(axes_tree, shapes_tree, rules, mesh):
    """Per leaf, ``spec_for(axes, shape)`` (the reference's
    ``_shardings``, a tree of spec tuples)."""
    ms = BL.mesh_shape_dict(mesh)
    return tree_map(lambda ax, shp: LG.spec_for(ax, tuple(shp), rules, ms),
                    axes_tree, shapes_tree)


def _with_derived(axes, abstract):
    """``axes`` with an entry of ``None`` per dim for each derived copy
    (``transformer.DERIVED``) that ``abstract`` holds: never split."""
    if isinstance(abstract, dict):
        return {k: (None,) * abstract[k].ndim if k in T.DERIVED
                else _with_derived(axes[k], v) for k, v in abstract.items()}
    if isinstance(abstract, list):
        return [_with_derived(a, v) for a, v in zip(axes, abstract)]
    return axes


def init_sharded_state(built: BuiltStep, params):
    """A mesh train step's first state: each rank's blocks of the whole
    weights ``params`` (on every rank alike, with or without the derived
    copies) and zeros for the optimizer state and error feedback."""
    astate, pl = built.abstract_inputs[0], built.in_shardings[0]
    dev = tree_leaves(params)[0].device
    state = {k: BL.local_zeros(v, pl[k], built.mesh, dev)
             for k, v in astate.items() if k != "params"}
    params = T.add_derived(T.trainable(params), built.cfg)
    state["params"] = BL.shard_tree(params, pl["params"], built.mesh)
    return state


def per_rank_bytes(built: BuiltStep) -> int:
    """The bytes of one rank's blocks of a train step's state (weights,
    optimizer state, error feedback; the derived copies left out), from
    its placements: the same on every rank, since a split divides."""
    ms = BL.mesh_shape_dict(built.mesh)
    out = []
    tree_map(lambda a, spec: out.append(
        math.prod(BL.local_shape(spec, tuple(a.shape), ms))
        * a.element_size()), T.trainable(built.abstract_inputs[0]),
        T.trainable(built.in_shardings[0]))
    return sum(out)


# =====================================================================
# train
# =====================================================================
TP_FAMILIES = ("dense", "vlm")


def tensor_parallel_leaves(cfg, w_pl, mesh):
    """Per leaf of the trainable weights' placement ``w_pl``: True where a
    tensor-parallel layer reads the leaf's ``model`` block (module
    docstring): a dense or vlm model, a ``model`` of more than one rank,
    and a placement that splits a dim over it."""
    on = cfg.family in TP_FAMILIES and \
        BL.mesh_shape_dict(mesh).get("model", 1) > 1
    return tree_map(lambda spec: on and any(
        "model" in BL.dim_axes(e) for e in spec), w_pl)


def partial_kv_leaves(tp):
    """Per leaf of ``tensor_parallel_leaves``' tree: True for the K/V
    leaves (``wk``, ``wv``, ``bk``, ``bv``) of an attention whose query
    heads are split and whose KV heads are not: each rank's gradient of
    them is its query heads' share."""
    if isinstance(tp, list):
        return [partial_kv_leaves(t) for t in tp]
    if not isinstance(tp, dict):
        return False
    out = {k: partial_kv_leaves(v) for k, v in tp.items()}
    if tp.get("wq") is True and tp.get("wk") is False:
        out.update({k: True for k in ("wk", "wv", "bk", "bv") if k in tp})
    return out


def _gather_split(tree, flags, placement, mesh, axes, rest_whole=False):
    """``tree`` with the leaves where ``flags`` is True gathered over
    ``axes`` and, with ``rest_whole``, the others whole over every axis
    (``blocks.gather``; one call for each set)."""
    leaves, marks = tree_leaves(tree), BL.tree_leaves_of(flags, tree)
    specs = BL.tree_leaves_of(placement, tree)
    out = list(leaves)
    for want, ax in ((True, axes), (False, None)):
        if not (want or rest_whole):
            continue
        at = [i for i, m in enumerate(marks) if m is want]
        got = BL.gather([leaves[i] for i in at], [specs[i] for i in at],
                        mesh, ax)
        for i, g in zip(at, got):
            out[i] = g
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def loss_and_grads(model: Model, params, batch, objective=None):
    """((loss, metrics), grads): the gradients congruent with
    ``transformer.trainable(params)`` (the reference's leaves, without
    the decode path's derived copies), in the parameters' dtypes (zeros
    for a leaf the loss does not reach).  ``objective(loss, metrics)``,
    when given, is what is differentiated and returned in place of
    ``Model.loss``'s total."""
    leaves = []

    def watch(p):
        p = p.detach().requires_grad_(True)
        leaves.append(p)
        return p

    params = T.trainable(params)
    loss, metrics = model.loss(tree_map(watch, params), batch)
    if objective is not None:
        loss = objective(loss, metrics)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), \
        tree_map(lambda _: next(it), params)


def build_train_step(run: RunConfig, mesh=None, lr_base: float = 3e-4,
                     lr_warmup: int = 200, lr_total: int = 10000,
                     device=None):
    """The train step (module docstring) on ``mesh``, a ``DeviceMesh`` or
    a ``MeshPlan``: a ``BuiltStep`` (the reference's call).  With None or
    a device in ``mesh``'s place (the port's call
    ``build_train_step(run, device)``), the bare step on the local
    one-rank layout on that device, ``"cuda"`` by default, which raises
    without a card."""
    if mesh is None or isinstance(mesh, (str, torch.device)):
        if mesh is not None and device is not None:
            raise ValueError("build_train_step: a device given twice")
        return build_train_step(run, BL.ONE_RANK, lr_base, lr_warmup,
                                lr_total, device or mesh or "cuda").fn
    cfg = run.model
    dev = mesh_device(mesh, device)
    model = Model(cfg, device=dev, remat=run.remat)
    opt = get_optimizer(run.optimizer)
    lr_fn = cosine_schedule(lr_base, lr_warmup, lr_total)
    rules = make_rules(run, mesh)

    aparams = T.add_derived(Model(cfg, device="meta").abstract_params(), cfg)
    p_axes = model.param_axes()
    astate = {"params": aparams, "opt": opt.init(T.trainable(aparams))}
    state_ax = {"params": _with_derived(p_axes, aparams),
                "opt": opt.state_axes(p_axes)}
    if run.gradient_compression:
        astate["ef"] = GC.init_ef(T.trainable(aparams))
        state_ax["ef"] = p_axes
    state_pl = placements(state_ax, shapes_of(astate), rules, mesh)
    ainputs = input_specs(cfg, run.shape)
    b_axes = batch_axes(cfg, run.shape)
    if "embeddings" in ainputs:     # a vlm trains on ids or embeddings
        ainputs["tokens"] = torch.empty(ainputs["labels"].shape,
                                        dtype=torch.int32, device="meta")
        b_axes["tokens"] = ("batch", "seq")
    batch_pl = placements(b_axes, shapes_of(ainputs), rules, mesh)
    split = _batch_split(batch_pl)
    group = BL.axis_group(mesh, split) if split else None
    w_pl = T.trainable(state_pl["params"])
    tp = tensor_parallel_leaves(cfg, w_pl, mesh)
    tp_on = any(tree_leaves(tp))
    ms = BL.mesh_shape_dict(mesh)
    rest = tuple(a for a in ms if a != "model")
    m_group = BL.axis_group(mesh, "model") if tp_on else None
    partial = partial_kv_leaves(tp)
    gather_grads = run.gradient_compression or not opt.elementwise

    def train_step(state, batch):
        BL.require_runnable(mesh, "train step", tree_leaves(state)[0])
        weights = T.trainable(state["params"])
        if tp_on and opt.elementwise:
            whole = _gather_split(weights, tp, w_pl, mesh, rest, True)
        else:       # whole for the update; a layer reads its model block
            whole = full = BL.gather_tree(weights, w_pl, mesh)
            if tp_on:
                whole = tree_map(lambda w, spec, t: BL.local_slice(
                    w, spec, mesh, axes=("model",)) if t else w,
                    full, w_pl, tp)
        # the split gradients gathered whole over ``model`` (before the
        # batch ranks' sum, in the weights' dtype) where the update or the
        # compression reads whole leaves
        whole_grads = (lambda g: _gather_split(g, tp, w_pl, mesh, (
            "model",))) if tp_on and gather_grads else (lambda g: g)
        if group is None:
            (loss, metrics), grads = loss_and_grads(model, whole, batch)
            grads = whole_grads(grads)
        else:
            loss, metrics, grads = _split_loss_and_grads(
                model, whole, batch, group, whole_grads)
        if tp_on:
            grads = _sum_partial(grads, partial, m_group)
        new_state = dict(state)
        if run.gradient_compression:
            ef = BL.gather_tree(state["ef"], state_pl["ef"], mesh)
            grads, ef = GC.apply_compression(grads, ef)
            new_state["ef"] = BL.shard_tree(ef, state_pl["ef"], mesh)
        lr = lr_fn(state["opt"]["step"])
        if opt.elementwise:
            local = tp_on and not gather_grads
            clip = clip_scale(grads, opt.clip_norm,
                              (tp, m_group) if local else None)
            mine = tree_map(lambda g, spec, t: BL.local_slice(
                g, spec, mesh, axes=rest if local and t else None),
                grads, w_pl, tp)
            _, new_state["opt"], om = opt.update(mine, state["opt"],
                                                 weights, lr, clip=clip)
        else:
            o_pl = state_pl["opt"]
            whole_opt = {**state["opt"], "slots": BL.gather_tree(
                state["opt"]["slots"], o_pl["slots"], mesh)}
            _, whole_opt, om = opt.update(grads, whole_opt, full, lr)
            _keep_blocks(weights, full, w_pl, mesh)
            _keep_blocks(state["opt"]["slots"], whole_opt["slots"],
                         o_pl["slots"], mesh)
            new_state["opt"] = {**state["opt"], "step": whole_opt["step"]}
        if cfg.mla:
            remake_derived(state["params"], state_pl["params"], mesh, cfg)
        return new_state, {**metrics, **om, "loss": loss, "lr": lr}

    return BuiltStep(
        fn=_ctx_wrap(train_step, mesh, rules, run, group),
        in_shardings=(state_pl, batch_pl),
        out_shardings=(state_pl, None),
        abstract_inputs=(astate, ainputs), donate_argnums=(0,), mesh=mesh,
        cfg=cfg,
        tensor_parallel=ms.get("model", 1) if tp_on else 1)


def mesh_device(mesh, device=None) -> torch.device:
    """The device a mesh's ranks compute on: a live mesh's (a ``device``
    given beside it must agree), ``device`` (``"cuda"`` by default) on
    the local one-rank layout, ``meta`` for a plan of more ranks."""
    if BL.is_local(mesh):
        return resolve_device(device or "cuda")
    if not BL.is_live(mesh):
        return torch.device("meta")
    dev = resolve_device(mesh.device_type)
    if device is not None and resolve_device(device).type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh and device {device}")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _batch_split(pl_batch):
    """The mesh axes the batch rows are split over (those of the first
    dim of the labels' placement)."""
    return BL.dim_axes(pl_batch["labels"][0])


def _split_loss_and_grads(model, whole, batch, group, prepare):
    """(loss, metrics, grads) of the whole batch from this rank's rows,
    the batch rows split over the ranks of ``group`` (module docstring,
    step 2): the gradients fp32 (``prepare(grads)`` summed), the metrics
    the global ones."""
    labels = batch["labels"]
    counts = torch.stack([(labels >= 0).sum(),
                          (labels[:, 1:] >= 0).sum()]).float()
    local = counts.clone()
    BL.all_reduce(counts, group)
    share = local / torch.clamp(counts, min=1.0)

    def objective(_, m):
        out = m["ce"] * share[0] + m["aux"]
        if "mtp" in m:
            out = out + 0.3 * (m["mtp"] * share[1])
        return out

    (_, metrics), grads = loss_and_grads(model, whole, batch, objective)
    grads = prepare(grads)
    it = iter(_flat_all_reduce(tree_leaves(grads), group))
    grads = tree_map(lambda _: next(it), grads)
    parts = [metrics["ce"] * share[0]]
    if "mtp" in metrics:
        parts.append(metrics["mtp"] * share[1])
    parts = torch.stack(parts)
    BL.all_reduce(parts, group)
    metrics = {**metrics, "ce": parts[0]}
    loss = parts[0] + metrics["aux"]
    if "mtp" in metrics:
        metrics["mtp"] = parts[1]
        loss = loss + 0.3 * parts[1]
    return loss, metrics, grads


def _flat_all_reduce(tensors, group):
    """fp32 copies of ``tensors`` summed over ``group`` (one
    ``all_reduce`` of one flat buffer); views into that buffer."""
    flat = torch.cat([t.float().reshape(-1) for t in tensors])
    BL.all_reduce(flat, group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def _sum_partial(grads, partial, group):
    """``grads`` with the leaves where ``partial`` is True summed over
    ``group`` in fp32 (one ``all_reduce`` of one flat buffer), when
    there are any."""
    leaves, marks = tree_leaves(grads), BL.tree_leaves_of(partial, grads)
    at = [i for i, m in enumerate(marks) if m]
    if not at:
        return grads
    for i, g in zip(at, _flat_all_reduce([leaves[i] for i in at], group)):
        leaves[i] = g
    it = iter(leaves)
    return tree_map(lambda _: next(it), grads)


def _keep_blocks(local, whole, placement, mesh):
    """Copy each rank's block of the updated whole leaves into its
    blocks (a leaf that is not split was updated in place)."""
    tree_map(lambda lo, wh, spec: lo.copy_(BL.local_slice(wh, spec, mesh))
             if lo is not wh else None, local, whole, placement)


def remake_derived(params, placement, mesh, cfg):
    """An MLA model's absorbed copies made again, whole on every rank,
    from the gathered ``wuk`` / ``wuv`` of every layer (one gather)."""
    stack = T.layer_stack(params, cfg)
    pl_stack = T.layer_stack(placement, cfg)
    leaves, specs = [], []
    for (lp, _), (pp, _) in zip(stack, pl_stack):
        for k in ("wuk", "wuv"):
            leaves.append(lp["attn"][k])
            specs.append(pp["attn"][k])
    it = iter(BL.gather(leaves, specs, mesh))
    for lp, _ in stack:
        lp["attn"].update(L.mla_absorbed({"wuk": next(it), "wuv": next(it)}))


# =====================================================================
# serve: prefill + decode
# =====================================================================
def _one_rank(mesh, what):
    BL.require_runnable(mesh, what)
    n = math.prod(BL.mesh_shape_dict(mesh).values())
    if n != 1:
        raise ValueError(f"{what}: serving runs on a one-rank mesh; this "
                         f"one has {n} ranks")


def _serve_placements(model, run, mesh, rules, enc_seq):
    """(param placement, cache placement, abstract params) of a serving
    step: the cache's from a ``meta`` cache of the shape's batch and
    length."""
    cfg, shape = run.model, run.shape
    meta = Model(cfg, device="meta")
    aparams = T.add_derived(meta.abstract_params(), cfg)
    p_pl = placements(_with_derived(model.param_axes(), aparams),
                      shapes_of(aparams), rules, mesh)
    from repro_torch.models.decoding import cache_tree
    with TU.tuning_context(run_tuning(run)):
        acache = cache_tree(meta.init_cache(
            shape.global_batch, shape.seq_len, SERVE_PAGE_TOKENS,
            enc_seq=enc_seq))
        c_ax = model.cache_axes()
    return p_pl, placements(c_ax, shapes_of(acache), rules, mesh), aparams


def build_prefill_step(run: RunConfig, mesh, device=None) -> BuiltStep:
    """``fn(params, batch) -> (cache, last-token logits (B, padded
    vocab))``: a paged cache with room for ``shape.seq_len`` tokens in
    each of B slots, slots ``arange(B)`` prefilled with the batch's
    prompts (``tokens``, or ``embeddings`` for a vlm config, or an audio
    config's ``audio_frames`` and decoder ``tokens``; a prompt may be
    shorter than ``seq_len``).  ``device`` picks where a one-rank mesh
    runs (``mesh_device``)."""
    cfg, shape = run.model, run.shape
    model = Model(cfg, device=mesh_device(mesh, device), remat=run.remat)
    rules = make_rules(run, mesh)
    enc_seq = max(shape.seq_len, 16) if cfg.family == "audio" else 0

    def prefill_step(params, batch):
        _one_rank(mesh, "prefill step")
        tokens, emb = batch.get("tokens"), batch.get("embeddings")
        frames = batch.get("audio_frames")
        x = emb if tokens is None else tokens
        B, Tq = x.shape[:2]
        cache = model.init_cache(
            B, shape.seq_len, SERVE_PAGE_TOKENS,
            enc_seq=0 if frames is None else frames.shape[1])
        for slot in range(B):
            cache.alloc_seq(slot, Tq)
        logits = model.prefill(params, tokens, cache, list(range(B)),
                               embeddings=emb, audio_frames=frames)
        return cache, logits

    p_pl, c_pl, aparams = _serve_placements(model, run, mesh, rules,
                                            enc_seq)
    ainputs = input_specs(cfg, shape)
    b_pl = placements(batch_axes(cfg, shape), shapes_of(ainputs), rules,
                      mesh)
    return BuiltStep(fn=_ctx_wrap(prefill_step, mesh, rules, run),
                     in_shardings=(p_pl, b_pl), out_shardings=(c_pl, None),
                     abstract_inputs=(aparams, ainputs), mesh=mesh)


def build_decode_step(run: RunConfig, mesh, device=None) -> BuiltStep:
    """``fn(params, cache, tokens) -> (cache, next tokens (B,) int32)``:
    one decode step of slots ``arange(B)`` of the prefill step's cache,
    the next token the argmax over ``[..., :vocab_size]``; ``device`` as
    in ``build_prefill_step``."""
    cfg, shape = run.model, run.shape
    model = Model(cfg, device=mesh_device(mesh, device), remat=run.remat)
    rules = make_rules(run, mesh)
    B, S = shape.global_batch, shape.seq_len
    enc_seq = max(S // 8, 16) if cfg.family == "audio" else 0

    def decode_step(params, cache, tokens):
        _one_rank(mesh, "decode step")
        logits = model.decode_step(params, cache, tokens,
                                   list(range(tokens.shape[0])))
        return cache, torch.argmax(logits[..., :cfg.vocab_size],
                                   dim=-1).to(torch.int32)

    p_pl, c_pl, aparams = _serve_placements(model, run, mesh, rules,
                                            enc_seq)
    t_pl = LG.spec_for(("batch",), (B,), rules, BL.mesh_shape_dict(mesh))
    return BuiltStep(
        fn=_ctx_wrap(decode_step, mesh, rules, run),
        in_shardings=(p_pl, c_pl, t_pl), out_shardings=(c_pl, t_pl),
        abstract_inputs=(aparams, None,
                         torch.empty((B,), dtype=torch.int32,
                                     device="meta")),
        donate_argnums=(1,), mesh=mesh)


def build_step(run: RunConfig, mesh) -> BuiltStep:
    if run.shape.kind == "train":
        return build_train_step(run, mesh)
    if run.shape.kind == "prefill":
        return build_prefill_step(run, mesh)
    return build_decode_step(run, mesh)
