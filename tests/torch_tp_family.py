"""What ``tests/test_torch_tensor_parallel_{ssm,hybrid,audio}.py`` share:
the reduced config with its overrides and the reference's weights
(``from_reference``), the batches, one module fixture's worth of gloo
jobs and reference processes started at once (``start``), the forward
GEMM widths the placements predict on a model extent (``widths``), the
key of a leaf path within a layer (``key``), and the dry run's GEMM
flops on a reduced plan against that prediction (``dry_run_flops``),
and the measure a case is held at (``check_run``, ``Tol``).

A case is ``name: (mesh, overrides, run settings)`` of one arch; the
overrides replace fields of the reduced config on both sides
(``torch_mesh_reference.with_overrides``).
"""
import dataclasses

import numpy as np
import torch

import jax

import torch_mesh_ranks as R
import torch_mesh_reference as REF
import torch_tp_ranks as TPR
from repro.configs import get_reduced as ref_reduced
from repro.models.model import Model as RefModel
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as HA
from repro_torch.models import transformer as T
from repro_torch.models.params import from_reference
from repro_torch.optim import AdamW
import test_torch_mesh as M
from test_torch_dryrun import count_by_group

STEPS = 4
# whisper's batches: frames and decoder tokens a row (test_torch_mesh's)
AUDIO_FRAMES, AUDIO_TOKENS, AUDIO_ROWS = 48, 40, 4


def configs(arch, overrides):
    """(the reference's reduced config, the port's), overridden."""
    return (REF.with_overrides(ref_reduced(arch), overrides),
            REF.with_overrides(get_reduced(arch), overrides))


def params(arch, overrides):
    rcfg, cfg = configs(arch, overrides)
    p = RefModel(rcfg, remat="none").init(jax.random.PRNGKey(0))
    return from_reference(jax.tree.map(np.asarray, p), cfg)


def run_kw(cfg, kw):
    """The run settings of a case, with whisper's shape."""
    if cfg.family == "audio":
        return dict(kw, seq=AUDIO_TOKENS, batch=AUDIO_ROWS)
    return kw


def batches(cfg, n=STEPS, seq=32, batch=4):
    """The corpus's batches; whisper's: frames N(0, 1) in bf16, ids and
    labels from a seed, row 0's first 5 labels ``-1`` (the data ranks
    of a (2, 2) mesh count different numbers of valid labels)."""
    if cfg.family != "audio":
        corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=seq, global_batch=batch,
                                            seed=0))
        return [{k: torch.from_numpy(v) for k, v in corpus.batch(s).items()}
                for s in range(n)]
    rng = np.random.default_rng(0)
    B, TE, TD = AUDIO_ROWS, AUDIO_FRAMES, AUDIO_TOKENS
    out = []
    for _ in range(n):
        labels = rng.integers(0, cfg.vocab_size, (B, TD)).astype(np.int32)
        labels[0, :5] = -1
        out.append({"audio_frames": torch.from_numpy(rng.standard_normal(
                        (B, TE, cfg.d_model)).astype(np.float32)
                    ).to(torch.bfloat16),
                    "tokens": torch.from_numpy(rng.integers(
                        0, cfg.vocab_size, (B, TD)).astype(np.int32)),
                    "labels": torch.from_numpy(labels)})
    return out


def start(tmp, arch, cases, pieces=None, elastic=None, timeout=400.0):
    """Every mesh's gloo job (``torch_tp_ranks.family_job``) and the
    reference's first steps (two processes), all at once: ({case:
    result}, {case: reference}, {case: weights before}, {piece name: its
    result}, the elastic result).  ``pieces`` = {mesh: [(name, keyword
    arguments)]} and ``elastic`` = (mesh, keyword arguments) run on that
    mesh's job after its cases."""
    pieces = pieces or {}
    before, data, ref_cases = {}, {}, [{}, {}]
    for i, (name, (mesh, ov, kw)) in enumerate(cases.items()):
        cfg = configs(arch, ov)[1]
        before[name], data[name] = params(arch, ov), batches(cfg)
        ref_cases[i % 2][name] = (arch, data[name][0],
                                  dict(run_kw(cfg, kw), overrides=ov))
    refs = [REF.start(tmp / f"ref{i}", c, timeout=timeout)
            for i, c in enumerate(ref_cases) if c]
    jobs = {}
    for mesh in sorted({c[0] for c in cases.values()}):
        inputs = {"cases": [
            (name, configs(arch, ov)[1], mesh, before[name], data[name],
             run_kw(configs(arch, ov)[1], kw))
            for name, (m, ov, kw) in cases.items() if m == mesh],
            "pieces": pieces.get(mesh, ())}
        if elastic is not None and elastic[0] == mesh:
            inputs["elastic"] = elastic[1]
        jobs[mesh] = R.start(TPR.family_job, mesh[0] * mesh[1],
                             tmp / "x".join(map(str, mesh)), inputs,
                             timeout=timeout)
    res, got = {}, {}
    for j in jobs.values():
        out = j.result()
        got.update(out.pop("pieces", {}))
        res.update(out)
    ref = {}
    for r in refs:
        ref.update(r.result())
    return res, ref, before, got, res.pop("elastic", None)


@dataclasses.dataclass
class Tol:
    """The measures of ``check_run``: ``tests/test_torch_mesh.py``'s by
    default; ``loose`` names leaves (by the last part of their path)
    whose first gradient is held at ``loose_rel`` instead of ``grad``;
    ``skip_ref`` those left out against the reference."""
    loss: float = M.LOSS_RTOL
    norm: float = M.NORM_RTOL
    grad: float = M.GRAD_REL_L2
    total: float = M.TOTAL_REL
    loose: tuple = ()
    loose_rel: float = M.GRAD_REL_L2
    skip_ref: tuple = ()

    def grad_of(self, path):
        return self.loose_rel if path.rsplit("/", 1)[-1] in self.loose \
            else self.grad


def check_run(res, ref, before, steps, tol=Tol()):
    """``test_torch_mesh._check_run`` at ``tol``: the first batch's
    gradient each leaf within its bound of one rank's (and the leaves
    whose first AdamW step the two put more than ``NOISE_REL`` apart,
    on a tensor-parallel mesh, held by their update's size); the
    metrics of the first ``steps`` steps against one rank's; the updates
    after them; the first step against the reference's metrics and,
    for AdamW, its gradient; each rank's blocks' bytes."""
    mesh, one = (M._by_path(g) for g in res["grad0"])
    rounding = set()
    for path, w in one.items():
        g, size = mesh[path], float(w.norm())
        assert g.shape == w.shape, path
        assert float((g - w).norm()) <= tol.grad_of(path) * size, path
        step_g, step_w = (t / (t.abs() + AdamW.eps) for t in (g, w))
        if res["tensor_parallel"] > 1 and float(
                (step_g - step_w).norm()) > M.NOISE_REL * float(
                    step_w.norm()):
            rounding.add(path)
    got, want = res["got"][:steps], res["want"][:steps]
    assert len(got) == len(want) == steps
    for g, w in zip(got, want):
        for k in ("loss", "ce", "aux"):
            assert abs(g[k] - w[k]) <= tol.loss * abs(w[k]), (k, g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= \
            tol.norm * w["grad_norm"], (g, w)
        assert g["lr"] == w["lr"]
    off = total = 0.0
    got_p = M._by_path(res["params"][steps - 1])
    want_p = M._by_path(res["meshless"][steps - 1])
    for path, old in M._by_path(T.trainable(before)).items():
        got_d = got_p[path].float() - old.float()
        want_d = want_p[path].float() - old.float()
        err, size = float((got_d - want_d).norm()), float(want_d.norm())
        if path in rounding:
            assert abs(float(got_d.norm()) - size) <= M.LEAF_REL * size, \
                path
            continue
        assert err <= M.LEAF_REL * size, path
        off, total = off + err ** 2, total + size ** 2
    assert off ** 0.5 <= tol.total * total ** 0.5
    M._hold_metrics(res["got"][:1], [ref["metrics"]])
    if "m" in res["opt0"]:
        clip = min(1.0, AdamW.clip_norm / res["got"][0]["grad_norm"])
        adam = M._by_path(res["opt0"]["m"])
        for path, w in M._by_path(ref["grad"]).items():
            if path.rsplit("/", 1)[-1] in tol.skip_ref:
                continue
            g, w = adam[path] / ((1 - AdamW.b1) * clip), w.float()
            assert g.shape == w.shape, path
            assert float((g - w).norm()) <= \
                tol.grad_of(path) * float(w.norm()), path
    for held, due, _ in res["sizes"]:
        assert held == due


def local(n, count, m):
    """A dim of n over ``count`` heads / columns on a model extent of m:
    its block where ``count`` divides, else whole."""
    return n // m if m > 1 and count % m == 0 else n


def _attn(cfg, m, pre):
    d, H, KH = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    q, kv = local(H * hd, H, m), local(KH * hd, KH, m)
    return {pre + "wq": (d, q), pre + "wk": (d, kv), pre + "wv": (d, kv),
            pre + "wo": (q, d)}


def _mlp(cfg, m, pre):
    d, f = cfg.d_model, cfg.d_ff
    lf = local(f, f, m)
    names = ("wi_gate", "wi_up") if cfg.glu else ("wi",)
    return {**{pre + n: (d, lf) for n in names}, pre + "wo": (lf, d)}


def widths(cfg, m):
    """{leaf key (``key``): (K, N) of the B operand its forward product
    reads} on a model extent of ``m``: N / m for a column-parallel leaf,
    K / m for a row-parallel one, where its heads, columns or vocabulary
    divide over m; else whole."""
    d, V = cfg.d_model, cfg.padded_vocab
    out = {"lm_head": (d, local(V, V, m))}
    if cfg.family == "ssm":
        c = local(d, d, m)
        out.update({f"layers/time/{n}": (d, c)
                    for n in ("wr", "wk", "wv", "wg", "ww")})
        f = local(cfg.d_ff, cfg.d_ff, m)
        out.update({"layers/time/wo": (c, d), "layers/channel/wk": (d, f),
                    "layers/channel/wv": (f, d),
                    "layers/channel/wr": (d, c)})
    elif cfg.family == "hybrid":
        s = cfg.ssm
        d_in = s.expand * d
        cols = 2 * d_in + 2 * s.d_state + d_in // s.head_dim
        out.update({"layers/mamba/in_proj": (d, local(cols, cols, m)),
                    "layers/mamba/out_proj": (local(d_in, d_in, m), d),
                    **_mlp(cfg, m, "layers/mlp/"),
                    **_attn(cfg, m, "shared_attn/attn/")})
    else:
        out.update({**_attn(cfg, m, "enc_layers/attn/"),
                    **_mlp(cfg, m, "enc_layers/mlp/"),
                    **_attn(cfg, m, "layers/attn/"),
                    **_attn(cfg, m, "layers/xattn/"),
                    **_mlp(cfg, m, "layers/mlp/")})
    return out


def key(path):
    """A leaf path without its layer index (``layers/3/mlp/wo`` ->
    ``layers/mlp/wo``)."""
    parts = path.split("/")
    if parts[0] in ("layers", "enc_layers"):
        return "/".join(parts[:1] + parts[2:])
    return path


def gemm_widths(res) -> dict:
    """{key: the (K, N) shapes a case's first forward read}, every leaf
    path at one shape."""
    got = {}
    for path, shapes in res["gemm_widths"].items():
        assert len(shapes) == 1, (path, shapes)
        got.setdefault(key(path), set()).add(shapes[0])
    return got


def dry_run_flops(run, mesh):
    """(2-D GEMM flops, collectives by (op, group size)) of rank 0's step
    on ``mesh``, counted on ``meta``."""
    flops = []
    kernel = HA.kernel

    def count(name, f, b):
        if name == "streaming_gemm":
            flops.append(f)
        kernel(name, f, b)

    HA.kernel = count
    try:
        fn, args, donated = dryrun.cell_step(run, mesh)
        _, groups = count_by_group(fn, args, donated)
    finally:
        HA.kernel = kernel
    return sum(flops), groups


def predicted_flops(cfg, run, m, data):
    """Rank 0's GEMM flops from the placements (``widths``): each
    product's forward, dA and dB, 2·M·K·N each, M the rank's rows (a
    whisper encoder's over its frames, the cross K/V products too; the
    hybrid's shared block where a layer runs it), the layers' forward
    once more under ``remat="full"``; the lm_head over the decoder's
    tokens."""
    B, T = run.shape.global_batch // data, run.shape.seq_len
    w = widths(cfg, m)
    per = 4 if run.remat == "full" else 3

    def prod(keys):
        return sum(w[k][0] * w[k][1] for k in keys)

    layer = [k for k in w if k.startswith("layers/")]
    total = 0
    if cfg.family == "hybrid":
        shared = -(-cfg.n_layers // cfg.ssm.attn_every)
        total = per * B * T * (cfg.n_layers * prod(layer) + shared * prod(
            [k for k in w if k.startswith("shared_attn/")]))
    elif cfg.family == "ssm":
        total = per * B * T * cfg.n_layers * prod(layer)
    else:       # frames and tokens both T long in the dry run's shape
        total = per * B * T * (cfg.n_encoder_layers * prod(
            [k for k in w if k.startswith("enc_layers/")])
            + cfg.n_layers * prod(layer))
    return 2 * (total + 3 * B * T * prod(["lm_head"]))


def layer_case(name, arch, overrides, seed, B=2, T=24):
    """A case of ``torch_tp_ranks.layer_pieces``: (name, the port's
    config, whole fp32 leaves of one RWKV6 layer's time and channel mix
    or one Mamba2 block, x (B, T, d), the output's weight), all from
    ``seed``: matrices N(0, 1 / fan-in), ``mix``, ``u``, ``w_bias`` and
    the Mamba2 per-head leaves and ``norm_scale`` N(0, 1) x 0.5 around
    their init."""
    from repro_torch.models import ssm as SSM
    cfg = configs(arch, overrides)[1]
    rng = np.random.default_rng(seed)
    specs = SSM.rwkv_pspecs(cfg) if cfg.family == "ssm" else \
        {"mamba": SSM.mamba2_pspecs(cfg)}

    def leaf(ps):
        a = rng.standard_normal(ps.shape).astype(np.float32)
        if ps.init == "normal" and len(ps.shape) > 1 and ps.shape[0] > 5:
            a /= np.sqrt(ps.shape[0])
        else:
            a = a * 0.5 + (1.0 if ps.init == "ones" else 0.0)
        return torch.from_numpy(a)

    leaves = {k: {n: leaf(ps) for n, ps in v.items()}
              for k, v in specs.items()}
    x = torch.from_numpy(rng.standard_normal(
        (B, T, cfg.d_model)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(
        (B, T, cfg.d_model)).astype(np.float32))
    return name, cfg, leaves, x, w


def check_layer(every, rel=1e-4):
    """``layer_pieces``' results: on every rank the split layer's output,
    x's gradient and each leaf's block of the gradient within ``rel``
    relative L2 of the whole layer's."""
    for out in every:
        (y, gx, grads), (wy, wgx, wgrads) = out["split"], out["whole"]
        for got, want, what in ((y, wy, "out"), (gx, wgx, "x")):
            assert float((got - want).norm()) <= rel * float(want.norm()), \
                what
        for k, v in wgrads.items():
            for n, want in v.items():
                got = grads[k][n]
                assert got.shape == want.shape, (k, n)
                assert float((got - want).norm()) <= \
                    rel * float(want.norm()), (k, n)
