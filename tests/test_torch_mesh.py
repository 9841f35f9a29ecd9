"""The port's mesh on the CPU: gloo ranks, spawned per test
(``torch_mesh_ranks.start``: ``spawn``, a ``FileStore`` rendezvous in the
test's own directory, one intra-op thread a rank, a join timeout), on
reduced configs with weights from the reference (``from_reference``).

Every training run on a mesh is held against two witnesses from the
same weights and batches.

1. The port's step on one rank (``build_train_step(run, "cpu")``), run
   by rank 0, over every step of the run, at
   ``tests/test_torch_trainer.py``'s measure: the loss, the
   cross-entropy, the aux and MTP losses within 1e-3 relative each
   step, the clipped gradient norm within 1e-2, the learning rate
   equal, and each leaf's update (the whole weights after the step less
   before the run) within 0.3 of the witness's update in relative L2,
   all leaves together within 0.1.  The gradient of the first batch the
   mesh reduced (read from an AdamW step's first moment, also for an
   Adafactor run: ``torch_mesh_ranks._first_gradients``) is held
   against the one-rank step's, each leaf within 5e-2 relative L2.
   On a mesh whose ``model`` axis splits the layers (tensor
   parallelism, which rounds its row-parallel partials to bf16 where
   one rank rounds the whole product once), a leaf whose update that
   rounding decides is held by its size instead (its update's L2 norm
   within 0.3 of the witness's) and left out of the total: those whose
   first AdamW step, g / (|g| + eps) a value, differs by more than
   ``NOISE_REL`` (0.2) relative L2 between the two gradients of the
   first batch, which agree at 5e-2.  Adam's per-value normalisation
   turns a gradient value at the level of round-off into a full-size
   step whose sign rounding sets: the key bias ``bk`` in the head dims
   of RoPE's slowest frequencies, where softmax's indifference to a
   shift of every key's score leaves a gradient near 1e-6 beside 1e-3
   in the others (up to 1.22 in the tensor-parallel cases; a 64-value
   norm scale or a 32-value bias with one sign flipped 0.25 or 0.35;
   the weight matrices 0.15 at most).  The bound is below the update's
   0.3 because the update held is that of up to four steps, over which
   rounding's share grows (qwen2 with compression on (1, 2): ``bk``'s
   first step 0.21 apart, its update after four 0.31).  On every other
   mesh each leaf is held by its direction.
2. The reference's first step (``torch_mesh_reference``: its jitted
   loss and gradients without XLA's excess precision, compression as
   its ``Trainer`` applies it, from ``PRNGKey(0)``), computed in two
   processes of its own while the ranks run: the metrics at the same
   measure, and, for AdamW, the whole gradient the mesh reduced (its
   first moment after step 0, which is ``(1 - b1)`` times the clipped
   gradient, divided by both) each leaf within 5e-2 relative L2 of the
   reference's gradient, the measure of ``tests/test_torch_train*.py``.
   The learning rate of step 0 is 0, so the first moment is the one
   quantity of that step the mesh's gradient reduction alone decides.
   Leaves left out: zamba2's Mamba ``D``, whose gradient the reference
   sums in bf16 (``tests/test_torch_train_hybrid.py``: 16% off the
   exact sum on random terms).  The multi-step updates are not held
   against the reference: Adam's first updates divide the gradient by
   its own size, so a leaf whose gradient is rounding noise (a key
   bias, whose exact gradient is 0, since softmax ignores a shift of
   every key's score) moves by as much in the port on one rank as on
   the mesh.

- qwen2-0.5b on (2, 2) and (4, 1) meshes, 4 AdamW steps.  Each rank's
  state holds exactly its blocks' bytes.
- Every arch id's reduced config takes 2 steps on a (2, 1) mesh (the
  MoE models with ``moe_local_dispatch``, their aux loss > 0; whisper
  through ``build_train_step`` with frames and some labels ``-1``, so
  the two ranks count different numbers of valid labels); gradient
  compression 4 steps; Adafactor (with and without compression) 2
  steps, its first update at lr > 0, as the trainer test's one step
  (further updates are ill-conditioned on qwen2's key bias: in a
  meshless run, summing the gradient of the two half batches instead of
  taking the whole batch's, a 0.2% change, moves that leaf's second
  update by about 50%); global MoE dispatch on the split raises naming
  ``moe_local_dispatch``.
- The sharding of the state is exact: on a (2, 1) mesh whose batch of 3
  rows the data extent does not divide (so every rank takes every row
  and no gradient is summed) 4 steps of AdamW and Adafactor, with and
  without compression, equal the one-rank steps bit for bit (losses and
  weights after every step), while the embedding and its state are
  split.
- The reference's elastic restore: reduced qwen1.5-32b on (2, 2) for 8
  steps with a checkpoint every 4, then (4, 1) restores step 7 and runs
  to 12, then (2, 2) restores step 11, and so does a meshless Trainer:
  each restore's gathered leaves equal the checkpoint's bit for bit.
- ``compressed_psum`` on 4 ranks equals the reference's arithmetic bit
  for bit (``repro.runtime.compression._q`` per rank, the int32 sum of
  the codes times the largest scale), alike on every rank.
- ``build_prefill_step`` / ``build_decode_step`` on a one-rank CPU mesh
  against the reference's, jitted on its ``make_host_mesh(1, 1)``: the
  greedy tokens of 8 decode steps equal.
- ``launch/train.py --mesh host --device cpu --reduced`` runs;
  ``--mesh production`` raises naming the ranks it needs;
  ``make_host_mesh`` raises without a card unless ``device="cpu"``, and
  on a mesh the process group cannot fill.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
import torch_mesh_reference as REF  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.configs.base import RunConfig as RefRun  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.launch.mesh import make_host_mesh as ref_host_mesh  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro.runtime.compression import _q as ref_q  # noqa: E402
from repro_torch.checkpoint.checkpoint import _flatten  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_reduced  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.mesh import MeshPlan, make_production_mesh  # noqa: E402,E501
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import from_reference, tree_map  # noqa: E402,E501
from repro_torch.optim import AdamW  # noqa: E402

MOE_ARCHS = ("qwen2_moe_a2_7b", "deepseek_v3_671b")
LOSS_RTOL, NORM_RTOL = 1e-3, 1e-2
LEAF_REL, TOTAL_REL = 0.3, 0.1
GRAD_REL_L2 = 5e-2
NOISE_REL = 0.2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(arch, seed=0):
    rcfg = ref_reduced(arch)
    p = RefModel(rcfg, remat="none").init(jax.random.PRNGKey(seed))
    return from_reference(jax.tree.map(np.asarray, p), get_reduced(arch))


def _batches(cfg, n, seq=32, batch=4):
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=seq, global_batch=batch,
                                        seed=0))
    return [{k: torch.from_numpy(v) for k, v in corpus.batch(s).items()}
            for s in range(n)]


def _whisper_batch(cfg, B=2, TE=48, TD=40):
    """Frames of N(0, 1) in bf16, ids and labels, row 0's first 5
    labels ``-1``: the ranks' valid label counts differ."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, cfg.vocab_size, (B, TD)).astype(np.int32)
    labels[0, :5] = -1
    return {"audio_frames": torch.from_numpy(
                rng.standard_normal((B, TE, cfg.d_model)).astype(np.float32)
            ).to(torch.bfloat16),
            "tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (B, TD)).astype(np.int32)),
            "labels": torch.from_numpy(labels)}


def _by_path(tree) -> dict:
    return {"/".join(p): t for p, t in _flatten(tree)}


def _hold_metrics(got, want):
    """Per-step metrics ``got`` against ``want`` (module docstring)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("loss", "ce", "aux") + (("mtp",) if "mtp" in w else ()):
            assert abs(g[k] - w[k]) <= LOSS_RTOL * abs(w[k]), (k, g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= \
            NORM_RTOL * w["grad_norm"], (g, w)
        assert g["lr"] == w["lr"]


def _hold(got, got_p, want, want_p, before, rounding=frozenset()):
    """The measure of the module docstring: per-step metrics ``got``
    against ``want``, and the weights after the last of them against
    ``want_p``'s, as updates from ``before``; the leaves at the paths in
    ``rounding`` by their size."""
    _hold_metrics(got, want)
    off = total = 0.0
    got_p, want_p = _by_path(got_p), _by_path(want_p)
    for path, old in _by_path(T.trainable(before)).items():
        got_d = got_p[path].float() - old.float()
        want_d = want_p[path].float() - old.float()
        err, size = float((got_d - want_d).norm()), float(want_d.norm())
        if path in rounding:
            assert abs(float(got_d.norm()) - size) <= LEAF_REL * size, path
            continue
        assert err <= LEAF_REL * size, path
        off, total = off + err ** 2, total + size ** 2
    assert off ** 0.5 <= TOTAL_REL * total ** 0.5


def _rounding_leaves(res) -> set:
    """The paths of the leaves whose update the rounding of a
    tensor-parallel mesh decides (module docstring), from the two
    gradients of the first batch; none on any other mesh.  Each
    gradient is held against the other at ``GRAD_REL_L2``."""
    mesh, one = (_by_path(g) for g in res["grad0"])
    out = set()
    for path, w in one.items():
        g, size = mesh[path], float(w.norm())
        assert g.shape == w.shape, path
        assert float((g - w).norm()) <= GRAD_REL_L2 * size, path
        step_g, step_w = (t / (t.abs() + AdamW.eps) for t in (g, w))
        apart = float((step_g - step_w).norm())
        if res["tensor_parallel"] > 1 and \
                apart > NOISE_REL * float(step_w.norm()):
            out.add(path)
    return out


def _check_run(res, ref, before, steps, arch=None):
    """A result of ``train_against_meshless`` over its first ``steps``
    steps against the one-rank port, its first batch's gradient against
    the one-rank port's, and its first step against the reference's
    ``ref`` (module docstring); each rank held its blocks' bytes."""
    _hold(res["got"][:steps], res["params"][steps - 1],
          res["want"][:steps], res["meshless"][steps - 1], before,
          _rounding_leaves(res))
    _hold_metrics(res["got"][:1], [ref["metrics"]])
    if "m" in res["opt0"]:      # AdamW: m = (1 - b1) g clip after step 0
        clip = min(1.0, AdamW.clip_norm / res["got"][0]["grad_norm"])
        got = _by_path(tree_map(lambda m: m / ((1 - AdamW.b1) * clip),
                                res["opt0"]["m"]))
        for path, w in _by_path(ref["grad"]).items():
            if arch == "zamba2_7b" and path.endswith("mamba/D"):
                continue        # the reference sums it in bf16
            g, w, size = got[path], w.float(), float(w.float().norm())
            assert g.shape == w.shape, path
            assert float((g - w).norm()) <= GRAD_REL_L2 * size, path
    for held, due, _ in res["sizes"]:
        assert held == due


# ------------------------------------------------------------ 4 ranks
QWEN = "qwen2_0_5b"
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}


def _psum_inputs():
    return [torch.from_numpy(np.random.default_rng(100 + r).standard_normal(
        (37, 53)).astype(np.float32) * (r + 1)) for r in range(4)]


SPLIT_RUNS = {"adafactor": (dict(opt="adafactor"), 2),
              "compression": (dict(compression=True), 4),
              "adafactor_compression": (dict(opt="adafactor",
                                             compression=True), 2)}
REPLICATED_RUNS = {"adamw": dict(), "adafactor": dict(opt="adafactor"),
                   "adamw_compression": dict(compression=True),
                   "adafactor_compression": dict(opt="adafactor",
                                                 compression=True)}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The reference's first steps, then the four-rank and the two-rank
    jobs, all running at once; (four-rank result, two-rank result, {run
    name: reference}, {run name: weights before})."""
    tmp = tmp_path_factory.mktemp("mesh")
    qwen = get_reduced(QWEN)
    runs = []                   # (name, arch, batches, run settings)
    for arch in ARCH_IDS:
        cfg = get_reduced(arch)
        if cfg.family == "audio":
            batches, kw = [_whisper_batch(cfg)] * 2, dict(seq=40, batch=2)
        else:
            batches, kw = _batches(cfg, 2), {}
        kw["local"] = arch in MOE_ARCHS
        runs.append((arch, arch, batches, kw))
    runs += [(name, QWEN, _batches(qwen, n), kw)
             for name, (kw, n) in SPLIT_RUNS.items()]
    runs += [("replicated_" + name, QWEN, _batches(qwen, 4, batch=3),
              dict(kw, batch=3)) for name, kw in REPLICATED_RUNS.items()]
    archs = list(ARCH_IDS)
    refs = [REF.start(tmp / f"ref{i}", {
        name: (arch, batches[0], kw) for name, arch, batches, kw in runs
        if archs.index(arch) % 2 == i})
        for i in (0, 1)]        # two processes, half the archs each
    before = {arch: _params(arch) for arch in ARCH_IDS}
    four = R.start(R.meshes_and_psum, 4, tmp / "four", {
        "cases": [(name, qwen, shape, before[QWEN], _batches(qwen, 4))
                  for name, shape in MESHES.items()],
        "psum_inputs": _psum_inputs()})
    moe = "qwen2_moe_a2_7b"
    two = R.start(R.batch_split, 2, tmp / "two", {
        "cases": [(name, get_reduced(arch), before[arch], batches, kw)
                  for name, arch, batches, kw in runs],
        "moe_global": (get_reduced(moe), before[moe],
                       _batches(get_reduced(moe), 1)[0])})
    before.update({name: before[arch] for name, arch, _, _ in runs})
    res4, res2 = four.result(), two.result()
    return res4, res2, {**refs[0].result(), **refs[1].result()}, before


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_matches_meshless(mesh_runs, name):
    res, _, ref, before = mesh_runs
    _check_run(res[name], ref[QWEN], before[QWEN], 4)
    for held, _, whole in res[name]["sizes"]:
        assert held < whole / 1.5     # the state is split, not copied


def test_compressed_psum_on_four_ranks(mesh_runs):
    ys = mesh_runs[0]["psum"]
    qs = [ref_q(jnp.asarray(x.numpy())) for x in _psum_inputs()]
    want = np.asarray(sum(q.astype(jnp.int32) for q, _ in qs)
                      .astype(jnp.float32) * jnp.max(jnp.stack(
                          [s for _, s in qs])))
    for y in ys:
        assert y.dtype == torch.float32
        np.testing.assert_array_equal(y.numpy(), want)


# ------------------------------------------------------------ 2 ranks
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_on_a_batch_split(mesh_runs, arch):
    _, res, refs, before = mesh_runs
    _check_run(res[arch], refs[arch], before[arch], 2, arch)
    if arch in MOE_ARCHS:
        assert all(s["aux"] > 0 for s in res[arch]["got"])


@pytest.mark.parametrize("name", sorted(SPLIT_RUNS))
def test_adafactor_and_compression_on_a_batch_split(mesh_runs, name):
    _, res, refs, before = mesh_runs
    _check_run(res[name], refs[name], before[name], SPLIT_RUNS[name][1])


@pytest.mark.parametrize("name", sorted(REPLICATED_RUNS))
def test_sharded_state_is_exact_on_a_replicated_batch(mesh_runs, name):
    _, res, refs, before = mesh_runs
    res, ref = res["replicated_" + name], refs["replicated_" + name]
    assert [g["loss"] for g in res["got"]] == \
        [w["loss"] for w in res["want"]]
    for got, want in zip(res["params"], res["meshless"]):
        got, want = _by_path(got), _by_path(want)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for held, due, whole in res["sizes"]:
        assert held == due < whole
    _check_run(res, ref, before[QWEN], 4)


def test_global_moe_dispatch_on_a_batch_split_raises(mesh_runs):
    msg = mesh_runs[1]["moe_global"]
    assert msg is not None and "moe_local_dispatch" in msg


# ------------------------------------------------------------ elastic
def _checkpoint(ckpt, step):
    with np.load(ckpt / f"step_{step:08d}" / "arrays.npz") as data:
        return {k: data[k] for k in data.files}


def _assert_equal_to_checkpoint(state, saved):
    flat = {"__".join(p): t for p, t in _flatten(state)}
    assert set(flat) == set(saved)
    for k, t in flat.items():
        np.testing.assert_array_equal(t.float().numpy() if t.is_floating_point()
                                      else t.numpy(), saved[k], err_msg=k)


def test_elastic_restore_onto_another_mesh(tmp_path):
    ckpt = tmp_path / "ckpt"
    res = R.spawn(R.elastic, 4, tmp_path / "ranks",
                  {"cfg": get_reduced("qwen1_5_32b"), "ckpt_dir": str(ckpt)})
    assert len(res["a"]["losses"]) == 8
    assert res["b_start"] == 8 and len(res["b"]["losses"]) == 4
    assert np.isfinite(res["b"]["losses"]).all()
    assert res["c_start"] == res["meshless_start"] == 12
    _assert_equal_to_checkpoint(res["b_state"], _checkpoint(ckpt, 7))
    for key in ("c_state", "meshless_state"):
        _assert_equal_to_checkpoint(res[key], _checkpoint(ckpt, 11))
    meta = json.loads((ckpt / "step_00000011" / "meta.json").read_text())
    assert meta["dtypes"]["params/embed"] == "bfloat16"


# ----------------------------------------------------- in this process
@pytest.fixture
def one_rank_group():
    """A one-rank gloo group ``make_host_mesh`` makes, destroyed after."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_serving_steps_match_reference(one_rank_group):
    arch, B, S_CACHE, T, STEPS = QWEN, 2, 32, 16, 8
    rcfg, cfg = ref_reduced(arch), get_reduced(arch)
    rp = RefModel(rcfg).init(jax.random.PRNGKey(0))
    params = from_reference(jax.tree.map(np.asarray, rp), cfg)
    prompt = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (B, T)).astype(np.int32)

    rmesh = ref_host_mesh(1, 1)
    with rmesh:
        pre = jax.jit(ref_steps.build_prefill_step(
            RefRun(model=rcfg, shape=RefShape("p", "prefill", S_CACHE, B)),
            rmesh).fn)
        dec = jax.jit(ref_steps.build_decode_step(
            RefRun(model=rcfg, shape=RefShape("d", "decode", S_CACHE, B)),
            rmesh).fn)
        cache, logits = pre(rp, {"tokens": jnp.asarray(prompt)})
        tok = jnp.argmax(logits[..., :rcfg.vocab_size], -1).astype(jnp.int32)
        want = [np.asarray(tok)]
        for _ in range(STEPS):
            cache, tok = dec(rp, cache, tok)
            want.append(np.asarray(tok))

    mesh = make_host_mesh(1, 1, device="cpu")
    pre = S.build_prefill_step(
        RunConfig(model=cfg, shape=ShapeConfig("p", "prefill", S_CACHE, B)),
        mesh)
    dec = S.build_decode_step(
        RunConfig(model=cfg, shape=ShapeConfig("d", "decode", S_CACHE, B)),
        mesh)
    assert pre.in_shardings[1] == {"tokens": ("data", None)}
    cache, logits = pre.fn(params, {"tokens": torch.from_numpy(prompt)})
    tok = torch.argmax(logits[..., :cfg.vocab_size], -1).to(torch.int32)
    got = [tok.numpy().copy()]
    for _ in range(STEPS):
        cache, tok = dec.fn(params, cache, tok)
        assert tok.dtype == torch.int32
        got.append(tok.numpy().copy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert list(cache.lens[:B]) == [T + STEPS] * B


def test_serving_steps_on_a_plan_raise():
    cfg = get_reduced(QWEN)
    run = RunConfig(model=cfg, shape=ShapeConfig("d", "decode", 32, 2))
    for mesh in (make_production_mesh(), MeshPlan((2, 1), ("data", "model"))):
        built = S.build_decode_step(run, mesh)
        with pytest.raises(ValueError, match="plan"):
            built.fn({}, None, torch.zeros(2, dtype=torch.int32))


def test_train_cli_on_a_host_mesh(tmp_path, capsys, one_rank_group):
    train_cli.main(["--reduced", "--device", "cpu", "--mesh", "host",
                    "--steps", "3", "--seq", "32", "--batch", "2",
                    "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert "3 steps" in out and "mesh" in out


@pytest.mark.parametrize("choice,ranks", [("production", 256),
                                          ("production-multi", 512)])
def test_train_cli_production_mesh_raises(tmp_path, choice, ranks):
    with pytest.raises(ValueError, match=f"{ranks} ranks"):
        train_cli.main(["--reduced", "--device", "cpu", "--mesh", choice,
                        "--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_make_host_mesh_refusals(monkeypatch, one_rank_group):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_host_mesh(1, 1)
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        make_host_mesh(2, 1, device="cpu")
    make_host_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="has 1"):
        make_host_mesh(1, 2, device="cpu")
