"""Tensor parallelism of the audio family in the port's train step
(``models/layers.py``, ``models/transformer.py``, ``launch/steps.py``):
whisper's encoder and decoder self-attention, and its cross-attention,
by heads, the MLPs by columns, the vocabulary in blocks; the encoder's
output passes one ``copy_to_model`` before the decoder, and the
cross-attention's query reads its input through ``copy_to_model``.

Gloo ranks on the CPU (``torch_mesh_ranks.start``; bodies in
``torch_tp_ranks``, set up by ``torch_tp_family``), reduced whisper-tiny
(2 encoder and 2 decoder layers, d 64, 4 heads, d_ff 128, vocabulary 250
padded to 256) with the reference's weights (``from_reference``), 4
rows of 48 frames and 40 decoder tokens, row 0's first 5 labels ignored,
on (1, 2), (1, 4) and (2, 2) meshes, all jobs and two reference
processes at once in one module fixture.

- Every case is held as ``tests/test_torch_mesh.py`` holds a mesh run
  (``torch_tp_family.check_run``, its tolerances: metrics 1e-3
  relative, grad norm 1e-2, each leaf's update within 0.3 relative L2
  and all within 0.1 of the one-rank step's, each leaf's first gradient
  within 5e-2 of one rank's and of the reference's); 4 steps, 2 with
  Adafactor.  Under INT8 compression the first gradient is held at 0.1
  a leaf and the updates together at 0.15, as the moe family's
  (measured 5.7% against one rank, 5.4% against the reference; one
  rank's port against the reference 5.1%).  The cases: (1, 2) with
  remat "none" and "full", INT8 compression; (1, 4); (2, 2) with
  Adafactor; (1, 4) with 2 KV heads, whose query heads split
  and KV heads do not (the cross K/V are made whole and cut to the
  rank's heads, ``tensor_parallel.kv_for_heads``; their leaves'
  gradient shares summed by the step).
- Every forward product of the first step reads its leaf at the local
  width (``torch_tp_family.widths``).
- The cross-attention's query over the rank's heads on 2 ranks: x's
  gradient equals the whole layer's within 2e-2 relative L2 (the
  row-parallel output's bf16 rounding) with ``copy_to_model`` on x, and
  is more than 0.3 away without it (each rank's gradient only its
  heads' share).
- The dry run on a reduced (4, 4) plan on ``meta``: rank 0's GEMM flops
  equal the placements' prediction exactly, ``tensor_parallel`` 4; per
  step one more all-reduce than per-layer sums account for: the
  encoder output's gradient, summed once for the decoder.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_family as F  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch.mesh import MeshPlan  # noqa: E402

ARCH = "whisper_tiny"
KV2 = dict(n_kv_heads=2)
CASES = {
    "1x2-whisper": ((1, 2), {}, {}),
    "1x2-whisper-full": ((1, 2), {}, dict(remat="full")),
    "1x2-whisper-compression": ((1, 2), {}, dict(compression=True)),
    "1x4-whisper": ((1, 4), {}, {}),
    "1x4-whisper-kv2": ((1, 4), KV2, {}),
    "2x2-whisper-adafactor": ((2, 2), {}, dict(opt="adafactor")),
}
CROSS_RANKS = 2
INT8 = F.Tol(grad=0.1, total=0.15)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cross():
    cfg = F.configs(ARCH, {})[1]
    p = F.params(ARCH, {})["layers"][0]["xattn"]
    rng = np.random.default_rng(13)
    B, T, Te, H, hd = 2, 12, 20, cfg.n_heads, cfg.resolved_head_dim

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(torch.bfloat16)

    return dict(cfg=cfg, params={"wq": p["wq"], "wo": p["wo"]},
                x=bf16(B, T, cfg.d_model), k=bf16(B, Te, H, hd),
                v=bf16(B, Te, H, hd),
                weight=torch.from_numpy(rng.standard_normal(
                    (B, T, cfg.d_model)).astype(np.float32)))


@pytest.fixture(scope="module")
def audio_runs(tmp_path_factory):
    return F.start(tmp_path_factory.mktemp("tp_audio"), ARCH, CASES,
                   pieces={(1, CROSS_RANKS): [("cross_pieces", _cross())]})


@pytest.mark.parametrize("name", sorted(CASES))
def test_audio_tp_step_matches_reference_and_meshless(audio_runs, name):
    res, refs, before = audio_runs[:3]
    mesh, _, kw = CASES[name]
    assert res[name]["tensor_parallel"] == mesh[1]
    steps = 2 if kw.get("opt") == "adafactor" else F.STEPS
    F.check_run(res[name], refs[name], before[name], steps,
                INT8 if kw.get("compression") else F.Tol())


@pytest.mark.parametrize("name", sorted(CASES))
def test_audio_gemms_run_at_local_widths(audio_runs, name):
    res = audio_runs[0][name]
    mesh, ov, _ = CASES[name]
    cfg = F.configs(ARCH, ov)[1]
    want = F.widths(cfg, mesh[1])
    assert F.gemm_widths(res) == {k: {v} for k, v in want.items()}


def test_cross_attention_query_reads_x_through_copy(audio_runs):
    every = audio_runs[3]["cross_pieces"]
    want_out, want = every[0]["whole"]
    size = float(want.float().norm())
    for out in every:
        got_out, got = out["split"]
        torch.testing.assert_close(got_out.float(), want_out.float(),
                                   rtol=2e-2, atol=2e-2)
        assert float((got.float() - want.float()).norm()) <= 2e-2 * size
        _, without = out["without_copy"]
        assert float((without.float() - want.float()).norm()) > 0.3 * size


PLAN = MeshPlan((4, 4), ("data", "model"))
TRAIN = ShapeConfig("train_4k", "train", 64, 8)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_dry_run_gemm_flops_follow_the_placements(remat):
    cfg = F.configs(ARCH, {})[1]
    run = RunConfig(model=cfg, shape=TRAIN, remat=remat)
    got, groups = F.dry_run_flops(run, PLAN)
    assert got == F.predicted_flops(cfg, run, 4, 4)
    assert S.build_train_step(run, PLAN).tensor_parallel == 4
    assert {g for op, g in groups if op == "all-reduce"} == {4}
    # the batch split's three; a layer's forward sums and input-gradient
    # sums (2 + 2 an encoder layer, 3 + 3 a decoder layer; the recompute
    # under remat="full" replays the attentions' sums); the lookup, the
    # cross-entropy's 3 a chunk; the encoder output's gradient once; the
    # clipping norm
    e, n = cfg.n_encoder_layers, cfg.n_layers
    full = remat == "full"
    layers = e * (4 + full) + n * (6 + 2 * full)
    chunks = -(-TRAIN.seq_len // run.ce_chunk)
    assert groups[("all-reduce", 4)][0] == \
        3 + layers + 1 + 3 * chunks + 1 + 1
