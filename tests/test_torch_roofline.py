"""The port's roofline and report (``repro_torch.launch.roofline`` /
``report``) against the reference's.

- ``n_params``, ``active_params`` and ``model_flops_for`` equal the
  reference's for every arch id, full and reduced, and every shape
  (the two counts known to be wrong included).
- For the same costs, ``compute_roofline``'s time terms are the
  reference's rescaled by the ratio of the two packages' constants,
  read from both modules; the counts, the model FLOPs, the useful ratio
  and the memory per device are equal; the bottleneck, the roofline
  share and "fits" follow the port's own terms and ``HBM_BYTES``.
- ``report`` renders the same records as the reference's, but for the
  "fits HBM" mark of a rank between 16 GiB and the H100's 80 GB.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.launch import hlo_analysis as RHA  # noqa: E402
from repro.launch import report as RREP  # noqa: E402
from repro.launch import roofline as RRL  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_reduced  # noqa: E402,E501
from repro_torch.launch import hlo_analysis as HA  # noqa: E402
from repro_torch.launch import report as REP  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import n_elements  # noqa: E402


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_parameter_and_model_flop_counts_equal_the_reference(arch, size):
    cfg = (get_config if size == "full" else get_reduced)(arch)
    want = (ref_config if size == "full" else ref_reduced)(arch)
    assert cfg.n_params() == want.n_params()
    assert RL.active_params(cfg) == RRL.active_params(want)
    for name, shape in SHAPES.items():
        assert RL.model_flops_for(cfg, shape) == \
            RRL.model_flops_for(want, REF_SHAPES[name])


def test_the_two_known_wrong_counts_are_kept():
    """ROADMAP Queue C: the reference's formula is copied, errors and
    all; the parameter trees hold other counts."""
    zamba, deepseek = get_config("zamba2_7b"), get_config("deepseek_v3_671b")
    assert zamba.n_params() == 6_679_916_544
    assert n_elements(Model(zamba, device="meta").abstract_params()) \
        == 19_082_080_336
    assert deepseek.n_params() == 703_796_805_632
    assert n_elements(Model(deepseek, device="meta").abstract_params()) \
        < deepseek.n_params()


def test_constants_are_the_h100s():
    assert (RL.PEAK_FLOPS_BF16, RL.HBM_BW, RL.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    assert 80e9 <= RL.HBM_BYTES < 80 * 2**30
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "HBM_BYTES"):
        assert getattr(RL, name) != getattr(RRL, name)


COSTS = {
    "compute": (4e14, 1e11, 1e8, {"all-reduce": 6e7}, 2),
    "memory": (1e12, 5e12, 1e9, {"all-gather": 8e8}, 3),
    "collective": (1e12, 1e11, 9e11, {"all-reduce": 5e11,
                                      "all-gather": 1e11}, 7),
}


@pytest.mark.parametrize("memory", [None, (2e10, 1e9, 6e10, 1e9)])
@pytest.mark.parametrize("which", list(COSTS))
def test_roofline_terms_rescale_the_references(which, memory,
                                               monkeypatch):
    flops, nbytes, eff, by_op, count = COSTS[which]
    costs = HA.Costs(flops, nbytes, sum(by_op.values()), eff, dict(by_op),
                     count)
    monkeypatch.setattr(RHA, "analyze", lambda text: RHA.Costs(
        flops, nbytes, sum(by_op.values()), eff, dict(by_op), count))
    ref_stats = None if memory is None else type("Stats", (), dict(zip(
        ("argument_size_in_bytes", "output_size_in_bytes",
         "temp_size_in_bytes", "alias_size_in_bytes"), memory)))
    got = RL.compute_roofline(costs, 256, 3e16, None if memory is None
                              else RL.MemoryStats(*memory))
    want = RRL.compute_roofline({}, "", 256, 3e16, ref_stats)
    assert got.compute_s == pytest.approx(
        want.compute_s * RRL.PEAK_FLOPS_BF16 / RL.PEAK_FLOPS_BF16, rel=1e-12)
    assert got.memory_s == pytest.approx(
        want.memory_s * RRL.HBM_BW / RL.HBM_BW, rel=1e-12)
    assert got.collective_s == pytest.approx(
        want.collective_s * RRL.ICI_BW / RL.LINK_BW, rel=1e-12)
    for f in ("flops_per_device", "bytes_per_device", "collective_bytes",
              "model_flops", "useful_ratio", "memory_per_device_bytes",
              "collective_count"):
        assert getattr(got, f) == getattr(want, f), f
    terms = {"compute": got.compute_s, "memory": got.memory_s,
             "collective": got.collective_s}
    assert got.bottleneck == which == max(terms, key=terms.get)
    assert got.step_time_s == max(terms.values())
    assert got.roofline_fraction == pytest.approx(
        3e16 / 256 / RL.PEAK_FLOPS_BF16 / got.step_time_s, rel=1e-12)
    if memory is not None:
        assert got.fits_hbm == (got.memory_per_device_bytes
                                <= RL.HBM_BYTES)


def _records():
    rl = RL.compute_roofline(HA.Costs(3e14, 2e12, 1e9, 1.5e9,
                                      {"all-reduce": 1e9}, 4), 256, 1e16)
    base = {"status": "ok", "roofline": rl.to_dict(), "tag": "baseline"}
    gib = 2 ** 30
    return [
        {**base, "arch": "qwen2_0_5b", "shape": "train_4k",
         "memory_analysis": {"argument_bytes": 2 * gib, "output_bytes": gib,
                             "temp_bytes": 5 * gib, "alias_bytes": gib}},
        # 40 GiB a rank: over the TPU's 16 GiB, within the H100's 80 GB
        {**base, "arch": "qwen2_moe_a2_7b", "shape": "train_4k",
         "memory_analysis": {"argument_bytes": 10 * gib,
                             "output_bytes": 10 * gib,
                             "temp_bytes": 30 * gib,
                             "alias_bytes": 10 * gib}},
        {**base, "arch": "deepseek_v3_671b", "shape": "train_4k",
         "memory_analysis": {"argument_bytes": 10 ** 13, "output_bytes": 0,
                             "temp_bytes": 10 ** 13, "alias_bytes": 0}},
        {"arch": "qwen2_0_5b", "shape": "long_500k", "status": "skipped",
         "reason": "r", "tag": "baseline"},
        {"arch": "rwkv6_7b", "shape": "decode_32k", "status": "error",
         "error": "e", "tag": "baseline"},
    ]


def test_report_renders_as_the_reference(tmp_path):
    for i, r in enumerate(_records()):
        (tmp_path / f"{r['arch']}.{r['shape']}.single.baseline.json") \
            .write_text(json.dumps(r))
    got = REP.roofline_table(tmp_path).splitlines()
    want = RREP.roofline_table(tmp_path).splitlines()
    assert len(got) == len(want) == 2 + len(_records())
    differ = [(g, w) for g, w in zip(got, want) if g != w]
    assert len(differ) == 1
    g, w = differ[0]
    assert "qwen2_moe_a2_7b" in g and g.replace("✓", "✗") == w
    assert REP.summary(tmp_path) == RREP.summary(tmp_path)
    assert REP.fmt_s(0.5e-3) == RREP.fmt_s(0.5e-3) and \
        REP.fmt_b(3e12) == RREP.fmt_b(3e12)
