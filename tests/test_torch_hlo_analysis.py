"""The port's cost counter (``repro_torch.launch.hlo_analysis``) against
the reference's HLO walker, and one count of a step on the CPU and on
``meta``.

- A Python loop of ``tanh(x @ w)`` counts 66,048 flops a trip, exactly
  4x more at 8 trips than at 2: the reference's ``analyze`` of the
  jitted scan less its loop counter's 2 flops a trip (the reference's
  ``tests/test_hlo_analysis.py`` asks for a ratio between 3 and 5).
- One (8, 64) x (64, 32) fp32 product counts the reference's flops and
  bytes; an all-reduce of (16, 16) fp32 over a 4-rank plan its one
  collective, payload and ring bytes (the literal HLO of the reference's
  test).
- Each kernel wrapper records the same op on the CPU (its plain
  version) and on ``meta`` (its launcher's checks and allocations),
  and neither touches ``LAUNCHES``.
- One train step of each of the ten reduced configs, and a prefill and
  a decode step of each family that serves, count the same flops, bytes,
  collectives and wrapper ops on the CPU and on ``meta``; the MoE and
  MLA steps run on ``meta`` (their dispatch needs no value on the host).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import hlo_analysis as RHA  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_reduced  # noqa: E402
from repro_torch.configs.base import MLAConfig, RunConfig, ShapeConfig  # noqa: E402,E501
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis as HA  # noqa: E402
from repro_torch.sharding import blocks as BL  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loop(n_iters):
    w = torch.zeros((64, 64))

    def fn(x):
        for _ in range(n_iters):
            x = torch.tanh(x @ w)
        return x
    return fn


def _ref_scan(n_iters):
    w = jnp.zeros((64, 64), jnp.float32)

    def fn(x):
        y, _ = jax.lax.scan(lambda x, _: (jnp.tanh(x @ w), None), x, None,
                            length=n_iters)
        return y

    return RHA.analyze(jax.jit(fn).lower(jax.ShapeDtypeStruct(
        (8, 64), jnp.float32)).compile().as_text())


def test_flops_scale_with_trip_count():
    x = torch.zeros((8, 64))
    c = {n: HA.analyze(_loop(n), x)[1] for n in (1, 2, 8)}
    assert c[1].flops == 2 * 8 * 64 * 64 + 8 * 64 == 66_048
    assert c[8].flops == 4 * c[2].flops == 528_384
    # the reference's scan adds its loop counter's add and compare
    assert c[8].flops == _ref_scan(8).flops - 2 * 8


def test_one_product_counts_as_the_reference():
    _, c = HA.analyze(torch.matmul, torch.zeros((8, 64)),
                      torch.zeros((64, 32)))
    want = RHA.analyze(jax.jit(jnp.matmul).lower(
        jax.ShapeDtypeStruct((8, 64), jnp.float32),
        jax.ShapeDtypeStruct((64, 32), jnp.float32)).compile().as_text())
    assert (c.flops, c.bytes) == (32_768, 11_264)
    assert (c.flops, c.bytes) == (want.flops, want.bytes)


def test_all_reduce_over_a_plan_counts_as_the_reference():
    group = BL.axis_group(BL.MeshPlan((4, 1), ("data", "model")), "data")
    t = torch.empty((16, 16), device="meta")
    out, c = HA.analyze(BL.all_reduce, t, group)
    want = RHA.analyze("""
ENTRY %main (p: f32[16,16]) -> f32[16,16] {
  %p = f32[16,16]{1,0} parameter(0)
  ROOT %ar = f32[16,16]{1,0} all-reduce(%p), replica_groups={{0,1,2,3}}, to_apply=%add
}
""")
    assert out is t and out.is_meta
    assert (c.coll_count, c.coll_bytes, c.coll_effective) == \
        (1, 1024, 1536)
    assert (c.coll_count, c.coll_bytes, c.coll_effective, c.coll_by_op) \
        == (want.coll_count, want.coll_bytes, want.coll_effective,
            want.coll_by_op)
    # over one rank: no group, nothing recorded
    assert BL.axis_group(BL.ONE_RANK, "data") is None


def test_costs_add_and_scale_as_the_reference():
    a = HA.Costs(1.0, 2.0, 3.0, 4.0, {"all-reduce": 3.0}, 1, 10.0,
                 {"streaming_gemm": 2})
    b = HA.Costs(5.0, 6.0, 7.0, 8.0, {"all-gather": 7.0}, 2, 30.0,
                 {"streaming_gemm": 1, "flash_attention": 1})
    r = RHA.Costs(1.0, 2.0, 3.0, 4.0, {"all-reduce": 3.0}, 1)
    r += RHA.Costs(5.0, 6.0, 7.0, 8.0, {"all-gather": 7.0}, 2)
    a += b
    assert (a.flops, a.bytes, a.coll_bytes, a.coll_effective, a.coll_by_op,
            a.coll_count) == (r.flops, r.bytes, r.coll_bytes,
                              r.coll_effective, r.coll_by_op, r.coll_count)
    assert a.peak_bytes == 30.0
    assert a.kernel_ops == {"streaming_gemm": 3, "flash_attention": 1}
    s = a.scaled(3)
    assert (s.flops, s.coll_count, s.peak_bytes, s.kernel_ops) == \
        (18.0, 9, 30.0, {"streaming_gemm": 9, "flash_attention": 3})


# ------------------------------------------------------- every wrapper
def _rand(shape, dtype, g, device):
    return torch.randn(shape, generator=g).to(dtype).to(device)


def _wrapper_calls(device):
    """(name, fn, args) of each wrapper at shapes its launcher takes."""
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def r(*shape, dtype=bf):
        return _rand(shape, dtype, g, device)

    def pools(P, page, KH, D):
        return (torch.zeros((P, page, KH, D), dtype=torch.int8,
                            device=device),
                torch.zeros((P, page, KH, D), dtype=torch.int8,
                            device=device),
                torch.ones((P, KH, page), dtype=torch.float16,
                           device=device),
                torch.ones((P, KH, page), dtype=torch.float16,
                           device=device))

    table = torch.arange(8, dtype=torch.int32, device=device).view(2, 4)
    lens = torch.tensor([37, 64], dtype=torch.int32, device=device)
    counts = torch.tensor([3, 0, 8, 5], dtype=torch.int32, device=device)
    rows = torch.tensor([5, 70], dtype=torch.int64, device=device)

    def gemm_grad(a, b):
        a = a.detach().requires_grad_(True)
        b = b.detach().requires_grad_(True)
        ops.streaming_gemm(a, b).float().sum().backward()
        return a.grad, b.grad

    def grouped_grad(a, b, counts):
        a = a.detach().requires_grad_(True)
        b = b.detach().requires_grad_(True)
        ops.grouped_streaming_gemm(a, b, counts).float().sum().backward()
        return a.grad, b.grad

    def paged_int8(q, table, lens):
        kp, vp, ks, vs = pools(8, 16, 2, 64)
        return ops.paged_attention(q, kp, vp, table, lens, ks, vs)

    def append(q, k, v, rows, table, lens):
        return ops.paged_attention_append(q, k, v, rows, pools(8, 16, 2, 64),
                                          table, lens)

    def quantize(k, v, rows):
        ops.kv_quantize_append(k, v, rows, *pools(8, 16, 2, 64))

    return [
        ("gemm", ops.streaming_gemm, (r(8, 64), r(64, 40))),
        ("gemm fp32", ops.streaming_gemm, (r(8, 64, dtype=torch.float32),
                                          r(64, 40, dtype=torch.float32))),
        ("gemm backward", gemm_grad, (r(16, 64), r(64, 40))),
        ("grouped", ops.grouped_streaming_gemm, (r(4, 8, 64), r(4, 64, 32),
                                                 counts)),
        ("grouped backward", grouped_grad, (r(4, 8, 64), r(4, 64, 32),
                                            counts)),
        ("flash causal", ops.flash_attention,
         (r(2, 48, 4, 64), r(2, 48, 2, 64), r(2, 48, 2, 64))),
        ("flash full, Tq != Tk", lambda q, k, v: ops.flash_attention(
            q, k, v, causal=False, bk=32),
         (r(2, 16, 4, 64), r(2, 64, 2, 64), r(2, 64, 2, 64))),
        ("flash 192 / 128", ops.flash_attention,
         (r(1, 32, 4, 192), r(1, 32, 4, 192), r(1, 32, 4, 128))),
        ("paged", ops.paged_attention,
         (r(2, 4, 64), r(8, 16, 2, 64), r(8, 16, 2, 64), table, lens)),
        ("paged int8", paged_int8, (r(2, 4, 64), table, lens)),
        ("paged int8 append", append,
         (r(2, 4, 64), r(2, 2, 64), r(2, 2, 64), rows, table, lens)),
        ("paged latent", lambda q, p, t, ln: ops.paged_latent_attention(
            q, p, t, ln, 512, 0.05),
         (r(2, 16, 576), r(8, 16, 1, 576), table, lens)),
        ("kv quantize", quantize, (r(2, 2, 64), r(2, 2, 64), rows)),
    ]


WRAPPERS = [c[0] for c in _wrapper_calls("cpu")]


@pytest.mark.parametrize("name", WRAPPERS)
def test_each_wrapper_counts_the_same_on_cpu_and_meta(name):
    got = {}
    for device in ("cpu", "meta"):
        _, fn, args = next(c for c in _wrapper_calls(device)
                           if c[0] == name)
        ops.reset_launches()
        out, c = HA.analyze(fn, *args)
        assert sum(ops.LAUNCHES.values()) == 0
        got[device] = c
        if device == "meta":
            for t in HA._tensors(out, []):
                assert t.is_meta
    cpu, meta = got["cpu"], got["meta"]
    assert (cpu.flops, cpu.bytes, cpu.kernel_ops) == \
        (meta.flops, meta.bytes, meta.kernel_ops)
    assert cpu.flops > 0 and sum(cpu.kernel_ops.values()) >= 1


def test_wrapper_records_follow_the_shape_formulas():
    a, b = torch.zeros((8, 64)), torch.zeros((64, 40))
    _, c = HA.analyze(ops.streaming_gemm, a, b)
    assert c.kernel_ops == {"streaming_gemm": 1}
    assert (c.flops, c.bytes) == (2 * 8 * 40 * 64,
                                  4 * (8 * 64 + 64 * 40 + 8 * 40))
    q = torch.zeros((2, 4, 64), dtype=torch.bfloat16, device="meta")
    kp = torch.zeros((8, 16, 2, 64), dtype=torch.bfloat16, device="meta")
    table = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    lens = torch.zeros((2,), dtype=torch.int32, device="meta")
    _, c = HA.analyze(ops.paged_attention, q, kp, kp, table, lens)
    n_tok = 2 * 4 * 16          # the table's capacity, not the lengths
    assert c.flops == 4 * 4 * 64 * n_tok
    assert c.bytes == 2 * 2 * (2 * 4 * 64) + 4 * 8 + 4 * 2 \
        + 2 * 2 * n_tok * 2 * 64
    assert HA.causal_pairs(4, 4) == 10 and HA.causal_pairs(2, 5) == 3 \
        and HA.causal_pairs(5, 2) == 3 + 3 * 2


def test_peak_counts_live_storages_once():
    x = torch.zeros((256,))            # 1 KB argument

    def fn(x):
        y = x * 2                      # +1 KB
        v = y[:128]                    # a view: nothing new
        z = v + 1                      # +512 B
        del y                          # v keeps its storage alive
        s = z.sum()                    # +4 B
        del v, z                       # -1.5 KB
        return s * 2                   # +4 B

    _, c = HA.analyze(fn, x)
    assert c.peak_bytes == 1024 + 1024 + 512 + 4


# --------------------------------------------------------- whole steps
def _mla_card_dims():
    """The reduced deepseek-v3 at MLA head dims the card's kernels take
    (flash 192 / 128, the latent kernel's 576 / 512 over 16 heads)."""
    cfg = get_reduced("deepseek_v3_671b")
    return dataclasses.replace(cfg, n_heads=16, n_kv_heads=16,
                               mla=MLAConfig(q_lora_rank=32))


def _counts(cfg, kind, device, seq=32, batch=2):
    run = RunConfig(model=cfg, shape=ShapeConfig(kind, kind, seq, batch))
    fn, args, donated = dryrun.cell_step(run, BL.ONE_RANK, device)
    ops.reset_launches()
    _, c, _ = dryrun.count(fn, args, donated)
    assert sum(ops.LAUNCHES.values()) == 0
    return c


def _same(cpu, meta):
    key = (lambda c: (c.flops, c.bytes, c.coll_bytes, c.coll_effective,
                      c.coll_by_op, c.coll_count, c.kernel_ops))
    assert key(cpu) == key(meta)
    assert cpu.flops > 0 and cpu.kernel_ops.get("streaming_gemm", 0) > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_counts_the_same_on_cpu_and_meta(arch):
    cfg = get_reduced(arch)
    _same(_counts(cfg, "train", "cpu"), _counts(cfg, "train", "meta"))


SERVING = {"dense": "qwen2_0_5b", "vlm": "internvl2_2b",
           "moe": "qwen2_moe_a2_7b", "mla": None, "audio": "whisper_tiny",
           "ssm": "rwkv6_7b", "hybrid": "zamba2_7b"}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("family", list(SERVING))
def test_serving_steps_count_the_same_on_cpu_and_meta(family, kind):
    arch = SERVING[family]
    cfg = _mla_card_dims() if arch is None else get_reduced(arch)
    cpu, meta = (_counts(cfg, kind, d) for d in ("cpu", "meta"))
    _same(cpu, meta)
    kernel = {"prefill": "flash_attention",
              "decode": "paged_latent_attention" if arch is None
              else "paged_attention"}[kind]
    # rwkv6 attends through its recurrent state: no attention kernel
    assert (meta.kernel_ops.get(kernel, 0) > 0) == (family != "ssm")
    if family in ("moe", "mla"):
        assert meta.kernel_ops["streaming_gemm_grouped"] > 0


def test_moe_dispatch_runs_without_host_values():
    from repro_torch.models import moe
    cfg = get_reduced("qwen2_moe_a2_7b")
    p = moe.moe_pspecs(cfg)
    bf = torch.bfloat16
    params = {k: torch.zeros(v.shape, dtype=bf, device="meta",
                             requires_grad=True) for k, v in p.items()}
    x = torch.zeros((2, 32, cfg.d_model), dtype=bf, device="meta",
                    requires_grad=True)
    y, aux = moe.apply_moe(params, x, cfg)     # capacity below B·T·k
    (y.sum() + aux).backward()
    assert y.shape == x.shape and x.grad.shape == x.shape
    assert np.prod(params["wi_gate"].grad.shape) > 0
