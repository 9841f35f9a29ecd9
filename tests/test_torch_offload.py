"""The port's ``LayerStreamer`` against the reference's, on the CPU.

The same seeded stacked weights and input go through both streamers in
DM, DC and DevMem, over several passes: outputs within rtol 1e-6 (fp32
products in another order), and the ``StreamReport`` (mode, layers,
bytes streamed) and ``TrafficStats`` equal after every pass.  Then the
port's own dense decoder layer, streamed, against the same layers run
from the model's parameter list.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.modes import MemoryMode as RMode  # noqa: E402
from repro.core.offload import LayerStreamer as RStreamer  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.modes import MemoryMode  # noqa: E402
from repro_torch.core.offload import LayerStreamer, stack_layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

MODES = [(m, RMode(m.value)) for m in MemoryMode]


def _weights(L=6, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((L, d, d)) * 0.2).astype(np.float32),
            # leaves whose byte count the layer count does not divide
            "b": {"bias": rng.standard_normal((L, d)).astype(np.float32),
                  "odd": rng.standard_normal((L, 3)).astype(np.float16)}}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


@pytest.mark.parametrize("mode,rmode", MODES)
@pytest.mark.parametrize("cache_layers", [0, 2, 6])
def test_layer_streamer_matches_reference(mode, rmode, cache_layers):
    L, d = 6, 32
    w = _weights(L, d)
    x0 = np.random.default_rng(1).standard_normal((4, d)).astype(np.float32)
    ref = RStreamer(jax.tree.map(jnp.asarray, w), L, rmode,
                    cache_layers=cache_layers)
    port = LayerStreamer(_to_torch(w), L, mode, cache_layers=cache_layers,
                         device="cpu")
    rfn = lambda p, x: jnp.tanh(x @ p["w"] + p["b"]["bias"])  # noqa: E731
    pfn = lambda p, x: torch.tanh(x @ p["w"] + p["b"]["bias"])  # noqa: E731
    rx, px = jnp.asarray(x0), torch.from_numpy(x0)
    for _ in range(3):
        rx, rrep = ref.run(rfn, rx)
        px, prep = port.run(pfn, px)
        np.testing.assert_allclose(px.numpy(), np.asarray(rx), rtol=1e-6,
                                   atol=1e-6)
        assert (prep.mode, prep.layers, prep.bytes_streamed) == \
            (rrep.mode, rrep.layers, rrep.bytes_streamed)
        assert dataclasses.astuple(port.stats) == \
            dataclasses.astuple(ref.stats)
    assert port._layer_bytes == ref._layer_bytes


def test_layer_streamer_traffic_per_mode():
    L, d = 6, 32
    w = _to_torch(_weights(L, d))
    fn = lambda p, x: torch.tanh(x @ p["w"])  # noqa: E731
    x0 = torch.ones(2, d)
    per_layer = sum(a.numel() * a.element_size() // L
                    for a in (w["w"], w["b"]["bias"], w["b"]["odd"]))
    out = {}
    for mode in MemoryMode:
        s = LayerStreamer(w, L, mode, cache_layers=2, device="cpu")
        sent = []
        for _ in range(3):
            y, rep = s.run(fn, x0)
            sent.append(rep.bytes_streamed)
        out[mode] = y
        if mode is MemoryMode.DEVMEM:
            assert sent == [0, 0, 0]
        elif mode is MemoryMode.DM:
            assert sent == [L * per_layer * i for i in (1, 2, 3)]
        else:          # the first 2 layers fetched stay, never evicted
            assert sent == [L * per_layer + (L - 2) * per_layer * i
                            for i in (0, 1, 2)]
            assert sorted(s._cache) == [0, 1]
    assert torch.equal(out[MemoryMode.DM], out[MemoryMode.DEVMEM])
    assert torch.equal(out[MemoryMode.DC], out[MemoryMode.DEVMEM])


def test_streamed_dense_decoder_equals_the_layer_list():
    """The port's own dense layer (``transformer.dense_layer_fwd``, with
    its GEMM and flash wrappers) streamed from stacked weights gives
    exactly what the model's per-layer parameter list gives."""
    cfg = get_reduced("qwen2_0_5b")
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    stacked = stack_layers(params["layers"])
    assert stacked["attn"]["wq"].shape[0] == cfg.n_layers
    g = torch.Generator().manual_seed(1)
    x0 = torch.randn((2, 12, cfg.d_model), generator=g).to(torch.bfloat16)
    pos = torch.arange(12)[None].expand(2, 12)
    fn = lambda lp, x: T.dense_layer_fwd(lp, x, cfg, pos)[0]  # noqa: E731
    want = x0
    for lp in params["layers"]:
        want = fn(lp, want)
    for mode in MemoryMode:
        s = LayerStreamer(stacked, cfg.n_layers, mode, cache_layers=1,
                          device="cpu")
        got, _ = s.run(fn, x0)
        assert torch.equal(got, want), mode


def test_packed_host_rows_hold_every_leaf_at_an_aligned_offset():
    """DM and DC keep one packed row per layer (one copy per fetch); each
    leaf sits at a 256-byte aligned offset and unpacks to its own bits,
    dtype and shape."""
    L = 5
    w = _to_torch(_weights(L, 24, seed=3))
    s = LayerStreamer(w, L, MemoryMode.DM, device="cpu")
    assert s._host.dtype == torch.uint8 and s._host.shape[0] == L
    assert all(o % LayerStreamer.ALIGN == 0 for o, _, _, _ in s._slots)
    for i in range(L):
        got, ready = s._fetch(i)
        assert ready is None
        for want, out in ((w["w"][i], got["w"]),
                          (w["b"]["bias"][i], got["b"]["bias"]),
                          (w["b"]["odd"][i], got["b"]["odd"])):
            assert out.dtype == want.dtype and out.shape == want.shape
            assert torch.equal(out, want)
