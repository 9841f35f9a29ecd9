"""Port parameters against the reference: the bridge is exact leaf by
leaf, and the port's own init follows the reference's tree and laws."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_reduced as ref_reduced  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.models.params import PSpec, from_reference, init_tree  # noqa: E402


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


ARCHS = ["qwen2_0_5b", "chatglm3_6b", "granite_20b", "internvl2_2b",
         "qwen1_5_32b", "rwkv6_7b", "zamba2_7b"]
# leaves outside the layers (embed, an untied lm_head, the final norm's
# scale and a layernorm's bias; zamba2: the shared block's norm and
# q/k/v/o) and in each layer (norms, q/k/v/o and their biases, the gated
# or plain MLP; rwkv6: two layernorms, the time mix's 9 leaves and the
# channel mix's 4; zamba2: two norms, the Mamba2 block's 7 leaves and the
# gated MLP's 3)
N_LEAVES = {"qwen2_0_5b": (2, 12), "chatglm3_6b": (3, 12),
            "granite_20b": (4, 12), "internvl2_2b": (3, 9),
            "qwen1_5_32b": (3, 12), "rwkv6_7b": (4, 17),
            "zamba2_7b": (8, 12)}


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    cfg = ref_reduced(request.param)
    rp = RefModel(cfg, remat="none").init(jax.random.PRNGKey(0))
    rp_np = jax.tree.map(np.asarray, rp)
    return request.param, rp_np, from_reference(rp_np,
                                                get_reduced(request.param))


def test_from_reference_equals_reference_leaf_by_leaf(bridged):
    arch, rp_np, pp = bridged
    n = 0
    for path, ref_leaf in _leaves({k: v for k, v in rp_np.items()
                                   if k != "layers"}):
        got = dict(_leaves({k: v for k, v in pp.items() if k != "layers"}))
        _assert_same(got[path], ref_leaf)
        n += 1
    for i, layer in enumerate(pp["layers"]):
        ref_layer = jax.tree.map(lambda a: a[i], rp_np["layers"])
        got = dict(_leaves(layer))
        for path, ref_leaf in _leaves(ref_layer):
            _assert_same(got[path], ref_leaf)
            n += 1
    top, per_layer = N_LEAVES[arch]
    assert n == top + get_reduced(arch).n_layers * per_layer


def _assert_same(t, a):
    assert tuple(t.shape) == a.shape
    assert str(t.dtype).removeprefix("torch.") == a.dtype.name
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_pspec_tree_matches_reference(reduced, arch):
    """Same leaves, shapes, init laws and dtypes as the reference tree,
    with the stacked L axis split into a list of layers."""
    rcfg = ref_reduced(arch) if reduced else ref_config(arch)
    pcfg = get_reduced(arch) if reduced else get_config(arch)
    rspec = RT.lm_pspecs(rcfg)
    pspec = PT.lm_pspecs(pcfg)
    assert len(pspec["layers"]) == pcfg.n_layers
    rlayer = dict(_leaves(rspec["layers"]))
    assert sorted(k for k, _ in _leaves(pspec["layers"][0])) == \
        sorted(rlayer)
    assert set(pspec) == set(rspec)
    for path, p in _leaves(pspec["layers"][0]):
        r = rlayer[path]
        assert (pcfg.n_layers,) + p.shape == r.shape
        assert (p.init, p.scale, p.dtype) == (r.init, r.scale, r.dtype)
        assert p.shape[p.fan_axis] == r.shape[r.fan_axis]
    for key in set(rspec) - {"layers"}:
        for (path, p), (_, r) in zip(_leaves(pspec[key]),
                                     _leaves(rspec[key]), strict=True):
            assert (p.shape, p.init, p.scale, p.dtype) == \
                (r.shape, r.init, r.scale, r.dtype), path


def test_init_tree_laws():
    tree = {"w": PSpec((256, 512), ("a", "b")),
            "e": PSpec((512, 64), ("a", "b"), scale=0.02),
            "n": PSpec((64,), ("a",), "ones", dtype="float32"),
            "z": PSpec((8,), ("a",), "zeros")}
    g = torch.Generator().manual_seed(0)
    p = init_tree(tree, g)
    assert p["w"].dtype == torch.bfloat16 and p["n"].dtype == torch.float32
    assert abs(p["w"].float().std().item() - 256 ** -0.5) < 2e-3
    assert abs(p["e"].float().std().item() - 0.02) < 1e-3
    assert torch.equal(p["n"], torch.ones(64))
    assert not p["z"].any()
