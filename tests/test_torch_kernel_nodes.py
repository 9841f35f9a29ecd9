"""The launch-count rule of ``repro_torch.kernels.kernel_nodes``: which
wrapper counter a device kernel's name belongs to, and which captured
nodes are strays.  Capturing needs a card; these checks of the rule do
not (the card tests count real graphs with it)."""
import pytest

from repro_torch.kernels import kernel_nodes as KN
from repro_torch.kernels import ops

# demangled names as the driver and the profiler give them
NAMES = [
    ("void (anonymous namespace)::gemm_bf16<128, 4>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16*, int, int, int)",
     "streaming_gemm"),
    ("void (anonymous namespace)::gemm_simt<float>(float const*)",
     "streaming_gemm"),
    ("void (anonymous namespace)::grouped_wgmma<64>(CUtensorMap, "
     "CUtensorMap, (anonymous namespace)::Problem)",
     "streaming_gemm_grouped"),
    ("void (anonymous namespace)::flash_bf16<128, 128, true>("
     "__nv_bfloat16 const*)", "flash_attention"),
    ("void (anonymous namespace)::flash_f32<64, 64>(float const*)",
     "flash_attention"),
    ("void (anonymous namespace)::paged_fwd<__nv_bfloat16, __nv_bfloat16, "
     "128, 8>(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 "
     "const*, __half const*, __half const*)", "paged_attention"),
    ("void (anonymous namespace)::paged_int8_fwd<128, 16, 1>(CUtensorMap, "
     "CUtensorMap, (anonymous namespace)::Args)", "paged_attention_int8"),
    ("void (anonymous namespace)::paged_latent_tc<6>(__nv_bfloat16 const*)",
     "paged_latent_attention"),
    ("void (anonymous namespace)::kv_quant_append<128>(__nv_bfloat16 "
     "const*, __nv_bfloat16 const*, long const*, signed char*)",
     "kv_quantize"),
    ("void at::native::index_elementwise_kernel<128, 4>(long, "
     "at::native::gpu_index_kernel)", KN.OTHER),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     KN.OTHER),
    (None, KN.NOT_A_KERNEL),
]


@pytest.mark.parametrize("name,group", NAMES)
def test_kernel_group_maps_each_kernel_to_its_counter(name, group):
    assert KN.kernel_group(name) == group


def test_every_counter_has_a_kernel_and_every_group_a_counter():
    groups = {g for _, g in KN.KERNEL_GROUPS} | set(KN.SHARED_KERNELS)
    assert groups == set(ops.LAUNCHES)
    assert set(KN.SHARED_KERNELS.values()) <= groups
    for name in KN.OPS_WRAPPERS:
        assert callable(getattr(ops, name))


def test_strays_are_the_nodes_not_of_the_counter_that_moved():
    """A library kernel, a memset or another wrapper's kernel under a
    counter is a stray; the counter's own kernels are not."""
    gemm, int8 = NAMES[0][0], NAMES[6][0]
    calls = {"streaming_gemm": [[gemm], [gemm]],
             "paged_attention_int8": [[int8]],
             "kv_quantize": [[NAMES[8][0], None]],
             "paged_attention": [[NAMES[10][0]], [int8]]}
    assert KN.strays(calls) == [("kv_quantize", None),
                                ("paged_attention", NAMES[10][0]),
                                ("paged_attention", int8)]
    assert KN.strays({"streaming_gemm": [[gemm]]}) == []
    # the append entry launches the int8 kernel itself: no stray
    assert KN.strays({"paged_attention_int8_append": [[int8]]}) == []
    assert KN.strays({"paged_attention_int8_append": [[gemm]]}) == [
        ("paged_attention_int8_append", gemm)]
