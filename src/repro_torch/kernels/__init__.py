from repro_torch.kernels.ops import (  # noqa: F401
    flash_attention,
    grouped_streaming_gemm,
    paged_attention,
    streaming_gemm,
)
