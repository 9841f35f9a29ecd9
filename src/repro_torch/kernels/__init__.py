from repro_torch.kernels.ops import (  # noqa: F401
    flash_attention,
    paged_attention,
    streaming_gemm,
)
