"""The accesys timing simulator: component models, the StreamPlan
replayers and the paper's systems, a numpy copy of the reference
package's ``accesys`` (a model of a MatrixFlow accelerator behind PCIe,
not of the card the port runs on)."""
from repro_torch.accesys import (components, pipeline,  # noqa: F401
                                 system, workloads)
from repro_torch.accesys.pipeline import (replay,  # noqa: F401
                                          replay_compiled, simulate_gemm)
