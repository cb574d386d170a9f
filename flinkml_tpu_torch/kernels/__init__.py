"""Hand-written CUDA kernels for Hopper (sm_90a), one per ported site.

The port's counterpart of ``flinkml_tpu.kernels``. Ported so far:

- ``spmv`` — the padded-ELL CSR matvec behind sparse LR scoring
  (:mod:`flinkml_tpu_torch.kernels.spmv`, ``csrc/spmv.cu``);
- ``fused_chain`` — the fused scaler→LR transform chain
  (:mod:`flinkml_tpu_torch.kernels.chain`, ``csrc/chain.cu``);
- ``segment_sum`` — the sparse gradient scatter-accumulate, unsorted
  (atomic) and sorted (run-flush) (:mod:`flinkml_tpu_torch.kernels.segsum`,
  ``csrc/segsum.cu``).

``topk`` is still to be ported. Every wrapper
computes its plain PyTorch version for CPU tensors and launches its kernel
for CUDA tensors, or raises :class:`KernelUnsupportedError`; each counts
its launches (:func:`launch_counts`). The submodules keep their names
(``kernels.spmv.spmv`` is the wrapper, ``kernels.chain.fused_chain`` the
chain's, ``kernels.segsum.segment_sum`` the scatter's). Kernels build with ``nvcc`` at first
use (:mod:`flinkml_tpu_torch.kernels._build`).
"""

from flinkml_tpu_torch.kernels._gate import (  # noqa: F401
    SITES,
    KernelUnsupportedError,
    launch_counts,
    reset_launch_counts,
)
# The kernel modules register their launch counters on import.
from flinkml_tpu_torch.kernels import chain, segsum, spmv  # noqa: F401,E402

__all__ = [
    "SITES",
    "KernelUnsupportedError",
    "chain",
    "launch_counts",
    "reset_launch_counts",
    "segsum",
    "spmv",
]
