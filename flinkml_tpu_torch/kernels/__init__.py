"""Hand-written CUDA kernels for Hopper (sm_90a), one per ported site.

The port's counterpart of ``flinkml_tpu.kernels``. Ported so far:

- ``spmv`` — the padded-ELL CSR matvec behind sparse LR scoring
  (:mod:`flinkml_tpu_torch.kernels.spmv`, ``csrc/spmv.cu``);
- ``fused_chain`` — the fused row-local transform chain: one-hot and
  assembling prologue, scalers, and a binomial or multinomial LR or KMeans
  head (:mod:`flinkml_tpu_torch.kernels.chain`, ``csrc/chain.cu``);
- ``segment_sum`` — the sparse gradient scatter-accumulate, unsorted
  (atomic) and sorted (run-flush) (:mod:`flinkml_tpu_torch.kernels.segsum`,
  ``csrc/segsum.cu``);
- ``topk`` — the row-wise top-k behind KNN voting and LSH ranking
  (:mod:`flinkml_tpu_torch.kernels.topk`, ``csrc/topk.cu``).

Every kernel site of the JAX package is ported. Every wrapper
computes its plain PyTorch version for CPU tensors and launches its kernel
for CUDA tensors, or raises :class:`KernelUnsupportedError`; each counts
its launches (:func:`launch_counts`). The submodules keep their names
(``kernels.spmv.spmv`` is the wrapper, ``kernels.chain.fused_chain`` the
chain's, ``kernels.segsum.segment_sum`` the scatter's,
``kernels.topk.top_k`` the selection's). Kernels build with ``nvcc`` at first
use (:mod:`flinkml_tpu_torch.kernels._build`).
"""

from flinkml_tpu_torch.kernels._gate import (  # noqa: F401
    SITES,
    KernelUnsupportedError,
    launch_counts,
    reset_launch_counts,
)
# The kernel modules register their launch counters on import.
from flinkml_tpu_torch.kernels import chain, segsum, spmv, topk  # noqa: F401,E402

__all__ = [
    "SITES",
    "KernelUnsupportedError",
    "chain",
    "launch_counts",
    "reset_launch_counts",
    "segsum",
    "spmv",
    "topk",
]
