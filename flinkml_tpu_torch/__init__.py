"""flinkml_tpu_torch — the PyTorch/CUDA port of flinkml_tpu.

A second package beside the JAX one (``flinkml_tpu``, the reference), with
the same module paths, the same pipeline API and the same on-disk model
format, on torch tensors. Entry points compute on the CUDA device unless
the caller asks for the CPU (:func:`use_device` /
:func:`set_default_device`); the hot loops are hand-written CUDA kernels
for Hopper (:mod:`flinkml_tpu_torch.kernels`).

Ported so far (LogisticRegression, served and trained): tables, params,
persistence, ``Pipeline``/``PipelineModel`` with the fused executor, the
four scalers (fit + transform), ``LogisticRegression`` (binomial fit on
one device, dense and sparse) and ``LogisticRegressionModel`` (binomial,
dense and sparse transform), and the ``fused_chain``, ``spmv`` and
``segment_sum`` kernels.
"""

from flinkml_tpu_torch.api import (  # noqa: F401
    AlgoOperator,
    ColumnKernel,
    Estimator,
    Model,
    Stage,
    Transformer,
)
from flinkml_tpu_torch.device import (  # noqa: F401
    default_device,
    set_default_device,
    use_device,
)
from flinkml_tpu_torch.io.read_write import (  # noqa: F401
    ModelIntegrityError,
    load_stage,
    stage_from_arrays,
)
from flinkml_tpu_torch.kernels import (  # noqa: F401
    KernelUnsupportedError,
    launch_counts,
    reset_launch_counts,
)
from flinkml_tpu_torch.linalg import (  # noqa: F401
    DenseVector,
    SparseVector,
    Vector,
    Vectors,
)
from flinkml_tpu_torch.models import (  # noqa: F401
    LogisticRegression,
    LogisticRegressionModel,
    MaxAbsScaler,
    MaxAbsScalerModel,
    MinMaxScaler,
    MinMaxScalerModel,
    RobustScaler,
    RobustScalerModel,
    StandardScaler,
    StandardScalerModel,
)
from flinkml_tpu_torch.pipeline import Pipeline, PipelineModel  # noqa: F401
from flinkml_tpu_torch.table import Table  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "AlgoOperator",
    "ColumnKernel",
    "DenseVector",
    "Estimator",
    "KernelUnsupportedError",
    "LogisticRegression",
    "LogisticRegressionModel",
    "MaxAbsScaler",
    "MaxAbsScalerModel",
    "MinMaxScaler",
    "MinMaxScalerModel",
    "Model",
    "ModelIntegrityError",
    "Pipeline",
    "PipelineModel",
    "RobustScaler",
    "RobustScalerModel",
    "SparseVector",
    "Stage",
    "StandardScaler",
    "StandardScalerModel",
    "Table",
    "Transformer",
    "Vector",
    "Vectors",
    "default_device",
    "launch_counts",
    "load_stage",
    "reset_launch_counts",
    "set_default_device",
    "stage_from_arrays",
    "use_device",
]
