"""Stages of the model catalog ported so far: the four scalers and
LogisticRegression (estimator and model)."""

from flinkml_tpu_torch.models.logistic_regression import (  # noqa: F401
    LogisticRegression,
    LogisticRegressionModel,
)
from flinkml_tpu_torch.models.scalers import (  # noqa: F401
    MaxAbsScaler,
    MaxAbsScalerModel,
    MinMaxScaler,
    MinMaxScalerModel,
    RobustScaler,
    RobustScalerModel,
    StandardScaler,
    StandardScalerModel,
)

__all__ = [
    "LogisticRegression",
    "LogisticRegressionModel",
    "MaxAbsScaler",
    "MaxAbsScalerModel",
    "MinMaxScaler",
    "MinMaxScalerModel",
    "RobustScaler",
    "RobustScalerModel",
    "StandardScaler",
    "StandardScalerModel",
]
