"""Feature scaling stages: StandardScaler, MinMaxScaler, MaxAbsScaler,
RobustScaler.

The port's counterpart of ``flinkml_tpu.models.scalers``. Fit statistics
are torch reductions on the compute device over the features cast to
float32, as the JAX package's sharded passes compute them: the mean is
shift-centered and the variance takes the two-pass centered form, so
float32 never cancels; RobustScaler's quantiles are exact ``np.quantile``
on the host.

Each fitted model's ``transform`` and its ``transform_kernel`` run the SAME
plain PyTorch math (``_apply``), so the per-stage and fused paths agree
exactly on the CPU. Dtype rule (as in the JAX package): a floating input
keeps its dtype — the float64 statistics are cast DOWN to it, and the zero
guards apply after that cast — and a non-float input promotes to float64.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.api import ColumnKernel, Estimator, Model
from flinkml_tpu_torch.common_params import HasInputCol, HasOutputCol
from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.models._data import features_matrix, features_tensor
from flinkml_tpu_torch.params import BoolParam, FloatParam, ParamValidators
from flinkml_tpu_torch.table import Table


class _HasInputOutputCol(HasInputCol, HasOutputCol):
    """Shared single-column in/out mixin."""


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return x.dtype if x.dtype.is_floating_point else torch.float64


def _guard(v: torch.Tensor) -> torch.Tensor:
    """Zero guard: a non-positive scale divides by 1 (constant feature)."""
    return torch.where(v > 0, v, 1.0)


class _ScalerModel(_HasInputOutputCol, Model):
    """Shared model scaffold: named float64 statistic vectors on the host
    (``ARRAYS``), the per-stage transform, and the ColumnKernel. A subclass
    sets ``ARRAYS`` and implements ``_flags`` (the configuration baked into
    the fingerprint) and ``_apply`` (the elementwise math)."""

    ARRAYS: Tuple[str, ...] = ()

    def __init__(self):
        super().__init__()
        self._data: Optional[Dict[str, np.ndarray]] = None

    def _flags(self) -> tuple:
        return ()

    @staticmethod
    def _apply(x: torch.Tensor, c: Mapping[str, torch.Tensor], flags) -> torch.Tensor:
        raise NotImplementedError

    # -- model data ----------------------------------------------------------
    def set_model_data(self, *inputs: Table):
        (table,) = inputs
        self._data = {
            k: np.asarray(table.column(k), np.float64)[0] for k in self.ARRAYS
        }
        return self

    def get_model_data(self) -> List[Table]:
        self._require()
        return [Table({k: v[None, :] for k, v in self._data.items()})]

    def _arrays(self) -> Dict[str, np.ndarray]:
        self._require()
        return dict(self._data)

    def _set_arrays(self, arrays: Mapping[str, np.ndarray]) -> None:
        data = {}
        for k in self.ARRAYS:
            v = np.asarray(arrays[k], np.float64)
            data[k] = v[0] if v.ndim == 2 and v.shape[0] == 1 else v
        self._data = data

    def _require(self) -> None:
        if self._data is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    # -- transform -------------------------------------------------------------
    def _fn(self):
        in_col = self.get(self.INPUT_COL)
        out_col = self.get(self.OUTPUT_COL)
        flags = self._flags()
        apply = self._apply

        def fn(cols, consts, valid):
            x = cols[in_col]
            if x.dim() == 1:
                x = x.reshape(-1, 1)
            dt = _compute_dtype(x)
            c = {k: torch.as_tensor(v).to(device=x.device, dtype=dt)
                 for k, v in consts.items()}
            return {out_col: apply(x.to(dt), c, flags)}

        return fn

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        in_col = self.get(self.INPUT_COL)
        out = self._fn()({in_col: features_tensor(table, in_col)}, self._data,
                         None)
        return (table.with_column(self.get(self.OUTPUT_COL),
                                  out[self.get(self.OUTPUT_COL)]),)

    def transform_kernel(self) -> Optional[ColumnKernel]:
        if self._data is None:
            return None
        in_col = self.get(self.INPUT_COL)
        out_col = self.get(self.OUTPUT_COL)
        return ColumnKernel(
            input_cols=(in_col,),
            output_cols=(out_col,),
            fn=self._fn(),
            constants=dict(self._data),
            fingerprint=(type(self).__name__, in_col, out_col) + self._flags(),
        )


def _fit_matrix(table: Table, col: str) -> torch.Tensor:
    """The features as float32 on the compute device (the fit passes'
    working type, as in the JAX package)."""
    x = features_matrix(table, col)
    return torch.from_numpy(x.astype(np.float32)).to(default_device())


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float64).cpu().numpy()


class StandardScaler(_HasInputOutputCol, Estimator):
    """Standardize features to zero mean / unit variance (configurable)."""

    WITH_MEAN = BoolParam("withMean", "Center features to mean zero.", True)
    WITH_STD = BoolParam("withStd", "Scale features to unit std.", True)

    def fit(self, *inputs: Table) -> "StandardScalerModel":
        (table,) = inputs
        xd = _fit_matrix(table, self.get(self.INPUT_COL))
        n = float(xd.shape[0])
        # The mean pass is shift-centered: summing (x - shift) with shift ≈
        # a typical value keeps the float32 accumulator small.
        shift = xd[0]
        s = torch.sum(xd - shift, dim=0)
        mean = _host(shift) + _host(s) / n
        # Two-pass variance: sum (x - mean)^2 — the one-pass
        # E[x^2] - E[x]^2 form cancels when |mean| >> std.
        c = xd - torch.as_tensor(mean, dtype=torch.float32, device=xd.device)
        sq = torch.sum(c * c, dim=0)
        var = np.maximum(_host(sq) / n, 0.0)
        model = StandardScalerModel()
        model.copy_params_from(self)
        model.set_model_data(
            Table({"mean": mean[None, :], "std": np.sqrt(var)[None, :]})
        )
        return model


class StandardScalerModel(_ScalerModel):
    WITH_MEAN = StandardScaler.WITH_MEAN
    WITH_STD = StandardScaler.WITH_STD
    ARRAYS = ("mean", "std")

    def _flags(self) -> tuple:
        return (self.get(self.WITH_MEAN), self.get(self.WITH_STD))

    @staticmethod
    def _apply(x, c, flags):
        with_mean, with_std = flags
        out = x
        if with_mean:
            out = out - c["mean"]
        if with_std:
            out = out / _guard(c["std"])
        return out


class MinMaxScaler(_HasInputOutputCol, Estimator):
    """Rescale features into [min, max] (default [0, 1])."""

    MIN = FloatParam("min", "Lower bound of the output range.", 0.0)
    MAX = FloatParam("max", "Upper bound of the output range.", 1.0)

    def fit(self, *inputs: Table) -> "MinMaxScalerModel":
        (table,) = inputs
        if self.get(self.MIN) >= self.get(self.MAX):
            raise ValueError(
                f"min {self.get(self.MIN)} must be < max {self.get(self.MAX)}"
            )
        xd = _fit_matrix(table, self.get(self.INPUT_COL))
        model = MinMaxScalerModel()
        model.copy_params_from(self)
        model.set_model_data(Table({
            "dataMin": _host(torch.amin(xd, dim=0))[None, :],
            "dataMax": _host(torch.amax(xd, dim=0))[None, :],
        }))
        return model


class MinMaxScalerModel(_ScalerModel):
    MIN = MinMaxScaler.MIN
    MAX = MinMaxScaler.MAX
    ARRAYS = ("dataMin", "dataMax")

    def _flags(self) -> tuple:
        return (self.get(self.MIN), self.get(self.MAX))

    @staticmethod
    def _apply(x, c, flags):
        lo, hi = flags
        span = c["dataMax"] - c["dataMin"]
        # Constant features map to the middle of the output range.
        unit = torch.where(span > 0, (x - c["dataMin"]) / _guard(span), 0.5)
        # The range's scale and offset round to the unit's dtype first, as
        # the JAX package's python scalars do (torch would keep them in
        # float32 against a bfloat16 tensor).
        return (unit * torch.tensor(hi - lo, dtype=unit.dtype)
                + torch.tensor(lo, dtype=unit.dtype))


class MaxAbsScaler(_HasInputOutputCol, Estimator):
    """Scale each feature into [-1, 1] by its max absolute value:
    max|x| = max(|min|, |max|) of the extrema pass."""

    def fit(self, *inputs: Table) -> "MaxAbsScalerModel":
        (table,) = inputs
        xd = _fit_matrix(table, self.get(self.INPUT_COL))
        max_abs = np.maximum(np.abs(_host(torch.amin(xd, dim=0))),
                             np.abs(_host(torch.amax(xd, dim=0))))
        model = MaxAbsScalerModel()
        model.copy_params_from(self)
        model.set_model_data(Table({"maxAbs": max_abs[None, :]}))
        return model


class MaxAbsScalerModel(_ScalerModel):
    ARRAYS = ("maxAbs",)

    @staticmethod
    def _apply(x, c, flags):
        return x / _guard(c["maxAbs"])


class RobustScaler(_HasInputOutputCol, Estimator):
    """Scale by quantile range (robust to outliers): optionally center by
    the median, scale by ``quantile(upper) - quantile(lower)``. Quantiles
    are exact, one vectorized ``np.quantile`` pass on the host."""

    LOWER = FloatParam(
        "lower", "Lower quantile of the scaling range.", 0.25,
        ParamValidators.in_range(0.0, 1.0),
    )
    UPPER = FloatParam(
        "upper", "Upper quantile of the scaling range.", 0.75,
        ParamValidators.in_range(0.0, 1.0),
    )
    WITH_CENTERING = BoolParam(
        "withCentering", "Whether to subtract the median.", False
    )
    WITH_SCALING = BoolParam(
        "withScaling", "Whether to divide by the quantile range.", True
    )

    def fit(self, *inputs: Table) -> "RobustScalerModel":
        (table,) = inputs
        lower, upper = self.get(self.LOWER), self.get(self.UPPER)
        if lower >= upper:
            raise ValueError(f"lower {lower} must be < upper {upper}")
        x = features_matrix(table, self.get(self.INPUT_COL)).astype(np.float64)
        median = np.quantile(x, 0.5, axis=0)
        q_lo = np.quantile(x, lower, axis=0)
        q_hi = np.quantile(x, upper, axis=0)
        model = RobustScalerModel()
        model.copy_params_from(self)
        model.set_model_data(
            Table({"median": median[None, :], "range": (q_hi - q_lo)[None, :]})
        )
        return model


class RobustScalerModel(_ScalerModel):
    LOWER = RobustScaler.LOWER
    UPPER = RobustScaler.UPPER
    WITH_CENTERING = RobustScaler.WITH_CENTERING
    WITH_SCALING = RobustScaler.WITH_SCALING
    ARRAYS = ("median", "range")

    def _flags(self) -> tuple:
        return (self.get(self.WITH_CENTERING), self.get(self.WITH_SCALING))

    @staticmethod
    def _apply(x, c, flags):
        centering, scaling = flags
        out = x
        if centering:
            out = out - c["median"]
        if scaling:
            out = out / _guard(c["range"])
        return out
