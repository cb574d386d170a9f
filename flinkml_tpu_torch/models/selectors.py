"""Feature statistics + selection: ChiSqTest, ANOVATest, FValueTest,
VarianceThresholdSelector, UnivariateFeatureSelector.

The port's counterpart of ``flinkml_tpu.models.selectors``. The variance
is the scalers' two shift-centered float32 passes on the compute device
(each summed over a mesh's ranks with one ``all_reduce``); the
chi-square contingency tables, the F-tests and their p-values are exact
host numpy, as in the JAX package (the tables are tiny, and the heavy
part, the selector's transform, is a column slice).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

import torch

from flinkml_tpu_torch.api import AlgoOperator, Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasFeaturesCol,
    HasLabelCol,
    HasOutputCol,
)
from flinkml_tpu_torch.models._data import features_matrix
from flinkml_tpu_torch.models.pca import shard_with_mask
from flinkml_tpu_torch.params import FloatParam, ParamValidators, StringParam
from flinkml_tpu_torch.parallel.mesh import DeviceMesh, check_mesh
from flinkml_tpu_torch.table import Table


def _mesh_sum(mesh: DeviceMesh, t: torch.Tensor) -> np.ndarray:
    """``t`` summed over the mesh's ranks (one ``all_reduce``), as host
    float64."""
    if mesh.group(DeviceMesh.DATA_AXIS) is not None:
        from flinkml_tpu_torch.parallel.collectives import all_reduce_

        all_reduce_(mesh, t)
    return t.cpu().numpy().astype(np.float64)


def feature_variance(x: np.ndarray, mesh: DeviceMesh) -> np.ndarray:
    """Population variance per feature: a float32 sum of ``x - x[0]``
    and the count, the mean in float64 on the host, then a float32 sum
    of ``(x - mean)²`` (the JAX scalers' ``_sum_fn`` and
    ``_centered_sumsq_fn``)."""
    xd, wd = shard_with_mask(x, mesh)
    shift = torch.from_numpy(np.asarray(x[0], np.float32)).to(xd.device)
    sn = _mesh_sum(mesh, torch.cat([
        torch.sum((xd - shift) * wd[:, None], dim=0),
        torch.sum(wd).reshape(1)]))
    s, n = sn[:-1], float(np.float32(sn[-1]))
    mean = np.asarray(x[0], np.float32).astype(np.float64) + s / n
    c = xd - torch.from_numpy(mean.astype(np.float32)).to(xd.device)
    sq = _mesh_sum(mesh, torch.sum(c * c * wd[:, None], dim=0))
    return np.maximum(sq / n, 0.0)


# -- chi-square ---------------------------------------------------------------

def _chi2_sf(x: float, df: int) -> float:
    """Survival function of the chi-square distribution via the
    regularized upper incomplete gamma Q(df/2, x/2) (no scipy needed)."""
    if x <= 0:
        return 1.0
    a, half_x = df / 2.0, x / 2.0
    # Series for P when x < a+1, continued fraction for Q otherwise
    # (Numerical Recipes 6.2).
    if half_x < a + 1.0:
        term = 1.0 / a
        total = term
        n = a
        for _ in range(500):
            n += 1.0
            term *= half_x / n
            total += term
            if abs(term) < abs(total) * 1e-15:
                break
        p = total * math.exp(-half_x + a * math.log(half_x) - math.lgamma(a))
        return max(0.0, min(1.0, 1.0 - p))
    b = half_x + 1.0 - a
    c = 1e300
    d = 1.0 / b
    h = d
    for i in range(1, 500):
        an = -i * (i - a)
        b += 2.0
        d = an * d + b
        d = 1.0 / d if abs(d) > 1e-300 else 1e300
        c = b + an / c
        if abs(c) < 1e-300:
            c = 1e-300
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 1e-15:
            break
    q = h * math.exp(-half_x + a * math.log(half_x) - math.lgamma(a))
    return max(0.0, min(1.0, q))


def chi_square_test(x: np.ndarray, y: np.ndarray):
    """Pearson chi-square independence test of each categorical feature
    column against the label. Returns (statistics, p_values, dof) arrays.
    """
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    y = np.asarray(y).reshape(-1)
    if y.shape[0] != x.shape[0]:
        raise ValueError("label rows != feature rows")
    _, yi = np.unique(y, return_inverse=True)
    n_classes = yi.max() + 1
    stats, pvals, dofs = [], [], []
    for j in range(x.shape[1]):
        cats, ci = np.unique(x[:, j], return_inverse=True)
        k = len(cats)
        observed = np.bincount(
            ci * n_classes + yi, minlength=k * n_classes
        ).reshape(k, n_classes).astype(np.float64)
        row = observed.sum(axis=1, keepdims=True)
        col = observed.sum(axis=0, keepdims=True)
        expected = row @ col / observed.sum()
        with np.errstate(divide="ignore", invalid="ignore"):
            contrib = np.where(
                expected > 0, (observed - expected) ** 2 / expected, 0.0
            )
        stat = float(contrib.sum())
        dof = (k - 1) * (n_classes - 1)
        stats.append(stat)
        dofs.append(dof)
        pvals.append(_chi2_sf(stat, dof) if dof > 0 else 1.0)
    return np.asarray(stats), np.asarray(pvals), np.asarray(dofs)


class ChiSqTest(HasFeaturesCol, HasLabelCol, AlgoOperator):
    """Per-feature chi-square independence test against the label.

    Output table: one row per feature with ``featureIndex``, ``pValue``,
    ``statistic``, ``degreesOfFreedom`` (the upstream ChiSqTest layout).
    """

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        x = features_matrix(table, self.get(self.FEATURES_COL))
        y = table.column(self.get(self.LABEL_COL))
        stats, pvals, dofs = chi_square_test(x, y)
        return (
            Table({
                "featureIndex": np.arange(x.shape[1]),
                "pValue": pvals,
                "statistic": stats,
                "degreesOfFreedom": dofs,
            }),
        )


# -- f-test (one-way ANOVA) ---------------------------------------------------

def _f_sf(f: float, d1: int, d2: int) -> float:
    """Survival function of the F distribution via the regularized
    incomplete beta function (continued fraction, NR 6.4)."""
    if f <= 0:
        return 1.0
    x = d2 / (d2 + d1 * f)   # P(F > f) = I_x(d2/2, d1/2)
    a, b = d2 / 2.0, d1 / 2.0

    def betacf(a, b, x):
        qab, qap, qam = a + b, a + 1.0, a - 1.0
        c = 1.0
        d = 1.0 - qab * x / qap
        if abs(d) < 1e-300:
            d = 1e-300
        d = 1.0 / d
        h = d
        for m in range(1, 300):
            m2 = 2 * m
            aa = m * (b - m) * x / ((qam + m2) * (a + m2))
            d = 1.0 + aa * d
            if abs(d) < 1e-300:
                d = 1e-300
            c = 1.0 + aa / c
            if abs(c) < 1e-300:
                c = 1e-300
            d = 1.0 / d
            h *= d * c
            aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
            d = 1.0 + aa * d
            if abs(d) < 1e-300:
                d = 1e-300
            c = 1.0 + aa / c
            if abs(c) < 1e-300:
                c = 1e-300
            d = 1.0 / d
            delta = d * c
            h *= delta
            if abs(delta - 1.0) < 1e-14:
                break
        return h

    ln_front = (
        math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
        + a * math.log(x) + b * math.log(1.0 - x)
    )
    if x < (a + 1.0) / (a + b + 2.0):
        val = math.exp(ln_front) * betacf(a, b, x) / a
    else:
        val = 1.0 - math.exp(
            math.lgamma(a + b) - math.lgamma(b) - math.lgamma(a)
            + b * math.log(1.0 - x) + a * math.log(x)
        ) * betacf(b, a, 1.0 - x) / b
    return max(0.0, min(1.0, val))


def f_classif_test(x: np.ndarray, y: np.ndarray):
    """One-way ANOVA F-test per feature (sklearn ``f_classif``)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y).reshape(-1)
    classes, yi = np.unique(y, return_inverse=True)
    k, n = len(classes), x.shape[0]
    if k < 2:
        raise ValueError("f-test requires at least 2 classes")
    overall = x.mean(axis=0)
    ss_between = np.zeros(x.shape[1])
    ss_within = np.zeros(x.shape[1])
    for c in range(k):
        xc = x[yi == c]
        mc = xc.mean(axis=0)
        ss_between += len(xc) * (mc - overall) ** 2
        ss_within += ((xc - mc) ** 2).sum(axis=0)
    d1, d2 = k - 1, n - k
    with np.errstate(divide="ignore", invalid="ignore"):
        f = (ss_between / d1) / (ss_within / d2)
    # ss_within == 0: a perfectly discriminative feature scores F = inf
    # (p = 0), matching sklearn; 0/0 (constant feature) scores 0.
    f = np.where(ss_within > 0, f,
                 np.where(ss_between > 0, np.inf, 0.0))
    p = np.asarray([
        0.0 if np.isinf(v) else _f_sf(float(v), d1, d2) for v in f
    ])
    return f, p


# -- selectors ----------------------------------------------------------------

class _SelectorModelBase(HasFeaturesCol, HasOutputCol, Model):
    """Shared transform/persistence for index-keeping selector models."""

    def __init__(self):
        super().__init__()
        self._indices: Optional[np.ndarray] = None

    def set_model_data(self, *inputs: Table):
        (table,) = inputs
        self._set_arrays({"selected": table.column("selected")})
        return self

    def get_model_data(self) -> List[Table]:
        self._require()
        return [Table({"selected": self._indices.copy()})]

    @property
    def selected_indices(self) -> np.ndarray:
        self._require()
        return self._indices

    def _require(self) -> None:
        if self._indices is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        x = features_matrix(table, self.get(self.FEATURES_COL))
        if self._indices.size and self._indices.max() >= x.shape[1]:
            raise ValueError(
                f"model selects index {self._indices.max()} but features "
                f"have dim {x.shape[1]}"
            )
        return (
            table.with_column(self.get(self.OUTPUT_COL), x[:, self._indices]),
        )

    def _arrays(self):
        self._require()
        return {"selected": self._indices}

    def _set_arrays(self, arrays) -> None:
        self._indices = np.asarray(arrays["selected"]).reshape(-1).astype(
            np.int64)


class VarianceThresholdSelector(HasFeaturesCol, HasOutputCol, Estimator):
    """Keep features whose (population) variance exceeds
    ``varianceThreshold`` (default 0: drop constants). Variance comes
    from the same sharded two-pass mesh reduction as StandardScaler."""

    VARIANCE_THRESHOLD = FloatParam(
        "varianceThreshold", "Features with variance <= this are dropped.",
        0.0, ParamValidators.gt_eq(0.0),
    )

    def __init__(self, mesh: Optional[DeviceMesh] = None):
        check_mesh(mesh)
        super().__init__()
        self.mesh = mesh

    def fit(self, *inputs: Table) -> "VarianceThresholdSelectorModel":
        (table,) = inputs
        x = features_matrix(table, self.get(self.FEATURES_COL))
        var = feature_variance(x, self.mesh or DeviceMesh())
        keep = np.nonzero(var > self.get(self.VARIANCE_THRESHOLD))[0]
        model = VarianceThresholdSelectorModel()
        model.copy_params_from(self)
        model.set_model_data(Table({"selected": keep}))
        return model


class VarianceThresholdSelectorModel(_SelectorModelBase):
    VARIANCE_THRESHOLD = VarianceThresholdSelector.VARIANCE_THRESHOLD


class _UnivariateParams(HasFeaturesCol, HasLabelCol, HasOutputCol):
    SCORE_FUNCTION = StringParam(
        "scoreFunction", "Scoring test.", "chi2",
        ParamValidators.in_array(["chi2", "fClassif"]),
    )
    SELECTION_MODE = StringParam(
        "selectionMode", "How to pick features.", "numTopFeatures",
        ParamValidators.in_array(["numTopFeatures", "percentile", "fpr"]),
    )
    SELECTION_THRESHOLD = FloatParam(
        "selectionThreshold",
        "numTopFeatures: count; percentile: fraction in (0,1]; fpr: "
        "p-value bound.",
        None,
    )


class UnivariateFeatureSelector(_UnivariateParams, Estimator):
    """Select features by a univariate statistical test against the
    label — ``chi2`` (categorical features) or ``fClassif`` (ANOVA,
    continuous features)."""

    def fit(self, *inputs: Table) -> "UnivariateFeatureSelectorModel":
        (table,) = inputs
        x = features_matrix(table, self.get(self.FEATURES_COL))
        y = table.column(self.get(self.LABEL_COL))
        if self.get(self.SCORE_FUNCTION) == "chi2":
            stats, pvals, _ = chi_square_test(x, y)
        else:
            stats, pvals = f_classif_test(x, y)
        mode = self.get(self.SELECTION_MODE)
        threshold = self.get(self.SELECTION_THRESHOLD)
        if threshold is None:
            threshold = {"numTopFeatures": 50, "percentile": 0.1, "fpr": 0.05}[mode]
        if mode == "numTopFeatures":
            if threshold < 1:
                raise ValueError(
                    f"numTopFeatures needs selectionThreshold >= 1, got {threshold}"
                )
        elif not 0.0 < threshold <= 1.0:
            raise ValueError(
                f"{mode} needs selectionThreshold in (0, 1], got {threshold}"
            )
        d = x.shape[1]
        if mode == "numTopFeatures":
            k = min(int(threshold), d)
            keep = np.sort(np.argsort(pvals, kind="stable")[:k])
        elif mode == "percentile":
            k = max(1, int(d * float(threshold)))
            keep = np.sort(np.argsort(pvals, kind="stable")[:k])
        else:  # fpr
            keep = np.nonzero(pvals < float(threshold))[0]
        model = UnivariateFeatureSelectorModel()
        model.copy_params_from(self)
        model.set_model_data(Table({"selected": keep}))
        return model


class UnivariateFeatureSelectorModel(_SelectorModelBase):
    SCORE_FUNCTION = UnivariateFeatureSelector.SCORE_FUNCTION
    SELECTION_MODE = UnivariateFeatureSelector.SELECTION_MODE
    SELECTION_THRESHOLD = UnivariateFeatureSelector.SELECTION_THRESHOLD


def f_regression_test(x: np.ndarray, y: np.ndarray):
    """Univariate linear F-test per feature against a CONTINUOUS label
    (sklearn ``f_regression``): F = r²/(1−r²)·(n−2), p from F(1, n−2)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    n = x.shape[0]
    if n < 3:
        raise ValueError("f_regression requires at least 3 rows")
    xc = x - x.mean(axis=0)
    yc = y - y.mean()
    denom = np.sqrt((xc * xc).sum(axis=0) * (yc * yc).sum())
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(denom > 0, xc.T @ yc / denom, 0.0)
    r2 = np.clip(r * r, 0.0, 1.0)
    d2 = n - 2
    with np.errstate(divide="ignore"):
        f = r2 / np.maximum(1.0 - r2, 0.0) * d2
    f = np.where(r2 >= 1.0, np.inf, f)
    p = np.asarray([
        0.0 if np.isinf(v) else _f_sf(float(v), 1, d2) for v in f
    ])
    return f, p


class _UnivariateTestBase(HasFeaturesCol, HasLabelCol, AlgoOperator):
    """Shared output layout for the per-feature test operators
    (featureIndex, pValue, statistic — the upstream ANOVATest/FValueTest
    shape)."""

    def _run(self, x, y):
        raise NotImplementedError

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        x = features_matrix(table, self.get(self.FEATURES_COL))
        y = table.column(self.get(self.LABEL_COL))
        stats, pvals = self._run(x, y)
        return (
            Table({
                "featureIndex": np.arange(x.shape[1]),
                "pValue": pvals,
                "statistic": stats,
            }),
        )


class ANOVATest(_UnivariateTestBase):
    """One-way ANOVA F-test of continuous features against a categorical
    label (upstream ``ANOVATest``)."""

    def _run(self, x, y):
        return f_classif_test(x, y)


class FValueTest(_UnivariateTestBase):
    """Univariate linear F-test of continuous features against a
    continuous label (upstream ``FValueTest``)."""

    def _run(self, x, y):
        return f_regression_test(x, y)
