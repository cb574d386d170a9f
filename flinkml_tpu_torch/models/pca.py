"""PCA — principal component analysis on the device mesh.

The port's counterpart of ``flinkml_tpu.models.pca``: the ``[d, d]``
covariance is ONE gram pass on the compute device (each rank's shifted
rows ``(x - shift)ᵀ (x - shift)·w`` in float32, cuBLAS on the card),
summed over the mesh's ranks with ONE ``all_reduce`` of the packed
``[count | sum | gram]`` (JAX: a ``psum`` of each); the shift is the first
row, so the float32 gram accumulates small magnitudes, and the mean
correction and the eigensolve run on the host in float64.

Sign convention: each component is flipped so its max-|entry| is
positive, making fitted models deterministic across runs and meshes.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import HasInputCol, HasOutputCol
from flinkml_tpu_torch.models._data import features_matrix
from flinkml_tpu_torch.params import IntParam, ParamValidators
from flinkml_tpu_torch.parallel.mesh import (
    DeviceMesh,
    check_mesh,
    pad_to_multiple,
)
from flinkml_tpu_torch.table import Table


def shard_with_mask(x: np.ndarray, mesh: DeviceMesh):
    """This rank's block of ``x`` as float32 on its device, padded to the
    data axis, and its row mask (1 on real rows); the JAX scalers'
    ``_shard_with_mask``."""
    p = mesh.axis_size()
    x_pad, n_valid = pad_to_multiple(np.asarray(x).astype(np.float32), p)
    w = np.zeros(x_pad.shape[0], dtype=np.float32)
    w[:n_valid] = 1.0
    return mesh.shard_batch(x_pad), mesh.shard_batch(w)


def mean_and_gram(mesh: Optional[DeviceMesh], xl: torch.Tensor,
                  wl: torch.Tensor, shift) -> Tuple[float, np.ndarray,
                                                    np.ndarray]:
    """``(count, Σ w·(x - shift), (x - shift)ᵀ · w·(x - shift))`` over the
    mesh's rows, in float32 on the device, as host float64. ``xl``/``wl``
    are this rank's rows; one ``all_reduce`` sums the three."""
    shift = torch.as_tensor(np.asarray(shift, np.float32)).to(xl.device)
    xs = xl.to(torch.float32) - shift
    c = xs * wl[:, None]
    d = xs.shape[1]
    packed = torch.cat([torch.sum(wl).reshape(1), torch.sum(c, dim=0),
                        (xs.T @ c).reshape(-1)])
    if mesh is not None and mesh.group(DeviceMesh.DATA_AXIS) is not None:
        from flinkml_tpu_torch.parallel.collectives import all_reduce_

        all_reduce_(mesh, packed)
    out = packed.cpu().numpy().astype(np.float64)
    return float(out[0]), out[1:1 + d], out[1 + d:].reshape(d, d)


class _PCAParams(HasInputCol, HasOutputCol):
    K = IntParam(
        "k", "Number of principal components.", 2, ParamValidators.gt(0)
    )


class PCA(_PCAParams, Estimator):
    """``fit`` also accepts an iterable of batch Tables or a sealed
    :class:`~flinkml_tpu_torch.iteration.datacache.DataCache`: PCA is ONE
    accumulation pass (count, shifted sum, shifted gram per batch, added
    on the host in float64), so nothing is cached or replayed. On a mesh
    of several ranks each rank feeds its own partition in lockstep
    (:func:`~flinkml_tpu_torch.iteration.stream_sync.
    synced_padded_stream`: one agreement a step, zero-weight dummies on a
    drained rank), the shift agreed from the lowest non-empty rank."""

    def __init__(self, mesh: Optional[DeviceMesh] = None):
        check_mesh(mesh)
        super().__init__()
        self.mesh = mesh

    def fit(self, *inputs) -> "PCAModel":
        (table,) = inputs
        if not isinstance(table, Table):
            return self._fit_stream(table)
        x = features_matrix(table, self.get(self.INPUT_COL))
        n, d = x.shape
        k = self.get(self.K)
        if k > min(n, d):
            raise ValueError(f"k={k} must be <= min(n_rows, dim) = {min(n, d)}")
        mesh = self.mesh or DeviceMesh()
        xd, wd = shard_with_mask(x, mesh)
        shift = np.asarray(x[0], dtype=np.float32)
        cnt, s, g = mean_and_gram(mesh, xd, wd, shift)
        return self._finish(cnt, s, g, shift, k)

    def _fit_stream(self, source) -> "PCAModel":
        from flinkml_tpu_torch.iteration.datacache import DataCache
        from flinkml_tpu_torch.models._linear_sgd import multi_rank

        input_col = self.get(self.INPUT_COL)
        k = self.get(self.K)
        mesh = self.mesh or DeviceMesh()
        multi = multi_rank(mesh)
        column = input_col if isinstance(source, DataCache) else None
        batches = source.reader() if isinstance(source, DataCache) else source

        def extract(b):
            if column is not None:
                return np.asarray(b[column], np.float32)
            return features_matrix(b, input_col).astype(np.float32)

        d = [None]

        def check_x(x):
            if x.ndim != 2 or x.shape[0] == 0:
                raise ValueError(
                    f"stream batches must be non-empty [n, d], got {x.shape}"
                )
            if d[0] is None:
                d[0] = x.shape[1]
            elif x.shape[1] != d[0]:
                raise ValueError(
                    f"batch feature dim {x.shape[1]} != first batch's {d[0]}"
                )

        cnt = 0.0
        s = g = None
        shift = None

        def add(parts):
            nonlocal cnt, s, g
            cb, sb, gb = parts
            cnt += cb
            s = sb if s is None else s + sb
            g = gb if g is None else g + gb

        if not multi:
            for b in batches:
                x = extract(b)
                check_x(x)
                if shift is None:
                    shift = np.array(x[0])  # the stream's first row
                add(mean_and_gram(mesh, *shard_with_mask(x, mesh), shift))
            if shift is None:
                raise ValueError("training stream is empty")
        else:
            from flinkml_tpu_torch.iteration.stream_sync import (
                agree_first_item_dim,
                gather_vectors,
                synced_padded_stream,
            )

            first, it, dim = agree_first_item_dim(
                (extract(b) for b in batches), check_x,
                lambda x: x.shape[1], mesh,
            )
            d[0] = dim
            # The agreed shift: the first row of the lowest non-empty rank.
            cand = np.zeros(1 + dim)
            if first is not None:
                cand[0] = 1.0
                cand[1:] = first[0].astype(np.float64)
            rows = gather_vectors(cand, mesh)
            nonempty = np.nonzero(rows[:, 0] > 0)[0]
            shift = rows[nonempty[0], 1:].astype(np.float32)
            stream = itertools.chain([first] if first is not None else [], it)
            for (x_pad,), w, _h in synced_padded_stream(
                ((x,) for x in stream), mesh,
                check=lambda item: check_x(item[0]),
                row_tile=mesh.axis_size() * 8, dummy_cols=((dim,),),
            ):
                add(mean_and_gram(mesh, mesh.global_batch(x_pad),
                                  mesh.global_batch(w), shift))

        if k > min(int(cnt), d[0] if d[0] is not None else int(cnt)):
            raise ValueError(
                f"k={k} must be <= min(n_rows, dim) = "
                f"{min(int(cnt), d[0] if d[0] is not None else int(cnt))}"
            )
        return self._finish(cnt, s, g, shift, k)

    def _finish(self, cnt: float, s: np.ndarray, g: np.ndarray,
                shift: np.ndarray, k: int) -> "PCAModel":
        """Host float64 eigensolve from (count, sum, gram)."""
        mean_c = s / cnt                                  # mean of (x - shift)
        cov = (g / cnt - np.outer(mean_c, mean_c)) * (cnt / max(cnt - 1, 1))
        eigvals, eigvecs = np.linalg.eigh(cov)
        idx = np.argsort(eigvals)[::-1][:k]
        components = eigvecs[:, idx].T                     # [k, d]
        variances = np.maximum(eigvals[idx], 0.0)
        flip = np.sign(
            components[np.arange(k), np.argmax(np.abs(components), axis=1)]
        )
        flip[flip == 0] = 1.0
        components = components * flip[:, None]
        total_var = float(np.maximum(np.trace(cov), 1e-300))
        model = PCAModel()
        model.copy_params_from(self)
        model._set_arrays({
            "mean": shift.astype(np.float64) + mean_c,
            "components": components,
            "explainedVariance": variances,
            "explainedVarianceRatio": variances / total_var,
        })
        return model


class PCAModel(_PCAParams, Model):
    _NAMES = ("mean", "components", "explainedVariance",
              "explainedVarianceRatio")

    def __init__(self):
        super().__init__()
        self._mean: Optional[np.ndarray] = None
        self._components: Optional[np.ndarray] = None
        self._explained_variance: Optional[np.ndarray] = None
        self._explained_variance_ratio: Optional[np.ndarray] = None

    def _set_arrays(self, arrays) -> None:
        """The saved layout, or the model-data table's (a leading axis
        of 1)."""
        def arr(name, ndim):
            a = np.asarray(arrays[name], np.float64)
            return a[0] if a.ndim > ndim else a

        self._mean = arr("mean", 1)
        self._components = arr("components", 2)
        self._explained_variance = arr("explainedVariance", 1)
        self._explained_variance_ratio = arr("explainedVarianceRatio", 1)

    def _arrays(self) -> Dict[str, np.ndarray]:
        self._require()
        return {
            "mean": self._mean,
            "components": self._components,
            "explainedVariance": self._explained_variance,
            "explainedVarianceRatio": self._explained_variance_ratio,
        }

    def set_model_data(self, *inputs: Table) -> "PCAModel":
        (table,) = inputs
        self._set_arrays({k: table.column(k) for k in self._NAMES})
        return self

    def get_model_data(self) -> List[Table]:
        return [Table({k: v[None] for k, v in self._arrays().items()})]

    @property
    def components(self) -> np.ndarray:
        self._require()
        return self._components

    @property
    def explained_variance(self) -> np.ndarray:
        self._require()
        return self._explained_variance

    @property
    def explained_variance_ratio(self) -> np.ndarray:
        self._require()
        return self._explained_variance_ratio

    def _require(self) -> None:
        if self._components is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        x = features_matrix(table, self.get(self.INPUT_COL))
        proj = (x - self._mean) @ self._components.T
        return (table.with_column(self.get(self.OUTPUT_COL), proj),)
