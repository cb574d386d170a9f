"""KMeans — Lloyd's algorithm with random or k-means++ init (batch fit).

The port's counterpart of ``flinkml_tpu.models.kmeans`` (reference:
``KMeans.java:79-335``, ``KMeansModel.java``, ``KMeansModelData.java``):

- Init: a seeded host choice of k distinct rows (``random``, the
  reference's ``selectRandomCentroids``) or k-means++ seeding, with the
  JAX package's numpy calls, so both packages start from the same
  centroids.
- The Lloyd loop runs on the compute device for ``maxIter`` steps with no
  host read in between: ``squared_distances`` → ``argmin`` → one-hot
  (padded rows weigh 0) → per-cluster sums ``onehot.T @ x`` and counts →
  new centroids; an empty cluster keeps its previous centroid. The JAX
  package runs the same body as one ``fori_loop`` program.
- Termination: ``maxIter`` only, as in the reference.

Dtype rule: the fit computes in the feature column's floating dtype (a
non-float column promotes to float64); the JAX estimator promotes to
float64 and computes in its x64 flag's dtype. ``KMeansModel.transform``
does the same with the query column.

``KMeansModel.transform_kernel`` (euclidean only) is the per-stage
nearest-centroid math as plain PyTorch, and the KMeans head of the
``fused_chain`` kernel on the card; it pins its input column, as the JAX
package's does.

One device, in-RAM tables only: streamed fits (an iterable of batch
Tables or a DataCache, ``cache_dir``, ``cache_memory_budget_bytes``) and
checkpointing raise ``NotImplementedError`` naming ROADMAP.md Queue 1
item 6 (the rest of KMeans), ``mesh=`` item 7.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flinkml_tpu_torch.api import ColumnKernel, Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasDistanceMeasure,
    HasFeaturesCol,
    HasK,
    HasMaxIter,
    HasPredictionCol,
    HasSeed,
)
from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.models import _linear_sgd
from flinkml_tpu_torch.models._data import features_matrix, features_tensor
from flinkml_tpu_torch.ops import blas
from flinkml_tpu_torch.ops.distance import DistanceMeasure
from flinkml_tpu_torch.params import IntParam, ParamValidators, StringParam
from flinkml_tpu_torch.parallel import pad_to_multiple
from flinkml_tpu_torch.precision import chain_policy
from flinkml_tpu_torch.table import Table

#: Row tile of the padded point matrix (the JAX package's per-device
#: sublane tile); padded rows weigh 0.
ROW_TILE = 8


class _KMeansParams(
    HasDistanceMeasure, HasFeaturesCol, HasPredictionCol, HasK, HasMaxIter, HasSeed
):
    """Reference: KMeansParams. KMeans redefines ``k`` (clusters, default 2,
    > 1) over HasK's nearest-neighbors variant. ``initMode`` adds k-means++
    to the reference's random init."""

    K = IntParam(
        "k", "The number of clusters to create.", 2, ParamValidators.gt(1)
    )

    INIT_MODE = StringParam(
        "initMode", "Centroid initialization: random or k-means++.", "random",
        ParamValidators.in_array(["random", "k-means++"]),
    )


_STREAM_ITEM = ("ROADMAP.md Queue 1 item 6 (the rest of KMeans: its "
                "streamed fit and checkpointing)")


class KMeans(_KMeansParams, Estimator):
    """Fits centroids from a :class:`Table` on the compute device.

    The constructor takes the JAX estimator's knobs; ``mesh``,
    ``cache_dir``, ``cache_memory_budget_bytes``, ``checkpoint_manager``
    and ``resume`` raise ``NotImplementedError`` naming their ROADMAP.md
    item when set (``checkpoint_interval`` acts only with a
    ``checkpoint_manager``); ``sharding_plan`` and ``precision`` raise
    ``ValueError`` as in the JAX package, whose KMeans takes neither.
    """

    def __init__(self, mesh=None, cache_dir=None,
                 cache_memory_budget_bytes=None, checkpoint_manager=None,
                 checkpoint_interval: int = 0, resume: bool = False,
                 sharding_plan=None, precision=None):
        super().__init__()
        for name, value in (("sharding_plan", sharding_plan),
                            ("precision", precision)):
            if value is not None:
                raise ValueError(
                    f"KMeans does not support {name} yet (plan- and "
                    "policy-aware estimators: the linear family's dense "
                    "paths)"
                )
        _linear_sgd.refuse_unported(mesh=mesh)
        for name, value in (
                ("checkpoint_manager", checkpoint_manager),
                ("resume", resume), ("cache_dir", cache_dir),
                ("cache_memory_budget_bytes", cache_memory_budget_bytes)):
            if value is not None and value is not False:
                raise NotImplementedError(
                    f"KMeans {name}={value!r} is not ported to "
                    f"flinkml_tpu_torch yet: it comes with {_STREAM_ITEM}"
                )

    def fit(self, *inputs) -> "KMeansModel":
        (table,) = inputs
        k = self.get(_KMeansParams.K)
        measure = self.get(_KMeansParams.DISTANCE_MEASURE)
        if measure != "euclidean":
            raise ValueError(
                "KMeans currently supports the euclidean distance measure "
                f"(parity with the reference), got {measure!r}"
            )
        if not isinstance(table, Table):
            raise NotImplementedError(
                "KMeans streamed fits (an iterable of batch Tables or a "
                "DataCache) are not ported to flinkml_tpu_torch yet: they "
                f"come with {_STREAM_ITEM}"
            )
        x = features_matrix(table, self.get(_KMeansParams.FEATURES_COL),
                            dtype=None)
        if x.shape[0] < k:
            raise ValueError(f"k={k} exceeds number of points {x.shape[0]}")
        centroids = train_kmeans(
            x,
            k=k,
            max_iter=self.get(_KMeansParams.MAX_ITER),
            seed=self.get_seed(),
            init_mode=self.get(_KMeansParams.INIT_MODE),
        )
        model = KMeansModel()
        model.copy_params_from(self)
        model.set_model_data(Table({"centroids": centroids[None, :, :]}))
        return model


class KMeansModel(_KMeansParams, Model):
    """Nearest-centroid prediction (broadcast-model pattern,
    ``KMeansModel.java``)."""

    def __init__(self):
        super().__init__()
        self._centroids: Optional[np.ndarray] = None

    def set_model_data(self, *inputs: Table) -> "KMeansModel":
        (table,) = inputs
        self._set_arrays({"centroids": table.column("centroids")})
        return self

    def get_model_data(self) -> List[Table]:
        self._require_model()
        return [Table({"centroids": self._centroids[None, :, :]})]

    def _arrays(self) -> Dict[str, np.ndarray]:
        self._require_model()
        return {"centroids": self._centroids}

    def _set_arrays(self, arrays: Mapping[str, np.ndarray]) -> None:
        c = np.asarray(arrays["centroids"], dtype=np.float64)
        self._centroids = c.reshape(c.shape[-2], c.shape[-1])

    @property
    def centroids(self) -> np.ndarray:
        self._require_model()
        return self._centroids

    def _require_model(self) -> None:
        if self._centroids is None:
            raise ValueError("Model data is not set; call set_model_data or fit first")

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require_model()
        x = features_tensor(table, self.get(_KMeansParams.FEATURES_COL))
        measure = DistanceMeasure.get_instance(
            self.get(_KMeansParams.DISTANCE_MEASURE)
        )
        centroids = torch.from_numpy(self._centroids).to(x.device, x.dtype)
        assign = measure.nearest(x, centroids)
        return (
            table.with_column(self.get(_KMeansParams.PREDICTION_COL), assign),
        )

    def transform_kernel(self) -> Optional[ColumnKernel]:
        """Nearest-centroid assignment as a chainable kernel: the per-stage
        path's euclidean ``nearest`` (argmin of ``squared_distances``, an
        int64 index) in the feature column's dtype, the centroids as a
        constant. Other distance measures keep the per-stage path."""
        if self._centroids is None:
            return None
        if self.get(_KMeansParams.DISTANCE_MEASURE) != "euclidean":
            return None
        fcol = self.get(_KMeansParams.FEATURES_COL)
        pcol = self.get(_KMeansParams.PREDICTION_COL)

        def fn(cols, consts, valid):
            x = cols[fcol]
            if x.dim() == 1:
                x = x.reshape(-1, 1)
            if not x.dtype.is_floating_point:
                x = x.to(torch.float64)
            pol = chain_policy()
            if pol is not None and pol.declared:
                # The distances at policy.compute, their sums too (plain
                # dtype propagation, as the JAX kernel): the precision
                # check refuses this stage where accum is wider.
                x = x.to(pol.compute_dtype)
            c = torch.as_tensor(consts["centroids"]).to(device=x.device,
                                                         dtype=x.dtype)
            return {pcol: torch.argmin(blas.squared_distances(x, c), dim=-1)}

        return ColumnKernel(
            input_cols=(fcol,), output_cols=(pcol,), fn=fn,
            constants={"centroids": self._centroids},
            fingerprint=("KMeansModel", fcol, pcol, "euclidean"),
            # As the JAX package: the input column is an eager output.
            pin_inputs=True,
            accumulates="compute",
        )


def lloyd(xd: torch.Tensor, wd: torch.Tensor, centroids: torch.Tensor,
          max_iter: int) -> torch.Tensor:
    """``max_iter`` Lloyd steps on the device from ``centroids``; no host
    read in between. ``wd`` weighs each row (0 for padding)."""
    k = centroids.shape[0]
    for _ in range(max_iter):
        # Assignment: argmin over pairwise squared distances.
        assign = torch.argmin(blas.squared_distances(xd, centroids), dim=-1)
        # Per-cluster sums via a one-hot product; padded rows have w=0.
        onehot = F.one_hot(assign, k).to(xd.dtype) * wd[:, None]
        sums = onehot.T @ xd
        counts = torch.sum(onehot, dim=0)
        # Empty clusters keep their previous centroid.
        safe = torch.clamp_min(counts, 1.0)[:, None]
        centroids = torch.where(counts[:, None] > 0, sums / safe, centroids)
    return centroids


def _kmeans_pp_init(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """k-means++ seeding: each next centroid sampled ∝ distance² to the
    nearest chosen one."""
    centroids = [x[rng.integers(x.shape[0])]]
    d2 = ((x - centroids[0]) ** 2).sum(-1)
    for _ in range(1, k):
        probs = d2 / d2.sum() if d2.sum() > 0 else np.full(len(x), 1.0 / len(x))
        nxt = x[rng.choice(x.shape[0], p=probs)]
        centroids.append(nxt)
        d2 = np.minimum(d2, ((x - nxt) ** 2).sum(-1))
    return np.stack(centroids)


def init_centroids(x: np.ndarray, k: int, seed: int,
                   init_mode: str = "random") -> np.ndarray:
    """The seeded initial centroids, drawn as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    if init_mode == "k-means++":
        return _kmeans_pp_init(x, k, rng)
    init_idx = rng.choice(x.shape[0], size=k, replace=False)
    return np.ascontiguousarray(x[init_idx])


def train_kmeans(
    x: np.ndarray,
    k: int,
    mesh=None,
    max_iter: int = 20,
    seed: int = 0,
    init_mode: str = "random",
    initial_centroids: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Returns centroids [k, d] (in ``x``'s dtype); the whole loop runs on
    the compute device. ``initial_centroids`` overrides the seeded init
    (tests, warm restarts). ``mesh`` is the JAX signature's; only None
    (one device) is ported."""
    _linear_sgd.refuse_unported(mesh=mesh)
    if initial_centroids is not None:
        start = np.asarray(initial_centroids, x.dtype)
    else:
        start = init_centroids(x, k, seed, init_mode)
    xd, wd, _ = prepare_kmeans_data(x)
    centroids = lloyd(xd, wd, torch.from_numpy(start).to(xd.device), max_iter)
    return centroids.cpu().numpy()


def prepare_kmeans_data(x: np.ndarray, mesh=None):
    """Pad and mask the points and move them to the compute device; returns
    ``(xd, wd, n_valid)``. Rows pad to a multiple of :data:`ROW_TILE`;
    padded rows weigh 0, so they never influence centroids."""
    _linear_sgd.refuse_unported(mesh=mesh)
    x_pad, n_valid = pad_to_multiple(x, ROW_TILE)
    w = np.zeros(x_pad.shape[0], dtype=x.dtype)
    w[:n_valid] = 1.0
    device = default_device()
    return (torch.from_numpy(np.ascontiguousarray(x_pad)).to(device),
            torch.from_numpy(w).to(device), n_valid)
