"""BisectingKMeans — top-down hierarchical k-means.

The port's counterpart of ``flinkml_tpu.models.bisecting_kmeans``. Start
with all rows in one cluster; repeatedly split the splittable cluster with
the largest within-cluster sum of squares by a seeded 2-means (the device
Lloyd loop of :func:`~flinkml_tpu_torch.models.kmeans.train_kmeans` over
that cluster's rows, seed ``seed + split_round``) until ``k`` leaves
exist. The split assigns rows in float32, as the JAX package does. A
split that leaves one side empty (identical points) retires the cluster.
The model is a :class:`KMeansModel` over the leaf centroids.

The 2-means runs in the feature column's floating dtype; the statistics
on the host (sums of squares, leaf means) are float64, as in the JAX
package. ``mesh=`` runs each 2-means data parallel on the mesh's ranks
(:func:`~flinkml_tpu_torch.models.kmeans.train_kmeans`); the split
assignment and the statistics are computed whole on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from flinkml_tpu_torch.api import Estimator
from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.models import _linear_sgd
from flinkml_tpu_torch.models._data import features_matrix
from flinkml_tpu_torch.models.kmeans import (
    KMeansModel,
    _KMeansParams,
    train_kmeans,
)
from flinkml_tpu_torch.ops import blas
from flinkml_tpu_torch.table import Table


class BisectingKMeans(_KMeansParams, Estimator):
    def __init__(self, mesh=None):
        super().__init__()
        _linear_sgd.check_mesh(mesh)
        self.mesh = mesh

    def fit(self, *inputs: Table) -> "BisectingKMeansModel":
        (table,) = inputs
        if self.get(self.DISTANCE_MEASURE) != "euclidean":
            raise ValueError(
                "BisectingKMeans trains on squared-euclidean WCSS; "
                "distanceMeasure must be 'euclidean' (same constraint as "
                "KMeans.fit)"
            )
        xc = features_matrix(table, self.get(self.FEATURES_COL), dtype=None)
        x = xc.astype(np.float64, copy=False)
        k = self.get(self.K)
        n = x.shape[0]
        if n < k:
            raise ValueError(f"n_rows={n} < k={k}")
        max_iter = self.get(self.MAX_ITER)
        init_mode = self.get(self.INIT_MODE)
        seed = self.get_seed()
        device = default_device() if self.mesh is None else self.mesh.device
        x32 = torch.from_numpy(xc).to(device=device, dtype=torch.float32)

        # Leaf clusters as (member_index_array, centroid, splittable).
        members = [np.arange(n)]
        centroids = [x.mean(axis=0)]
        splittable = [True]
        split_round = 0
        while len(members) < k and any(
            s and len(m) >= 2 for s, m in zip(splittable, members)
        ):
            # Pick the splittable cluster with the largest WCSS.
            wcss = [
                float(((x[m] - c) ** 2).sum()) if s and len(m) >= 2 else -1.0
                for m, c, s in zip(members, centroids, splittable)
            ]
            target = int(np.argmax(wcss))
            idx = members[target]
            sub_centroids = train_kmeans(
                xc[idx], 2, self.mesh, max_iter, seed + split_round,
                init_mode=init_mode,
            )
            split_round += 1
            assign = torch.argmin(blas.squared_distances(
                x32[torch.from_numpy(idx).to(device)],
                torch.from_numpy(sub_centroids).to(device, torch.float32),
            ), dim=1).cpu().numpy()
            left, right = idx[assign == 0], idx[assign == 1]
            if len(left) == 0 or len(right) == 0:
                # Identical points (or collapsed split): retire the leaf.
                splittable[target] = False
                continue
            members[target] = left
            centroids[target] = x[left].mean(axis=0)
            splittable[target] = True
            members.append(right)
            centroids.append(x[right].mean(axis=0))
            splittable.append(True)

        model = BisectingKMeansModel(mesh=self.mesh)
        model.copy_params_from(self)
        model.set_model_data(
            Table({"centroids": np.stack(centroids)[None, :, :]})
        )
        return model


class BisectingKMeansModel(KMeansModel):
    """Nearest-centroid prediction over the bisecting-derived leaf
    centroids (shares KMeansModel's predict and persistence)."""
