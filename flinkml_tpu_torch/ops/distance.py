"""Distance measures.

The port's counterpart of ``flinkml_tpu.ops.distance`` (parity:
``ml/common/distance/DistanceMeasure.java:26-43``): a named registry
(``DistanceMeasure.get_instance("euclidean")``) with ``euclidean``,
``cosine`` and ``manhattan``. The per-pair ``distance(a, b)`` exists for
API parity; ``pairwise`` (an [n, m] matrix) and ``nearest`` (its argmin,
the first index on ties as ``jnp.argmin``) are what KMeans uses.
"""

from __future__ import annotations

from typing import Dict, Type

import torch

from flinkml_tpu_torch.ops import blas


class DistanceMeasure:
    """Registry of distance measures; instances are stateless."""

    NAME = "base"
    _registry: Dict[str, "DistanceMeasure"] = {}

    @classmethod
    def register(cls, impl_cls: Type["DistanceMeasure"]) -> Type["DistanceMeasure"]:
        cls._registry[impl_cls.NAME] = impl_cls()
        return impl_cls

    @staticmethod
    def get_instance(name: str) -> "DistanceMeasure":
        impl = DistanceMeasure._registry.get(name)
        if impl is None:
            raise ValueError(
                f"distanceMeasure must be one of {sorted(DistanceMeasure._registry)}, "
                f"got {name!r}"
            )
        return impl

    def distance(self, a, b):
        raise NotImplementedError

    def pairwise(self, xs, ys):
        """[n, d] x [m, d] -> [n, m] distances."""
        raise NotImplementedError

    def nearest(self, xs, centroids):
        """Index of the nearest centroid per row: [n, d] x [k, d] -> [n]."""
        return torch.argmin(self.pairwise(xs, centroids), dim=-1)


@DistanceMeasure.register
class EuclideanDistanceMeasure(DistanceMeasure):
    """Parity: ``EuclideanDistanceMeasure.java``."""

    NAME = "euclidean"

    def distance(self, a, b):
        return blas.norm2(torch.as_tensor(a) - torch.as_tensor(b))

    def pairwise(self, xs, ys):
        return torch.sqrt(blas.squared_distances(xs, ys))

    def nearest(self, xs, centroids):
        # argmin over squared distances avoids the sqrt entirely.
        return torch.argmin(blas.squared_distances(xs, centroids), dim=-1)


@DistanceMeasure.register
class CosineDistanceMeasure(DistanceMeasure):
    """Cosine distance = 1 - cos(a, b)."""

    NAME = "cosine"

    def distance(self, a, b):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        return 1.0 - torch.dot(a, b) / (blas.norm2(a) * blas.norm2(b))

    def pairwise(self, xs, ys):
        xs, ys = torch.as_tensor(xs), torch.as_tensor(ys)
        xn = xs / torch.linalg.norm(xs, dim=-1, keepdim=True)
        yn = ys / torch.linalg.norm(ys, dim=-1, keepdim=True)
        return 1.0 - xn @ yn.T


@DistanceMeasure.register
class ManhattanDistanceMeasure(DistanceMeasure):
    """L1 distance."""

    NAME = "manhattan"

    def distance(self, a, b):
        return torch.sum(torch.abs(torch.as_tensor(a) - torch.as_tensor(b)))

    def pairwise(self, xs, ys):
        xs, ys = torch.as_tensor(xs), torch.as_tensor(ys)
        return torch.sum(torch.abs(xs[:, None, :] - ys[None, :, :]), dim=-1)
