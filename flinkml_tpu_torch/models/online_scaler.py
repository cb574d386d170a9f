"""OnlineStandardScaler — standardization statistics over an unbounded
stream.

The port's counterpart of ``flinkml_tpu.models.online_scaler`` (upstream
Flink ML's ``OnlineStandardScaler``: a continuously updated mean and
standard deviation emitted as versioned models), the third trainer of the
unbounded-iteration mode after OnlineLogisticRegression and OnlineKMeans.

Each batch's moments merge exactly into the carry by Chan's pairwise
mean/M2 combination, on the compute device in float64 (no drift
whatever the stream's length; from the zero carry the first merge gives
the batch's moments exactly), and each consumed batch bumps
``model_version``. The carry ``{"m2", "mean", "n", "version"}`` is the
JAX package's, so snapshots cross packages. The fitted model transforms
exactly like ``StandardScalerModel`` (``withMean``/``withStd``).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from flinkml_tpu_torch.api import Estimator
from flinkml_tpu_torch.common_params import HasGlobalBatchSize
from flinkml_tpu_torch.device import default_device
from flinkml_tpu_torch.models._data import features_matrix
from flinkml_tpu_torch.models.scalers import (
    StandardScalerModel,
    _HasInputOutputCol,
)
from flinkml_tpu_torch.table import Table


def _chan_merge(na: float, mean, m2, nb: float, mb, m2b):
    """Chan's pairwise mean/M2 combination of ``(na, mean, m2)`` and
    ``(nb, mb, m2b)`` (tensors or numpy arrays): ``(n, mean, m2)``. From
    ``na = 0`` it gives ``mb`` and ``m2b`` exactly."""
    delta = mb - mean
    n = na + nb
    return n, mean + delta * (nb / n), m2 + m2b + delta * delta * (na * nb / n)


def _chan_step(carry, x: torch.Tensor):
    """The carry after merging the float64 batch ``x`` (``[n, d]``)."""
    nb = float(x.shape[0])
    if nb == 0:
        return carry
    mb = x.mean(dim=0)
    m2b = ((x - mb) ** 2).sum(dim=0)
    if carry["mean"] is None:
        n, mean, m2 = nb, mb, m2b
    else:
        n, mean, m2 = _chan_merge(float(carry["n"]), carry["mean"],
                                  carry["m2"], nb, mb, m2b)
    return {"n": n, "mean": mean, "m2": m2,
            "version": int(carry["version"]) + 1}


class OnlineStandardScaler(_HasInputOutputCol, HasGlobalBatchSize, Estimator):
    """Streaming standardization: ``fit(table)`` consumes
    ``globalBatchSize`` mini-batches of one Table, ``fit_stream(batches)``
    an iterable of batch Tables (one exact merge each)."""

    WITH_MEAN = StandardScalerModel.WITH_MEAN
    WITH_STD = StandardScalerModel.WITH_STD

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh

    def fit(self, *inputs: Table) -> "OnlineStandardScalerModel":
        (table,) = inputs
        return self.fit_stream(table.batches(self.get(self.GLOBAL_BATCH_SIZE)))

    def fit_stream(
        self,
        batches: Iterable[Table],
        *,
        checkpoint_manager=None,
        checkpoint_interval: int = 0,
        resume: bool = False,
        stream_resume: str = "replay",
        sentinel=None,
        recovery=None,
    ) -> "OnlineStandardScalerModel":
        """One exact Chan merge per arriving batch.

        ``checkpoint_manager`` (+ ``checkpoint_interval``) snapshots the
        moment carry every N consumed batches and at the end;
        ``resume=True`` continues from the newest valid snapshot, the same
        bits as the uninterrupted run; ``stream_resume`` as in
        ``OnlineLogisticRegression.fit_stream``. ``sentinel``/``recovery``
        thread the numerics sentinel and the rollback-and-quarantine
        policy of :mod:`flinkml_tpu_torch.recovery` through ``iterate``.

        In a process group of several ranks each rank consumes its own
        partition alone (the merge is associative and exact) and the
        per-rank ``(n, mean, M2)`` merge once at the end, in rank order,
        so every rank holds the same model; a rank-local failure is held
        and agreed before the merge. Checkpoints, the sentinel and
        recovery are refused there, as in the JAX package.
        """
        from flinkml_tpu_torch.iteration import (
            IterationConfig,
            TerminateOnMaxIter,
            iterate,
        )
        from flinkml_tpu_torch.models.online_logistic_regression import (
            _process_count,
        )

        input_col = self.get(self.INPUT_COL)
        device = default_device()

        def dev(a):
            if torch.is_tensor(a):
                return a.to(device=device, dtype=torch.float64)
            a = np.array(a, dtype=np.float64)
            return torch.from_numpy(a).to(device)

        def step(carry, batch_table, epoch):
            x = dev(features_matrix(batch_table, input_col))
            if carry["mean"] is not None:
                # A restored carry comes back from the checkpoint as numpy.
                carry = dict(carry, mean=dev(carry["mean"]),
                             m2=dev(carry["m2"]))
            return _chan_step(carry, x), None

        if _process_count() > 1:
            if (checkpoint_manager is not None or resume
                    or sentinel is not None or recovery is not None):
                raise NotImplementedError(
                    "checkpoint/resume and sentinel/recovery for the "
                    "multi-process online stream path are not wired (as in "
                    "the JAX package); run the checkpointing or "
                    "self-healing fit single-process"
                )
            from flinkml_tpu_torch.iteration.stream_sync import (
                DeferredValidation,
            )

            # A rank-local raise would strand the peers in the merge: the
            # local pass's failure is held and agreed first.
            final = {"n": 0.0, "mean": None, "m2": None, "version": 0}
            dv = DeferredValidation()
            try:
                final = iterate(step, final, iter(batches), IterationConfig(
                    TerminateOnMaxIter(2**31 - 1))).state
            except Exception as e:  # noqa: BLE001 — agreed below
                dv.err = e
            dv.rendezvous(self.mesh, "online scaler stream")
            final = self._merge_across_processes(final, self.mesh)
            if final["mean"] is None:
                raise ValueError("training stream is empty on every process")
            return self._model_from_final(final)

        from flinkml_tpu_torch.iteration.checkpoint import begin_resume
        from flinkml_tpu_torch.models._streaming import (
            feed_world_size,
            peek_stream,
        )

        restore_epoch = begin_resume(checkpoint_manager, resume,
                                     world_size=feed_world_size(batches))
        # The first batch fixes the feature dim, so the carry is a full
        # tree of arrays from epoch 0 (restore needs its structure).
        first, stream = peek_stream(batches)
        if first is None:
            if restore_epoch is not None:
                # A resumed run whose stream is exhausted: the snapshot's
                # moments are the model.
                final, _ = checkpoint_manager.restore_latest(
                    like={"n": 0, "mean": 0, "m2": 0, "version": 0})
                return self._model_from_final(final)
            raise ValueError("training stream is empty")
        d = features_matrix(first, input_col).shape[1]
        zeros = torch.zeros(d, dtype=torch.float64, device=device)
        state = {"n": 0.0, "mean": zeros, "m2": zeros.clone(), "version": 0}
        result = iterate(
            step, state, stream,
            IterationConfig(
                TerminateOnMaxIter(2**31 - 1),
                checkpoint_interval=checkpoint_interval,
                checkpoint_manager=checkpoint_manager,
                stream_resume=stream_resume,
                sentinel=sentinel,
                recovery=recovery,
            ),
            resume=resume,
        )
        final = result.state
        if float(final["n"]) == 0.0:
            raise ValueError("training stream is empty")
        model = self._model_from_final(final)
        # What the recovery did (None without a policy).
        model.recovery_summary = result.recovery
        return model

    def _model_from_final(self, final) -> "OnlineStandardScalerModel":
        def host(a):
            return (a.detach().cpu().numpy() if torch.is_tensor(a)
                    else np.asarray(a, dtype=np.float64))

        mean, m2 = host(final["mean"]), host(final["m2"])
        model = OnlineStandardScalerModel()
        model.copy_params_from(self)
        model.set_model_data(Table({
            "mean": mean[None, :],
            "std": np.sqrt(m2 / float(final["n"]))[None, :],
        }))
        model._model_version = int(final["version"])
        return model

    @staticmethod
    def _merge_across_processes(final, mesh=None):
        """Chan-merge the ranks' ``(n, mean, M2, version)`` in rank order
        on the host in float64: the same bits on every rank."""
        from flinkml_tpu_torch.iteration.stream_sync import (
            agree_all_ok,
            agree_max,
            gather_vectors,
        )

        mean_l = final["mean"]
        if torch.is_tensor(mean_l):
            mean_l = mean_l.cpu().numpy()
            final = dict(final, mean=mean_l, m2=final["m2"].cpu().numpy())
        local_d = 0 if mean_l is None else mean_l.shape[0]
        d = agree_max(local_d, mesh)
        # Every rank passes this agreement: the max-dim rank always
        # matches, so a bare local raise would strand it in the gather.
        agree_all_ok(
            not (local_d and local_d != d), mesh,
            f"feature-dim agreement (local {local_d}, global {d})",
        )
        if d == 0:
            return {"n": 0.0, "mean": None, "m2": None, "version": 0}
        vec = np.zeros(2 + 2 * d)
        vec[0] = final["n"]
        vec[1] = float(final["version"])
        if final["mean"] is not None:
            vec[2:2 + d] = final["mean"]
            vec[2 + d:] = final["m2"]
        n, mean, m2, version = 0.0, np.zeros(d), np.zeros(d), 0
        for row in gather_vectors(vec, mesh):  # rank order on every rank
            nb = float(row[0])
            version += int(round(row[1]))
            if nb == 0.0:
                continue
            mb, m2b = row[2:2 + d], row[2 + d:]
            if n == 0.0:
                n, mean, m2 = nb, mb.copy(), m2b.copy()
            else:
                n, mean, m2 = _chan_merge(n, mean, m2, nb, mb, m2b)
        if n == 0.0:
            return {"n": 0.0, "mean": None, "m2": None, "version": version}
        return {"n": n, "mean": mean, "m2": m2, "version": version}


class OnlineStandardScalerModel(StandardScalerModel):
    """StandardScalerModel with the online model-version counter
    (persisted, like the other online models')."""

    def __init__(self):
        super().__init__()
        self._model_version = 0

    @property
    def model_version(self) -> int:
        return self._model_version

    def save(self, path: str) -> None:
        self._save_with_arrays(path, self._arrays(),
                               extra={"modelVersion": self._model_version})

    @classmethod
    def load(cls, path: str) -> "OnlineStandardScalerModel":
        model, arrays, meta = cls._load_with_arrays(path)
        model._set_arrays(arrays)
        model._model_version = int(meta.get("modelVersion", 0))
        return model
