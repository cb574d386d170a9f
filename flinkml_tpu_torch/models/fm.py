"""Factorization machines: FMClassifier (logistic) and FMRegressor
(squared loss).

The port's counterpart of ``flinkml_tpu.models.fm``. Second-order FMs
(Rendle): ``ŷ(x) = w₀ + w·x + ½ Σ_f [(x·V_f)² − (x² · V_f²)]`` — the
pairwise term by the O(n·d·k) sum-of-squares identity, two matrix products
(``x @ V`` and ``x² @ V²``). Training rides the shared Adam trainer
(:mod:`flinkml_tpu_torch.models._adam`); L2 regularization applies to w
and V (not the intercept), scaled per minibatch like the loss, its
strength the frozen tail of the parameter tuple. ``V`` starts at
``0.01 · threefry.normal(PRNGKey(seed), [d, k])``, JAX's draw.

Three paths besides the in-RAM replicated fit:

  - the streamed fit (an iterable of Tables or a sealed DataCache) through
    :func:`~flinkml_tpu_torch.models._adam.run_streamed_adam`; it refuses
    a ``sharding_plan`` (its trainer keeps factors replicated);
  - the embedding-sharded factor fit (``sharding_plan=``): V, w and their
    Adam slots row-sharded over the plan's embedding-family axes, x
    column-sharded to match, so both products contract locally; one
    ``all_reduce`` a step sums the batch-sized partials ``[x·V | x²·V² |
    x·w]`` and the squared norm (the JAX trainer's ``psum``s, packed into
    one buffer), and the closed-form FM gradients stay local. It
    reproduces the replicated trainer's sampling for a data world of the
    shard count, and refuses plans that split factor rows, replicate the
    factor family, or shard it over a streamed fit;
  - the sparse margin (an all-``SparseVector`` column): the linear term by
    the ``spmv`` kernel in float64 over the padded ELL block, the pairwise
    term by gathering factor rows, on the compute device, so a hashed
    feature space never densifies.

The dense transform runs on the host in float64, as in the JAX package;
model data, ``save`` and ``load`` use its format.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from flinkml_tpu_torch.api import Estimator, Model
from flinkml_tpu_torch.common_params import (
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasLabelCol,
    HasLearningRate,
    HasMaxIter,
    HasPredictionCol,
    HasRawPredictionCol,
    HasReg,
    HasSeed,
    HasTol,
    HasWeightCol,
)
from flinkml_tpu_torch.models._adam import (
    IndexDraws,
    adam_update,
    make_adam_trainer,
)
from flinkml_tpu_torch.models._data import (
    check_binary_labels,
    features_matrix,
    labeled_data,
)
from flinkml_tpu_torch.models._streaming import StreamingEstimatorMixin
from flinkml_tpu_torch.ops import threefry
from flinkml_tpu_torch.params import IntParam, ParamValidators
from flinkml_tpu_torch.table import Table


class _FMParams(
    HasFeaturesCol, HasLabelCol, HasPredictionCol, HasRawPredictionCol,
    HasWeightCol, HasMaxIter, HasLearningRate, HasGlobalBatchSize, HasReg,
    HasTol, HasSeed,
):
    FACTOR_SIZE = IntParam(
        "factorSize", "Dimensionality of the interaction factors.", 8,
        ParamValidators.gt(0),
    )


def _fm_margin(params, xb):
    """params = (w0 [1], w [d], v [d, k]); returns [n] margins."""
    w0, w, v = params
    linear = xb @ w
    xv = xb @ v
    x2v2 = (xb * xb) @ (v * v)
    pair = 0.5 * torch.sum(xv * xv - x2v2, dim=1)
    return w0[0] + linear + pair


def _logaddexp0(margin):
    """``log(1 + e^margin)``, as ``jnp.logaddexp(0, margin)``."""
    return torch.logaddexp(torch.zeros_like(margin), margin)


def _fm_logistic_loss_builder():
    def local_loss(params, xb, yb, wb):
        margin = _fm_margin(params[:3], xb)
        # params[3] is a [1] tensor holding the L2 strength (the frozen
        # tail of the tuple).
        nll = _logaddexp0(margin) - yb * margin
        _, w, v = params[:3]
        reg = params[3][0] * (torch.sum(w * w) + torch.sum(v * v))
        return torch.sum(nll * wb) + reg * torch.sum(wb)

    return local_loss


def _fm_squared_loss_builder():
    def local_loss(params, xb, yb, wb):
        err = _fm_margin(params[:3], xb) - yb
        _, w, v = params[:3]
        reg = params[3][0] * (torch.sum(w * w) + torch.sum(v * v))
        return 0.5 * torch.sum(err * err * wb) + reg * torch.sum(wb)

    return local_loss


# -- the embedding-sharded factor path ---------------------------------------

#: Parameter names of the sharded-FM state — the ``*embedding*`` suffixes
#: land V and w (and their Adam slots) in the plan's EMBEDDING family.
_FM_V_PARAM = "fm/v_embedding"
_FM_W_PARAM = "fm/w_embedding"


def _fm_sharded_trainer(mesh, row_axes, n_shards: int, emu_bs: int,
                        logistic: bool):
    """Adam trainer with V/w (and their m/v slots) row-sharded over
    ``row_axes`` and x column-sharded to match: ``trainer(x_cols, y, wt,
    w0, w_sh, v_sh, reg, lr, max_iter, tol, key) -> ((w0, w_sh, v_sh),
    steps, loss)``, ``x_cols`` every row of this shard's feature columns.

    Reproduces the replicated trainer's SAMPLING for a data world of
    ``n_shards``: each step's ``fold_in`` key draws ``emu_bs`` positions,
    applied to each of the ``n_shards`` contiguous row blocks. Margins and
    gradients agree with the replicated trainer up to float32 summation
    order; over many steps Adam's ``±lr·sign(ĝ)`` update turns that order
    noise into full ``lr`` jumps on near-zero gradients, so whole fits
    are held on quality, not per coordinate."""
    from flinkml_tpu_torch.embeddings.exchange import ShardAxes
    from flinkml_tpu_torch.parallel.collectives import group_all_reduce

    axes = ShardAxes.of(mesh, row_axes)

    def trainer(x, y, wt, w0, w_sh, v_sh, reg, lr, max_iter: int,
                tol: float, key):
        n_rows = x.shape[0]
        n_block = n_rows // n_shards
        k = v_sh.shape[1]
        reg0 = float(reg[0])
        lr = torch.tensor(lr, dtype=torch.float32, device=x.device)
        offsets = (torch.arange(n_shards, device=x.device)
                   * n_block)[:, None]
        draws = IndexDraws(key, emu_bs, n_block)
        params = (w0, w_sh, v_sh)
        m = tuple(torch.zeros_like(p) for p in params)
        v = tuple(torch.zeros_like(p) for p in params)
        tol32 = np.float32(tol)
        prev, cur = np.float32(np.inf), np.float32(-np.inf)
        step = 0
        loss = torch.tensor(-np.inf, dtype=torch.float32)
        while step < max_iter and np.abs(prev - cur) > tol32:
            w0_, w_, v_ = params
            gidx = (draws(step)[None, :] + offsets).reshape(-1)
            xb, yb, wb = x[gidx], y[gidx], wt[gidx]
            bsz = xb.shape[0]
            x2 = xb * xb
            sq_local = torch.sum(w_ * w_) + torch.sum(v_ * v_)
            partial = torch.cat([(xb @ v_).reshape(-1),
                                 (x2 @ (v_ * v_)).reshape(-1),
                                 xb @ w_, sq_local.reshape(1)])
            partial = group_all_reduce(axes.group, axes.ranks, partial)
            xv = partial[:bsz * k].reshape(bsz, k)
            x2v2 = partial[bsz * k:2 * bsz * k].reshape(bsz, k)
            lin = partial[2 * bsz * k:2 * bsz * k + bsz]
            sq = partial[-1]
            margin = w0_[0] + lin + 0.5 * torch.sum(xv * xv - x2v2, dim=1)
            if logistic:
                nll = _logaddexp0(margin) - yb * margin
                g = (torch.sigmoid(margin) - yb) * wb
            else:
                err = margin - yb
                nll = 0.5 * err * err
                g = err * wb
            wsum = torch.sum(wb)
            total_w = torch.clamp_min(wsum, 1e-12)
            loss = (torch.sum(nll * wb) + reg0 * sq * wsum) / total_w
            gw0 = torch.sum(g)[None] / total_w
            gw = (xb.T @ g + 2.0 * reg0 * w_ * wsum) / total_w
            gv = (xb.T @ (g[:, None] * xv) - (x2.T @ g)[:, None] * v_
                  + 2.0 * reg0 * v_ * wsum) / total_w
            params, m, v = adam_update(params, m, v, (gw0, gw, gv), step, lr)
            prev, cur = cur, np.float32(loss.item())
            step += 1
        return params, step, loss

    return trainer


def _mesh(mesh):
    from flinkml_tpu_torch.parallel.mesh import DeviceMesh

    return mesh if mesh is not None else DeviceMesh()


class _FMBase(StreamingEstimatorMixin, _FMParams, Estimator):
    """``fit`` also accepts an iterable of batch Tables or a sealed
    :class:`~flinkml_tpu_torch.iteration.datacache.DataCache` — the
    out-of-core path (:func:`~flinkml_tpu_torch.models._adam.
    run_streamed_adam`). ``checkpoint_manager`` + ``checkpoint_interval``
    snapshot the full Adam state every N epochs; ``resume=True`` (durable
    DataCache input required) continues exactly."""

    _LOGISTIC = True

    #: The FM trainers thread an EMBEDDING-family ShardingPlan through the
    #: factor matrix (the module docstring).
    _SHARDING_PLAN_AWARE = True

    def _loss_builder(self):
        return (_fm_logistic_loss_builder if self._LOGISTIC
                else _fm_squared_loss_builder)

    def _params0(self, d: int, device):
        """Initial flat params tuple (bias, w, V, frozen reg tail) — the
        single source for the in-RAM and streamed paths."""
        k = self.get(self.FACTOR_SIZE)
        v0 = threefry.normal(threefry.PRNGKey(self.get_seed(), device),
                             (d, k)) * 0.01
        return (
            torch.zeros(1, dtype=torch.float32, device=device),
            torch.zeros(d, dtype=torch.float32, device=device),
            v0,
            torch.tensor([self.get(self.REG)], dtype=torch.float32,
                         device=device),
        )

    def _make_model(self, params):
        model = (FMClassifierModel if self._LOGISTIC else FMRegressorModel)()
        model.copy_params_from(self)
        host = [torch.as_tensor(t).detach().cpu().numpy().astype(np.float64)
                for t in params[:3]]
        model._set(host[0][0], host[1], host[2])
        return model

    def _fit_stream(self, source):
        """Out-of-core FM through the shared streamed-Adam runner; the reg
        strength rides as the frozen params-tuple tail."""
        from flinkml_tpu_torch.models._adam import run_streamed_adam

        if self.sharding_plan is not None:
            # The cache-replay trainer keeps factors replicated: dropping
            # the plan in silence would replicate the factor matrix, the
            # memory the plan was set to save.
            raise ValueError(
                f"{type(self).__name__} streamed fit does not thread a "
                "sharding_plan yet: the cache-replay trainer keeps "
                "factors replicated. Use the in-RAM fit (which shards "
                "V/w + Adam slots per the plan's embedding family), or "
                "drop the plan."
            )
        features_col = self.get(self.FEATURES_COL)
        label_col = self.get(self.LABEL_COL)
        weight_col = self.get(self.WEIGHT_COL)
        mesh = _mesh(self.mesh)

        def prepare_y(y):
            y = np.asarray(y, np.float32)
            if self._LOGISTIC:
                check_binary_labels(y, type(self).__name__)
            return y

        def ingest(t):
            x, y, w = labeled_data(t, features_col, label_col, weight_col)
            return {"x": x.astype(np.float32), "y": prepare_y(y),
                    "w": w.astype(np.float32)}

        params = run_streamed_adam(
            source,
            what="FM streamed fit",
            mesh=mesh,
            cache_dir=self.cache_dir,
            cache_memory_budget_bytes=self.cache_memory_budget_bytes,
            ingest=ingest,
            place_y=prepare_y,
            loss_builder=self._loss_builder(),
            n_params=4,
            params0_fn=lambda d: self._params0(d, mesh.device),
            lr=self.get(self.LEARNING_RATE),
            global_bs=self.get(self.GLOBAL_BATCH_SIZE),
            max_iter=self.get(self.MAX_ITER),
            tol=self.get(self.TOL),
            seed=self.get_seed(),
            frozen_tail=1,
            **self._checkpoint_kwargs(),
        )
        return self._make_model(params)

    def _fit_sharded(self, x, y, w):
        """The embedding-sharded factor fit (the module docstring); refuses
        loudly where the layout cannot host the trainer."""
        from flinkml_tpu_torch.parallel.mesh import DeviceMesh
        from flinkml_tpu_torch.sharding.apply import validate_plan
        from flinkml_tpu_torch.sharding.plan import entry_axes

        plan = self.sharding_plan
        spec = plan.spec_for(_FM_V_PARAM, ndim=2)
        row_entry = spec[0] if spec else None
        if any(entry_axes(e) for e in spec[1:]):
            raise ValueError(
                f"plan {plan.name!r} shards the FM factor matrix's "
                "factor dim (dim 1): the sharded trainer keeps factor "
                "rows whole (the embedding-family layout). Use the "
                "EMBEDDING or FSDP preset."
            )
        if not entry_axes(row_entry):
            raise ValueError(
                f"plan {plan.name!r} leaves the FM factor family "
                f"({_FM_V_PARAM!r}) replicated — pass a plan whose "
                "embedding family shards rows (EMBEDDING/FSDP), or drop "
                "sharding_plan to train replicated."
            )
        mesh = self.mesh or DeviceMesh.for_plan(plan)
        row_axes = entry_axes(row_entry)
        sizes = mesh.shape
        n_shards = 1
        for axis in row_axes:
            n_shards *= int(sizes.get(axis, 1))
        d = x.shape[1]
        k = self.get(self.FACTOR_SIZE)
        d_pad = -(-d // n_shards) * n_shards
        validate_plan(
            plan, mesh,
            param_shapes={_FM_V_PARAM: (d_pad, k), _FM_W_PARAM: (d_pad,)},
            optimizer_slots=2,  # Adam m/v shard like their table
        )
        n_pad = -(-x.shape[0] // n_shards) * n_shards
        xp = np.zeros((n_pad, d_pad), np.float32)
        xp[: x.shape[0], :d] = x
        yp = np.zeros(n_pad, np.float32)
        yp[: x.shape[0]] = y
        wp = np.zeros(n_pad, np.float32)
        wp[: x.shape[0]] = w[: x.shape[0]]
        device = mesh.device
        w0_0, _, v0, reg = self._params0(d, device)
        v0p = torch.zeros((d_pad, k), dtype=torch.float32, device=device)
        v0p[:d] = v0
        cols = d_pad // n_shards
        me = mesh.coordinate_of(row_axes)
        part = slice(me * cols, (me + 1) * cols)
        emu_bs = max(1, self.get(self.GLOBAL_BATCH_SIZE) // n_shards)
        trainer = _fm_sharded_trainer(mesh, row_axes, n_shards, emu_bs,
                                      self._LOGISTIC)
        (w0, w_sh, v_sh), _steps, _loss = trainer(
            torch.from_numpy(np.ascontiguousarray(xp[:, part])).to(device),
            torch.from_numpy(yp).to(device), torch.from_numpy(wp).to(device),
            w0_0, torch.zeros(cols, dtype=torch.float32, device=device),
            v0p[part].contiguous(), reg.cpu().numpy(),
            self.get(self.LEARNING_RATE), self.get(self.MAX_ITER),
            self.get(self.TOL),
            threefry.fold_in(threefry.PRNGKey(self.get_seed(), device), 321),
        )
        from flinkml_tpu_torch.embeddings.exchange import ShardAxes
        from flinkml_tpu_torch.parallel.collectives import group_all_gather

        axes = ShardAxes.of(mesh, row_axes)
        w_full = group_all_gather(axes.group, axes.ranks, w_sh)
        v_full = group_all_gather(axes.group, axes.ranks, v_sh)
        return self._make_model((w0, w_full[:d], v_full[:d]))

    def fit(self, *inputs):
        from flinkml_tpu_torch.parallel.mesh import pad_to_multiple

        (table,) = inputs
        if not isinstance(table, Table):
            return self._fit_stream(table)
        self._reject_in_ram_checkpointing()
        x, y, w = labeled_data(
            table, self.get(self.FEATURES_COL), self.get(self.LABEL_COL),
            self.get(self.WEIGHT_COL),
        )
        if self._LOGISTIC:
            check_binary_labels(y, type(self).__name__)
        if self.sharding_plan is not None:
            return self._fit_sharded(x, y, w)
        d = x.shape[1]
        mesh = _mesh(self.mesh)
        p = mesh.axis_size()
        x_pad, n_valid = pad_to_multiple(x.astype(np.float32), p)
        y_pad, _ = pad_to_multiple(y.astype(np.float32), p)
        w_pad = np.zeros(x_pad.shape[0], np.float32)
        w_pad[:n_valid] = w[:n_valid].astype(np.float32)
        local_bs = max(1, self.get(self.GLOBAL_BATCH_SIZE) // p)
        trainer = make_adam_trainer(mesh, local_bs, self._loss_builder(), 4,
                                    frozen_tail=1)
        params, _steps, _loss = trainer(
            mesh.shard_batch(x_pad), mesh.shard_batch(y_pad),
            mesh.shard_batch(w_pad), self._params0(d, mesh.device),
            self.get(self.LEARNING_RATE), self.get(self.MAX_ITER),
            self.get(self.TOL),
            threefry.fold_in(threefry.PRNGKey(self.get_seed(), mesh.device),
                             321),
        )
        return self._make_model(params)


class _FMModelBase(_FMParams, Model):
    def __init__(self):
        super().__init__()
        self._w0: Optional[float] = None
        self._w: Optional[np.ndarray] = None
        self._v: Optional[np.ndarray] = None

    def _set(self, w0, w, v):
        self._w0, self._w, self._v = float(w0), np.asarray(w), np.asarray(v)

    def set_model_data(self, *inputs: Table):
        (table,) = inputs
        self._set(
            float(np.asarray(table.column("w0"))[0]),
            np.asarray(table.column("w"), np.float64)[0],
            np.asarray(table.column("v"), np.float64)[0],
        )
        return self

    def get_model_data(self) -> List[Table]:
        self._require()
        return [Table({
            "w0": np.asarray([self._w0]),
            "w": self._w[None, :],
            "v": self._v[None, :, :],
        })]

    def _require(self) -> None:
        if self._w is None:
            raise ValueError("Model data is not set; fit or set_model_data first")

    def _arrays(self):
        self._require()
        return {"w0": np.asarray(self._w0), "w": self._w, "v": self._v}

    def _set_arrays(self, arrays) -> None:
        w = np.asarray(arrays["w"])
        v = np.asarray(arrays["v"])
        self._set(float(np.asarray(arrays["w0"]).reshape(-1)[0]),
                  w.reshape(w.shape[-1]), v.reshape(v.shape[-2:]))

    def _margin(self, table: Table) -> np.ndarray:
        from flinkml_tpu_torch.models._data import sparse_features

        vecs = sparse_features(table, self.get(self.FEATURES_COL))
        if vecs is not None:
            return self._margin_sparse(vecs)
        x = features_matrix(table, self.get(self.FEATURES_COL))
        xv = x @ self._v
        x2v2 = (x * x) @ (self._v * self._v)
        return self._w0 + x @ self._w + 0.5 * (xv * xv - x2v2).sum(axis=1)

    def _margin_sparse(self, vecs) -> np.ndarray:
        """O(nnz·k) float64 margin over a padded-ELL block on the compute
        device: the linear term is the ``spmv`` kernel, the pairwise term
        gathers factor rows (``v[indices]``, ``[n, s, k]``) and contracts
        them. ELL padding (index 0, value 0) adds exact zeros to both
        terms."""
        from flinkml_tpu_torch.device import default_device
        from flinkml_tpu_torch.kernels.spmv import spmv
        from flinkml_tpu_torch.ops.sparse import BatchedCSR

        ib, vb, d = BatchedCSR.pack_sparse_vectors(vecs, dtype=np.float64)
        if d != self._w.shape[0]:
            raise ValueError(
                f"sparse features have dim {d}, model expects "
                f"{self._w.shape[0]}"
            )
        if vb.shape[1] == 0:  # all-empty rows: margin is the intercept
            return np.full(vb.shape[0], self._w0)
        device = default_device()
        idx = torch.from_numpy(ib).to(device)
        val = torch.from_numpy(vb).to(device)
        w = torch.from_numpy(np.asarray(self._w, np.float64)).to(device)
        v = torch.from_numpy(np.asarray(self._v, np.float64)).to(device)
        gathered = v[idx.long()]                          # [n, s, k]
        xv = torch.einsum("ns,nsk->nk", val, gathered)
        x2v2 = torch.einsum("ns,nsk->nk", val * val, gathered * gathered)
        margin = spmv(idx, val, w) + 0.5 * (xv * xv - x2v2).sum(dim=1)
        return (self._w0 + margin).cpu().numpy()


class FMClassifier(_FMBase):
    """Binary factorization-machine classifier (logistic loss)."""

    _LOGISTIC = True


class FMClassifierModel(_FMModelBase):
    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        margin = self._margin(table)
        prob = 1.0 / (1.0 + np.exp(-margin))
        out = table.with_column(
            self.get(self.PREDICTION_COL), (margin >= 0).astype(np.float64)
        )
        out = out.with_column(
            self.get(self.RAW_PREDICTION_COL),
            np.stack([1.0 - prob, prob], axis=1),
        )
        return (out,)


class FMRegressor(_FMBase):
    """Factorization-machine regressor (squared loss)."""

    _LOGISTIC = False


class FMRegressorModel(_FMModelBase):
    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        (table,) = inputs
        self._require()
        return (
            table.with_column(
                self.get(self.PREDICTION_COL), self._margin(table)
            ),
        )
