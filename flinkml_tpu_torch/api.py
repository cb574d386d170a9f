"""The five stage interfaces of the pipeline API.

The port's counterpart of ``flinkml_tpu.api`` (itself parity with the
reference's ``flink-ml-core/.../ml/api/``):
  - ``Stage`` = WithParams + save/load (``Stage.java:34-44``),
  - ``AlgoOperator.transform(*tables)`` (``AlgoOperator.java:31-38``),
  - ``Transformer`` marker (``Transformer.java:32``),
  - ``Model`` adds ``set_model_data``/``get_model_data`` (``Model.java:38-50``),
  - ``Estimator.fit(*tables) -> Model`` (``Estimator.java:31-38``).

Tables are in-memory columnar batches (:class:`~flinkml_tpu_torch.table.Table`)
and fit/transform execute eagerly on the compute device
(:func:`~flinkml_tpu_torch.device.default_device`).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from flinkml_tpu_torch.io import read_write
from flinkml_tpu_torch.params import WithParams
from flinkml_tpu_torch.table import Table


@dataclasses.dataclass(frozen=True)
class ColumnKernel:
    """A stage's transform as a row-local columnar function — the unit the
    fused pipeline executor (:mod:`flinkml_tpu_torch.pipeline_fusion`)
    chains into one ``fused_chain`` kernel launch per run of stages.

    ``fn(cols, consts, valid)`` is the stage's plain PyTorch math: it maps
    a dict of tensors (one per ``input_cols`` entry, leading axis = padded
    rows) plus a dict of the stage's model constants (host numpy arrays,
    moved to the columns' device by ``fn``) and a float32 ``[rows]``
    validity mask to a dict of output tensors named by ``output_cols``.
    It is the CPU path of the executor and the reference the CUDA
    ``fused_chain`` kernel is held against.

    ``fingerprint`` fully determines the math: its first entry names the
    stage and the rest carry column names and flags — the CUDA chain
    reads the stage's op from it (:mod:`flinkml_tpu_torch.kernels.chain`).
    Values that only change numbers (fitted statistics) live in
    ``constants``.

    ``pin_inputs``: the stage's chain-produced input columns are
    materialized as eager outputs of the run (the JAX package pins them so
    the stage's transcendental ops lower as in the per-stage program; the
    port keeps the rule so both packages produce the same eager columns).

    ``accumulates``: where the stage reduces under a declared precision
    policy — ``"accum"`` (at ``policy.accum``, as LogisticRegression's
    products), ``"compute"`` (at ``policy.compute``, as KMeans' distance
    sums), or None (no reduction). The fused executor's precision check
    reads it in place of the JAX package's program walk.
    """

    input_cols: Tuple[str, ...]
    output_cols: Tuple[str, ...]
    fn: Callable[[Dict[str, Any], Dict[str, Any], Any], Dict[str, Any]]
    constants: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    fingerprint: Tuple = ()
    pin_inputs: bool = False
    accumulates: Optional[str] = None


class Stage(WithParams, abc.ABC):
    """Base class for nodes in a Pipeline; save/load-able.

    A stage directory holds a JSON ``metadata`` file; stages with model
    data add arrays under ``data/``. ``load`` is a classmethod; the generic
    loader (:func:`flinkml_tpu_torch.io.read_write.load_stage`) dispatches
    on the recorded class name.
    """

    def save(self, path: str) -> None:
        read_write.save_metadata(self, path)

    @classmethod
    def load(cls, path: str) -> "Stage":
        meta = read_write.load_metadata(path, expected_class=cls)
        return read_write.instantiate_with_params(cls, meta["paramMap"])


class AlgoOperator(Stage):
    """A Stage that computes output tables from input tables."""

    @abc.abstractmethod
    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        """Apply the operator to the inputs; returns a tuple of result tables."""

    def transform_kernel(self) -> Optional[ColumnKernel]:
        """The stage's transform as a chainable :class:`ColumnKernel`, or
        ``None`` when the stage (or its current configuration) cannot be
        expressed as a row-local columnar function. ``PipelineModel``
        fuses maximal runs of kernel-capable stages; the fused output
        matches ``transform``'s on dense input (same dtypes, same op
        order)."""
        return None


class Transformer(AlgoOperator):
    """An AlgoOperator with the semantics of a feature engineering /
    prediction step."""


class Model(Transformer):
    """A Transformer parameterized by fitted model data.

    Model data lives on the host as named numpy arrays (``_arrays`` /
    ``_set_arrays``): the layout ``save`` writes to ``data/model.npz``,
    byte-compatible with the JAX package's.
    """

    def set_model_data(self, *inputs: Table) -> "Model":
        raise NotImplementedError(
            f"{type(self).__name__} does not support set_model_data"
        )

    def get_model_data(self) -> List[Table]:
        raise NotImplementedError(
            f"{type(self).__name__} does not support get_model_data"
        )

    def _arrays(self) -> Dict[str, np.ndarray]:
        """The model's named arrays as ``save`` persists them."""
        raise NotImplementedError(f"{type(self).__name__} has no model arrays")

    def _set_arrays(self, arrays: Mapping[str, np.ndarray]) -> None:
        """Install arrays in the ``_arrays`` layout (load, stage_from_arrays)."""
        raise NotImplementedError(f"{type(self).__name__} has no model arrays")

    def save(self, path: str) -> None:
        self._save_with_arrays(path, self._arrays())

    @classmethod
    def load(cls, path: str) -> "Model":
        model, arrays, _ = cls._load_with_arrays(path)
        model._set_arrays(arrays)
        return model

    # -- shared persistence scaffold ---------------------------------------
    def _save_with_arrays(self, path: str, arrays, extra=None) -> None:
        """Standard model layout: metadata JSON + named arrays under data/,
        with a sha256 content fingerprint of arrays + param map recorded in
        the metadata and verified on load."""
        extra = dict(extra or {})
        extra[read_write.FINGERPRINT_KEY] = read_write.content_fingerprint(
            arrays, self.get_param_map_json()
        )
        read_write.save_metadata(self, path, extra=extra)
        read_write.save_model_arrays(path, arrays)

    @classmethod
    def _load_with_arrays(cls, path: str):
        """Counterpart of ``_save_with_arrays``: class-checked metadata,
        fingerprint-verified arrays, params restored; returns
        ``(model, arrays, metadata)``."""
        meta = read_write.load_metadata(path, expected_class=cls)
        model = cls()
        model.load_param_map_json(meta["paramMap"])
        arrays = read_write.load_model_arrays(path)
        read_write.verify_arrays(path, meta, arrays)
        return model, arrays, meta


class Estimator(Stage):
    """Fits a Model from training tables."""

    @abc.abstractmethod
    def fit(self, *inputs: Table) -> Model:
        ...
