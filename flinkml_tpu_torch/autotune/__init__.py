"""Measurement-driven autotuning: guessed defaults become measured ones.

The port's counterpart of ``flinkml_tpu.autotune``. The knobs whose
defaults were guesses (``infer_plan``'s preset order, the serving
engine's dispatch bucket cap and batching window, the autoscaler's
scale-up backlog, the int8 tier's smallest quantized constant, the
embedding exchange, and the four sort-class layouts: the sparse trainers'
``layout=``, GBT's ``hist_layout=``, ALS's ``layout=`` and Word2Vec's
``accum=``) are measured on the port's product paths
(:mod:`flinkml_tpu_torch.autotune.search`) and pinned into a committed,
mesh-keyed tuning table (:mod:`flinkml_tpu_torch.autotune.table`)
consulted where each default is resolved: an explicit argument or env var
always wins, the table supplies the default, and the static fallback only
fires when the current mesh (``cuda/<card>/<world>`` or ``cpu/cpu/<world>``)
has no measured entry.

Run the search on the card::

    python -m flinkml_tpu_torch.autotune --quick     # measure + print
    python -m flinkml_tpu_torch.autotune --commit    # rewrite the table
    python -m flinkml_tpu_torch.autotune --check     # schema gate

``FLINKML_TPU_AUTOTUNE=0`` disables every table consult (pure static
defaults, the escape hatch). The JAX package's ``kernel_backend_*`` knobs
have no counterpart: the port's kernel gate has one CUDA route.
"""

from flinkml_tpu_torch.autotune.table import (  # noqa: F401
    DEFAULT_TABLE_PATH,
    KNOWN_KNOBS,
    TuningTable,
    load_table,
    mesh_key,
    tuned_default,
)

__all__ = [
    "DEFAULT_TABLE_PATH",
    "KNOWN_KNOBS",
    "TuningTable",
    "load_table",
    "mesh_key",
    "tuned_default",
]
