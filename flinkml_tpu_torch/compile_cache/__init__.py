"""Persistent store of built kernel libraries: zero ``nvcc`` at spin-up.

The port's counterpart of ``flinkml_tpu.compile_cache``. Every process
used to find its kernel libraries in the checkout's ``kernels/build/``,
keyed by the source and flags only. This package keys each library by its
program (name, source hash, flags) AND its environment (torch, CUDA,
``nvcc``, card, driver), checks it before it is loaded, rebuilds a torn
one, and lets an operator keep the libraries anywhere: a fresh replica, a
respawned cluster worker or an elastic restart loads them instead of
running ``nvcc``.

See :mod:`flinkml_tpu_torch.compile_cache.store` for the key schema,
invalidation rules and concurrency.
"""

from flinkml_tpu_torch.compile_cache.store import (  # noqa: F401
    CompileCacheStore,
    ENV_DIR_VAR,
    active_store,
    configure,
    ensure_store,
    env_fingerprint,
    reset,
    serialization_supported,
    stable_key_repr,
)

__all__ = [
    "CompileCacheStore",
    "ENV_DIR_VAR",
    "active_store",
    "configure",
    "ensure_store",
    "env_fingerprint",
    "reset",
    "serialization_supported",
    "stable_key_repr",
]
