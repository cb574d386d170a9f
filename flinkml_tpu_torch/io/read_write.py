"""Stage persistence: JSON metadata + ``.npz`` model data.

The port's counterpart of ``flinkml_tpu.io.read_write``, with the same
on-disk format, so a model saved by one package loads in the other:

  - ``metadata`` JSON holding {className, timestamp, paramMap, extra};
  - model arrays as a compressed ``data/model.npz`` (host numpy arrays —
    model data is small and lives on the host between transforms);
  - a sha256 ``contentFingerprint`` over arrays + param map, verified on
    load.

Class names on disk are the JAX package's (``flinkml_tpu.models.…``): the
port writes them on save, and maps the ``flinkml_tpu.`` prefix onto
``flinkml_tpu_torch.`` on load without importing the JAX package. A stage
class of the port therefore accepts either spelling of its own name.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np

METADATA_FILE = "metadata"
MODEL_DATA_DIR = "data"
FINGERPRINT_KEY = "contentFingerprint"

#: Package prefixes on disk (the JAX package's) and in this process.
SAVED_PREFIX = "flinkml_tpu."
PORT_PREFIX = "flinkml_tpu_torch."


class ModelIntegrityError(ValueError):
    """A stage's persisted model data does not match the content
    fingerprint recorded in its metadata — the files were tampered with,
    truncated, or mixed between saves. Raised on load."""


def saved_class_name(cls: type) -> str:
    """The class name written to ``metadata``: the port's module path with
    its package prefix mapped to the JAX package's, so both packages
    resolve the saved stage."""
    name = f"{cls.__module__}.{cls.__qualname__}"
    if name.startswith(PORT_PREFIX):
        return SAVED_PREFIX + name[len(PORT_PREFIX):]
    return name


def port_class_name(name: str) -> str:
    """A saved class name as the port's dotted path (the inverse of
    :func:`saved_class_name`; names outside the JAX package pass as-is)."""
    if name.startswith(SAVED_PREFIX):
        return PORT_PREFIX + name[len(SAVED_PREFIX):]
    return name


def content_fingerprint(
    arrays: Mapping[str, Any],
    param_map_json: Optional[Mapping[str, Any]] = None,
) -> str:
    """Deterministic sha256 over named model arrays (+ optionally the
    stage's param map): names, dtypes, shapes, and raw bytes all
    contribute. Byte-identical to the JAX package's function."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(np.asarray(arrays[name]))
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    if param_map_json is not None:
        h.update(json.dumps(dict(param_map_json), sort_keys=True,
                            default=str).encode())
    return h.hexdigest()


def verify_arrays(path: str, meta: Mapping[str, Any],
                  arrays: Mapping[str, np.ndarray]) -> None:
    """Raise :class:`ModelIntegrityError` when ``arrays`` and the param
    map in ``meta`` do not match its recorded fingerprint (stages saved
    without one pass)."""
    recorded = meta.get(FINGERPRINT_KEY)
    if recorded is None:
        return
    actual = content_fingerprint(arrays, meta.get("paramMap"))
    if actual != recorded:
        raise ModelIntegrityError(
            f"model data at {path} does not match its recorded content "
            f"fingerprint (recorded {recorded[:12]}..., actual "
            f"{actual[:12]}...): the persisted arrays or params were "
            "modified after save"
        )


def stage_path(parent: str, stage_idx: int) -> str:
    """Numbered per-stage subdirectory of a composite stage."""
    return os.path.join(parent, "stages", f"{stage_idx}")


def save_metadata(stage: Any, path: str, extra: Optional[Mapping[str, Any]] = None) -> None:
    os.makedirs(path, exist_ok=True)
    meta: Dict[str, Any] = dict(extra or {})
    meta["className"] = saved_class_name(type(stage))
    meta["timestamp"] = int(time.time() * 1000)
    meta["paramMap"] = stage.get_param_map_json()
    metadata_path = os.path.join(path, METADATA_FILE)
    if os.path.exists(metadata_path):
        raise IOError(f"File {metadata_path} already exists")
    with open(metadata_path, "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)


def load_metadata(path: str, expected_class: Optional[type] = None) -> Dict[str, Any]:
    """Read ``path/metadata``; with ``expected_class``, refuse a stage
    saved as any other class (either package's spelling is accepted)."""
    with open(os.path.join(path, METADATA_FILE)) as f:
        meta = json.load(f)
    if expected_class is not None:
        expected = f"{expected_class.__module__}.{expected_class.__qualname__}"
        if port_class_name(meta.get("className", "")) != expected:
            raise ValueError(
                f"Stage metadata at {path} has className "
                f"{meta.get('className')}, expected "
                f"{saved_class_name(expected_class)}"
            )
    return meta


def load_stage(path: str) -> Any:
    """Instantiate the stage recorded at ``path`` (saved by either
    package): resolve the class in the port, then delegate to its own
    ``load`` (which verifies the content fingerprint) or rebuild it from
    params alone."""
    meta = load_metadata(path)
    cls = resolve_class(meta["className"])
    own_load = _class_defines_own_load(cls)
    if own_load is not None:
        return own_load(path)
    return instantiate_with_params(cls, meta["paramMap"])


def stage_from_arrays(class_name: str, param_map_json: Mapping[str, Any],
                      arrays: Mapping[str, Any]) -> Any:
    """Build the port's stage from the JAX package's model data without
    touching the disk: ``class_name`` in either package's spelling,
    ``param_map_json`` as ``get_param_map_json()`` returns it, and
    ``arrays`` the model's named numpy arrays as its ``save`` writes them
    to ``data/model.npz`` (a leading axis of 1, as ``get_model_data()``
    tables carry it, is accepted too)."""
    cls = resolve_class(class_name)
    stage = instantiate_with_params(cls, param_map_json)
    stage._set_arrays({k: np.asarray(v) for k, v in arrays.items()})
    return stage


def instantiate_with_params(cls: type, param_map_json: Mapping[str, Any]) -> Any:
    stage = cls()
    stage.load_param_map_json(dict(param_map_json))
    return stage


def resolve_class(dotted: str) -> type:
    """The port's class for a saved dotted name (the longest importable
    module prefix, then attribute walks for nested classes)."""
    dotted = port_class_name(dotted)
    if not dotted.startswith(PORT_PREFIX):
        raise ImportError(
            f"stage class {dotted!r} is not part of flinkml_tpu_torch"
        )
    module_name = dotted.rpartition(".")[0]
    while module_name:
        try:
            mod = importlib.import_module(module_name)
        except ModuleNotFoundError as e:
            # Only swallow "this prefix is not a module" — a missing
            # dependency raised from inside the module must surface.
            if e.name and (
                module_name == e.name or module_name.startswith(e.name + ".")
            ):
                module_name = module_name.rpartition(".")[0]
                continue
            raise
        obj: Any = mod
        try:
            for part in dotted[len(module_name) + 1:].split("."):
                obj = getattr(obj, part)
        except AttributeError:
            module_name = module_name.rpartition(".")[0]
            continue
        return obj
    raise ImportError(f"Cannot resolve stage class {dotted!r}")


def _class_defines_own_load(cls: type):
    """Return cls.load if defined below Stage in the MRO, else None."""
    from flinkml_tpu_torch.api import Stage

    for klass in cls.__mro__:
        if klass is Stage:
            return None
        if "load" in vars(klass):
            return getattr(cls, "load")
    return None


# -- model data ------------------------------------------------------------

def save_model_arrays(path: str, arrays: Mapping[str, np.ndarray], name: str = "model") -> str:
    """Persist named host arrays as a compressed npz under path/data/."""
    data_dir = os.path.join(path, MODEL_DATA_DIR)
    os.makedirs(data_dir, exist_ok=True)
    out = os.path.join(data_dir, f"{name}.npz")
    np.savez_compressed(out, **{k: np.asarray(v) for k, v in arrays.items()})
    return out


def load_model_arrays(path: str, name: str = "model") -> Dict[str, np.ndarray]:
    out = os.path.join(path, MODEL_DATA_DIR, f"{name}.npz")
    with np.load(out, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
