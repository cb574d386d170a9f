"""The port's package surface against the JAX package's.

For every package of ``flinkml_tpu_torch`` whose JAX counterpart declares
``__all__``, the port's ``__all__`` holds each of the JAX names but a
listed set of gaps, every name in the port's ``__all__`` resolves, and
no gap is in fact exported (a gap closed by a port must leave this list).
Each gap names its ROADMAP.md item; the kernel gate's names are a
declared difference: the port's wrappers pick their device path from the
tensor's device, with no backend knob.
"""

from __future__ import annotations

import importlib
import os

import pytest

import flinkml_tpu_torch

PORT_ROOT = os.path.dirname(flinkml_tpu_torch.__file__)

#: Names of the JAX ``__all__`` the port does not export yet, by package.
GAPS = {
    # Declared difference: the JAX kernel gate (backend knobs, interpret
    # mode, the Pallas entry points).
    "flinkml_tpu_torch.kernels": {
        "BACKENDS", "ENV_INTERPRET_VAR", "ENV_VAR", "KNOB_PREFIX",
        "backend_for", "interpret_mode", "resolve_backend",
        "pallas_segment_sum", "segment_sum", "segsum_backend", "pallas_spmv",
        "spmv_backend", "pallas_top_k", "top_k", "topk_backend",
    },
}


def _port_packages():
    names = ["flinkml_tpu_torch"]
    for root, dirs, files in os.walk(PORT_ROOT):
        dirs[:] = sorted(d for d in dirs if not d.startswith(("_", ".")))
        if root != PORT_ROOT and "__init__.py" in files:
            rel = os.path.relpath(root, os.path.dirname(PORT_ROOT))
            names.append(rel.replace(os.sep, "."))
    return sorted(names)


def _pairs():
    out = []
    for name in _port_packages():
        jax_name = "flinkml_tpu" + name[len("flinkml_tpu_torch"):]
        try:
            jax_pkg = importlib.import_module(jax_name)
        except ImportError:
            continue
        if hasattr(jax_pkg, "__all__"):
            out.append((name, jax_pkg))
    return out


PAIRS = _pairs()


def test_packages_found():
    names = {name for name, _ in PAIRS}
    for must in ("flinkml_tpu_torch", "flinkml_tpu_torch.models",
                 "flinkml_tpu_torch.data", "flinkml_tpu_torch.io",
                 "flinkml_tpu_torch.kernels", "flinkml_tpu_torch.utils"):
        assert must in names
    assert set(GAPS) <= names


@pytest.mark.parametrize("name,jax_pkg", PAIRS, ids=[n for n, _ in PAIRS])
def test_port_exports_the_jax_names(name, jax_pkg):
    port = importlib.import_module(name)
    exported = set(getattr(port, "__all__", ()))
    for n in exported:
        assert hasattr(port, n), f"{name}.__all__ lists {n!r}, not defined"
    gaps = GAPS.get(name, set())
    missing = [n for n in jax_pkg.__all__ if n not in exported
               and n not in gaps]
    assert not missing, f"{name} lacks {missing} of the JAX __all__"
    closed = sorted(g for g in gaps if g in exported)
    assert not closed, f"{name} now exports {closed}: drop them from GAPS"
    assert gaps <= set(jax_pkg.__all__), "a gap the JAX package lacks"


def test_models_follow_the_jax_order():
    import flinkml_tpu.models as jm
    import flinkml_tpu_torch.models as tm

    assert tm.__all__ == [n for n in jm.__all__ if n in set(tm.__all__)]


def test_surface_repairs():
    import flinkml_tpu_torch as fml
    import flinkml_tpu_torch.data as data
    import flinkml_tpu_torch.io as io
    from flinkml_tpu_torch import params
    from flinkml_tpu_torch.data.ops import HashOp
    from flinkml_tpu_torch.io import read_write

    assert data.HashOp is HashOp
    assert "refused" not in (data.__doc__ or "")
    for n in ("Param", "IntParam", "LongParam", "FloatParam", "BoolParam",
              "StringParam", "IntArrayParam", "FloatArrayParam",
              "StringArrayParam", "ParamValidators", "WithParams"):
        assert getattr(fml, n) is getattr(params, n)
    for n in ("save_metadata", "load_metadata", "save_model_arrays",
              "load_model_arrays"):
        assert getattr(io, n) is getattr(read_write, n)
