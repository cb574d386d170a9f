"""Program capture: the port's counterpart of ``jax.make_jaxpr``.

Every analysis pass of the JAX package walks a jaxpr. The port's passes
walk an ``fx.GraphModule`` made by :func:`capture`:
``make_fx(fn, tracing_mode="fake")`` over fake tensors, so

- it is device-free: no argument is read, no buffer is allocated, and
  ``node.meta["val"]`` carries every node's shape and dtype;
- it is not functionalized: an in-place update (``sub_``, ``copy_``, an
  ``out=`` variant) stays an in-place node whose output aliases the
  mutated argument, which is what the memory pass reads as a donated
  buffer (FML703);
- it sees the port's own kernel and collective sites. A kernel wrapper
  chooses its path by its operands' device, so a trace of the plain path
  would record ``index_add_`` and lose ``segment_sum``'s sorted flag.
  While :func:`capture` traces, this thread's capture flag
  (``kernels._gate.CAPTURE``) is set and each wrapper calls its op of the
  ``flinkml`` namespace (:func:`register_ops`) instead, which the trace
  records as one node with its arguments. Outside a capture a wrapper reads
  the flag once and runs as before: no op, no dispatcher.

The ops: ``segment_sum(values, ids, num_segments, indices_are_sorted)``,
``spmv(indices, values, w)``, ``topk(x, k)``, and the collectives of
:mod:`flinkml_tpu_torch.parallel.collectives` — ``psum``, ``all_reduce_``
and ``broadcast`` (carrying the mesh axis, ``"data"``) and
``group_all_reduce``, ``group_all_gather``, ``group_all_to_all`` and
``ppermute`` (carrying the ranks, ``"ranks=0,1"``). Each has a fake
implementation whose shapes and dtypes are the kernel's, and CPU and CUDA
implementations that are the wrappers themselves (a collective finds its
mesh or group under its string in ``collectives.CAPTURED``).
``fused_chain`` takes chain descriptors, not tensors, so it has no op: the
validator evaluates the plain chain (``kernels.chain.chain_plain``) under
a ``FakeTensorMode`` instead.

Arguments may be tensors, numpy arrays, :class:`TensorSpec` (the port's
``jax.ShapeDtypeStruct``), or Python values, nested in dicts, lists and
tuples; every tensor leaf becomes a fake tensor of the capture's mode.
"""

from __future__ import annotations

import operator
import threading
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

_LIB = None
_LIB_LOCK = threading.Lock()


class TensorSpec(NamedTuple):
    """An abstract argument: shape and dtype, no data."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    device: str = "cpu"


def spec(shape, dtype=torch.float32, device: str = "cpu") -> TensorSpec:
    """A :class:`TensorSpec` (``dtype`` a torch dtype, a numpy dtype or a
    name such as ``"bfloat16"``)."""
    return TensorSpec(tuple(int(d) for d in shape), torch_dtype(dtype),
                      str(device))


def torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    return getattr(torch, name)


# -- the ops ----------------------------------------------------------------

_SCHEMAS = {
    "segment_sum": "segment_sum(Tensor values, Tensor ids, int num_segments,"
                   " bool indices_are_sorted) -> Tensor",
    "spmv": "spmv(Tensor indices, Tensor values, Tensor w) -> Tensor",
    "topk": "topk(Tensor x, int k) -> (Tensor, Tensor)",
    "psum": "psum(Tensor tensor, str axes) -> Tensor",
    "all_reduce_": "all_reduce_(Tensor(a!) tensor, str axes) -> Tensor(a!)",
    "broadcast": "broadcast(Tensor tensor, str axes) -> Tensor",
    "group_all_reduce": "group_all_reduce(Tensor(a!) tensor, str ranks)"
                        " -> Tensor(a!)",
    "group_all_gather": "group_all_gather(Tensor tensor, str ranks) -> Tensor",
    "group_all_to_all": "group_all_to_all(Tensor tensor, str ranks) -> Tensor",
    "ppermute": "ppermute(Tensor[] tensors, str ranks, int shift)"
                " -> Tensor[]",
}

def _n_ranks(ranks: str) -> int:
    return len(ranks.split("=", 1)[1].split(","))


def _fake_impls():
    def segment_sum(values, ids, num_segments, indices_are_sorted):
        return values.new_empty((num_segments,) + tuple(values.shape[1:]))

    def spmv(indices, values, w):
        return values.new_empty((values.shape[0],))

    def topk(x, k):
        shape = tuple(x.shape[:-1]) + (k,)
        return x.new_empty(shape), x.new_empty(shape, dtype=torch.int32)

    def same(tensor, axes):
        return tensor.new_empty(tensor.shape)

    def alias(tensor, axes):
        return tensor

    def gather(tensor, ranks):
        return tensor.new_empty((tensor.shape[0] * _n_ranks(ranks),)
                                + tuple(tensor.shape[1:]))

    def ppermute(tensors, ranks, shift):
        return [t.new_empty(t.shape) for t in tensors]

    return {"segment_sum": segment_sum, "spmv": spmv, "topk": topk,
            "psum": same, "all_reduce_": alias, "broadcast": same,
            "group_all_reduce": alias, "group_all_gather": gather,
            "group_all_to_all": same, "ppermute": ppermute}


def _real_impls():
    from flinkml_tpu_torch.kernels import _gate, segsum, spmv, topk
    from flinkml_tpu_torch.parallel import collectives as coll

    def quiet(fn):
        def run(*args):
            with _gate.not_capturing():
                return fn(*args)
        return run

    def mesh_of(axes):
        return coll.CAPTURED.get(axes)

    def group_of(ranks):
        return coll.CAPTURED.get(ranks, (None, (0,)))

    def psum(tensor, axes):
        mesh = mesh_of(axes)
        return coll.psum(mesh, tensor, axes) if mesh else tensor.clone()

    def all_reduce_(tensor, axes):
        mesh = mesh_of(axes)
        return coll.all_reduce_(mesh, tensor, axes) if mesh else tensor

    def broadcast(tensor, axes):
        mesh = mesh_of(axes)
        return coll.broadcast(mesh, tensor) if mesh else tensor.clone()

    return {
        "segment_sum": lambda v, i, n, s: segsum.segment_sum(
            v, i, n, indices_are_sorted=s),
        "spmv": spmv.spmv,
        "topk": topk.top_k,
        "psum": psum, "all_reduce_": all_reduce_, "broadcast": broadcast,
        "group_all_reduce": lambda t, r: coll.group_all_reduce(
            *group_of(r), t),
        "group_all_gather": lambda t, r: coll.group_all_gather(
            *group_of(r), t),
        "group_all_to_all": lambda t, r: coll.group_all_to_all(
            *group_of(r), t),
        "ppermute": lambda ts, r, s: coll.ppermute(*group_of(r), ts, s),
    }, quiet


def register_ops() -> None:
    """Define the ``flinkml`` ops once per process (idempotent)."""
    global _LIB
    if _LIB is not None:
        return
    with _LIB_LOCK:
        if _LIB is not None:
            return
        lib = torch.library.Library("flinkml", "DEF")
        fakes = _fake_impls()
        reals, quiet = _real_impls()
        for name, schema in _SCHEMAS.items():
            lib.define(schema)
            for key in ("CPU", "CUDA"):
                lib.impl(name, quiet(reals[name]), key)
            torch.library.register_fake(f"flinkml::{name}", fakes[name],
                                        lib=lib)
        _LIB = lib


# -- capture ----------------------------------------------------------------


def _fake_leaf(mode, leaf):
    if isinstance(leaf, TensorSpec):
        with mode:
            return torch.empty(leaf.shape, dtype=leaf.dtype,
                               device=leaf.device)
    if isinstance(leaf, np.ndarray):
        leaf = torch.from_numpy(np.ascontiguousarray(leaf))
    if isinstance(leaf, torch.Tensor):
        from torch._subclasses.fake_tensor import FakeTensor

        if isinstance(leaf, FakeTensor):
            return leaf
        return mode.from_tensor(leaf)
    return leaf


def fake_args(args):
    """``args`` with every tensor leaf (tensor, numpy array,
    :class:`TensorSpec`) made a fake tensor of one new mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    return tree_map(lambda leaf: _fake_leaf(mode, leaf), args,
                    is_leaf=lambda x: isinstance(x, TensorSpec))


class capturing:
    """Set this thread's capture flag for a block (the kernel wrappers
    call their ``flinkml`` ops)."""

    def __enter__(self):
        from flinkml_tpu_torch.kernels import _gate

        register_ops()
        self._gate = _gate
        self._prev = _gate.CAPTURE.on
        _gate.CAPTURE.on = True
        return self

    def __exit__(self, *exc):
        self._gate.CAPTURE.on = self._prev
        return False


def capture(fn, *example_args) -> torch.fx.GraphModule:
    """The graph of ``fn(*example_args)``: ``make_fx`` over fake tensors,
    not functionalized, with the port's kernel and collective sites as
    ``flinkml`` nodes (module docstring)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    args = fake_args(example_args)
    with capturing():
        return make_fx(fn, tracing_mode="fake",
                       _allow_non_fake_inputs=True)(*args)


# -- reading a graph --------------------------------------------------------


def leaf_paths(args) -> List[str]:
    """Per flattened leaf of ``args`` (the order of the graph's
    placeholders): its path as the JAX package names one (``coef``,
    ``emb/embedding``, ``0/1``)."""
    from torch.utils._pytree import tree_flatten_with_path

    out = []
    for i, arg in enumerate(args):
        leaves, _ = tree_flatten_with_path(
            arg, is_leaf=lambda x: isinstance(x, TensorSpec))
        for path, _leaf in leaves:
            parts = []
            for k in path:
                for attr in ("key", "name", "idx"):
                    if hasattr(k, attr):
                        parts.append(str(getattr(k, attr)))
                        break
                else:
                    parts.append(str(k))
            out.append("/".join(parts) or f"arg{i}")
    return out


def leaf_counts(args) -> List[int]:
    """Number of flattened leaves of each argument."""
    from torch.utils._pytree import tree_leaves

    return [len(tree_leaves(a, is_leaf=lambda x: isinstance(x, TensorSpec)))
            for a in args]


def placeholders(gm) -> list:
    return [n for n in gm.graph.nodes if n.op == "placeholder"]


def val(node):
    """The fake value of a node (a tensor, a tuple or list of them, or a
    Python value)."""
    return node.meta.get("val")


def is_tensor(v) -> bool:
    return isinstance(v, torch.Tensor)


def op_name(node) -> Tuple[str, str]:
    """``(namespace, name)`` of a ``call_function`` node: ``("aten",
    "sub_")``, ``("flinkml", "segment_sum")``; ``("", "getitem")`` for a
    tuple read."""
    t = node.target
    if t is operator.getitem:
        return "", "getitem"
    ns = getattr(t, "namespace", "")
    name = getattr(t, "_opname", None) or getattr(t, "__name__", str(t))
    return ns, name


def alias_of(node) -> Optional[Tuple[Any, bool]]:
    """``(argument node, written)`` when the node's (first) output aliases
    one of its arguments: a view (``written`` False) or an in-place or
    ``out=`` update (``written`` True); None for a new buffer."""
    if node.op != "call_function":
        return None
    if node.target is operator.getitem:
        return None
    schema = getattr(node.target, "_schema", None)
    if schema is None or not schema.returns:
        return None
    ret = schema.returns[0].alias_info
    if ret is None:
        return None
    sets = set(ret.before_set)
    for i, arg in enumerate(schema.arguments):
        info = arg.alias_info
        if info is None or not (set(info.before_set) & sets):
            continue
        if arg.kwarg_only:
            value = node.kwargs.get(arg.name)
        else:
            value = node.args[i] if i < len(node.args) else None
        if isinstance(value, torch.fx.Node):
            return value, bool(info.is_write)
    return None


def tensor_inputs(node) -> List[Any]:
    """The node arguments (flattened through lists and kwargs) that are
    graph nodes."""
    out: List[Any] = []

    def walk(a):
        if isinstance(a, torch.fx.Node):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            for x in a:
                walk(x)
        elif isinstance(a, dict):
            for x in a.values():
                walk(x)

    walk(node.args)
    walk(node.kwargs)
    return out


def output_nodes(gm) -> List[Any]:
    """The graph nodes the program returns (flattened)."""
    return next(tensor_inputs(n) for n in gm.graph.nodes if n.op == "output")


def nodes_named(gm, name: str, namespace: str = "flinkml") -> list:
    """Every ``call_function`` node of ``namespace::name``."""
    return [n for n in gm.graph.nodes if n.op == "call_function"
            and op_name(n) == (namespace, name)]


def arg(node, index: int, name: str, default=None):
    """A call's argument by position or keyword."""
    if index < len(node.args):
        return node.args[index]
    return node.kwargs.get(name, default)


def leaf_roles(example_args: Sequence, param_argnums: Sequence[int],
               n_placeholders: int) -> Tuple[List[str], List[str]]:
    """``(roles, names)`` per placeholder: ``"param"`` for the leaves of
    the arguments at ``param_argnums``, else ``"data"``; unlabeled (all
    data, ``argN``) when the flattening does not line up."""
    counts = leaf_counts(example_args)
    if sum(counts) != n_placeholders:
        return (["data"] * n_placeholders,
                [f"arg{i}" for i in range(n_placeholders)])
    params = set(param_argnums)
    roles = [("param" if i in params else "data")
             for i, c in enumerate(counts) for _ in range(c)]
    return roles, leaf_paths(example_args)


def leaf_indices(example_args: Sequence, argnums: Sequence[int]) -> List[int]:
    """Placeholder indices of the leaves of the arguments at
    ``argnums``."""
    counts = leaf_counts(example_args)
    wanted = set(argnums)
    out, idx = [], 0
    for i, c in enumerate(counts):
        if i in wanted:
            out.extend(range(idx, idx + c))
        idx += c
    return out
