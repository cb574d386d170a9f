"""The program capture of the port's analysis passes (``analysis/_capture``).

- a capture of each kernel wrapper and collective shows its ``flinkml``
  node with its arguments, and the fake value of the node has the shape
  and dtype of the plain version's result;
- outside a capture the wrappers reach their plain versions on the CPU
  with no op and no dispatcher hop; the flag is this thread's and is
  cleared after a capture, even one that raises;
- the capture is not functionalized (an in-place update stays one node
  whose output aliases its argument) and runs device-free on specs;
- a captured graph runs: the ops' CPU implementations are the wrappers;
- the package surface: ``flinkml_tpu_torch.analysis`` exports the JAX
  package's analysis names, letter for letter.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import flinkml_tpu_torch as fml
from flinkml_tpu_torch.analysis import _capture
from flinkml_tpu_torch.analysis._capture import (
    alias_of,
    capture,
    nodes_named,
    op_name,
    spec,
    val,
)
from flinkml_tpu_torch.kernels import _gate
from flinkml_tpu_torch.kernels.segsum import segment_sum, segment_sum_plain
from flinkml_tpu_torch.kernels.spmv import spmv, spmv_plain
from flinkml_tpu_torch.kernels.topk import top_k, top_k_plain
from flinkml_tpu_torch.parallel import collectives as coll

from tests._torch_threads import cap_torch_threads

cap_torch_threads()


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.normal(size=64))
    ids = torch.from_numpy(np.sort(rng.integers(0, 16, 64)).astype(np.int32))
    ib = torch.from_numpy(rng.integers(0, 32, (8, 4)).astype(np.int32))
    vb = torch.from_numpy(rng.normal(size=(8, 4)))
    w = torch.from_numpy(rng.normal(size=32))
    return v, ids, ib, vb, w


@pytest.mark.parametrize("sorted_flag", [True, False])
def test_capture_shows_each_kernel_node(sorted_flag):
    v, ids, ib, vb, w = _inputs()

    def f(v, ids, ib, vb, w):
        s = segment_sum(v, ids, 16, indices_are_sorted=sorted_flag)
        m = spmv(ib, vb, w)
        values, idx = top_k(m, 3)
        return s, m, values, idx

    gm = capture(f, v, ids, ib, vb, w)
    (seg,) = nodes_named(gm, "segment_sum")
    assert seg.args[2:] == (16, sorted_flag)
    assert len(nodes_named(gm, "spmv")) == 1
    assert len(nodes_named(gm, "topk")) == 1
    # No aten op stands in for a kernel site.
    assert not [n for n in gm.graph.nodes if n.op == "call_function"
                and op_name(n) in (("aten", "index_add"),
                                   ("aten", "index_add_"), ("aten", "topk"))]
    want = (segment_sum_plain(v, ids, 16), spmv_plain(ib, vb, w),
            *top_k_plain(spmv_plain(ib, vb, w), 3))
    outs = [n for n in gm.graph.nodes if n.op == "output"][0].args[0]
    for node, ref in zip(outs, want):
        assert tuple(val(node).shape) == tuple(ref.shape)
        assert val(node).dtype == ref.dtype
    # The graph runs: the ops' CPU implementations are the wrappers.
    with fml.use_device("cpu"):
        got = gm(v, ids, ib, vb, w)
    for g, ref in zip(got, want):
        assert torch.equal(g, ref)


def test_capture_shows_each_collective_node():
    with fml.use_device("cpu"):
        mesh = fml.parallel.DeviceMesh()

        def f(x):
            y = coll.psum(mesh, x, "data")
            coll.all_reduce_(mesh, y, "data")
            (b,) = coll.broadcast(mesh, [y])
            g = coll.group_all_reduce(None, (0, 1), b.clone())
            a = coll.group_all_gather(None, (0, 1), g)
            t = coll.group_all_to_all(None, (0, 1), a)
            (p,) = coll.ppermute(None, (0, 1), [t])
            return p

        gm = capture(f, torch.ones(4))
        names = [op_name(n) for n in gm.graph.nodes
                 if n.op == "call_function" and op_name(n)[0] == "flinkml"]
        assert [n for _, n in names] == [
            "psum", "all_reduce_", "broadcast", "group_all_reduce",
            "group_all_gather", "group_all_to_all", "ppermute"]
        (gather,) = nodes_named(gm, "group_all_gather")
        assert gather.args[1] == "ranks=0,1"
        assert tuple(val(gather).shape) == (8,)
        (psum,) = nodes_named(gm, "psum")
        assert psum.args[1] == "data"
        # The in-place all-reduce aliases and writes its argument.
        (ar,) = nodes_named(gm, "all_reduce_")
        assert alias_of(ar) == (psum, True)
        # World 1 without a group: psum is a copy, all_reduce_ a no-op.
        out = gm(torch.arange(4.0))
    assert out.shape == (4,)


def test_outside_a_capture_no_op_and_no_dispatcher(monkeypatch):
    v, ids, ib, vb, w = _inputs(1)

    def refuse(name):
        raise AssertionError(f"op {name} reached outside a capture")

    monkeypatch.setattr(_gate, "op", refuse)
    assert not _gate.CAPTURE.on
    assert torch.equal(segment_sum(v, ids, 16, indices_are_sorted=True),
                       segment_sum_plain(v, ids, 16))
    assert torch.equal(spmv(ib, vb, w), spmv_plain(ib, vb, w))
    got, want = top_k(v, 5), top_k_plain(v, 5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with fml.use_device("cpu"):
        mesh = fml.parallel.DeviceMesh()
        assert torch.equal(coll.psum(mesh, v, "data"), v)


def test_flag_is_cleared_after_a_failing_capture():
    def bad(x):
        raise ValueError("boom")

    with pytest.raises(ValueError):
        capture(bad, torch.ones(3))
    assert not _gate.CAPTURE.on


def test_flag_is_this_threads_only(monkeypatch):
    v, ids, *_ = _inputs(2)
    seen = {}
    real_op = _gate.op

    def op(name):
        seen.setdefault(threading.current_thread().name, []).append(name)
        return real_op(name)

    monkeypatch.setattr(_gate, "op", op)
    other = {}
    started, release = threading.Event(), threading.Event()

    def worker():
        started.wait()
        other["out"] = segment_sum(v, ids, 16)
        release.set()

    t = threading.Thread(target=worker, name="plain-caller")
    t.start()

    def f(v, ids):
        started.set()
        release.wait(30)
        return segment_sum(v, ids, 16)

    capture(f, v, ids)
    t.join()
    assert "plain-caller" not in seen
    assert torch.equal(other["out"], segment_sum_plain(v, ids, 16))


def test_capture_is_device_free_and_not_functionalized():
    def step(state, grad):
        state.sub_(grad)
        return state.T.sum()

    gm = capture(step, spec((1 << 20, 64)), spec((1 << 20, 64)))
    (sub,) = [n for n in gm.graph.nodes
              if n.op == "call_function" and op_name(n)[1] == "sub_"]
    ph = [n for n in gm.graph.nodes if n.op == "placeholder"][0]
    assert alias_of(sub) == (ph, True)
    views = [n for n in gm.graph.nodes if n.op == "call_function"
             and alias_of(n) is not None and not alias_of(n)[1]]
    assert views  # the transpose is a view of the updated state


def test_spec_and_numpy_arguments():
    gm = capture(lambda x, y: x + torch.as_tensor(y),
                 spec((3, 2), "bfloat16"), np.ones((3, 2), np.float32))
    out = [n for n in gm.graph.nodes if n.op == "output"][0].args[0]
    assert val(out).dtype == torch.float32
    assert _capture.torch_dtype(np.float64) == torch.float64


def test_package_surface_equals_jax():
    import flinkml_tpu.analysis as jax_analysis
    import flinkml_tpu_torch.analysis as port_analysis

    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), type(threading))}

    assert public(port_analysis) == public(jax_analysis)
