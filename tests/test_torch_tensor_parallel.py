"""The port's tensor, pipeline and expert parallelism
(``flinkml_tpu_torch.parallel.tensor``) against the JAX package's, on the
CPU.

The cases of ``tests/test_tensor_parallel.py``, each on P = 2 and 4 gloo
ranks (one process each, started once per P by ``spawn_ranks`` through
``tests/_torch_mesh_worker.py tensor``; the rank body is
``tests/_torch_recsys_cases.py::tensor_cases``, which imports no JAX) and
on a JAX mesh of the same shape over the conftest's CPU devices, from the
same numpy inputs. Each output is held three ways: the same bits on every
rank; the JAX package's value within its own tests' tolerance (rtol 2e-4,
atol 2e-5: XLA and PyTorch block their float32 matmuls differently); and
the numpy reference of the JAX test. The routed MoE drops exactly the JAX
package's tokens (a dropped token's output is exactly zero in both), and
the refusals carry the JAX package's messages.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flinkml_tpu.parallel import DeviceMesh as JMesh
from flinkml_tpu.parallel import tensor as jtp
from flinkml_tpu_torch.parallel.launch import spawn_ranks
from tests import _torch_recsys_cases as cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mesh_worker.py")
WORLDS = (2, 4)
LAUNCH_TIMEOUT_S = 240
TOL = dict(rtol=2e-4, atol=2e-5)


def launch(which: str, world: int, workdir: str):
    """Every rank's outputs of one launch of the worker's ``which`` mode."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    spawn_ranks([sys.executable, WORKER, which, workdir], world, workdir,
                LAUNCH_TIMEOUT_S, env=env)
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
            for r in range(world)]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda p: f"P{p}")
def ranks(request, tmp_path_factory):
    world = request.param
    return world, launch("tensor", world,
                         str(tmp_path_factory.mktemp(f"tensor{world}")))


def same_on_every_rank(outs, name) -> np.ndarray:
    first = outs[0][name]
    for r, o in enumerate(outs[1:], start=1):
        assert o[name].tobytes() == first.tobytes(), (name, r)
    return first


def jmesh(shape):
    return JMesh(shape, jax.devices()[:int(np.prod(list(shape.values())))])


def gelu(x):
    return np.asarray(jax.nn.gelu(jnp.asarray(x)))


def test_tp_mlp_matches_dense(ranks):
    p, outs = ranks
    got = same_on_every_rank(outs, "tp_mlp")
    x, w1, b1, w2, b2 = cases.mlp_inputs()
    want = jtp.tensor_parallel_mlp(x, w1, b1, w2, b2, jmesh({"model": p}))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, gelu(x @ w1 + b1) @ w2 + b2, **TOL)


def test_tp_mlp_on_2d_mesh_model_axis(ranks):
    p, outs = ranks
    got = same_on_every_rank(outs, "tp_mlp_2d")
    x, w1, b1, w2, b2 = cases.mlp_inputs(1, n=8, d_in=4, d_ff=16, d_out=4)
    want = jtp.tensor_parallel_mlp(x, w1, b1, w2, b2,
                                   jmesh({"data": 2, "model": p // 2}),
                                   axis="model")
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_tp_mlp_validates_d_ff_and_axis_name(ranks):
    _, outs = ranks
    assert "must divide by axis size" in str(outs[0]["err_d_ff"])
    assert "no axis named 'model'" in str(outs[0]["err_axis"])


def _stages(x, params, fn):
    ref = x
    for s in range(params.shape[0]):
        ref = fn(ref @ params[s])
    return ref


def test_pipeline_matches_sequential(ranks):
    p, outs = ranks
    got = same_on_every_rank(outs, "pipeline")
    x, params = cases.pipeline_inputs(p)
    want = jtp.pipeline_parallel_apply(x, params, stage="linear_tanh",
                                       mesh=jmesh({"pipe": p}))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, _stages(x, params, np.tanh), **TOL)


def test_pipeline_validates_stages_and_names(ranks):
    p, outs = ranks
    assert f"stage_params has {p + 1} stages" in str(outs[0]["err_stages"])
    assert "unknown pipeline stage 'nope'" in str(
        outs[0]["err_unknown_stage"])


def test_custom_registered_stage(ranks):
    p, outs = ranks
    got = same_on_every_rank(outs, "pipeline_custom")
    jtp.register_pipeline_stage("affine_relu",
                                lambda a, w: jnp.maximum(a @ w, 0))
    x, params = cases.pipeline_inputs(p, seed=3, n_mb=3, b=2, d=4, scale=0.4)
    want = jtp.pipeline_parallel_apply(x, params, stage="affine_relu",
                                       mesh=jmesh({"pipe": p}))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got, _stages(x, params, lambda a: np.maximum(a, 0)), **TOL)


def test_expert_parallel_matches_dense_moe(ranks):
    p, outs = ranks
    got = same_on_every_rank(outs, "expert_dense")
    x, logits, w1, w2 = cases.expert_inputs(p)
    gates = cases.softmax(logits)
    want = jtp.expert_parallel_ffn(x, gates, w1, w2, jmesh({"expert": p}))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    ref = sum(gates[:, e:e + 1] * (gelu(x @ w1[e]) @ w2[e])
              for e in range(p))
    np.testing.assert_allclose(got, ref, **TOL)


def test_expert_parallel_top1_routing(ranks):
    p, outs = ranks
    got = same_on_every_rank(outs, "expert_top1")
    x, _, w1, w2 = cases.expert_inputs(p)
    assign = np.random.default_rng(5).integers(0, p, size=x.shape[0])
    gates = np.eye(p, dtype=np.float32)[assign]
    want = jtp.expert_parallel_ffn(x, gates, w1, w2, jmesh({"expert": p}))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for i in range(x.shape[0]):
        e = assign[i]
        np.testing.assert_allclose(got[i], gelu(x[i] @ w1[e]) @ w2[e], **TOL)


def test_expert_parallel_validates_expert_count(ranks):
    _, outs = ranks
    assert "expert count mismatch" in str(outs[0]["err_expert_count"])


def test_pipeline_on_multi_axis_mesh(ranks):
    p, outs = ranks
    got = same_on_every_rank(outs, "pipeline_2d")
    x, params = cases.pipeline_inputs(p // 2, seed=6, n_mb=3, b=2, d=5)
    want = jtp.pipeline_parallel_apply(
        x, params, stage="linear_tanh",
        mesh=jmesh({"data": 2, "pipe": p // 2}), axis="pipe")
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_expert_parallel_on_multi_axis_mesh(ranks):
    p, outs = ranks
    got = same_on_every_rank(outs, "expert_2d")
    x, logits, w1, w2 = cases.expert_inputs(p // 2, seed=7, n=6, d_in=4,
                                            d_ff=8, d_out=4)
    want = jtp.expert_parallel_ffn(x, cases.softmax(logits), w1, w2,
                                   jmesh({"data": 2, "expert": p // 2}),
                                   axis="expert")
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_stage_reregistration_takes_effect(ranks):
    p, outs = ranks
    out1 = same_on_every_rank(outs, "restage_1")
    out2 = same_on_every_rank(outs, "restage_2")
    np.testing.assert_allclose(out1, np.ones((2, 2, 4)))
    np.testing.assert_allclose(out2, out1 * 2.0 ** p)


def _moe_ref(x, logits, w1, w2, n_local, p_size, capacity):
    """Per-rank top-1 routed reference with capacity dropping (the JAX
    test's)."""
    probs = cases.softmax(logits)
    expert = probs.argmax(-1)
    gate = probs.max(-1)
    out = np.zeros((x.shape[0], w2.shape[2]), np.float32)
    for dev in range(p_size):
        counts = np.zeros(logits.shape[1], np.int64)
        for i in range(dev * n_local, (dev + 1) * n_local):
            e = expert[i]
            if counts[e] < capacity:
                out[i] = gate[i] * (gelu(x[i] @ w1[e]) @ w2[e])
            counts[e] += 1
    return out


def test_routed_expert_matches_reference_with_drops(ranks):
    """capacity_factor 0.5 forces drops: the port drops the JAX package's
    tokens (their rows are exactly zero in both)."""
    p, outs = ranks
    got = same_on_every_rank(outs, "routed_drops")
    x, logits, w1, w2 = cases.routed_inputs(p)
    want = np.asarray(jtp.routed_expert_ffn(
        x, logits, w1, w2, jmesh({"expert": p}), capacity_factor=0.5))
    n_local = x.shape[0] // p
    capacity = max(1, int(np.ceil(n_local * 0.5 / p)))
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (got == 0).all(axis=1).any()  # some token really dropped
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got, _moe_ref(x, logits, w1, w2, n_local, p, capacity), **TOL)


def test_routed_expert_no_drops_matches_dense_top1(ranks):
    p, outs = ranks
    got = same_on_every_rank(outs, "routed_no_drops")
    dense = same_on_every_rank(outs, "routed_dense_top1")
    np.testing.assert_allclose(got, dense, **TOL)
    x, logits, w1, w2 = cases.routed_inputs(p)
    want = jtp.routed_expert_ffn(x, logits, w1, w2, jmesh({"expert": p}),
                                 capacity_factor=100.0)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_routed_expert_validates(ranks):
    _, outs = ranks
    assert "expert count mismatch" in str(outs[0]["err_routed"])


def test_routed_expert_bf16_many_tokens_unique_slots(ranks):
    """Slot bookkeeping counts in int64 whatever the data type: 320
    bfloat16 tokens a rank all routed to expert 0 keep their own slots
    (a bfloat16 count would collide past 256)."""
    p, outs = ranks
    got = same_on_every_rank(outs, "routed_bf16")
    x, logits, w1, w2 = cases.routed_bf16_inputs(p)
    want = np.asarray(jtp.routed_expert_ffn(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(logits, jnp.bfloat16),
        jnp.asarray(w1, jnp.bfloat16), jnp.asarray(w2, jnp.bfloat16),
        jmesh({"expert": p}), capacity_factor=float(p)), np.float32)
    ref = gelu(x @ w1[0]) @ w2[0]
    # bfloat16 compute: loose tolerance, but collisions give O(1) errors.
    assert np.abs(got - ref).max() < 0.15, np.abs(got - ref).max()
    assert np.abs(got - want).max() < 0.15, np.abs(got - want).max()
