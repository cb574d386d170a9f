"""The port's ring and Ulysses attention (``flinkml_tpu_torch.parallel.
ring``) against the JAX package's, on the CPU.

The cases of ``tests/test_ring_attention.py``, on P = 2 and 4 gloo ranks
(``tests/_torch_mesh_worker.py ring``, the rank body ``tests/
_torch_recsys_cases.py::ring_cases``) and on a JAX mesh of P CPU devices,
from the same numpy inputs: every rank's output is the same bits, within
the JAX tests' tolerance (rtol 2e-4, atol 2e-5) of the JAX package's
sharded attention and of its single-device full-softmax reference; the
refusals carry the JAX package's messages. One process (no group) takes
the full-attention path, as the JAX package does on one device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flinkml_tpu.parallel import DeviceMesh as JMesh
from flinkml_tpu.parallel.ring import _full_attention as jax_full
from flinkml_tpu.parallel.ring import ring_attention as jax_ring
from flinkml_tpu.parallel.ring import ulysses_attention as jax_ulysses
from flinkml_tpu_torch.device import use_device
from flinkml_tpu_torch.parallel import DeviceMesh
from flinkml_tpu_torch.parallel import ring as tring
from tests import _torch_recsys_cases as cases
from tests.test_torch_tensor_parallel import launch, same_on_every_rank

WORLDS = (2, 4)
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda p: f"P{p}")
def ranks(request, tmp_path_factory):
    world = request.param
    return world, launch("ring", world,
                         str(tmp_path_factory.mktemp(f"ring{world}")))


def _reference(q, k, v, causal):
    return np.asarray(jax_full(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal))


def _jmesh(p, name="data"):
    return JMesh({name: p}, jax.devices()[:p])


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_matches_full(ranks, kind, causal):
    p, outs = ranks
    got = same_on_every_rank(outs, f"{kind}_{causal}")
    q, k, v = cases.qkv()
    fn = jax_ring if kind == "ring" else jax_ulysses
    want = np.asarray(fn(q, k, v, _jmesh(p), causal=causal))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _reference(q, k, v, causal), **TOL)


def test_ring_attention_long_sequence_many_blocks(ranks):
    p, outs = ranks
    got = same_on_every_rank(outs, "ring_long")
    q, k, v = cases.qkv(b=1, h=2, l=128, d=8, seed=3)
    np.testing.assert_allclose(got, _reference(q, k, v, True), **TOL)


def test_rejections(ranks):
    _, outs = ranks
    assert "divisible by the mesh" in str(outs[0]["err_heads"])
    assert "must divide by mesh size" in str(outs[0]["err_seq"])
    assert "batch, heads, seq" in str(outs[0]["err_rank"])


def test_causal_first_token_attends_only_itself(ranks):
    _, outs = ranks
    got = same_on_every_rank(outs, "ring_first_token")
    _, _, v = cases.qkv(b=1, h=1, l=64, d=4, seed=9)
    np.testing.assert_allclose(got[0, 0, 0], v[0, 0, 0], rtol=1e-5,
                               atol=1e-6)


def test_custom_axis_name_mesh(ranks):
    """The shard axis is the mesh's first axis, whatever its name."""
    p, outs = ranks
    q, k, v = cases.qkv(b=1, h=8, l=64, d=8, seed=4)
    np.testing.assert_allclose(same_on_every_rank(outs, "ring_seq_axis"),
                               _reference(q, k, v, True), **TOL)
    np.testing.assert_allclose(
        same_on_every_rank(outs, "ulysses_seq_axis"),
        np.asarray(jax_ulysses(q, k, v, _jmesh(p, "seq"), causal=False)),
        **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_one_rank_is_full_attention(causal):
    """Without a process group the mesh has one rank: both entry points
    are the plain full softmax, as JAX's one-device path."""
    q, k, v = cases.qkv(seed=5)
    with use_device("cpu"):
        mesh = DeviceMesh()
        ring = tring.ring_attention(q, k, v, mesh, causal=causal)
        uly = tring.ulysses_attention(q, k, v, mesh, causal=causal)
    assert isinstance(ring, torch.Tensor)
    want = np.asarray(jax_ring(q, k, v, _jmesh(1), causal=causal))
    np.testing.assert_allclose(ring.numpy(), want, **TOL)
    np.testing.assert_allclose(uly.numpy(), want, **TOL)
