"""The port's threefry draws (``flinkml_tpu_torch.ops.threefry``) against
``jax.random``, on the CPU.

``jax.random`` here runs threefry2x32 with ``jax_threefry_partitionable``
on (this JAX's default) and ``jax_enable_x64`` on (the conftest's), the
configuration the JAX trainers' draws are compared in. ``PRNGKey``,
``fold_in`` (one step and a vectorised block), ``split``, ``randint``
(int32 and int64, the spans the trainers use), ``uniform`` (float32 and
float64), ``poisson`` (Knuth's branch) and ``permutation`` equal JAX's
bit for bit. ``normal`` carries XLA's float32 ``erf_inv`` polynomial (with
XLA's fused multiply-adds) but PyTorch's ``log1p`` and ``sqrt``: over
600,000 draws (three seeds) at most 3 ulps part it from JAX's, on about 1%
of the draws; the test bounds the gap at those 3 ulps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flinkml_tpu_torch.ops import threefry as tf

SEEDS = (0, 7, 123456789)
SPANS = (1, 7, 1000, 2**18, 2**31 - 1)
SHAPES = ((13,), (4, 6))
NORMAL_MAX_ULPS = 3


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS + (2**40 + 3,))
def test_prng_key(seed):
    assert (_words(jax.random.PRNGKey(seed))
            == tf.PRNGKey(seed, "cpu").numpy()).all()


def test_fold_in_known_value():
    assert tf.fold_in(tf.PRNGKey(0, "cpu"), 3).tolist() == \
        [2467461003, 3840466878]


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_split(seed):
    jk, pk = jax.random.PRNGKey(seed), tf.PRNGKey(seed, "cpu")
    for d in (0, 1, 5, 123, 2**31 + 5, 2**32 - 1):
        assert (_words(jax.random.fold_in(jk, d))
                == tf.fold_in(pk, d).numpy()).all(), d
    for num in (2, 5):
        assert (_words(jax.random.split(jk, num))
                == tf.split(pk, num).numpy()).all()
    # A chain: fold_in, then split, then split the second half again.
    k = jax.random.split(jax.random.split(jax.random.fold_in(jk, 9))[1])
    p = tf.split(tf.split(tf.fold_in(pk, 9))[1])
    assert (_words(k) == p.numpy()).all()


def test_vectorised_fold_in_matches_per_step():
    base_j, base_p = jax.random.PRNGKey(3), tf.PRNGKey(3, "cpu")
    steps = torch.arange(40, 72)
    keys = tf.fold_in(base_p, steps)
    assert tuple(keys.shape) == (32, 2)
    draws = tf.randint(keys, (6,), 0, 77)
    for i, s in enumerate(steps.tolist()):
        jkey = jax.random.fold_in(base_j, s)
        assert (_words(jkey) == keys[i].numpy()).all()
        assert (np.asarray(jax.random.randint(jkey, (6,), 0, 77))
                == draws[i].numpy()).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("shape", SHAPES, ids=("n", "n_k"))
@pytest.mark.parametrize("dtype", ("int32", "int64"))
def test_randint(seed, span, shape, dtype):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0,
                                         span, dtype=jd))
    got = tf.randint(tf.PRNGKey(seed, "cpu"), shape, 0, span, dtype=td)
    assert got.dtype == td
    assert (want == got.numpy()).all()


@pytest.mark.parametrize("dtype", ("int32", "int64"))
def test_randint_offsets_and_empty_span(dtype):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jk, pk = jax.random.PRNGKey(11), tf.PRNGKey(11, "cpu")
    for lo, hi in ((-5, 17), (5, 5), (9, 2)):
        want = np.asarray(jax.random.randint(jk, (9,), lo, hi, dtype=jd))
        assert (want == tf.randint(pk, (9,), lo, hi, dtype=td).numpy()).all()


def test_randint_int32_full_range():
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (64,),
                                         -2**31, 2**31, dtype=jnp.int32))
    got = tf.randint(tf.PRNGKey(2, "cpu"), (64,), -2**31, 2**31,
                     dtype=torch.int32)
    assert (want == got.numpy()).all()


def test_randint_default_dtype_is_x64_int():
    """The trainers' calls name no dtype: JAX's ``int`` under x64."""
    want = jax.random.randint(jax.random.PRNGKey(0), (5,), 0, 1000)
    assert want.dtype == jnp.int64
    got = tf.randint(tf.PRNGKey(0, "cpu"), (5,), 0, 1000)
    assert got.dtype == torch.int64
    assert (np.asarray(want) == got.numpy()).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bit_for_bit(seed):
    jk, pk = jax.random.PRNGKey(seed), tf.PRNGKey(seed, "cpu")
    want = np.asarray(jax.random.uniform(jk, (1000,), jnp.float32))
    assert want.view(np.int32).tolist() == \
        tf.uniform(pk, (1000,)).numpy().view(np.int32).tolist()
    want = np.asarray(jax.random.uniform(jk, (7, 9), jnp.float32, -2.0, 3.0))
    got = tf.uniform(pk, (7, 9), -2.0, 3.0).numpy()
    assert (want.view(np.int32) == got.view(np.int32)).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_ulps(seed):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (200000,),
                                        jnp.float32))
    got = tf.normal(tf.PRNGKey(seed, "cpu"), (200000,)).numpy()
    assert got.dtype == np.float32
    ulps = np.abs(want.view(np.int32).astype(np.int64)
                  - got.view(np.int32).astype(np.int64))
    assert ulps.max() <= NORMAL_MAX_ULPS
    assert (ulps == 0).mean() > 0.98
    # Keys batched in front: each row is its own key's draw.
    keys = tf.split(tf.PRNGKey(seed, "cpu"), 3)
    rows = tf.normal(keys, (4, 5)).numpy()
    for i in range(3):
        one = tf.normal(keys[i], (4, 5)).numpy()
        assert rows[i].tobytes() == one.tobytes()


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999], dtype=torch.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    got = tf.erf_inv(x).numpy()
    assert np.isinf(got[0]) and got[0] < 0 and np.isinf(got[1])
    np.testing.assert_allclose(got[2:], want[2:], rtol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", ((1000,), (7, 9)))
def test_uniform_float64_bit_for_bit(seed, shape):
    """JAX's default dtype under x64, the boosted forests' row mask."""
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    assert want.dtype == np.float64
    got = tf.uniform(tf.PRNGKey(seed, "cpu"), shape, dtype=torch.float64)
    assert got.dtype == torch.float64
    assert (want.view(np.int64) == got.numpy().view(np.int64)).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lam", (1.0, 0.5, 0.37, 1e-3, 0.0, 9.5))
def test_poisson_knuth_bit_for_bit(seed, lam):
    want = np.asarray(jax.random.poisson(jax.random.PRNGKey(seed), lam,
                                         (50_000,)))
    got = tf.poisson(tf.PRNGKey(seed, "cpu"), lam, (50_000,))
    assert want.dtype == np.int64 and got.dtype == torch.int64
    assert (want == got.numpy()).all()
    want = np.asarray(jax.random.poisson(jax.random.PRNGKey(seed), lam,
                                         (6, 11)))
    assert (want == tf.poisson(tf.PRNGKey(seed, "cpu"), lam,
                               (6, 11)).numpy()).all()


@pytest.mark.parametrize("lam", (10.0, 25.0, float("nan")))
def test_poisson_refuses_the_rejection_branch(lam):
    with pytest.raises(tf.UnsupportedDrawError):
        tf.poisson(tf.PRNGKey(0, "cpu"), lam, (4,))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", (1, 2, 5, 16, 123, 2000))
def test_permutation_bit_for_bit(seed, n):
    """``n`` up to 2000 runs two sorting rounds (1626 and above)."""
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
    got = tf.permutation(tf.PRNGKey(seed, "cpu"), n)
    assert got.dtype == torch.int64
    assert want.tolist() == got.tolist()
