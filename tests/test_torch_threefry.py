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

The float64 ``normal`` carries XLA's float64 ``erf_inv`` (Giles'
double-precision polynomials) and ``log1p`` (a Cephes rational) with their
fused multiply-adds, and PyTorch's ``log`` above ``sqrt(2) - 1`` only:
over 900,000 draws (three seeds) 28 differ from JAX's, by at most 3 ulps.
``gamma`` (Marsaglia–Tsang, ``a >= 1``) equals JAX's bit for bit at LDA's
``a = 100``; over 1.5 M draws at ``a`` in {1, 1.5, 2.5, 10, 100} (three
seeds) 6 differ, by at most 10 ulps, and no accept/reject decision flips
(a flip would change a draw wholly). The tests bound those gaps.
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
NORMAL64_MAX_ULPS = 3
GAMMA_MAX_ULPS = 10


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


def _ulps64(want, got) -> np.ndarray:
    return np.abs(np.asarray(want).view(np.int64)
                  - np.asarray(got).view(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_float64_within_ulps(seed):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (50000,),
                                        jnp.float64))
    got = tf.normal(tf.PRNGKey(seed, "cpu"), (50000,), torch.float64).numpy()
    assert got.dtype == np.float64
    ulps = _ulps64(want, got)
    assert ulps.max() <= NORMAL64_MAX_ULPS
    assert (ulps == 0).mean() > 0.999


def test_erf_inv_float64_matches_xla():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1, 1, 4000),
                        1 - 10.0 ** -rng.uniform(0, 15, 2000),
                        -1 + 10.0 ** -rng.uniform(0, 15, 2000),
                        [-1.0, 1.0, 0.0]])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = tf.erf_inv(torch.from_numpy(x)).numpy()
    assert np.isinf(got[-3]) and got[-3] < 0 and np.isinf(got[-2])
    assert got[-1] == 0.0
    ulps = _ulps64(want[:-3], got[:-3])
    # Only PyTorch's log in log1p's upper branch (w >= ~0.35) is not XLA's.
    assert (ulps == 0).mean() > 0.99
    np.testing.assert_allclose(got[:-3], want[:-3], rtol=1e-13)


def test_erf_inv_float64_planted_fault_is_caught():
    """A Horner step without the fused multiply-add breaks the bit
    equality the test above holds."""
    x = torch.from_numpy(np.random.default_rng(1).uniform(-0.99, 0.99, 4000))
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    fused = tf._fma64
    try:
        tf._fma64 = lambda a, b, c: a * b + c
        got = tf.erf_inv(x).numpy()
    finally:
        tf._fma64 = fused
    assert (_ulps64(want, got) == 0).mean() < 0.99


@pytest.mark.parametrize("seed", SEEDS[:2])
@pytest.mark.parametrize("a,shape", [(100.0, (40, 50)), (100.0, (3000,)),
                                     (1.0, (3000,)), (2.5, (3000,))])
def test_gamma_matches_jax(seed, a, shape):
    want = np.asarray(jax.random.gamma(jax.random.PRNGKey(seed), a, shape))
    got = tf.gamma(tf.PRNGKey(seed, "cpu"), a, shape).numpy()
    assert got.dtype == np.float64 and got.shape == shape
    ulps = _ulps64(want, got)
    # No flipped decision: a flip would give a wholly different draw.
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert ulps.max() <= GAMMA_MAX_ULPS
    if a == 100.0:  # LDA's draws: bit for bit
        assert ulps.max() == 0


def test_gamma_over_a_batch_of_keys():
    keys = tf.split(tf.PRNGKey(3, "cpu"), 4)
    rows = tf.gamma(keys, 100.0, (5,)).numpy()
    scalars = tf.gamma(keys, 100.0).numpy()
    assert rows.shape == (4, 5) and scalars.shape == (4,)
    jkeys = jax.random.split(jax.random.PRNGKey(3), 4)
    for i in range(4):
        assert rows[i].tobytes() == tf.gamma(keys[i], 100.0, (5,)).numpy() \
            .tobytes()
        want = np.asarray(jax.random.gamma(jkeys[i], 100.0, ()))
        assert scalars[i] == want


def test_gamma_planted_fault_is_caught():
    """Another key, or multiply-adds rounded twice (XLA fuses them),
    breaks the bounds the tests above hold."""
    want = np.asarray(jax.random.gamma(jax.random.PRNGKey(0), 1.0, (3000,)))
    other = tf.gamma(tf.PRNGKey(1, "cpu"), 1.0, (3000,)).numpy()
    assert not np.allclose(other, want, rtol=1e-12)
    fused = tf._fma64
    try:
        tf._fma64 = lambda a, b, c: a * b + c
        got = tf.gamma(tf.PRNGKey(0, "cpu"), 1.0, (3000,)).numpy()
    finally:
        tf._fma64 = fused
    assert _ulps64(want, got).max() > GAMMA_MAX_ULPS


@pytest.mark.parametrize("a", (0.5, 0.99, float("nan")))
def test_gamma_refuses_the_boosted_branch(a):
    with pytest.raises(tf.UnsupportedDrawError):
        tf.gamma(tf.PRNGKey(0, "cpu"), a, (3,))
