"""Threefry-2x32 counter-based random numbers: the draws of ``jax.random``.

The port's counterpart of the ``jax.random`` calls its Adam, MLP, FM and
Word2Vec trainers make (``PRNGKey``, ``fold_in``, ``split``, ``randint``,
``uniform``, ``normal``) and the forests make (float64 ``uniform``,
``poisson`` below a rate of 10, ``permutation``), with the bit layout of
``jax_threefry_partitionable=True``: a draw of shape ``s`` runs the
Threefry-2x32 block cipher once per element, on the counter pair (high and
low 32 bits of the element's row-major index), and a 32-bit draw is the
XOR of the two output words. The integer draws and ``uniform`` equal
JAX's bit for bit (``uniform``'s scaling is one fused multiply-add, as XLA
contracts it on the CPU); ``normal`` goes through XLA's float32 ``erf_inv``
polynomial (Giles), and its ``log1p`` and ``sqrt`` are PyTorch's, so a
normal draw may differ from JAX's in the last bits (the tests bound the gap
in ulps).

Keys are explicit tensors, as in JAX and as PyTorch's explicit generators:
a key is an int64 tensor ``[..., 2]`` holding two uint32 words, and
nothing is global. Every function takes a batch of keys in the leading
dimensions, so a trainer draws a whole block of steps at once:
``fold_in(key, torch.arange(s0, s1))`` gives the block's step keys and
``randint(step_keys, (bs,), 0, n)`` their indices, ``[s1 - s0, bs]``.

uint32 arithmetic is emulated on int64 tensors masked to 32 bits (PyTorch
has no uint32 arithmetic on the card); products split one factor into 16-bit
halves so that no intermediate leaves int64.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

#: XLA's float32 ``erf_inv`` coefficients (Giles, "Approximating the erfinv
#: function"), for ``w < 5`` and ``w >= 5``, highest power first.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)

IntLike = Union[int, torch.Tensor]


def _device(device):
    if device is not None:
        return torch.device(device)
    from flinkml_tpu_torch.device import default_device

    return default_device()


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 ``[2]`` tensor: the high
    and low 32 bits of the 64-bit seed (the conversion JAX makes with
    ``jax_enable_x64``; a seed in ``[0, 2**32)`` gives ``[0, seed]`` in
    either mode)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return torch.tensor([seed >> 32, seed & MASK], dtype=torch.int64,
                        device=_device(device))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds) on broadcastable int64
    tensors of uint32 words: JAX's ``threefry2x32_p``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [(x0 + ks[0]) & MASK, (x1 + ks[1]) & MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x[0], x[1]


def _words(key: torch.Tensor, extra_dims: int):
    """The key's two words, each with ``extra_dims`` trailing unit dims
    (to broadcast a batch of keys against a draw's shape)."""
    shape = tuple(key.shape[:-1]) + (1,) * extra_dims
    return key[..., 0].reshape(shape), key[..., 1].reshape(shape)


def _counters(shape: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iota_2x32_shape``: the high and low words of each element's
    row-major index."""
    n = int(np.prod(shape)) if len(shape) else 1
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))
    return idx >> 32, idx & MASK


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in``: the cipher of the counter ``[0, data]``
    (``data`` taken modulo 2**32) under ``key``. ``data`` may be an int or
    an integer tensor; the result broadcasts ``key [..., 2]`` against it,
    so ``fold_in(key, torch.arange(s))`` gives ``s`` step keys in one
    call."""
    if not torch.is_tensor(data):
        data = torch.tensor(int(data), dtype=torch.int64, device=key.device)
    data = data.to(device=key.device, dtype=torch.int64) & MASK
    k0, k1 = key[..., 0], key[..., 1]
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[..., num, 2]`` (the
    partitionable fold-like split: the cipher of counters ``0..num-1``)."""
    k0, k1 = _words(key, 1)
    hi, lo = _counters((num,), key.device)
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element, ``[..., *shape]`` (int64 holding
    uint32): the XOR of the cipher's two words on each element's
    counter."""
    shape = tuple(int(s) for s in shape)
    k0, k1 = _words(key, len(shape))
    hi, lo = _counters(shape, key.device)
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return y0 ^ y1


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2**32`` for uint32 words, without leaving int64."""
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & MASK


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int, dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype)``:
    ``[..., *shape]``. The span reduction is JAX's: two draws ``hi``,
    ``lo`` of the dtype's width (one under each half of ``split(key)``)
    and ``(hi % span · (2**w % span) + lo % span) % span`` in unsigned
    arithmetic. ``maxval <= minval`` returns ``minval``.

    ``dtype`` is int64 by default, the ``int`` of JAX with
    ``jax_enable_x64`` (the trainers' ``randint`` calls name no dtype, so
    they draw int64 there and int32 without x64; the port draws as the
    former). int64 takes spans up to 2**31, which every index draw
    satisfies."""
    if dtype not in (torch.int32, torch.int64):
        raise TypeError(f"randint draws int32 or int64, got {dtype}")
    lo_d, hi_d = ((-2**31, 2**31 - 1) if dtype == torch.int32
                  else (-2**63, 2**63 - 1))
    minval = min(max(int(minval), lo_d), hi_d)
    out_of_range = int(maxval) > hi_d
    maxval = min(max(int(maxval), lo_d), hi_d)
    keys = split(key, 2)
    if maxval <= minval:
        return torch.full(tuple(key.shape[:-1]) + tuple(shape), minval,
                          dtype=dtype, device=key.device)
    if dtype == torch.int64:
        span = maxval - minval
        if span > 2**31:
            raise ValueError(f"int64 randint takes spans up to 2**31, "
                             f"got {span}")
        # Each 64-bit draw is hi·2**32 + lo of the cipher's two words.
        w32 = (1 << 32) % span
        multiplier = (w32 * w32) % span

        def rem64(k):
            k0, k1 = _words(k, len(shape))
            hi, lo = _counters(tuple(shape), key.device)
            y0, y1 = threefry2x32(k0, k1, hi, lo)
            return torch.remainder(
                torch.remainder(y0, span) * w32 + torch.remainder(y1, span),
                span)

        offset = torch.remainder(
            rem64(keys[..., 0, :]) * multiplier + rem64(keys[..., 1, :]),
            span)
        return offset + minval
    span = (maxval - minval) & MASK
    if out_of_range:
        span = (span + 1) & MASK
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    if span == 0:  # the full 2**32 range: the remainders are the bits
        offset = lower
    else:
        multiplier = (1 << 16) % span
        multiplier = ((multiplier * multiplier) & MASK) % span
        offset = (_mul32(torch.remainder(higher, span),
                         torch.full_like(higher, multiplier))
                  + torch.remainder(lower, span)) & MASK
        offset = torch.remainder(offset, span)
    out = (offset + minval) & MASK
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.uniform``: the top mantissa bits of a draw as the
    mantissa of a float in ``[1, 2)``, minus 1, scaled to ``[minval,
    maxval)`` and clamped below at ``minval``.

    float32 (the default) takes the top 23 of 32 bits, and its scaling is
    XLA's one fused multiply-add. float64 (JAX's default dtype under
    ``jax_enable_x64``) takes the top 52 of the 64 bits ``hi·2**32 + lo``
    of the cipher's two words; its scaling is a float64 multiply and add,
    so it equals JAX's bit for bit on ``[0, 1)`` (the forests' draw),
    where both are exact."""
    if dtype == torch.float64:
        shape = tuple(int(s) for s in shape)
        k0, k1 = _words(key, len(shape))
        hi, lo = _counters(shape, key.device)
        y0, y1 = threefry2x32(k0, k1, hi, lo)
        # (hi·2**32 + lo) >> 12 without leaving the positive int64 range.
        bits = (y0 << 20) | (y1 >> 12) | 0x3FF0000000000000
        floats = bits.view(torch.float64) - 1.0
        lo_t = torch.tensor(minval, dtype=torch.float64, device=key.device)
        hi_t = torch.tensor(maxval, dtype=torch.float64, device=key.device)
        return torch.maximum(lo_t, floats * (hi_t - lo_t) + lo_t)
    if dtype != torch.float32:
        raise TypeError(f"uniform draws float32 or float64, got {dtype}")
    bits = random_bits(key, shape)
    floats = (((bits >> 9) | 0x3F800000).to(torch.int32)
              .view(torch.float32) - 1.0)
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


class UnsupportedDrawError(NotImplementedError):
    """A draw the port does not make: ``poisson`` with ``lam >= 10`` (JAX's
    transformed-rejection branch) or a NaN rate."""


#: JAX's switch from Knuth's algorithm to transformed rejection.
POISSON_KNUTH_LIMIT = 10.0


def poisson(key: torch.Tensor, lam: float, shape: Sequence[int],
            dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """``jax.random.poisson(key, lam, shape)`` for a scalar rate below 10:
    Knuth's algorithm as ``jax._src.random._poisson_knuth`` runs it. ``lam``
    is rounded to float32; each round splits the key once (the first half
    carries on, the second draws), counts every element whose running
    ``log_prod`` is still above ``-lam``, then adds the ``log`` of one
    float32 ``uniform`` over the whole shape; the rounds stop when no
    element is above. The draw is the count less one, ``dtype`` (int64:
    JAX's ``int`` under x64); ``lam == 0`` gives zeros.

    The rejection branch (``lam >= 10``) raises
    :class:`UnsupportedDrawError`: the forests' rates (``subsample``) lie
    in (0, 1]."""
    lam32 = float(np.float32(lam))
    if not lam32 < POISSON_KNUTH_LIMIT:
        raise UnsupportedDrawError(
            f"poisson takes rates below {POISSON_KNUTH_LIMIT} (Knuth's "
            f"branch), got {lam!r}")
    if lam32 < 0:
        raise ValueError(f"poisson rate must be >= 0, got {lam!r}")
    shape = tuple(int(s) for s in shape)
    if lam32 == 0.0:
        return torch.zeros(shape, dtype=dtype, device=key.device)
    neg = torch.tensor(-lam32, dtype=torch.float32, device=key.device)
    k = torch.zeros(shape, dtype=torch.int64, device=key.device)
    log_prod = torch.zeros(shape, dtype=torch.float32, device=key.device)
    rng = key
    while True:
        live = log_prod > neg
        if not bool(live.any()):
            break
        keys = split(rng)
        rng, sub = keys[0], keys[1]
        k = k + live.to(torch.int64)
        log_prod = log_prod + torch.log(uniform(sub, shape))
    return (k - 1).to(dtype)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``, JAX's ``_shuffle`` of
    ``arange(n)`` (int64): ``ceil(3 ln n / ln(2**32 - 1))`` rounds, each
    splitting the key (the first half carries on), drawing 32-bit sort
    keys with the second and sorting the values by them, stably."""
    n = int(n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        keys = split(key)
        key, sub = keys[0], keys[1]
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` rounded once to float32, as XLA's CPU backend contracts
    it: the float32 product is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: Giles' degree-8 polynomials in
    ``w = -log1p(-x²)`` (``w - 2.5`` below 5, ``sqrt(w) - 3`` above), by
    Horner's rule with each step one fused multiply-add as XLA's CPU
    backend contracts it, times ``x``; ``±1`` gives ``±inf``."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coefficient(i):
        return torch.where(
            lt, torch.tensor(_ERFINV_LT5[i], dtype=torch.float32,
                             device=x.device),
            torch.tensor(_ERFINV_GE5[i], dtype=torch.float32,
                         device=x.device))

    p = coefficient(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coefficient(i))
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) · erf_inv(u)`` for
    ``u`` uniform in ``[nextafter(-1, 0), 1)``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return np.float32(np.sqrt(2)).item() * erf_inv(u)
