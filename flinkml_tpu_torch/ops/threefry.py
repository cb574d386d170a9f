"""Threefry-2x32 counter-based random numbers: the draws of ``jax.random``.

The port's counterpart of the ``jax.random`` calls its Adam, MLP, FM and
Word2Vec trainers make (``PRNGKey``, ``fold_in``, ``split``, ``randint``,
``uniform``, ``normal``), the forests make (float64 ``uniform``,
``poisson`` below a rate of 10, ``permutation``) and LDA makes (float64
``normal`` and ``gamma``), with the bit layout of
``jax_threefry_partitionable=True``: a draw of shape ``s`` runs the
Threefry-2x32 block cipher once per element, on the counter pair (high and
low 32 bits of the element's row-major index), and a 32-bit draw is the
XOR of the two output words. The integer draws and ``uniform`` equal
JAX's bit for bit (``uniform``'s scaling is one fused multiply-add, as XLA
contracts it on the CPU); ``normal`` goes through XLA's float32 ``erf_inv``
polynomial (Giles), and its ``log1p`` and ``sqrt`` are PyTorch's, so a
normal draw may differ from JAX's in the last bits (the tests bound the gap
in ulps). The float64 ``normal`` goes through XLA's float64 ``erf_inv``
(Giles' double-precision polynomials) and XLA's ``log1p`` (a Cephes
rational below ``sqrt(2) - 1``), with every Horner step one fused
multiply-add as XLA's CPU backend contracts it; only the ``log`` of its
upper branch is PyTorch's. ``gamma`` is Marsaglia–Tsang's rejection loop as
``jax._src.random._gamma_one`` runs it, whose accept test takes PyTorch's
``log`` too (the tests count the draws that differ and the decisions that
flip).

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

#: XLA's float64 ``erf_inv`` coefficients (Giles' double-precision
#: polynomials) for ``w < 6.25``, ``w < 16`` and ``w >= 16``, highest power
#: first.
_ERFINV64_LT6_25 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)
#: XLA's float64 ``log1p`` below ``sqrt(2) - 1``: the Cephes rational
#: ``x - x²/2 + x³·P(x)/Q(x)``, highest power last.
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG1P_SMALL = 0.41421356237309504880

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
    transformed-rejection branch) or a NaN rate, ``gamma`` with ``a < 1``
    (JAX's boosted branch)."""


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


def _fma64(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """``a·b + c`` in float64 rounded once, as XLA's CPU backend contracts
    it: the product split exactly into ``p + e`` (Dekker), the sum ``p + c``
    into ``s + t`` (Knuth), then ``s + (t + e)``. That last sum rounds
    twice, so a result within one ulp of a tie may differ from a true fused
    multiply-add in its last bit."""
    p = a * b
    split = 134217729.0  # 2**27 + 1

    def halves(v):
        t = split * v
        hi = t - (t - v)
        return hi, v - hi

    ah, al = halves(a)
    bh, bl = halves(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    t = (p - (s - bb)) + (c - bb)
    return s + (t + e)


def _log1p64(x: torch.Tensor) -> torch.Tensor:
    """XLA's float64 ``log1p``: the Cephes rational below ``sqrt(2) - 1``
    (each Horner step and ``-x²/2 + x³·P/Q`` one fused multiply-add),
    ``log(1 + x)`` above it."""
    def horner(cs):
        r = torch.full_like(x, cs[0])
        for c in cs[1:]:
            r = _fma64(r, x, c)
        return r

    x2 = x * x
    small = x + _fma64(torch.full_like(x, -0.5), x2,
                       (x * x2) * (horner(_LOG1P_P) / horner(_LOG1P_Q)))
    return torch.where(torch.abs(x) < _LOG1P_SMALL, small, torch.log(x + 1.0))


def _erf_inv64(x: torch.Tensor) -> torch.Tensor:
    """XLA's float64 ``erf_inv``: Giles' polynomials in ``w = -log1p(-x²)``
    (``w - 3.125`` below 6.25, ``sqrt(w) - 3.25`` below 16, ``sqrt(w) - 5``
    above; 23, 19 and 17 coefficients), times ``x``."""
    w = -_log1p64(-x * x)
    lt6 = w < 6.25
    lt16 = w < 16.0
    sqrt_w = torch.sqrt(w)
    w = torch.where(lt6, w - 3.125,
                    sqrt_w - torch.where(lt16, torch.full_like(x, 3.25),
                                         torch.full_like(x, 5.0)))

    def coefficient(i):
        c = torch.full_like(x, _ERFINV64_LT6_25[i])
        if i < len(_ERFINV64_LT16):
            c = torch.where(lt6, c, torch.full_like(x, _ERFINV64_LT16[i]))
        if i < len(_ERFINV64_GE16):
            c = torch.where(lt16, c, torch.full_like(x, _ERFINV64_GE16[i]))
        return c

    p = coefficient(0)
    for i in range(1, len(_ERFINV64_GE16)):
        p = _fma64(p, w, coefficient(i))
    for i in range(len(_ERFINV64_GE16), len(_ERFINV64_LT16)):
        p = torch.where(lt16, _fma64(p, w, coefficient(i)), p)
    for i in range(len(_ERFINV64_LT16), len(_ERFINV64_LT6_25)):
        p = torch.where(lt6, _fma64(p, w, coefficient(i)), p)
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``erf_inv`` at the dtype of ``x``: float64 as
    :func:`_erf_inv64`; float32 as below.

    XLA's float32 ``erf_inv``: Giles' degree-8 polynomials in
    ``w = -log1p(-x²)`` (``w - 2.5`` below 5, ``sqrt(w) - 3`` above), by
    Horner's rule with each step one fused multiply-add as XLA's CPU
    backend contracts it, times ``x``; ``±1`` gives ``±inf``."""
    if x.dtype == torch.float64:
        return _erf_inv64(x)
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


def normal(key: torch.Tensor, shape: Sequence[int],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal`` in float32 (the default) or float64:
    ``sqrt(2) · erf_inv(u)`` for ``u`` uniform in ``[nextafter(-1, 0), 1)``
    at that dtype."""
    if dtype == torch.float64:
        lo = float(np.nextafter(-1.0, 0.0))
        u = uniform(key, shape, lo, 1.0, dtype=torch.float64)
        return float(np.sqrt(2)) * erf_inv(u)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return np.float32(np.sqrt(2)).item() * erf_inv(u)


def gamma(key: torch.Tensor, a: float, shape: Sequence[int] = ()
          ) -> torch.Tensor:
    """``jax.random.gamma(key, a, shape)`` in float64 (JAX's dtype under
    x64) for a scalar ``a >= 1``: ``[..., *shape]`` for keys ``[..., 2]``.

    As ``jax._src.random._gamma_impl`` runs it, each element draws under
    its own key of ``split(key, prod(shape))``: that key splits in two (the
    first half runs the loop), and Marsaglia–Tsang's loop
    (``_gamma_one``) repeats, while ``U >= 1 - 0.0331·X²`` and
    ``log U >= X/2 + d·(1 - V + log V)``: split the key in three (carry,
    ``x`` key, ``U`` key), draw float64 normals ``x`` under the ``x`` key's
    chain of halves until ``v = 1 + x·c > 0`` (one fused multiply-add),
    set ``X = x²``, ``V = v³`` and ``U`` a float64 uniform; the draw is
    ``d·V``, with ``d = a - 1/3``, ``c = (1/3)·(1/sqrt(d))``. A round runs
    on the elements still rejected (gathered by one ``nonzero``, the
    round's host check).

    ``a < 1`` (JAX's boost ``Gamma(a + 1)·U**(1/a)``) raises
    :class:`UnsupportedDrawError`: LDA draws ``a = 100``."""
    a = float(a)
    if not a >= 1.0:
        raise UnsupportedDrawError(
            f"gamma takes a >= 1 (Marsaglia-Tsang without JAX's boost), "
            f"got {a!r}")
    shape = tuple(int(s) for s in shape)
    lead = tuple(key.shape[:-1])
    n = int(np.prod(shape)) if shape else 1
    keys = split(key, n).reshape(-1, 2)
    rng = split(keys, 2)[:, 0]
    f64 = dict(dtype=torch.float64, device=key.device)
    d = a - 1.0 / 3.0
    # XLA rewrites (1/3)/sqrt(d) as (1/3)·rsqrt(d).
    c = (1.0 / 3.0) * (1.0 / float(np.sqrt(d)))
    x2 = torch.zeros(rng.shape[0], **f64)
    v3 = torch.ones(rng.shape[0], **f64)
    u = torch.full((rng.shape[0],), 2.0, **f64)
    while True:
        rejected = (u >= 1.0 - 0.0331 * (x2 * x2)) & (
            torch.log(u) >= x2 * 0.5 + d * ((1.0 - v3) + torch.log(v3)))
        live = torch.nonzero(rejected).reshape(-1)
        if live.numel() == 0:
            break
        three = split(rng[live], 3)
        rng[live] = three[:, 0]
        x_key = three[:, 1]
        c_t = torch.full((live.numel(),), c, **f64)
        x = torch.zeros_like(c_t)
        v = torch.full_like(c_t, -1.0)
        redraw = torch.ones_like(c_t, dtype=torch.bool)
        while bool(redraw.any()):
            two = split(x_key, 2)
            x_key = two[:, 0]
            x_new = normal(two[:, 1], (), dtype=torch.float64)
            x = torch.where(redraw, x_new, x)
            v = torch.where(redraw, _fma64(x_new, c_t, 1.0), v)
            redraw = redraw & (v <= 0.0)
        x2[live] = x * x
        v3[live] = (v * v) * v
        u[live] = uniform(three[:, 2], (), dtype=torch.float64)
    return (d * v3).reshape(lead + shape)
