"""The JAX key chain on torch tensors: ``PRNGKey``, ``split``,
``fold_in``, ``permutation``, ``uniform``, ``randint``, ``normal``,
``truncated_normal`` and ``bernoulli`` with ``jax.random``'s threefry semantics under
``jax_threefry_partitionable=True``.

A key is an ``int64[2]`` tensor holding two uint32 words.  ``split`` is
threefry on iota counters: ``split(key, n)[i] = threefry2x32(k0, k1, 0, i)``.
A draw's flat element index i is the counter pair ``(i >> 32, i & 0xFFFFFFFF)``,
as jax's ``iota_2x32_shape`` makes it, so a leaf of 2³² elements or more
draws fresh bits past element 2³² - 1.
``permutation(key, m)`` shuffles ``arange(m)`` by sorting it on fresh 32-bit
random keys, once per shuffle round (one round for any m below ~1600);
the round's keys are ``b0 ^ b1`` of threefry on ``(0, arange(m))`` under
``split(key)[1]``.  ``fold_in(key, data)`` is ``threefry2x32(k0, k1, 0,
data)``.  ``uniform`` and ``randint`` draw ``b0 ^ b1`` of threefry on the
flat element index, as ``jax.random.bits`` does for 32-bit words.
``normal`` is ``√2·erf_inv(u)`` of a uniform u on (nextafter(−1, 0), 1),
with ``erf_inv`` Giles' single-precision polynomial as XLA evaluates it
(:func:`erf_inv`); ``bernoulli`` is ``uniform < p``.

``truncated_normal`` is ``√2·erf_inv`` of a uniform between the bounds'
erf, clamped inside the bounds.

``uniform``, ``normal`` and ``truncated_normal`` take an ``offset``: the
draw is then elements ``offset, offset + 1, …`` of a flat draw from the same
key, so a large leaf can be drawn piece by piece with the whole draw's bits
(:func:`repro_torch.models.common.init_param`).

``split``, ``uniform``, ``randint``, ``normal`` and ``bernoulli`` also take
a batch of keys, an ``(..., 2)`` tensor, and then draw once per key, as
``jax.vmap`` of the single-key call does: the result has the keys' batch
shape in front (``split(keys, n)`` is ``(..., n, 2)``).  All functions stay
on the key's device and never sync with the host.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.gradgen import MASK32, threefry2x32


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 32-bit seeds (jax's default,
    x64 off): the words ``[0, seed]``."""
    seed = int(seed)
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def _words(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two words of a key, or of a batch of keys (..., 2), shaped to
    broadcast against a trailing counter axis."""
    return key[..., 0, None], key[..., 1, None]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: an ``(num, 2)`` int64 tensor of keys
    (``(..., num, 2)`` for a batch of keys)."""
    counters = torch.arange(num, dtype=torch.int64, device=key.device)
    k0, k1 = _words(key)
    x0, x1 = threefry2x32(k0, k1, torch.zeros_like(counters), counters)
    return torch.stack([x0, x1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    data = int(data)
    if not 0 <= data <= MASK32:
        raise ValueError(f"fold_in data must lie in [0, 2**32), got {data}")
    # a fill on the key's device, not a copy from the host
    c = torch.full((), data, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key[0], key[1], torch.zeros_like(c), c)
    return torch.stack([x0, x1])


# counters a threefry call takes at once: a draw the size of a model's
# embedding table goes through in pieces, so its int64 temporaries stay
# near 1 GiB
_BITS_CHUNK = 1 << 25


def _random_bits32(key: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, (offset + n,), uint32)[offset:]``: ``b0 ^ b1``
    of threefry on the counter words ``(i >> 32, i & MASK32)``; ``(..., n)``
    for a batch of keys."""
    k0, k1 = _words(key)

    def draw(lo: int, hi: int) -> torch.Tensor:
        counters = torch.arange(lo, hi, dtype=torch.int64, device=key.device)
        b0, b1 = threefry2x32(k0, k1, counters >> 32, counters & MASK32)
        return b0 ^ b1

    if n > _BITS_CHUNK:
        out = torch.empty(key.shape[:-1] + (n,), dtype=torch.int64, device=key.device)
        for lo in range(0, n, _BITS_CHUNK):
            hi = min(lo + _BITS_CHUNK, n)
            out[..., lo:hi] = draw(offset + lo, offset + hi)
        return out
    return draw(offset, offset + n)


def permutation(key: torch.Tensor, m: int) -> torch.Tensor:
    """``jax.random.permutation(key, m)`` for an integer ``m``."""
    x = torch.arange(m, dtype=torch.int64, device=key.device)
    # jax's shuffle round count: enough rounds that 32-bit sort keys
    # collide with small probability
    n_rounds = math.ceil(3 * math.log(max(1, m)) / math.log(MASK32))
    for _ in range(n_rounds):
        key, sub = split(key)
        order = torch.argsort(_random_bits32(sub, m), stable=True)
        x = x[order]
    return x


def _bits(key: torch.Tensor, shape, offset: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 words, after the
    keys' batch shape (from flat element ``offset`` on)."""
    shape = tuple(int(n) for n in shape)
    return _random_bits32(key, math.prod(shape), offset).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0, *, offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits as the mantissa of a float in [1, 2), minus 1, times the f32
    span ``maxval − minval`` plus ``minval`` in one fused multiply-add (XLA
    contracts the two), and held at or above ``minval``."""
    # the float with those 23 mantissa bits in [1, 2), minus 1, is k·2⁻²³
    # for the 23-bit k: exact in f32 either way, and a product where a bit
    # view would be (vmap has no rule for a dtype view in every torch)
    floats = (_bits(key, shape, offset) >> 9).to(torch.float64) * (2.0 ** -23)
    lo32 = np.float32(minval)
    span = float(np.float32(maxval) - lo32)
    # an f32 product is exact in f64, so the f64 sum rounded to f32 is the
    # FMA's result
    out = (floats * span + float(lo32)).to(torch.float32)
    return torch.clamp(out, min=float(lo32))


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` in int32 for
    ``minval < maxval``: two 32-bit streams under ``split(key)``, combined
    as ``(hi % span · (2¹⁶ % span)² % span + lo % span) % span`` in uint32."""
    minval, maxval = int(minval), int(maxval)
    if not -2 ** 31 <= minval < maxval <= 2 ** 31 - 1:
        raise ValueError(f"randint needs int32 bounds with minval < maxval, "
                         f"got {minval}, {maxval}")
    keys = split(key)
    higher, lower = _bits(keys[..., 0, :], shape), _bits(keys[..., 1, :], shape)
    span = maxval - minval
    mult = (2 ** 16 % span) ** 2 % span
    offset = (((higher % span) * mult) & MASK32) + lower % span
    offset = (offset & MASK32) % span
    return (minval + offset).to(torch.int32)


# Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011):
# the single-precision coefficients, highest order first, for w < 5 (at
# w − 2.5) and otherwise (at √w − 3), as XLA's f32 erf_inv holds them
_ERFINV_LOW = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HIGH = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``: w = −log1p(−x²); Giles' polynomial at w − 2.5
    for w < 5, else at √w − 3, by Horner steps that are fused
    multiply-adds; times x (±1 gives ±inf).  Each step is taken in f64 and
    rounded once to f32: an f32 product is exact in f64 and the sum rounds
    once more, which gives the FMA's bits but where the f64 sum sits exactly
    on an f32 rounding midpoint.  ``torch.log1p`` and ``torch.sqrt`` stand
    in for XLA's own on the CPU, which differ from them by an ulp on some
    inputs (ROADMAP.md, "Documented differences")."""
    w = -torch.log1p(-(x * x))
    low = w < 5.0
    w = torch.where(low, w - 2.5, torch.sqrt(w) - 3.0).to(torch.float64)
    p = torch.where(low, _ERFINV_LOW[0], _ERFINV_HIGH[0]).to(torch.float64)
    for c_low, c_high in zip(_ERFINV_LOW[1:], _ERFINV_HIGH[1:]):
        c = torch.where(low, float(np.float32(c_low)), float(np.float32(c_high))).to(w.dtype)
        p = torch.addcmul(c, p, w).to(torch.float32).to(torch.float64)
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p.to(torch.float32) * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal(key: torch.Tensor, shape=(), dtype=torch.float32, *,
           offset: int = 0) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: √2·erf_inv(u) for u
    uniform on (nextafter(−1, 0), 1).  Only float32 is ported: jax draws
    another dtype from other bits."""
    if dtype != torch.float32:
        raise ValueError(f"normal draws float32 only, got {dtype}")
    return _SQRT2 * erf_inv(uniform(key, shape, _NORMAL_LO, 1.0, offset=offset))


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape=(), *, offset: int = 0) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)``:
    u uniform on [erf(lower/√2), erf(upper/√2)), then √2·erf_inv(u),
    clamped to [nextafter(lower, +inf), nextafter(upper, −inf)].  The bounds'
    erf is taken in double and rounded to f32 (XLA's f32 erf gives the same
    bits at ±2/√2, the bounds the models draw with); the draws inherit
    :func:`normal`'s few-ulp difference from ``erf_inv``."""
    lo, hi = np.float32(lower), np.float32(upper)
    sqrt2 = np.float32(np.sqrt(2.0))
    a = float(np.float32(math.erf(float(lo / sqrt2))))
    b = float(np.float32(math.erf(float(hi / sqrt2))))
    out = _SQRT2 * erf_inv(uniform(key, shape, a, b, offset=offset))
    return torch.clamp(out, float(np.nextafter(lo, np.float32(np.inf))),
                       float(np.nextafter(hi, np.float32(-np.inf))))


def bernoulli(key: torch.Tensor, p: float = 0.5, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` in its default ``mode="low"``:
    ``uniform(key, shape) < p`` in f32, a bool tensor."""
    return uniform(key, shape) < float(np.float32(p))
