"""The JAX key chain on torch tensors: ``PRNGKey``, ``split``,
``fold_in``, ``permutation``, ``uniform`` and ``randint`` with
``jax.random``'s threefry semantics under
``jax_threefry_partitionable=True``.

A key is an ``int64[2]`` tensor holding two uint32 words.  ``split`` is
threefry on iota counters: ``split(key, n)[i] = threefry2x32(k0, k1, 0, i)``.
``permutation(key, m)`` shuffles ``arange(m)`` by sorting it on fresh 32-bit
random keys, once per shuffle round (one round for any m below ~1600);
the round's keys are ``b0 ^ b1`` of threefry on ``(0, arange(m))`` under
``split(key)[1]``.  ``fold_in(key, data)`` is ``threefry2x32(k0, k1, 0,
data)``.  ``uniform`` and ``randint`` draw ``b0 ^ b1`` of threefry on the
flat element index, as ``jax.random.bits`` does for 32-bit words.  All
functions stay on the key's device and never sync with the host.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.gradgen import MASK32, threefry2x32


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 32-bit seeds (jax's default,
    x64 off): the words ``[0, seed]``."""
    seed = int(seed)
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: an ``(num, 2)`` int64 tensor of keys."""
    counters = torch.arange(num, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key[0], key[1], torch.zeros_like(counters), counters)
    return torch.stack([x0, x1], dim=1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    data = int(data)
    if not 0 <= data <= MASK32:
        raise ValueError(f"fold_in data must lie in [0, 2**32), got {data}")
    # a fill on the key's device, not a copy from the host
    c = torch.full((), data, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key[0], key[1], torch.zeros_like(c), c)
    return torch.stack([x0, x1])


def _random_bits32(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)``: ``b0 ^ b1`` of threefry on
    the counters (0, i)."""
    counters = torch.arange(n, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key[0], key[1], torch.zeros_like(counters), counters)
    return b0 ^ b1


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


def _bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 words."""
    shape = tuple(int(n) for n in shape)
    return _random_bits32(key, math.prod(shape)).reshape(shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits as the mantissa of a float in [1, 2), minus 1, scaled and
    shifted in f32, and held at or above ``minval``."""
    mant = (_bits(key, shape) >> 9) | 0x3F800000
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` in int32 for
    ``minval < maxval``: two 32-bit streams under ``split(key)``, combined
    as ``(hi % span · (2¹⁶ % span)² % span + lo % span) % span`` in uint32."""
    minval, maxval = int(minval), int(maxval)
    if not -2 ** 31 <= minval < maxval <= 2 ** 31 - 1:
        raise ValueError(f"randint needs int32 bounds with minval < maxval, "
                         f"got {minval}, {maxval}")
    k1, k2 = split(key)
    higher, lower = _bits(k1, shape), _bits(k2, shape)
    span = maxval - minval
    mult = (2 ** 16 % span) ** 2 % span
    offset = (((higher % span) * mult) & MASK32) + lower % span
    offset = (offset & MASK32) % span
    return (minval + offset).to(torch.int32)
