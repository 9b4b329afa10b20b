"""The JAX key chain on torch tensors: ``PRNGKey``, ``split`` and
``permutation`` with ``jax.random``'s threefry semantics under
``jax_threefry_partitionable=True``.

A key is an ``int64[2]`` tensor holding two uint32 words.  ``split`` is
threefry on iota counters: ``split(key, n)[i] = threefry2x32(k0, k1, 0, i)``.
``permutation(key, m)`` shuffles ``arange(m)`` by sorting it on fresh 32-bit
random keys, once per shuffle round (one round for any m below ~1600);
the round's keys are ``b0 ^ b1`` of threefry on ``(0, arange(m))`` under
``split(key)[1]``.  All functions stay on the key's device and never sync
with the host.
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
