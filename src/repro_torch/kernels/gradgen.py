"""Counter-based gradient generation: the part of
:mod:`repro.kernels.gradgen` that the materialised generated problem needs.

Threefry-2x32 (20 rounds) on torch integer tensors.  torch has no uint32
add on the CPU, so every word is an ``int64`` tensor holding a value in
``[0, 2³²)``: each add is masked with ``& 0xFFFFFFFF`` and each right
shift acts on an already-masked value.  The bits equal the JAX package's
``threefry2x32`` (pinned by the Random123 known-answer vectors in the
tests), so the port's key chain and noise stream reproduce the
reference's from the same seed.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# Threefry-2x32 rotation schedule (Salmon et al. 2011), 20 rounds in five
# groups of four; even groups rotate by R_A, odd groups by R_B.
_R_A = (13, 15, 26, 6)
_R_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds.  The four operands are int64 tensors of
    uint32 values and broadcast against each other; returns the two output
    words as int64 tensors of uint32 values."""
    ks2 = k0 ^ k1 ^ _PARITY
    x0 = (c0 + k0) & MASK32
    x1 = (c1 + k1) & MASK32
    # key-injection schedule after each 4-round group
    inject = ((k1, ks2, 1), (ks2, k0, 2), (k0, k1, 3),
              (k1, ks2, 4), (ks2, k0, 5))
    for g, (ka, kb, inc) in enumerate(inject):
        rots = _R_A if g % 2 == 0 else _R_B
        for r in rots:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ka) & MASK32
        x1 = (x1 + kb + inc) & MASK32
    return x0, x1


def centered_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits → f32 uniform in (−1, 1): the top 23 bits land on the
    open-interval lattice ((b >> 9) + 0.5)·2⁻²³ ∈ (0, 1), then center.
    Every step is one f32 operation, as in the JAX package."""
    u = ((bits >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)
    return 2.0 * u - 1.0


def key_bits(key: torch.Tensor) -> torch.Tensor:
    """Raw uint32 words of a key (``int64[..., 2]``), masked to 32 bits."""
    if key.dtype != torch.int64:
        raise TypeError(f"keys are int64 tensors of uint32 words, got {key.dtype}")
    return key & MASK32


def noise_bits(k0, k1, j: torch.Tensor) -> torch.Tensor:
    """Noise bits for coordinate counter ``j`` under worker key words
    (k0, k1): word 0 of ``threefry2x32(k0, k1, 0, j)``."""
    return threefry2x32(k0, k1, torch.zeros_like(j), j)[0]


def mean_grad(h: torch.Tensor, x: torch.Tensor, x_star: torch.Tensor) -> torch.Tensor:
    """∇f(x) of the diagonal quadratic f(x) = ½ Σ hⱼ (xⱼ − x*ⱼ)²."""
    return h * (x - x_star)


def noise_row(k0, k1, j: torch.Tensor, noise_scale: float) -> torch.Tensor:
    """Noise at global coordinates ``j`` under key words (k0, k1):
    ``noise_scale · centered_uniform(bits)``.  With ``k0``/``k1`` of shape
    (m, 1) and ``j`` of shape (1, d) this is the whole (m, d) batch — the
    batched form of the JAX package's per-worker ``vmap``."""
    return noise_scale * centered_uniform(noise_bits(k0, k1, j))
