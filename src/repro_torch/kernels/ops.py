"""Dispatch of the port's kernels by the tensor's device.

A CUDA tensor launches the hand-written kernel, or raises (no fallback to
the plain version when a build or launch fails).  A CPU tensor runs the
plain PyTorch version in :mod:`repro_torch.kernels.ref`.  The signatures
are the JAX package's ``ops.fused_guard(grads, B, delta, sanitize=False)``,
``ops.filtered_mean(x, mask, denom, sanitize=False)``, ``ops.gram(x)``,
``ops.coordinate_median(x)``, ``ops.trimmed_mean(x, n_trim)`` and
``ops.countsketch(x, k, salt=0)``, without the TPU's ``d_block``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.countsketch import countsketch_cuda
from repro_torch.kernels.fused_guard import fused_guard_cuda
from repro_torch.kernels.pairdist import gram_cuda
from repro_torch.kernels.robust_reduce import (
    coordinate_median_cuda,
    filtered_mean_cuda,
    trimmed_mean_cuda,
)


def runs_kernel(t: torch.Tensor) -> bool:
    """True when ``t``'s device sends ``ops`` to the CUDA kernels, False
    when it runs the plain versions."""
    return t.device.type != "cpu"


def fused_guard(grads: torch.Tensor, B: torch.Tensor, delta: torch.Tensor,
                sanitize: bool = False):
    """(m, d), (m, d), (d,) → (gram_g, cross, a_inc, B_new) in one sweep;
    ``sanitize=True`` zeroes non-finite gradient entries in the sweep and
    appends ``nf``, the per-row (m,) int32 count of them."""
    if runs_kernel(grads):
        return fused_guard_cuda(grads, B, delta, sanitize=sanitize)
    if sanitize:
        return ref.fused_guard_sanitize_ref(grads, B, delta)
    return ref.fused_guard_ref(grads, B, delta)


def filtered_mean(x: torch.Tensor, mask: torch.Tensor, denom: float,
                  sanitize: bool = False) -> torch.Tensor:
    """(m, d), (m,) → (d,): Σᵢ (maskᵢ/denom)·xᵢ in f32; ``sanitize=True``
    takes non-finite entries of x as 0."""
    if runs_kernel(x):
        return filtered_mean_cuda(x, mask, denom, sanitize=sanitize)
    if sanitize:
        return ref.filtered_mean_sanitize_ref(x, mask, denom)
    return ref.filtered_mean_ref(x, mask, denom)


def gram(x: torch.Tensor) -> torch.Tensor:
    """(m, d) → (m, m) worker Gram matrix in f32."""
    if runs_kernel(x):
        return gram_cuda(x)
    return ref.gram_ref(x)


def coordinate_median(x: torch.Tensor) -> torch.Tensor:
    """(m, d) → (d,) coordinate-wise median in f32."""
    if runs_kernel(x):
        return coordinate_median_cuda(x)
    return ref.coordinate_median_ref(x)


def trimmed_mean(x: torch.Tensor, n_trim: int) -> torch.Tensor:
    """(m, d) → (d,) coordinate-wise n_trim-trimmed mean in f32."""
    if runs_kernel(x):
        return trimmed_mean_cuda(x, n_trim)
    return ref.trimmed_mean_ref(x, n_trim)


def countsketch(x: torch.Tensor, k: int, salt: int = 0) -> torch.Tensor:
    """(m, d) → (m, k) f32 strided-fold CountSketch with hashed signs."""
    if runs_kernel(x):
        return countsketch_cuda(x, k, salt)
    return ref.countsketch_ref(x, k, salt)
