"""Dispatch of the guard kernels by the tensor's device.

A CUDA tensor launches the hand-written kernel, or raises (no fallback to
the plain version when a build or launch fails).  A CPU tensor runs the
plain PyTorch version in :mod:`repro_torch.kernels.ref`.  The signatures
are the JAX package's ``ops.fused_guard(grads, B, delta)`` and
``ops.filtered_mean(x, mask, denom)``, without the TPU's ``d_block``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_guard import fused_guard_cuda
from repro_torch.kernels.robust_reduce import filtered_mean_cuda


def runs_kernel(t: torch.Tensor) -> bool:
    """True when ``t``'s device sends ``ops`` to the CUDA kernels, False
    when it runs the plain versions."""
    return t.device.type != "cpu"


def fused_guard(grads: torch.Tensor, B: torch.Tensor, delta: torch.Tensor):
    """(m, d), (m, d), (d,) → (gram_g, cross, a_inc, B_new) in one sweep."""
    if runs_kernel(grads):
        return fused_guard_cuda(grads, B, delta)
    return ref.fused_guard_ref(grads, B, delta)


def filtered_mean(x: torch.Tensor, mask: torch.Tensor, denom: float) -> torch.Tensor:
    """(m, d), (m,) → (d,): Σᵢ (maskᵢ/denom)·xᵢ in f32."""
    if runs_kernel(x):
        return filtered_mean_cuda(x, mask, denom)
    return ref.filtered_mean_ref(x, mask, denom)
