"""Plain PyTorch versions of the guard kernels — the semantics the CUDA
kernels must reproduce, and what ``ops`` runs for a CPU tensor.

Inputs are upcast to f32 (exact for bf16) and every product accumulates
in f32.  On a GPU, ``torch.matmul`` in f32 keeps full precision only while
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default);
TF32 would break the 1e-5 tolerance the kernels are held to.
"""
from __future__ import annotations

import torch


def gram_ref(x: torch.Tensor) -> torch.Tensor:
    """(m, d) → (m, m) Gram matrix G_ij = ⟨x_i, x_j⟩ in f32."""
    x32 = x.to(torch.float32)
    return x32 @ x32.T


def filtered_mean_ref(x: torch.Tensor, mask: torch.Tensor,
                      denom: float) -> torch.Tensor:
    """(m, d), (m,) → (d,): Σᵢ (maskᵢ/denom)·xᵢ in f32 — the paper's ξ_k."""
    w = mask.to(torch.float32) / denom
    return w @ x.to(torch.float32)


def fused_guard_ref(grads: torch.Tensor, B: torch.Tensor, delta: torch.Tensor):
    """``(gram_g, cross, a_inc, B_new)`` = (g gᵀ, B gᵀ, g·δ, B + g); all
    accumulators f32, ``B_new`` rounded once (round-to-nearest-even) to
    ``B.dtype``.  ``cross`` uses the pre-update B."""
    g = grads.to(torch.float32)
    b = B.to(torch.float32)
    dlt = delta.to(torch.float32)
    return g @ g.T, b @ g.T, g @ dlt, (b + g).to(B.dtype)
