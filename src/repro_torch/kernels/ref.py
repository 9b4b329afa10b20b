"""Plain PyTorch versions of the port's kernels — the semantics the CUDA
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


def _sorted_columns(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(each column of ``x`` sorted ascending in f32, which columns hold a
    NaN).  The Pallas kernels sort with NaN-propagating min/max, so one NaN
    turns its whole column to NaN; the order statistics here follow them."""
    x32 = x.to(torch.float32)
    return torch.sort(x32, dim=0).values, torch.isnan(x32).any(dim=0)


def coordinate_median_ref(x: torch.Tensor) -> torch.Tensor:
    """(m, d) → (d,) coordinate-wise median in f32 (Yin et al.'s
    Median-GD rule).  Even m averages the two middle values, as
    ``jnp.median``; ``torch.median`` would return the lower one."""
    s, nan = _sorted_columns(x)
    m = x.shape[0]
    med = s[m // 2] if m % 2 else (s[m // 2 - 1] + s[m // 2]) * 0.5
    return torch.where(nan, torch.nan, med)


def trimmed_mean_ref(x: torch.Tensor, n_trim: int) -> torch.Tensor:
    """(m, d) → (d,): drop the n_trim largest and smallest entries of each
    column and average the rest in f32."""
    m = x.shape[0]
    if not 0 <= 2 * n_trim < m:
        raise ValueError(f"trimmed_mean: n_trim={n_trim} trims everything for m={m}")
    s, nan = _sorted_columns(x)
    return torch.where(nan, torch.nan, torch.mean(s[n_trim:m - n_trim], dim=0))


def filtered_mean_ref(x: torch.Tensor, mask: torch.Tensor,
                      denom: float) -> torch.Tensor:
    """(m, d), (m,) → (d,): Σᵢ (maskᵢ/denom)·xᵢ in f32 — the paper's ξ_k."""
    w = mask.to(torch.float32) / denom
    return w @ x.to(torch.float32)


def filtered_mean_sanitize_ref(x: torch.Tensor, mask: torch.Tensor,
                               denom: float) -> torch.Tensor:
    """:func:`filtered_mean_ref` with non-finite entries of x taken as 0,
    so a zero-weight NaN/Inf row adds nothing (0·Inf would be NaN)."""
    x32 = x.to(torch.float32)
    x32 = torch.where(torch.isfinite(x32), x32, 0.0)
    w = mask.to(torch.float32) / denom
    return w @ x32


def fused_guard_ref(grads: torch.Tensor, B: torch.Tensor, delta: torch.Tensor):
    """``(gram_g, cross, a_inc, B_new)`` = (g gᵀ, B gᵀ, g·δ, B + g); all
    accumulators f32, ``B_new`` rounded once (round-to-nearest-even) to
    ``B.dtype``.  ``cross`` uses the pre-update B."""
    g = grads.to(torch.float32)
    b = B.to(torch.float32)
    dlt = delta.to(torch.float32)
    return g @ g.T, b @ g.T, g @ dlt, (b + g).to(B.dtype)


def fused_guard_sanitize_ref(grads: torch.Tensor, B: torch.Tensor, delta: torch.Tensor):
    """:func:`fused_guard_ref` with the non-finite entries of the
    gradients zeroed before every product and the B update, plus a fifth
    output ``nf``: each row's (m,) int32 count of them.  B and δ are not
    tested (finite by construction)."""
    g = grads.to(torch.float32)
    fin = torch.isfinite(g)
    nf = torch.sum(~fin, dim=1, dtype=torch.int32)
    g = torch.where(fin, g, 0.0)
    b = B.to(torch.float32)
    dlt = delta.to(torch.float32)
    return g @ g.T, b @ g.T, g @ dlt, (b + g).to(B.dtype), nf
