"""Dispatch of the port's kernels by the tensor's device.

A CUDA tensor launches the hand-written kernel, or raises (no fallback to
the plain version when a build or launch fails).  A CPU tensor runs the
plain PyTorch version in :mod:`repro_torch.kernels.ref`.  The signatures
are the JAX package's ``ops.fused_guard(grads, B, delta, sanitize=False)``,
``ops.filtered_mean(x, mask, denom, sanitize=False)``, ``ops.gram(x)``,
``ops.coordinate_median(x)``, ``ops.trimmed_mean(x, n_trim)`` and
``ops.countsketch(x, k, salt=0)``, ``ops.fused_guard_gen(B, delta, x, h,
x_star, het_dir, keys, skewsign, slot, params)`` and ``ops.gen_xi(w_xi,
w_byz, …, stats_dtype)``, without the TPU's ``d_block``; the port's
``fused_guard_gen(..., return_moments=True)`` also returns ALIE's
moments for ``gen_xi(..., moments=…)`` of the same step.

Under ``torch.func.vmap`` (a campaign group's runs) a CUDA tensor goes to
the ops of :mod:`repro_torch.kernels.run_axis`, whose vmap rules launch
each kernel once for the group, never a loop of R launches and never a
plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref, run_axis
from repro_torch.kernels.countsketch import countsketch_cuda
from repro_torch.kernels.fused_guard import fused_guard_cuda, fused_guard_gen_cuda, gen_xi_cuda
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
        if run_axis.under_vmap(grads, B, delta):
            op = run_axis.fused_guard_sanitize if sanitize else run_axis.fused_guard
            return op(grads, B, delta)
        return fused_guard_cuda(grads, B, delta, sanitize=sanitize)
    if sanitize:
        return ref.fused_guard_sanitize_ref(grads, B, delta)
    return ref.fused_guard_ref(grads, B, delta)


def filtered_mean(x: torch.Tensor, mask: torch.Tensor, denom: float,
                  sanitize: bool = False) -> torch.Tensor:
    """(m, d), (m,) → (d,): Σᵢ (maskᵢ/denom)·xᵢ in f32; ``sanitize=True``
    takes non-finite entries of x as 0."""
    if runs_kernel(x):
        if run_axis.under_vmap(x, mask):
            return run_axis.filtered_mean(x, mask, float(denom), bool(sanitize))
        return filtered_mean_cuda(x, mask, denom, sanitize=sanitize)
    if sanitize:
        return ref.filtered_mean_sanitize_ref(x, mask, denom)
    return ref.filtered_mean_ref(x, mask, denom)


def gram(x: torch.Tensor) -> torch.Tensor:
    """(m, d) → (m, m) worker Gram matrix in f32."""
    if runs_kernel(x):
        return run_axis.gram(x) if run_axis.under_vmap(x) else gram_cuda(x)
    return ref.gram_ref(x)


def coordinate_median(x: torch.Tensor) -> torch.Tensor:
    """(m, d) → (d,) coordinate-wise median in f32."""
    if runs_kernel(x):
        if run_axis.under_vmap(x):
            return run_axis.coordinate_median(x)
        return coordinate_median_cuda(x)
    return ref.coordinate_median_ref(x)


def trimmed_mean(x: torch.Tensor, n_trim: int) -> torch.Tensor:
    """(m, d) → (d,) coordinate-wise n_trim-trimmed mean in f32."""
    if runs_kernel(x):
        if run_axis.under_vmap(x):
            return run_axis.trimmed_mean(x, int(n_trim))
        return trimmed_mean_cuda(x, n_trim)
    return ref.trimmed_mean_ref(x, n_trim)


def countsketch(x: torch.Tensor, k: int, salt: int = 0) -> torch.Tensor:
    """(m, d) → (m, k) f32 strided-fold CountSketch with hashed signs."""
    if runs_kernel(x):
        if run_axis.under_vmap(x):
            return run_axis.countsketch(x, int(k), int(salt))
        return countsketch_cuda(x, k, salt)
    return ref.countsketch_ref(x, k, salt)


def fused_guard_gen(B, delta, x, h, x_star, het_dir, keys, skewsign, slot, params,
                    return_moments=False):
    """:func:`fused_guard` with the (m, d) gradients generated from the
    worker keys and the attack parameters instead of read (see
    :func:`repro_torch.kernels.gradgen.gen_worker_rows`); the rows are
    rounded through ``B.dtype``.  ``keys`` are (m, 2) int64 uint32 words.
    ``return_moments=True`` appends ALIE's (2, d) honest column moments,
    for :func:`gen_xi` of the same step (written by the kernel only when
    an ALIE id is in play)."""
    operands = (x, h, x_star, het_dir, keys, skewsign, slot, params)
    if runs_kernel(B):
        if run_axis.under_vmap(B, delta, *operands):
            out = run_axis.fused_guard_gen(B, delta, *operands)
            return out if return_moments else out[:4]
        moments = (torch.empty((2, x.shape[0]), dtype=torch.float32, device=x.device)
                   if return_moments else None)
        out = fused_guard_gen_cuda(B, delta, *operands, moments=moments)
        return (*out, moments) if return_moments else out
    return ref.fused_guard_gen_ref(B, delta, *operands, return_moments=return_moments)


def gen_xi(w_xi, w_byz, x, h, x_star, het_dir, keys, skewsign, slot, params,
           stats_dtype=torch.float32, moments=None):
    """``(ξ, byz)`` over the generated rows: ξ = Σ w_xi·rows rounded through
    ``stats_dtype``, byz = Σ w_byz·rows over the raw f32 rows.  ``moments``:
    what :func:`fused_guard_gen` left there for the same operands, read
    instead of taken again."""
    if runs_kernel(x):
        if run_axis.under_vmap(w_xi, w_byz, x, h, x_star, het_dir, keys, skewsign, slot,
                               params, moments):
            return run_axis.gen_xi(w_xi, w_byz, x, h, x_star, het_dir, keys, skewsign, slot,
                                   params, moments, stats_dtype == torch.bfloat16)
        return gen_xi_cuda(w_xi, w_byz, x, h, x_star, het_dir, keys, skewsign, slot, params,
                           stats_dtype=stats_dtype, moments=moments)
    return ref.gen_xi_ref(w_xi, w_byz, x, h, x_star, het_dir, keys, skewsign, slot, params,
                          stats_dtype=stats_dtype, moments=moments)
