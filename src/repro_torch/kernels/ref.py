"""Plain PyTorch versions of the port's kernels — the semantics the CUDA
kernels must reproduce, and what ``ops`` runs for a CPU tensor.

Inputs are upcast to f32 (exact for bf16) and every product accumulates
in f32.  On a GPU, ``torch.matmul`` in f32 keeps full precision only while
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default);
TF32 would break the 1e-5 tolerance the kernels are held to.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import gradgen
from repro_torch.kernels.gradgen import MASK32


def gram_ref(x: torch.Tensor) -> torch.Tensor:
    """(m, d) → (m, m) Gram matrix G_ij = ⟨x_i, x_j⟩ in f32: the f32 (or
    exactly upcast bf16) rows multiplied and summed in f64, then rounded
    once to f32.  A plain f32 product drifts with d: on an H100, cuBLAS's
    f32 GEMM at m = 32, d = 2^26 misses the exact Gram by 1.3e-5 relative,
    more than the 1e-5 the kernel is held to (PERF.md §6)."""
    x64 = x.to(torch.float32).to(torch.float64)
    return (x64 @ x64.T).to(torch.float32)


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


def gen_rows_ref(x, h, x_star, het_dir, keys, skewsign, slot, params,
                 moments=None) -> torch.Tensor:
    """The (m, d) f32 attacked batch the generating kernels stand in for:
    :func:`~repro_torch.kernels.gradgen.gen_worker_rows` over every
    coordinate at once.  ``keys`` are (m, 2) int64 uint32 words;
    ``moments``, when given, the (2, d) honest moments ALIE's rows read."""
    d = x.shape[0]
    j = torch.arange(d, dtype=torch.int64, device=x.device)
    f32 = torch.float32
    return gradgen.gen_worker_rows(x.to(f32), h.to(f32), x_star.to(f32), het_dir.to(f32),
                                   keys, skewsign.to(f32), slot, params.to(f32), j, d,
                                   moments=moments)


def gen_moments_ref(x, h, x_star, het_dir, keys, skewsign, slot, params) -> torch.Tensor:
    """(2, d) f32: the honest column moments (μ, σ) that ALIE's rows read,
    over the whole batch."""
    d = x.shape[0]
    j = torch.arange(d, dtype=torch.int64, device=x.device)
    f32 = torch.float32
    _, g = gradgen.honest_rows(x.to(f32), h.to(f32), x_star.to(f32), het_dir.to(f32), keys,
                               skewsign.to(f32), params.to(f32), j)
    return torch.stack(gradgen.honest_moments(g, slot))


def fused_guard_gen_ref(B, delta, x, h, x_star, het_dir, keys, skewsign, slot, params,
                        return_moments=False):
    """:func:`fused_guard_ref` over the generated batch, rounded once
    through the statistics dtype ``B.dtype`` as the materialising path
    stores it.  ``return_moments=True`` appends the (2, d) honest column
    moments (:func:`gen_moments_ref`) for :func:`gen_xi_ref`."""
    operands = (x, h, x_star, het_dir, keys, skewsign, slot, params)
    mom = gen_moments_ref(*operands) if return_moments else None
    out = fused_guard_ref(gen_rows_ref(*operands, moments=mom).to(B.dtype), B, delta)
    return (*out, mom) if return_moments else out


def gen_xi_ref(w_xi, w_byz, x, h, x_star, het_dir, keys, skewsign, slot, params,
               stats_dtype=torch.float32, moments=None):
    """``(Σᵢ w_xi[i]·rowᵢ, Σᵢ w_byz[i]·rowᵢ)`` in f32: ξ over the rows
    rounded through ``stats_dtype`` (what the guard's filtered mean sees),
    the Byzantine row sum over the raw f32 rows (what the adversary's
    feedback update sees).  ``moments``: the (2, d) honest moments that
    :func:`fused_guard_gen_ref` left for the same operands, read instead
    of taken again."""
    rows = gen_rows_ref(x, h, x_star, het_dir, keys, skewsign, slot, params, moments=moments)
    gs = rows.to(stats_dtype).to(torch.float32)
    xi = w_xi.to(torch.float32) @ gs
    byz = torch.sum(rows * w_byz.to(torch.float32)[:, None], dim=0)
    return xi, byz


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a · c) mod 2³² for int64 ``a`` holding uint32 values and a uint32
    constant ``c``, in two 16-bit halves of c so that no product leaves
    int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def sketch_sign(n: int, salt: int, device="cpu") -> torch.Tensor:
    """(n,) f32 ±1 per flat coordinate i, from the uint32 hash shared with
    the JAX package's ``sketch_sign``: h = (i + s)·2654435761 with
    s = (salt·0x9E3779B9 + 1) mod 2³², h ^= h >> 15, h *= 0x85EBCA6B,
    h ^= h >> 13, σ = 1 − 2·(h & 1).  The uint32 words live in int64."""
    s = (salt * 0x9E3779B9 + 1) & MASK32
    h = _mul32((torch.arange(n, dtype=torch.int64, device=device) + s) & MASK32, 2654435761)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    return 1.0 - 2.0 * (h & 1).to(torch.float32)


def countsketch_ref(x: torch.Tensor, k: int, salt: int = 0) -> torch.Tensor:
    """(m, d) → (m, k) f32 strided-fold CountSketch: out[w, c] = Σ over
    i ≡ c (mod k) of σ(i)·x[w, i], signs from :func:`sketch_sign`; x is
    upcast to f32 (exact for bf16).  k need not divide d, and buckets at or
    past d (k > d) are 0."""
    m, d = x.shape
    signed = x.to(torch.float32) * sketch_sign(d, salt, x.device)
    pad = (-d) % k
    if pad:
        signed = F.pad(signed, (0, pad))
    return torch.sum(signed.reshape(m, -1, k), dim=1)
