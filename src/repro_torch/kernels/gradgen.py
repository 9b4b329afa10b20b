"""Counter-based gradient generation, the counterpart of
:mod:`repro.kernels.gradgen`: the materialised generated problem's
sampler, and the plain version of the generator that the two generating
kernels (``csrc/fused_guard.cu`` with ``GEN``, ``csrc/filtered_mean.cu``'s
``gen_xi``) run per strip, :func:`gen_worker_rows`.

Threefry-2x32 (20 rounds) on torch integer tensors.  torch has no uint32
add on the CPU, so every word is an ``int64`` tensor holding a value in
``[0, 2³²)``: each add is masked with ``& 0xFFFFFFFF`` and each right
shift acts on an already-masked value.  The bits equal the JAX package's
``threefry2x32`` (pinned by the Random123 known-answer vectors in the
tests), so the port's key chain and noise stream reproduce the
reference's from the same seed.
"""
from __future__ import annotations

from typing import NamedTuple

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


class GenSpec(NamedTuple):
    """What a kernel needs to regenerate a worker's row: the coordinate-wise
    problem data, the noise scale and the rank-1 heterogeneity direction
    (zeros for a homogeneous fleet).  ``het_sign`` holds the workers' ±1
    signs once :func:`repro_torch.data.problems.heterogenize_generated` has
    set them, else ``None``."""

    h: torch.Tensor             # (d,) diagonal curvature
    x_star: torch.Tensor        # (d,) optimum
    noise_scale: float          # V/√d in f32, ‖noise‖ ≤ V almost surely
    het_dir: torch.Tensor       # (d,) rank-1 skew direction; zeros if iid
    het_sign: torch.Tensor | None = None  # (m,) ±1 f32


# The attack parameter vector of one step (see the JAX package's module
# comment): slots a/b are the scenario's two coalition phases, each with
# its effective ATTACK_TABLE id (retreat_on_filter already remapped to
# inner_product or none), the sign_flip factor sf (row = sf·g), the ALIE
# deviation z (row = μ ∓ z·σ), the drift / hidden-shift constant (row =
# const, or t + const) and the inner-product pull ipc (row = t −
# ipc·t/‖t‖); then ‖∇f(x)‖ (floored at 1e-12) and the noise scale.
GEN_NPARAMS = 12
(P_ID_A, P_SF_A, P_Z_A, P_CONST_A, P_IPC_A,
 P_ID_B, P_SF_B, P_Z_B, P_CONST_B, P_IPC_B,
 P_TGNRM, P_NSCALE) = range(GEN_NPARAMS)

# the ATTACK_TABLE ids the generator applies; random_gaussian (2) draws a
# key per row and falls through to the honest row
GEN_SUPPORTED_IDS = (0, 1, 3, 4, 5, 6, 7, 8)


class GenStepCtx(NamedTuple):
    """The O(m) inputs of one generating guard step, in place of the (m, d)
    batch."""

    worker_keys: torch.Tensor  # (m, 2) int64 uint32 words of split(gkey, m)
    skewsign: torch.Tensor     # (m,) f32 skew·sign per worker (0 = iid)
    slot: torch.Tensor         # (m,) int32: 0 honest, 1 phase a, 2 phase b
    params: torch.Tensor       # (GEN_NPARAMS,) f32
    w_byz: torch.Tensor        # (m,) f32 Byzantine mask, for the feedback sum


def honest_rows(x, h, x_star, het_dir, keys, skewsign, params, j):
    """``(t, g)``: the true gradient t (blk,) and every worker's honest
    row g (m, blk) at the coordinates ``j`` (arguments as for
    :func:`gen_worker_rows`)."""
    jm = j.reshape(1, -1)
    t = mean_grad(h, x, x_star)
    bits = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(jm), jm)[0]
    g = t[None, :] + params[P_NSCALE] * centered_uniform(bits)
    g = torch.where(skewsign[:, None] != 0.0,
                    g + skewsign[:, None] * het_dir[None, :], g)
    return t, g


def honest_moments(g, slot):
    """ALIE's honest column moments ``(μ, σ)`` over the rows of slot 0,
    population form, as attacks._good_row_stats."""
    w = (slot == 0).to(torch.float32)[:, None]
    n_good = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(g * w, dim=0) / n_good
    var = torch.sum(w * (g - mu[None, :]) ** 2, dim=0) / n_good
    return mu, torch.sqrt(var + 1e-12)


def gen_worker_rows(x, h, x_star, het_dir, keys, skewsign, slot, params, j, d: int,
                    moments=None):
    """All worker rows at the coordinates ``j``, attacked: the plain
    version of the generating kernels' prologue, op for op the JAX
    package's ``gen_worker_rows``.

    ``x, h, x_star, het_dir`` are the (blk,) f32 strips at ``j``; ``keys``
    the (m, 2) int64 key words; ``skewsign`` (m,) f32; ``slot`` (m,) int
    (−1 marks a padding row); ``params`` (GEN_NPARAMS,) f32; ``j`` the
    (blk,) int64 global coordinates; ``moments``, when given, the (2, blk)
    honest moments (μ, σ) at ``j`` to use instead of taking them from
    these rows (:func:`honest_moments` gives the same values).  Returns
    (m, blk) f32 rows; padding rows and coordinates at or past ``d`` are 0.
    """
    p = params
    jm = j.reshape(1, -1)
    t, g = honest_rows(x, h, x_star, het_dir, keys, skewsign, params, j)
    mu, sig = honest_moments(g, slot) if moments is None else (moments[0], moments[1])
    gn = t / p[P_TGNRM]

    use_b = slot == 2
    aid = torch.where(use_b, p[P_ID_B], p[P_ID_A])[:, None]
    sf = torch.where(use_b, p[P_SF_B], p[P_SF_A])[:, None]
    zf = torch.where(use_b, p[P_Z_B], p[P_Z_A])[:, None]
    cst = torch.where(use_b, p[P_CONST_B], p[P_CONST_A])[:, None]
    ipc = torch.where(use_b, p[P_IPC_B], p[P_IPC_A])[:, None]

    # ids 0 and 2 fall through to the honest row
    row = g
    row = torch.where(aid == 1.0, sf * g, row)
    row = torch.where(aid == 3.0, cst + torch.zeros_like(g), row)
    row = torch.where(aid == 4.0, mu[None, :] - zf * sig[None, :], row)
    row = torch.where(aid == 8.0, mu[None, :] + zf * sig[None, :], row)
    row = torch.where(aid == 5.0, t[None, :] - ipc * gn[None, :], row)
    row = torch.where(aid == 6.0, t[None, :] + cst, row)
    out = torch.where((slot > 0)[:, None], row, g)

    keep = (slot >= 0)[:, None] & (jm < d)
    return torch.where(keep, out, 0.0)
