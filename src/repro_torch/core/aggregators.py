"""Baseline gradient-aggregation rules of :mod:`repro.core.aggregators`:
the Table-1 / Section-1.4 baselines and the empirical literature's
aggregators.

Two kinds of rule live here, as in the JAX package:

* **stateless** — ``agg(grads: (m, d)) -> (d,)``, registered in
  :data:`AGGREGATORS` and resolved by :func:`get_aggregator`;
* **stateful** — factories ``factory(d, **knobs) -> (state0, step)`` with
  ``step(state, grads) -> (state', xi)`` in :data:`STATEFUL_AGGREGATORS`
  (centered clipping's carried center); the solver carries the state.

``bucket_means`` is the pre-averaging behind the solver's
``bucket<s>:<base>`` spelling.

Design choice: the coordinate median and the trimmed mean go through
:func:`repro_torch.kernels.ops.coordinate_median` /
:func:`~repro_torch.kernels.ops.trimmed_mean`, so a CUDA tensor runs the
hand-written order-statistic kernels (the Median-GD and trimmed-mean-GD
reductions those kernels exist for).  The JAX rules call ``jnp.median`` /
``jnp.sort`` instead; the function is the same on finite input, and the
result is cast back to the input's dtype as the JAX rules return it.  Krum,
multi-Krum and the medoid take their distances from ``ops.gram``, as the
JAX package does.

References: coordinate median / trimmed mean — Yin et al. 2018; Krum —
Blanchard et al. 2017; geometric median — Chen, Su & Xu 2017 (Weiszfeld,
smoothed as Pillutla et al.'s RFA); AutoGM — Li et al. 2022; centered
clipping — Karimireddy, He & Jaggi 2021; bucketing — Karimireddy, He &
Jaggi 2022.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch import prng
from repro_torch.core.byzantine_sgd import pairwise_sq_dists_from_gram
from repro_torch.kernels import ops


def aggregate_mean(grads: torch.Tensor) -> torch.Tensor:
    """Plain mini-batch mean — the α = 0 baseline; not Byzantine-robust."""
    return torch.mean(grads, dim=0)


def aggregate_coordinate_median(grads: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median (Yin et al.'s Median-GD aggregation)."""
    return ops.coordinate_median(grads).to(grads.dtype)


def aggregate_trimmed_mean(grads: torch.Tensor, trim_fraction: float = 0.1) -> torch.Tensor:
    """Coordinate-wise β-trimmed mean: drop the β·m largest and smallest
    entries per coordinate, average the rest (Yin et al., trimmed-mean-GD).
    The count is taken in Python floats with the JAX package's epsilon, so
    an exactly integral β·m (0.3 · 10 → 2.999…) trims the intended count."""
    m = grads.shape[0]
    b = int(trim_fraction * m + 1e-9)
    if 2 * b >= m:
        raise ValueError(f"trim_fraction {trim_fraction} trims everything for m={m}")
    return ops.trimmed_mean(grads, b).to(grads.dtype)


def _pairwise_sq_dists(grads: torch.Tensor) -> torch.Tensor:
    return pairwise_sq_dists_from_gram(ops.gram(grads))


def aggregate_krum(grads: torch.Tensor, n_byzantine: int, multi_k: int = 1) -> torch.Tensor:
    """(Multi-)Krum [Blanchard et al. 2017].

    Score(i) = sum of squared distances to i's m − f − 2 nearest neighbours
    (f = n_byzantine); select the multi_k lowest-scoring gradients and
    average them.  The first minimum wins a tie, as ``jnp.argmin`` and
    ``lax.top_k`` pick it (``torch.topk`` does not promise the lower
    index, so the multi_k rows come from a stable argsort)."""
    m = grads.shape[0]
    n_neighbors = max(m - n_byzantine - 2, 1)
    d2 = _pairwise_sq_dists(grads)
    # exclude self (a where, not fill_diagonal_, so that vmap batches it
    # without a loop over the runs)
    d2 = torch.where(torch.eye(m, dtype=torch.bool, device=d2.device), torch.inf, d2)
    nearest = torch.sort(d2, dim=1).values[:, :n_neighbors]
    scores = torch.sum(nearest, dim=1)
    if multi_k == 1:
        return grads[torch.argmin(scores)]
    idx = torch.argsort(scores, stable=True)[:multi_k]
    return torch.mean(grads[idx], dim=0)


def aggregate_medoid(grads: torch.Tensor) -> torch.Tensor:
    """The gradient minimizing total distance to all others."""
    scores = torch.sum(torch.sqrt(_pairwise_sq_dists(grads)), dim=1)
    return grads[torch.argmin(scores)]


def weiszfeld_update(y: torch.Tensor, g: torch.Tensor, alphas: torch.Tensor | None = None,
                     tol: float = 1e-6) -> torch.Tensor:
    """One *smoothed* (optionally weighted) Weiszfeld step: the weights
    ``a / max(dist, tol)`` stay finite when the iterate lands on a row, and
    the ``denom > 0`` guard only fires when every weight is zero."""
    dist = torch.linalg.vector_norm(g - y[None, :], dim=1)
    a = torch.ones(g.shape[:1], dtype=g.dtype, device=g.device) if alphas is None else alphas
    w = a / torch.clamp(dist, min=tol)
    denom = torch.sum(w)
    y_new = (w @ g) / torch.clamp(denom, min=1e-30)
    return torch.where(denom > 0, y_new, y)


def aggregate_geometric_median(grads: torch.Tensor, n_iters: int = 8,
                               eps: float = 1e-6) -> torch.Tensor:
    """Geometric median via smoothed Weiszfeld iterations, warm-started at
    the mean; ``eps`` is the distance floor of :func:`weiszfeld_update`."""
    g32 = grads.to(torch.float32)
    y = torch.mean(g32, dim=0)
    for _ in range(n_iters):
        y = weiszfeld_update(y, g32, tol=eps)
    return y.to(grads.dtype)


def simplex_project(y: torch.Tensor) -> torch.Tensor:
    """Euclidean projection onto the probability simplex (Duchi et al.
    2008): sort descending, cumulative sum, threshold."""
    n = y.shape[0]
    u = torch.sort(y, descending=True).values
    css = torch.cumsum(u, dim=0)
    j = torch.arange(1, n + 1, dtype=y.dtype, device=y.device)
    rho = torch.max(torch.where(u + (1.0 - css) / j > 0, j, 1.0))
    tau = (css[rho.to(torch.int64) - 1] - 1.0) / rho
    return torch.clamp(y - tau, min=0.0)


def aggregate_autogm(grads: torch.Tensor, lamb: float = 2.0, n_outer: int = 4,
                     n_inner: int = 8, eps: float = 1e-6) -> torch.Tensor:
    """AutoGM — auto-weighted geometric median (Li et al., IoT J. 2022):
    alternating minimization of Σᵢ αᵢ‖xᵢ − v‖ + λ‖α‖² over v and α ∈ Δ on
    a fixed schedule — ``n_outer`` rounds of (``n_inner`` α-weighted
    Weiszfeld steps, then α = proj_Δ(−dist / 2λ)), then a final v-step
    under the last weights.  Warm start at the mean."""
    g32 = grads.to(torch.float32)
    m = g32.shape[0]

    def v_steps(v, alphas):
        for _ in range(n_inner):
            v = weiszfeld_update(v, g32, alphas, tol=eps)
        return v

    v = torch.mean(g32, dim=0)
    alphas = torch.full((m,), 1.0 / m, dtype=torch.float32, device=g32.device)
    for _ in range(n_outer):
        v = v_steps(v, alphas)
        dist = torch.linalg.vector_norm(g32 - v[None, :], dim=1)
        alphas = simplex_project(-dist / (2.0 * lamb))
    v = v_steps(v, alphas)
    return v.to(grads.dtype)


AGGREGATORS: dict[str, Callable] = {
    "mean": aggregate_mean,
    "coordinate_median": aggregate_coordinate_median,
    "trimmed_mean": aggregate_trimmed_mean,
    "krum": aggregate_krum,
    "multi_krum": functools.partial(aggregate_krum, multi_k=4),
    "medoid": aggregate_medoid,
    "geometric_median": aggregate_geometric_median,
    "autogm": aggregate_autogm,
}


def get_aggregator(name: str, **kwargs) -> Callable:
    """Resolve a stateless aggregator by name with bound hyper-parameters
    (``krum``/``multi_krum`` need ``n_byzantine``)."""
    if name not in AGGREGATORS:
        raise KeyError(f"unknown aggregator {name!r}; have {sorted(AGGREGATORS)}")
    fn = AGGREGATORS[name]
    return functools.partial(fn, **kwargs) if kwargs else fn


def make_centered_clip(d: int, clip_tau: float = 10.0, clip_iters: int = 5,
                       device="cuda"):
    """Centered clipping (Karimireddy, He & Jaggi 2021): ``clip_iters``
    times per step, v ← v + (1/m) Σᵢ clip(xᵢ − v, τ) with clip(z, τ) =
    z·min(1, τ/‖z‖), around the center carried from the previous step
    (v₀ = 0).  Returns ``(state0, step)``."""
    state0 = torch.zeros((d,), dtype=torch.float32, device=device)

    def step(v: torch.Tensor, grads: torch.Tensor):
        g32 = grads.to(torch.float32)
        for _ in range(clip_iters):
            diff = g32 - v[None, :]
            nrm = torch.linalg.vector_norm(diff, dim=1)
            lam = torch.clamp(clip_tau / torch.clamp(nrm, min=1e-12), max=1.0)
            v = v + torch.mean(lam[:, None] * diff, dim=0)
        return v, v

    return state0, step


STATEFUL_AGGREGATORS: dict[str, Callable] = {
    "centered_clip": make_centered_clip,
}


def aggregator_names() -> tuple[str, ...]:
    """Every registered baseline aggregator, stateless and stateful."""
    return tuple(sorted(AGGREGATORS)) + tuple(sorted(STATEFUL_AGGREGATORS))


def bucket_means(grads: torch.Tensor, s: int, key: torch.Tensor) -> torch.Tensor:
    """(m, d) → (m/s, d): permute the worker rows with
    ``prng.permutation(key, m)`` and average disjoint groups of ``s``
    (Karimireddy, He & Jaggi 2022)."""
    m = grads.shape[0]
    if m % s:
        raise ValueError(f"bucketing needs s | m, got s={s}, m={m}")
    perm = prng.permutation(key, m)
    return torch.mean(grads[perm].reshape(m // s, s, -1), dim=1)
