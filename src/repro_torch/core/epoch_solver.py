"""Section-4 epoch solver for σ-strongly-convex objectives, the
counterpart of :mod:`repro.core.epoch_solver`.

Epoch p starts at x^{(p−1)} with ‖x^{(p−1)} − x*‖ ≤ D_{p−1} and runs
Theorem-3.8 SGD (:func:`~repro_torch.core.solver.run_sgd`) from there
until f(x^{(p)}) − f(x*) ≤ σ D_p² / 2, which by strong convexity gives the
next radius D_p = D_{p−1}/2.  P = ⌈log₂ √(σD²/2ε)⌉ epochs reach ε.  T_p
is the Theorem-3.8 bound's iteration count times ``t_scale``.  Everything
here is host arithmetic but the runs, which stay on ``device``; each
epoch's gap is read back once.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import prng
from repro_torch.core.solver import Problem, SolverConfig, run_sgd
from repro_torch.utils import log_c


class EpochSolverConfig(NamedTuple):
    m: int
    alpha: float = 0.0
    epsilon: float = 1e-3
    aggregator: str = "byzantine_sgd"
    attack: str = "sign_flip"
    attack_kwargs: tuple = ()
    delta: float = 1e-3
    t_scale: float = 1.0        # scale on the theory iteration count
    max_t_per_epoch: int = 200_000


class EpochResult(NamedTuple):
    x: torch.Tensor
    total_iters: int
    epochs: int
    per_epoch_T: list
    per_epoch_gap: list


def theory_iterations(L: float, sigma: float, D: float, V: float, m: int, alpha: float,
                      eps: float, delta: float, t_scale: float) -> int:
    """Smallest T making the Theorem-3.8 bound ≤ eps with η = 1/(2L),
    scaled by t_scale: a doubling search, then 20 halvings (the bound is
    monotone in T)."""
    eta = 1.0 / (2.0 * L)

    def bound(T: float) -> float:
        C = log_c(m, max(int(T), 1), delta)
        term_gd = D * D / (eta * T)
        term_stat = 8.0 * D * V * math.sqrt(C / (T * m))
        term_byz = 32.0 * alpha * D * V * math.sqrt(C / T)
        term_var = eta * (8.0 * V * V * C / m + 32.0 * alpha * alpha * V * V)
        return term_gd + term_stat + term_byz + term_var

    T = 1.0
    while bound(T) > eps and T < 1e12:
        T *= 2.0
    lo, hi = T / 2.0, T
    for _ in range(20):
        mid = 0.5 * (lo + hi)
        if bound(mid) > eps:
            lo = mid
        else:
            hi = mid
    return max(1, int(hi * t_scale))


def solve_strongly_convex(problem: Problem, cfg: EpochSolverConfig, key: torch.Tensor,
                          device="cuda") -> EpochResult:
    """The Section-4 reduction on ``device``.  ``problem.sigma`` must be > 0."""
    if not problem.sigma > 0:
        raise ValueError("the epoch solver needs a strongly convex problem (sigma > 0)")
    sigma, D0 = problem.sigma, problem.D
    P = max(1, math.ceil(math.log2(math.sqrt(sigma * D0 * D0 / (2 * cfg.epsilon)))))
    L = max(problem.L, problem.sigma)
    key = key.to(problem.x1.device)

    x = problem.x1
    total, per_T, per_gap = 0, [], []
    for p in range(1, P + 1):
        D_prev = D0 * (2.0 ** -(p - 1))
        D_p = D0 * (2.0 ** -p)
        eps_p = sigma * D_p * D_p / 2.0
        T_p = min(theory_iterations(L, sigma, D_prev, problem.V, cfg.m, cfg.alpha, eps_p,
                                    cfg.delta, cfg.t_scale),
                  cfg.max_t_per_epoch)
        scfg = SolverConfig(m=cfg.m, T=T_p, eta=1.0 / (2.0 * L), alpha=cfg.alpha,
                            aggregator=cfg.aggregator, attack=cfg.attack,
                            attack_kwargs=cfg.attack_kwargs, delta=cfg.delta)
        key, sub_key = prng.split(key)
        res = run_sgd(problem._replace(x1=x, D=D_prev), scfg, sub_key, device=device)
        x = res.x_avg
        total += T_p
        per_T.append(T_p)
        per_gap.append(float(problem.f(x) - problem.f(problem.x_star)))
    return EpochResult(x=x, total_iters=total, epochs=P, per_epoch_T=per_T,
                       per_epoch_gap=per_gap)
