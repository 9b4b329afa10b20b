"""Section-5 lower bounds as distinguishing experiments, the counterpart
of :mod:`repro.core.lower_bound`.

Theorem 5.4 (linear) and Theorem 5.5 (strongly convex) reduce
ε-optimization to telling apart two sample distributions whose means
differ by O(α): the Byzantine workers are honest workers of the mirror
objective.  Far below T ≈ α²V²D²/ε² no algorithm can tell which objective
made the data, so ByzantineSGD's success rate over random cases stays
near 1/2; far above it, it goes to 1.

Each trial draws, from ``ck, sk, mk = split(tk, 3)`` of ``split(key,
n_trials)``: the case (``bernoulli(ck)``), the (T, m) honest noise
(``normal(sk, (T, m))``) and the Byzantine set (a prefix of ⌊αm⌋ workers
under ``permutation(mk, m)``), and runs the dense
:class:`~repro_torch.core.byzantine_sgd.ByzantineGuard` at d = 1 for T
steps.  The JAX package ``vmap``s its trials; the port ``torch.func.vmap``s
the guard's step over a leading trial axis, so the T steps run once for
all trials (the permutations are drawn in a loop over trials).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch import prng, resolve_device
from repro_torch.core.byzantine_sgd import ByzantineGuard, GuardConfig, GuardState


class LowerBoundResult(NamedTuple):
    success_rate: float     # fraction of trials where the case was identified (exact
    #                         quotient; the JAX package's is an f32 mean)
    threshold_T: float      # the theory threshold α²V²D²/ε² (or its SC analogue)


def _trial_draws(key: torch.Tensor, m: int, T: int, n_trials: int, alpha: float):
    """Per trial: the case (n,) bool, the (n, T, m) standard normal noise
    and the (n, m) Byzantine mask."""
    ck, sk, mk = prng.split(prng.split(key, n_trials), 3).unbind(dim=1)
    case = prng.bernoulli(ck)
    noise = prng.normal(sk, (T, m))
    n_byz = int(np.floor(np.float32(alpha * m)))
    prefix = torch.arange(m, device=key.device) < n_byz
    byz = torch.stack([prefix[prng.permutation(k, m)] for k in mk])
    return case, noise, byz


def _run_trials(grads_at: Callable, samples: torch.Tensor, D: float, V: float, eta: float,
                delta: float) -> torch.Tensor:
    """The 1-D guard over every trial at once: step k hands the guard
    ``grads_at(x, samples[:, k])`` ((n, m, 1) worker messages at the
    trials' iterates x (n, 1)), clips x − η ξ to [−D, D] and sums the new
    iterates.  Returns x̄ (n,)."""
    n, T, m = samples.shape
    dev = samples.device
    guard = ByzantineGuard(GuardConfig(m=m, T=T, V=V, D=D, delta=delta), device=dev)
    s0 = guard.init(1)
    A, B, alive, gram_B = (t.expand(n, *t.shape).clone()
                           for t in (s0.A, s0.B, s0.alive, s0.gram_B))
    x1 = torch.zeros((1,), dtype=torch.float32, device=dev)
    x = torch.zeros((n, 1), dtype=torch.float32, device=dev)
    x_sum = torch.zeros_like(x)
    for k in range(T):
        def step(A, B, alive, gram_B, grads, x, k=k):
            state, xi, _ = guard.step(GuardState(A=A, B=B, alive=alive, k=k, gram_B=gram_B),
                                      grads, x, x1)
            return state.A, state.B, state.alive, state.gram_B, xi

        grads = grads_at(x, samples[:, k])
        A, B, alive, gram_B, xi = vmap(step)(A, B, alive, gram_B, grads, x)
        x = torch.clamp(x - eta * xi, -D, D)
        x_sum = x_sum + x
    return (x_sum / T)[:, 0]


def distinguishing_experiment_linear(key: torch.Tensor, m: int = 16, T: int = 256,
                                     n_trials: int = 32, alpha: float = 0.25, D: float = 1.0,
                                     V: float = 1.0, eps: float = 0.05,
                                     eta: float | None = None, delta: float = 1e-3,
                                     device="cuda") -> LowerBoundResult:
    """Theorem 5.4 experiment: f_±(x) = ±εx/D on [−D, D]; honest samples
    s ~ N(±ε/(DV), 1) send the gradient s·V, the Byzantine ones the mirror
    s ∓ 2ε/(DV).  A trial wins when x̄ < 0 exactly in the case f_+."""
    dev = resolve_device(device)
    if eta is None:
        eta = D / (V * (T ** 0.5))
    case, noise, byz = _trial_draws(key.to(dev), m, T, n_trials, alpha)
    mu = torch.where(case, eps / (D * V), -eps / (D * V))[:, None, None]
    s = noise + mu
    samples = torch.where(byz[:, None, :], s - 2.0 * mu, s) * V
    xbar = _run_trials(lambda x, g: g[:, :, None], samples, D, V, eta, delta)
    wins = (xbar < 0.0) == case
    rate = int(torch.sum(wins)) / n_trials
    return LowerBoundResult(success_rate=rate,
                            threshold_T=(alpha ** 2) * (V ** 2) * (D ** 2) / (eps ** 2))


def distinguishing_experiment_strongly_convex(key: torch.Tensor, m: int = 16, T: int = 256,
                                              n_trials: int = 32, alpha: float = 0.25,
                                              sigma: float = 1.0, V: float = 1.0,
                                              eps_hat: float = 0.05, eta: float | None = None,
                                              delta: float = 1e-3,
                                              device="cuda") -> LowerBoundResult:
    """Theorem 5.5 experiment: f_±(x) = σ/2 (x ∓ ε̂)² on [−10ε̂, 10ε̂];
    honest samples s = ±ε̂ + (V/σ)·N(0, 1), the gradient σ(x − s) taken at
    the current iterate.  A trial wins when the sign of x̄ is the case's."""
    dev = resolve_device(device)
    if eta is None:
        eta = 1.0 / (2.0 * sigma)
    D = 10.0 * eps_hat
    case, noise, byz = _trial_draws(key.to(dev), m, T, n_trials, alpha)
    mu = torch.where(case, eps_hat, -eps_hat)[:, None, None]
    s = mu + (V / sigma) * noise
    samples = torch.where(byz[:, None, :], s - 2.0 * mu, s)
    xbar = _run_trials(lambda x, srow: (sigma * (x - srow))[:, :, None], samples, D, V, eta,
                       delta)
    wins = (xbar > 0.0) == case
    rate = int(torch.sum(wins)) / n_trials
    return LowerBoundResult(success_rate=rate,
                            threshold_T=(alpha ** 2) * (V ** 2) / (sigma ** 2 * eps_hat ** 2))
