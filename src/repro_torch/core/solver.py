"""Convex Byzantine-SGD driver — the counterpart of :mod:`repro.core.solver`.

Runs a :class:`Problem` for T iterations with m simulated workers, an
α-fraction of them Byzantine under a static attack, with the projected
step of Fact 2.5:

    x_{k+1} = Proj_{‖y − x_1‖ ≤ D} (x_k − η ξ_k)

where ξ_k comes from the Algorithm-1 guard (``aggregator="byzantine_sgd"``)
or the plain mean.  The JAX ``lax.scan`` becomes a Python step loop over
the same key chain: ``key, mask_key = split(key)``; per step ``rng, gkey,
akey = split(rng, 3)`` and ``worker_keys = split(gkey, m)``.  On a
generated problem the port therefore draws the reference's batches from
the same seed.  The loop never waits for the device; results are stacked
once at the end.

Not ported yet (they raise NotImplementedError): scenario adversaries,
telemetry, ``generate="kernel"``, ``sanitize``, staleness
(``max_delay``), partial participation and every baseline but the mean.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import prng, resolve_device
from repro_torch.core import aggregators as agg_lib
from repro_torch.core import attacks as attack_lib
from repro_torch.core.guard_backends import make_guard_backend


class Problem(NamedTuple):
    """A stochastic convex objective in the Section-2.1 model.

    Unlike the JAX ``Problem``, ``stoch_grad(worker_keys, x) -> (m, d)``
    takes the (m, 2) worker keys of one step and returns the whole batch
    (the JAX solver ``vmap``s a per-key sampler).  Every tensor lives on
    one device."""

    d: int
    f: Callable[[torch.Tensor], torch.Tensor]
    grad: Callable[[torch.Tensor], torch.Tensor]
    stoch_grad: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    x1: torch.Tensor
    x_star: torch.Tensor
    D: float
    V: float
    L: float = 1.0
    sigma: float = 0.0


class SolverConfig(NamedTuple):
    m: int                      # number of workers
    T: int                      # iterations
    eta: float                  # learning rate
    alpha: float = 0.0          # Byzantine fraction
    aggregator: str = "byzantine_sgd"
    attack: str = "sign_flip"
    attack_kwargs: tuple = ()   # (key, value) pairs
    mean_over_alive: bool = False
    delta: float = 1e-3
    threshold_mode: str = "anytime"
    guard_backend: str = "dense"  # 'dense' | 'fused'
    guard_opts: tuple = ()      # backend knobs as (key, value) pairs
    stats_dtype: str = "f32"    # 'f32' | 'bf16'
    max_delay: int = 0          # not ported: must stay 0
    partial_participation: bool = False  # not ported: must stay False
    generate: str = "off"       # not ported: must stay "off"
    sanitize: str = "off"       # not ported: must stay "off"

    @property
    def n_byzantine(self) -> int:
        # the adversary corrupts whole workers: floor
        return int(self.alpha * self.m)


class SolverResult(NamedTuple):
    x_final: torch.Tensor          # last iterate
    x_avg: torch.Tensor            # (1/T) Σ_{k≤T} x_k  (Theorem 3.8 average)
    gaps: torch.Tensor             # (T,) f(x_k) − f(x*)
    n_alive: torch.Tensor          # (T,) |good_k| (m for the mean)
    byz_mask: torch.Tensor         # (m,) workers that were ever Byzantine
    ever_filtered_good: torch.Tensor  # () bool
    final_alive: torch.Tensor      # (m,) bool


def byz_rank(key: torch.Tensor, m: int) -> torch.Tensor:
    """Random per-worker rank; worker w is Byzantine iff rank[w] < n_byz."""
    return torch.argsort(prng.permutation(key, m), stable=True)


def make_aggregator(problem: Problem, cfg: SolverConfig, device="cuda"):
    """Returns (init_state, step(state, grads, x, x1) -> (state, xi, n_alive, alive))."""
    if cfg.aggregator == "byzantine_sgd":
        return make_guard_backend(cfg.guard_backend, problem, cfg, device)
    fn = agg_lib.get_aggregator(cfg.aggregator)
    dev = resolve_device(device)
    n_alive = torch.tensor(cfg.m, device=dev)
    alive = torch.ones((cfg.m,), dtype=torch.bool, device=dev)

    def step(state, grads, x, x1):
        return state, fn(grads), n_alive, alive

    return None, step


def _check_supported(cfg: SolverConfig, adversary, telemetry) -> None:
    unported = {
        "a scenario adversary": adversary is not None,
        "telemetry": telemetry is not None,
        "generate='kernel'": cfg.generate != "off",
        "sanitize": cfg.sanitize != "off",
        "max_delay": cfg.max_delay != 0,
        "partial_participation": cfg.partial_participation,
    }
    missing = [name for name, on in unported.items() if on]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")


def run_sgd(problem: Problem, cfg: SolverConfig, key: torch.Tensor,
            adversary=None, telemetry=None, device="cuda") -> SolverResult:
    """Run one full optimization on ``device`` (the card unless the caller
    asks for the CPU).  ``key`` is a :func:`repro_torch.prng.PRNGKey`."""
    _check_supported(cfg, adversary, telemetry)
    dev = resolve_device(device)
    if problem.x1.device.type != dev.type:
        raise ValueError(f"problem lives on {problem.x1.device}, run asked for {dev}")
    key = key.to(dev)
    key, mask_key = prng.split(key)
    rank = byz_rank(mask_key, cfg.m)
    byz_mask = rank < cfg.n_byzantine
    attack_fn = attack_lib.get_attack(cfg.attack)
    attack_kwargs = dict(cfg.attack_kwargs)
    agg_state, agg_step = make_aggregator(problem, cfg, dev)

    x1 = problem.x1.to(torch.float32)
    x = x1
    x_sum = torch.zeros_like(x1)
    any_good_filtered = torch.zeros((), dtype=torch.bool, device=dev)
    f_star = problem.f(problem.x_star)
    rng = key
    gaps, n_alive_series = [], []
    for _ in range(cfg.T):
        rng, gkey, akey = prng.split(rng, 3)
        worker_keys = prng.split(gkey, cfg.m)
        grads = problem.stoch_grad(worker_keys, x)
        ctx = {"true_grad": problem.grad(x), "V": problem.V}
        grads = attack_fn(akey, grads, byz_mask, ctx, **attack_kwargs)
        agg_state, xi, n_alive, alive = agg_step(agg_state, grads, x, x1)

        x_new = x - cfg.eta * xi
        # Fact 2.5 projected step: ball of radius D around x_1
        delta = x_new - x1
        nrm = torch.linalg.vector_norm(delta)
        x_new = x1 + delta * torch.clamp(problem.D / torch.clamp(nrm, min=1e-30), max=1.0)

        # the gap is taken at x_k, before the update
        gaps.append(problem.f(x) - f_star)
        n_alive_series.append(n_alive)
        any_good_filtered = any_good_filtered | torch.any((~alive) & (~byz_mask))
        # Theorem-3.8 average over the iterates the gradients were taken
        # at: accumulate x_k, not x_{k+1}
        x_sum = x_sum + x
        x = x_new

    return SolverResult(
        x_final=x,
        x_avg=x_sum / cfg.T,
        gaps=torch.stack(gaps),
        n_alive=torch.stack(n_alive_series),
        byz_mask=byz_mask,
        ever_filtered_good=any_good_filtered,
        final_alive=alive,
    )
