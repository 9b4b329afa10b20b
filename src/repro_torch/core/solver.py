"""Convex Byzantine-SGD driver — the counterpart of :mod:`repro.core.solver`.

Runs a :class:`Problem` for T iterations with m simulated workers, an
α-fraction of them Byzantine under a static attack, with the projected
step of Fact 2.5:

    x_{k+1} = Proj_{‖y − x_1‖ ≤ D} (x_k − η ξ_k)

where ξ_k comes from the Algorithm-1 guard (``aggregator="byzantine_sgd"``)
or a baseline aggregator of :mod:`repro_torch.core.aggregators` (stateless,
stateful, or composed with bucketing as ``bucket<s>:<base>``).  The JAX
``lax.scan`` becomes a Python step loop over the same key chain:
``key, mask_key = split(key)``; per step ``rng, gkey, akey = split(rng,
3)`` and ``worker_keys = split(gkey, m)``.  On a
generated problem the port therefore draws the reference's batches from
the same seed.  The loop never waits for the device; results are stacked
once at the end.

``sanitize="quarantine"`` (DESIGN.md §15) puts the quarantine stage in
front of every aggregator: the guard backends zero non-finite entries in
their sweeps and drop the rows that held them for good; every baseline
(and ``bucket<s>:<base>``) sees those entries zeroed and reports the rows
dead for the step.  On finite input it changes no bit of the result.

Not ported yet (they raise NotImplementedError): scenario adversaries
(and with them fault plans in ``run_sgd``), telemetry and
``generate="kernel"``.  Staleness (``max_delay``) and partial participation
act only through an adversary's worker profile, so without one they are
ignored, as in the JAX package.
"""
from __future__ import annotations

import functools
import inspect
import math
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


def ceil_byzantine_count(alpha: float, m: int) -> int:
    """max(⌈αm⌉, 1) — the *covering* Byzantine count that defense
    parameters (Krum's f, the trimmed mean's count) round up to, while the
    adversary's realized count floors; the epsilon guards f32 grid alphas
    landing just above an integer."""
    return max(math.ceil(alpha * m - 1e-9), 1)


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
    krum_f: int | None = None   # override Krum's f (defaults to ⌈αm⌉)
    trim_fraction: float | None = None  # defaults to the ceil convention
    guard_backend: str = "dense"  # 'dense' | 'fused' | 'dp_exact' | 'dp_sketch'
    guard_opts: tuple = ()      # backend knobs as (key, value) pairs
    stats_dtype: str = "f32"    # 'f32' | 'bf16'
    agg_opts: tuple = ()        # baseline knobs as (key, value) pairs, e.g.
    #                             clip_tau for centered_clip, bucket_seed
    #                             for bucket<s>:<base>; each rule receives
    #                             only the knobs it declares
    max_delay: int = 0          # ignored without a scenario adversary
    partial_participation: bool = False  # ignored without a scenario adversary
    generate: str = "off"       # "off"; "kernel" is not ported yet
    sanitize: str = "off"       # "off" | "quarantine": zero non-finite
    #                             gradient entries before the aggregator and
    #                             report their rows dead (DESIGN.md §15)

    @property
    def n_byzantine(self) -> int:
        # the adversary corrupts whole workers: floor
        return int(self.alpha * self.m)

    @property
    def krum_f_default(self) -> int:
        """⌈αm⌉: Krum's f must cover the Byzantine count, so it rounds up."""
        return ceil_byzantine_count(self.alpha, self.m)


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


def parse_aggregator_spec(name: str) -> tuple[int | None, str]:
    """``"bucket2:krum"`` → ``(2, "krum")``; ``"krum"`` → ``(None, "krum")``.
    The base may be any spec, another bucketing layer included."""
    head, sep, base = name.partition(":")
    if sep and head.startswith("bucket"):
        try:
            s = int(head[len("bucket"):])
        except ValueError:
            raise KeyError(f"malformed bucketing spec {name!r}; "
                           "expected 'bucket<s>:<base>'") from None
        if s < 1:
            raise KeyError(f"bucketing needs s >= 1, got {name!r}")
        return s, base
    return None, name


def _declared_knobs(target) -> set[str]:
    """Parameter names ``target`` accepts beyond its data arguments (and
    the port's own ``device``, which is not a knob)."""
    sig = inspect.signature(target)
    return {p.name for p in sig.parameters.values()
            if p.kind in (p.KEYWORD_ONLY, p.POSITIONAL_OR_KEYWORD)
            and p.name not in ("grads", "d", "device")}


def _validate_agg_opts(opts: dict) -> None:
    """KeyError on knobs no registered aggregator declares: one tuple
    serves a whole sweep (knobs of other rules drop silently), typos fail
    before the first step."""
    known = {"bucket_seed"}
    for fn in agg_lib.AGGREGATORS.values():
        known |= _declared_knobs(fn)
    for factory in agg_lib.STATEFUL_AGGREGATORS.values():
        known |= _declared_knobs(factory)
    unknown = set(opts) - known
    if unknown:
        raise KeyError(f"unknown agg_opts {sorted(unknown)}; "
                       f"known knobs: {sorted(known)}")


def _sanitized(step4):
    """The quarantine stage in front of a baseline step: non-finite entries
    are zeroed before the rule sees them and their rows are reported dead
    for the step (baselines keep no membership; the guards carry theirs)."""

    def step(state, grads, x, x1, report=None):
        fin = torch.isfinite(grads)
        finite = torch.all(fin, dim=1)
        state, xi, _, alive = step4(state, torch.where(fin, grads, 0.0), x, x1, report)
        alive = alive & finite
        return state, xi, torch.sum(alive, dtype=torch.int32), alive

    return step


def make_aggregator(problem: Problem, cfg: SolverConfig, device="cuda"):
    """Returns (init_state, step(state, grads, x, x1, report=None) -> (state,
    xi, n_alive, alive)).

    ``byzantine_sgd`` goes to the guard backends.  Stateless baselines
    carry no state; stateful ones (:data:`~repro_torch.core.aggregators.
    STATEFUL_AGGREGATORS`) carry theirs from step to step.  A
    ``bucket<s>:<base>`` spec permutes the worker rows with a carried key,
    averages them in groups of s and hands the m/s bucket means to the base
    rule, built at m/s workers with its Byzantine sizing raised to the
    min(s·α, 1/2) contaminated-bucket fraction.  Baselines and bucketing
    report every worker alive, but for the rows the quarantine stage drops
    under ``sanitize="quarantine"``; the bucket rule's inner aggregator is
    built with the same ``sanitize``.  Baselines ignore ``report``."""
    opts = dict(cfg.agg_opts)
    _validate_agg_opts(opts)
    if cfg.sanitize not in ("off", "quarantine"):
        raise ValueError(f"sanitize must be 'off' or 'quarantine', got {cfg.sanitize!r}")
    wrap = _sanitized if cfg.sanitize == "quarantine" else (lambda step4: step4)
    bucket_s, name = parse_aggregator_spec(cfg.aggregator)
    dev = resolve_device(device)
    n_alive = torch.tensor(cfg.m, device=dev)
    alive = torch.ones((cfg.m,), dtype=torch.bool, device=dev)

    if bucket_s is not None:
        if cfg.m % bucket_s:
            raise ValueError(f"bucketing needs s | m, got s={bucket_s}, m={cfg.m}")
        inner_cfg = cfg._replace(aggregator=name, m=cfg.m // bucket_s,
                                 alpha=min(cfg.alpha * bucket_s, 0.5))
        inner_state0, inner_step = make_aggregator(problem, inner_cfg, dev)
        state0 = (prng.PRNGKey(int(opts.get("bucket_seed", 0)), device=dev), inner_state0)

        def bucket_step(state, grads, x, x1, report=None):
            key, inner = state
            key, sub = prng.split(key)
            buckets = agg_lib.bucket_means(grads, bucket_s, sub)
            inner, xi, _, _ = inner_step(inner, buckets, x, x1)
            return (key, inner), xi, n_alive, alive

        return state0, wrap(bucket_step)

    if name == "byzantine_sgd":
        return make_guard_backend(cfg.guard_backend, problem, cfg, dev)

    if name in agg_lib.STATEFUL_AGGREGATORS:
        factory = agg_lib.STATEFUL_AGGREGATORS[name]
        fkwargs = {k: v for k, v in opts.items() if k in _declared_knobs(factory)}
        state0, agg_step = factory(problem.d, device=dev, **fkwargs)

        def stateful_step(state, grads, x, x1, report=None):
            state, xi = agg_step(state, grads)
            return state, xi, n_alive, alive

        return state0, wrap(stateful_step)

    kwargs = {}
    if name in ("krum", "multi_krum"):
        kwargs["n_byzantine"] = cfg.krum_f if cfg.krum_f is not None else cfg.krum_f_default
    if name == "trimmed_mean":
        # the ceil convention (cover ⌈αm⌉ per side), capped so that a
        # near-1/2 α leaves at least one value
        kwargs["trim_fraction"] = (
            cfg.trim_fraction if cfg.trim_fraction is not None
            else min(ceil_byzantine_count(cfg.alpha, cfg.m), (cfg.m - 1) // 2) / cfg.m)
    fn = agg_lib.get_aggregator(name)
    kwargs.update({k: v for k, v in opts.items() if k in _declared_knobs(fn)})
    fn = functools.partial(fn, **kwargs) if kwargs else fn

    def step(state, grads, x, x1, report=None):
        return state, fn(grads), n_alive, alive

    return None, wrap(step)


def _check_supported(cfg: SolverConfig, adversary, telemetry) -> None:
    if cfg.generate not in ("off", "kernel"):
        raise ValueError(f"generate must be 'off' or 'kernel', got {cfg.generate!r}")
    unported = {
        "a scenario adversary": adversary is not None,
        "telemetry": telemetry is not None,
        "generate='kernel'": cfg.generate == "kernel",
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
        # the aggregator's carried membership where it keeps one (the
        # guards), else everyone: a baseline's per-step quarantine drop is
        # not a membership
        final_alive=(agg_state.alive if hasattr(agg_state, "alive")
                     else torch.ones((cfg.m,), dtype=torch.bool, device=dev)),
    )
