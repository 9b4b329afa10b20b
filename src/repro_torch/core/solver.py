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

``adversary=`` takes a :class:`repro_torch.scenarios.adversary.
ScenarioAdversary` in place of the static ``cfg.attack``/``cfg.alpha``
pair: its ``mask_at`` schedule gives each step's Byzantine set, its
``attack`` the rows, and its state is updated from the feedback after each
aggregation.  Every attack receives ``ctx`` with the previous step's
feedback: ``step``, ``alive``, ``n_alive``, ``prev_xi``.  ``byz_mask`` is
the union of the step masks.

``generate="kernel"`` (DESIGN.md §14, with a scenario adversary,
``aggregator="byzantine_sgd"`` and ``guard_backend="fused"`` on a
counter-generatable problem) never builds the (m, d) batch: each step
hands the guard the worker keys and the adversary's O(m) attack
parameters, and the two generating kernels rebuild the rows.  The key
chain is the materialising path's, ``akey`` included, so both paths see
the same noise step for step.

A :class:`~repro_torch.scenarios.spec.WorkerProfile` on the adversary
(DESIGN.md §13) arms three axes, each only where its switch is set, as in
the JAX package: heterogeneous sampling through ``Problem.het_grad`` (on
the generating path the rank-1 ``skew·het_sign`` goes to the kernels),
staleness (``cfg.max_delay > 0``: an (m, d) f32 buffer holds each
worker's last fresh row between its refreshes) and partial participation
(``cfg.partial_participation``: the step's reporting mask, drawn from
``fold_in(akey, 7919)``, goes to the aggregator, and
``SolverResult.n_reporting`` counts the reporters).  Without a profile
``max_delay`` and ``partial_participation`` are ignored.  A
:class:`~repro_torch.scenarios.faults.FaultPlan` on the adversary
corrupts rows after the attack, keyed by ``fold_in(akey,
FAULT_KEY_TAG)``, and its victims join ``byz_mask``.

``telemetry=`` (a :class:`repro_torch.obs.TelemetryConfig`, DESIGN.md
§12) arms the guard flight recorder: the aggregator's step runs in its
probed form, and its frame, completed here with ``step``, ‖ξ_k‖, the
adversary's ``adapt_scale`` and, where their axes are armed,
``n_reporting`` and ``staleness``, goes into a ring on the device; the
per-worker first-filter step and the per-step count of surviving
Byzantine workers ride along.  ``SolverResult.telemetry`` holds all three
(:class:`repro_torch.obs.Telemetry`); nothing waits for the device until
the caller reads the ring (``ring_read``).  ``None`` or ``enabled=False``
runs the step as without the recorder; armed, it changes no decision and
no kernel launch, since the frames only read the guard's own diagnostics.
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
from repro_torch.kernels import gradgen
from repro_torch.obs.telemetry import (
    Telemetry,
    baseline_frame,
    ring_init,
    ring_push,
    telemetry_on,
)
from repro_torch.scenarios import faults as faults_mod


class Problem(NamedTuple):
    """A stochastic convex objective in the Section-2.1 model.

    Unlike the JAX ``Problem``, ``stoch_grad(worker_keys, x) -> (m, d)``
    takes the (m, 2) worker keys of one step and returns the whole batch
    (the JAX solver ``vmap``s a per-key sampler), and so does the non-iid
    sampler ``het_grad(worker_keys, x, skew) -> (m, d)`` with ``skew`` the
    (m,) per-worker magnitudes (:func:`repro_torch.data.problems.
    heterogenize_problem`); ``het`` is its provenance ``{'V0', 'cmax',
    'skew_max'}``.  Every tensor lives on one device."""

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
    het_grad: Callable | None = None  # (worker_keys, x, skew) -> (m, d), non-iid
    het: dict | None = None           # {'V0', 'cmax', 'skew_max'} provenance
    gen: object = None   # kernels.gradgen.GenSpec on a counter-generatable problem


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
    max_delay: int = 0          # ignored without a worker profile
    partial_participation: bool = False  # ignored without a worker profile
    generate: str = "off"       # "off" | "kernel": rebuild the batch inside
    #                             the fused guard's kernels (DESIGN.md §14)
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
    n_reporting: torch.Tensor | None = None  # (T,) int32 reporters a step under
    #                                          partial participation, else None
    telemetry: Telemetry | None = None  # the flight recorder's ring and series
    #                                     when armed, else None


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


def _probed(step4, m: int, sanitize: bool):
    """A baseline step with the flight recorder's frame as a fifth output:
    who survived, and under the quarantine how many rows held NaN/Inf."""

    def step(state, grads, x, x1, report=None):
        state, xi, n_alive, alive = step4(state, grads, x, x1, report)
        frame = baseline_frame(m, alive, n_alive)
        if sanitize:
            frame["n_nonfinite"] = torch.sum(~torch.all(torch.isfinite(grads), dim=1))
        return state, xi, n_alive, alive, frame

    return step


def make_aggregator(problem: Problem, cfg: SolverConfig, device="cuda", telemetry=None):
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
    built with the same ``sanitize``.  Baselines ignore ``report``.

    ``telemetry`` armed gives every step its probed form, with the flight
    recorder's frame as a fifth output (a generating guard step: sixth):
    the guard backends fill the filter's forensics, baselines and
    bucketing the alive mask and n_alive (and ``n_nonfinite`` under the
    quarantine)."""
    opts = dict(cfg.agg_opts)
    _validate_agg_opts(opts)
    if cfg.sanitize not in ("off", "quarantine"):
        raise ValueError(f"sanitize must be 'off' or 'quarantine', got {cfg.sanitize!r}")
    san_on = cfg.sanitize == "quarantine"
    probe = telemetry_on(telemetry)

    def wrap(step4):
        if san_on:
            step4 = _sanitized(step4)
        return _probed(step4, cfg.m, san_on) if probe else step4

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
        return make_guard_backend(cfg.guard_backend, problem, cfg, dev, telemetry)

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


def _check_supported(problem: Problem, cfg: SolverConfig, adversary) -> None:
    """The JAX package's ``ValueError`` gates of ``generate="kernel"``."""
    if cfg.generate not in ("off", "kernel"):
        raise ValueError(f"generate must be 'off' or 'kernel', got {cfg.generate!r}")
    if cfg.generate == "kernel":
        if problem.gen is None:
            raise ValueError("generate='kernel' needs a counter-generatable problem "
                             "(make_generated_problem)")
        if adversary is None or not hasattr(adversary, "gen_attack_ctx"):
            raise ValueError("generate='kernel' needs a scenario adversary "
                             "(ScenarioAdversary): the static attack path is not "
                             "parameterized for in-kernel generation")
        if cfg.aggregator != "byzantine_sgd" or cfg.guard_backend != "fused":
            raise ValueError("generate='kernel' requires aggregator='byzantine_sgd' with "
                             f"guard_backend='fused', got {cfg.aggregator!r}/"
                             f"{cfg.guard_backend!r}")
        if cfg.max_delay or cfg.partial_participation:
            raise ValueError("generate='kernel' does not compose with staleness buffers or "
                             "partial participation (both need the materialized batch)")
        if getattr(adversary, "faults", None) is not None or cfg.sanitize != "off":
            raise ValueError("generate='kernel' does not compose with fault injection or "
                             "sanitize='quarantine' (both need the materialized batch)")
        if (getattr(adversary, "profile", None) is not None and problem.het_grad is not None
                and problem.gen.het_sign is None):
            raise ValueError("generate='kernel' with a heterogeneous profile needs "
                             "heterogenize_generated (rank-1 skew); heterogenize_problem's "
                             "dense bias cannot stream through a strip")
        ids = (adversary.scenario.attack_a, adversary.scenario.attack_b)
        bad = [i for i in ids if i not in gradgen.GEN_SUPPORTED_IDS]
        if bad:
            raise ValueError(f"attack ids {bad} are not in-kernel generatable "
                             f"(supported: {gradgen.GEN_SUPPORTED_IDS})")


def run_sgd(problem: Problem, cfg: SolverConfig, key: torch.Tensor,
            adversary=None, telemetry=None, device="cuda") -> SolverResult:
    """Run one full optimization on ``device`` (the card unless the caller
    asks for the CPU).  ``key`` is a :func:`repro_torch.prng.PRNGKey`;
    ``adversary`` a :class:`~repro_torch.scenarios.adversary.
    ScenarioAdversary` or None (the static ``cfg.attack``); ``telemetry``
    a :class:`repro_torch.obs.TelemetryConfig` or None (module
    docstring)."""
    tel_on = telemetry_on(telemetry)
    _check_supported(problem, cfg, adversary)
    dev = resolve_device(device)
    if problem.x1.device.type != dev.type:
        raise ValueError(f"problem lives on {problem.x1.device}, run asked for {dev}")
    # the per-worker and fault axes, each a host decision as in the JAX
    # package: a run without its switch never touches its machinery
    profile = getattr(adversary, "profile", None)
    if profile is not None and profile.skew.device.type != dev.type:
        raise ValueError(f"worker profile lives on {profile.skew.device}, run asked for {dev}")
    het_on = profile is not None and problem.het_grad is not None
    stale_on = profile is not None and cfg.max_delay > 0
    part_on = profile is not None and cfg.partial_participation
    fault_plan = getattr(adversary, "faults", None)
    gen_on = cfg.generate == "kernel"
    key = key.to(dev)
    key, mask_key = prng.split(key)
    rank = byz_rank(mask_key, cfg.m)
    if adversary is None:
        static_mask = rank < cfg.n_byzantine
        attack_fn = attack_lib.get_attack(cfg.attack)
        attack_kwargs = dict(cfg.attack_kwargs)
        adv_state = None
    else:
        adv_state = adversary.init_state(cfg.m, problem.d, device=dev)
    agg_state, agg_step = make_aggregator(problem, cfg, dev, telemetry)

    x1 = problem.x1.to(torch.float32)
    x = x1
    x_sum = torch.zeros_like(x1)
    ever_byz = torch.zeros((cfg.m,), dtype=torch.bool, device=dev)
    any_good_filtered = torch.zeros((), dtype=torch.bool, device=dev)
    # the previous step's filter feedback: zeros / all alive at step 0
    prev_xi = torch.zeros_like(x1)
    prev_alive = torch.ones((cfg.m,), dtype=torch.bool, device=dev)
    prev_n_alive = torch.tensor(cfg.m, device=dev)
    f_star = problem.f(problem.x_star)
    if gen_on:
        # the rank-1 skew of a heterogeneous profile, zero for an iid fleet
        skewsign = (profile.skew * problem.gen.het_sign if het_on
                    else torch.zeros((cfg.m,), dtype=torch.float32, device=dev))
    if stale_on:
        # each worker's last fresh row; every schedule fires at k = 0, so
        # the zeros are never read
        buf = torch.zeros((cfg.m, problem.d), dtype=torch.float32, device=dev)
    if tel_on:
        ring = ring_init(cfg.m, telemetry.ring_size, dev)
        # first step (1-based) each worker left good_k; -1 = never
        ffs = torch.full((cfg.m,), -1, dtype=torch.int32, device=dev)
        byz_alive = []
    rng = key
    gaps, n_alive_series, n_reporting = [], [], []
    for k in range(cfg.T):
        rng, gkey, akey = prng.split(rng, 3)
        worker_keys = prng.split(gkey, cfg.m)
        ctx = {"true_grad": problem.grad(x), "V": problem.V, "step": k,
               "alive": prev_alive, "n_alive": prev_n_alive, "prev_xi": prev_xi}
        if gen_on:
            # no (m, d) batch: the guard's kernels rebuild every row from
            # the worker keys; akey is split all the same so the stream
            # matches the materialising path's step for step
            mask_k = adversary.mask_at(rank, k)
            slot, params, w_byz = adversary.gen_attack_ctx(mask_k, ctx, adv_state,
                                                           problem.gen.noise_scale)
            genctx = gradgen.GenStepCtx(worker_keys=worker_keys, skewsign=skewsign, slot=slot,
                                        params=params, w_byz=w_byz)
            agg_state, xi, n_alive, alive, byz_sum, *frame = agg_step(agg_state, genctx, x, x1)
            byz_row = byz_sum / torch.clamp(torch.sum(mask_k), min=1)
            adv_state = adversary.update_state_from_byz_row(adv_state, mask_k, byz_row, xi,
                                                            alive, n_alive, ctx)
        else:
            if het_on:
                # worker w draws around ∇f + skew[w]·C[w], from the iid
                # sampler's stream: skew 0 gives its rows bit for bit
                grads = problem.het_grad(worker_keys, x, profile.skew)
            else:
                grads = problem.stoch_grad(worker_keys, x)
            if stale_on:
                # between refreshes a worker reports the row it computed
                # at an older iterate
                buf = torch.where(adversary.refresh_at(k, cfg.max_delay)[:, None], grads, buf)
                grads = buf
            if adversary is None:
                mask_k = static_mask
                grads = attack_fn(akey, grads, mask_k, ctx, **attack_kwargs)
            else:
                mask_k = adversary.mask_at(rank, k)
                grads = adversary.attack(akey, grads, mask_k, ctx, adv_state)
            if fault_plan is not None:
                # machine faults land after the attack, on the top ranks;
                # fold_in leaves the gkey/akey streams as they are
                fkey = prng.fold_in(akey, faults_mod.FAULT_KEY_TAG)
                grads = faults_mod.apply_fault_plan(fault_plan, fkey, grads, rank, k)
                ever_byz = ever_byz | faults_mod.fault_rows(fault_plan, rank, k)
            report = None
            if part_on:
                # who reports is drawn apart from the Byzantine mask:
                # Byzantine workers always report
                report = adversary.report_at(prng.fold_in(akey, 7919), mask_k)
                n_reporting.append(torch.sum(report, dtype=torch.int32))
            agg_state, xi, n_alive, alive, *frame = agg_step(agg_state, grads, x, x1, report)
            if adversary is not None:
                adv_state = adversary.update_state(adv_state, mask_k, grads, xi, alive,
                                                   n_alive, ctx)

        x_new = x - cfg.eta * xi
        # Fact 2.5 projected step: ball of radius D around x_1
        delta = x_new - x1
        nrm = torch.linalg.vector_norm(delta)
        x_new = x1 + delta * torch.clamp(problem.D / torch.clamp(nrm, min=1e-30), max=1.0)

        # the gap is taken at x_k, before the update
        gaps.append(problem.f(x) - f_star)
        n_alive_series.append(n_alive)
        # fault victims count as Byzantine (folded in above), so the
        # sanitizer killing them is not an honest worker filtered
        ever_byz = ever_byz | mask_k
        any_good_filtered = any_good_filtered | torch.any((~alive) & (~ever_byz))
        if tel_on:
            # the aggregator's frame completed with the solver's signals
            frame = frame[0]
            frame["step"] = k + 1
            frame["xi_norm"] = torch.linalg.vector_norm(xi)
            scale = getattr(adv_state, "adapt_scale", None)
            if scale is not None:
                frame["adapt_scale"] = scale
            if part_on:
                frame["n_reporting"] = n_reporting[-1]
            if stale_on:
                frame["staleness"] = torch.mean(
                    adversary.staleness_at(k, cfg.max_delay).to(torch.float32))
            ring = ring_push(ring, frame)
            ffs = torch.where((ffs < 0) & ~alive, k + 1, ffs)
            byz_alive.append(torch.sum(alive & mask_k, dtype=torch.int32))
        prev_xi, prev_alive, prev_n_alive = xi, alive, n_alive
        # Theorem-3.8 average over the iterates the gradients were taken
        # at: accumulate x_k, not x_{k+1}
        x_sum = x_sum + x
        x = x_new

    return SolverResult(
        x_final=x,
        x_avg=x_sum / cfg.T,
        gaps=torch.stack(gaps),
        n_alive=torch.stack(n_alive_series),
        byz_mask=ever_byz,
        ever_filtered_good=any_good_filtered,
        # the aggregator's carried membership where it keeps one (the
        # guards), else everyone: a baseline's per-step quarantine drop is
        # not a membership
        final_alive=(agg_state.alive if hasattr(agg_state, "alive")
                     else torch.ones((cfg.m,), dtype=torch.bool, device=dev)),
        n_reporting=torch.stack(n_reporting) if part_on else None,
        telemetry=(Telemetry(ring=ring, first_filter_step=ffs, byz_alive=torch.stack(byz_alive))
                   if tel_on else None),
    )


class ByzantineSGDSolver:
    """Convenience wrapper: ``run(seed)`` is :func:`run_sgd` from
    ``PRNGKey(seed)``, made on the solver's device (the card unless the
    caller asks for the CPU)."""

    def __init__(self, problem: Problem, cfg: SolverConfig, device="cuda"):
        self.problem = problem
        self.cfg = cfg
        self.device = resolve_device(device)

    def run(self, seed: int = 0) -> SolverResult:
        return run_sgd(self.problem, self.cfg, prng.PRNGKey(seed, device=self.device),
                       device=self.device)

    def suboptimality(self, seed: int = 0) -> float:
        res = self.run(seed)
        return float(self.problem.f(res.x_avg) - self.problem.f(self.problem.x_star))
