"""Guard-backend axis: four realizations of Algorithm 1's filter behind
one factory protocol (the counterpart of :mod:`repro.core.guard_backends`).

A backend is a factory ``factory(problem, cfg, device, **knobs) ->
(state0, step)`` with ``step(state, grads, x, x1, report=None) -> (state',
ξ, n_alive, alive)`` over the stacked (m, d) worker gradients; ξ is f32.

==============  ==========================================================
``dense``       the three-pass ``ByzantineGuard``, the oracle
``fused``       ``ByzantineGuard(use_fused=True)``: the one-pass kernel, the
                incremental Gram and the filtered-mean kernel
``dp_exact``    the exact guard of :mod:`repro_torch.distributed.
                byzantine_dp` on the flat harness: the (m, d) gradients are
                a one-leaf worker pytree, x and x1 stand in for params and
                anchor; auto-V calibration on by default
``dp_sketch``   the CountSketch guard on the same adaptation
==============  ==========================================================

Knobs ride ``SolverConfig.guard_opts`` as (key, value) pairs.  One tuple
serves every backend of a sweep: each factory receives only the knobs it
declares, and a knob that no backend declares raises KeyError.
``dp_exact`` with ``auto_v=False`` matches ``dense`` to float tolerance
(its thresholds round a device-side V in f32, dense's a Python float in
double, as in the JAX package).  ``cfg.sanitize == "quarantine"`` builds
sanitizing guards.  ``cfg.generate == "kernel"`` makes ``fused`` return
the generating step, ``step(state, genctx, x, x1, report=None) -> (state',
ξ, n_alive, alive, byz_sum)`` over a
:class:`~repro_torch.kernels.gradgen.GenStepCtx` (the solver's gate
admits it on ``fused`` only).  Telemetry is not ported.
"""
from __future__ import annotations

import functools
import inspect

import torch

from repro_torch import resolve_device
from repro_torch.core.byzantine_sgd import ByzantineGuard, GuardConfig, resolve_stats_dtype

# factory parameters that are not knobs
_NOT_KNOBS = ("problem", "cfg", "device", "mode")


def parse_backend_spec(spec: str) -> tuple[str, str | None]:
    """``"fused@bf16"`` → ``("fused", "bf16")``; ``"fused"`` → ``("fused",
    None)``.  The campaign's spelling of a (backend, stats precision)
    point: the dtype suffix is checked here (a typo, ``"fused@"``
    included, raises KeyError), the backend name by
    :func:`make_guard_backend` when it is built."""
    name, sep, dt = spec.partition("@")
    if sep:
        resolve_stats_dtype(dt)
        return name, dt
    return name, None


def _declared_opts(factory) -> set[str]:
    return {p.name for p in inspect.signature(factory).parameters.values()
            if p.kind in (p.KEYWORD_ONLY, p.POSITIONAL_OR_KEYWORD)
            and p.name not in _NOT_KNOBS}


def make_guard_backend(name: str, problem, cfg, device="cuda"):
    """Instantiate backend ``name`` for (problem, cfg) on ``device``."""
    if name not in BACKENDS:
        raise KeyError(f"unknown guard backend {name!r}; have {sorted(BACKENDS)}")
    resolve_stats_dtype(cfg.stats_dtype)  # fail loudly before the first step
    opts = dict(cfg.guard_opts)
    known = set().union(*(_declared_opts(f) for f in BACKENDS.values()))
    unknown = set(opts) - known
    if unknown:
        raise KeyError(f"unknown guard_opts {sorted(unknown)}; "
                       f"known knobs: {sorted(known)}")
    factory = BACKENDS[name]
    declared = _declared_opts(factory)
    return factory(problem, cfg, device, **{k: v for k, v in opts.items() if k in declared})


def _check_resync(gram_resync_every) -> None:
    if (not isinstance(gram_resync_every, int) or isinstance(gram_resync_every, bool)
            or gram_resync_every < 0):
        raise ValueError("gram_resync_every must be an int >= 0 (0 disables), "
                         f"got {gram_resync_every!r}")


def _guard_config(problem, cfg) -> GuardConfig:
    return GuardConfig(
        m=cfg.m, T=cfg.T, V=problem.V, D=problem.D, delta=cfg.delta,
        threshold_mode=cfg.threshold_mode, mean_over_alive=cfg.mean_over_alive,
    )


def _wrap_byzantine_guard(guard: ByzantineGuard, d: int):
    state0 = guard.init(d)

    def step(state, grads, x, x1, report=None):
        state, xi, diag = guard.step(state, grads, x, x1, report)
        return state, xi, diag["n_alive"], state.alive

    return state0, step


def _wrap_gen_guard(guard: ByzantineGuard, d: int):
    """The generating step: a GenStepCtx in place of the batch, and the
    adversary's feedback row sum as a fifth output."""
    state0 = guard.init(d)

    def step(state, genctx, x, x1, report=None):
        # report is None: partial participation needs the materialised batch
        state, xi, byz_sum, diag = guard.gen_step(state, genctx, x, x1)
        return state, xi, diag["n_alive"], state.alive, byz_sum

    return state0, step


def _dense_backend(problem, cfg, device="cuda"):
    # gram_B is re-derived from the stored B every step (the drift oracle)
    guard = ByzantineGuard(_guard_config(problem, cfg), stats_dtype=cfg.stats_dtype,
                           device=device, sanitize=cfg.sanitize == "quarantine")
    return _wrap_byzantine_guard(guard, problem.d)


def _fused_backend(problem, cfg, device="cuda", d_block: int | None = None,
                   gram_resync_every: int = 64):
    """``d_block`` is accepted for the JAX package's sweeps and ignored: the
    CUDA kernel takes any d with no strip width."""
    _check_resync(gram_resync_every)
    gen_on = cfg.generate == "kernel"
    guard = ByzantineGuard(_guard_config(problem, cfg), use_fused=True,
                           gram_resync_every=gram_resync_every,
                           stats_dtype=cfg.stats_dtype, device=device,
                           sanitize=cfg.sanitize == "quarantine",
                           gen_spec=problem.gen if gen_on else None)
    if gen_on:
        return _wrap_gen_guard(guard, problem.d)
    return _wrap_byzantine_guard(guard, problem.d)


def _dp_backend(problem, cfg, device="cuda", *, mode: str, auto_v: bool = True,
                sketch_dim: int = 4096, sketch_slack: float = 1.5,
                incremental_gram: bool = True, gram_resync_every: int = 64,
                low_precision_stats: bool = False, v_ema: float = 0.9):
    from repro_torch.distributed.byzantine_dp import (
        DPGuardConfig,
        guard_step,
        init_guard_state,
    )

    _check_resync(gram_resync_every)
    # stats_dtype='bf16' implies the low-precision contraction path
    dcfg = DPGuardConfig(
        n_workers=cfg.m, T=cfg.T, V=problem.V, D=problem.D, delta=cfg.delta,
        mode=mode, threshold_mode=cfg.threshold_mode,
        mean_over_alive=cfg.mean_over_alive, auto_v=auto_v,
        sketch_dim=sketch_dim, sketch_slack=sketch_slack,
        incremental_gram=incremental_gram, gram_resync_every=gram_resync_every,
        low_precision_stats=low_precision_stats or cfg.stats_dtype == "bf16",
        v_ema=v_ema, stats_dtype=cfg.stats_dtype,
    )
    dev = resolve_device(device)
    state0 = init_guard_state(dcfg, torch.zeros((problem.d,), device=dev))
    san = cfg.sanitize == "quarantine"

    def step(state, grads, x, x1, report=None):
        if san:
            # the quarantine wraps the step: non-finite entries are zeroed
            # out of every statistic, poisoned rows are scored as
            # non-reporters (so their status would pass through) and are
            # then dropped from the carried alive mask for good
            fin = torch.isfinite(grads)
            finite = torch.all(fin, dim=1)
            grads = torch.where(fin, grads, 0.0)
            report = finite if report is None else report & finite
        state, xi, diag = guard_step(dcfg, state, grads, x, x1, report)
        n_alive = diag["n_alive"]
        if san:
            state = state._replace(alive=state.alive & finite)
            n_alive = torch.sum(state.alive)
        # ξ leaves the guard in the gradients' dtype; the solver takes f32
        return state, xi.to(torch.float32), n_alive, state.alive

    return state0, step


BACKENDS = {"dense": _dense_backend, "fused": _fused_backend,
            "dp_exact": functools.partial(_dp_backend, mode="exact"),
            "dp_sketch": functools.partial(_dp_backend, mode="sketch")}
