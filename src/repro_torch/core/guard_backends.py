"""Guard-backend axis: the ``dense`` and ``fused`` realizations of
Algorithm 1's filter behind one factory protocol (the counterpart of
:mod:`repro.core.guard_backends`).

A backend is a factory ``factory(problem, cfg, device, **opts) -> (state0,
step)`` with ``step(state, grads, x, x1) -> (state', ξ, n_alive, alive)``
over the stacked (m, d) worker gradients.  The one knob, the fused
backend's ``gram_resync_every``, rides ``SolverConfig.guard_opts`` as a
(key, value) pair; any other key raises KeyError, and the dense backend
ignores it.  The ``dp_exact``/``dp_sketch`` backends and telemetry are not
ported yet.
"""
from __future__ import annotations

from repro_torch.core.byzantine_sgd import ByzantineGuard, GuardConfig, resolve_stats_dtype

GUARD_OPTS = ("gram_resync_every",)


def make_guard_backend(name: str, problem, cfg, device="cuda"):
    """Instantiate backend ``name`` for (problem, cfg) on ``device``."""
    if name not in BACKENDS:
        raise KeyError(f"unknown guard backend {name!r}; have {sorted(BACKENDS)}")
    resolve_stats_dtype(cfg.stats_dtype)  # fail loudly before the first step
    opts = dict(cfg.guard_opts)
    unknown = set(opts) - set(GUARD_OPTS)
    if unknown:
        raise KeyError(f"unknown guard_opts {sorted(unknown)}; "
                       f"known knobs: {list(GUARD_OPTS)}")
    return BACKENDS[name](problem, cfg, device, **opts)


def _guard_config(problem, cfg) -> GuardConfig:
    return GuardConfig(
        m=cfg.m, T=cfg.T, V=problem.V, D=problem.D, delta=cfg.delta,
        threshold_mode=cfg.threshold_mode, mean_over_alive=cfg.mean_over_alive,
    )


def _wrap_byzantine_guard(guard: ByzantineGuard, d: int):
    state0 = guard.init(d)

    def step(state, grads, x, x1):
        state, xi, diag = guard.step(state, grads, x, x1)
        return state, xi, diag["n_alive"], state.alive

    return state0, step


def _dense_backend(problem, cfg, device="cuda", gram_resync_every: int = 64):
    # gram_B is re-derived from the stored B every step (the drift oracle),
    # so the fused backend's resync knob is accepted and ignored
    guard = ByzantineGuard(_guard_config(problem, cfg), stats_dtype=cfg.stats_dtype,
                           device=device)
    return _wrap_byzantine_guard(guard, problem.d)


def _fused_backend(problem, cfg, device="cuda", gram_resync_every: int = 64):
    if (not isinstance(gram_resync_every, int) or isinstance(gram_resync_every, bool)
            or gram_resync_every < 0):
        raise ValueError("gram_resync_every must be an int >= 0 (0 disables), "
                         f"got {gram_resync_every!r}")
    guard = ByzantineGuard(_guard_config(problem, cfg), use_fused=True,
                           gram_resync_every=gram_resync_every,
                           stats_dtype=cfg.stats_dtype, device=device)
    return _wrap_byzantine_guard(guard, problem.d)


BACKENDS = {"dense": _dense_backend, "fused": _fused_backend}
