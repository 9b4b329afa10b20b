"""The scenario adversary, the counterpart of
:mod:`repro.scenarios.adversary`: a :class:`~repro_torch.scenarios.spec.
Scenario` bound to its Byzantine fraction, as ``run_sgd`` drives it.

* **mask schedule** — :meth:`ScenarioAdversary.mask_at` derives the step's
  Byzantine set from the run's worker ranks (rotation by ``churn_stride``
  every ``churn_period`` steps, activation at ``join_step``), on the host
  schedule and the device ranks;
* **attack dispatch** — each coalition phase runs the static attack of
  :mod:`repro_torch.core.attacks` its id names, with the generic magnitude
  ``scale`` on the attack's own knob (``default · scale``: scale = 1
  reproduces the static zoo).  The JAX package dispatches through
  ``lax.switch``; the port branches in Python on the scenario's host id.
  The two phases draw from ``ka, kb = split(key)`` as in the JAX package;
  only ``random_gaussian`` (id 2) reads its key, so a scenario without it
  skips the split and, when both phases name one attack, computes it once;
* **feedback** — :class:`AdvState` carries the multiplicative-weights
  magnitude, updated after each aggregation from the filter decision and
  the realized ξ.  With ``adapt_rate = 0`` the update is the identity, and
  the port skips it;
* **per-worker schedules** — with a :class:`~repro_torch.scenarios.spec.
  WorkerProfile`, :meth:`ScenarioAdversary.refresh_at` says which workers
  recompute their gradient at a step (the others report a stale one) and
  :meth:`ScenarioAdversary.report_at` which report at all (Byzantine
  workers always do);
* **machine faults** — a :class:`~repro_torch.scenarios.faults.FaultPlan`
  in ``faults`` is applied by ``run_sgd`` after the attack.

:meth:`ScenarioAdversary.gen_attack_ctx` is the O(m) form of the attack
for ``generate="kernel"``: per-worker slots and the parameter vector of
:mod:`repro_torch.kernels.gradgen`, expression for expression as
:meth:`attack` computes the rows.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import attacks as attack_lib
from repro_torch.scenarios.faults import FaultPlan
from repro_torch.scenarios.spec import Scenario, WorkerProfile

# name → (knob, default): the generic scale multiplies the knob's default.
# The order is the JAX package's ATTACK_TABLE (ids are stored in scenarios).
_SCALE_KNOBS: dict[str, tuple[str, float] | None] = {
    "none": None,
    "sign_flip": ("scale", 3.0),
    "random_gaussian": ("scale", 100.0),
    "constant_drift": ("scale", 10.0),
    "alie": ("z_scale", 1.0),
    "inner_product": ("scale", 1.0),
    "hidden_shift": ("c", 0.9),
    "retreat_on_filter": ("scale", 1.0),
    "alie_update": ("z_scale", 1.0),
}

ATTACK_TABLE: tuple[str, ...] = tuple(_SCALE_KNOBS)

# the one attack that draws from its key (random_gaussian)
_KEYED_ID = ATTACK_TABLE.index("random_gaussian")

# default magnitude knob per id ("none" pads with 1.0)
_KNOB_DEFAULTS = tuple(1.0 if knob is None else knob[1] for knob in _SCALE_KNOBS.values())

# bounds of the multiplicative-weights magnitude search
ADAPT_MIN, ADAPT_MAX = 0.1, 8.0
# cosine threshold deciding "the previous update moved our way"
_WIN_COS = 0.3


def attack_id(name: str) -> int:
    """Integer id of ``name`` in :data:`ATTACK_TABLE`."""
    try:
        return ATTACK_TABLE.index(name)
    except ValueError:
        raise KeyError(
            f"attack {name!r} is not scenario-dispatchable; have {ATTACK_TABLE}"
        ) from None


def _dispatch(aid: int, key, grads, mask, ctx, scale: torch.Tensor) -> torch.Tensor:
    """Attack ``aid`` with its knob at ``default · scale``, in the input
    gradients' dtype."""
    name = ATTACK_TABLE[aid]
    fn = attack_lib.get_attack(name)
    knob = _SCALE_KNOBS[name]
    if knob is None:
        return fn(key, grads, mask, ctx).to(grads.dtype)
    kwarg, default = knob
    return fn(key, grads, mask, ctx, **{kwarg: default * scale}).to(grads.dtype)


class AdvState(NamedTuple):
    """Adversary memory, carried next to the aggregator state."""

    adapt_scale: torch.Tensor   # () f32 multiplicative magnitude multiplier


class ScenarioAdversary:
    """A Scenario bound to its Byzantine fraction ``alpha`` (f32).

    ``profile`` (a :class:`~repro_torch.scenarios.spec.WorkerProfile`, its
    leaves on the run's device) parameterizes the honest workers; ``faults``
    (a :class:`~repro_torch.scenarios.faults.FaultPlan`) the machine faults
    ``run_sgd`` injects after the attack.  ``None`` leaves either out of
    the run entirely."""

    def __init__(self, scenario: Scenario, alpha, profile: WorkerProfile | None = None,
                 faults: FaultPlan | None = None):
        self.scenario = scenario
        self.alpha = np.float32(alpha)
        self.profile = profile
        self.faults = faults

    def n_byz(self, m: int) -> int:
        """floor(α·m + 1e-6) in f32, as the JAX package computes it."""
        return int(np.floor(self.alpha * np.float32(m) + np.float32(1e-6)))

    # -- per-worker schedules (need a profile) ------------------------------
    def stale_period(self, max_delay: int) -> torch.Tensor:
        """(m,) int32: worker w refreshes its gradient every ``period[w]``
        steps; ``max_delay`` caps the schedule."""
        return torch.clamp(self.profile.delay, max=max_delay) + 1

    def refresh_at(self, k: int, max_delay: int) -> torch.Tensor:
        """(m,) bool: the workers that compute a fresh gradient at step
        ``k`` (delay 0 refreshes every step)."""
        return (k % self.stale_period(max_delay)) == 0

    def staleness_at(self, k: int, max_delay: int) -> torch.Tensor:
        """(m,) int32: the age in steps of the gradient worker w reports at
        step ``k``."""
        return k % self.stale_period(max_delay)

    def report_at(self, key: torch.Tensor, mask_k: torch.Tensor) -> torch.Tensor:
        """(m,) bool: who reports this step.  Honest worker w reports with
        probability ``p_report[w]``; Byzantine workers always do."""
        p = self.profile.p_report
        return (prng.uniform(key, p.shape) < p) | mask_k

    # -- mask schedule -----------------------------------------------------
    def mask_at(self, rank: torch.Tensor, k: int) -> torch.Tensor:
        """(m,) bool Byzantine set at step ``k`` (a host int) from the
        per-worker ranks."""
        s = self.scenario
        m = rank.shape[0]
        if k < s.join_step:
            return torch.zeros_like(rank, dtype=torch.bool)
        rot = (k // max(s.churn_period, 1)) * s.churn_stride if s.churn_period > 0 else 0
        return ((rank - rot) % m) < self.n_byz(m)

    # -- attack ------------------------------------------------------------
    def init_state(self, m: int, d: int, device="cuda") -> AdvState:
        return AdvState(adapt_scale=torch.ones((), dtype=torch.float32, device=device))

    def _scale(self, state: AdvState) -> torch.Tensor:
        """attack_scale, times the carried magnitude when adaptive: a 0-d
        f32 tensor, so every knob product rounds in f32 as in JAX."""
        s = self.scenario
        if s.adapt_rate > 0:
            return state.adapt_scale * float(s.attack_scale)
        return torch.full((), float(s.attack_scale), dtype=torch.float32,
                          device=state.adapt_scale.device)

    def _use_b(self, mask_k: torch.Tensor, step: int) -> torch.Tensor:
        """(m,) bool: rows that play phase b at ``step``."""
        s = self.scenario
        if step >= s.switch_step:
            return torch.ones_like(mask_k)
        crank = torch.cumsum(mask_k, dim=0) - 1   # 0-based rank within the set
        return crank >= torch.ceil(float(s.coalition_frac) * torch.sum(mask_k))

    def attack(self, key, grads, mask_k, ctx, state: AdvState) -> torch.Tensor:
        """Corrupt the Byzantine rows per the scenario's per-step rule."""
        s = self.scenario
        scale = self._scale(state)
        if _KEYED_ID in (s.attack_a, s.attack_b):
            ka, kb = prng.split(key)
            ga = _dispatch(s.attack_a, ka, grads, mask_k, ctx, scale)
            gb = _dispatch(s.attack_b, kb, grads, mask_k, ctx, scale)
        else:
            # key-free phases: the split is never read, and one phase serves
            # both when their ids agree
            ga = _dispatch(s.attack_a, key, grads, mask_k, ctx, scale)
            gb = ga if s.attack_b == s.attack_a else _dispatch(s.attack_b, key, grads,
                                                               mask_k, ctx, scale)
        return torch.where((mask_k & self._use_b(mask_k, ctx["step"]))[:, None], gb, ga)

    def gen_attack_ctx(self, mask_k, ctx, state: AdvState, noise_scale):
        """The attack's O(m) form for the generated path: ``(slot, params,
        w_byz)``, the per-worker slot (0 honest, 1 phase a, 2 phase b), the
        :mod:`~repro_torch.kernels.gradgen` parameter vector (each phase's
        effective id and its knobs at ``default · scale``, as :meth:`attack`
        computes them) and the f32 Byzantine mask.  ``retreat_on_filter``
        (id 7) becomes inner_product or none here, on its coalition-intact
        condition; the solver rejects random_gaussian (id 2) before."""
        s = self.scenario
        m = mask_k.shape[0]
        scale = self._scale(state)
        n_byz_k = torch.sum(mask_k)
        slot = torch.where(mask_k, torch.where(self._use_b(mask_k, ctx["step"]), 2, 1), 0)

        tg = ctx["true_grad"]
        tg_nrm = torch.clamp(torch.linalg.vector_norm(tg), min=1e-12)
        zz = attack_lib.alie_z_max(m, n_byz_k)
        V = ctx["V"]
        # the per-coordinate value of the zoo's ones(d)/√d direction
        inv_sqrt_d = float(np.float32(1.0) / np.sqrt(np.float32(tg.shape[0])))
        intact = torch.sum(ctx["alive"] & mask_k) >= torch.clamp(n_byz_k, min=1)

        def pgroup(aid: int):
            knob = _KNOB_DEFAULTS[aid] * scale
            if aid == 7:
                aid_eff = torch.where(intact, 5.0, 0.0).to(torch.float32)
            else:
                aid_eff = torch.full_like(knob, float(aid))
            return (aid_eff, -knob, knob * zz, knob * V * inv_sqrt_d, (1.0 + knob) * V)

        params = torch.stack([*pgroup(s.attack_a), *pgroup(s.attack_b), tg_nrm,
                              torch.full_like(tg_nrm, float(noise_scale))])
        return slot.to(torch.int32), params.to(torch.float32), mask_k.to(torch.float32)

    # -- feedback ----------------------------------------------------------
    def update_state(self, state: AdvState, mask_k, grads_out, xi, alive, n_alive,
                     ctx) -> AdvState:
        """The multiplicative-weights response to the aggregation outcome,
        from the coalition's mean row of ``grads_out``."""
        if not self.scenario.adapt_rate > 0:
            return state
        w = mask_k.to(torch.float32)[:, None]
        byz_row = torch.sum(grads_out * w, dim=0) / torch.clamp(torch.sum(mask_k), min=1)
        return self.update_state_from_byz_row(state, mask_k, byz_row, xi, alive, n_alive, ctx)

    def update_state_from_byz_row(self, state: AdvState, mask_k, byz_row, xi, alive,
                                  n_alive, ctx) -> AdvState:
        """:meth:`update_state` from a precomputed coalition mean row (the
        generated path's entry: ``gen_xi`` returns Σ mask·rows).  "Win" =
        the realized residual ξ − (n_alive/m)·∇f points along the coalition's
        deviation (cosine > 0.3) and more than half the coalition is alive;
        a win scales by (1 + rate), a loss by 1/(1 + rate), clipped to
        [ADAPT_MIN, ADAPT_MAX]; no change while no worker is Byzantine."""
        s = self.scenario
        if not s.adapt_rate > 0:
            return state
        m = mask_k.shape[0]
        n_byz_k = torch.sum(mask_k)
        tg = ctx["true_grad"]
        dev = byz_row - tg
        resid = xi - (n_alive.to(torch.float32) / m) * tg
        cos = torch.dot(resid, dev) / torch.clamp(
            torch.linalg.vector_norm(resid) * torch.linalg.vector_norm(dev), min=1e-12)
        byz_alive_frac = torch.sum(alive & mask_k) / torch.clamp(n_byz_k, min=1)
        win = (cos > _WIN_COS) & (byz_alive_frac > 0.5)
        up = np.float32(1.0) + s.adapt_rate
        factor = torch.where(win, float(up), float(np.float32(1.0) / up))
        new_scale = torch.clamp(state.adapt_scale * factor, ADAPT_MIN, ADAPT_MAX)
        return AdvState(adapt_scale=torch.where(n_byz_k > 0, new_scale, state.adapt_scale))
