"""Scenario engine, the counterpart of :mod:`repro.scenarios`.

Ported so far: :mod:`repro_torch.scenarios.spec` (``Scenario`` and its
constructors), :mod:`repro_torch.scenarios.adversary` (the
``ScenarioAdversary`` that ``run_sgd`` drives, on the materialising and
the generating path) and :mod:`repro_torch.scenarios.faults`, the fault
plans that poison worker gradients with NaN, ±Inf, finite garbage or bit
flips (the input of the ``sanitize="quarantine"`` stage, DESIGN.md §15).
The adversary carries a worker profile (``WorkerProfile`` and its
constructors: skewed, straggling and partially participating fleets) and
a fault plan, both driven by ``run_sgd``.  The campaign runner is not
ported yet.
"""
from repro_torch.scenarios.adversary import (
    ATTACK_TABLE,
    AdvState,
    ScenarioAdversary,
    attack_id,
)
from repro_torch.scenarios.faults import (
    FAULT_KEY_TAG,
    FAULT_TABLE,
    FaultPlan,
    apply_fault_plan,
    fault_bitflip,
    fault_garbage,
    fault_id,
    fault_inf_rows,
    fault_knobs,
    fault_nan_rows,
    fault_none,
    fault_rows,
    make_fault_plan,
    n_faulty,
)
from repro_torch.scenarios.spec import (
    NEVER,
    Scenario,
    WorkerProfile,
    make_scenario,
    profile_iid,
    profile_knobs,
    profile_linear_skew,
    profile_partial,
    profile_stragglers,
    scenario_adaptive,
    scenario_churn,
    scenario_coalition,
    scenario_late_join,
    scenario_lie_low_then_strike,
    scenario_static,
    worker_profile,
)

__all__ = [
    "ATTACK_TABLE", "AdvState", "ScenarioAdversary", "attack_id",
    "FAULT_KEY_TAG", "FAULT_TABLE", "FaultPlan", "apply_fault_plan", "fault_bitflip",
    "fault_garbage", "fault_id", "fault_inf_rows", "fault_knobs", "fault_nan_rows",
    "fault_none", "fault_rows", "make_fault_plan", "n_faulty",
    "NEVER", "Scenario", "make_scenario", "scenario_adaptive", "scenario_churn",
    "scenario_coalition", "scenario_late_join", "scenario_lie_low_then_strike",
    "scenario_static", "WorkerProfile", "profile_iid", "profile_knobs",
    "profile_linear_skew", "profile_partial", "profile_stragglers", "worker_profile",
]
