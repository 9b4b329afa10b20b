"""Scenario engine, the counterpart of :mod:`repro.scenarios`.

Ported so far: :mod:`repro_torch.scenarios.spec` (``Scenario`` and its
constructors), :mod:`repro_torch.scenarios.adversary` (the
``ScenarioAdversary`` that ``run_sgd`` drives, on the materialising and
the generating path) and :mod:`repro_torch.scenarios.faults`, the fault
plans that poison worker gradients with NaN, ±Inf, finite garbage or bit
flips (the input of the ``sanitize="quarantine"`` stage, DESIGN.md §15).
The adversary carries a worker profile (``WorkerProfile`` and its
constructors: skewed, straggling and partially participating fleets) and
a fault plan, both driven by ``run_sgd``.  :func:`expand_grid` builds a
campaign grid, :func:`run_campaign` (:mod:`repro_torch.scenarios.campaign`)
runs it with each group of rows on one run axis, and
:mod:`repro_torch.scenarios.report` reduces the result across seeds.
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
    CampaignGrid,
    GridEntry,
    Scenario,
    WorkerProfile,
    expand_grid,
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
    "GUARD_AGGREGATOR", "CampaignResult", "RunStats", "build_campaign_fn", "expand_variants",
    "run_campaign", "run_campaign_looped",
    "campaign_trace_events", "degraded_pairs", "filter_timelines", "summarize_campaign",
    "theorem38_bound", "write_report",
    "CampaignGrid", "GridEntry", "expand_grid",
    "FAULT_KEY_TAG", "FAULT_TABLE", "FaultPlan", "apply_fault_plan", "fault_bitflip",
    "fault_garbage", "fault_id", "fault_inf_rows", "fault_knobs", "fault_nan_rows",
    "fault_none", "fault_rows", "make_fault_plan", "n_faulty",
    "NEVER", "Scenario", "make_scenario", "scenario_adaptive", "scenario_churn",
    "scenario_coalition", "scenario_late_join", "scenario_lie_low_then_strike",
    "scenario_static", "WorkerProfile", "profile_iid", "profile_knobs",
    "profile_linear_skew", "profile_partial", "profile_stragglers", "worker_profile",
    "TrainCampaignResult", "TrainRunStats", "build_train_campaign_fn", "run_train_campaign",
    "summarize_train_campaign",
]

# the campaign runner and its report import core.solver, which imports this
# package's faults: they load on first use
_LAZY = {**{name: "campaign" for name in (
    "GUARD_AGGREGATOR", "CampaignResult", "RunStats", "build_campaign_fn", "expand_variants",
    "run_campaign", "run_campaign_looped")},
    **{name: "report" for name in (
        "campaign_trace_events", "degraded_pairs", "filter_timelines", "summarize_campaign",
        "theorem38_bound", "write_report")},
    **{name: "train_campaign" for name in (
        "TrainCampaignResult", "TrainRunStats", "build_train_campaign_fn", "run_train_campaign",
        "summarize_train_campaign")}}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"repro_torch.scenarios.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
