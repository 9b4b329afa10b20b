"""Scenario engine, the counterpart of :mod:`repro.scenarios`.

Ported so far: :mod:`repro_torch.scenarios.faults`, the fault plans that
poison worker gradients with NaN, ±Inf, finite garbage or bit flips (the
input of the ``sanitize="quarantine"`` stage, DESIGN.md §15).  The
scenario specs, the scenario adversary and the campaign runner are not
ported yet.
"""
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

__all__ = [
    "FAULT_KEY_TAG", "FAULT_TABLE", "FaultPlan", "apply_fault_plan", "fault_bitflip",
    "fault_garbage", "fault_id", "fault_inf_rows", "fault_knobs", "fault_nan_rows",
    "fault_none", "fault_rows", "make_fault_plan", "n_faulty",
]
