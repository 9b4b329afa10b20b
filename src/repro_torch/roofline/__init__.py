"""The analytic guard-step traffic model (the counterpart of
:mod:`repro.roofline`'s ``guard_cost``) on the card the port targets.
The JAX package's compiled-HLO analysis has no counterpart here."""
from repro_torch.roofline.guard_cost import (
    BACKEND_COSTS,
    GuardStepCost,
    backend_cost,
    dense_guard_cost,
    dp_exact_guard_cost,
    dp_sketch_guard_cost,
    fused_guard_cost,
    gen_guard_cost,
    steady_state_us,
)
from repro_torch.roofline.hw import H100, HwSpec

__all__ = [
    "BACKEND_COSTS",
    "GuardStepCost",
    "H100",
    "HwSpec",
    "backend_cost",
    "dense_guard_cost",
    "dp_exact_guard_cost",
    "dp_sketch_guard_cost",
    "fused_guard_cost",
    "gen_guard_cost",
    "steady_state_us",
]
