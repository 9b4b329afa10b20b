"""repro_torch.distributed — the counterpart of :mod:`repro.distributed`.

Ported so far: :mod:`repro_torch.distributed.byzantine_dp`, the exact and
sketch guards that the ``dp_exact``/``dp_sketch`` guard backends run on the
flat harness, and :mod:`repro_torch.distributed.trainer`, the LM training
step on one card (workers simulated on the worker axis).  The mesh modules
(``sharding``, ``specs``) wait for a multi-GPU machine.
"""
from repro_torch.distributed.byzantine_dp import (
    DPGuardConfig,
    apply_tree_attack,
    DPGuardState,
    guard_step,
    init_guard_state,
    sketch_gram,
    sketch_tree,
    v_from_gram,
)

__all__ = ["DPGuardConfig", "apply_tree_attack", "DPGuardState", "guard_step", "init_guard_state",
           "sketch_gram", "sketch_tree", "v_from_gram"]
