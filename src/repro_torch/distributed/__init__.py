"""repro_torch.distributed — the counterpart of :mod:`repro.distributed`.

Ported so far: :mod:`repro_torch.distributed.byzantine_dp`, the exact and
sketch guards that the ``dp_exact``/``dp_sketch`` guard backends run on the
flat harness.  The trainer and the mesh modules (``sharding``, ``specs``)
wait for a multi-GPU machine.
"""
from repro_torch.distributed.byzantine_dp import (
    DPGuardConfig,
    DPGuardState,
    guard_step,
    init_guard_state,
    sketch_gram,
    sketch_tree,
    v_from_gram,
)

__all__ = ["DPGuardConfig", "DPGuardState", "guard_step", "init_guard_state",
           "sketch_gram", "sketch_tree", "v_from_gram"]
