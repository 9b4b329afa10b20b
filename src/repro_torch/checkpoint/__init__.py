"""repro_torch.checkpoint — crash-safe npz checkpoints of a tree of
tensors, in the JAX package's on-disk format."""
from repro_torch.checkpoint.ckpt import (
    CKPT_VERSION,
    CheckpointCorruptError,
    clean_stale_tmp,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CKPT_VERSION",
    "CheckpointCorruptError",
    "clean_stale_tmp",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
]
