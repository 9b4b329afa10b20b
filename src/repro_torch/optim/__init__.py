"""repro_torch.optim — pytree optimizers (the counterpart of :mod:`repro.optim`)."""
from repro_torch.optim.optimizers import (
    Optimizer,
    adamw,
    cosine_schedule,
    linear_warmup_cosine,
    momentum,
    projected_sgd,
    sgd,
)

__all__ = ["Optimizer", "sgd", "momentum", "adamw", "projected_sgd", "cosine_schedule",
           "linear_warmup_cosine"]
