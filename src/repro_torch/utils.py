"""Host helpers of :mod:`repro.utils` that the port needs, copied so the
port imports nothing of the JAX package."""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def log_c(m: int, T: int, delta: float) -> float:
    """The paper's C = log(16 m T / δ) (Section 3.1)."""
    return float(np.log(16.0 * m * T / delta))
