"""Baseline aggregators of :mod:`repro.core.aggregators`; only the plain
mean is ported so far (the baseline that fails under ``sign_flip``)."""
from __future__ import annotations

from typing import Callable

import torch


def aggregate_mean(grads: torch.Tensor) -> torch.Tensor:
    """Plain mini-batch mean — the α = 0 baseline; not Byzantine-robust."""
    return torch.mean(grads, dim=0)


AGGREGATORS: dict[str, Callable] = {"mean": aggregate_mean}


def get_aggregator(name: str) -> Callable:
    if name not in AGGREGATORS:
        raise KeyError(f"unknown or unported aggregator {name!r}; "
                       f"have {sorted(AGGREGATORS)}")
    return AGGREGATORS[name]
