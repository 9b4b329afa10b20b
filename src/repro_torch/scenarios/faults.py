"""Fault plans: machine-level corruption of the worker gradients, the
counterpart of :mod:`repro.scenarios.faults`.

A :class:`FaultPlan` injects NaN rows, ±Inf rows, finite garbage or
single-bit flips into the (m, d) batch after the attack, on a schedule,
into the workers of the top ranks (the Byzantine workers take the bottom
ranks, so faults land on honest workers until the two sets overlap)::

    faulty = rank >= m - floor(frac · m + 1e-6)
    active = k >= start_step and (k - start_step) % period == 0

``garbage`` is finite (the filter's job); ``nan_rows``, ``inf_rows`` and
some ``bitflip`` entries are not (the sanitize stage's job).

The plan's fields are host scalars, ``frac`` and ``magnitude`` f32 as the
JAX plan's leaves, so the schedule is decided on the host and a step never
waits for the device.  Given the same key, every mode gives the JAX
package's bits: ``garbage`` draws :func:`repro_torch.prng.uniform`,
``bitflip`` :func:`repro_torch.prng.randint` and flips through a
same-width integer view (16 bits for bf16).  One difference: a bit flip
that makes a bf16 NaN keeps its payload here, where XLA on the CPU turns
it into the canonical NaN of its sign.  The flip is the custom op
``repro_torch::flip_bits`` with its own vmap rule (an elementwise op, so
the rule flips the stacked runs in one call): ``torch.func.vmap`` has no
rule for a dtype view in every torch the port runs on, and a campaign
with a ``bitflip`` fault axis maps the step over its runs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import prng

FAULT_TABLE: tuple[str, ...] = (
    "none", "nan_rows", "inf_rows", "garbage", "bitflip",
)

# the key of a step's faults is fold_in(akey, FAULT_KEY_TAG)
FAULT_KEY_TAG = 104729

_INT_VIEWS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _flip(grads: torch.Tensor, which: torch.Tensor) -> torch.Tensor:
    """``grads`` with bit ``which`` of each entry flipped (``which`` in the
    entries' same-width integer type)."""
    flipped = grads.view(which.dtype) ^ torch.bitwise_left_shift(torch.ones_like(which), which)
    return flipped.view(grads.dtype)


@torch.library.custom_op("repro_torch::flip_bits", mutates_args=())
def flip_bits(grads: torch.Tensor, which: torch.Tensor) -> torch.Tensor:
    return _flip(grads, which)


@flip_bits.register_vmap
def _(info, in_dims, grads, which):
    # elementwise: the runs' entries flip as one stacked tensor
    grads, which = (t.expand(info.batch_size, *t.shape) if dim is None else t.movedim(dim, 0)
                    for t, dim in zip((grads, which), in_dims))
    return _flip(grads.contiguous(), which.contiguous()), 0


def fault_id(name: str) -> int:
    try:
        return FAULT_TABLE.index(name)
    except ValueError:
        raise KeyError(f"fault mode {name!r} unknown; have {FAULT_TABLE}") from None


class FaultPlan(NamedTuple):
    """One fault-injection schedule."""

    mode: int              # id into FAULT_TABLE
    frac: np.float32       # fraction of the fleet hit
    start_step: int        # first step faults can fire (0-based)
    period: int            # fire every `period` steps (>= 1)
    magnitude: np.float32  # garbage amplitude


def make_fault_plan(mode: str = "none", *, frac: float = 0.0, start_step: int = 0,
                    period: int = 1, magnitude: float = 1e30) -> FaultPlan:
    return FaultPlan(mode=fault_id(mode), frac=np.float32(frac), start_step=int(start_step),
                     period=max(int(period), 1), magnitude=np.float32(magnitude))


def fault_none() -> FaultPlan:
    """The inert plan: every gradient stays as it was."""
    return make_fault_plan("none")


def fault_nan_rows(frac: float, *, start_step: int = 0, period: int = 1) -> FaultPlan:
    """Affected workers report all-NaN rows (a diverged replica)."""
    return make_fault_plan("nan_rows", frac=frac, start_step=start_step, period=period)


def fault_inf_rows(frac: float, *, start_step: int = 0, period: int = 1) -> FaultPlan:
    """Affected workers report ±Inf rows (an overflowed accumulator)."""
    return make_fault_plan("inf_rows", frac=frac, start_step=start_step, period=period)


def fault_garbage(frac: float, *, magnitude: float = 1e30, start_step: int = 0,
                  period: int = 1) -> FaultPlan:
    """Affected workers report finite garbage of amplitude ``magnitude`` on
    every 4th coordinate."""
    return make_fault_plan("garbage", frac=frac, magnitude=magnitude,
                           start_step=start_step, period=period)


def fault_bitflip(frac: float, *, start_step: int = 0, period: int = 1) -> FaultPlan:
    """One random bit of each affected element flips (faulty memory)."""
    return make_fault_plan("bitflip", frac=frac, start_step=start_step, period=period)


def fault_knobs(plan: FaultPlan | None) -> dict:
    """Summary knobs of a plan, for result rows."""
    if plan is None:
        return {"fault": "none", "fault_frac": 0.0}
    return {"fault": FAULT_TABLE[plan.mode], "fault_frac": float(plan.frac)}


def n_faulty(plan: FaultPlan, m: int) -> int:
    """floor(frac · m + 1e-6), in f32 as the JAX package computes it."""
    return int(np.floor(plan.frac * np.float32(m) + np.float32(1e-6)))


def _active(plan: FaultPlan, k: int) -> bool:
    return k >= plan.start_step and (k - plan.start_step) % max(plan.period, 1) == 0


def fault_rows(plan: FaultPlan, rank: torch.Tensor, k: int) -> torch.Tensor:
    """(m,) bool: the workers whose row is corrupted at step ``k``."""
    m = rank.shape[0]
    faulty = rank >= m - n_faulty(plan, m)
    return faulty & (plan.mode != 0 and _active(plan, k))


def apply_fault_plan(plan: FaultPlan, key: torch.Tensor, grads: torch.Tensor,
                     rank: torch.Tensor, k: int) -> torch.Tensor:
    """``grads`` (m, d) corrupted per the plan at step ``k``; a new tensor,
    or ``grads`` itself when nothing fires (mode 0 or an inactive step)."""
    if plan.mode == 0 or not _active(plan, k):
        return grads
    m, d = grads.shape
    dtype, dev = grads.dtype, grads.device
    row = (rank >= m - n_faulty(plan, m))[:, None]
    col = torch.arange(d, device=dev)
    name = FAULT_TABLE[plan.mode]
    if name == "nan_rows":
        return torch.where(row, torch.tensor(float("nan"), dtype=dtype, device=dev), grads)
    if name == "inf_rows":
        # ±Inf by coordinate parity: the row has no direction even before
        # it is sanitized
        sign = torch.where(col % 2 == 0, float("inf"), float("-inf")).to(dtype)
        return torch.where(row, sign[None, :], grads)
    if name == "garbage":
        noise = prng.uniform(key, (m, d), -1.0, 1.0) * torch.tensor(plan.magnitude, device=dev)
        return torch.where(row & (col % 4 == 0)[None, :], noise.to(dtype), grads)
    # bitflip: the shift wraps in the signed view as in the unsigned one
    view = _INT_VIEWS[dtype]
    nbits = torch.iinfo(view).bits
    which = prng.randint(key, (m, d), 0, nbits).to(view)
    return torch.where(row, flip_bits(grads.contiguous(), which), grads)
