"""Pytree optimizers: SGD / momentum / AdamW and the paper's projected
step (the counterpart of :mod:`repro.optim.optimizers`).

Each optimizer is an ``Optimizer(init, update)`` pair:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = tree_add(params, updates)

``updates`` are deltas (already scaled by −lr).  Learning rates are floats
or schedules ``step → lr``.  ``step`` is a host int or a 0-d integer
tensor; every scalar the update derives from it (the schedule, AdamW's
``1 − β^t``) is a 0-d f32 tensor on the parameters' device, computed in
f32 in the JAX package's order, so no step waits for the device.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.utils import (
    clip_by_global_norm,
    project_ball,
    tree_add,
    tree_leaves,
    tree_map,
    tree_scale,
    tree_sub,
    tree_zeros_like,
)

F32 = torch.float32
Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]   # (grads, state, params, step)


def _device_of(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def _step_tensor(step, device) -> torch.Tensor:
    """``step`` as a 0-d int32 tensor on ``device`` (a fill, no copy)."""
    if isinstance(step, torch.Tensor):
        return step.to(device=device, dtype=torch.int32)
    return torch.full((), int(step), dtype=torch.int32, device=device)


def _lr_at(lr: Schedule, step: torch.Tensor) -> torch.Tensor:
    if callable(lr):
        return lr(step)
    return torch.full((), lr, dtype=F32, device=step.device)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1) -> Callable:
    def lr(step):
        step = _step_tensor(step, step.device if isinstance(step, torch.Tensor) else "cpu")
        t = torch.clamp(step.to(F32) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * (final_frac + (1 - final_frac) * cos)
    return lr


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1) -> Callable:
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), final_frac)

    def lr(step):
        step = _step_tensor(step, step.device if isinstance(step, torch.Tensor) else "cpu")
        w = torch.clamp(step.to(F32) / max(warmup, 1), max=1.0)
        return w * cos(torch.clamp(step - warmup, min=0))
    return lr


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def sgd(lr: Schedule, grad_clip: float | None = None) -> Optimizer:
    def init(params):
        return {}

    def update(grads, state, params, step):
        if grad_clip:
            grads = clip_by_global_norm(grads, grad_clip)
        step = _step_tensor(step, _device_of(grads))
        return tree_scale(grads, -_lr_at(lr, step)), state

    return Optimizer(init, update)


def momentum(lr: Schedule, beta: float = 0.9, nesterov: bool = False,
             grad_clip: float | None = None) -> Optimizer:
    def init(params):
        return {"m": tree_zeros_like(params)}

    def update(grads, state, params, step):
        if grad_clip:
            grads = clip_by_global_norm(grads, grad_clip)
        m = tree_map(lambda mi, gi: beta * mi + gi, state["m"], grads)
        d = tree_map(lambda mi, gi: beta * mi + gi, m, grads) if nesterov else m
        step = _step_tensor(step, _device_of(grads))
        return tree_scale(d, -_lr_at(lr, step)), {"m": m}

    return Optimizer(init, update)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, grad_clip: float | None = None) -> Optimizer:
    """AdamW with f32 moments regardless of param dtype (bf16-safe)."""

    def init(params):
        f32 = lambda t: tree_map(lambda x: torch.zeros(x.shape, dtype=F32, device=x.device), t)
        return {"m": f32(params), "v": f32(params)}

    def update(grads, state, params, step):
        if grad_clip:
            grads = clip_by_global_norm(grads, grad_clip)
        step = _step_tensor(step, _device_of(grads))
        t = step.to(F32) + 1.0
        m = tree_map(lambda mi, gi: b1 * mi + (1 - b1) * gi.to(F32), state["m"], grads)
        v = tree_map(lambda vi, gi: b2 * vi + (1 - b2) * torch.square(gi.to(F32)),
                     state["v"], grads)
        # b ** t with b rounded to f32 and the power in f32, as jnp takes it
        mh = tree_scale(m, 1.0 / (1 - torch.pow(torch.full_like(t, b1), t)))
        vh = tree_scale(v, 1.0 / (1 - torch.pow(torch.full_like(t, b2), t)))
        lr_t = _lr_at(lr, step)
        upd = tree_map(
            lambda mi, vi, pi: (-lr_t * (mi / (torch.sqrt(vi) + eps)
                                         + weight_decay * pi.to(F32))).to(pi.dtype),
            mh, vh, params,
        )
        return upd, {"m": m, "v": v}

    return Optimizer(init, update)


def projected_sgd(lr: Schedule, x1: Any, D: float,
                  grad_clip: float | None = None) -> Optimizer:
    """The paper's update: x ← Proj_{‖·−x₁‖≤D}(x − η ξ); ``update`` returns
    the delta that lands exactly on the projected point."""
    base = sgd(lr, grad_clip)

    def update(grads, state, params, step):
        delta, state2 = base.update(grads, state, params, step)
        x_proj = project_ball(tree_add(params, delta), x1, D)
        return tree_sub(x_proj, params), state2

    return Optimizer(base.init, update)
