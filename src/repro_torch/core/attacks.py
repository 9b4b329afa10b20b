"""The key-free static attacks of :mod:`repro.core.attacks`.

All share the signature ``attack(key, grads, byz_mask, ctx, **kwargs) ->
grads'``: ``grads`` is (m, d) with honest rows everywhere, ``byz_mask`` is
(m,) bool, and the attack overwrites the Byzantine rows; honest rows pass
through bit for bit.  ``ctx`` holds ``true_grad`` (d,) and ``V``.  The
attacks that draw random numbers or read filter feedback are not ported
yet.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _overwrite(grads: torch.Tensor, byz_mask: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Replace Byzantine rows with ``rows`` (broadcast against (m, d))."""
    return torch.where(byz_mask[:, None], rows, grads)


def attack_none(key, grads, byz_mask, ctx):
    """Byzantine workers behave honestly (sanity baseline)."""
    return grads


def attack_sign_flip(key, grads, byz_mask, ctx, scale: float = 3.0):
    """Classic reversed-gradient attack: send −scale · (own gradient)."""
    return _overwrite(grads, byz_mask, -scale * grads)


def attack_constant_drift(key, grads, byz_mask, ctx, scale: float = 10.0):
    """All Byzantine workers send the same constant vector scale·V·1/√d."""
    d = grads.shape[1]
    # 1/√d in f32 as jnp computes it: √d rounded to f32, then the quotient
    direction = (torch.ones((d,), dtype=grads.dtype, device=grads.device)
                 / float(np.sqrt(np.float32(d))))
    return _overwrite(grads, byz_mask, scale * ctx["V"] * direction[None, :])


def attack_inner_product(key, grads, byz_mask, ctx, scale: float = 1.0):
    """Omniscient negative-inner-product attack: push exactly against the
    true gradient, scaled to the top of the allowed deviation V."""
    g = ctx["true_grad"]
    gn = g / torch.clamp(torch.linalg.vector_norm(g), min=1e-12)
    row = g - (1.0 + scale) * ctx["V"] * gn
    return _overwrite(grads, byz_mask, row[None, :])


ATTACKS: dict[str, Callable] = {
    "none": attack_none,
    "sign_flip": attack_sign_flip,
    "constant_drift": attack_constant_drift,
    "inner_product": attack_inner_product,
}


def get_attack(name: str) -> Callable:
    if name not in ATTACKS:
        raise KeyError(f"unknown or unported attack {name!r}; have {sorted(ATTACKS)}")
    return ATTACKS[name]
