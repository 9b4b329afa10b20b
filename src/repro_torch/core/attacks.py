"""The attack zoo of :mod:`repro.core.attacks`: every attack, ALIE and the
filter-feedback ``retreat_on_filter`` included, and the ``phase_switch``
and ``coalition`` combinators.

All share the signature ``attack(key, grads, byz_mask, ctx, **kwargs) ->
grads'``: ``grads`` is (m, d) with honest rows everywhere, ``byz_mask`` is
(m,) bool, and the attack overwrites the Byzantine rows; honest rows pass
through bit for bit.  ``ctx`` holds ``true_grad`` (d,) and ``V``, and the
solver adds the previous step's feedback: ``step``, ``alive`` (m,) bool,
``n_alive`` and ``prev_xi`` (d,).  A magnitude knob may be a Python float,
a numpy f32 scalar or a 0-d f32 tensor (the scenario adversary's scaled
knob); each expression rounds in f32 in the JAX package's order.
``random_gaussian`` draws :func:`repro_torch.prng.normal` from its key;
``mirror`` (the Section-5 adversary) reads the honest rows of the mirror
objective from ``ctx["mirror_grads"]``.  The rest are key-free.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch import prng


def _overwrite(grads: torch.Tensor, byz_mask: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Replace Byzantine rows with ``rows`` (broadcast against (m, d))."""
    return torch.where(byz_mask[:, None], rows, grads)


def _inv_sqrt_d_ones(d: int, like: torch.Tensor) -> torch.Tensor:
    """ones(d)/√d in f32 as jnp computes it: √d rounded to f32, then the
    quotient."""
    return (torch.ones((d,), dtype=like.dtype, device=like.device)
            / float(np.sqrt(np.float32(d))))


def attack_none(key, grads, byz_mask, ctx):
    """Byzantine workers behave honestly (sanity baseline)."""
    return grads


def attack_sign_flip(key, grads, byz_mask, ctx, scale: float = 3.0):
    """Classic reversed-gradient attack: send −scale · (own gradient)."""
    return _overwrite(grads, byz_mask, -scale * grads)


def attack_random_gaussian(key, grads, byz_mask, ctx, scale: float = 100.0):
    """Large iid Gaussian noise: crashes the naive mean, trivially filtered."""
    noise = scale * prng.normal(key, grads.shape, grads.dtype)
    return _overwrite(grads, byz_mask, noise)


def attack_constant_drift(key, grads, byz_mask, ctx, scale: float = 10.0):
    """All Byzantine workers send the same constant vector scale·V·1/√d."""
    direction = _inv_sqrt_d_ones(grads.shape[1], grads)
    return _overwrite(grads, byz_mask, scale * ctx["V"] * direction[None, :])


def alie_z_max(n_workers, n_byz) -> torch.Tensor:
    """The calibrated ALIE deviation z_max (Baruch et al., blades parity):
    z_max = Φ⁻¹((n − m − s) / (n − m)) with s = ⌊n/2 + 1⌋ − m supporters,
    in f32 as the JAX package computes it, the cdf argument clipped to
    [1e-6, 1 − 1e-6] so a coalition past n/2 saturates instead of
    returning ±inf.  ``n_byz`` may be a tensor; the result lies on its
    device."""
    mb = torch.as_tensor(n_byz).to(torch.float32)
    n = torch.full_like(mb, float(n_workers))
    n_good = torch.clamp(n - mb, min=1.0)
    s = torch.floor(n / 2.0 + 1.0) - mb
    cdf = (n_good - s) / n_good
    return torch.special.ndtri(torch.clamp(cdf, 1e-6, 1.0 - 1e-6))


def _good_row_stats(grads: torch.Tensor, byz_mask: torch.Tensor):
    """(μ, σ²) over the honest rows (population moments, coordinate-wise)."""
    w = (~byz_mask).to(grads.dtype)[:, None]
    n_good = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(grads * w, dim=0) / n_good
    var = torch.sum(w * (grads - mu[None, :]) ** 2, dim=0) / n_good
    return mu, var


def attack_alie(key, grads, byz_mask, ctx, z: float | None = None, z_scale: float = 1.0):
    """'A little is enough' (Baruch et al.): the colluding workers send
    μ − z·σ (coordinate-wise over the honest rows).  ``z=None`` calibrates
    z to the supporter count with :func:`alie_z_max`; ``z_scale``
    multiplies whichever z is in effect."""
    zz = alie_z_max(grads.shape[0], torch.sum(byz_mask)) if z is None else z
    mu, var = _good_row_stats(grads, byz_mask)
    row = mu - z_scale * zz * torch.sqrt(var + 1e-12)
    return _overwrite(grads, byz_mask, row[None, :])


def attack_alie_update(key, grads, byz_mask, ctx, z: float | None = None,
                       z_scale: float = 1.0):
    """ALIE on the workers' updates (blades ``is_fedavg=True``): the same
    lie on u = −η·g, which in gradient space is μ + z·σ."""
    zz = alie_z_max(grads.shape[0], torch.sum(byz_mask)) if z is None else z
    mu, var = _good_row_stats(grads, byz_mask)
    row = mu + z_scale * zz * torch.sqrt(var + 1e-12)
    return _overwrite(grads, byz_mask, row[None, :])


def attack_inner_product(key, grads, byz_mask, ctx, scale: float = 1.0):
    """Omniscient negative-inner-product attack: push exactly against the
    true gradient, scaled to the top of the allowed deviation V."""
    g = ctx["true_grad"]
    gn = g / torch.clamp(torch.linalg.vector_norm(g), min=1e-12)
    row = g - (1.0 + scale) * ctx["V"] * gn
    return _overwrite(grads, byz_mask, row[None, :])


def attack_hidden_shift(key, grads, byz_mask, ctx, c: float = 0.9):
    """The paper's 'hide inside the thresholds' adversary (Section 1.3):
    true gradient + c·V·u for the colluding unit direction u = 1/√d."""
    u = _inv_sqrt_d_ones(grads.shape[1], grads)
    row = ctx["true_grad"] + c * ctx["V"] * u
    return _overwrite(grads, byz_mask, row[None, :])


def attack_mirror(key, grads, byz_mask, ctx):
    """Section-5 lower-bound adversary: Byzantine workers behave as honest
    workers of the mirror objective (``ctx["mirror_grads"]``)."""
    return _overwrite(grads, byz_mask, ctx["mirror_grads"])


def attack_retreat_on_filter(key, grads, byz_mask, ctx, scale: float = 1.0):
    """Strike with the inner-product row while the whole coalition is alive
    per the previous filter decision (``ctx["alive"]``), else send honest
    rows.  The condition stays on the device: no host sync."""
    n_byz = torch.clamp(torch.sum(byz_mask), min=1)
    coalition_intact = torch.sum(ctx["alive"] & byz_mask) >= n_byz
    struck = attack_inner_product(key, grads, byz_mask, ctx, scale=scale)
    return torch.where(coalition_intact, struck, grads)


ATTACKS: dict[str, Callable] = {
    "none": attack_none,
    "sign_flip": attack_sign_flip,
    "random_gaussian": attack_random_gaussian,
    "constant_drift": attack_constant_drift,
    "alie": attack_alie,
    "alie_update": attack_alie_update,
    "inner_product": attack_inner_product,
    "hidden_shift": attack_hidden_shift,
    "mirror": attack_mirror,
    "retreat_on_filter": attack_retreat_on_filter,
}


def get_attack(name: str) -> Callable:
    if name not in ATTACKS:
        raise KeyError(f"unknown attack {name!r}; have {sorted(ATTACKS)}")
    return ATTACKS[name]


# combinators: scheduled and split adversaries from the primitives above.
# Each draws ``ka, kb = split(key)`` for its two attacks, as the JAX
# package does; the closed-over parameters may be Python numbers or 0-d
# tensors.

def phase_switch(attack_a: Callable, attack_b: Callable, switch_step) -> Callable:
    """Play ``attack_a`` while ``step < switch_step``, then ``attack_b``."""

    def attack(key, grads, byz_mask, ctx, **kwargs):
        ka, kb = prng.split(key)
        ga = attack_a(ka, grads, byz_mask, ctx, **kwargs)
        gb = attack_b(kb, grads, byz_mask, ctx, **kwargs)
        late = ctx["step"] >= switch_step
        if isinstance(late, torch.Tensor):
            return torch.where(late, gb, ga)
        return gb if late else ga

    return attack


def coalition(attack_a: Callable, attack_b: Callable, frac) -> Callable:
    """The first ⌈frac·n_byz⌉ Byzantine workers (by index) play
    ``attack_a``, the rest ``attack_b``."""

    def attack(key, grads, byz_mask, ctx, **kwargs):
        ka, kb = prng.split(key)
        ga = attack_a(ka, grads, byz_mask, ctx, **kwargs)
        gb = attack_b(kb, grads, byz_mask, ctx, **kwargs)
        rank = torch.cumsum(byz_mask, dim=0) - 1      # 0-based index among byz
        in_a = byz_mask & (rank < torch.ceil(torch.sum(byz_mask) * frac))
        return torch.where(in_a[:, None], ga, gb)

    return attack
