"""Stochastic convex objectives satisfying the paper's Assumption 2.2 —
the generated problem of :mod:`repro.data.problems`.

``make_generated_problem`` builds the diagonal quadratic f(x) = ½ Σⱼ hⱼ
(xⱼ − x*ⱼ)² with hⱼ log-spaced in [σ, L] and stochastic gradient ∇f(x) +
noise, noiseⱼ = (V/√d)·uniform(−1, 1) from threefry counters keyed on
(worker key, coordinate j).  ``h`` and ``x*`` come from numpy's
``default_rng(seed)`` exactly as in the JAX package, and the noise stream
is the same threefry stream, so the port samples the reference's batches.
The quadratic problem with sphere noise draws ``jax.random.normal`` and is
not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.solver import Problem
from repro_torch.kernels import gradgen


def generated_problem(h, x_star, x1, D: float, V: float, L: float,
                      sigma: float, noise_scale: float, device="cuda") -> Problem:
    """The generated problem from its arrays (numpy or tensors) on ``device``."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    h = torch.tensor(np.asarray(h, np.float32), **f32)
    x_star = torch.tensor(np.asarray(x_star, np.float32), **f32)
    x1 = torch.tensor(np.asarray(x1, np.float32), **f32)
    d = h.shape[0]
    noise_scale = float(np.float32(noise_scale))
    coords = torch.arange(d, dtype=torch.int64, device=dev)[None, :]

    def f(x):
        r = x - x_star
        return 0.5 * torch.sum(h * r * r)

    def grad(x):
        return gradgen.mean_grad(h, x, x_star)

    def stoch_grad(worker_keys, x):
        kd = gradgen.key_bits(worker_keys)
        return (gradgen.mean_grad(h, x, x_star)[None, :]
                + gradgen.noise_row(kd[:, 0:1], kd[:, 1:2], coords, noise_scale))

    return Problem(d=d, f=f, grad=grad, stoch_grad=stoch_grad, x1=x1,
                   x_star=x_star, D=float(D), V=float(V), L=float(L),
                   sigma=float(sigma))


def make_generated_problem(d: int = 16, sigma: float = 1.0, L: float = 10.0,
                           V: float = 1.0, D: float | None = None, seed: int = 0,
                           device="cuda") -> Problem:
    """The counter-generatable quadratic of the JAX package, on ``device``."""
    rng = np.random.default_rng(seed)
    h = np.geomspace(sigma, L, d).astype(np.float32)
    x_star = (rng.normal(size=(d,)) / np.sqrt(d)).astype(np.float32)
    if D is None:
        # numpy's f32 norm, as the JAX package takes it
        D = float(2.0 * np.linalg.norm(x_star))
    noise_scale = np.float32(V) / np.sqrt(np.float32(d))
    return generated_problem(h, x_star, np.zeros((d,), np.float32), D, V, L,
                             sigma, noise_scale, device)
