"""Stochastic convex objectives satisfying the paper's Assumption 2.2 —
the generated problem of :mod:`repro.data.problems`.

``make_generated_problem`` builds the diagonal quadratic f(x) = ½ Σⱼ hⱼ
(xⱼ − x*ⱼ)² with hⱼ log-spaced in [σ, L] and stochastic gradient ∇f(x) +
noise, noiseⱼ = (V/√d)·uniform(−1, 1) from threefry counters keyed on
(worker key, coordinate j).  ``h`` and ``x*`` come from numpy's
``default_rng(seed)`` exactly as in the JAX package, and the noise stream
is the same threefry stream, so the port samples the reference's batches.
``Problem.gen`` holds the :class:`~repro_torch.kernels.gradgen.GenSpec`
that ``SolverConfig.generate="kernel"`` regenerates the batch from.

``heterogenize_problem`` and ``heterogenize_generated`` give a problem
non-iid workers (DESIGN.md §13): worker w's gradient is biased by
``skew·C[w]`` for a zero-sum direction matrix C drawn from numpy's
``default_rng(seed)`` as in the JAX package, so C is the reference's bit
for bit.  The generated form keeps C rank 1 (``sign[w]·dir``), which the
generating kernels fold in as one scalar a worker.

``make_quadratic_problem`` (a dense H, sphere noise),
``make_least_squares_problem`` and ``make_logistic_problem`` (one sample
a worker and step) are the problems of the paper's own experiments.  Their
numpy construction is the JAX package's line for line, so a seed gives the
reference's arrays; their samplers are the batched form of the reference's
per-key sampler, drawn from the same key chain (``prng.normal``,
``uniform`` and ``randint`` over the (m, 2) worker keys).  The logistic
x* is 2000 gradient steps of the port's own gradient, so it matches the
reference's by tolerance; ``repro_torch.convert`` takes the reference's
x* where a test needs it exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng, resolve_device
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

    gen = gradgen.GenSpec(h=h, x_star=x_star, noise_scale=noise_scale,
                          het_dir=torch.zeros((d,), **f32))
    return Problem(d=d, f=f, grad=grad, stoch_grad=stoch_grad, x1=x1,
                   x_star=x_star, D=float(D), V=float(V), L=float(L),
                   sigma=float(sigma), gen=gen)


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


def _het_sampler(base, C: torch.Tensor):
    """``het_grad(worker_keys, x, skew)``: the base batch plus ``skew[w]·C[w]``
    on every row with a non-zero skew; a zero-skew row passes through bit
    for bit (``g + 0.0`` would turn −0.0 into +0.0)."""

    def het_grad(worker_keys, x, skew):
        g = base(worker_keys, x)
        s = skew[:, None]
        return torch.where(s != 0.0, g + s * C, g)

    return het_grad


def heterogenize_problem(problem: Problem, m: int, skew_max: float, seed: int = 0) -> Problem:
    """Non-iid per-worker gradients with the base problem's optimum: rows
    of C are centred, normalised and centred again (row sum exactly zero),
    ``V`` grows by ``skew_max·cmax`` (cmax the largest row norm) and
    ``het`` keeps ``{'V0', 'cmax', 'skew_max'}``."""
    if skew_max < 0:
        raise ValueError(f"skew_max must be >= 0, got {skew_max}")
    rng = np.random.default_rng(seed)
    C = rng.normal(size=(m, problem.d))
    C -= C.mean(axis=0, keepdims=True)
    C /= np.maximum(np.linalg.norm(C, axis=1, keepdims=True), 1e-12)
    C -= C.mean(axis=0, keepdims=True)
    cmax = float(np.linalg.norm(C, axis=1).max())
    C_t = torch.tensor(C.astype(np.float32), device=problem.x1.device)
    return problem._replace(
        V=problem.V + skew_max * cmax,
        het_grad=_het_sampler(problem.stoch_grad, C_t),
        het={"V0": float(problem.V), "cmax": cmax, "skew_max": float(skew_max)},
    )


def heterogenize_generated(problem: Problem, m: int, skew_max: float,
                           seed: int = 0) -> Problem:
    """:func:`heterogenize_problem` with C of rank 1, ``C[w] = sign[w]·dir``
    (a unit direction, signs alternating +1, −1, so the fleet sum is exactly
    zero), for a generated problem: ``GenSpec.het_dir`` is ``dir`` and
    ``GenSpec.het_sign`` the signs.  Since ``sign`` is ±1, ``skew·(sign·dir)``
    here and ``(skew·sign)·dir`` in the kernels give the same bits."""
    if problem.gen is None:
        raise ValueError("heterogenize_generated needs a generated problem "
                         "(make_generated_problem); use heterogenize_problem "
                         "for dense bias matrices")
    if skew_max < 0:
        raise ValueError(f"skew_max must be >= 0, got {skew_max}")
    if m % 2:
        raise ValueError(f"rank-1 zero-sum signs need even m, got {m}")
    dev = problem.x1.device
    rng = np.random.default_rng(seed)
    dvec = rng.normal(size=problem.d)
    dvec /= max(np.linalg.norm(dvec), 1e-12)
    dir_t = torch.tensor(dvec.astype(np.float32), device=dev)
    sign = torch.tensor(np.where(np.arange(m) % 2 == 0, 1.0, -1.0).astype(np.float32),
                        device=dev)
    cmax = float(np.linalg.norm(dvec))
    return problem._replace(
        V=problem.V + skew_max * cmax,
        het_grad=_het_sampler(problem.stoch_grad, sign[:, None] * dir_t[None, :]),
        het={"V0": float(problem.V), "cmax": cmax, "skew_max": float(skew_max)},
        gen=problem.gen._replace(het_dir=dir_t, het_sign=sign),
    )


def _f32(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), dtype=torch.float32, device=dev)


def _sphere_noise(worker_keys: torch.Tensor, d: int, V: float) -> torch.Tensor:
    """(m, d): per worker key, a direction uniform on the sphere times a
    radius r = V·u^{1/d} ≤ V (mean zero, ‖·‖ ≤ V a.s.), from ``nk, rk =
    split(key)`` as in the JAX package."""
    keys = prng.split(worker_keys)
    n = prng.normal(keys[:, 0], (d,))
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=1, keepdim=True), min=1e-12)
    r = V * prng.uniform(keys[:, 1], ()) ** (1.0 / d)
    return r[:, None] * n


def quadratic_problem(H, x_star, x1, D: float, V: float, L: float, sigma: float,
                      device="cuda") -> Problem:
    """f(x) = ½ (x−x*)ᵀ H (x−x*) with sphere noise, from its arrays on
    ``device``."""
    dev = resolve_device(device)
    H, x_star, x1 = _f32(H, dev), _f32(x_star, dev), _f32(x1, dev)
    d = H.shape[0]

    def f(x):
        r = x - x_star
        return (0.5 * r) @ H @ r

    def grad(x):
        return H @ (x - x_star)

    def stoch_grad(worker_keys, x):
        return grad(x)[None, :] + _sphere_noise(worker_keys, d, V)

    return Problem(d=d, f=f, grad=grad, stoch_grad=stoch_grad, x1=x1, x_star=x_star,
                   D=float(D), V=float(V), L=float(L), sigma=float(sigma))


def make_quadratic_problem(d: int = 16, sigma: float = 1.0, L: float = 10.0, V: float = 1.0,
                           D: float | None = None, seed: int = 0,
                           device="cuda") -> Problem:
    """spec(H) ⊂ [σ, L] in a random orthogonal basis (σ-strongly convex,
    L-smooth); stochastic gradient ∇f(x) + sphere noise of radius ≤ V."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    eigs = np.geomspace(sigma, L, d)
    H = ((Q * eigs) @ Q.T).astype(np.float32)
    x_star = (rng.normal(size=(d,)) / np.sqrt(d)).astype(np.float32)
    if D is None:
        D = float(2.0 * np.linalg.norm(x_star))
    return quadratic_problem(H, x_star, np.zeros((d,), np.float32), D, V, L, sigma, device)


def _sample_rows(worker_keys: torch.Tensor, n_data: int) -> torch.Tensor:
    """(m,) int64: each worker's ``randint(key, (), 0, n_data)``."""
    return prng.randint(worker_keys, (), 0, n_data).to(torch.int64)


def least_squares_problem(A, b, x_star, x1, D: float, V: float, L: float, sigma: float,
                          device="cuda") -> Problem:
    """f(x) = (1/2n) Σ (aᵢᵀx − bᵢ)², one sampled row a worker, from its
    arrays on ``device``."""
    dev = resolve_device(device)
    A, b, x_star, x1 = _f32(A, dev), _f32(b, dev), _f32(x_star, dev), _f32(x1, dev)
    n_data, d = A.shape

    def f(x):
        r = A @ x - b
        return 0.5 * torch.mean(r * r)

    def grad(x):
        return A.T @ (A @ x - b) / n_data

    def stoch_grad(worker_keys, x):
        i = _sample_rows(worker_keys, n_data)
        a = A[i]
        return a * (a @ x - b[i])[:, None]

    return Problem(d=d, f=f, grad=grad, stoch_grad=stoch_grad, x1=x1, x_star=x_star,
                   D=float(D), V=float(V), L=float(L), sigma=float(sigma))


def make_least_squares_problem(d: int = 16, n_data: int = 512, noise: float = 0.1,
                               V: float | None = None, seed: int = 0,
                               device="cuda") -> Problem:
    """Least squares on Gaussian rows; V is the largest deviation of a
    sampled gradient over 64 points on the ball's boundary (numpy), so the
    a.s. bound holds on the data."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_data, d)) / np.sqrt(d)
    x_true = rng.normal(size=(d,))
    b = A @ x_true + noise * rng.normal(size=(n_data,))
    eigs = np.linalg.eigvalsh((A.T @ A) / n_data)
    x_star = np.linalg.lstsq(A, b, rcond=None)[0]
    D = float(2.0 * np.linalg.norm(x_star) + 1.0)
    if V is None:
        xs = x_star[None, :] + D * rng.normal(size=(64, d)) / np.sqrt(d)
        devs = []
        for x in xs:
            g = A @ x - b
            per_row = A * g[:, None]
            devs.append(np.abs(per_row - (A.T @ g / n_data)[None, :]).sum(-1).max())
        V = float(np.max(devs))
    return least_squares_problem(A, b, x_star, np.zeros((d,), np.float32), D, V,
                                 float(eigs[-1]), float(max(eigs[0], 0.0)), device)


LOGISTIC_STEPS = 2000   # gradient steps of step 1/L that give the logistic x*


def logistic_problem(A, y, reg: float, x_star, x1, D: float, V: float, L: float,
                     device="cuda") -> Problem:
    """ℓ2-regularised logistic regression, one sampled example a worker,
    from its arrays on ``device``; σ = reg."""
    dev = resolve_device(device)
    A, y, x_star, x1 = _f32(A, dev), _f32(y, dev), _f32(x_star, dev), _f32(x1, dev)
    n_data, d = A.shape

    def f(x):
        margins = y * (A @ x)
        return (torch.mean(torch.logaddexp(torch.zeros_like(margins), -margins))
                + ((0.5 * reg) * x) @ x)

    def grad(x):
        s = -torch.sigmoid(-(y * (A @ x))) * y
        return A.T @ s / n_data + reg * x

    def stoch_grad(worker_keys, x):
        i = _sample_rows(worker_keys, n_data)
        a, yy = A[i], y[i]
        s = -torch.sigmoid(-(yy * (a @ x))) * yy
        return a * s[:, None] + reg * x[None, :]

    return Problem(d=d, f=f, grad=grad, stoch_grad=stoch_grad, x1=x1, x_star=x_star,
                   D=float(D), V=float(V), L=float(L), sigma=float(reg))


def make_logistic_problem(d: int = 16, n_data: int = 512, reg: float = 1e-2, seed: int = 0,
                          device="cuda") -> Problem:
    """Logistic regression on Gaussian rows with labels drawn from a
    logistic model of a random x_true: L = max‖aᵢ‖²/4 + reg, V =
    2·max‖aᵢ‖, and x* is LOGISTIC_STEPS gradient steps of step 1/L from 0,
    taken on ``device`` with the problem's own gradient; D = 2‖x*‖ + 1."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_data, d)) / np.sqrt(d)
    x_true = rng.normal(size=(d,))
    p = 1.0 / (1.0 + np.exp(-A @ x_true))
    y = (rng.uniform(size=n_data) < p).astype(np.float32) * 2.0 - 1.0
    row_norms = np.linalg.norm(A, axis=1)
    L = float(np.max(row_norms) ** 2 / 4.0 + reg)
    zeros = np.zeros((d,), np.float32)
    problem = logistic_problem(A, y, reg, zeros, zeros, 1.0, float(2.0 * np.max(row_norms)),
                               L, device)
    x = problem.x1
    for _ in range(LOGISTIC_STEPS):
        x = x - (1.0 / L) * problem.grad(x)
    return problem._replace(x_star=x, D=float(2.0 * np.linalg.norm(x.cpu().numpy()) + 1.0))
