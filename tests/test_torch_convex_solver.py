"""The paper's convex experiments in the port against the JAX package:
``run_sgd`` on the quadratic, least-squares and logistic problems (each
carried across with ``convert``, so both packages hold the same arrays and
x*), the scenario adversary's ``random_gaussian`` through ``run_sgd``,
``ByzantineSGDSolver``, the Section-4 epoch solver and the Section-5
distinguishing experiments.

Decisions are exact everywhere: ``n_alive`` at every step,
``final_alive``, ``byz_mask`` and ``ever_filtered_good``, the epoch
solver's per-epoch T, the experiments' trials won and ``threshold_T``.
Values: ``x_avg`` within 1e-5 relative at f32 and 1e-2 at bf16
(``tests/test_fused_guard.py``'s tolerances); the epoch solver's gaps
within 1e-5 relative; the 1-D guard's x̄ per trial within 1e-5.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import epoch_solver as jepoch
from repro.core import lower_bound as jlb
from repro.core import solver as jsolver
from repro.data import problems as jproblems
from repro.scenarios import adversary as jadv
from repro.scenarios import spec as jspec
from repro_torch import convert, prng
from repro_torch.core import epoch_solver, lower_bound
from repro_torch.core.solver import ByzantineSGDSolver, SolverConfig, run_sgd
from repro_torch.data import problems
from repro_torch.scenarios import adversary

M, T = 16, 30
TOL = {"f32": 1e-5, "bf16": 1e-2}


def _closure(fn, name):
    return np.asarray(fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents)


def _pair(name):
    """(JAX problem, the port's problem carried from it on the CPU)."""
    if name == "quadratic":
        jp = jproblems.make_quadratic_problem(d=16, sigma=1.0, L=8.0, V=1.0, seed=1)
        tp = convert.quadratic_problem_from_numpy(
            _closure(jp.f, "H"), np.asarray(jp.x_star), np.asarray(jp.x1), jp.D, jp.V, jp.L,
            jp.sigma, device="cpu")
    elif name == "least_squares":
        jp = jproblems.make_least_squares_problem(d=16, n_data=128, seed=3)
        tp = convert.least_squares_problem_from_numpy(
            _closure(jp.f, "A_j"), _closure(jp.f, "b_j"), np.asarray(jp.x_star),
            np.asarray(jp.x1), jp.D, jp.V, jp.L, jp.sigma, device="cpu")
    else:
        jp = jproblems.make_logistic_problem(d=10, n_data=256, reg=1e-2, seed=2)
        tp = convert.logistic_problem_from_numpy(
            _closure(jp.f, "A_j"), _closure(jp.f, "y_j"), jp.sigma, np.asarray(jp.x_star),
            np.asarray(jp.x1), jp.D, jp.V, jp.L, device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def pairs():
    return {name: _pair(name) for name in ("quadratic", "least_squares", "logistic")}


def _assert_same_run(got, want, tol, what=""):
    for field in ("n_alive", "final_alive", "byz_mask", "ever_filtered_good"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=f"{what} {field}")
    want_x = np.asarray(want.x_avg)
    err = np.linalg.norm(got.x_avg.numpy() - want_x) / np.linalg.norm(want_x)
    assert err <= tol, (what, err)


# the JAX reference of each port run: the guard's dense and fused forms
# make the same decisions (the JAX package pins it), so both port forms at
# one stats dtype are held to the JAX dense run at that dtype
RUNS = {
    "dense@f32": (dict(guard_backend="dense"), "byz@f32"),
    "fused@f32": (dict(guard_backend="fused"), "byz@f32"),
    "fused@bf16": (dict(guard_backend="fused", stats_dtype="bf16"), "byz@bf16"),
    "mean": (dict(aggregator="mean"), "mean"),
    "krum": (dict(aggregator="krum"), "krum"),
    "coordinate_median": (dict(aggregator="coordinate_median"), "coordinate_median"),
}
JAX_RUNS = {"byz@f32": dict(), "byz@bf16": dict(stats_dtype="bf16"),
            "mean": dict(aggregator="mean"), "krum": dict(aggregator="krum"),
            "coordinate_median": dict(aggregator="coordinate_median")}
BASE = dict(m=M, T=T, eta=0.05, alpha=0.25, aggregator="byzantine_sgd")


@pytest.fixture(scope="module")
def jax_runs(pairs):
    out = {}

    def get(problem, attack, ref):
        if (problem, attack, ref) not in out:
            cfg = jsolver.SolverConfig(**{**BASE, "attack": attack, **JAX_RUNS[ref]})
            out[(problem, attack, ref)] = jsolver.run_sgd(pairs[problem][0], cfg,
                                                          jax.random.PRNGKey(0))
        return out[(problem, attack, ref)]

    return get


@pytest.mark.parametrize("attack", ["sign_flip", "random_gaussian"])
@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("problem", ["quadratic", "least_squares", "logistic"])
def test_run_sgd_matches_jax(pairs, jax_runs, problem, run, attack):
    over, ref = RUNS[run]
    cfg = SolverConfig(**{**BASE, "attack": attack, **over})
    got = run_sgd(pairs[problem][1], cfg, prng.PRNGKey(0), device="cpu")
    want = jax_runs(problem, attack, ref)
    _assert_same_run(got, want, TOL["bf16" if "bf16" in run else "f32"],
                     f"{problem} {run} {attack}")
    if run.startswith(("dense", "fused")):
        # the attackers are caught and no honest worker is
        assert not bool(got.ever_filtered_good)


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_scenario_random_gaussian_across_a_switch_matches_jax(pairs, backend):
    """id 2 in phase b after lying low (phase a sign_flip at scale 0 is
    none): the same decisions as the reference before and after step 20."""
    jp, tp = pairs["quadratic"]
    jscn = jspec.make_scenario(attack_a="none", attack_b="random_gaussian", switch_step=20)
    tscn = convert.scenario_from_numpy(*map(np.asarray, jscn))
    cfg = dict(BASE, T=32, guard_backend=backend)
    want = jsolver.run_sgd(jp, jsolver.SolverConfig(**cfg), jax.random.PRNGKey(1),
                           adversary=jadv.ScenarioAdversary(jscn, jnp.float32(0.25)))
    got = run_sgd(tp, SolverConfig(**cfg), prng.PRNGKey(1), device="cpu",
                  adversary=adversary.ScenarioAdversary(tscn, 0.25))
    _assert_same_run(got, want, TOL["f32"], backend)
    n_alive = got.n_alive.numpy()
    assert (n_alive[:20] == M).all() and n_alive[-1] == M - 4


def test_byzantine_sgd_solver_matches_run_sgd_and_jax(pairs):
    jp, tp = pairs["quadratic"]
    cfg = dict(BASE, attack="random_gaussian")
    solver = ByzantineSGDSolver(tp, SolverConfig(**cfg), device="cpu")
    res = solver.run(3)
    ref = run_sgd(tp, SolverConfig(**cfg), prng.PRNGKey(3), device="cpu")
    for field in res._fields:
        a, b = getattr(res, field), getattr(ref, field)
        assert (a is None and b is None) or torch.equal(a, b), field
    want = jsolver.ByzantineSGDSolver(jp, jsolver.SolverConfig(**cfg)).suboptimality(3)
    assert solver.suboptimality(3) == pytest.approx(want, rel=1e-4, abs=1e-7)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ByzantineSGDSolver(tp, SolverConfig(**cfg))


@pytest.mark.parametrize("alpha", [0.0, 0.1, 0.25, 0.45])
def test_theory_iterations_matches_jax(alpha):
    for L, sigma, D, V, m, eps, delta, t_scale in [
            (8.0, 1.0, 1.6, 1.0, 16, 0.6, 1e-3, 0.05), (8.0, 1.0, 0.2, 1.0, 16, 2e-3, 1e-3, 1.0),
            (1.0, 0.1, 10.0, 3.0, 4, 1e-2, 1e-2, 0.5), (100.0, 1.0, 0.5, 0.1, 64, 1e-4, 1e-3, 2.0)]:
        args = (L, sigma, D, V, m, alpha, eps, delta, t_scale)
        assert epoch_solver.theory_iterations(*args) == jepoch.theory_iterations(*args), args


def test_solve_strongly_convex_matches_jax(pairs):
    jp, tp = pairs["quadratic"]
    kw = dict(m=8, alpha=0.25, epsilon=0.2, attack="sign_flip", t_scale=0.05,
              max_t_per_epoch=60)
    want = jepoch.solve_strongly_convex(jp, jepoch.EpochSolverConfig(**kw),
                                        jax.random.PRNGKey(0))
    got = epoch_solver.solve_strongly_convex(tp, epoch_solver.EpochSolverConfig(**kw),
                                             prng.PRNGKey(0), device="cpu")
    assert got.per_epoch_T == want.per_epoch_T and got.epochs == want.epochs
    assert got.total_iters == want.total_iters
    np.testing.assert_allclose(got.per_epoch_gap, want.per_epoch_gap, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="strongly convex"):
        epoch_solver.solve_strongly_convex(tp._replace(sigma=0.0),
                                           epoch_solver.EpochSolverConfig(m=8),
                                           prng.PRNGKey(0), device="cpu")


@pytest.mark.parametrize("T", [2, 32])
@pytest.mark.parametrize("experiment", ["distinguishing_experiment_linear",
                                        "distinguishing_experiment_strongly_convex"])
def test_distinguishing_experiments_match_jax(experiment, T):
    kw = dict(m=16, T=T, n_trials=12, alpha=0.3)
    want = getattr(jlb, experiment)(jax.random.PRNGKey(T), **kw)
    got = getattr(lower_bound, experiment)(prng.PRNGKey(T), device="cpu", **kw)
    # the same trials won: the reference's rate is an f32 mean, the port's
    # the exact quotient
    assert round(got.success_rate * 12) == round(float(want.success_rate) * 12)
    assert got.success_rate == pytest.approx(float(want.success_rate), rel=1e-6)
    assert got.threshold_T == want.threshold_T


def test_trial_loop_matches_the_reference_guard():
    """The vmapped 1-D guard's x̄ per trial against the reference's scan
    over the same (T, m) messages, one trial at a time."""
    rng = np.random.default_rng(0)
    samples = rng.normal(0.05, 1.0, size=(3, 40, 16)).astype(np.float32)
    samples[:, :, :4] *= -1.0
    eta = 1.0 / math.sqrt(40)
    got = lower_bound._run_trials(lambda x, g: g[:, :, None], torch.from_numpy(samples),
                                  1.0, 1.0, eta, 1e-3).numpy()
    want = [float(jlb._run_one_dim_byzantine_sgd(jnp.asarray(s), 1.0, 1.0, eta, 1e-3))
            for s in samples]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
