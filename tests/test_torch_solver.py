"""The port's convex driver against the JAX package's ``run_sgd``.

Both run the generated problem from the same seed.  The port rebuilds the
reference's key chain (``repro_torch.prng``) and noise stream, so the
honest batches agree to within an ulp and the filter decisions must agree
exactly: ``n_alive`` at every step, ``final_alive`` and ``byz_mask``.
``x_avg`` and the gaps agree within 1e-5 relative (f32) or 1e-2 (bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attacks as jattacks
from repro.core.solver import SolverConfig as JaxConfig
from repro.core.solver import run_sgd as jax_run_sgd
from repro.data.problems import make_generated_problem as jax_problem
from repro_torch import convert, prng
from repro_torch.core import attacks
from repro_torch.core.solver import SolverConfig, run_sgd
from repro_torch.data.problems import make_generated_problem

D_DIM = 257
TOL = {"f32": 1e-5, "bf16": 1e-2}


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    assert err <= tol * np.linalg.norm(want) + tol, (err, np.linalg.norm(want))


def _assert_runs_agree(got, want, tol):
    np.testing.assert_array_equal(got.n_alive.numpy(), np.asarray(want.n_alive))
    np.testing.assert_array_equal(got.final_alive.numpy(), np.asarray(want.final_alive))
    np.testing.assert_array_equal(got.byz_mask.numpy(), np.asarray(want.byz_mask))
    assert bool(got.ever_filtered_good) == bool(want.ever_filtered_good)
    _rel_close(got.x_avg.numpy(), want.x_avg, tol)
    _rel_close(got.x_final.numpy(), want.x_final, tol)
    _rel_close(got.gaps.numpy(), want.gaps, tol)


@pytest.mark.parametrize("backend,sd", [("fused", "f32"), ("fused", "bf16"), ("dense", "f32")])
def test_run_sgd_matches_jax(backend, sd):
    kw = dict(m=8, T=70, eta=0.05, alpha=0.25, attack="sign_flip",
              aggregator="byzantine_sgd", guard_backend=backend, stats_dtype=sd)
    want = jax_run_sgd(jax_problem(d=D_DIM, seed=0), JaxConfig(**kw), jax.random.PRNGKey(0))
    got = run_sgd(make_generated_problem(d=D_DIM, seed=0, device="cpu"), SolverConfig(**kw),
                  prng.PRNGKey(0), device="cpu")
    _assert_runs_agree(got, want, TOL[sd])
    # the two Byzantine workers are filtered at once and no honest one is
    assert int(got.n_alive[0]) == 6 and not bool(got.ever_filtered_good)
    assert int(got.byz_mask.sum()) == 2 and not bool((got.final_alive & got.byz_mask).any())


def test_mean_baseline_matches_jax_and_breaks():
    kw = dict(m=8, T=30, eta=0.05, alpha=0.25, attack="sign_flip", aggregator="mean")
    want = jax_run_sgd(jax_problem(d=D_DIM, seed=2), JaxConfig(**kw), jax.random.PRNGKey(2))
    got = run_sgd(make_generated_problem(d=D_DIM, seed=2, device="cpu"), SolverConfig(**kw),
                  prng.PRNGKey(2), device="cpu")
    _assert_runs_agree(got, want, 1e-5)
    guarded = run_sgd(make_generated_problem(d=D_DIM, seed=2, device="cpu"),
                      SolverConfig(**{**kw, "aggregator": "byzantine_sgd"}),
                      prng.PRNGKey(2), device="cpu")
    assert float(got.gaps[-1]) > 10 * float(guarded.gaps[-1])


def test_generated_problem_matches_jax():
    jp = jax_problem(d=D_DIM, sigma=1.0, L=8.0, V=2.0, seed=4)
    tp = make_generated_problem(d=D_DIM, sigma=1.0, L=8.0, V=2.0, seed=4, device="cpu")
    assert (tp.d, tp.D, tp.V, tp.L, tp.sigma) == (jp.d, jp.D, jp.V, jp.L, jp.sigma)
    np.testing.assert_array_equal(tp.x_star.numpy(), np.asarray(jp.x_star))
    x = np.random.default_rng(0).normal(size=D_DIM).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(9), 5)
    want = jax.vmap(lambda k: jp.stoch_grad(k, jnp.asarray(x)))(keys)
    got = tp.stoch_grad(torch.from_numpy(np.asarray(keys).astype(np.int64)), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tp.grad(torch.from_numpy(x)).numpy(),
                                  np.asarray(jp.grad(jnp.asarray(x))))
    _rel_close(float(tp.f(torch.from_numpy(x))), float(jp.f(jnp.asarray(x))), 1e-6)
    # the same problem handed over as arrays
    cp = convert.problem_from_numpy(np.asarray(jp.gen.h), np.asarray(jp.x_star),
                                    np.asarray(jp.x1), jp.D, jp.V, jp.L, jp.sigma,
                                    np.asarray(jp.gen.noise_scale), device="cpu")
    got2 = cp.stoch_grad(torch.from_numpy(np.asarray(keys).astype(np.int64)),
                         torch.from_numpy(x))
    assert torch.equal(got2, got)


@pytest.mark.parametrize("name", ["none", "sign_flip", "constant_drift", "inner_product"])
def test_static_attacks_match_jax(name):
    rng = np.random.default_rng(1)
    m, d = 6, 33
    g = rng.normal(size=(m, d)).astype(np.float32)
    tg = rng.normal(size=d).astype(np.float32)
    mask = np.array([True, False, False, True, False, False])
    want = jattacks.get_attack(name)(None, jnp.asarray(g), jnp.asarray(mask),
                                     {"true_grad": jnp.asarray(tg), "V": 1.5})
    got = attacks.get_attack(name)(None, torch.from_numpy(g), torch.from_numpy(mask),
                                   {"true_grad": torch.from_numpy(tg), "V": 1.5})
    np.testing.assert_array_equal(got[~mask].numpy(), g[~mask])   # honest rows untouched
    _rel_close(got.numpy(), want, 1e-6)


def test_run_sgd_defaults_to_the_card():
    """With no ``device`` the entry points ask for CUDA: on a machine
    without a card they raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = SolverConfig(m=4, T=2, eta=0.1)
    problem = make_generated_problem(d=8, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sgd(problem, cfg, prng.PRNGKey(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_generated_problem(d=8)


@pytest.mark.parametrize("field,value", [
    ("generate", "kernel"), ("max_delay", 2), ("partial_participation", True),
    ("generate", "fast")])
def test_run_sgd_rejects_unported_options(field, value):
    """``generate="kernel"`` is not ported and raises; any other value than
    "off"/"kernel" is a ValueError, as in the JAX package.  ``max_delay``
    and ``partial_participation`` act only through a scenario adversary's
    profile, so without one the run equals the run without them, as the
    JAX package's does."""
    cfg = SolverConfig(m=4, T=3, eta=0.1, alpha=0.25)
    problem = make_generated_problem(d=8, device="cpu")
    if field == "generate":
        with pytest.raises(NotImplementedError if value == "kernel" else ValueError,
                           match="not ported" if value == "kernel" else "generate must be"):
            run_sgd(problem, cfg._replace(generate=value), prng.PRNGKey(0), device="cpu")
        with pytest.raises(ValueError, match="generate must be"):
            jax_run_sgd(jax_problem(d=8), JaxConfig(m=4, T=3, eta=0.1, generate="fast"),
                        jax.random.PRNGKey(0))
        return
    got = run_sgd(problem, cfg._replace(**{field: value}), prng.PRNGKey(0), device="cpu")
    want = run_sgd(problem, cfg, prng.PRNGKey(0), device="cpu")
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("aggregator", ["coordinate_median", "bucket2:krum", "byzantine_sgd"])
def test_final_alive_is_the_carried_membership(aggregator):
    """``final_alive`` is the aggregator state's ``alive`` where it keeps
    one (the guards) and all-true otherwise, as in the JAX package.  With a
    sampler that returns NaN rows at every step, quarantine drops every row
    at the last step: a baseline still reports everyone at the end, the
    guard no one."""
    kw = dict(m=8, T=3, eta=0.05, alpha=0.25, attack="sign_flip", aggregator=aggregator,
              sanitize="quarantine")
    jp = jax_problem(d=16, seed=5)
    jp = jp._replace(stoch_grad=lambda k, x: jnp.full_like(x, jnp.nan))
    tp = make_generated_problem(d=16, seed=5, device="cpu")
    tp = tp._replace(stoch_grad=lambda keys, x: torch.full((keys.shape[0], x.shape[0]),
                                                            float("nan")))
    want = jax_run_sgd(jp, JaxConfig(**kw), jax.random.PRNGKey(0))
    got = run_sgd(tp, SolverConfig(**kw), prng.PRNGKey(0), device="cpu")
    np.testing.assert_array_equal(got.final_alive.numpy(), np.asarray(want.final_alive))
    np.testing.assert_array_equal(got.n_alive.numpy(), np.asarray(want.n_alive))
    assert bool(got.final_alive.all()) == (aggregator != "byzantine_sgd")


def test_run_sgd_rejects_an_unknown_sanitize_mode():
    cfg = SolverConfig(m=4, T=2, eta=0.1, sanitize="drop")
    with pytest.raises(ValueError, match="sanitize"):
        run_sgd(make_generated_problem(d=8, device="cpu"), cfg, prng.PRNGKey(0), device="cpu")


def test_run_sgd_rejects_unported_attack_and_aggregator():
    problem = make_generated_problem(d=8, device="cpu")
    cfg = SolverConfig(m=4, T=2, eta=0.1)
    for kw in ({"adversary": object()}, {"telemetry": object()}):
        with pytest.raises(NotImplementedError, match="not ported"):
            run_sgd(problem, cfg, prng.PRNGKey(0), device="cpu", **kw)
    with pytest.raises(KeyError, match="random_gaussian"):
        run_sgd(problem, SolverConfig(m=4, T=2, eta=0.1, attack="random_gaussian"),
                prng.PRNGKey(0), device="cpu")
    with pytest.raises(KeyError, match="no_such_rule"):
        run_sgd(problem, SolverConfig(m=4, T=2, eta=0.1, aggregator="no_such_rule"),
                prng.PRNGKey(0), device="cpu")
