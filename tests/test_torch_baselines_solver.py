"""The port's ``run_sgd`` with every baseline aggregator against the JAX
package's ``run_sgd``, on the generated problem from the same seed and key.

The port rebuilds the reference's key chain and noise stream, so both
runs see the same honest batches; every registered baseline, the
``bucket2:krum`` / ``bucket2:byzantine_sgd`` compositions and Krum under
ALIE must give ``x_avg``, ``x_final`` and the gaps within 1e-5 relative,
with the all-alive reporting of baselines.  m = 8, d = 257, T = 20.
"""
import jax
import numpy as np
import pytest

from repro.core import aggregators as jagg
from repro.core.solver import SolverConfig as JaxConfig
from repro.core.solver import run_sgd as jax_run_sgd
from repro.data.problems import make_generated_problem as jax_problem
from repro_torch import prng
from repro_torch.core import solver
from repro_torch.core.solver import SolverConfig, run_sgd
from repro_torch.data.problems import make_generated_problem

D_DIM, M, T = 257, 8, 20
BASE = dict(m=M, T=T, eta=0.05, alpha=0.25, attack="sign_flip")


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    assert err <= tol * np.linalg.norm(want) + tol, (err, np.linalg.norm(want))


def _both(seed=3, **over):
    kw = {**BASE, **over}
    want = jax_run_sgd(jax_problem(d=D_DIM, seed=seed), JaxConfig(**kw),
                       jax.random.PRNGKey(seed))
    got = run_sgd(make_generated_problem(d=D_DIM, seed=seed, device="cpu"),
                  SolverConfig(**kw), prng.PRNGKey(seed), device="cpu")
    return got, want


def _assert_runs_agree(got, want, tol=1e-5):
    np.testing.assert_array_equal(got.n_alive.numpy(), np.asarray(want.n_alive))
    np.testing.assert_array_equal(got.final_alive.numpy(), np.asarray(want.final_alive))
    np.testing.assert_array_equal(got.byz_mask.numpy(), np.asarray(want.byz_mask))
    _rel_close(got.x_avg.numpy(), want.x_avg, tol)
    _rel_close(got.x_final.numpy(), want.x_final, tol)
    _rel_close(got.gaps.numpy(), want.gaps, tol)


ROSTER = list(jagg.aggregator_names()) + ["bucket2:krum", "bucket2:byzantine_sgd"]


@pytest.mark.parametrize("name", ROSTER)
def test_baseline_run_sgd_matches_jax(name):
    got, want = _both(aggregator=name)
    _assert_runs_agree(got, want)
    assert int(got.n_alive[-1]) == M and bool(got.final_alive.all())


@pytest.mark.parametrize("name", ["krum", "coordinate_median"])
def test_baseline_under_alie_matches_jax(name):
    got, want = _both(seed=4, aggregator=name, attack="alie")
    _assert_runs_agree(got, want)


@pytest.mark.parametrize("name", ["krum", "coordinate_median"])
def test_baseline_past_32_workers_matches_jax(name):
    """m = 40 workers: past the register sort's 32 and the first Gram's
    single worker tile, which the card's kernels now take."""
    kw = {**BASE, "m": 40, "aggregator": name}
    want = jax_run_sgd(jax_problem(d=D_DIM, seed=6), JaxConfig(**kw), jax.random.PRNGKey(6))
    got = run_sgd(make_generated_problem(d=D_DIM, seed=6, device="cpu"), SolverConfig(**kw),
                  prng.PRNGKey(6), device="cpu")
    _assert_runs_agree(got, want)


@pytest.mark.parametrize("over", [
    dict(aggregator="krum", krum_f=1),
    dict(aggregator="trimmed_mean", trim_fraction=0.25),
    dict(aggregator="centered_clip", agg_opts=(("clip_tau", 0.5), ("lamb", 1.0))),
    dict(aggregator="bucket2:trimmed_mean", agg_opts=(("bucket_seed", 7),)),
])
def test_baseline_knobs_match_jax(over):
    got, want = _both(seed=5, **over)
    _assert_runs_agree(got, want)


def test_knob_validation_and_specs_mirror_jax():
    from repro.core import solver as jsolver
    problem = make_generated_problem(d=8, device="cpu")
    with pytest.raises(KeyError, match="unknown agg_opts"):
        solver.make_aggregator(problem, SolverConfig(m=4, T=2, eta=0.1, aggregator="krum",
                                                     agg_opts=(("clip_taux", 1.0),)), "cpu")
    with pytest.raises(ValueError, match="s | m"):
        solver.make_aggregator(problem, SolverConfig(m=6, T=2, eta=0.1,
                                                     aggregator="bucket4:krum"), "cpu")
    for spec in ("bucket2:krum", "krum", "bucket3:bucket2:mean", "bucketx"):
        assert solver.parse_aggregator_spec(spec) == jsolver.parse_aggregator_spec(spec)
    for spec in ("bucketx:krum", "bucket0:krum"):
        with pytest.raises(KeyError):
            solver.parse_aggregator_spec(spec)
    for alpha, m in ((0.25, 8), (0.3, 10), (0.0, 5), (0.49, 33)):
        assert solver.ceil_byzantine_count(alpha, m) == jsolver.ceil_byzantine_count(alpha, m)
        assert (SolverConfig(m=m, T=1, eta=0.1, alpha=alpha).krum_f_default
                == JaxConfig(m=m, T=1, eta=0.1, alpha=alpha).krum_f_default)
