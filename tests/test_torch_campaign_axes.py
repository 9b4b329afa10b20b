"""Campaigns in the port against the JAX package on the CPU, continued
(``tests/test_torch_campaign.py`` holds the grid, the variants, the main
grid's runs and the report):

* ``chunk_size`` 1, 5, 12 and 64 on one group of 8 runs (churn, m = 16,
  T = 20): every stat bit for bit, for the guard variants (as the
  reference pins them) and for the mean too (the reference leaves its
  stateless ones out: XLA moves them by an ulp);
* a profile axis (iid, ``profile_linear_skew``, ``profile_stragglers``
  with staleness and partial participation armed, on the heterogenized
  problem) and a fault axis (none + ``nan_rows`` under quarantine) inside
  the groups: decisions equal to JAX's, gaps and ``report_frac`` within
  1e-5 relative;
* ``iters_to_eps_batch`` and Table 1's backend section (T = 80) against
  ``benchmarks/bench_table1.py``: each seed's iterations-to-ε equal.
"""
import numpy as np
import pytest
import torch

from benchmarks import bench_table1
from repro.core.solver import SolverConfig as JaxConfig
from repro.data import problems as jproblems
from repro.scenarios import campaign as jcampaign
from repro.scenarios import faults as jfaults
from repro.scenarios import spec as jspec
from repro_torch import convert
from repro_torch.data import problems
from repro_torch.experiments import table1
from repro_torch.scenarios import campaign, faults, spec

M, T = 16, 40
TOL = 1e-5   # against JAX (tests/test_torch_convex_solver.py's x_avg tolerance)
INT_FIELDS = ("n_alive_final", "n_byz_ever", "detect_latency", "ever_filtered_good")
STAT_FIELDS = INT_FIELDS + ("gap_avg", "gap_final", "gaps")
CHUNKED = ("byzantine_sgd@dense", "byzantine_sgd@fused", "byzantine_sgd@dp_sketch", "mean")


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol, what=""):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    err = np.linalg.norm(got - want)
    assert err <= tol * np.linalg.norm(want) + 1e-12, (what, err, np.linalg.norm(want))


def _cfg(mod, **over):
    return mod.SolverConfig(**{**dict(m=M, T=T, eta=0.05, alpha=0.25), **over})


def _quadratic():
    jp = jproblems.make_quadratic_problem(d=16, sigma=1.0, L=8.0, V=1.0, seed=0)
    H = np.asarray(jp.f.__closure__[jp.f.__code__.co_freevars.index("H")].cell_contents)
    tp = convert.quadratic_problem_from_numpy(H, np.asarray(jp.x_star), np.asarray(jp.x1),
                                              jp.D, jp.V, jp.L, jp.sigma, device="cpu")
    return jp, tp


# ---------------------------------------------------------------- chunking

@pytest.fixture(scope="module")
def chunked():
    """One group of 8 runs, flat and at every chunk size."""
    _, tp = _quadratic()
    grid = spec.expand_grid([("churn", spec.scenario_churn("sign_flip", period=10, stride=2))],
                            [0.25], range(8))
    assert len(campaign.run_groups(grid)) == 1
    cfg = _cfg(campaign, T=20)
    return {c: campaign.run_campaign(tp, cfg, grid, list(CHUNKED), return_gaps=True,
                                     chunk_size=c, device="cpu")
            for c in (None, 1, 5, 12, 64)}


@pytest.mark.parametrize("chunk_size", [1, 5, 12, 64])
def test_chunk_sizes_give_the_same_stats(chunked, chunk_size):
    flat, part = chunked[None], chunked[chunk_size]
    for variant in CHUNKED:
        for field in STAT_FIELDS:
            a, b = getattr(flat.stats[variant], field), getattr(part.stats[variant], field)
            assert torch.equal(a, b), (chunk_size, variant, field)
    # the churn's rotation reaches honest ranks: the guard filters them
    assert int(flat.stats["byzantine_sgd@fused"].n_byz_ever.min()) > 4


# ---------------------------------------------------------------- the axes

def _het_pair():
    jbase = jproblems.make_generated_problem(d=16, sigma=1.0, L=8.0, V=1.0, seed=0)
    tbase = problems.make_generated_problem(d=16, sigma=1.0, L=8.0, V=1.0, seed=0,
                                            device="cpu")
    return (jproblems.heterogenize_problem(jbase, m=M, skew_max=0.5, seed=3),
            problems.heterogenize_problem(tbase, m=M, skew_max=0.5, seed=3))


def _axis_grid(mod, axis, dev=None):
    kw = {} if dev is None else {"device": dev}
    scn = [("sign_flip", mod.scenario_static("sign_flip")),
           ("churn", mod.scenario_churn("sign_flip", period=10, stride=2))]
    if axis == "profiles":
        return mod.expand_grid(scn[:1], [0.25], [0, 1],
                               profiles=[("iid", mod.profile_iid(M, **kw)),
                                         ("skew", mod.profile_linear_skew(M, 0.4, **kw)),
                                         ("slow", mod.profile_stragglers(M, 0.25, 3, **kw))])
    fault_mod = jfaults if mod is jspec else faults
    return mod.expand_grid(scn, [0.25], [3],
                           faults=[("none", None),
                                   ("nan", fault_mod.fault_nan_rows(0.125, start_step=5))])


@pytest.mark.parametrize("axis", ["profiles", "faults"])
def test_profile_and_fault_axes_match_jax(axis):
    if axis == "profiles":
        jp, tp = _het_pair()
        over = {"max_delay": 3, "partial_participation": True}
        variants = ["byzantine_sgd@fused", "byzantine_sgd@dense", "coordinate_median"]
    else:
        jp, tp = _quadratic()
        over = {"sanitize": "quarantine"}
        variants = ["byzantine_sgd@fused", "byzantine_sgd@dense", "mean"]
    jgrid, tgrid = _axis_grid(jspec, axis), _axis_grid(spec, axis, "cpu")
    want = jcampaign.run_campaign(jp, JaxConfig(m=M, T=T, eta=0.05, alpha=0.25, **over), jgrid,
                                  variants, return_gaps=True)
    got = campaign.run_campaign(tp, _cfg(campaign, **over), tgrid, variants, return_gaps=True,
                                device="cpu")
    # profiles ride inside one group; each fault plan and scenario is its own
    assert len(campaign.run_groups(tgrid)) == (1 if axis == "profiles" else 4)
    for variant in variants:
        w, g = want.stats[variant], got.stats[variant]
        for field in INT_FIELDS:
            np.testing.assert_array_equal(_np(getattr(g, field)), np.asarray(getattr(w, field)),
                                          err_msg=f"{axis} {variant} {field}")
        for field in ("gap_avg", "gaps"):
            _close(getattr(g, field), getattr(w, field), TOL, f"{axis} {variant} {field}")
        if axis == "profiles":
            _close(g.report_frac, w.report_frac, TOL, f"{variant} report_frac")
        else:
            assert bool(torch.isfinite(g.gaps).all())


# ---------------------------------------------------------------- Table 1

@pytest.mark.parametrize("seed", range(4))
def test_iters_to_eps_batch_matches_the_bench(seed):
    rng = np.random.default_rng(seed)
    gaps = np.abs(rng.normal(size=(7, 50))) * np.linspace(1.0, 0.01, 50) * 0.2
    gaps[3] = 1.0   # a run that never reaches ε
    got = table1.iters_to_eps_batch(gaps, 2e-2)
    np.testing.assert_array_equal(got, bench_table1.iters_to_eps_batch(gaps, 2e-2))
    q = table1.quantiles(got)
    ok = got[got > 0]
    p25, med, p75 = np.percentile(ok, [25, 50, 75])
    assert q["reached"] == ok.size and q["iters_to_eps_med"] == int(med)
    assert q["iqr"] == [int(p25), int(p75)]
    assert table1.quantiles(np.full(5, -1))["iters_to_eps_med"] == -1


def test_table1_backend_section_matches_the_bench():
    T1 = 80
    jp = jproblems.make_quadratic_problem(d=16, sigma=1.0, L=8.0, V=1.0, seed=0)
    cfg = JaxConfig(m=16, T=T1, eta=0.05, alpha=0.25, aggregator="mean", attack="sign_flip",
                    guard_opts=(("sketch_dim", 8),))
    grid = jspec.expand_grid([("sign_flip", jspec.scenario_static("sign_flip"))], [0.25],
                             bench_table1.SEEDS)
    want = jcampaign.run_campaign(jp, cfg, grid, ["byzantine_sgd"], return_gaps=True,
                                  backends=["dense", "fused", "dp_sketch"])
    got = {p["point"]: p for p in table1.section("backend", T=T1, device="cpu")}
    assert sorted(got) == [f"table1/backend/{b}" for b in ("dense", "dp_sketch", "fused")]
    for key in sorted(want.stats):
        point = got[f"table1/backend/{key.partition('@')[2]}"]
        t = bench_table1.iters_to_eps_batch(want.stats[key].gaps, table1.EPS)
        assert point["iters_to_eps"] == t.tolist(), key
        assert point["reached"] == int((t > 0).sum()) == 5
        assert point["n_alive_final"] == np.asarray(want.stats[key].n_alive_final).tolist()
        _close(np.asarray(point["gap_final"]), want.stats[key].gap_final, TOL, key)
