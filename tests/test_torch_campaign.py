"""Campaigns in the port (``repro_torch.scenarios.campaign``, ``report``,
``spec.expand_grid``, ``core.guard_backends.parse_backend_spec`` and
``experiments.table1``) against the JAX package on the same inputs, on
the CPU (the JAX campaign runs its fused guard in interpret mode).

* ``expand_grid``'s entries equal JAX's, and so do its two ValueErrors;
  ``parse_backend_spec`` and ``expand_variants`` on every spelling of the
  reference, bad ones raising as there.
* ``run_campaign`` on the quadratic (d = 16, m = 16, T = 40) over
  sign_flip and churn × α {0.125, 0.25} × 3 seeds, for mean, krum,
  coordinate_median, trimmed_mean and byzantine_sgd @dense, @fused and
  @dp_sketch: ``n_alive_final``, ``n_byz_ever``, ``detect_latency`` and
  ``ever_filtered_good`` equal; ``gap_avg``, ``gap_final`` and the
  ``return_gaps`` traces within 1e-5 relative (‖got − want‖ ≤
  1e-5·‖want‖ over a variant's rows), the tolerance
  ``tests/test_torch_convex_solver.py`` holds ``run_sgd`` to against JAX.
* Each row against the port's ``run_sgd`` of that row alone: decisions
  equal, gaps within 1e-6 relative (a batched product may sum in another
  order than the single run's).
* ``chunk_size`` < 1, ``telemetry=`` and the ``gen`` variant raise; the
  looped campaign gives the batched one's gaps.
* ``summarize_campaign``, ``theorem38_bound`` and ``degraded_pairs``
  against the reference's on the same grid.

Chunking, the profile and fault axes and Table 1 are in
``tests/test_torch_campaign_axes.py``.
"""
import math

import numpy as np
import pytest
import torch

from benchmarks import bench_table1
from repro.core import guard_backends as jbackends
from repro.core.solver import SolverConfig as JaxConfig
from repro.data import problems as jproblems
from repro.scenarios import campaign as jcampaign
from repro.scenarios import faults as jfaults
from repro.scenarios import report as jreport
from repro.scenarios import spec as jspec
from repro_torch import convert, prng
from repro_torch.core import guard_backends
from repro_torch.core.solver import SolverConfig, run_sgd
from repro_torch.data import problems
from repro_torch.experiments import table1
from repro_torch.scenarios import campaign, faults, report, spec
from repro_torch.scenarios.adversary import ScenarioAdversary

M, T = 16, 40
ALPHAS = (0.125, 0.25)
SEEDS = range(3)
VARIANTS = ("mean", "krum", "coordinate_median", "trimmed_mean", "byzantine_sgd@dense",
            "byzantine_sgd@fused", "byzantine_sgd@dp_sketch")
GUARDS = tuple(v for v in VARIANTS if v.startswith("byzantine_sgd@"))
TOL = 1e-5          # against JAX (tests/test_torch_convex_solver.py's x_avg tolerance)
ALONE_TOL = 1e-6    # a row against its run alone in the port
INT_FIELDS = ("n_alive_final", "n_byz_ever", "detect_latency", "ever_filtered_good")
STAT_FIELDS = INT_FIELDS + ("gap_avg", "gap_final", "gaps")
STATIC_OF = {"churn": "sign_flip"}


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol, what=""):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    err = np.linalg.norm(got - want)
    assert err <= tol * np.linalg.norm(want) + 1e-12, (what, err, np.linalg.norm(want))


def _scenarios(mod):
    return [("sign_flip", mod.scenario_static("sign_flip")),
            ("churn", mod.scenario_churn("sign_flip", period=10, stride=2))]


def _cfg(mod, **over):
    return mod.SolverConfig(**{**dict(m=M, T=T, eta=0.05, alpha=0.25), **over})


@pytest.fixture(scope="module")
def quadratic():
    """(JAX quadratic, the port's carried from it)."""
    jp = jproblems.make_quadratic_problem(d=16, sigma=1.0, L=8.0, V=1.0, seed=0)
    H = np.asarray(jp.f.__closure__[jp.f.__code__.co_freevars.index("H")].cell_contents)
    tp = convert.quadratic_problem_from_numpy(H, np.asarray(jp.x_star), np.asarray(jp.x1),
                                              jp.D, jp.V, jp.L, jp.sigma, device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def main_campaigns(quadratic):
    """The main grid's campaign in both packages, every variant, gaps kept."""
    jp, tp = quadratic
    jgrid = jspec.expand_grid(_scenarios(jspec), ALPHAS, SEEDS)
    tgrid = spec.expand_grid(_scenarios(spec), ALPHAS, SEEDS)
    want = jcampaign.run_campaign(jp, JaxConfig(m=M, T=T, eta=0.05, alpha=0.25), jgrid,
                                  list(VARIANTS), return_gaps=True)
    got = campaign.run_campaign(tp, _cfg(campaign), tgrid, list(VARIANTS), return_gaps=True,
                                device="cpu")
    return want, got, tgrid


# ---------------------------------------------------------------- the grid

def _grids(mod, dev=None):
    kw = {} if dev is None else {"device": dev}
    fault_mod = jfaults if mod is jspec else faults
    return {
        "basic": mod.expand_grid(_scenarios(mod), ALPHAS, SEEDS),
        "profiles": mod.expand_grid(
            _scenarios(mod)[:1], [0.25], [0, 1],
            profiles=[("iid", mod.profile_iid(M, **kw)),
                      ("skew", mod.profile_linear_skew(M, 0.4, **kw)),
                      ("slow", mod.profile_stragglers(M, 0.25, 3, **kw))]),
        "faults": mod.expand_grid(
            _scenarios(mod), [0.25], [3],
            faults=[("none", None), ("nan", fault_mod.fault_nan_rows(0.125, start_step=5))]),
    }


@pytest.mark.parametrize("name", ["basic", "profiles", "faults"])
def test_expand_grid_entries_match_jax(name):
    want = _grids(jspec)[name]
    got = _grids(spec, "cpu")[name]
    assert got.entries == want.entries and got.n_runs == want.n_runs
    np.testing.assert_array_equal(got.seeds.numpy(), np.asarray(want.seeds))
    np.testing.assert_array_equal(got.alpha, np.asarray(want.alpha))
    if want.profiles is not None:
        for field in spec.WorkerProfile._fields:
            np.testing.assert_array_equal(getattr(got.profiles, field).numpy(),
                                          np.asarray(getattr(want.profiles, field)))
    if want.faults is not None:
        # the None member became the inert plan, as in the JAX package
        assert got.faults[0] == faults.fault_none()
        assert [p.mode for p in got.faults] == list(np.asarray(want.faults.mode))


@pytest.mark.parametrize("case", ["empty", "mismatched_profile_m"])
def test_expand_grid_errors_match_jax(case):
    def call(mod, dev=None):
        kw = {} if dev is None else {"device": dev}
        if case == "empty":
            return mod.expand_grid([], alphas=[0.25], seeds=[0])
        return mod.expand_grid(_scenarios(mod)[:1], alphas=[0.25], seeds=[0],
                               profiles=[("a", mod.profile_linear_skew(8, 0.4, **kw)),
                                         ("b", mod.profile_linear_skew(16, 0.4, **kw))])

    with pytest.raises(ValueError) as want:
        call(jspec)
    with pytest.raises(ValueError) as got:
        call(spec, "cpu")
    if case == "empty":
        assert str(got.value) == str(want.value) == "empty grid"
    else:
        for part in ("'profiles'", ".skew", "(16,)", "(8,)", "member 1"):
            assert part in str(want.value) and part in str(got.value), part


# ---------------------------------------------------------------- spellings

@pytest.mark.parametrize("spelling", ["fused", "dense", "dp_sketch", "fused@bf16", "fused@f32",
                                      "dp_exact@bf16", "gen", "gen@bf16", "nonsense@f32"])
def test_parse_backend_spec_matches_jax(spelling):
    assert guard_backends.parse_backend_spec(spelling) == jbackends.parse_backend_spec(spelling)


@pytest.mark.parametrize("spelling", ["fused@", "fused@f16", "fused@bf16@f32", "@x"])
def test_parse_backend_spec_refuses_what_jax_refuses(spelling):
    with pytest.raises(KeyError):
        jbackends.parse_backend_spec(spelling)
    with pytest.raises(KeyError):
        guard_backends.parse_backend_spec(spelling)


SPELLINGS = {
    "backends": (["byzantine_sgd"], ["fused", "gen", "gen@bf16"]),
    "explicit": (["byzantine_sgd@fused@bf16", "mean", "byzantine_sgd@dp_sketch"], None),
    "mixed": (["krum", "byzantine_sgd", "trimmed_mean"], ["dense", "dp_sketch@bf16"]),
    "guard_only": (["byzantine_sgd"], None),
}


@pytest.mark.parametrize("name", sorted(SPELLINGS))
def test_expand_variants_matches_jax(name):
    aggs, backends = SPELLINGS[name]
    want = jcampaign.expand_variants(JaxConfig(m=M, T=T, eta=0.05, alpha=0.25), aggs, backends)
    got = campaign.expand_variants(_cfg(campaign), aggs, backends)
    assert list(got) == list(want)
    for key in want:
        for field in ("aggregator", "guard_backend", "generate", "stats_dtype"):
            assert getattr(got[key], field) == getattr(want[key], field), (key, field)


@pytest.mark.parametrize("aggs,backends,error", [
    (["krum@fused"], None, ValueError),
    (["byzantine_sgd"], ["fused@f16"], KeyError),
    (["byzantine_sgd@fused@"], None, KeyError),
])
def test_expand_variants_refuses_what_jax_refuses(aggs, backends, error):
    with pytest.raises(error):
        jcampaign.expand_variants(JaxConfig(m=M, T=T, eta=0.05), aggs, backends)
    with pytest.raises(error):
        campaign.expand_variants(_cfg(campaign), aggs, backends)


# ---------------------------------------------------------------- run_campaign

@pytest.mark.parametrize("variant", VARIANTS)
def test_run_campaign_matches_jax(main_campaigns, variant):
    want, got, _ = main_campaigns
    assert got.entries == want.entries and got.n_runs == want.n_runs == 12
    w, g = want.stats[variant], got.stats[variant]
    for field in INT_FIELDS:
        np.testing.assert_array_equal(_np(getattr(g, field)), np.asarray(getattr(w, field)),
                                      err_msg=f"{variant} {field}")
    for field in ("gap_avg", "gap_final", "gaps"):
        _close(getattr(g, field), getattr(w, field), TOL, f"{variant} {field}")
    assert g.gaps.shape == (12, T) and g.report_frac is None and g.telemetry is None


def test_campaign_result_fields(main_campaigns):
    _, got, _ = main_campaigns
    assert got.memory is None and got.compile_s == 0.0 and got.wall_s > 0
    assert set(got.stats) == set(VARIANTS)
    # the guard sees the attackers; the mean never filters
    assert int(got.stats["mean"].n_alive_final.min()) == M


@pytest.mark.parametrize("variant", VARIANTS)
def test_rows_equal_their_runs_alone(quadratic, main_campaigns, variant):
    _, tp = quadratic
    _, got, tgrid = main_campaigns
    cfg = campaign.expand_variants(_cfg(campaign), [variant])[variant]
    st = got.stats[variant]
    for i in (0, 4, 7, 11):   # both scenarios, both α
        adv = ScenarioAdversary(tgrid.scenarios[i], tgrid.alpha[i])
        run = run_sgd(tp, cfg, prng.PRNGKey(int(tgrid.seeds[i]), device="cpu"), adversary=adv,
                      device="cpu")
        summary = campaign._summarize(tp, cfg, run, True)
        for field in INT_FIELDS:
            assert bool(torch.equal(getattr(st, field)[i], summary[field])), (variant, i, field)
        _close(st.gaps[i], run.gaps, ALONE_TOL, f"{variant} row {i}")


def test_chunk_size_below_one_and_unported_axes_raise(quadratic):
    _, tp = quadratic
    tgrid = spec.expand_grid(_scenarios(spec)[:1], [0.25], [0])
    with pytest.raises(ValueError, match="chunk_size"):
        campaign.run_campaign(tp, _cfg(campaign), tgrid, ["byzantine_sgd"], chunk_size=0,
                              device="cpu")
    with pytest.raises(NotImplementedError, match="telemetry"):
        campaign.run_campaign(tp, _cfg(campaign), tgrid, ["mean"], telemetry=object(),
                              device="cpu")
    for backends in (["gen"], ["fused", "gen@bf16"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            campaign.run_campaign(tp, _cfg(campaign), tgrid, ["byzantine_sgd"],
                                  backends=backends, device="cpu")


def test_looped_campaign_matches_the_batched_one(quadratic, main_campaigns):
    _, tp = quadratic
    _, got, tgrid = main_campaigns
    gaps, seconds = campaign.run_campaign_looped(tp, _cfg(campaign), tgrid,
                                                 ["byzantine_sgd@fused", "krum"], device="cpu")
    assert seconds > 0
    for variant, row in gaps.items():
        _close(np.asarray(row), got.stats[variant].gap_avg, ALONE_TOL, variant)


# ---------------------------------------------------------------- the report

def _same_record(got, want, path="record"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same_record(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same_record(a, b, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert math.isclose(got, want, rel_tol=1e-4, abs_tol=1e-9) or (
            math.isnan(got) and math.isnan(want)), (path, got, want)
    else:
        assert got == want, (path, got, want)


def test_summarize_campaign_matches_jax(quadratic, main_campaigns):
    jp, tp = quadratic
    want, got, _ = main_campaigns
    cfg_j, cfg_t = JaxConfig(m=M, T=T, eta=0.05, alpha=0.25), _cfg(campaign)
    rec_w = jreport.summarize_campaign(want, jp, cfg_j, static_of=STATIC_OF)
    rec_g = report.summarize_campaign(got, tp, cfg_t, static_of=STATIC_OF)
    for key in ("wall_clock",):
        rec_w.pop(key), rec_g.pop(key)
    _same_record(rec_g, rec_w)
    assert report.degraded_pairs(rec_g) == jreport.degraded_pairs(rec_w)
    assert report.filter_timelines(got) == jreport.filter_timelines(want) == []
    for alpha, V, m_eff in ((0.25, None, None), (0.5, 1.7, 9.5), (0.0, 0.3, 0.4)):
        assert report.theorem38_bound(tp, cfg_t, alpha, V=V, m_eff=m_eff) == \
            jreport.theorem38_bound(jp, cfg_j, alpha, V=V, m_eff=m_eff)
    series = np.array([8, 8, 7, 7, 7, 4, 4, 0] * 20)
    assert report._survival_curve(series, 16) == jreport._survival_curve(series, 16)


def test_write_report_needs_a_path_and_stamps_provenance(tmp_path):
    import inspect
    import json

    assert inspect.signature(report.write_report).parameters["path"].default is \
        inspect.Parameter.empty
    out = tmp_path / "r.json"
    report.write_report({"leaderboard": []}, str(out))
    meta = json.loads(out.read_text())["meta"]
    for key in ("commit", "timestamp", "torch_version", "cuda_version", "device_kind",
                "card_name", "power_limit"):
        assert isinstance(meta[key], str) and meta[key], key
