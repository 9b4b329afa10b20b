"""The port's train campaigns (``repro_torch.scenarios.train_campaign``)
against the JAX package's, on the CPU.

A 2-row grid (static and churning sign_flip, one seed: two groups of one
row) × 2 variants (mean, byzantine_sgd@dp_exact) × 4 steps of internlm2-
1.8b ``reduced(max_d_model=64)``, W = 4, seq 16, per-worker batch 1,
AdamW: ``n_alive_final``, ``byz_alive_final``, ``n_byz_ever`` and
``ever_filtered_good`` exactly equal to ``repro.scenarios.
train_campaign.run_train_campaign``'s, losses within 1e-4 relative (f32
gradients summed in another order, then AdamW), and
``summarize_train_campaign``'s keys and rows equal (its losses within the
same bound).  Then the port alone: two seeds in one group against each
seed's campaign, ``chunk_size`` 1 against none, and an iid worker profile
against none, all bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.solver import SolverConfig as JConfig
from repro.data.synthetic import SyntheticTokens as JTokens
from repro.models.model import build_model as jbuild
from repro.optim import optimizers as jopt
from repro.scenarios import expand_grid as jexpand_grid
from repro.scenarios import scenario_churn as jchurn
from repro.scenarios import scenario_static as jstatic
from repro.scenarios.train_campaign import run_train_campaign as jrun
from repro.scenarios.train_campaign import summarize_train_campaign as jsummarize
from repro_torch.configs import get_config
from repro_torch.core.solver import SolverConfig
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.models import build_model
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.scenarios import (
    expand_grid,
    profile_iid,
    run_train_campaign,
    scenario_churn,
    scenario_static,
    summarize_train_campaign,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The runs compared bit for bit take one CPU thread: torch splits a
    CPU reduction by the size of its thread team, so a team that comes up
    short on a loaded host would change a run's bits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

W, T, SEQ, TOL = 4, 4, 16, 1e-4
BASE = dict(m=W, T=T, eta=3e-3, alpha=0.25, attack="sign_flip", mean_over_alive=True)
VARIANTS = ["mean", "byzantine_sgd@dp_exact"]
DECISIONS = ("n_alive_final", "byz_alive_final", "n_byz_ever", "ever_filtered_good")
LOSSES = ("loss_first", "loss_final")


def _port(seeds=(0,), profiles=None):
    model = build_model(get_config("internlm2-1.8b").reduced(max_d_model=64), device="cpu")
    grid = expand_grid([("static", scenario_static("sign_flip")),
                        ("churn", scenario_churn("sign_flip", period=2, stride=1))],
                       [0.25], seeds, profiles=profiles)
    opt = adamw(linear_warmup_cosine(3e-3, 1, T), grad_clip=1.0)
    return model, opt, SolverConfig(**BASE), grid


def _run_port(aggregators=VARIANTS, **kw):
    model, opt, cfg, grid = _port(**{k: kw.pop(k) for k in ("seeds", "profiles") if k in kw})
    return run_train_campaign(model, opt, cfg, grid, steps=T, aggregators=aggregators,
                              stream=SyntheticTokens(512, SEQ, seed=0), **kw), cfg


@pytest.fixture(scope="module")
def both():
    jm = jbuild(jget_config("internlm2-1.8b").reduced(max_d_model=64))
    grid = jexpand_grid([("static", jstatic("sign_flip")),
                         ("churn", jchurn("sign_flip", period=2, stride=1))], [0.25], [0])
    jcfg = JConfig(**BASE)
    jres = jrun(jm, jopt.adamw(jopt.linear_warmup_cosine(3e-3, 1, T), grad_clip=1.0), jcfg,
                grid, steps=T, stream=JTokens(512, SEQ, seed=0), aggregators=VARIANTS)
    tres, tcfg = _run_port()
    return jres, jcfg, tres, tcfg


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / np.abs(want)


@pytest.mark.parametrize("variant", VARIANTS)
def test_run_train_campaign_matches_jax(both, variant):
    jres, _, tres, _ = both
    want, got = jres.stats[variant], tres.stats[variant]
    assert tuple(type(got)._fields) == tuple(type(want)._fields)
    for f in DECISIONS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in LOSSES:
        assert np.all(_rel(getattr(got, f).numpy(), getattr(want, f)) <= TOL), f
    assert tres.entries == jres.entries and tres.n_runs == jres.n_runs == 2
    assert tres.steps == T and tres.memory is None and tres.compile_s == 0.0


def test_summary_matches_jax(both):
    jres, jcfg, tres, tcfg = both
    want, got = jsummarize(jres, jcfg), summarize_train_campaign(tres, tcfg)
    assert got.keys() == want.keys()
    assert got["wall_clock"].keys() == want["wall_clock"].keys()
    for k in ("config", "variants", "n_runs_per_variant"):
        assert got[k] == want[k], k
    assert len(got["leaderboard"]) == len(want["leaderboard"]) == 4
    for g, w in zip(got["leaderboard"], want["leaderboard"]):
        assert g.keys() == w.keys()
        for k in g:
            if k.startswith("loss_"):
                assert _rel(g[k], w[k]) <= TOL, k
            else:
                assert g[k] == w[k], k


def _assert_stats_equal(a, b):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("case", ["seeds_in_one_group", "chunk_size", "iid_profile"])
def test_grouping_and_chunks_change_no_bit(case):
    """A seed's rows in a group of two seeds against the same rows run
    apart, chunk_size 1 against none, and an iid profile armed (a zero
    skew and every gate open) against none."""
    if case == "seeds_in_one_group":
        res, _ = _run_port(["byzantine_sgd@dp_exact"], seeds=(0, 1))
        alone, _ = _run_port(["byzantine_sgd@dp_exact"], seeds=(1,))
        for f in alone.stats["byzantine_sgd@dp_exact"]._fields:
            got = getattr(res.stats["byzantine_sgd@dp_exact"], f)[[1, 3]]
            want = getattr(alone.stats["byzantine_sgd@dp_exact"], f)
            if f in LOSSES:
                assert np.all(_rel(got.numpy(), want.numpy()) <= 1e-6), f
            else:
                assert torch.equal(got, want), f
        return
    plain, _ = _run_port(["byzantine_sgd@dp_exact"])
    if case == "chunk_size":
        other, _ = _run_port(["byzantine_sgd@dp_exact"], chunk_size=1)
    else:
        other, _ = _run_port(["byzantine_sgd@dp_exact"],
                             profiles=[("iid", profile_iid(W, device="cpu"))])
    _assert_stats_equal(other.stats["byzantine_sgd@dp_exact"],
                        plain.stats["byzantine_sgd@dp_exact"])
