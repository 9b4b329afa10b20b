"""A campaign's ``gen`` variants in the port (the generating kernels'
run axis: ``ops.fused_guard_gen`` and ``ops.gen_xi`` under
``torch.func.vmap``) against the JAX package's on the same grid, on the
CPU (the JAX campaign runs its generating Pallas kernels in interpret
mode).

* The reference's grid of ``tests/test_campaign_chunked.py`` (generated
  problem d = 16, m = 16, T = 25; static and churning sign_flip × α
  {0.125, 0.25} × 3 seeds) with ``fused``, ``gen`` and ``gen@bf16``: each
  ``gen`` row's ``n_alive_final``, ``n_byz_ever``, ``detect_latency`` and
  ``ever_filtered_good`` equal JAX's, ``gap_final`` and ``gap_avg``
  within 1e-6; the port's ``gen`` rows decide as its ``fused`` rows (and
  ``gen@bf16`` as ``fused@bf16``) with gaps within 1e-6 (the reference's
  own criterion).
* ALIE (whose rows read the honest column moments the sweep returns) in a
  campaign: decisions equal to JAX's, gaps within 1e-6, and each row equal
  to its generating run alone.
* ``chunk_size`` 1 and 5 give the ``gen`` rows' bits.
"""
import numpy as np
import pytest
import torch

from repro.core.solver import SolverConfig as JaxConfig
from repro.data.problems import make_generated_problem as jax_problem
from repro.scenarios import spec as jspec
from repro.scenarios.campaign import run_campaign as jax_run_campaign
from repro_torch import prng
from repro_torch.core.solver import SolverConfig, run_sgd
from repro_torch.data.problems import make_generated_problem
from repro_torch.scenarios import ScenarioAdversary, run_campaign, spec
from repro_torch.scenarios.campaign import _summarize, expand_variants

M, T = 16, 25
BACKENDS = ("fused", "gen", "gen@bf16")
INT_FIELDS = ("n_alive_final", "n_byz_ever", "detect_latency", "ever_filtered_good")
GAP_ATOL = 1e-6


def _grid(mod, attack="sign_flip"):
    return mod.expand_grid(
        [("static", mod.scenario_static(attack)),
         ("churn", mod.scenario_churn(attack, period=10, stride=2))],
        alphas=[0.125, 0.25], seeds=range(3))


def _campaigns(attack, backends, port_only=()):
    want = jax_run_campaign(jax_problem(d=16, sigma=1.0, L=8.0, V=1.0, seed=0),
                            JaxConfig(m=M, alpha=0.25, T=T, eta=0.05), _grid(jspec, attack),
                            ["byzantine_sgd"], backends=backends)
    prob = make_generated_problem(d=16, sigma=1.0, L=8.0, V=1.0, seed=0, device="cpu")
    got = run_campaign(prob, SolverConfig(m=M, alpha=0.25, T=T, eta=0.05), _grid(spec, attack),
                       ["byzantine_sgd"], backends=backends + port_only, device="cpu")
    return got, want, prob


@pytest.fixture(scope="module")
def sign_flip():
    # fused@bf16 in the port only: what gen@bf16 decides as
    return _campaigns("sign_flip", BACKENDS, port_only=("fused@bf16",))


@pytest.fixture(scope="module")
def alie():
    return _campaigns("alie", ("gen",))


def _assert_rows(got, want, what):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f"{what} {f}")
    for f in ("gap_final", "gap_avg"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=GAP_ATOL, err_msg=f"{what} {f}")


@pytest.mark.parametrize("backend", BACKENDS)
def test_gen_rows_match_jax(sign_flip, backend):
    got, want, _ = sign_flip
    name = f"byzantine_sgd@{backend}"
    assert set(want.stats) == {f"byzantine_sgd@{b}" for b in BACKENDS}
    _assert_rows(got.stats[name], want.stats[name], name)


@pytest.mark.parametrize("sd", ["", "@bf16"])
def test_gen_rows_decide_as_fused_rows(sign_flip, sd):
    got, _, _ = sign_flip
    gen, fused = got.stats[f"byzantine_sgd@gen{sd}"], got.stats[f"byzantine_sgd@fused{sd}"]
    for f in ("n_alive_final", "detect_latency"):
        assert torch.equal(getattr(gen, f), getattr(fused, f)), f
    torch.testing.assert_close(gen.gap_final, fused.gap_final, rtol=0, atol=GAP_ATOL)


def test_alie_gen_rows_match_jax_and_their_runs_alone(alie):
    got, want, prob = alie
    name = "byzantine_sgd@gen"
    _assert_rows(got.stats[name], want.stats[name], name)
    cfg = expand_variants(SolverConfig(m=M, alpha=0.25, T=T, eta=0.05), [name])[name]
    grid = _grid(spec, "alie")
    st = got.stats[name]
    for i in (0, 7):
        alone = run_sgd(prob, cfg, prng.PRNGKey(int(grid.seeds[i])),
                        adversary=ScenarioAdversary(grid.scenarios[i], grid.alpha[i]),
                        device="cpu")
        summary = _summarize(prob, cfg, alone, False)
        for f in INT_FIELDS:
            assert torch.equal(getattr(st, f)[i], summary[f]), (i, f)
        torch.testing.assert_close(st.gap_final[i], summary["gap_final"], rtol=1e-6,
                                   atol=1e-9)


@pytest.mark.parametrize("chunk_size", [1, 5])
def test_gen_rows_bit_identical_across_chunk_sizes(sign_flip, chunk_size):
    got, _, prob = sign_flip
    chunked = run_campaign(prob, SolverConfig(m=M, alpha=0.25, T=T, eta=0.05),
                           _grid(spec), ["byzantine_sgd"], backends=("gen",),
                           chunk_size=chunk_size, device="cpu")
    a, b = got.stats["byzantine_sgd@gen"], chunked.stats["byzantine_sgd@gen"]
    for f in INT_FIELDS + ("gap_final", "gap_avg"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
