"""Fault plans on the scenario adversary through ``run_sgd``: the port
against the JAX package on the same problem, plan and key.

* Every mode of ``FAULT_TABLE`` (``none`` included), with and without
  ``sanitize="quarantine"``, on the dense and the fused guard (generated
  problem, m = 16, d = 16, T = 24, α = 0.25, ``sign_flip``, 2 victims from
  step 5, every second step): decisions (``n_alive``, ``final_alive``,
  ``byz_mask``, ``ever_filtered_good``) exactly, values within 1e-5
  relative (1e-2 at bf16), NaN where JAX has NaN.
* An inert plan (``fault_none``, a zero fraction, a start past the run)
  runs bit for bit as no plan; every victim is in ``byz_mask``; the
  quarantine never counts a victim as an honest worker filtered.
* ``generate="kernel"`` refuses a plan with the reference's ValueError.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solver import SolverConfig as JaxConfig
from repro.core.solver import run_sgd as jax_run_sgd
from repro.data.problems import make_generated_problem as jax_problem
from repro.scenarios import faults as jfaults
from repro.scenarios import spec as jspec
from repro.scenarios.adversary import ScenarioAdversary as JaxAdversary
from repro_torch import convert, prng
from repro_torch.core.solver import SolverConfig, byz_rank, run_sgd
from repro_torch.data.problems import make_generated_problem
from repro_torch.scenarios import adversary, faults, spec

M, D, T = 16, 16, 24
START, PERIOD, FRAC = 5, 2, 0.125
TOL = {"f32": 1e-5, "bf16": 1e-2}


def _jplan(mode, **kw):
    kw = {"frac": FRAC, "start_step": START, "period": PERIOD, **kw}
    return jfaults.make_fault_plan(mode, **kw)


def _cfg(backend, sanitize, sd="f32", **over):
    return dict(m=M, T=T, eta=0.05, alpha=0.25, aggregator="byzantine_sgd",
                guard_backend=backend, stats_dtype=sd, sanitize=sanitize, **over)


def _port_run(plan, backend, sanitize, sd="f32", seed=3, **over):
    prob = make_generated_problem(d=D, sigma=1.0, L=8.0, V=1.0, seed=0, device="cpu")
    adv = adversary.ScenarioAdversary(spec.scenario_static("sign_flip"), 0.25, faults=plan)
    return run_sgd(prob, SolverConfig(**_cfg(backend, sanitize, sd, **over)), prng.PRNGKey(seed),
                   adversary=adv, device="cpu")


def _port_plan(jplan):
    return convert.fault_plan_from_numpy(*map(np.asarray, jplan))


CASES = [(mode, sanitize, backend)
         for mode in jfaults.FAULT_TABLE for sanitize in ("off", "quarantine")
         for backend in ("dense", "fused")]


def _compare(mode, sanitize, backend, sd):
    jplan = _jplan(mode)
    want = jax_run_sgd(jax_problem(d=D, sigma=1.0, L=8.0, V=1.0, seed=0),
                       JaxConfig(**_cfg(backend, sanitize, sd)), jax.random.PRNGKey(3),
                       adversary=JaxAdversary(jspec.scenario_static("sign_flip"),
                                              jnp.float32(0.25), faults=jplan))
    got = _port_run(_port_plan(jplan), backend, sanitize, sd)
    for f in ("n_alive", "byz_mask", "final_alive"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert bool(got.ever_filtered_good) == bool(want.ever_filtered_good)
    assert got.n_reporting is None and want.n_reporting is None
    for f in ("gaps", "x_final", "x_avg"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=TOL[sd], atol=1e-6, equal_nan=True, err_msg=f)
    return got


@pytest.mark.parametrize("mode,sanitize,backend", CASES)
def test_run_sgd_with_fault_plan_matches_jax(mode, sanitize, backend):
    got = _compare(mode, sanitize, backend, "f32")
    if sanitize == "quarantine":
        assert bool(torch.isfinite(got.x_avg).all())


@pytest.mark.parametrize("mode", ["nan_rows", "bitflip"])
def test_bf16_quarantine_with_fault_plan_matches_jax(mode):
    _compare(mode, "quarantine", "fused", "bf16")


@pytest.mark.parametrize("backend", ["dense", "fused"])
@pytest.mark.parametrize("plan", [
    faults.fault_none(),
    faults.fault_nan_rows(0.0, start_step=START),
    faults.fault_garbage(FRAC, start_step=T),
], ids=["none", "zero_frac", "start_past_the_run"])
def test_inert_plan_is_no_plan_bit_for_bit(plan, backend):
    got = _port_run(plan, backend, "quarantine")
    base = _port_run(None, backend, "quarantine")
    for f in ("x_final", "x_avg", "gaps", "n_alive", "final_alive", "byz_mask",
              "ever_filtered_good"):
        assert torch.equal(getattr(got, f), getattr(base, f)), f


@pytest.mark.parametrize("mode", [m for m in jfaults.FAULT_TABLE if m != "none"])
def test_victims_join_byz_mask(mode):
    """The plan's victims (the top ranks) count as Byzantine, so the
    quarantine killing them is no honest worker filtered."""
    got = _port_run(faults.make_fault_plan(mode, frac=FRAC, start_step=START, period=PERIOD),
                    "fused", "quarantine")
    rank = byz_rank(prng.split(prng.PRNGKey(3))[1], M)
    plan = faults.make_fault_plan(mode, frac=FRAC, start_step=START)
    victims = faults.fault_rows(plan, rank, START)
    assert int(victims.sum()) == 2
    assert torch.equal(got.byz_mask, victims | (rank < 4))
    if mode in ("nan_rows", "inf_rows"):
        # the poisoned rows die at their first fault step, nothing else honest does
        assert not bool(got.final_alive[victims].any())
        assert not bool(got.ever_filtered_good)
        assert int(got.n_alive[START - 1]) - int(got.n_alive[START]) == 2


def test_generating_path_refuses_a_fault_plan():
    prob = make_generated_problem(d=D, seed=0, device="cpu")
    adv = adversary.ScenarioAdversary(spec.scenario_static("sign_flip"), 0.25,
                                      faults=faults.fault_none())
    with pytest.raises(ValueError, match="fault injection"):
        run_sgd(prob, SolverConfig(**_cfg("fused", "off", generate="kernel")), prng.PRNGKey(0),
                adversary=adv, device="cpu")


def test_convert_carries_a_jax_fault_plan():
    jplan = jfaults.fault_garbage(0.25, magnitude=3.5, start_step=2, period=3)
    got = _port_plan(jplan)
    assert got == faults.fault_garbage(0.25, magnitude=3.5, start_step=2, period=3)
    assert type(got.frac) is np.float32 and type(got.mode) is int
