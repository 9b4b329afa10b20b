"""``run_sgd`` with a scenario adversary, on the materialising path
(``generate="off"``) and the generating one (``generate="kernel"``),
against the JAX package and against itself.

* Port against JAX on the reference's end-to-end setting
  (``tests/test_gradgen.py``: generated problem d = 16, m = 16, T = 40,
  α = 0.25, fused guard): filter decisions equal (``n_alive`` per step,
  ``byz_mask``, ``final_alive``), gaps and iterates within 1e-6 absolute,
  the reference's own tolerance for its non-exact scenarios.
* The port's ``generate="kernel"`` against its ``generate="off"`` for the
  reference's eleven scenarios and ``scenario_adaptive``, with the
  reference's split: bit for bit where it marks the scenario exact, else
  decisions equal and values within 1e-6.
* The generating path never builds the batch (``stoch_grad`` is never
  called) and runs only the two generating ops, once each per step.
* Every ``ValueError`` gate of the reference's ``generate="kernel"``, and
  TypeError for a ``telemetry`` that is not a TelemetryConfig.
* Staleness and partial participation without a worker profile: ignored,
  as in the reference, on the dense and the fused guard.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solver import SolverConfig as JaxConfig
from repro.core.solver import run_sgd as jax_run_sgd
from repro.data.problems import make_generated_problem as jax_problem
from repro.scenarios import spec as jspec
from repro.scenarios.adversary import ScenarioAdversary as JaxAdversary
from repro_torch import convert, prng
from repro_torch.core.solver import SolverConfig, run_sgd
from repro_torch.data.problems import heterogenize_problem, make_generated_problem
from repro_torch.kernels import ops
from repro_torch.obs import TelemetryConfig
from repro_torch.scenarios import adversary, faults, spec

M, D, T = 16, 16, 40

# (name, scenario builder, exact): the reference's _E2E_SCENARIOS
SCENARIOS = [
    ("static_sign_flip", lambda s: s.scenario_static("sign_flip"), True),
    ("static_alie", lambda s: s.scenario_static("alie"), False),
    ("static_alie_update", lambda s: s.scenario_static("alie_update"), False),
    ("static_constant_drift", lambda s: s.scenario_static("constant_drift"), True),
    ("static_hidden_shift", lambda s: s.scenario_static("hidden_shift"), True),
    ("static_inner_product", lambda s: s.scenario_static("inner_product"), True),
    ("retreat_on_filter", lambda s: s.scenario_static("retreat_on_filter"), True),
    ("coalition", lambda s: s.scenario_coalition("sign_flip", "alie", 0.5), False),
    ("churn", lambda s: s.scenario_churn("sign_flip", period=20, stride=2), True),
    ("late_join", lambda s: s.scenario_late_join("alie", 15), False),
    ("lie_low", lambda s: s.scenario_lie_low_then_strike("inner_product", 20), True),
    ("adaptive", lambda s: s.scenario_adaptive("inner_product", 0.5), False),
]
BY_NAME = {name: (make, exact) for name, make, exact in SCENARIOS}


def _cfg(generate, **kw):
    base = dict(m=M, alpha=0.25, T=T, eta=0.05, aggregator="byzantine_sgd",
                guard_backend="fused", generate=generate)
    base.update(kw)
    return base


def _port(name, generate, seed=3, **kw):
    prob = make_generated_problem(d=D, sigma=1.0, L=8.0, V=1.0, seed=0, device="cpu")
    adv = adversary.ScenarioAdversary(BY_NAME[name][0](spec), 0.25)
    return run_sgd(prob, SolverConfig(**_cfg(generate, **kw)), prng.PRNGKey(seed),
                   adversary=adv, device="cpu")


def _assert_decisions_equal(got, want):
    for f in ("n_alive", "byz_mask", "final_alive"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert bool(got.ever_filtered_good) == bool(want.ever_filtered_good)


@pytest.mark.parametrize("name,generate", [
    ("static_sign_flip", "kernel"), ("static_alie", "kernel"), ("churn", "kernel"),
    ("coalition", "kernel"), ("adaptive", "kernel"),
    ("static_alie_update", "off"), ("late_join", "off")])
def test_run_sgd_matches_jax(name, generate):
    jprob = jax_problem(d=D, sigma=1.0, L=8.0, V=1.0, seed=0)
    jadv = JaxAdversary(BY_NAME[name][0](jspec), jnp.asarray(0.25, jnp.float32))
    want = jax_run_sgd(jprob, JaxConfig(**_cfg(generate)), jax.random.PRNGKey(3),
                       adversary=jadv)
    got = _port(name, generate)
    _assert_decisions_equal(got, want)
    for f in ("gaps", "x_final", "x_avg"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("name", [n for n, _, _ in SCENARIOS])
def test_generating_path_equals_materialising_path(name):
    off, gen = _port(name, "off"), _port(name, "kernel")
    _assert_decisions_equal(gen, off)
    for f in ("gaps", "x_final", "x_avg"):
        if BY_NAME[name][1]:
            assert torch.equal(getattr(gen, f), getattr(off, f)), f
        else:
            np.testing.assert_allclose(getattr(gen, f).numpy(), getattr(off, f).numpy(),
                                       rtol=0, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("name", ["static_sign_flip", "static_alie", "adaptive"])
def test_generating_path_equals_materialising_path_bf16(name):
    """bf16 statistics: both paths round the same rows once to bf16."""
    off = _port(name, "off", stats_dtype="bf16")
    gen = _port(name, "kernel", stats_dtype="bf16")
    _assert_decisions_equal(gen, off)
    np.testing.assert_allclose(gen.gaps.numpy(), off.gaps.numpy(), rtol=0, atol=1e-6)


def test_generating_path_builds_no_batch(monkeypatch):
    """Each step runs ops.fused_guard_gen and ops.gen_xi once and no
    materialising op, and the problem's sampler is never called."""
    calls = {}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrapper

    for name in ("fused_guard_gen", "gen_xi", "fused_guard", "filtered_mean"):
        monkeypatch.setattr(ops, name, counted(name, getattr(ops, name)))
    prob = make_generated_problem(d=D, seed=0, device="cpu")

    def no_batch(*a, **k):
        raise AssertionError("the generating path built the (m, d) batch")

    prob = prob._replace(stoch_grad=no_batch)
    adv = adversary.ScenarioAdversary(spec.scenario_static("alie"), 0.25)
    res = run_sgd(prob, SolverConfig(**_cfg("kernel", T=9)), prng.PRNGKey(0), adversary=adv,
                  device="cpu")
    assert calls == {"fused_guard_gen": 9, "gen_xi": 9}
    assert torch.isfinite(res.x_avg).all()


def _gen_run(attack="alie", problem=None, telemetry=None, profile=None, faults=None, **over):
    prob = problem or make_generated_problem(d=D, seed=0, device="cpu")
    adv = (adversary.ScenarioAdversary(spec.scenario_static(attack), 0.25, profile=profile,
                                       faults=faults) if attack else None)
    return run_sgd(prob, SolverConfig(**_cfg(over.pop("generate", "kernel"), T=4, **over)),
                   prng.PRNGKey(0), adversary=adv, telemetry=telemetry, device="cpu")


@pytest.mark.parametrize("over,match", [
    (dict(generate="device"), "generate must be"),
    (dict(problem=make_generated_problem(d=D, seed=0, device="cpu")._replace(gen=None)),
     "counter-generatable"),
    (dict(attack=None), "scenario adversary"),
    (dict(guard_backend="dense"), "guard_backend='fused'"),
    (dict(aggregator="krum"), "guard_backend='fused'"),
    (dict(max_delay=2), "staleness"),
    (dict(partial_participation=True), "partial participation"),
    (dict(sanitize="quarantine"), "sanitize='quarantine'"),
    (dict(attack="random_gaussian"), "not in-kernel generatable"),
    (dict(faults=faults.fault_none()), "fault injection"),
    (dict(profile=spec.profile_linear_skew(M, 0.5, device="cpu"),
          problem=heterogenize_problem(make_generated_problem(d=D, seed=0, device="cpu"),
                                       m=M, skew_max=0.5)), "heterogenize_generated"),
], ids=["generate", "problem", "adversary", "backend", "aggregator", "staleness",
        "partial", "sanitize", "attack_id", "faults", "het_sign"])
def test_generate_gates_raise_value_error(over, match):
    with pytest.raises(ValueError, match=match):
        _gen_run(**over)


@pytest.mark.parametrize("over,match", [
    (dict(telemetry=object()), "TelemetryConfig"),
    (dict(generate="off", attack="random_gaussian"), None),
], ids=["telemetry", "random_gaussian"])
def test_unported_parts_raise_not_implemented(over, match):
    """Telemetry is ported: anything but None or a TelemetryConfig raises
    TypeError, and an armed generating run decides as the run without it.
    ``random_gaussian`` (id 2) is ported: on the materialising path its run
    finishes with finite values and its noise in the attackers' rows
    filters all of them."""
    if match is None:
        res = _gen_run(**over)
        assert bool(torch.isfinite(res.x_avg).all() and torch.isfinite(res.gaps).all())
        assert not bool((res.final_alive & res.byz_mask).any())
        return
    with pytest.raises(TypeError, match=match):
        _gen_run(**over)
    armed = _gen_run(telemetry=TelemetryConfig(ring_size=4))
    off = _gen_run()
    assert torch.equal(armed.gaps, off.gaps) and torch.equal(armed.n_alive, off.n_alive)
    assert armed.telemetry.ring.head == 4 and off.telemetry is None


def test_worker_profile_still_raises_not_implemented():
    """Worker profiles are ported, so an adversary carrying one is no
    longer refused with NotImplementedError; a profile with ``max_delay``
    under ``generate="kernel"`` raises the reference's ValueError (the
    stale buffer needs the materialised batch)."""
    adv = adversary.ScenarioAdversary(spec.scenario_static("sign_flip"), 0.25,
                                      profile=spec.profile_stragglers(M, 0.25, 3, device="cpu"))
    prob = make_generated_problem(d=D, seed=0, device="cpu")
    with pytest.raises(ValueError, match="does not compose with staleness buffers"):
        run_sgd(prob, SolverConfig(**_cfg("kernel", T=4, max_delay=3)), prng.PRNGKey(0),
                adversary=adv, device="cpu")


STALE_PARTIAL = {"staleness": dict(max_delay=3),
                 "partial": dict(partial_participation=True),
                 "both": dict(max_delay=3, partial_participation=True)}


@pytest.mark.parametrize("backend", ["dense", "fused"])
@pytest.mark.parametrize("opt", sorted(STALE_PARTIAL))
def test_staleness_and_partial_without_profile_match_jax(opt, backend):
    """The reference arms staleness and partial participation only when the
    adversary carries a worker profile (``src/repro/core/solver.py``:
    ``stale_on``/``part_on``).  Without one, the port's adversary run with
    ``max_delay=3`` and/or ``partial_participation=True`` equals JAX's
    (decisions exactly, values within 1e-6) and its own ``max_delay=0``
    run bit for bit."""
    over = dict(guard_backend=backend, **STALE_PARTIAL[opt])
    jprob = jax_problem(d=D, sigma=1.0, L=8.0, V=1.0, seed=0)
    jadv = JaxAdversary(jspec.scenario_static("sign_flip"), jnp.asarray(0.25, jnp.float32))
    want = jax_run_sgd(jprob, JaxConfig(**_cfg("off", **over)), jax.random.PRNGKey(3),
                       adversary=jadv)
    got = _port("static_sign_flip", "off", **over)
    _assert_decisions_equal(got, want)
    for f in ("gaps", "x_final", "x_avg"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    plain = _port("static_sign_flip", "off", guard_backend=backend)
    for f in ("n_alive", "byz_mask", "final_alive", "gaps", "x_final", "x_avg"):
        assert torch.equal(getattr(got, f), getattr(plain, f)), f


def test_convert_carries_a_jax_scenario_into_a_run():
    """A JAX Scenario carried by ``convert`` runs as the port's own."""
    jscn = jspec.scenario_churn("sign_flip", period=20, stride=2)
    carried = adversary.ScenarioAdversary(
        convert.scenario_from_numpy(*map(np.asarray, jscn)), 0.25)
    prob = make_generated_problem(d=D, sigma=1.0, L=8.0, V=1.0, seed=0, device="cpu")
    res = run_sgd(prob, SolverConfig(**_cfg("kernel")), prng.PRNGKey(3), adversary=carried,
                  device="cpu")
    own = _port("churn", "kernel")
    assert torch.equal(res.gaps, own.gaps) and torch.equal(res.byz_mask, own.byz_mask)
    # churn rotates the Byzantine set: the union outgrows one step's 4
    assert int(res.byz_mask.sum()) > 4


@pytest.mark.parametrize("name", ["static_alie", "static_alie_update", "coalition"])
@pytest.mark.parametrize("sd", ["f32", "bf16"])
def test_gen_step_hands_alie_moments_to_gen_xi(name, sd, monkeypatch):
    """ALIE's honest moments are taken once a step: every step's
    ``ops.gen_xi`` reads the (2, d) moments that the same step's
    ``ops.fused_guard_gen`` returned, and the run equals JAX's generating
    run (Pallas in interpret mode): decisions exactly, values within
    1e-6."""
    seen = []
    fg, gx = ops.fused_guard_gen, ops.gen_xi

    def sweep(*a, **k):
        assert k.get("return_moments")
        out = fg(*a, **k)
        seen.append(out[4])
        return out

    def xi_pass(*a, moments=None, **k):
        assert moments is not None and moments is seen[-1]
        assert torch.isfinite(moments).all()
        seen.append(moments)
        return gx(*a, moments=moments, **k)

    monkeypatch.setattr(ops, "fused_guard_gen", sweep)
    monkeypatch.setattr(ops, "gen_xi", xi_pass)
    got = _port(name, "kernel", stats_dtype=sd)
    assert len(seen) == 2 * T and all(m.shape == (2, D) for m in seen)
    jprob = jax_problem(d=D, sigma=1.0, L=8.0, V=1.0, seed=0)
    jadv = JaxAdversary(BY_NAME[name][0](jspec), jnp.asarray(0.25, jnp.float32))
    want = jax_run_sgd(jprob, JaxConfig(**_cfg("kernel", stats_dtype=sd)),
                       jax.random.PRNGKey(3), adversary=jadv)
    _assert_decisions_equal(got, want)
    for f in ("gaps", "x_final", "x_avg"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-6, err_msg=f)

