"""The port's scenario specs and adversary (``repro_torch.scenarios``)
against the JAX package's, on the same numpy inputs, with the JAX
scenario carried across by ``convert.scenario_from_numpy``.

Per attack id: ``ScenarioAdversary.attack`` (both coalition phases, a
scaled and an adaptive magnitude), ``gen_attack_ctx`` and the feedback
update; ``mask_at`` under churn and late join.  Rows and masks are
bit-equal (the attacks follow the JAX expressions op by op), but where a
row depends on a reduction over rows or coordinates, which the two
libraries sum in another order: ALIE's honest moments (ids 4 and 8) and
‖∇f‖ (inner_product 5, retreat_on_filter 7) are held to 1e-6.  The
parameter vector holds ‖∇f‖ and ALIE's ``ndtri`` calibration, both
computed by another library's routine, so it is held to 1e-6 relative;
its ids and the slots are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.scenarios import adversary as jadv
from repro.scenarios import faults as jfaults
from repro.scenarios import spec as jspec
from repro_torch import convert, prng
from repro_torch.core.solver import SolverConfig, byz_rank, run_sgd
from repro_torch.data.problems import make_generated_problem
from repro_torch.kernels import gradgen
from repro_torch.scenarios import adversary, faults, spec

M, D = 16, 33
IDS = [i for i, name in enumerate(adversary.ATTACK_TABLE) if name != "random_gaussian"]
# rows that depend on a reduction: ALIE's honest moments (4, 8), ‖∇f‖ (5, 7)
REDUCED_IDS = (4, 5, 7, 8)


def _pair(jscn, alpha=0.25):
    """The JAX adversary and the port's, from one JAX scenario."""
    tscn = convert.scenario_from_numpy(*map(np.asarray, jscn))
    return (jadv.ScenarioAdversary(jscn, jnp.asarray(alpha, jnp.float32)),
            adversary.ScenarioAdversary(tscn, alpha))


def _ctx(seed=0, *, step=3, dead=()):
    rng = np.random.default_rng(seed)
    tg = rng.normal(size=D).astype(np.float32)
    alive = np.ones(M, bool)
    alive[list(dead)] = False
    xi = rng.normal(size=D).astype(np.float32)
    j = {"true_grad": jnp.asarray(tg), "V": 1.5, "step": jnp.int32(step),
         "alive": jnp.asarray(alive), "n_alive": jnp.int32(alive.sum()),
         "prev_xi": jnp.asarray(xi)}
    t = {"true_grad": torch.from_numpy(tg), "V": 1.5, "step": step,
         "alive": torch.from_numpy(alive), "n_alive": torch.tensor(int(alive.sum())),
         "prev_xi": torch.from_numpy(xi)}
    return j, t


def _mask(n_byz=5, seed=0):
    rank = np.random.default_rng(seed + 1).permutation(M)
    return rank < n_byz


def _equal_or_close(got, want, aid):
    got, want = np.asarray(got), np.asarray(want)
    if aid in REDUCED_IDS:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("aid", IDS)
def test_attack_matches_jax(aid):
    """Phase a plays ``aid``, phase b sign_flip, at an adaptive magnitude
    (attack_scale 1.3 times a carried 1.7); retreat_on_filter also with a
    caught colluder."""
    name = adversary.ATTACK_TABLE[aid]
    jscn = jspec.make_scenario(attack_a=name, attack_b="sign_flip", coalition_frac=0.5,
                               attack_scale=1.3, adapt_rate=0.5)
    ja, ta = _pair(jscn)
    grads = np.random.default_rng(aid).normal(size=(M, D)).astype(np.float32)
    mask = _mask()
    caught = ((int(np.flatnonzero(mask)[0]),),) if name == "retreat_on_filter" else ()
    for dead in ((), *caught):
        jctx, tctx = _ctx(dead=dead)
        js = jadv.AdvState(adapt_scale=jnp.float32(1.7))
        ts = convert.adv_state_from_numpy(np.float32(1.7), device="cpu")
        want = ja.attack(jax.random.PRNGKey(0), jnp.asarray(grads), jnp.asarray(mask), jctx, js)
        got = ta.attack(prng.PRNGKey(0), torch.from_numpy(grads), torch.from_numpy(mask),
                        tctx, ts)
        _equal_or_close(got.numpy(), want, aid)
        # honest rows pass through bit for bit
        np.testing.assert_array_equal(got.numpy()[~mask], grads[~mask])


@pytest.mark.parametrize("aid", IDS)
def test_gen_attack_ctx_matches_jax(aid):
    name = adversary.ATTACK_TABLE[aid]
    jscn = jspec.make_scenario(attack_a="inner_product", attack_b=name, switch_step=2,
                               attack_scale=0.8, adapt_rate=0.25)
    ja, ta = _pair(jscn)
    mask = _mask()
    for step, dead in ((1, ()), (5, (int(np.flatnonzero(mask)[0]),))):
        jctx, tctx = _ctx(aid, step=step, dead=dead)
        want = ja.gen_attack_ctx(jnp.asarray(mask), jctx, jadv.AdvState(jnp.float32(2.0)),
                                 jnp.float32(0.25))
        got = ta.gen_attack_ctx(torch.from_numpy(mask), tctx,
                                convert.adv_state_from_numpy(2.0, device="cpu"), 0.25)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))      # slot
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))      # w_byz
        gp, wp = got[1].numpy(), np.asarray(want[1])
        ids = [gradgen.P_ID_A, gradgen.P_ID_B]
        np.testing.assert_array_equal(gp[ids], wp[ids])
        np.testing.assert_allclose(gp, wp, rtol=1e-6, atol=0)


def test_gen_attack_ctx_remaps_retreat_on_its_condition():
    """retreat_on_filter (id 7) reaches the kernel as inner_product (5)
    while the coalition is intact, and as none (0) once one is caught."""
    ja, ta = _pair(jspec.scenario_static("retreat_on_filter"))
    mask = _mask()
    for dead, want in (((), 5.0), ((int(np.flatnonzero(mask)[0]),), 0.0)):
        _, tctx = _ctx(dead=dead)
        slot, params, _ = ta.gen_attack_ctx(torch.from_numpy(mask), tctx,
                                            ta.init_state(M, D, device="cpu"), 0.25)
        assert float(params[gradgen.P_ID_A]) == want == float(params[gradgen.P_ID_B])
        assert torch.equal(slot, torch.from_numpy(mask).to(torch.int32))


@pytest.mark.parametrize("jscn", [jspec.scenario_churn("sign_flip", period=3, stride=2),
                                  jspec.scenario_late_join("alie", 4),
                                  jspec.scenario_static("alie")],
                         ids=["churn", "late_join", "static"])
def test_mask_at_matches_jax(jscn):
    ja, ta = _pair(jscn, alpha=0.3)
    rank = np.random.default_rng(5).permutation(M)
    for k in range(12):
        want = ja.mask_at(jnp.asarray(rank), jnp.int32(k))
        got = ta.mask_at(torch.from_numpy(rank), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ta.n_byz(M) == int(ja.n_byz(M)) == 4


@pytest.mark.parametrize("win", [True, False])
def test_update_state_matches_jax(win):
    ja, ta = _pair(jspec.scenario_adaptive("inner_product", 0.5))
    mask = _mask()
    rng = np.random.default_rng(7)
    grads = rng.normal(size=(M, D)).astype(np.float32)
    jctx, tctx = _ctx()
    tg = np.asarray(jctx["true_grad"])
    byz_row = grads[mask].mean(axis=0)
    # ξ leaning along (win) or against (loss) the coalition's deviation
    xi = (0.75 * tg + (1.0 if win else -1.0) * (byz_row - tg)).astype(np.float32)
    alive = np.ones(M, bool)
    n_alive = 12
    for via_row in (False, True):
        js, ts = jadv.AdvState(jnp.float32(1.3)), convert.adv_state_from_numpy(1.3, "cpu")
        if via_row:
            row = jnp.sum(jnp.asarray(grads) * jnp.asarray(mask, jnp.float32)[:, None], 0) / 5
            want = ja.update_state_from_byz_row(js, jnp.asarray(mask), row, jnp.asarray(xi),
                                                jnp.asarray(alive), jnp.int32(n_alive), jctx)
            got = ta.update_state_from_byz_row(
                ts, torch.from_numpy(mask), torch.from_numpy(np.array(row)),
                torch.from_numpy(xi), torch.from_numpy(alive), torch.tensor(n_alive), tctx)
        else:
            want = ja.update_state(js, jnp.asarray(mask), jnp.asarray(grads), jnp.asarray(xi),
                                   jnp.asarray(alive), jnp.int32(n_alive), jctx)
            got = ta.update_state(ts, torch.from_numpy(mask), torch.from_numpy(grads),
                                  torch.from_numpy(xi), torch.from_numpy(alive),
                                  torch.tensor(n_alive), tctx)
        assert float(got.adapt_scale) == float(want.adapt_scale)
        assert (float(got.adapt_scale) > 1.3) == win


def test_update_state_is_the_identity_without_adaptation():
    _, ta = _pair(jspec.scenario_static("sign_flip"))
    state = ta.init_state(M, D, device="cpu")
    _, tctx = _ctx()
    mask = torch.from_numpy(_mask())
    out = ta.update_state(state, mask, torch.ones(M, D), torch.ones(D),
                          torch.ones(M, dtype=torch.bool), torch.tensor(M), tctx)
    assert out is state


@pytest.mark.parametrize("make", [
    lambda s: s.scenario_static("alie", 1.5),
    lambda s: s.scenario_lie_low_then_strike("inner_product", 20),
    lambda s: s.scenario_churn("sign_flip", 20, 2),
    lambda s: s.scenario_late_join("alie", 15),
    lambda s: s.scenario_coalition("sign_flip", "alie", 0.5),
    lambda s: s.scenario_adaptive("hidden_shift", 0.5, 2.0),
    lambda s: s.make_scenario(attack_a="constant_drift", attack_b="alie_update",
                              switch_step=7, coalition_frac=0.25),
], ids=["static", "lie_low", "churn", "late_join", "coalition", "adaptive", "general"])
def test_constructors_match_jax(make):
    want, got = make(jspec), make(spec)
    assert convert.scenario_from_numpy(*map(np.asarray, want)) == got
    assert type(got.coalition_frac) is np.float32 and type(got.attack_a) is int


def test_attack_table_and_knobs_match_jax():
    assert adversary.ATTACK_TABLE == jadv.ATTACK_TABLE
    assert adversary._KNOB_DEFAULTS == jadv._KNOB_DEFAULTS
    assert (adversary.ADAPT_MIN, adversary.ADAPT_MAX, adversary._WIN_COS) == (
        jadv.ADAPT_MIN, jadv.ADAPT_MAX, jadv._WIN_COS)
    assert spec.NEVER == jspec.NEVER
    with pytest.raises(KeyError):
        adversary.attack_id("mirror")


def test_unported_parts_raise():
    """Nothing of the adversary is left unported: random_gaussian (id 2)
    draws its noise into the Byzantine rows only (its parity with JAX is
    in ``test_torch_convex.py``)."""
    scn = spec.scenario_static("random_gaussian")
    adv = adversary.ScenarioAdversary(scn, 0.25)
    _, tctx = _ctx()
    mask = torch.from_numpy(_mask())
    rows = adv.attack(prng.PRNGKey(0), torch.ones(M, D), mask, tctx,
                      adv.init_state(M, D, device="cpu"))
    assert torch.equal(rows[~mask], torch.ones(int((~mask).sum()), D))
    assert float(rows[mask].abs().max()) > 50.0
    # worker profiles and fault plans are ported: the adversary carries
    # the JAX package's leaves as they were
    jprofile = jspec.profile_stragglers(M, 0.25, 3)
    jplan = jfaults.fault_nan_rows(0.1, start_step=2)
    carried = adversary.ScenarioAdversary(
        scn, 0.25, profile=convert.profile_from_numpy(*map(np.asarray, jprofile), device="cpu"),
        faults=convert.fault_plan_from_numpy(*map(np.asarray, jplan)))
    for field in ("skew", "delay", "p_report"):
        np.testing.assert_array_equal(getattr(carried.profile, field).numpy(),
                                      np.asarray(getattr(jprofile, field)), err_msg=field)
    assert carried.faults == faults.fault_nan_rows(0.1, start_step=2)


def test_static_scenario_is_the_static_attack():
    """``scenario_static(a)`` at α reproduces ``cfg.attack = a`` bit for bit
    (scale 1 is the zoo's default magnitude)."""
    prob = make_generated_problem(d=D, seed=1, device="cpu")
    for name in ("sign_flip", "alie", "hidden_shift"):
        cfg = SolverConfig(m=M, T=12, eta=0.05, alpha=0.25, attack=name,
                           guard_backend="fused")
        static = run_sgd(prob, cfg, prng.PRNGKey(4), device="cpu")
        scen = run_sgd(prob, cfg, prng.PRNGKey(4), device="cpu",
                       adversary=adversary.ScenarioAdversary(spec.scenario_static(name), 0.25))
        for f in ("gaps", "x_final", "n_alive", "byz_mask", "final_alive"):
            assert torch.equal(getattr(static, f), getattr(scen, f)), (name, f)
    rank = byz_rank(prng.split(prng.PRNGKey(4))[1], M)
    assert torch.equal(static.byz_mask, rank < 4)
