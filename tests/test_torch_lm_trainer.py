"""The port's LM training path (``repro_torch.optim``,
``data.synthetic``, ``distributed.byzantine_dp.apply_tree_attack``,
``distributed.trainer``, ``launch.train``, ``convert``'s parameter and
state carriers) against the JAX package's, on the CPU.

Inputs are made from seeds (numpy, or the two packages' bit-equal key
chains); both packages run on the CPU.  The model is internlm2-1.8b
``reduced(max_d_model=64)`` (2 layers, vocab 512), W = 8, α = 0.25,
sequences of 16–32 tokens.  Tolerances: tokens, labels, ranks and every
filter decision (``n_alive``, ``byz_alive``, ``good_filtered``, the alive
mask) exactly equal at every step; optimizer updates within 1e-6
relative (f32, the same order of operations but for XLA's fused
multiply-adds and its pow); losses, ξ and parameters within 1e-4
relative after a few steps (‖got − want‖ ≤ tol·‖want‖ + tol: the
per-worker gradients sum thousands of f32 terms in another order, and
AdamW divides by √v of near-zero moments).  The ``train_step`` tests start
the port from the JAX package's initial state carried over by
``convert.train_state_from_numpy``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.solver import SolverConfig as JConfig
from repro.core.solver import byz_rank as jbyz_rank
from repro.data import synthetic as jsyn
from repro.distributed import byzantine_dp as jdp
from repro.distributed import trainer as jtrainer
from repro.launch.train import run_training as jrun_training
from repro.models.model import build_model as jbuild
from repro.obs import TelemetryConfig as JTel
from repro.optim import optimizers as jopt
from repro.scenarios import ScenarioAdversary as JAdv
from repro.scenarios import scenario_churn as jchurn
from repro.scenarios import scenario_static as jstatic
from repro.scenarios import worker_profile as jworker_profile
from repro_torch import convert, prng, utils
from repro_torch.configs import get_config
from repro_torch.core.solver import SolverConfig, byz_rank, run_sgd
from repro_torch.core.tree_harness import VectorModel
from repro_torch.data import synthetic as tsyn
from repro_torch.data.problems import make_quadratic_problem
from repro_torch.distributed import byzantine_dp as tdp
from repro_torch.distributed import trainer as ttrainer
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import build_model as tbuild
from repro_torch.obs import TelemetryConfig
from repro_torch.optim import optimizers as topt
from repro_torch.scenarios import (
    ScenarioAdversary,
    scenario_churn,
    scenario_static,
    worker_profile,
)

W, ALPHA, STEPS, SEQ = 8, 0.25, 2, 16
LOOSE = 1e-4


def _close(got, want, tol):
    got = np.asarray(got.detach().cpu().double() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    assert err <= tol * np.linalg.norm(want) + tol, (err, np.linalg.norm(want))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_trees(got, want, tol):
    jl, tl = jax.tree_util.tree_leaves(want), utils.tree_leaves(got)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        _close(b, a, tol)


# ---------------------------------------------------------------- optimizers

def _opt_pairs():
    sched_j = jopt.linear_warmup_cosine(0.05, warmup=2, total_steps=9)
    sched_t = topt.linear_warmup_cosine(0.05, warmup=2, total_steps=9)
    x1 = {"a": np.full((5, 3), 0.2, np.float32), "b": [np.zeros(7, np.float32)]}
    return {
        "sgd": (jopt.sgd(0.1), topt.sgd(0.1)),
        "sgd_clip": (jopt.sgd(sched_j, grad_clip=0.5), topt.sgd(sched_t, grad_clip=0.5)),
        "momentum": (jopt.momentum(0.1, 0.8), topt.momentum(0.1, 0.8)),
        "nesterov": (jopt.momentum(0.1, 0.9, nesterov=True, grad_clip=1.0),
                     topt.momentum(0.1, 0.9, nesterov=True, grad_clip=1.0)),
        "adamw": (jopt.adamw(sched_j, grad_clip=1.0), topt.adamw(sched_t, grad_clip=1.0)),
        "adamw_wd": (jopt.adamw(3e-3, b1=0.8, weight_decay=0.1),
                     topt.adamw(3e-3, b1=0.8, weight_decay=0.1)),
        "projected": (jopt.projected_sgd(0.5, jax.tree_util.tree_map(jnp.asarray, x1), 0.3),
                      topt.projected_sgd(0.5, convert.params_from_numpy(x1, "cpu"), 0.3)),
    }


@pytest.mark.parametrize("name", sorted(_opt_pairs()))
def test_optimizers_match_jax(name):
    jo, to = _opt_pairs()[name]
    rng = np.random.default_rng(11)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": [rng.normal(size=7).astype(np.float32)]}
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), convert.params_from_numpy(params, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for step in range(6):
        g = {"a": rng.normal(size=(5, 3)).astype(np.float32) * 10 ** (step - 3),
             "b": [rng.normal(size=7).astype(np.float32)]}
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, jnp.asarray(step))
        tu, ts = to.update(convert.params_from_numpy(g, "cpu"), ts, tp, step)
        _close_trees(tu, ju, 1e-6)
        jp, tp = jax.tree_util.tree_map(jnp.add, jp, ju), utils.tree_add(tp, tu)
    _close_trees(ts, js, 1e-6)


@pytest.mark.parametrize("kind", ["cosine", "warmup_cosine"])
def test_schedules_match_jax(kind):
    if kind == "cosine":
        j, t = jopt.cosine_schedule(0.3, 50, 0.2), topt.cosine_schedule(0.3, 50, 0.2)
    else:
        j, t = jopt.linear_warmup_cosine(3e-3, 5, 100), topt.linear_warmup_cosine(3e-3, 5, 100)
    for step in (0, 1, 4, 5, 6, 37, 99, 100, 150):
        _close(t(torch.tensor(step, dtype=torch.int32)), j(jnp.asarray(step, jnp.int32)), 1e-7)


def test_adamw_keeps_bf16_params_and_f32_moments():
    p = {"w": convert.tensor_from_numpy(np.asarray(jnp.ones((4, 4), jnp.bfloat16)), "cpu")}
    opt = topt.adamw(1e-2)
    state = opt.init(p)
    upd, state = opt.update({"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16)}, state, p, 0)
    assert upd["w"].dtype == torch.bfloat16 and state["m"]["w"].dtype == torch.float32


# ---------------------------------------------------------------- synthetic tokens

@pytest.mark.parametrize("poison,skew", [(False, False), (True, False), (False, True),
                                         (True, True)])
def test_worker_batches_are_jaxs_bit_for_bit(poison, skew):
    js, ts = jsyn.SyntheticTokens(512, 32, seed=4), tsyn.SyntheticTokens(512, 32, seed=4)
    mask = np.array([0, 1, 0, 0, 1, 0, 0, 0], bool)
    sk = np.linspace(0.0, 0.7, W).astype(np.float32)
    for step in (0, 3, 1000):
        want = jsyn.make_worker_batch(js, W, 2, jnp.asarray(step),
                                      poison_mask=jnp.asarray(mask) if poison else None,
                                      skew=jnp.asarray(sk) if skew else None)
        got = tsyn.make_worker_batch(ts, W, 2, step, device="cpu",
                                     poison_mask=torch.tensor(mask) if poison else None,
                                     skew=torch.tensor(sk) if skew else None)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            assert got[k].dtype == torch.int32
    np.testing.assert_array_equal(ts.sample(5, 7, 3, device="cpu").numpy(),
                                  np.asarray(js.sample(jnp.asarray(5), jnp.asarray(7), 3)))


# ---------------------------------------------------------------- tree attacks

@pytest.mark.parametrize("name", ["none", "sign_flip", "noise", "constant_drift",
                                  "scaled_copy"])
def test_apply_tree_attack_matches_jax(name):
    rng = np.random.default_rng(12)
    tree = {"w": rng.normal(size=(W, 4, 3)).astype(np.float32),
            "b": [rng.normal(size=(W, 5)).astype(np.float32)]}
    mask = np.array([1, 0, 0, 1, 0, 0, 0, 0], bool)
    want = jdp.apply_tree_attack(name, jax.random.PRNGKey(3),
                                 jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(mask),
                                 scale=2.5)
    got = tdp.apply_tree_attack(name, prng.PRNGKey(3), convert.params_from_numpy(tree, "cpu"),
                                torch.tensor(mask), scale=2.5)
    for a, b in zip(jax.tree_util.tree_leaves(want), utils.tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-6, atol=1e-6)
        np.testing.assert_array_equal(b.numpy()[~mask], np.asarray(a)[~mask])
    with pytest.raises(KeyError):
        tdp.apply_tree_attack("nope", prng.PRNGKey(0), got, torch.tensor(mask))


def test_rank_from_mask_matches_jax():
    for bits in ([1, 0, 0, 1, 0, 0, 0, 0], [0] * 8, [1] * 8, [0, 1, 1, 0, 1, 0, 0, 1]):
        mask = np.array(bits, bool)
        got = ttrainer.rank_from_mask(torch.tensor(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jtrainer.rank_from_mask(mask)))


# ---------------------------------------------------------------- train_step

CASES = {
    # name: (SolverConfig overrides, V, scenario churn?, telemetry?)
    "dense": (dict(guard_backend="dense"), 2.0, False, False),
    "fused": (dict(guard_backend="fused"), 2.0, False, False),
    "dp_exact": (dict(guard_backend="dp_exact"), 0.0, False, False),
    "dp_sketch": (dict(guard_backend="dp_sketch", guard_opts=(("sketch_dim", 64),)), 0.0,
                  False, False),
    "mean": (dict(aggregator="mean"), 0.0, False, False),
    "krum": (dict(aggregator="krum"), 0.0, False, False),
    "churn": (dict(guard_backend="dp_exact"), 0.0, True, False),
    "telemetry": (dict(guard_backend="dp_exact"), 0.0, False, True),
    # a fleet whose last two workers straggle (stale buffer) and whose
    # honest workers report with probability 0.75 (reporting mask)
    "profile": (dict(guard_backend="dp_exact", max_delay=1, partial_participation=True), 0.0,
                False, False),
}
PROFILE = dict(delay=[0, 0, 0, 0, 0, 0, 1, 1], p_report=0.75)
DECISIONS = ("n_alive", "byz_alive", "good_filtered", "n_byz")


@pytest.fixture(scope="module")
def lm():
    jcfg = jget_config("internlm2-1.8b").reduced(max_d_model=64)
    tcfg = get_config("internlm2-1.8b").reduced(max_d_model=64)
    return jbuild(jcfg), tbuild(tcfg, device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(lm, case):
    jm, tm = lm
    over, V, churn, tel = CASES[case]
    base = dict(m=W, T=STEPS, eta=3e-3, alpha=ALPHA, attack="sign_flip", mean_over_alive=True)
    jcfg, tcfg = JConfig(**base, **over), SolverConfig(**base, **over)
    jo = jopt.adamw(jopt.linear_warmup_cosine(3e-3, 1, STEPS), grad_clip=1.0)
    to = topt.adamw(topt.linear_warmup_cosine(3e-3, 1, STEPS), grad_clip=1.0)
    jadv = JAdv(scenario=jchurn("sign_flip", period=1, stride=1), alpha=jnp.float32(ALPHA)) \
        if churn else None
    tadv = ScenarioAdversary(scenario=scenario_churn("sign_flip", period=1, stride=1),
                             alpha=ALPHA) if churn else None
    if case == "profile":
        jadv = JAdv(scenario=jstatic("sign_flip"), alpha=jnp.float32(ALPHA),
                    profile=jworker_profile(W, **PROFILE))
        tadv = ScenarioAdversary(scenario=scenario_static("sign_flip"), alpha=ALPHA,
                                 profile=worker_profile(W, device="cpu", **PROFILE))
    jstep = jax.jit(jtrainer.build_train_step(jm, jo, jcfg, V=V, adversary=jadv,
                                              telemetry=JTel() if tel else None))
    tstep = ttrainer.build_train_step(tm, to, tcfg, V=V, adversary=tadv,
                                      telemetry=TelemetryConfig() if tel else None)
    # one program for the whole initial state (op by op, jax compiles each op)
    jstate = jax.jit(lambda k: jtrainer.init_train_state(jm, jo, jcfg, k, V=V,
                                                         adversary=jadv))(jax.random.PRNGKey(0))
    tstate = convert.train_state_from_numpy(*_np_tree(jstate), device="cpu")
    jrank, trank = jbyz_rank(jax.random.PRNGKey(1), W), byz_rank(prng.PRNGKey(1), W)
    np.testing.assert_array_equal(trank.numpy(), np.asarray(jrank))
    js, ts = jsyn.SyntheticTokens(512, SEQ, seed=2), tsyn.SyntheticTokens(512, SEQ, seed=2)
    for i in range(STEPS):
        jstate, jm_ = jstep(jstate, jsyn.make_worker_batch(js, W, 2, jnp.asarray(i)), jrank,
                            jax.random.fold_in(jax.random.PRNGKey(3), i))
        tstate, tm_ = tstep(tstate, tsyn.make_worker_batch(ts, W, 2, i, device="cpu"), trank,
                            prng.fold_in(prng.PRNGKey(3), i))
        for k in DECISIONS:
            assert int(tm_[k]) == int(jm_[k]), (i, k)
        np.testing.assert_array_equal(tstate.prev_alive.numpy(), np.asarray(jstate.prev_alive))
        if case == "profile":
            assert float(tm_["n_reporting"]) == float(jm_["n_reporting"]), i
        _close(tm_["loss_good_workers"], jm_["loss_good_workers"], LOOSE)
        _close(tm_["loss_all_workers"], jm_["loss_all_workers"], LOOSE)
        if V == 0.0 and over.get("aggregator") is None:
            _close(tm_["v_est"], jm_["v_est"], LOOSE)
        if tel:
            assert {k for k in tm_ if k.startswith("tel/")} == \
                {k for k in jm_ if k.startswith("tel/")}
            np.testing.assert_array_equal(np.asarray(tm_["tel/alive"]),
                                          np.asarray(jm_["tel/alive"]))
            _close(tm_["tel/xi_norm"], jm_["tel/xi_norm"], LOOSE)
            _close(tm_["tel/dist_g"], jm_["tel/dist_g"], LOOSE)
    _close(tstate.prev_xi, jstate.prev_xi, LOOSE)
    _close_trees(tstate.params, jstate.params, LOOSE)
    _close_trees(tstate.opt_state, jstate.opt_state, LOOSE)
    assert tstate.step == int(jstate.step) == STEPS
    back = convert.train_state_to_numpy(tstate)
    _close(back["anchor"], jstate.anchor, 0.0)
    np.testing.assert_array_equal(back["ever_byz"], np.asarray(jstate.ever_byz))


def test_fused_and_dense_need_v(lm):
    _, tm = lm
    for backend in ("dense", "fused"):
        cfg = SolverConfig(m=W, T=2, eta=0.1, alpha=ALPHA, guard_backend=backend)
        with pytest.raises(ValueError, match="auto-V"):
            ttrainer.build_train_step(tm, topt.sgd(0.1), cfg)


@pytest.mark.parametrize("backend", ["dense", "fused", "dp_exact"])
def test_vector_model_trainer_reproduces_run_sgd(backend):
    """The trainer on ``VectorModel(problem)`` fed run_sgd's own noise
    stream decides as ``run_sgd`` and lands on its iterate."""
    quad = make_quadratic_problem(d=16, seed=0, device="cpu")
    gopts = (("auto_v", False),) if backend == "dp_exact" else ()
    cfg = SolverConfig(m=W, T=25, eta=0.05, alpha=ALPHA, attack="sign_flip",
                       guard_backend=backend, guard_opts=gopts)
    res = run_sgd(quad, cfg, prng.PRNGKey(5), device="cpu")
    model = VectorModel(quad)
    opt = topt.projected_sgd(cfg.eta, {"x": quad.x1}, quad.D)
    step = ttrainer.build_train_step(model, opt, cfg, V=quad.V, D=quad.D)
    state = ttrainer.init_train_state(model, opt, cfg, prng.PRNGKey(0), V=quad.V, D=quad.D)
    key, mask_key = prng.split(prng.PRNGKey(5))
    rank = byz_rank(mask_key, W)
    zero = torch.zeros(quad.d)
    g0 = quad.grad(zero)
    rng, n_alive = key, []
    for _ in range(cfg.T):
        rng, gkey, akey = prng.split(rng, 3)
        noise = quad.stoch_grad(prng.split(gkey, W), zero) - g0
        state, m = step(state, {"noise": noise[:, None, :]}, rank, akey)
        n_alive.append(int(m["n_alive"]))
    np.testing.assert_array_equal(np.array(n_alive), res.n_alive.numpy())
    np.testing.assert_array_equal(state.prev_alive.numpy(), res.final_alive.numpy())
    np.testing.assert_allclose(state.params["x"].numpy(), res.x_final.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert state.prev_xi.shape[0] % 128 == 0 and not state.prev_xi[quad.d:].any()


# ---------------------------------------------------------------- run_training

LAUNCH = dict(reduced=True, d_model=64, workers=W, seq_len=32, steps=6, log_every=4)


@pytest.mark.parametrize("attack", ["sign_flip", "label_flip"])
def test_run_training_matches_jax(attack):
    kw = dict(LAUNCH, attack=attack, guard_backend="dp_exact")
    # JAX's loop driver runs the same jitted step as its scan driver with one
    # compile instead of two (the scan chunk and the ragged tail's step)
    _, jh = jrun_training("internlm2-1.8b", driver="loop", **kw)
    _, th = tlaunch.run_training("internlm2-1.8b", device="cpu", verbose=False, **kw)
    assert len(jh) == len(th) == LAUNCH["steps"]
    for a, b in zip(jh, th):
        assert a["step"] == b["step"]
        for k in DECISIONS:
            assert a[k] == b[k], (a["step"], k)
        _close(b["loss_good_workers"], a["loss_good_workers"], LOOSE)
        _close(b["v_est"], a["v_est"], LOOSE)


def test_scan_and_loop_drivers_agree_and_trace(tmp_path):
    kw = dict(LAUNCH, steps=5, log_every=2)
    _, scan = tlaunch.run_training("internlm2-1.8b", device="cpu", verbose=False, **kw)
    trace = tmp_path / "trace.jsonl"
    _, loop = tlaunch.run_training("internlm2-1.8b", device="cpu", verbose=False, driver="loop",
                                   trace=str(trace), **kw)
    np.testing.assert_equal(scan, loop)   # NaN (n_reporting off) equal to NaN
    lines = trace.read_text().splitlines()
    assert len([ln for ln in lines if '"guard_step"' in ln]) == 5
    _, head = tlaunch.run_training("internlm2-1.8b", device="cpu", verbose=False,
                                   stop_after=3, **kw)
    np.testing.assert_equal(head, scan[:3])   # schedules sized by steps, not stop_after
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tlaunch.run_training("internlm2-1.8b", device="cpu", ckpt_dir=str(tmp_path), **kw)
    with pytest.raises(ValueError, match="label_flip"):
        tlaunch.run_training("internlm2-1.8b", device="cpu", attack="label_flip",
                             scenario="churn", **kw)


def test_cli_runs_on_the_cpu(capsys):
    tlaunch.main(["--arch", "internlm2-1.8b", "--d-model", "64", "--workers", "8",
                  "--steps", "2", "--seq-len", "16", "--log-every", "1", "--device", "cpu",
                  "--scenario", "churn"])
    out = capsys.readouterr().out
    assert out.count("step ") == 2 and "alive=" in out


@pytest.mark.parametrize("blocks", [False, True])
def test_dp_products_by_blocks_and_pieces_are_f32_sums(monkeypatch, blocks):
    """The dp guard's worker-axis products at a width that takes the
    pieces-of-SPLIT_K path (and, with small column blocks, several blocks)
    against f64 sums: each entry within 1e-6 of Σ|aᵢ·bᵢ| (the error of f32
    sums over pieces; the inputs are random, so the sums themselves
    cancel and a relative bound on them would measure the data, not the
    code)."""
    if blocks:
        monkeypatch.setattr(tdp, "COL_BLOCK", 1 << 17)
    rng = np.random.default_rng(13)
    n = 3 * tdp.SPLIT_K + 4099
    a = rng.normal(size=(W, n)).astype(np.float32)
    b = rng.normal(size=(W, n)).astype(np.float32)
    v = rng.normal(size=n).astype(np.float32)
    a64, b64, v64 = (x.astype(np.float64) for x in (a, b, v))
    ta, tb, tv = (torch.from_numpy(x) for x in (a, b, v))
    cases = [(tdp.worker_pair_gram(tb, ta), b64 @ a64.T, np.abs(b64) @ np.abs(a64).T),
             (tdp.worker_cross_gram(ta), a64 @ a64.T, np.abs(a64) @ np.abs(a64).T),
             (tdp.worker_vdot(ta, tb), (a64 * b64).sum(1), np.abs(a64 * b64).sum(1)),
             (tdp.worker_vdot(ta, tv), a64 @ v64, np.abs(a64) @ np.abs(v64)),
             (tdp._worker_sum(ta)[0], a64.sum(0), np.abs(a64).sum(0))]
    for got, exact, scale in cases:
        assert np.all(np.abs(got.double().numpy() - exact) <= 1e-6 * scale + 1e-12)
