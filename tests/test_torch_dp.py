"""The port's dp guards (``repro_torch.distributed.byzantine_dp`` and the
``dp_exact``/``dp_sketch`` guard backends) against the JAX package's.

Inputs are made with numpy from a seed; JAX runs on the CPU and the port on
the CPU (``ops`` runs the plain versions).  Filter decisions (``alive``,
``n_alive``) are equal at every step; values agree within 1e-5 relative at
f32 and 1e-2 at bf16 (‖got − want‖ ≤ tol·‖want‖ + tol), the tolerances of
the port's other guard tests.  The step-by-step test carries the JAX state
into the port through ``convert`` before every step, so each step is held
to the reference on its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solver import Problem as JaxProblem
from repro.core.solver import SolverConfig as JaxConfig
from repro.core.solver import make_aggregator as jax_make_aggregator
from repro.core.solver import run_sgd as jax_run_sgd
from repro.data.problems import make_generated_problem as jax_problem
from repro.distributed import byzantine_dp as jdp
from repro_torch import convert, prng
from repro_torch.core.guard_backends import make_guard_backend
from repro_torch.core.solver import Problem, SolverConfig, make_aggregator, run_sgd
from repro_torch.data.problems import make_generated_problem
from repro_torch.distributed import byzantine_dp as tdp

M, D_DIM, STEPS = 8, 300, 20
TOL = {"f32": 1e-5, "bf16": 1e-2}


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    assert err <= tol * np.linalg.norm(want) + tol, (err, np.linalg.norm(want))


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _stream(seed, report_p):
    """Per-step (grads, x_k, x1, report): six honest workers around a common
    mean and two (rows 2 and 5) that add a 3V bias along a fixed direction;
    with ``report_p`` each worker reports with that probability."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=D_DIM)
    u /= np.linalg.norm(u)
    mu = 0.1 * rng.normal(size=D_DIM)
    x1 = np.zeros(D_DIM, np.float32)
    for k in range(STEPS):
        g = mu + rng.uniform(-1, 1, size=(M, D_DIM)) / np.sqrt(D_DIM)
        g[[2, 5]] += 3.0 * u
        x_k = (x1 + 0.01 * k * mu).astype(np.float32)
        report = None if report_p is None else rng.uniform(size=M) < report_p
        yield g.astype(np.float32), x_k, x1, report


# (mode, stats dtype, auto_v, gram: incremental | recompute | resync8,
#  sketch_dim, report probability): every value of each axis appears with
#  each mode and dtype
STEP_CASES = [
    ("exact", "f32", True, "incremental", 0, None),
    ("exact", "f32", False, "recompute", 0, 0.8),
    ("exact", "f32", True, "resync8", 0, 0.8),
    ("exact", "bf16", True, "incremental", 0, 0.8),
    ("exact", "bf16", False, "resync8", 0, None),
    ("exact", "bf16", True, "recompute", 0, None),
    ("sketch", "f32", True, "incremental", 64, None),
    ("sketch", "f32", False, "incremental", 64, 0.8),
    ("sketch", "f32", True, "incremental", 4096, 0.8),
    ("sketch", "bf16", True, "incremental", 64, 0.8),
    ("sketch", "bf16", False, "incremental", 4096, None),
]


def _dp_cfg(mod, mode, sd, auto_v, gram, k):
    return mod.DPGuardConfig(
        n_workers=M, T=100, V=1.0, D=5.0, mode=mode, sketch_dim=k or 4096, auto_v=auto_v,
        incremental_gram=gram != "recompute",
        gram_resync_every=8 if gram == "resync8" else 64,
        low_precision_stats=sd == "bf16", stats_dtype=sd)


@pytest.mark.parametrize("mode,sd,auto_v,gram,k,report_p", STEP_CASES)
def test_guard_step_matches_jax_step_by_step(mode, sd, auto_v, gram, k, report_p):
    jcfg = _dp_cfg(jdp, mode, sd, auto_v, gram, k)
    tcfg = _dp_cfg(tdp, mode, sd, auto_v, gram, k)
    jstep = jax.jit(jdp.guard_step, static_argnums=0)
    js = jdp.init_guard_state(jcfg, jnp.zeros((D_DIM,)))
    for g, x_k, x1, report in _stream(seed=len(mode) + k, report_p=report_p):
        ts = convert.dp_guard_state_from_numpy(
            np.asarray(js.A), np.asarray(js.B), np.asarray(js.alive), int(js.k),
            np.asarray(js.v_est), np.asarray(js.gram_B), device="cpu")
        js, jxi, jdiag = jstep(jcfg, js, jnp.asarray(g), jnp.asarray(x_k), jnp.asarray(x1),
                               None if report is None else jnp.asarray(report))
        ts, txi, tdiag = tdp.guard_step(
            tcfg, ts, torch.from_numpy(g), torch.from_numpy(x_k), torch.from_numpy(x1),
            None if report is None else torch.from_numpy(report))
        np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
        assert int(tdiag["n_alive"]) == int(jdiag["n_alive"])
        assert ts.k == int(js.k)
        back = convert.dp_guard_state_to_numpy(ts)
        for name in ("A", "B", "gram_B"):
            _rel_close(back[name], _f32(getattr(js, name)), TOL[sd])
        _rel_close(back["v_est"], _f32(js.v_est), TOL[sd])
        _rel_close(txi.to(torch.float32).numpy(), _f32(jxi), TOL[sd])
    # not a degenerate run: with everyone reporting no honest worker is
    # filtered, and with auto-V (V ≈ 0.4, so the 3-unit bias fails the 4V
    # gradient check) both biased ones are; at V = 1 the B check would need
    # ~30 steps.  (An honest worker that skips a step lags the B median by
    # the missing mean gradient, and both packages may filter it.)
    if report_p is None:
        alive = ts.alive.numpy()
        assert alive[[0, 1, 3, 4, 6, 7]].all()
        if auto_v:
            assert not alive[[2, 5]].any()


@pytest.mark.parametrize("sd", ["f32", "bf16"])
@pytest.mark.parametrize("lp", [False, True])
def test_worker_helpers_match_jax(sd, lp):
    """The Gram helpers, the sketch Gram and v_from_gram on one batch."""
    rng = np.random.default_rng(3)
    dt = jnp.bfloat16 if sd == "bf16" else jnp.float32
    g = jnp.asarray(rng.normal(size=(M, D_DIM)), jnp.float32).astype(dt)
    b = jnp.asarray(3 * rng.normal(size=(M, D_DIM)), jnp.float32).astype(dt)
    dlt = jnp.asarray(rng.normal(size=D_DIM), jnp.float32)
    tg, tb = (convert.tensor_from_numpy(np.asarray(a), "cpu") for a in (g, b))
    td = torch.from_numpy(np.array(dlt))
    pairs = [
        (tdp.worker_vdot(tg, td, lp), jdp.worker_vdot(g, dlt, lp)),
        (tdp.worker_sq_norms(tg, lp), jdp.worker_sq_norms(g, lp)),
        (tdp.worker_pair_gram(tb, tg, lp), jdp.worker_pair_gram(b, g, lp)),
        (tdp.worker_cross_gram([tg, tb], lp), jdp.worker_cross_gram([g, b], lp)),
    ]
    s = tdp.sketch_tree(tg, 64)
    pairs.append((tdp.sketch_gram(s, tdp.worker_sq_norms(tg, lp)),
                  jdp.sketch_gram(jdp.sketch_tree(g, 64, lp), jdp.worker_sq_norms(g, lp))))
    for got, want in pairs:
        _rel_close(got.numpy(), want, 1e-5)   # exact upcasts, f32 sums either way
    gram = pairs[3][1]
    report = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    for rep in (None, report):
        jrep = None if rep is None else jnp.asarray(rep)
        got = float(tdp.v_from_gram(torch.from_numpy(np.array(gram)),
                                    None if rep is None else torch.from_numpy(rep)))
        # op by op the quantile's low·(1 − w) + high·w is the port's bit for
        # bit; under jit XLA on the CPU may fuse the last product into an FMA
        with jax.disable_jit():
            assert got == float(jdp.v_from_gram(gram, jrep))
        _rel_close(got, jax.jit(jdp.v_from_gram)(gram, jrep), 1e-6)


def test_dp_state_carries_bf16_bit_for_bit():
    jcfg = _dp_cfg(jdp, "exact", "bf16", True, "incremental", 0)
    js = jdp.init_guard_state(jcfg, jnp.zeros((D_DIM,)))
    g, x_k, x1, _ = next(_stream(seed=0, report_p=None))
    js, _, _ = jax.jit(jdp.guard_step, static_argnums=0)(
        jcfg, js, jnp.asarray(g), jnp.asarray(x_k), jnp.asarray(x1))
    ts = convert.dp_guard_state_from_numpy(np.asarray(js.A), np.asarray(js.B),
                                           np.asarray(js.alive), int(js.k),
                                           np.asarray(js.v_est), np.asarray(js.gram_B), "cpu")
    assert ts.B.dtype == torch.bfloat16 and ts.k == 1
    np.testing.assert_array_equal(convert.dp_guard_state_to_numpy(ts)["B"], _f32(js.B))
    leaves = convert.dp_guard_state_from_numpy(np.asarray(js.A), [np.asarray(js.B)] * 2,
                                               np.asarray(js.alive), 1, np.asarray(js.v_est),
                                               np.asarray(js.gram_B), "cpu")
    assert [b.dtype for b in leaves.B] == [torch.bfloat16] * 2


def _assert_runs_agree(got, want, tol):
    np.testing.assert_array_equal(got.n_alive.numpy(), np.asarray(want.n_alive))
    np.testing.assert_array_equal(got.final_alive.numpy(), np.asarray(want.final_alive))
    np.testing.assert_array_equal(got.byz_mask.numpy(), np.asarray(want.byz_mask))
    assert bool(got.ever_filtered_good) == bool(want.ever_filtered_good)
    _rel_close(got.x_avg.numpy(), want.x_avg, tol)
    _rel_close(got.x_final.numpy(), want.x_final, tol)
    _rel_close(got.gaps.numpy(), want.gaps, tol)


@pytest.mark.parametrize("backend", ["dp_exact", "dp_sketch"])
@pytest.mark.parametrize("sd", ["f32", "bf16"])
@pytest.mark.parametrize("sanitize", ["off", "quarantine"])
def test_run_sgd_matches_jax(backend, sd, sanitize):
    kw = dict(m=8, T=40, eta=0.05, alpha=0.25, attack="sign_flip", aggregator="byzantine_sgd",
              guard_backend=backend, stats_dtype=sd, sanitize=sanitize)
    want = jax_run_sgd(jax_problem(d=257, seed=0), JaxConfig(**kw), jax.random.PRNGKey(0))
    got = run_sgd(make_generated_problem(d=257, seed=0, device="cpu"), SolverConfig(**kw),
                  prng.PRNGKey(0), device="cpu")
    _assert_runs_agree(got, want, TOL[sd])
    assert int(got.n_alive[0]) == 6 and not bool(got.ever_filtered_good)


@pytest.mark.parametrize("seed", [1, 2])
def test_sketch_at_real_compression_takes_the_reference_decisions(seed):
    """sketch_dim 8 < d 16, the reference's failing convergence pin: the
    port takes the reference's decisions, whatever they are.  Seed 1 keeps
    the 12 honest workers; seed 2 filters the whole fleet in both."""
    kw = dict(m=16, T=100, eta=0.05, alpha=0.25, attack="sign_flip",
              aggregator="byzantine_sgd", guard_backend="dp_sketch",
              guard_opts=(("sketch_dim", 8),))
    want = jax_run_sgd(jax_problem(d=16, seed=seed), JaxConfig(**kw), jax.random.PRNGKey(2))
    got = run_sgd(make_generated_problem(d=16, seed=seed, device="cpu"), SolverConfig(**kw),
                  prng.PRNGKey(2), device="cpu")
    _assert_runs_agree(got, want, 1e-5)
    assert int(got.n_alive[-1]) == (12 if seed == 1 else 0)


def test_dp_exact_without_auto_v_matches_the_dense_oracle():
    kw = dict(m=8, T=70, eta=0.05, alpha=0.25, attack="sign_flip", aggregator="byzantine_sgd")
    problem = make_generated_problem(d=257, seed=3, device="cpu")
    dense = run_sgd(problem, SolverConfig(**kw, guard_backend="dense"), prng.PRNGKey(3),
                    device="cpu")
    dp = run_sgd(problem, SolverConfig(**kw, guard_backend="dp_exact",
                                       guard_opts=(("auto_v", False),)),
                 prng.PRNGKey(3), device="cpu")
    np.testing.assert_array_equal(dp.n_alive.numpy(), dense.n_alive.numpy())
    np.testing.assert_array_equal(dp.final_alive.numpy(), dense.final_alive.numpy())
    for f in ("x_avg", "gaps"):
        np.testing.assert_allclose(getattr(dp, f).numpy(), getattr(dense, f).numpy(),
                                   rtol=1e-4, atol=1e-6)


def _flat(d):
    zero_j, zero_t = jnp.zeros((d,)), torch.zeros(d)
    return (JaxProblem(d=d, f=lambda x: 0.0, grad=lambda x: zero_j,
                       stoch_grad=lambda k, x: zero_j, x1=zero_j, x_star=zero_j, D=10.0, V=1.0),
            Problem(d=d, f=lambda x: 0.0, grad=lambda x: zero_t,
                    stoch_grad=lambda k, x: zero_t, x1=zero_t, x_star=zero_t, D=10.0, V=1.0))


@pytest.mark.parametrize("backend", ["dp_exact", "dp_sketch"])
@pytest.mark.parametrize("sd", ["f32", "bf16"])
def test_quarantine_poisoned_rows_match_jax(backend, sd):
    """A NaN row, then an Inf row and a single NaN entry, then clean steps:
    the poisoned rows die for good, ξ stays finite, decisions are JAX's."""
    d = 64
    kw = dict(m=M, T=4, eta=0.1, alpha=0.25, aggregator="byzantine_sgd", attack="none",
              guard_backend=backend, stats_dtype=sd, sanitize="quarantine",
              guard_opts=(("sketch_dim", 32),))
    jprob, tprob = _flat(d)
    js, jstep = jax_make_aggregator(jprob, JaxConfig(**kw))
    ts, tstep = make_aggregator(tprob, SolverConfig(**kw), "cpu")
    rng = np.random.default_rng(5)
    batches = [(0.1 + 0.05 * rng.normal(size=(M, d))).astype(np.float32) for _ in range(4)]
    batches[0][2] = np.nan
    batches[1][6] = np.inf
    batches[1][4, 3] = np.nan
    jz, tz = jnp.zeros((d,)), torch.zeros(d)
    for g in batches:
        js, jxi, jn, ja = jstep(js, jnp.asarray(g), jz, jz)
        ts, txi, tn, ta = tstep(ts, torch.from_numpy(g), tz, tz)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        assert int(tn) == int(jn)
        assert txi.dtype == torch.float32 and np.isfinite(txi.numpy()).all()
        _rel_close(txi.numpy(), jxi, TOL[sd])
    assert ta.tolist() == [True, True, False, True, False, True, False, True]


def test_guard_opts_are_checked_against_every_backend():
    """One guard_opts tuple serves a sweep over every backend: a knob some
    backend declares is dropped by the others, a knob none declares raises."""
    _, tprob = _flat(16)
    cfg = SolverConfig(m=M, T=10, eta=0.1,
                       guard_opts=(("d_block", 256), ("sketch_dim", 8), ("auto_v", False),
                                   ("gram_resync_every", 2)))
    for name in ("dense", "fused", "dp_exact", "dp_sketch"):
        state0, step = make_guard_backend(name, tprob, cfg, "cpu")
        _, xi, n_alive, alive = step(state0, torch.full((M, 16), 0.1), tprob.x1, tprob.x1)
        assert xi.shape == (16,) and xi.dtype == torch.float32 and int(n_alive) == M, name
    sketch0, _ = make_guard_backend("dp_sketch", tprob, cfg, "cpu")
    assert sketch0.B.shape == (M, 8)
    with pytest.raises(KeyError, match="unknown guard_opts"):
        make_guard_backend("dense", tprob, cfg._replace(guard_opts=(("sketchdim", 8),)), "cpu")
