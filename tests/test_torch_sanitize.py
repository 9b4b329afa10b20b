"""The port's sanitize stage (``sanitize="quarantine"``, DESIGN.md §15)
against the JAX package's, on the same numpy-made inputs.

* the plain sanitizing versions against the Pallas kernels in interpret
  mode: ``nf`` exact, ``B_new`` bit-equal, the rest within
  ``tests/test_fused_guard.py``'s 1e-5 (f32) / 1e-2 (bf16);
* the report-aware filter (``masked_median``, ``counting_median_index``,
  ``filter_update``): equal decisions, and an all-true mask bit-equal to
  the path without one;
* the quarantine contract of ``tests/test_faults.py`` for every baseline
  and both guard backends: alive and ``n_alive`` equal to JAX's, ξ within
  1e-5 relative;
* ``run_sgd`` with sanitize on: decisions equal to JAX's, ``x_avg`` within
  1e-5, and bit-equal to the port's own sanitize-off run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import byzantine_sgd as jbs
from repro.core.aggregators import aggregator_names
from repro.core.solver import Problem as JaxProblem
from repro.core.solver import SolverConfig as JaxConfig
from repro.core.solver import make_aggregator as jax_make_aggregator
from repro.core.solver import run_sgd as jax_run_sgd
from repro.data.problems import make_generated_problem as jax_generated_problem
from repro.kernels.fused_guard import fused_guard_pallas
from repro.kernels.robust_reduce import filtered_mean_pallas
from repro.scenarios import faults as jfaults
from repro_torch import prng
from repro_torch.core import byzantine_sgd as tbs
from repro_torch.core.solver import Problem, SolverConfig, make_aggregator, run_sgd
from repro_torch.data.problems import make_generated_problem
from repro_torch.kernels import ops, ref
from repro_torch.scenarios import faults

TOL = {"f32": 1e-5, "bf16": 1e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
M, D = 8, 12


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    assert err <= tol * np.linalg.norm(want) + tol, (err, np.linalg.norm(want))


def _poisoned(m, d, seed):
    """Normal entries, a whole NaN row, a ±Inf row, a single NaN in the
    last column and a single -Inf."""
    g = np.random.default_rng(seed).normal(size=(m, d)).astype(np.float32)
    g[1] = np.nan
    g[m // 2] = np.where(np.arange(d) % 2 == 0, np.inf, -np.inf)
    g[m - 1, d - 1] = np.nan
    g[0, 3] = -np.inf
    return g


def _both(x, dt):
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


# ------------------------------------------------------------- kernels

@pytest.mark.parametrize("m,d", [(8, 300), (17, 555)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fused_guard_sanitize_ref_matches_pallas(m, d, dt):
    rng = np.random.default_rng(m + d)
    jg, tg = _both(_poisoned(m, d, m), dt)
    jB, tB = _both((3 * rng.normal(size=(m, d))).astype(np.float32), dt)
    jd, td = _both(rng.normal(size=d).astype(np.float32), dt)
    want = fused_guard_pallas(jg, jB, jd, d_block=128, interpret=True, sanitize=True)
    got = ref.fused_guard_sanitize_ref(tg, tB, td)
    assert got[4].dtype == torch.int32
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(got[3].to(torch.float32).numpy(),
                                  np.asarray(want[3].astype(jnp.float32)))
    for a, b in zip(got[:3], want[:3]):
        assert np.isfinite(a.numpy()).all()
        _rel_close(a.numpy(), b, TOL[dt])
    # ops sends a CPU tensor to the plain version
    for a, b in zip(ops.fused_guard(tg, tB, td, sanitize=True), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_filtered_mean_sanitize_ref_matches_pallas(dt):
    m, d = 9, 1000
    jx, tx = _both(_poisoned(m, d, 3), dt)
    mask = np.array([1, 0, 1, 1, 0, 1, 1, 1, 1], np.float32)
    want = filtered_mean_pallas(jx, jnp.asarray(mask), 7.0, d_block=256, interpret=True,
                                sanitize=True)
    got = ref.filtered_mean_sanitize_ref(tx, torch.from_numpy(mask), 7.0)
    assert np.isfinite(got.numpy()).all()
    _rel_close(got.numpy(), want, TOL[dt])
    assert torch.equal(ops.filtered_mean(tx, torch.from_numpy(mask), 7.0, sanitize=True), got)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_sanitize_refs_on_clean_input_equal_the_plain_refs(dt):
    rng = np.random.default_rng(7)
    _, g = _both(rng.normal(size=(6, 70)).astype(np.float32), dt)
    _, B = _both(rng.normal(size=(6, 70)).astype(np.float32), dt)
    san, plain = ref.fused_guard_sanitize_ref(g, B, g[0]), ref.fused_guard_ref(g, B, g[0])
    assert int(san[4].abs().sum()) == 0
    for a, b in zip(san[:4], plain):
        assert torch.equal(a, b)
    w = torch.ones(6)
    assert torch.equal(ref.filtered_mean_sanitize_ref(g, w, 6.0),
                       ref.filtered_mean_ref(g, w, 6.0))


# ------------------------------------------------------------- filter

@pytest.mark.parametrize("n", [1, 2, 7, 8])
def test_masked_median_matches_jax(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=n).astype(np.float32)
    for trial in range(6):
        mask = rng.random(n) < 0.6
        got = tbs.masked_median(torch.from_numpy(x), torch.from_numpy(mask))
        want = jbs.masked_median(jnp.asarray(x), jnp.asarray(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    everyone = torch.ones(n, dtype=torch.bool)
    got = tbs.masked_median(torch.from_numpy(x), everyone)
    assert got.numpy().tobytes() == tbs.scalar_median(torch.from_numpy(x)).numpy().tobytes()
    assert float(got) == float(jnp.median(x))


def test_counting_median_index_with_report_matches_jax():
    rng = np.random.default_rng(11)
    for trial in range(10):
        m = 5 if trial % 2 else 8
        pts = rng.integers(0, 3, size=(m, 2)).astype(np.float32)   # many ties
        gram = pts @ pts.T
        report = rng.random(m) < 0.7
        if trial == 0:
            report[:] = False   # nobody reports: the fallback medoid over nobody
        jd2 = jbs.pairwise_sq_dists_from_gram(jnp.asarray(gram))
        td2 = tbs.pairwise_sq_dists_from_gram(torch.from_numpy(gram))
        for radius in (0.5, 1.0, 2.0, np.float32(1.5)):
            ji, jf = jbs.counting_median_index(jd2, radius, jnp.asarray(report))
            ti, tf = tbs.counting_median_index(td2, radius, torch.from_numpy(report))
            assert (int(ti), bool(tf)) == (int(ji), bool(jf))
            everyone = torch.ones(m, dtype=torch.bool)
            assert [int(v) for v in tbs.counting_median_index(td2, radius, everyone)] == [
                int(v) for v in tbs.counting_median_index(td2, radius)]


def test_counting_median_index_takes_the_first_nan_as_jax():
    """Finite garbage overflows a Gram to ±Inf and its distances to NaN;
    both argmins then take the first NaN score."""
    inf = np.inf
    gram = np.array([[inf, inf, 0], [inf, inf, 0], [0, 0, 1.0]], np.float32)
    jd2 = jbs.pairwise_sq_dists_from_gram(jnp.asarray(gram))
    td2 = tbs.pairwise_sq_dists_from_gram(torch.from_numpy(gram))
    np.testing.assert_array_equal(td2.numpy(), np.asarray(jd2))
    assert np.isnan(td2.numpy()).any()
    for report in (None, np.array([True, True, True]), np.array([False, True, True])):
        ji, jf = jbs.counting_median_index(jd2, 1.0, None if report is None
                                           else jnp.asarray(report))
        ti, tf = tbs.counting_median_index(td2, 1.0, None if report is None
                                           else torch.from_numpy(report))
        assert (int(ti), bool(tf)) == (int(ji), bool(jf))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_filter_update_with_report_matches_jax(seed):
    rng = np.random.default_rng(seed)
    m, d = 8, 40
    g = rng.normal(size=(m, d)).astype(np.float32) / np.sqrt(d)
    B = (g * 5 + rng.normal(size=(m, d)) / np.sqrt(d)).astype(np.float32)
    B[seed % m] += 3.0
    A = rng.normal(size=m).astype(np.float32)
    A[(seed + 3) % m] += 40.0
    alive = rng.random(m) < 0.9
    report = rng.random(m) < 0.75
    cfg = dict(m=m, T=100, V=1.0, D=5.0)
    gram_B, gram_g = (B @ B.T).astype(np.float32), (g @ g.T).astype(np.float32)
    jc, tc = jbs.GuardConfig(**cfg), tbs.GuardConfig(**cfg)
    for rep in (report, np.ones(m, bool)):
        jgood, jdiag = jbs.filter_update(jnp.asarray(A), jnp.asarray(gram_B),
                                         jnp.asarray(gram_g), jnp.asarray(alive),
                                         jnp.asarray(5, jnp.int32), jc, jnp.asarray(rep))
        tgood, tdiag = tbs.filter_update(torch.from_numpy(A), torch.from_numpy(gram_B),
                                         torch.from_numpy(gram_g), torch.from_numpy(alive),
                                         5, tc, torch.from_numpy(rep))
        np.testing.assert_array_equal(tgood.numpy(), np.asarray(jgood))
        assert int(tdiag["n_alive"]) == int(jdiag["n_alive"])
    plain, _ = tbs.filter_update(torch.from_numpy(A), torch.from_numpy(gram_B),
                                 torch.from_numpy(gram_g), torch.from_numpy(alive), 5, tc)
    assert torch.equal(tgood, plain)


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_guard_step_with_report_matches_jax(fused):
    """Non-reporting rows are zeroed on entry and keep their status; the
    medians run over reporters, with and without sanitize."""
    m, d = 8, 60
    rng = np.random.default_rng(21)
    cfg = dict(m=m, T=10, V=1.0, D=5.0)
    for sanitize in (False, True):
        jg = jbs.ByzantineGuard(jbs.GuardConfig(**cfg), use_fused=fused, d_block=128,
                                sanitize=sanitize)
        tg = tbs.ByzantineGuard(tbs.GuardConfig(**cfg), use_fused=fused, sanitize=sanitize,
                                device="cpu")
        js, ts = jg.init(d), tg.init(d)
        x1 = np.zeros(d, np.float32)
        for k in range(4):
            g = (0.1 + rng.normal(size=(m, d)) / np.sqrt(d)).astype(np.float32)
            g[3] += 2.0          # caught while it reports
            g[6, 5] = np.nan     # poisoned, but only reported at odd steps
            report = np.ones(m, bool)
            report[[3, 6]] = k % 2 == 1
            x = (x1 + 0.01 * k).astype(np.float32)
            js, jxi, jdiag = jg.step(js, jnp.asarray(g), jnp.asarray(x), jnp.asarray(x1),
                                     jnp.asarray(report))
            ts, txi, tdiag = tg.step(ts, torch.from_numpy(g), torch.from_numpy(x),
                                     torch.from_numpy(x1), torch.from_numpy(report))
            np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
            assert int(tdiag["n_alive"]) == int(jdiag["n_alive"])
            np.testing.assert_array_equal(np.isfinite(txi.numpy()), np.isfinite(np.asarray(jxi)))
            if sanitize:
                _rel_close(txi.numpy(), jxi, 1e-5)
        if sanitize:
            assert ts.alive.tolist() == [True, True, True, False, True, True, False, True]


# ------------------------------------------------------------- the quarantine contract

def _jax_problem(d=D):
    zero = jnp.zeros((d,))
    return JaxProblem(d=d, f=lambda x: 0.0, grad=lambda x: zero,
                      stoch_grad=lambda k, x: zero, x1=zero, x_star=zero, D=10.0, V=1.0)


def _problem(d=D):
    zero = torch.zeros(d)
    return Problem(d=d, f=lambda x: 0.0, grad=lambda x: zero,
                   stoch_grad=lambda k, x: zero, x1=zero, x_star=zero, D=10.0, V=1.0)


def _nan_row_batch(poison=2, seed=0):
    g = (0.1 + 0.05 * np.random.default_rng(seed).normal(size=(M, D))).astype(np.float32)
    g[poison] = np.nan
    return g


def _steps_agree(kw, batches):
    """Drive JAX's and the port's make_aggregator step over ``batches``;
    alive and n_alive equal and ξ within 1e-5 at every step.  Returns the
    port's last (ξ, n_alive, alive)."""
    js, jstep = jax_make_aggregator(_jax_problem(), JaxConfig(**kw))
    ts, tstep = make_aggregator(_problem(), SolverConfig(**kw), "cpu")
    jz, tz = jnp.zeros((D,)), torch.zeros(D)
    for g in batches:
        js, jxi, jn, ja = jstep(js, jnp.asarray(g), jz, jz)
        ts, txi, tn, ta = tstep(ts, torch.from_numpy(g), tz, tz)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        assert int(tn) == int(jn)
        assert np.isfinite(txi.numpy()).all()
        _rel_close(txi.numpy(), jxi, 1e-5)
    return txi, int(tn), ta.numpy()


@pytest.mark.parametrize("name", list(aggregator_names()) + ["bucket2:krum"])
def test_quarantine_baselines_match_jax(name):
    kw = dict(m=M, T=1, eta=0.1, alpha=0.25, aggregator=name, attack="none",
              sanitize="quarantine")
    _, n_alive, alive = _steps_agree(kw, [_nan_row_batch()])
    assert not alive[2] and n_alive == M - 1


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_quarantine_guard_backends_match_jax(backend):
    kw = dict(m=M, T=1, eta=0.1, alpha=0.25, aggregator="byzantine_sgd", attack="none",
              guard_backend=backend, sanitize="quarantine")
    _, n_alive, alive = _steps_agree(kw, [_nan_row_batch()])
    assert not alive[2] and n_alive == M - 1


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_quarantine_guard_kill_is_permanent(backend):
    kw = dict(m=M, T=4, eta=0.1, alpha=0.25, aggregator="byzantine_sgd", attack="none",
              guard_backend=backend, sanitize="quarantine")
    clean = (0.1 + 0.05 * np.random.default_rng(1).normal(size=(M, D))).astype(np.float32)
    _, n_alive, alive = _steps_agree(kw, [_nan_row_batch(), clean, clean])
    assert not alive[2] and n_alive == M - 1


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_quarantine_inf_row_and_partial_nan(backend):
    kw = dict(m=M, T=1, eta=0.1, alpha=0.25, aggregator="byzantine_sgd", attack="none",
              guard_backend=backend, sanitize="quarantine")
    g = np.full((M, D), 0.1, np.float32)
    g[1] = np.inf
    g[5, 7] = -np.inf
    g[6, 0] = np.nan
    _, n_alive, alive = _steps_agree(kw, [g])
    assert not alive[1] and not alive[5] and not alive[6] and n_alive == M - 3


@pytest.mark.parametrize("backend,sd", [("dense", "f32"), ("fused", "f32"), ("fused", "bf16")])
def test_quarantine_garbage_batch_decisions_match_jax(backend, sd):
    """Finite garbage (1e30 on every 4th coordinate of 2 rows) passes the
    sanitizer; the guard's decisions on it must still be JAX's."""
    m, d = 8, 64
    kw = dict(m=m, T=4, eta=0.1, alpha=0.25, aggregator="byzantine_sgd", attack="none",
              guard_backend=backend, stats_dtype=sd, sanitize="quarantine")
    jp, tp = jfaults.fault_garbage(0.25), faults.fault_garbage(0.25)
    rank = np.arange(m)
    js, jstep = jax_make_aggregator(_jax_problem(d), JaxConfig(**kw))
    ts, tstep = make_aggregator(_problem(d), SolverConfig(**kw), "cpu")
    jz, tz = jnp.zeros((d,)), torch.zeros(d)
    for k in range(3):
        g = (0.1 + 0.05 * np.random.default_rng(k).normal(size=(m, d))).astype(np.float32)
        jg = jfaults.apply_fault_plan(jp, jax.random.PRNGKey(k), jnp.asarray(g),
                                      jnp.asarray(rank), jnp.int32(k))
        tg = faults.apply_fault_plan(tp, prng.PRNGKey(k), torch.from_numpy(g),
                                     torch.from_numpy(rank), k)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        js, jxi, jn, ja = jstep(js, jg, jz, jz)
        ts, txi, tn, ta = tstep(ts, tg, tz, tz)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        assert int(tn) == int(jn)
        np.testing.assert_array_equal(np.isfinite(txi.numpy()), np.isfinite(np.asarray(jxi)))


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
@pytest.mark.parametrize("sd", ["f32", "bf16"])
def test_guard_diag_counts_nonfinite_rows_as_jax(fused, sd):
    """``n_nonfinite`` counts rows non-finite after the stats-dtype
    rounding: 3.4e38 is finite in f32 and rounds to Inf in bf16."""
    g = _poisoned(M, D, 5)
    g[3, 2] = 3.4e38
    cfg = dict(m=M, T=10, V=1.0, D=5.0)
    jg = jbs.ByzantineGuard(jbs.GuardConfig(**cfg), use_fused=fused, d_block=128,
                            stats_dtype=sd, sanitize=True)
    tg = tbs.ByzantineGuard(tbs.GuardConfig(**cfg), use_fused=fused, stats_dtype=sd,
                            sanitize=True, device="cpu")
    z = np.zeros(D, np.float32)
    js, jxi, jdiag = jg.step(jg.init(D), jnp.asarray(g), jnp.asarray(z), jnp.asarray(z))
    ts, txi, tdiag = tg.step(tg.init(D), torch.from_numpy(g), torch.from_numpy(z),
                             torch.from_numpy(z))
    assert int(tdiag["n_nonfinite"]) == int(jdiag["n_nonfinite"]) == (4 if sd == "f32" else 5)
    assert int(tdiag["n_alive"]) == int(jdiag["n_alive"])
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    assert np.isfinite(ts.B.to(torch.float32).numpy()).all()
    _rel_close(txi.numpy(), jxi, TOL[sd])


def test_bad_sanitize_value_raises():
    cfg = SolverConfig(m=M, T=1, eta=0.1, alpha=0.25, aggregator="mean", attack="none",
                       sanitize="drop")
    with pytest.raises(ValueError, match="sanitize"):
        make_aggregator(_problem(), cfg, "cpu")


# ------------------------------------------------------------- run_sgd

@pytest.mark.parametrize("backend,sd", [("dense", "f32"), ("fused", "f32"), ("fused", "bf16")])
def test_run_sgd_quarantine_matches_jax_and_sanitize_off(backend, sd):
    kw = dict(m=8, T=20, eta=0.05, alpha=0.25, attack="sign_flip",
              aggregator="byzantine_sgd", guard_backend=backend, stats_dtype=sd,
              sanitize="quarantine")
    want = jax_run_sgd(jax_generated_problem(d=257, seed=0), JaxConfig(**kw),
                       jax.random.PRNGKey(0))
    problem = make_generated_problem(d=257, seed=0, device="cpu")
    got = run_sgd(problem, SolverConfig(**kw), prng.PRNGKey(0), device="cpu")
    np.testing.assert_array_equal(got.n_alive.numpy(), np.asarray(want.n_alive))
    np.testing.assert_array_equal(got.final_alive.numpy(), np.asarray(want.final_alive))
    _rel_close(got.x_avg.numpy(), want.x_avg, 1e-5)
    off = run_sgd(problem, SolverConfig(**{**kw, "sanitize": "off"}), prng.PRNGKey(0),
                  device="cpu")
    for field in ("n_alive", "final_alive", "x_avg", "x_final", "gaps"):
        assert torch.equal(getattr(got, field), getattr(off, field)), field
    assert int(got.n_alive[-1]) == 6
