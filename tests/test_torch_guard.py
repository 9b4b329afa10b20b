"""The port's Algorithm-1 guard against the JAX package's, step by step.

The same numpy-made gradients go through ``repro.core.byzantine_sgd`` (its
fused path runs the Pallas kernels in interpret mode) and through
``repro_torch.core.byzantine_sgd`` on the CPU (plain versions).  Filter
decisions must be equal at every step; A, the B Gram and ξ agree within
1e-5 relative (f32) or 1e-2 (bf16).  70 steps cross the step-64 resync.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import byzantine_sgd as jbs
from repro_torch import convert
from repro_torch.core import byzantine_sgd as tbs
from repro_torch.core.guard_backends import make_guard_backend
from repro_torch.core.solver import SolverConfig

M, D_DIM, STEPS = 8, 300, 70
TOL = {"f32": 1e-5, "bf16": 1e-2}


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    assert err <= tol * np.linalg.norm(want) + tol, (err, np.linalg.norm(want))


def _stream(seed=0):
    """Per-step (grads, x_k): six honest workers around a common mean and
    two that add a 3V bias along a fixed direction — inside the 4V gradient
    check, so only the B martingale catches them (near step 30)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=D_DIM)
    u /= np.linalg.norm(u)
    mu = 0.1 * rng.normal(size=D_DIM)
    x1 = np.zeros(D_DIM, np.float32)
    for k in range(STEPS):
        noise = rng.uniform(-1, 1, size=(M, D_DIM)) / np.sqrt(D_DIM)
        g = mu + noise
        g[[2, 5]] += 3.0 * u
        x_k = x1 + 0.01 * k * mu
        yield g.astype(np.float32), x_k.astype(np.float32), x1


def _cfg():
    return dict(m=M, T=100, V=1.0, D=5.0)


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
@pytest.mark.parametrize("sd", ["f32", "bf16"])
def test_guard_matches_jax_for_70_steps(fused, sd):
    jg = jbs.ByzantineGuard(jbs.GuardConfig(**_cfg()), use_fused=fused, d_block=128,
                            stats_dtype=sd)
    tg = tbs.ByzantineGuard(tbs.GuardConfig(**_cfg()), use_fused=fused, stats_dtype=sd,
                            device="cpu")
    jstep = jax.jit(jg.step)
    js, ts = jg.init(D_DIM), tg.init(D_DIM)
    alive_series = []
    for g, x_k, x1 in _stream():
        js, jxi, jdiag = jstep(js, jnp.asarray(g), jnp.asarray(x_k), jnp.asarray(x1))
        ts, txi, tdiag = tg.step(ts, torch.from_numpy(g), torch.from_numpy(x_k),
                                 torch.from_numpy(x1))
        np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
        assert int(tdiag["n_alive"]) == int(jdiag["n_alive"])
        _rel_close(txi.numpy(), jxi, TOL[sd])
        alive_series.append(int(tdiag["n_alive"]))
    _rel_close(ts.A.numpy(), js.A, TOL[sd])
    _rel_close(ts.gram_B.numpy(), js.gram_B, TOL[sd])
    assert ts.k == int(js.k) == STEPS
    assert ts.B.dtype == tbs.resolve_stats_dtype(sd)
    # the run is not degenerate: the two biased workers are caught mid-run
    assert alive_series[0] == M and alive_series[-1] == M - 2


@pytest.mark.parametrize("sd", ["f32", "bf16"])
def test_state_carried_from_jax_continues_identically(sd):
    """A JAX GuardState handed over through numpy continues in the port
    exactly as in JAX (bf16 B reinterpreted bit for bit)."""
    jg = jbs.ByzantineGuard(jbs.GuardConfig(**_cfg()), use_fused=True, d_block=128,
                            stats_dtype=sd)
    tg = tbs.ByzantineGuard(tbs.GuardConfig(**_cfg()), use_fused=True, stats_dtype=sd,
                            device="cpu")
    jstep = jax.jit(jg.step)
    js, ts = jg.init(D_DIM), None
    for k, (g, x_k, x1) in enumerate(_stream(seed=1)):
        if k == 20:
            ts = convert.guard_state_from_numpy(
                np.asarray(js.A), np.asarray(js.B), np.asarray(js.alive), int(js.k),
                np.asarray(js.gram_B), device="cpu")
            back = convert.guard_state_to_numpy(ts)
            np.testing.assert_array_equal(back["B"],
                                          np.asarray(js.B.astype(jnp.float32)))
        js, _, _ = jstep(js, jnp.asarray(g), jnp.asarray(x_k), jnp.asarray(x1))
        if ts is not None:
            ts, _, _ = tg.step(ts, torch.from_numpy(g), torch.from_numpy(x_k),
                               torch.from_numpy(x1))
            np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    _rel_close(ts.gram_B.numpy(), js.gram_B, TOL[sd])


@pytest.mark.parametrize("n", [1, 2, 7, 8])
def test_scalar_median_is_jnp_median(n):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32)
    assert float(tbs.scalar_median(torch.from_numpy(x))) == float(jnp.median(x))


def test_counting_median_index_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    for trial in range(8):
        m = 5 if trial % 2 else 8
        pts = rng.integers(0, 3, size=(m, 2)).astype(np.float32)   # many ties
        gram = pts @ pts.T
        jd2 = jbs.pairwise_sq_dists_from_gram(jnp.asarray(gram))
        td2 = tbs.pairwise_sq_dists_from_gram(torch.from_numpy(gram))
        np.testing.assert_array_equal(td2.numpy(), np.asarray(jd2))
        for radius in (0.5, 1.0, 2.0, np.float32(1.5)):
            ji, jf = jbs.counting_median_index(jd2, radius)
            ti, tf = tbs.counting_median_index(td2, radius)
            assert (int(ti), bool(tf)) == (int(ji), bool(jf))


@pytest.mark.parametrize("mode", ["anytime", "fixed"])
def test_thresholds_are_bit_equal_to_jax(mode):
    jc = jbs.GuardConfig(m=32, T=128, V=1.0, D=0.73, threshold_mode=mode)
    tc = tbs.GuardConfig(m=32, T=128, V=1.0, D=0.73, threshold_mode=mode)
    for k in (1, 2, 63, 64, 128):
        ja, jb = jc.thresholds(jnp.asarray(k, jnp.int32))
        ta, tb = tc.thresholds(k)
        assert (float(ta), float(tb)) == (float(ja), float(jb))


def test_guard_rejects_unported_options():
    cfg = tbs.GuardConfig(**_cfg())
    guard = tbs.ByzantineGuard(cfg, device="cpu")
    state = guard.init(4)
    # a guard built without a GenSpec cannot generate, as in the JAX package
    with pytest.raises(ValueError, match="GenSpec"):
        guard.gen_step(state, None, torch.zeros(4), torch.zeros(4))
    with pytest.raises(KeyError):
        tbs.resolve_stats_dtype("fp16")


class _Prob:
    d, V, D = 4, 1.0, 5.0


def test_guard_opts_validation():
    cfg = SolverConfig(m=M, T=10, eta=0.1, guard_backend="fused")
    with pytest.raises(KeyError, match="unknown guard_opts"):
        make_guard_backend("fused", _Prob, cfg._replace(guard_opts=(("d_blok", 1),)), "cpu")
    with pytest.raises(ValueError, match="gram_resync_every"):
        make_guard_backend("fused", _Prob, cfg._replace(guard_opts=(("gram_resync_every", -1),)),
                           "cpu")
    with pytest.raises(KeyError, match="unknown guard backend"):
        make_guard_backend("dp_exactly", _Prob, cfg, "cpu")
    # a knob the fused backend declares is dropped for dense
    state0, _ = make_guard_backend("dense", _Prob,
                                   cfg._replace(guard_opts=(("gram_resync_every", 8),)), "cpu")
    assert state0.B.shape == (M, 4)
