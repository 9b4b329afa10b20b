"""The port's plain generator (``gradgen.gen_worker_rows`` and the
``ref.gen_rows_ref``/``fused_guard_gen_ref``/``gen_xi_ref`` oracles, which
``ops.fused_guard_gen``/``ops.gen_xi`` run on the CPU) against the JAX
package's generating Pallas kernels in interpret mode, on the same numpy
inputs, as ``tests/test_gradgen.py`` runs them.

Inputs are built as that file's ``_gen_inputs`` builds them, once per
attack id the generator supports: a quarter of the fleet plays the id
under test (phase a), two rows play sign_flip (phase b) and the last row
is padding (slot −1).  The rows, and so ``B_new``, are bit-equal to the
JAX package's own oracle run op by op wherever no row depends on a sum
over rows (every id but ALIE's 4 and 8, whose honest moments sum in
another order).  Against the Pallas kernels, everything is within the
reference's own tolerance, ‖got − want‖ ≤ tol·‖want‖ + tol with tol =
1e-5 (f32) or 1e-2 (bf16) (``tests/test_gradgen.py``'s ``_rel_close``),
and f32 ``B_new`` within 1e-6 absolute: under ``jit`` XLA on the CPU
fuses the generator's ``t + ns·u`` into one FMA at some shapes (d = 555
here), one rounding fewer than the op-by-op expression the port follows
(``ROADMAP.md`` §3, documented differences).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.attacks import alie_z_max
from repro.data.problems import heterogenize_generated
from repro.data.problems import make_generated_problem as jax_problem
from repro.kernels import gradgen as jgradgen
from repro.kernels import ref as jref
from repro.kernels.fused_guard import fused_guard_gen_pallas, gen_xi_pallas
from repro_torch import convert, prng
from repro_torch.data.problems import make_generated_problem
from repro_torch.kernels import gradgen, ops, ref

SHAPES = [(8, 64), (16, 555), (16, 1024)]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
MOMENT_IDS = (4, 8)   # ALIE and alie_update read the honest column moments


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    assert err <= tol * np.linalg.norm(want) + tol, (err, np.linalg.norm(want))


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _inputs(m, d, aid, *, skew=False, seed=0):
    """(JAX operands, the same as CPU tensors) for the generating kernels."""
    prob = jax_problem(d=d, sigma=1.0, L=8.0, V=1.0, seed=seed)
    if skew:
        prob = heterogenize_generated(prob, m=m, skew_max=0.4, seed=seed + 1)
    g = prob.gen
    keys = jgradgen.key_bits(jax.random.split(jax.random.PRNGKey(seed + 7), m))
    x = 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 9), (d,), jnp.float32)
    n_a = max(m // 4, 1)
    slot = np.zeros(m, np.int32)
    slot[:n_a] = 1
    slot[n_a:n_a + 2] = 2
    slot[-1] = -1
    tg = jgradgen.mean_grad(g.h, x, g.x_star)
    inv_sqrt_d = 1.0 / jnp.sqrt(jnp.float32(d))
    J = jgradgen
    params = (jnp.zeros((J.GEN_NPARAMS,), jnp.float32)
              .at[J.P_ID_A].set(float(aid)).at[J.P_SF_A].set(-3.0)
              .at[J.P_Z_A].set(alie_z_max(m, n_a + 2))
              .at[J.P_CONST_A].set(10.0 * inv_sqrt_d).at[J.P_IPC_A].set(2.0)
              .at[J.P_ID_B].set(1.0).at[J.P_SF_B].set(-1.5)
              .at[J.P_TGNRM].set(jnp.maximum(jnp.linalg.norm(tg), 1e-12))
              .at[J.P_NSCALE].set(g.noise_scale))
    skewsign = (0.3 * g.het_sign if skew else jnp.zeros((m,), jnp.float32))
    jops = dict(x=x, h=g.h, x_star=g.x_star, het_dir=g.het_dir, keys=keys,
                skewsign=skewsign, slot=jnp.asarray(slot), params=params)
    tops = {k: torch.from_numpy(np.array(v, np.int64 if k == "keys" else None))
            for k, v in jops.items()}
    return jops, tops


def _gen_args(ops_: dict) -> tuple:
    return tuple(ops_[k] for k in ("x", "h", "x_star", "het_dir", "keys", "skewsign",
                                   "slot", "params"))


@pytest.mark.parametrize("aid", gradgen.GEN_SUPPORTED_IDS)
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("m,d", SHAPES)
def test_fused_guard_gen_matches_pallas(m, d, dt, aid):
    jdt, tdt, tol = DTYPES[dt]
    jops, tops = _inputs(m, d, aid)
    rng = np.random.default_rng(m * 1000 + d)
    B = (3.0 * rng.normal(size=(m, d))).astype(np.float32)
    delta = rng.normal(size=d).astype(np.float32)
    jB, jdelta = jnp.asarray(B).astype(jdt), jnp.asarray(delta).astype(jdt)
    want = fused_guard_gen_pallas(jB, jdelta, *_gen_args(jops), d_block=256, interpret=True)
    got = ops.fused_guard_gen(torch.from_numpy(B).to(tdt), torch.from_numpy(delta).to(tdt),
                              *_gen_args(tops))
    assert got[3].dtype == tdt
    for a, b in zip(got[:3], want[:3]):
        _rel_close(a.numpy(), _f32(b), tol)
    b_got = got[3].to(torch.float32).numpy()
    if dt == "f32":
        np.testing.assert_allclose(b_got, _f32(want[3]), rtol=0, atol=1e-6)
    else:
        _rel_close(b_got, _f32(want[3]), tol)
    if aid not in MOMENT_IDS:
        op_by_op = jref.fused_guard_gen_ref(jB, jdelta, *_gen_args(jops))
        np.testing.assert_array_equal(b_got, _f32(op_by_op[3]))


@pytest.mark.parametrize("aid", gradgen.GEN_SUPPORTED_IDS)
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("m,d", SHAPES[:2])
def test_gen_xi_matches_pallas(m, d, dt, aid):
    jdt, tdt, tol = DTYPES[dt]
    jops, tops = _inputs(m, d, aid)
    slot = np.asarray(jops["slot"])
    w_xi = np.where(slot == 0, 1.0 / m, 0.0).astype(np.float32)
    w_byz = (slot > 0).astype(np.float32)
    want = gen_xi_pallas(jnp.asarray(w_xi), jnp.asarray(w_byz), *_gen_args(jops), d_block=256,
                         interpret=True, stats_dtype=jnp.dtype(jdt).name)
    got = ops.gen_xi(torch.from_numpy(w_xi), torch.from_numpy(w_byz), *_gen_args(tops),
                     stats_dtype=tdt)
    for a, b in zip(got, want):
        _rel_close(a.numpy(), np.asarray(b), tol)


@pytest.mark.parametrize("aid", MOMENT_IDS)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_moments_handoff_matches_pallas(dt, aid):
    """``ops.fused_guard_gen(..., return_moments=True)`` returns ALIE's
    honest moments and changes none of its outputs; ``ops.gen_xi``
    reading them gives its own bits, and both kernels match the Pallas
    kernels (interpret)."""
    jdt, tdt, tol = DTYPES[dt]
    m, d = 16, 555
    jops, tops = _inputs(m, d, aid, skew=True)
    rng = np.random.default_rng(7)
    B = torch.from_numpy((3.0 * rng.normal(size=(m, d))).astype(np.float32)).to(tdt)
    delta = torch.from_numpy(rng.normal(size=d).astype(np.float32)).to(tdt)
    *got, mom = ops.fused_guard_gen(B, delta, *_gen_args(tops), return_moments=True)
    assert torch.equal(mom, ref.gen_moments_ref(*_gen_args(tops)))
    assert bool(torch.isfinite(mom).all()) and bool((mom[1] > 0).all())
    for a, b in zip(got, ops.fused_guard_gen(B, delta, *_gen_args(tops))):
        assert torch.equal(a, b)
    want = fused_guard_gen_pallas(jnp.asarray(B.float().numpy()).astype(jdt),
                                  jnp.asarray(delta.float().numpy()).astype(jdt),
                                  *_gen_args(jops), d_block=256, interpret=True)
    for a, b in zip(got[:3], want[:3]):
        _rel_close(a.numpy(), _f32(b), tol)
    slot = np.asarray(jops["slot"])
    w_xi = np.where(slot == 0, 1.0 / m, 0.0).astype(np.float32)
    w_byz = (slot > 0).astype(np.float32)
    args = (torch.from_numpy(w_xi), torch.from_numpy(w_byz), *_gen_args(tops))
    shared = ops.gen_xi(*args, stats_dtype=tdt, moments=mom)
    for a, b in zip(shared, ops.gen_xi(*args, stats_dtype=tdt)):
        assert torch.equal(a, b)
    want_xi = gen_xi_pallas(jnp.asarray(w_xi), jnp.asarray(w_byz), *_gen_args(jops),
                            d_block=256, interpret=True, stats_dtype=jnp.dtype(jdt).name)
    for a, b in zip(shared, want_xi):
        _rel_close(a.numpy(), np.asarray(b), tol)


@pytest.mark.parametrize("aid", (1, 4))
def test_skewed_strip_matches_pallas(aid):
    """The rank-1 skew of JAX's ``heterogenize_generated`` (het_dir, ±1
    signs): with B and δ zero, B_new is the generated batch itself."""
    m, d = 16, 512
    jops, tops = _inputs(m, d, aid, skew=True)
    assert float(np.abs(np.asarray(jops["het_dir"])).sum()) > 0
    want = fused_guard_gen_pallas(jnp.zeros((m, d)), jnp.zeros((d,)), *_gen_args(jops),
                                  d_block=128, interpret=True)
    got = ops.fused_guard_gen(torch.zeros(m, d), torch.zeros(d), *_gen_args(tops))
    for a, b in zip(got[:3], want[:3]):
        _rel_close(a.numpy(), np.asarray(b), 1e-5)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0, atol=1e-6)
    if aid not in MOMENT_IDS:
        op_by_op = jref.gen_rows_ref(*_gen_args(jops))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(op_by_op))


@pytest.mark.parametrize("aid", gradgen.GEN_SUPPORTED_IDS)
def test_gen_rows_match_the_reference_rows(aid):
    """The plain generator against the JAX package's host oracle: op by op
    bit for bit (bar ALIE's moments), and within 1e-6 of its jitted form,
    whose FMA moves 765 of these 8880 values by one ulp (element [0, 10]:
    0.058773693 jitted, 0.058773696 op by op and in the port)."""
    jops, tops = _inputs(16, 555, aid, skew=aid == 6)
    got = ref.gen_rows_ref(*_gen_args(tops)).numpy()
    assert np.all(got[-1] == 0.0)                 # the padding row
    jitted = np.asarray(jax.jit(jref.gen_rows_ref)(*_gen_args(jops)))
    np.testing.assert_allclose(got, jitted, rtol=0, atol=1e-6)
    op_by_op = np.asarray(jref.gen_rows_ref(*_gen_args(jops)))
    if aid in MOMENT_IDS:
        np.testing.assert_allclose(got, op_by_op, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, op_by_op)


def test_honest_rows_are_the_host_sampler():
    """Slot 0 everywhere: the generated rows are ``Problem.stoch_grad``'s
    batch bit for bit (the key chain's contract), and ``Problem.gen``
    carries the problem's data."""
    m, d = 16, 777
    prob = make_generated_problem(d=d, sigma=1.0, L=8.0, V=1.0, seed=3, device="cpu")
    wkeys = prng.split(prng.PRNGKey(11), m)
    x = 0.2 * torch.from_numpy(np.random.default_rng(13).normal(size=d).astype(np.float32))
    params = torch.zeros(gradgen.GEN_NPARAMS)
    params[gradgen.P_TGNRM] = 1.0
    params[gradgen.P_NSCALE] = prob.gen.noise_scale
    gen = ref.gen_rows_ref(x, prob.gen.h, prob.gen.x_star, prob.gen.het_dir, wkeys,
                           torch.zeros(m), torch.zeros(m, dtype=torch.int32), params)
    assert torch.equal(gen, prob.stoch_grad(wkeys, x))
    jp = jax_problem(d=d, sigma=1.0, L=8.0, V=1.0, seed=3)
    assert prob.gen.noise_scale == float(jp.gen.noise_scale)
    np.testing.assert_array_equal(prob.gen.h.numpy(), np.asarray(jp.gen.h))
    assert not bool(prob.gen.het_dir.any()) and prob.gen.het_sign is None
    carried = convert.problem_from_numpy(jp.gen.h, jp.x_star, jp.x1, jp.D, jp.V, jp.L,
                                         jp.sigma, jp.gen.noise_scale, device="cpu")
    assert carried.gen.noise_scale == prob.gen.noise_scale


def test_generator_constants_match_the_reference():
    assert gradgen.GEN_NPARAMS == jgradgen.GEN_NPARAMS
    assert gradgen.GEN_SUPPORTED_IDS == jgradgen.GEN_SUPPORTED_IDS
    names = [n for n in dir(jgradgen) if n.startswith("P_")]
    assert {n: getattr(gradgen, n) for n in names} == {n: getattr(jgradgen, n) for n in names}
