"""The convex harness's building blocks in the port against the JAX package
on the same inputs: ``prng.normal`` and ``bernoulli`` (one key and a batch
of keys), ``random_gaussian``, ``mirror`` and the ``phase_switch`` /
``coalition`` combinators, the scenario adversary's id 2, and the
quadratic, least-squares and logistic problems.

Tolerances:

* ``bernoulli``, the uniforms and every key are bit-equal.
* ``normal`` is √2·erf_inv(u) with XLA's polynomial and its fused
  multiply-adds; ``torch.log1p`` and ``torch.sqrt`` stand in for XLA's
  own, which differ from them by an ulp on some inputs.  Over 2¹⁶ draws
  at most 2 % of the draws differ, each by at most 5e-7 absolute (measured:
  0.94 % of 2²⁰ draws, 4.8e-7 at most, all |z| < 6).
* ``random_gaussian`` rows are ``100·normal``: within 100× that, 5e-5;
  every other row bit-equal.
* The factories' numpy-built arrays (H, A, b, y, x*) and scalars (D, V, L,
  σ) are bit-equal; the logistic x* (2000 gradient steps of each
  package's own gradient) within 1e-5; f and ∇f within 1e-6 relative; each
  sampler's (m, d) batch within 1e-6 of the reference's ``vmap`` over the
  same worker keys (the sphere noise normalises by a norm and takes
  u^{1/d}, both summed or rounded by another library).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attacks as jattacks
from repro.core import solver as jsolver
from repro.data import problems as jproblems
from repro.scenarios import adversary as jadv
from repro.scenarios import spec as jspec
from repro_torch import convert, prng
from repro_torch.core import attacks
from repro_torch.core.solver import SolverConfig, run_sgd
from repro_torch.data import problems
from repro_torch.scenarios import adversary, spec

M, D = 16, 12
NORMAL_ATOL = 5e-7
NORMAL_SHARE = 0.02
GAUSS_ATOL = 100 * NORMAL_ATOL
# a row of 100·N(0, 1) over D coordinates reaches past this; no other row does
NOISY = 50.0


def _tkey(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _closure(fn, name):
    """The reference problem's array ``name`` from its closure."""
    return np.asarray(fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents)


def _assert_normal_close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= NORMAL_ATOL
    assert np.mean(got != want) <= NORMAL_SHARE


# ---------------------------------------------------------------- prng

@pytest.mark.parametrize("seed", [0, 7])
def test_normal_matches_jax(seed):
    n = 1 << 16
    got = prng.normal(prng.PRNGKey(seed), (n,))
    _assert_normal_close(got, jax.random.normal(jax.random.PRNGKey(seed), (n,)))
    # the uniform under it is jax's bit for bit
    lo = np.nextafter(np.float32(-1), np.float32(0))
    np.testing.assert_array_equal(
        prng.uniform(prng.PRNGKey(seed), (n,), float(lo), 1.0).numpy(),
        np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n,), jnp.float32, lo, 1.0)))


def test_erf_inv_is_xla_polynomial_where_log1p_agrees():
    """Where torch's and XLA's log1p agree (w < 5), the port's erf_inv is
    XLA's bit for bit: the Horner steps round as fused multiply-adds."""
    x = np.linspace(-0.9, 0.9, 4097, dtype=np.float32)
    w_t = -torch.log1p(-(torch.from_numpy(x) ** 2)).numpy()
    w_j = -np.asarray(jax.jit(jnp.log1p)(-(x * x)))
    same = w_t == w_j
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    assert same.mean() > 0.5
    np.testing.assert_array_equal(got[same], want[same])
    assert np.isposinf(prng.erf_inv(torch.tensor([1.0])).item())


@pytest.mark.parametrize("shape", [(), (3,), (4, 5)])
def test_normal_batched_matches_vmap(shape):
    jkeys = jax.random.split(jax.random.PRNGKey(3), 6)
    got = prng.normal(_tkey(jkeys), shape)
    _assert_normal_close(got, jax.vmap(lambda k: jax.random.normal(k, shape))(jkeys))
    assert got.shape == (6, *shape)
    # one draw per key: row i is the single-key draw of key i
    for i in range(6):
        assert torch.equal(got[i], prng.normal(_tkey(jkeys[i]), shape))


@pytest.mark.parametrize("p", [0.5, 0.3, 0.97])
@pytest.mark.parametrize("shape", [(), (257,)])
def test_bernoulli_matches_jax(p, shape):
    key = jax.random.PRNGKey(11)
    np.testing.assert_array_equal(prng.bernoulli(prng.PRNGKey(11), p, shape).numpy(),
                                  np.asarray(jax.random.bernoulli(key, p, shape)))
    jkeys = jax.random.split(key, 9)
    np.testing.assert_array_equal(
        prng.bernoulli(_tkey(jkeys), p, shape).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, p, shape))(jkeys)))


def test_batched_split_uniform_randint_match_vmap():
    jkeys = jax.random.split(jax.random.PRNGKey(5), 7)
    tkeys = _tkey(jkeys)
    np.testing.assert_array_equal(prng.split(tkeys, 3).numpy(),
                                  np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(jkeys)))
    np.testing.assert_array_equal(prng.uniform(tkeys, (2, 3)).numpy(),
                                  np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (2, 3)))(
                                      jkeys)))
    np.testing.assert_array_equal(prng.randint(tkeys, (), 0, 513).numpy(),
                                  np.asarray(jax.vmap(lambda k: jax.random.randint(
                                      k, (), 0, 513))(jkeys)))


def test_normal_refuses_other_dtypes():
    """float32 and, since the frontends' frames need it, bfloat16 are drawn
    (bf16 held to jax's in ``tests/test_torch_encdec.py``); any other dtype
    is refused."""
    with pytest.raises(ValueError, match="float32"):
        prng.normal(prng.PRNGKey(0), (3,), torch.float16)
    assert prng.normal(prng.PRNGKey(0), (3,), torch.bfloat16).dtype == torch.bfloat16


# ---------------------------------------------------------------- attacks

def _inputs(seed=0, step=3):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(M, D)).astype(np.float32)
    mask = np.zeros(M, bool)
    mask[rng.permutation(M)[:5]] = True
    tg = rng.normal(size=D).astype(np.float32)
    mirror = rng.normal(size=(M, D)).astype(np.float32)
    jctx = {"true_grad": jnp.asarray(tg), "V": 1.5, "step": jnp.int32(step),
            "mirror_grads": jnp.asarray(mirror)}
    tctx = {"true_grad": torch.from_numpy(tg), "V": 1.5, "step": step,
            "mirror_grads": torch.from_numpy(mirror)}
    return (jnp.asarray(g), jnp.asarray(mask), jctx), (torch.from_numpy(g),
                                                       torch.from_numpy(mask), tctx)


def _assert_rows(got, want, noisy_rows):
    """Rows in ``noisy_rows`` (a (m,) bool) within GAUSS_ATOL, the rest
    bit-equal."""
    got, want = _np(got), _np(want)
    np.testing.assert_array_equal(got[~noisy_rows], want[~noisy_rows])
    np.testing.assert_allclose(got[noisy_rows], want[noisy_rows], rtol=0, atol=GAUSS_ATOL)
    assert np.abs(got[noisy_rows]).max() > NOISY  # the noise is there


@pytest.mark.parametrize("seed", [0, 1])
def test_random_gaussian_matches_jax(seed):
    (jg, jm, jctx), (tg, tm, tctx) = _inputs(seed)
    jkey = jax.random.PRNGKey(seed + 40)
    want = jattacks.attack_random_gaussian(jkey, jg, jm, jctx)
    got = attacks.attack_random_gaussian(_tkey(jkey), tg, tm, tctx)
    _assert_rows(got, want, _np(tm))
    scaled = attacks.attack_random_gaussian(_tkey(jkey), tg, tm, tctx, scale=torch.tensor(7.0))
    want = jattacks.attack_random_gaussian(jkey, jg, jm, jctx, scale=jnp.float32(7.0))
    np.testing.assert_allclose(_np(scaled), _np(want), rtol=0, atol=7 * NORMAL_ATOL)


def test_mirror_matches_jax():
    (jg, jm, jctx), (tg, tm, tctx) = _inputs(2)
    np.testing.assert_array_equal(
        _np(attacks.attack_mirror(None, tg, tm, tctx)),
        _np(jattacks.attack_mirror(jax.random.PRNGKey(0), jg, jm, jctx)))
    assert set(attacks.ATTACKS) == set(jattacks.ATTACKS)


COMBOS = {
    "switch_gauss_late": lambda lib: lib.phase_switch(lib.attack_sign_flip,
                                                      lib.attack_random_gaussian, 3),
    "switch_gauss_early": lambda lib: lib.phase_switch(lib.attack_random_gaussian,
                                                       lib.attack_constant_drift, 4),
    "coalition_gauss_flip": lambda lib: lib.coalition(lib.attack_random_gaussian,
                                                      lib.attack_sign_flip, 0.5),
    "coalition_flip_gauss": lambda lib: lib.coalition(lib.attack_sign_flip,
                                                      lib.attack_random_gaussian, 0.3),
    "coalition_keyfree": lambda lib: lib.coalition(lib.attack_hidden_shift,
                                                   lib.attack_sign_flip, 0.6),
}


@pytest.mark.parametrize("step", [2, 3, 4])
@pytest.mark.parametrize("name", list(COMBOS))
def test_combinators_match_jax(name, step):
    """Each combinator draws ka, kb = split(key): a random_gaussian phase
    is the reference's draw in either slot, before and after the switch."""
    (jg, jm, jctx), (tg, tm, tctx) = _inputs(3, step=step)
    jkey = jax.random.PRNGKey(9)
    want = COMBOS[name](jattacks)(jkey, jg, jm, jctx)
    got = COMBOS[name](attacks)(_tkey(jkey), tg, tm, tctx)
    noisy = np.abs(_np(want)).max(axis=1) > NOISY
    if noisy.any():
        _assert_rows(got, want, noisy)
    else:
        np.testing.assert_array_equal(_np(got), _np(want))


def test_phase_switch_takes_a_tensor_switch_step():
    (_, _, _), (tg, tm, tctx) = _inputs(4, step=5)
    fn = attacks.phase_switch(attacks.attack_none, attacks.attack_sign_flip,
                              torch.tensor(5))
    assert torch.equal(fn(prng.PRNGKey(0), tg, tm, {**tctx, "step": torch.tensor(5)}),
                       attacks.attack_sign_flip(None, tg, tm, tctx))


# ---------------------------------------------------------------- adversary id 2

SCENARIOS = {
    "static": lambda s: s.scenario_static("random_gaussian"),
    "scaled": lambda s: s.scenario_static("random_gaussian", attack_scale=0.25),
    "lie_low_then_strike": lambda s: s.scenario_lie_low_then_strike("random_gaussian", 4),
    "coalition_a": lambda s: s.scenario_coalition("random_gaussian", "sign_flip", 0.5),
    "coalition_b": lambda s: s.scenario_coalition("alie", "random_gaussian", 0.5),
    "adaptive": lambda s: s.scenario_adaptive("random_gaussian", 0.5),
}


def _pair(jscn, alpha=0.25):
    tscn = convert.scenario_from_numpy(*map(np.asarray, jscn))
    return (jadv.ScenarioAdversary(jscn, jnp.asarray(alpha, jnp.float32)),
            adversary.ScenarioAdversary(tscn, alpha))


@pytest.fixture(scope="module")
def jax_id2_rows():
    """The JAX adversary's rows for every scenario of SCENARIOS at steps 3
    and 4, from one jitted vmap over the stacked scenarios."""
    (jg, jm, jctx), _ = _inputs(5)
    jctx = {**jctx, "alive": jnp.ones(M, bool), "n_alive": jnp.int32(M),
            "prev_xi": jnp.zeros(D)}
    scns = [make(jspec) for make in SCENARIOS.values()]
    stacked = jax.tree.map(lambda *leaves: jnp.stack(leaves), *scns)

    @jax.jit
    def rows(step):
        def one(scn):
            jad = jadv.ScenarioAdversary(scn, jnp.asarray(0.25, jnp.float32))
            return jad.attack(jax.random.PRNGKey(21), jg, jm, {**jctx, "step": step},
                              jad.init_state(M, D))
        return jax.vmap(one)(stacked)

    return {step: dict(zip(SCENARIOS, np.asarray(rows(jnp.int32(step))))) for step in (3, 4)}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_adversary_id2_matches_jax(name, jax_id2_rows):
    """Both phases draw from ka, kb = split(key), before and after the
    switch step: random_gaussian rows within 5e-5 (times the scenario's
    scale), the rest within 1e-6 (ALIE's honest moments are sums)."""
    jscn = SCENARIOS[name](jspec)
    _, tad = _pair(jscn)
    for step in (3, 4):
        _, (tg, tm, tctx) = _inputs(5, step=step)
        tctx = {**tctx, "alive": torch.ones(M, dtype=torch.bool), "n_alive": torch.tensor(M),
                "prev_xi": torch.zeros(D)}
        want = jax_id2_rows[step][name]
        got = _np(tad.attack(prng.PRNGKey(21), tg, tm, tctx, tad.init_state(M, D, device="cpu")))
        scale = float(jscn.attack_scale)
        noisy = np.abs(want).max(axis=1) > NOISY * scale
        assert noisy.any() == (name != "lie_low_then_strike" or step >= 4)
        np.testing.assert_allclose(got[~noisy], want[~noisy], rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[noisy], want[noisy], rtol=0, atol=GAUSS_ATOL * scale)


def test_adversary_id2_refuses_generation():
    """``generate="kernel"`` with id 2 raises the reference's ValueError."""
    kw = dict(m=M, T=2, eta=0.05, alpha=0.25, generate="kernel", guard_backend="fused")
    jad, tad = _pair(jspec.scenario_static("random_gaussian"))
    with pytest.raises(ValueError) as want:
        jsolver.run_sgd(jproblems.make_generated_problem(d=D, seed=0), jsolver.SolverConfig(**kw),
                        jax.random.PRNGKey(0), adversary=jad)
    with pytest.raises(ValueError, match=r"attack ids \[2, 2\] are not in-kernel") as got:
        run_sgd(problems.make_generated_problem(d=D, seed=0, device="cpu"), SolverConfig(**kw),
                prng.PRNGKey(0), adversary=tad, device="cpu")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- problems

def _factories():
    """name -> (factory, the arrays as (reference's closure name, port's))."""
    return {
        "quadratic": (lambda lib, **k: lib.make_quadratic_problem(
            d=16, sigma=1.0, L=8.0, V=1.0, seed=1, **k), (("H", "H"), ("x_star", "x_star"))),
        "least_squares": (lambda lib, **k: lib.make_least_squares_problem(
            d=16, n_data=128, seed=3, **k), (("A_j", "A"), ("b_j", "b"))),
        "logistic": (lambda lib, **k: lib.make_logistic_problem(
            d=10, n_data=256, reg=1e-2, seed=2, **k), (("A_j", "A"), ("y_j", "y"))),
    }


@pytest.fixture(scope="module")
def problem_pairs():
    return {name: (make(jproblems), make(problems, device="cpu"), arrays)
            for name, (make, arrays) in _factories().items()}


@pytest.mark.parametrize("name", ["quadratic", "least_squares", "logistic"])
def test_factories_match_jax(problem_pairs, name):
    jp, tp, arrays = problem_pairs[name]
    for ref_name, port_name in arrays:
        np.testing.assert_array_equal(_closure(tp.f, port_name), _closure(jp.f, ref_name),
                                      err_msg=ref_name)
    for field in ("d", "D", "V", "L", "sigma"):
        assert getattr(tp, field) == pytest.approx(getattr(jp, field), rel=1e-6), field
    if name == "logistic":
        np.testing.assert_allclose(_np(tp.x_star), np.asarray(jp.x_star), rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(_np(tp.x_star), np.asarray(jp.x_star))
        for field in ("D", "V", "L", "sigma"):
            assert getattr(tp, field) == getattr(jp, field), field
    np.testing.assert_array_equal(_np(tp.x1), np.asarray(jp.x1))
    x = np.random.default_rng(0).normal(size=tp.d).astype(np.float32)
    np.testing.assert_allclose(float(tp.f(torch.from_numpy(x))), float(jp.f(jnp.asarray(x))),
                               rtol=1e-6)
    want = np.asarray(jp.grad(jnp.asarray(x)))
    np.testing.assert_allclose(_np(tp.grad(torch.from_numpy(x))), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("name", ["quadratic", "least_squares", "logistic"])
def test_samplers_match_jax_vmap(problem_pairs, name):
    jp, tp, _ = problem_pairs[name]
    x = np.random.default_rng(1).normal(size=tp.d).astype(np.float32)
    jkeys = jax.random.split(jax.random.PRNGKey(8), M)
    want = np.asarray(jax.jit(jax.vmap(lambda k: jp.stoch_grad(k, jnp.asarray(x))))(jkeys))
    got = _np(tp.stoch_grad(_tkey(jkeys), torch.from_numpy(x)))
    assert got.shape == (M, tp.d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["quadratic", "least_squares", "logistic"])
def test_convert_carries_the_reference_problem(problem_pairs, name):
    jp, _, arrays = problem_pairs[name]
    a = {ref_name: _closure(jp.f, ref_name) for ref_name, _ in arrays}
    scal = dict(x1=np.asarray(jp.x1), D=jp.D, V=jp.V, L=jp.L, device="cpu")
    if name == "quadratic":
        tp = convert.quadratic_problem_from_numpy(a["H"], np.asarray(jp.x_star),
                                                  sigma=jp.sigma, **scal)
    elif name == "least_squares":
        tp = convert.least_squares_problem_from_numpy(a["A_j"], a["b_j"],
                                                      np.asarray(jp.x_star),
                                                      sigma=jp.sigma, **scal)
    else:
        tp = convert.logistic_problem_from_numpy(a["A_j"], a["y_j"], jp.sigma,
                                                 np.asarray(jp.x_star), **scal)
    np.testing.assert_array_equal(_np(tp.x_star), np.asarray(jp.x_star))
    assert (tp.D, tp.V, tp.L, tp.sigma) == (jp.D, jp.V, jp.L, jp.sigma)
    x = torch.zeros(tp.d)
    np.testing.assert_allclose(float(tp.f(tp.x_star)), float(jp.f(jp.x_star)), rtol=1e-6,
                               atol=1e-7)
    assert float(tp.f(x)) > float(tp.f(tp.x_star))


def test_factories_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device resolves")
    for make in (problems.make_quadratic_problem, problems.make_least_squares_problem,
                 problems.make_logistic_problem):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(d=4)
