"""Worker profiles in the port (``repro_torch.scenarios.spec.WorkerProfile``,
the adversary's per-worker schedules, ``heterogenize_problem`` /
``heterogenize_generated`` and ``run_sgd``'s heterogeneous, stale and
partial-participation axes) against the JAX package on the same inputs.

* Constructors and ``profile_knobs`` bit-equal to JAX's; ``linspace_f32``
  is ``jnp.linspace(0, s, m)`` bit for bit as XLA computes it on the CPU.
* ``heterogenize_*``: V, ``het`` and ``het_sign``/``het_dir`` bit-equal;
  ``het_grad`` rows bit-equal to the JAX sampler run op by op, within 1e-6
  of the jitted one (XLA fuses the noise's product and sum into an FMA,
  ``ROADMAP.md`` §3); a zero-skew row passes through with its −0.0.
* ``refresh_at``, ``staleness_at`` and ``report_at`` bit-equal to JAX's.
* ``run_sgd`` per profile × {dense, fused} × {f32, bf16} against JAX's
  ``run_sgd`` (generated problem, m = 16, d = 16, T = 40): decisions
  (``n_alive``, ``final_alive``, ``byz_mask``, ``ever_filtered_good``,
  ``n_reporting``) exactly, values within 1e-5 (f32) / 1e-2 (bf16)
  relative; the generating path with a skewed fleet against the
  materialising one; the degenerate profile bit-equal to no profile
  inside the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solver import SolverConfig as JaxConfig
from repro.core.solver import byz_rank as jax_byz_rank
from repro.core.solver import run_sgd as jax_run_sgd
from repro.data import problems as jproblems
from repro.scenarios import spec as jspec
from repro.scenarios.adversary import ScenarioAdversary as JaxAdversary
from repro_torch import convert, prng
from repro_torch.core.solver import SolverConfig, byz_rank, run_sgd
from repro_torch.data import problems
from repro_torch.scenarios import adversary, spec

M, D, T = 16, 16, 40
TOL = {"f32": 1e-5, "bf16": 1e-2}
SLOW = [0] * 12 + [3] * 4          # the last four workers straggle


def _bits(x) -> np.ndarray:
    a = np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.uint8)


# ---------------------------------------------------------------- constructors

CONSTRUCTORS = {
    "iid": lambda s, **k: s.profile_iid(M, **k),
    "scalars": lambda s, **k: s.worker_profile(M, skew=0.3, delay=2, p_report=0.9, **k),
    "sequences": lambda s, **k: s.worker_profile(
        M, skew=np.linspace(0, 1, M), delay=list(range(M)), p_report=np.full(M, 0.6), **k),
    "linear_skew": lambda s, **k: s.profile_linear_skew(M, 0.5, **k),
    "linear_skew_m7": lambda s, **k: s.profile_linear_skew(7, 2.7, **k),
    "partial": lambda s, **k: s.profile_partial(M, 0.75, **k),
}


def _port_profile(jprofile):
    return convert.profile_from_numpy(*map(np.asarray, jprofile), device="cpu")


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_match_jax(name):
    want = CONSTRUCTORS[name](jspec)
    got = CONSTRUCTORS[name](spec, device="cpu")
    assert isinstance(got, spec.WorkerProfile)
    for field, dt in zip(spec.WorkerProfile._fields, (torch.float32, torch.int32,
                                                       torch.float32)):
        leaf = getattr(got, field)
        assert leaf.dtype == dt and leaf.device.type == "cpu", field
        np.testing.assert_array_equal(_bits(leaf), _bits(getattr(want, field)), err_msg=field)
    assert spec.profile_knobs(got) == jspec.profile_knobs(want)


@pytest.mark.parametrize("frac", [0.0, 0.01, 0.1, 0.25, 0.5, 0.97, 1.0])
@pytest.mark.parametrize("m", [1, 7, 16, 33])
def test_straggler_count_matches_jax(frac, m):
    want = jspec.profile_stragglers(m, frac, 3)
    got = spec.profile_stragglers(m, frac, 3, device="cpu")
    np.testing.assert_array_equal(got.delay.numpy(), np.asarray(want.delay))
    n_slow = min(max(int(round(frac * m)), 1 if frac > 0 else 0), m)
    assert int((got.delay > 0).sum()) == n_slow
    assert bool((got.delay[m - n_slow:] == 3).all())


@pytest.mark.parametrize("m", [1, 2, 3, 7, 8, 16, 32, 33, 100, 1000])
@pytest.mark.parametrize("stop", [0.0, 0.3, 0.5, 1.0, 2.7])
def test_linspace_is_jax_linspace_bit_for_bit(m, stop):
    np.testing.assert_array_equal(spec.linspace_f32(stop, m).view(np.uint32),
                                  np.asarray(jnp.linspace(0.0, stop, m)).view(np.uint32))


def test_profile_knobs_of_none_and_default_device():
    assert spec.profile_knobs(None) == jspec.profile_knobs(None)
    if not torch.cuda.is_available():
        # the leaves go to the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            spec.profile_iid(M)


# ---------------------------------------------------------------- problems

def _problems(het: str, skew_max=0.5, seed=3, m=M, d=D):
    jbase = jproblems.make_generated_problem(d=d, sigma=1.0, L=8.0, V=1.0, seed=0)
    tbase = problems.make_generated_problem(d=d, sigma=1.0, L=8.0, V=1.0, seed=0,
                                            device="cpu")
    if het == "none":
        return jbase, tbase
    jfn = getattr(jproblems, f"heterogenize_{het}")
    tfn = getattr(problems, f"heterogenize_{het}")
    return jfn(jbase, m=m, skew_max=skew_max, seed=seed), tfn(tbase, m=m, skew_max=skew_max,
                                                            seed=seed)


@pytest.mark.parametrize("het", ["problem", "generated"])
@pytest.mark.parametrize("d", [16, 555])
def test_heterogenize_matches_jax(het, d):
    """V, ``het`` and the rank-1 fields bit-equal; every worker's row of
    ``het_grad`` bit-equal to JAX's op by op and within 1e-6 of its jitted
    form, at a zero, a ramped and a negative skew."""
    jp, tp = _problems(het, d=d)
    assert tp.V == jp.V and tp.het == jp.het
    if het == "generated":
        np.testing.assert_array_equal(_bits(tp.gen.het_dir), _bits(jp.gen.het_dir))
        np.testing.assert_array_equal(_bits(tp.gen.het_sign), _bits(jp.gen.het_sign))
    else:
        assert tp.gen.het_sign is None and jp.gen.het_sign is None
    rng = np.random.default_rng(d)
    x = rng.normal(size=d).astype(np.float32)
    skew = np.linspace(-0.5, 0.5, M).astype(np.float32)
    skew[3] = 0.0
    jkeys = jax.random.split(jax.random.PRNGKey(11), M)
    got = tp.het_grad(prng.split(prng.PRNGKey(11), M), torch.from_numpy(x),
                      torch.from_numpy(skew)).numpy()
    with jax.disable_jit():
        eager = np.stack([np.asarray(jp.het_grad(jkeys[w], jnp.asarray(x), jnp.float32(skew[w]),
                                                 jnp.int32(w))) for w in range(M)])
    np.testing.assert_array_equal(got.view(np.uint32), eager.view(np.uint32))
    jitted = np.asarray(jax.jit(jax.vmap(lambda k, s, w: jp.het_grad(k, jnp.asarray(x), s, w)))(
        jkeys, jnp.asarray(skew), jnp.arange(M)))
    np.testing.assert_allclose(got, jitted, rtol=0, atol=1e-6)


@pytest.mark.parametrize("het", ["problem", "generated"])
def test_zero_skew_passes_rows_through_with_their_sign(het):
    """``g + 0·C`` would turn −0.0 into +0.0: a zero-skew row comes back
    with its bits, a skewed one is ``g + skew·C``."""
    _, base = _problems("none")
    base = base._replace(stoch_grad=lambda keys, x: torch.full((M, D), -0.0))
    tp = getattr(problems, f"heterogenize_{het}")(base, m=M, skew_max=0.5, seed=3)
    keys, x = prng.split(prng.PRNGKey(0), M), torch.zeros(D)
    skew = torch.zeros(M)
    skew[5] = 0.25
    rows = tp.het_grad(keys, x, skew)
    C = tp.het_grad(keys, x, torch.ones(M))    # −0.0 + 1·C is C
    keep = torch.arange(M) != 5
    assert bool(torch.signbit(rows[keep]).all()) and bool((rows[keep] == 0).all())
    assert torch.equal(rows[5], 0.25 * C[5]) and bool((C[5] != 0).any())


def test_heterogenize_errors():
    _, tp = _problems("none")
    with pytest.raises(ValueError, match="generated problem"):
        problems.heterogenize_generated(tp._replace(gen=None), m=M, skew_max=0.5)
    with pytest.raises(ValueError, match="skew_max"):
        problems.heterogenize_generated(tp, m=M, skew_max=-0.1)
    with pytest.raises(ValueError, match="skew_max"):
        problems.heterogenize_problem(tp, m=M, skew_max=-0.1)
    with pytest.raises(ValueError, match="even m"):
        problems.heterogenize_generated(tp, m=M + 1, skew_max=0.5)


# ---------------------------------------------------------------- schedules

def _adversaries(jprofile, scenario="sign_flip"):
    jadv = JaxAdversary(jspec.scenario_static(scenario), jnp.float32(0.25), profile=jprofile)
    tadv = adversary.ScenarioAdversary(spec.scenario_static(scenario), 0.25,
                                       profile=_port_profile(jprofile))
    return jadv, tadv


@pytest.mark.parametrize("max_delay", [0, 1, 3, 5])
def test_refresh_and_staleness_match_jax(max_delay):
    jadv, tadv = _adversaries(jspec.worker_profile(M, delay=list(range(M))))
    for k in (0, 1, 2, 3, 5, 6, 11, 12, 60, 1 << 20):
        np.testing.assert_array_equal(tadv.refresh_at(k, max_delay).numpy(),
                                      np.asarray(jadv.refresh_at(jnp.int32(k), max_delay)))
        got = tadv.staleness_at(k, max_delay)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jadv.staleness_at(jnp.int32(k), max_delay)))


@pytest.mark.parametrize("p", [0.0, 0.3, 0.75, 1.0])
def test_report_at_matches_jax(p):
    jadv, tadv = _adversaries(jspec.worker_profile(M, p_report=np.linspace(0, p, M)))
    mask = np.zeros(M, bool)
    mask[[1, 4, 9]] = True
    for seed in range(6):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 7919)
        tkey = prng.fold_in(prng.PRNGKey(seed), 7919)
        got = tadv.report_at(tkey, torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jadv.report_at(jkey, jnp.asarray(mask))))
        assert bool(got[torch.from_numpy(mask)].all())


# ---------------------------------------------------------------- run_sgd

def _profile_of(name):
    """(JAX profile, heterogenized problem kind, cfg overrides, generate)."""
    skew = jspec.profile_linear_skew(M, 0.5)
    return {
        "skew_off": (skew, "generated", {}, "off"),
        "skew_kernel": (skew, "generated", {}, "kernel"),
        "skew_dense_bias": (skew, "problem", {}, "off"),
        "stragglers": (jspec.profile_stragglers(M, 0.25, 3), "none", dict(max_delay=3), "off"),
        "partial": (jspec.profile_partial(M, 0.75), "none",
                    dict(partial_participation=True), "off"),
        "all_three": (jspec.worker_profile(M, skew=skew.skew, delay=SLOW, p_report=0.75),
                      "generated", dict(max_delay=3, partial_participation=True), "off"),
    }[name]


def _cfg(backend, sd, generate="off", **over):
    return dict(m=M, T=T, eta=0.05, alpha=0.25, aggregator="byzantine_sgd",
                guard_backend=backend, stats_dtype=sd, generate=generate, **over)


def _port_run(name, backend, sd, scenario=None, seed=3):
    jprofile, het, over, generate = _profile_of(name)
    scn = scenario or (lambda s: s.scenario_static("sign_flip"))
    return run_sgd(_problems(het)[1], SolverConfig(**_cfg(backend, sd, generate, **over)),
                   prng.PRNGKey(seed), device="cpu",
                   adversary=adversary.ScenarioAdversary(scn(spec), 0.25,
                                                         profile=_port_profile(jprofile)))


def _runs(name, backend, sd, seed=3):
    """The port's run and JAX's, on the same problem, profile and key."""
    jprofile, het, over, generate = _profile_of(name)
    want = jax_run_sgd(_problems(het)[0], JaxConfig(**_cfg(backend, sd, generate, **over)),
                       jax.random.PRNGKey(seed),
                       adversary=JaxAdversary(jspec.scenario_static("sign_flip"),
                                              jnp.float32(0.25), profile=jprofile))
    return _port_run(name, backend, sd, seed=seed), want


def _assert_matches(got, want, sd):
    for f in ("n_alive", "byz_mask", "final_alive"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert bool(got.ever_filtered_good) == bool(want.ever_filtered_good)
    if want.n_reporting is None:
        assert got.n_reporting is None
    else:
        assert got.n_reporting.dtype == torch.int32
        np.testing.assert_array_equal(got.n_reporting.numpy(), np.asarray(want.n_reporting))
    for f in ("gaps", "x_final", "x_avg"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=TOL[sd], atol=1e-6, err_msg=f)


PROFILE_CASES = [(name, backend, sd)
                 for name in ("skew_off", "skew_kernel", "stragglers", "partial", "all_three")
                 for backend in ("dense", "fused") for sd in ("f32", "bf16")
                 if not (name == "skew_kernel" and backend == "dense")]


@pytest.mark.parametrize("name,backend,sd", PROFILE_CASES)
def test_run_sgd_with_profile_matches_jax(name, backend, sd):
    got, want = _runs(name, backend, sd)
    _assert_matches(got, want, sd)
    # the sign-flippers are filtered, and no honest worker is
    assert int(got.byz_mask.sum()) == 4 and not bool((got.final_alive & got.byz_mask).any())
    assert not bool(got.ever_filtered_good)


def test_dense_bias_profile_matches_jax():
    """``heterogenize_problem``'s (m, d) bias on the materialising path."""
    got, want = _runs("skew_dense_bias", "fused", "f32")
    _assert_matches(got, want, "f32")


@pytest.mark.parametrize("sd", ["f32", "bf16"])
def test_skewed_generating_path_equals_materialising_path(sd):
    """Under sign_flip no row reads a sum over rows, and ``(skew·sign)·dir``
    equals ``skew·(sign·dir)``, so the kernel path's rows are the sampled
    ones and the runs agree bit for bit."""
    kernel, off = _port_run("skew_kernel", "fused", sd), _port_run("skew_off", "fused", sd)
    for f in ("n_alive", "byz_mask", "final_alive", "gaps", "x_final", "x_avg"):
        assert torch.equal(getattr(kernel, f), getattr(off, f)), f
    # the skew moved the run: the iid fleet's gaps differ
    iid = run_sgd(_problems("generated")[1], SolverConfig(**_cfg("fused", sd)),
                  prng.PRNGKey(3), adversary=adversary.ScenarioAdversary(
                      spec.scenario_static("sign_flip"), 0.25), device="cpu")
    assert not torch.equal(iid.gaps, off.gaps)


@pytest.mark.parametrize("backend,generate", [("dense", "off"), ("fused", "off"),
                                              ("fused", "kernel")])
def test_degenerate_profile_is_no_profile_bit_for_bit(backend, generate):
    """``profile_iid`` with heterogeneity, staleness and partial
    participation armed runs bit for bit as no profile, with every worker
    reporting at every step; the fused run against JAX by decisions and
    tolerance (the reference's own byte-wise pin of this fails in the JAX
    package)."""
    over = {} if generate == "kernel" else dict(max_delay=3, partial_participation=True)
    _, tprob = _problems("generated")
    cfg = SolverConfig(**_cfg(backend, "f32", generate, **over))
    scn = spec.scenario_static("sign_flip")
    base = run_sgd(tprob, cfg, prng.PRNGKey(7), device="cpu",
                   adversary=adversary.ScenarioAdversary(scn, 0.25))
    armed = run_sgd(tprob, cfg, prng.PRNGKey(7), device="cpu",
                    adversary=adversary.ScenarioAdversary(
                        scn, 0.25, profile=spec.profile_iid(M, device="cpu")))
    for f in ("x_final", "x_avg", "gaps", "n_alive", "final_alive", "byz_mask"):
        np.testing.assert_array_equal(_bits(getattr(armed, f)), _bits(getattr(base, f)),
                                      err_msg=f)
    assert base.n_reporting is None
    if generate == "off":
        np.testing.assert_array_equal(armed.n_reporting.numpy(), np.full(T, M, np.int32))
    if backend == "fused" and generate == "off":
        jprob, _ = _problems("generated")
        want = jax_run_sgd(jprob, JaxConfig(**_cfg(backend, "f32", **over)),
                           jax.random.PRNGKey(7),
                           adversary=JaxAdversary(jspec.scenario_static("sign_flip"),
                                                  jnp.float32(0.25),
                                                  profile=jspec.profile_iid(M)))
        _assert_matches(armed, want, "f32")


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_honest_nonreporters_are_never_filtered(backend):
    """Under ``profile_partial(m, 0.0)`` only the Byzantine workers report:
    no honest worker is ever scored, so none is filtered, and every step
    counts n_byz reporters."""
    jprofile = jspec.profile_partial(M, 0.0)
    tprob = _problems("none")[1]
    res = run_sgd(tprob, SolverConfig(**_cfg(backend, "f32", partial_participation=True)),
                  prng.PRNGKey(5), device="cpu",
                  adversary=adversary.ScenarioAdversary(spec.scenario_static("sign_flip"), 0.25,
                                                        profile=_port_profile(jprofile)))
    assert bool(res.final_alive[~res.byz_mask].all())
    assert not bool(res.ever_filtered_good)
    np.testing.assert_array_equal(res.n_reporting.numpy(), np.full(T, 4, np.int32))


SCHEDULES = {"churn": lambda s: s.scenario_churn("sign_flip", period=10, stride=4),
             "late_join": lambda s: s.scenario_late_join("sign_flip", join_step=20)}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_byz_mask_is_the_schedule_union_under_partial(name):
    """Partial participation does not leak into ``byz_mask``: it equals the
    union of ``mask_at`` over the steps (the run's ranks are JAX's)."""
    got = _port_run("partial", "fused", "f32", scenario=SCHEDULES[name], seed=9)
    rank = byz_rank(prng.split(prng.PRNGKey(9))[1], M)
    np.testing.assert_array_equal(
        rank.numpy(), np.asarray(jax_byz_rank(jax.random.split(jax.random.PRNGKey(9))[1], M)))
    adv = adversary.ScenarioAdversary(SCHEDULES[name](spec), 0.25)
    oracle = torch.zeros(M, dtype=torch.bool)
    for k in range(T):
        oracle |= adv.mask_at(rank, k)
    assert torch.equal(got.byz_mask, oracle)


def test_profile_on_another_device_is_refused():
    _, tprob = _problems("none")
    meta = spec.WorkerProfile(*(leaf.to("meta") for leaf in spec.profile_iid(M, device="cpu")))
    with pytest.raises(ValueError, match="worker profile lives on"):
        run_sgd(tprob, SolverConfig(**_cfg("fused", "f32", max_delay=2)), prng.PRNGKey(0),
                adversary=adversary.ScenarioAdversary(spec.scenario_static("sign_flip"), 0.25,
                                                      profile=meta), device="cpu")
