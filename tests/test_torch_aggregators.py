"""The port's baseline aggregators, ALIE and order-statistic kernels'
plain versions against the JAX package, on the same numpy inputs made from
a seed.

Tolerances: ‖got − want‖ ≤ tol·‖want‖ + tol.  The coordinate median and
trimmed mean select and average the same values (1e-6).  Krum, multi-Krum
and the medoid must pick the same rows: the inputs are a tight honest
cluster and far outliers, so their scores are well separated (the
reference's own tie-break pins fail, so no test here is held to ties).
The Weiszfeld-based rules and centered clipping iterate in f32 with sums
taken in another order (1e-5).  The plain kernel versions are held to the
Pallas kernels in interpret mode at the JAX suite's own tolerances
(``tests/test_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.core import attacks as jattacks
from repro.kernels.pairdist import gram_pallas
from repro.kernels.robust_reduce import coordinate_median_pallas, trimmed_mean_pallas
from repro_torch import prng
from repro_torch.core import aggregators as agg
from repro_torch.core import attacks
from repro_torch.kernels import ops, ref
from repro_torch.kernels.pairdist import gram_cuda
from repro_torch.kernels.robust_reduce import coordinate_median_cuda, trimmed_mean_cuda


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    assert err <= tol * np.linalg.norm(want) + tol, (err, np.linalg.norm(want))


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _clustered(m=10, d=64, n_out=3, seed=0):
    """A tight honest cluster and ``n_out`` far outliers in the first rows."""
    x = 0.1 * _normal((m, d), seed) + 1.0
    x[:n_out] += 50.0 + _normal((n_out, d), seed + 1)
    return x


def _to_torch(a):
    """A jax/numpy array as a torch tensor of the same dtype (bf16 bit for bit)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


# ------------------------------------------------------------ order statistics

@pytest.mark.parametrize("m,d", [(1, 7), (8, 33), (10, 64), (17, 555), (16, 300)])
def test_coordinate_median_matches_jax(m, d):
    x = _normal((m, d), m + d)
    want = jagg.aggregate_coordinate_median(jnp.asarray(x))
    got = agg.aggregate_coordinate_median(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (d,)
    _rel_close(got.numpy(), want, 1e-6)


@pytest.mark.parametrize("m,tf", [(10, 0.3), (10, 0.1), (8, 0.25), (17, 0.2), (9, 0.0)])
def test_trimmed_mean_matches_jax(m, tf):
    # 0.3 at m = 10 is the integral count that floors one short without the
    # 1e-9 epsilon (0.3 * 10 = 2.999...)
    x = _normal((m, 40), m)
    want = jagg.aggregate_trimmed_mean(jnp.asarray(x), trim_fraction=tf)
    got = agg.aggregate_trimmed_mean(torch.from_numpy(x), trim_fraction=tf)
    _rel_close(got.numpy(), want, 1e-6)


def test_trimmed_mean_counts_like_jax_and_refuses_over_trim():
    x = torch.from_numpy(_normal((10, 5), 3))
    s = torch.sort(x, dim=0).values
    torch.testing.assert_close(agg.aggregate_trimmed_mean(x, 0.3), s[3:7].mean(0))
    for tf in (0.5, 0.6):
        with pytest.raises(ValueError, match="trims everything"):
            jagg.aggregate_trimmed_mean(jnp.asarray(x.numpy()), trim_fraction=tf)
        with pytest.raises(ValueError, match="trims everything"):
            agg.aggregate_trimmed_mean(x, trim_fraction=tf)


def test_order_statistics_turn_nan_columns_to_nan():
    x = _normal((8, 6), 4)
    x[3, 1] = np.nan
    x[0, 4] = np.nan
    want_med = coordinate_median_pallas(jnp.asarray(x), d_block=128, interpret=True)
    want_tm = trimmed_mean_pallas(jnp.asarray(x), 2, d_block=128, interpret=True)
    got_med = ref.coordinate_median_ref(torch.from_numpy(x))
    got_tm = ref.trimmed_mean_ref(torch.from_numpy(x), 2)
    for got, want in ((got_med, want_med), (got_tm, want_tm)):
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))
        assert np.isnan(got.numpy()).tolist() == [False, True, False, False, True, False]


# ------------------------------------------------------------ Krum and medoid

@pytest.mark.parametrize("name,f", [("krum", 3), ("krum", 1), ("multi_krum", 3), ("medoid", None)])
def test_distance_rules_pick_the_same_rows(name, f):
    x = _clustered()
    kw = {} if f is None else {"n_byzantine": f}
    want = np.asarray(jagg.get_aggregator(name, **kw)(jnp.asarray(x)))
    got = agg.get_aggregator(name, **kw)(torch.from_numpy(x)).numpy()
    if name == "multi_krum":
        _rel_close(got, want, 1e-6)
    else:
        np.testing.assert_array_equal(got, want)   # one row, selected
    assert np.abs(got - 1.0).max() < 1.0           # an honest row or mean of them


def test_multi_krum_takes_the_first_of_tied_scores():
    # rows 1..4 are equal: their scores tie, and the lower indices win
    x = np.zeros((6, 3), np.float32)
    x[0] = 9.0
    x[5] = -9.0
    x[1:5] = 0.5
    got = agg.aggregate_krum(torch.from_numpy(x), n_byzantine=1, multi_k=2)
    np.testing.assert_array_equal(got.numpy(), np.full(3, 0.5, np.float32))
    first = agg.aggregate_krum(torch.from_numpy(x), n_byzantine=1)
    np.testing.assert_array_equal(first.numpy(), x[1])


# ------------------------------------------------------------ Weiszfeld family

@pytest.mark.parametrize("name", ["geometric_median", "autogm", "mean"])
def test_weiszfeld_rules_match_jax(name):
    x = _clustered(m=12, d=48, n_out=4, seed=5)
    want = jagg.get_aggregator(name)(jnp.asarray(x))
    got = agg.get_aggregator(name)(torch.from_numpy(x))
    _rel_close(got.numpy(), want, 1e-5)


def test_weiszfeld_update_weighted_and_degenerate():
    g = _normal((7, 20), 6)
    y = _normal((20,), 7)
    a = np.abs(_normal((7,), 8))
    for alphas in (None, a, np.zeros(7, np.float32)):
        want = jagg.weiszfeld_update(jnp.asarray(y), jnp.asarray(g),
                                     None if alphas is None else jnp.asarray(alphas))
        got = agg.weiszfeld_update(torch.from_numpy(y), torch.from_numpy(g),
                                   None if alphas is None else torch.from_numpy(alphas))
        _rel_close(got.numpy(), want, 1e-5)
    # all rows equal: the smoothed weights keep the iterate finite
    same = np.ones((5, 4), np.float32)
    out = agg.aggregate_geometric_median(torch.from_numpy(same))
    np.testing.assert_allclose(out.numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simplex_project_matches_jax(seed):
    y = 3.0 * _normal((9,), 20 + seed)
    if seed == 2:
        y[:4] = 0.25   # ties
    want = jagg.simplex_project(jnp.asarray(y))
    got = agg.simplex_project(torch.from_numpy(y))
    _rel_close(got.numpy(), want, 1e-6)
    assert abs(float(got.sum()) - 1.0) < 1e-5 and float(got.min()) >= 0.0


def test_centered_clip_matches_jax_over_steps():
    d = 30
    j0, jstep = jagg.make_centered_clip(d, clip_tau=1.0, clip_iters=5)
    t0, tstep = agg.make_centered_clip(d, clip_tau=1.0, clip_iters=5, device="cpu")
    jv, tv = j0, t0
    for k in range(4):
        x = _clustered(m=8, d=d, n_out=2, seed=30 + k)
        jv, jxi = jstep(jv, jnp.asarray(x))
        tv, txi = tstep(tv, torch.from_numpy(x))
        _rel_close(txi.numpy(), jxi, 1e-5)
        assert torch.equal(tv, txi)


# ------------------------------------------------------------ bucketing, registry

@pytest.mark.parametrize("m,s,seed", [(8, 2, 0), (12, 3, 5), (32, 2, 1)])
def test_bucket_means_match_jax_with_the_same_key(m, s, seed):
    x = _normal((m, 11), seed)
    want = jagg.bucket_means(jnp.asarray(x), s, jax.random.PRNGKey(seed))
    got = agg.bucket_means(torch.from_numpy(x), s, prng.PRNGKey(seed))
    assert got.shape == (m // s, 11)
    _rel_close(got.numpy(), want, 1e-6)
    with pytest.raises(ValueError, match="s | m"):
        agg.bucket_means(torch.from_numpy(x[:-1]), s, prng.PRNGKey(seed))


def test_registry_mirrors_jax():
    assert agg.aggregator_names() == jagg.aggregator_names()
    assert set(agg.AGGREGATORS) == set(jagg.AGGREGATORS)
    assert set(agg.STATEFUL_AGGREGATORS) == set(jagg.STATEFUL_AGGREGATORS)
    with pytest.raises(KeyError, match="unknown aggregator"):
        agg.get_aggregator("no_such_rule")


# ------------------------------------------------------------ ALIE

@pytest.mark.parametrize("n,mb", [(8, 2), (10, 3), (32, 8), (16, 0), (20, 12), (4, 4)])
def test_alie_z_max_matches_jax(n, mb):
    want = float(jattacks.alie_z_max(n, mb))
    got = attacks.alie_z_max(n, torch.tensor(mb))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * max(1.0, abs(want))


@pytest.mark.parametrize("z", [None, 1.5])
def test_attack_alie_matches_jax(z):
    m, d = 10, 33
    g = _normal((m, d), 40)
    mask = np.zeros(m, bool)
    mask[[1, 4, 7]] = True
    kw = {} if z is None else {"z": z}
    want = jattacks.attack_alie(None, jnp.asarray(g), jnp.asarray(mask), {}, **kw)
    got = attacks.attack_alie(None, torch.from_numpy(g), torch.from_numpy(mask), {}, **kw)
    np.testing.assert_array_equal(got[~mask].numpy(), g[~mask])   # honest rows untouched
    _rel_close(got.numpy(), want, 1e-6)


# ------------------------------------------------------------ plain kernel versions

KSHAPES = [(4, 64), (17, 555), (16, 1000), (32, 2048)]
KDTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _kernel_input(m, d, dt, seed=0):
    return jnp.asarray(_normal((m, d), seed)).astype(KDTYPES[dt])


@pytest.mark.parametrize("m,d", KSHAPES)
@pytest.mark.parametrize("dt", sorted(KDTYPES))
def test_gram_ref_matches_pallas(m, d, dt):
    x = _kernel_input(m, d, dt, m + d)
    want = gram_pallas(x, d_block=512, interpret=True)
    got = ref.gram_ref(_to_torch(x))
    assert got.dtype == torch.float32 and got.shape == (m, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2 if dt == "bf16" else 2e-5,
                               atol=1e-2 if dt == "bf16" else 1e-4)


@pytest.mark.parametrize("m,d", KSHAPES)
@pytest.mark.parametrize("dt", sorted(KDTYPES))
def test_coordinate_median_ref_matches_pallas(m, d, dt):
    x = _kernel_input(m, d, dt, m * d)
    want = coordinate_median_pallas(x, d_block=512, interpret=True)
    got = ref.coordinate_median_ref(_to_torch(x))
    assert got.dtype == torch.float32 and got.shape == (d,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,d", KSHAPES)
@pytest.mark.parametrize("n_trim", [1, 2])
def test_trimmed_mean_ref_matches_pallas(m, d, n_trim):
    if 2 * n_trim >= m:
        n_trim = (m - 1) // 2
    x = _kernel_input(m, d, "f32", m + n_trim)
    want = trimmed_mean_pallas(x, n_trim, d_block=512, interpret=True)
    got = ref.trimmed_mean_ref(_to_torch(x), n_trim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [33, 48])
@pytest.mark.parametrize("dt", sorted(KDTYPES))
def test_ops_past_32_workers_match_pallas(m, dt):
    """``ops.gram``, ``ops.coordinate_median`` and ``ops.trimmed_mean`` on
    the CPU past the register sort's 32 workers (the card's kernels take
    them up to the port's worker cap), against the Pallas kernels in
    interpret mode, with ``tests/test_kernels.py``'s tolerances."""
    x = _kernel_input(m, 257, dt, 7 * m)
    xt = _to_torch(x)
    np.testing.assert_allclose(ops.gram(xt).numpy(), gram_pallas(x, d_block=512, interpret=True),
                               rtol=2e-2 if dt == "bf16" else 2e-5,
                               atol=1e-2 if dt == "bf16" else 1e-4)
    np.testing.assert_allclose(ops.coordinate_median(xt).numpy(),
                               coordinate_median_pallas(x, d_block=512, interpret=True),
                               rtol=1e-5, atol=1e-5)
    n_trim = m // 4
    np.testing.assert_allclose(ops.trimmed_mean(xt, n_trim).numpy(),
                               trimmed_mean_pallas(x, n_trim, d_block=512, interpret=True),
                               rtol=1e-5, atol=1e-5)


def test_ops_order_statistics_on_cpu_run_the_plain_versions():
    x = torch.from_numpy(_normal((9, 70), 50))
    before = (gram_cuda.launches, coordinate_median_cuda.launches, trimmed_mean_cuda.launches)
    assert torch.equal(ops.gram(x), ref.gram_ref(x))
    assert torch.equal(ops.coordinate_median(x), ref.coordinate_median_ref(x))
    assert torch.equal(ops.trimmed_mean(x, 2), ref.trimmed_mean_ref(x, 2))
    assert (gram_cuda.launches, coordinate_median_cuda.launches,
            trimmed_mean_cuda.launches) == before
    with pytest.raises(ValueError, match="trims everything"):
        ops.trimmed_mean(x, 5)


def test_order_statistic_wrappers_refuse_cpu_tensors():
    x = torch.zeros((4, 8))
    for call in (lambda: gram_cuda(x), lambda: coordinate_median_cuda(x),
                 lambda: trimmed_mean_cuda(x, 1)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
