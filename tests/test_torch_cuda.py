"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports neither JAX nor the JAX
package, so it also runs on a GPU machine without them; from the repo
root there (``--noconftest`` skips ``tests/conftest.py``, which imports
JAX):

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

Tolerance: ‖got − want‖ ≤ tol·‖want‖ + tol, tol = 1e-5 (f32) / 1e-4
(bf16).  Kernel and plain version upcast bf16 to f32 exactly and sum in
f32; only the order of the sums differs, so the bf16 limit sits about
10× above the largest such error read on an H100 (8.1e-6 relative, gram_g
at m=32, d=2^26+3) and well below what a sum rounded to bf16 would give.
``B_new`` is bit-equal, and so is the coordinate median: it selects one
value or averages two, with no sum whose order could differ.  The
sanitizing variants' ``nf`` counts are equal exactly, and on finite input
their shared outputs equal the plain kernels' bit for bit.  The
CountSketch's signs are bit-equal to ``ref.sketch_sign``, and its sums are
held to the same tolerance.
"""
import pytest
import torch

from repro_torch import prng
from repro_torch.core import byzantine_sgd as tbs
from repro_torch.core.solver import SolverConfig, run_sgd
from repro_torch.data.problems import make_generated_problem
from repro_torch.kernels import ops, ref
from repro_torch.kernels.countsketch import countsketch_cuda
from repro_torch.kernels.fused_guard import fused_guard_cuda
from repro_torch.kernels.pairdist import gram_cuda
from repro_torch.kernels.robust_reduce import (
    coordinate_median_cuda,
    filtered_mean_cuda,
    trimmed_mean_cuda,
)

DTYPES = {"f32": (torch.float32, 1e-5), "bf16": (torch.bfloat16, 1e-4)}


def _within(got, want, tol):
    err = (got.double() - want.double()).norm()
    assert err <= tol * want.double().norm() + tol, (float(err), float(want.double().norm()))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(1, 1), (17, 555), (32, 2048), (33, 1000), (128, 4099)])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_cuda_kernels_match_plain(cuda_device, m, d, dt):
    tdt, tol = DTYPES[dt]
    gen = torch.Generator(device=cuda_device).manual_seed(m * 1000 + d)
    g = torch.randn(m, d, device=cuda_device, generator=gen).to(tdt)
    B = (3 * torch.randn(m, d, device=cuda_device, generator=gen)).to(tdt)
    dlt = torch.randn(d, device=cuda_device, generator=gen).to(tdt)
    w = (torch.rand(m, device=cuda_device, generator=gen) > 0.3).float()
    got, want = fused_guard_cuda(g, B, dlt), ref.fused_guard_ref(g, B, dlt)
    assert torch.equal(got[3], want[3])
    for a, b in zip(got[:3], want[:3]):
        _within(a, b, tol)
    _within(filtered_mean_cuda(g, w, 3.0), ref.filtered_mean_ref(g, w, 3.0), tol)


@pytest.mark.cuda
def test_ops_on_cuda_launch_the_kernels(cuda_device):
    g = torch.randn(8, 300, device=cuda_device)
    before = (fused_guard_cuda.launches, filtered_mean_cuda.launches)
    assert ops.runs_kernel(g)
    ops.fused_guard(g, g, g[0])
    ops.filtered_mean(g, torch.ones(8, device=cuda_device), 8.0)
    assert (fused_guard_cuda.launches, filtered_mean_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(TypeError):
        ops.fused_guard(g.double(), g.double(), g[0].double())
    with pytest.raises(ValueError, match="m <= 128"):
        ops.fused_guard(torch.zeros(129, 4, device=cuda_device),
                        torch.zeros(129, 4, device=cuda_device),
                        torch.zeros(4, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(1, 1), (2, 9), (16, 4099), (17, 555), (32, 2048),
                                 (33, 1000), (128, 257)])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gram_and_order_statistics_match_plain(cuda_device, m, d, dt):
    tdt, tol = DTYPES[dt]
    gen = torch.Generator(device=cuda_device).manual_seed(m * 31 + d)
    x = torch.randn(m, d, device=cuda_device, generator=gen).to(tdt)
    _within(gram_cuda(x), ref.gram_ref(x), tol)
    if m > 32:   # beyond the sort kernels' register budget: they refuse
        with pytest.raises(ValueError, match="m <= 32"):
            coordinate_median_cuda(x)
        return
    assert torch.equal(coordinate_median_cuda(x), ref.coordinate_median_ref(x))
    for n_trim in {0, (m - 1) // 2, min(8, (m - 1) // 2)}:
        _within(trimmed_mean_cuda(x, n_trim), ref.trimmed_mean_ref(x, n_trim), tol)


@pytest.mark.cuda
def test_order_statistics_spread_nan_and_refuse_over_trim(cuda_device):
    x = torch.randn(9, 300, device=cuda_device)
    x[4, 7] = float("nan")
    for got, want in ((coordinate_median_cuda(x), ref.coordinate_median_ref(x)),
                      (trimmed_mean_cuda(x, 3), ref.trimmed_mean_ref(x, 3))):
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert bool(torch.isnan(got[7])) and int(torch.isnan(got).sum()) == 1
    with pytest.raises(ValueError, match="trims everything"):
        trimmed_mean_cuda(x, 5)


@pytest.mark.cuda
def test_ops_on_cuda_launch_the_order_kernels(cuda_device):
    x = torch.randn(8, 300, device=cuda_device)
    before = (gram_cuda.launches, coordinate_median_cuda.launches, trimmed_mean_cuda.launches)
    ops.gram(x)
    ops.coordinate_median(x)
    ops.trimmed_mean(x, 2)
    assert (gram_cuda.launches, coordinate_median_cuda.launches,
            trimmed_mean_cuda.launches) == tuple(b + 1 for b in before)
    with pytest.raises(TypeError):
        ops.gram(x.double())


def poison(x: torch.Tensor) -> torch.Tensor:
    """A copy of x with a whole NaN row, a row of ±Inf by column parity,
    a single NaN in the last column (the masked tail when d % 64 != 0)
    and a single -Inf."""
    m, d = x.shape
    x = x.clone()
    x[0] = float("nan")
    sign = torch.where(torch.arange(d, device=x.device) % 2 == 0, 1.0, -1.0)
    x[m // 2] = (sign * float("inf")).to(x.dtype)
    x[m - 1, d - 1] = float("nan")
    x[min(1, m - 1), 0] = float("-inf")
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(1, 1), (17, 555), (32, 2048), (33, 1000), (128, 4099)])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_sanitizing_kernels_match_plain(cuda_device, m, d, dt):
    tdt, tol = DTYPES[dt]
    gen = torch.Generator(device=cuda_device).manual_seed(m * 977 + d)
    clean = torch.randn(m, d, device=cuda_device, generator=gen).to(tdt)
    B = (3 * torch.randn(m, d, device=cuda_device, generator=gen)).to(tdt)
    dlt = torch.randn(d, device=cuda_device, generator=gen).to(tdt)
    w = (torch.rand(m, device=cuda_device, generator=gen) > 0.3).float()
    g = poison(clean)
    got = fused_guard_cuda(g, B, dlt, sanitize=True)
    want = ref.fused_guard_sanitize_ref(g, B, dlt)
    assert got[4].dtype == torch.int32 and torch.equal(got[4], want[4])
    assert torch.equal(got[3], want[3])
    for a, b in zip(got[:3], want[:3]):
        assert bool(torch.isfinite(a).all())
        _within(a, b, tol)
    xi = filtered_mean_cuda(g, w, 3.0, sanitize=True)
    assert bool(torch.isfinite(xi).all())
    _within(xi, ref.filtered_mean_sanitize_ref(g, w, 3.0), tol)
    # on finite input the sanitizing variants are the plain kernels, bit for bit
    san, plain = fused_guard_cuda(clean, B, dlt, sanitize=True), fused_guard_cuda(clean, B, dlt)
    assert int(san[4].abs().sum()) == 0
    for a, b in zip(san[:4], plain):
        assert torch.equal(a, b)
    assert torch.equal(filtered_mean_cuda(clean, w, 3.0, sanitize=True),
                       filtered_mean_cuda(clean, w, 3.0))


@pytest.mark.cuda
def test_ops_sanitize_launch_the_sanitizing_kernels(cuda_device):
    g = poison(torch.randn(8, 300, device=cuda_device))
    plain = (fused_guard_cuda.launches, filtered_mean_cuda.launches)
    san = (fused_guard_cuda.launches_sanitize, filtered_mean_cuda.launches_sanitize)
    out = ops.fused_guard(g, torch.zeros_like(g), torch.zeros_like(g[0]), sanitize=True)
    xi = ops.filtered_mean(g, torch.ones(8, device=cuda_device), 8.0, sanitize=True)
    assert len(out) == 5 and bool(torch.isfinite(xi).all())
    assert (fused_guard_cuda.launches, filtered_mean_cuda.launches) == plain
    assert (fused_guard_cuda.launches_sanitize, filtered_mean_cuda.launches_sanitize) == (
        san[0] + 1, san[1] + 1)


@pytest.mark.cuda
def test_argmin_takes_the_first_nan_on_the_card(cuda_device):
    """``jnp.argmin`` returns the first NaN; the counting median's argmins
    rely on torch doing the same on the card (finite garbage overflows
    the Grams to Inf, and their distances to NaN)."""
    nan, inf = float("nan"), float("inf")
    for row, first_nan in (([3.0, nan, 1.0, nan], 1), ([inf, 2.0, nan, 0.5], 2),
                           ([nan, nan, nan, nan], 0)):
        t = torch.tensor(row)
        assert int(torch.argmin(t.to(cuda_device))) == int(torch.argmin(t)) == first_nan
    rows = torch.ones(4, 40)
    rows[2, 5], rows[3, 1], rows[3, 7] = nan, nan, nan
    assert torch.argmin(rows.to(cuda_device), dim=1).tolist() == [0, 0, 5, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("sd", ["f32", "bf16"])
def test_quarantine_guard_on_the_card_matches_the_cpu(cuda_device, sd):
    """Both guard forms on the card, fed a poisoned batch, count the same
    non-finite rows, drop them and keep ξ finite, as on the CPU."""
    gen = torch.Generator().manual_seed(11)
    g = poison((0.1 + 0.05 * torch.randn(16, 700, generator=gen)))
    z = torch.zeros(700)
    results = []
    for fused in (False, True):
        for dev in ("cpu", cuda_device):
            guard = tbs.ByzantineGuard(tbs.GuardConfig(m=16, T=10, V=1.0, D=5.0),
                                       use_fused=fused, stats_dtype=sd, sanitize=True,
                                       device=dev)
            state, xi, diag = guard.step(guard.init(700), g.to(dev), z.to(dev), z.to(dev))
            assert bool(torch.isfinite(xi).all())
            results.append((int(diag["n_nonfinite"]), int(diag["n_alive"]),
                            state.alive.cpu().tolist(), xi.cpu()))
    for r in results[1:]:
        assert r[:3] == results[0][:3]
        _within(r[3], results[0][3], DTYPES[sd][1])
    assert results[0][0] == 4 and results[0][1] == 12


# chip_smoke.py's shapes: the main path's, k not dividing d, k > d, a small
# strided fold, and m·d > 2^31
SKETCH_SHAPES = [(32, 2 ** 20, 4096), (17, 555, 8), (16, 16, 4096), (8, 4099, 64),
                 (32, 2 ** 26 + 3, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,k", SKETCH_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("salt", [0, 7])
def test_countsketch_matches_plain(cuda_device, m, d, k, dt, salt):
    tdt, tol = DTYPES[dt]
    gen = torch.Generator(device=cuda_device).manual_seed(m * 31 + d + k)
    x = torch.randn(m, d, device=cuda_device, generator=gen).to(tdt)
    got = countsketch_cuda(x, k, salt)
    torch.cuda.synchronize()
    assert got.shape == (m, k) and got.dtype == torch.float32
    _within(got, ref.countsketch_ref(x, k, salt), tol)
    assert torch.equal(got, countsketch_cuda(x, k, salt))   # fixed-order sums


@pytest.mark.cuda
@pytest.mark.parametrize("salt", [0, 7])
def test_countsketch_signs_are_bit_equal(cuda_device, salt):
    n = 2 ** 20 + 3
    signs = countsketch_cuda(torch.ones(1, n, device=cuda_device), n, salt)[0]
    assert torch.equal(signs, ref.sketch_sign(n, salt, cuda_device))


@pytest.mark.cuda
def test_ops_countsketch_on_cuda_launches_the_kernel(cuda_device):
    x = torch.randn(8, 300, device=cuda_device)
    before = countsketch_cuda.launches
    ops.countsketch(x, 64, 1)
    assert countsketch_cuda.launches == before + 1
    with pytest.raises(TypeError):
        ops.countsketch(x.double(), 64)
    with pytest.raises(ValueError, match="k >= 1"):
        ops.countsketch(x, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["dp_exact", "dp_sketch"])
def test_dp_run_on_the_card_matches_the_cpu(cuda_device, backend):
    kw = dict(m=8, T=70, eta=0.05, alpha=0.25, attack="sign_flip",
              aggregator="byzantine_sgd", guard_backend=backend)
    before = countsketch_cuda.launches
    got = run_sgd(make_generated_problem(d=4099, seed=1, device=cuda_device),
                  SolverConfig(**kw), prng.PRNGKey(1), device=cuda_device)
    assert countsketch_cuda.launches - before == (70 if backend == "dp_sketch" else 0)
    want = run_sgd(make_generated_problem(d=4099, seed=1, device="cpu"), SolverConfig(**kw),
                   prng.PRNGKey(1), device="cpu")
    assert torch.equal(got.n_alive.cpu(), want.n_alive)
    assert torch.equal(got.final_alive.cpu(), want.final_alive)
    _within(got.x_avg.cpu(), want.x_avg, 1e-5)
