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
held to the same tolerance; its vector path's plan gives the same bits
with scalar loads, with 64-bit offsets and on a misaligned x.  The
generating kernels (``fused_guard_gen``, ``gen_xi``) against their plain versions run on the card: ``B_new`` is
bit-equal wherever no row depends on a sum over rows (every attack id but
ALIE's 4 and 8, whose honest moments sum in another order), the rest
within the same tolerance; and given the rows they generated, materialised,
``fused_guard.cu`` gives all four outputs bit for bit and
``filtered_mean.cu`` gives ξ bit for bit.  The three sweeps (plain,
sanitizing, generating; at bf16 one tensor-core consumer) repeat bit for
bit; the generating sweep equals the plain sweep fed the plain
generator's rows, all four outputs bit for bit, wherever no row reads a
sum over rows; and ``gen_xi`` reading the sweep's ALIE moments gives its
own bits.

Worker counts: every wrapper takes 1 ≤ m ≤ MAX_WORKERS = 12288 and raises
a ValueError naming the cap above it; the kernels are held to their plain
versions past the first version's 32 (order statistics) and 128 (the
rest) workers.  The Gram repeats bit for bit from call to call and is
exactly symmetric.

Order statistics: every m of the register path (1 to 32) at odd and even
d, f32 and bf16 (packed pairs), with one NaN in each row position in turn.
The network the kernels unroll is held to its Python mirror in
``tests/test_torch_sortnet.py``.

The run axis (a campaign group's R runs in one launch): ``fused_guard``
and ``filtered_mean`` (plain and sanitizing, f32 and bf16) and ``gram`` at
R ∈ {1, 3, 4} bit-equal to R launches alone and within the tolerances
above of their plain versions; the folded median, trimmed mean and
``countsketch`` bit-equal to per-run calls; ``fused_guard_gen`` and
``gen_xi`` over a run axis at R = 1 bit-equal to the one-run entries and
at R = 3 to three launches, ALIE's moments included, with a (d,) operand
shared by the runs or each run's own; ``ops`` under ``torch.func.vmap``
launches each kernel once (an operand the runs share is expanded, or for
the generator passed once), never reaches a plain version; a campaign's
rows on the card decide as their runs alone, its ``gen`` rows as its
``fused`` rows, and a ``bitflip`` fault axis runs in a campaign.

Checkpoints and serving: the launcher stopped and resumed on the card
equals the uninterrupted run bit for bit (a bf16 B leaf included); a
checkpoint written on the card restores on the CPU and back with the same
bits; at every published width of internlm2-1.8b and one layer, decode's
logits lie within 5e-2 of a teacher-forced forward's (bf16).
"""
import pytest
import torch

from repro_torch import prng
from repro_torch.core import byzantine_sgd as tbs
from repro_torch.core.attacks import alie_z_max
from repro_torch.core.solver import SolverConfig, run_sgd
from repro_torch.scenarios import ScenarioAdversary, scenario_static
from repro_torch.data.problems import make_generated_problem, make_quadratic_problem
from repro_torch.kernels import gradgen, ops, ref
from repro_torch.kernels.countsketch import countsketch_cuda, launch_plan, run_plan
from repro_torch.kernels.fused_guard import (
    MAX_WORKERS,
    fused_guard_cuda,
    fused_guard_gen_cuda,
    gen_xi_cuda,
)
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
@pytest.mark.parametrize("m,d", [(1, 1), (17, 555), (32, 2048), (33, 1000), (128, 4099),
                                 (129, 4099), (300, 555)])
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
    # past the first version's 128 workers, up to the port's cap
    g = torch.randn(129, 300, device=cuda_device)
    B = 3 * torch.randn(129, 300, device=cuda_device)
    got, want = ops.fused_guard(g, B, g[0]), ref.fused_guard_ref(g, B, g[0])
    assert torch.equal(got[3], want[3])
    for a, b in zip(got[:3], want[:3]):
        _within(a, b, 1e-5)
    big = torch.zeros(MAX_WORKERS + 1, 4, device=cuda_device)
    with pytest.raises(ValueError, match=f"MAX_WORKERS = {MAX_WORKERS}"):
        ops.fused_guard(big, big, big[0])


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(1, 1), (2, 9), (16, 4099), (17, 555), (32, 2048),
                                 (33, 1000), (128, 257), (129, 4099), (1000, 555)])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gram_and_order_statistics_match_plain(cuda_device, m, d, dt):
    tdt, tol = DTYPES[dt]
    gen = torch.Generator(device=cuda_device).manual_seed(m * 31 + d)
    x = torch.randn(m, d, device=cuda_device, generator=gen).to(tdt)
    _within(gram_cuda(x), ref.gram_ref(x), tol)
    # m > 32 runs the wide (shared-memory bitonic) path
    assert torch.equal(coordinate_median_cuda(x), ref.coordinate_median_ref(x))
    for n_trim in {0, (m - 1) // 2, min(8, (m - 1) // 2)}:
        _within(trimmed_mean_cuda(x, n_trim), ref.trimmed_mean_ref(x, n_trim), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 16, 17, 33, 64, 129, 1000])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_gram_matches_plain_and_repeats_bit_for_bit(cuda_device, m, dt):
    """The redesigned Gram (bf16 on tensor cores, f32 FMAs) at worker
    counts from one tile to many: d = 4099 (rows of no whole number of 16
    bytes: plain loads) and d = 4096 (cp.async); two calls give the same
    bits, and G is exactly symmetric."""
    tdt, tol = DTYPES[dt]
    gen = torch.Generator(device=cuda_device).manual_seed(m * 17 + 3)
    for d in (4099, 4096):
        x = torch.randn(m, d, device=cuda_device, generator=gen).to(tdt)
        got = gram_cuda(x)
        _within(got, ref.gram_ref(x), tol)
        assert torch.equal(got, gram_cuda(x))
        assert torch.equal(got, got.T)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [*range(1, 33), 40])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_order_statistics_spread_nan_and_refuse_over_trim(cuda_device, m, dt):
    """One NaN in each row position in turn, in column 7 and in the last
    column: at d = 300 the last column is the upper half of a packed bf16
    pair, at d = 301 the lone, masked one."""
    n_trim = min(3, (m - 1) // 2)
    for d in (300, 301):
        gen = torch.Generator(device=cuda_device).manual_seed(m * 7 + d)
        base = torch.randn(m, d, device=cuda_device, generator=gen).to(DTYPES[dt][0])
        for r in range(m):
            x = base.clone()
            x[r, 7] = float("nan")
            x[r, d - 1] = float("nan")
            for got, want in ((coordinate_median_cuda(x), ref.coordinate_median_ref(x)),
                              (trimmed_mean_cuda(x, n_trim), ref.trimmed_mean_ref(x, n_trim))):
                nan = torch.isnan(got)
                assert torch.equal(nan, torch.isnan(want))
                assert bool(nan[7]) and bool(nan[d - 1]) and int(nan.sum()) == 2
    with pytest.raises(ValueError, match="trims everything"):
        trimmed_mean_cuda(base, (m + 1) // 2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 555, 4096, 4099])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_order_statistics_match_plain_at_every_register_width(cuda_device, d, dt):
    """Every m of the register path (1 .. 32), odd and even d: the median
    bit-equal, the trimmed mean within tol."""
    tdt, tol = DTYPES[dt]
    for m in range(1, 33):
        gen = torch.Generator(device=cuda_device).manual_seed(m * 131 + d)
        x = torch.randn(m, d, device=cuda_device, generator=gen).to(tdt)
        med = coordinate_median_cuda(x)
        assert torch.equal(med, ref.coordinate_median_ref(x)), m
        for n_trim in {0, (m - 1) // 2, min(8, (m - 1) // 2)}:
            got = trimmed_mean_cuda(x, n_trim)
            _within(got, ref.trimmed_mean_ref(x, n_trim), tol)


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
@pytest.mark.parametrize("m,d", [(1, 1), (17, 555), (32, 2048), (33, 1000), (128, 4099),
                                 (129, 4099), (300, 555)])
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
# strided fold, and m·d > 2^31; then one for each of the kernel's paths and
# edges: k = 63 and k = 5 (scalar loads), k = d, d < V, row tiles cut short
# (m = 17, 33) on the vector path, odd d at bf16 (scalar loads), and a
# small k on the vector path whose terms are cut into chunks (scratch)
SKETCH_SHAPES = [(32, 2 ** 20, 4096), (17, 555, 8), (16, 16, 4096), (8, 4099, 64),
                 (32, 2 ** 26 + 3, 4096), (129, 4099, 64), (1000, 555, 8),
                 (33, 4099, 63), (17, 2 ** 16, 5), (8, 4096, 4096), (4, 3, 8),
                 (17, 2 ** 16, 256), (33, 2 ** 16, 4096), (17, 2 ** 18 + 1, 4096),
                 (32, 2 ** 20, 8)]


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
@pytest.mark.parametrize("m,d,k", [(33, 2 ** 16, 4096), (32, 2 ** 20, 8), (17, 4096, 64)])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_countsketch_instantiations_give_the_same_bits(cuda_device, m, d, k, dt):
    """The vector path's plan run with scalar loads, with 64-bit offsets, and
    on a misaligned copy of x (which the plan sends to the scalar loads):
    the same tiling sums in the same order, so the bits are the same."""
    tdt, tol = DTYPES[dt]
    gen = torch.Generator(device=cuda_device).manual_seed(m + d + k)
    x = torch.randn(m, d, device=cuda_device, generator=gen).to(tdt)
    plan = launch_plan(m, d, k, x.dtype, x.data_ptr() % 16 == 0)
    assert plan.vec
    got = countsketch_cuda(x, k, 3)
    _within(got, ref.countsketch_ref(x, k, 3), tol)
    for variant in (plan._replace(vec=False), plan._replace(wide=True),
                    plan._replace(vec=False, wide=True)):
        out = torch.empty_like(got)
        part = (torch.empty((variant.chunks, m, k), device=cuda_device)
                if variant.chunks > 1 else None)
        run_plan(x, k, 3, variant, out, part)
        assert torch.equal(out, got), variant
    shifted = torch.empty(m * d + 1, device=cuda_device, dtype=tdt)[1:].view(m, d)
    shifted.copy_(x)
    assert not launch_plan(m, d, k, tdt, shifted.data_ptr() % 16 == 0).vec
    assert torch.equal(countsketch_cuda(shifted, k, 3), got)


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


GEN_SHAPES = ([(m, d) for m in (1, 7, 32, 33, 128) for d in (1, 555, 2 ** 20 + 3)]
              + [(129, 555), (300, 4099)])
MOMENT_IDS = (4, 8)   # ALIE and alie_update: rows read the honest moments


def gen_operands(m: int, d: int, aid: int, dev, seed: int = 0) -> list:
    """The generator's operands: a quarter of the fleet plays ``aid``
    (phase a), two rows sign_flip (phase b), the last row is padding
    (slot −1) when m ≥ 4; every third worker carries a ±0.3 skew along a
    unit ``het_dir``."""
    cpu = torch.Generator().manual_seed(seed + 31 * m + d)
    h = torch.logspace(0.0, 3.0, d, base=2.0)
    x_star = torch.randn(d, generator=cpu) / d ** 0.5
    x = 0.1 * torch.randn(d, generator=cpu)
    het_dir = torch.randn(d, generator=cpu)
    het_dir /= het_dir.norm()
    keys = prng.split(prng.PRNGKey(seed + m), m)
    w = torch.arange(m)
    skewsign = 0.3 * (1.0 - 2.0 * (w % 2).float()) * (w % 3 == 0).float()
    n_a = max(m // 4, 1)
    slot = torch.zeros(m, dtype=torch.int32)
    slot[:n_a] = 1
    slot[n_a:n_a + 2] = 2
    if m >= 4:
        slot[-1] = -1
    params = torch.zeros(gradgen.GEN_NPARAMS)
    params[[gradgen.P_ID_A, gradgen.P_SF_A, gradgen.P_CONST_A, gradgen.P_IPC_A]] = torch.tensor(
        [float(aid), -3.0, 10.0 / d ** 0.5, 2.0])
    params[[gradgen.P_ID_B, gradgen.P_SF_B]] = torch.tensor([1.0, -1.5])
    params[gradgen.P_Z_A] = alie_z_max(m, torch.sum(slot > 0))
    params[gradgen.P_TGNRM] = torch.clamp(torch.linalg.vector_norm(h * (x - x_star)), min=1e-12)
    params[gradgen.P_NSCALE] = 1.0 / d ** 0.5
    return [t.to(dev) for t in (x, h, x_star, het_dir, keys, skewsign, slot, params)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", GEN_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_generating_kernels_match_plain(cuda_device, m, d, dt):
    tdt, tol = DTYPES[dt]
    cpu = torch.Generator().manual_seed(m * 1000 + d)
    B = (3.0 * torch.randn(m, d, generator=cpu)).to(tdt).to(cuda_device)
    delta = torch.randn(d, generator=cpu).to(tdt).to(cuda_device)
    for aid in gradgen.GEN_SUPPORTED_IDS:
        operands = gen_operands(m, d, aid, cuda_device)
        got = fused_guard_gen_cuda(B, delta, *operands)
        torch.cuda.synchronize()
        want = ref.fused_guard_gen_ref(B, delta, *operands)
        for a, b in zip(got[:3], want[:3]):
            _within(a, b, tol)
        assert got[3].dtype == tdt
        if aid in MOMENT_IDS:
            _within(got[3].float(), want[3].float(), tol)
        else:
            assert torch.equal(got[3], want[3]), f"B_new at id {aid}"
        # the kernel's own rows, materialised (B = 0 makes B_new the rows)
        rows = fused_guard_gen_cuda(torch.zeros_like(B), delta, *operands)[3]
        assert all(torch.equal(a, b) for a, b in zip(got, fused_guard_cuda(rows, B, delta)))

        slot = operands[6]
        w_xi = (slot == 0).float() / m
        w_byz = (slot > 0).float()
        xi, byz = gen_xi_cuda(w_xi, w_byz, *operands, stats_dtype=tdt)
        torch.cuda.synchronize()
        xi_want, byz_want = ref.gen_xi_ref(w_xi, w_byz, *operands, stats_dtype=tdt)
        _within(xi, xi_want, tol)
        _within(byz, byz_want, tol)
        assert torch.equal(xi, filtered_mean_cuda(rows, w_xi, 1.0)), f"xi at id {aid}"


SWEEP_WORKERS = [1, 17, 32, 33, 257]
ROW_LOCAL_IDS = [i for i in gradgen.GEN_SUPPORTED_IDS if i not in MOMENT_IDS]


@pytest.mark.cuda
@pytest.mark.parametrize("m", SWEEP_WORKERS)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_guard_sweep_variants_match_plain_and_repeat(cuda_device, m, dt):
    """The plain, sanitizing and generating sweeps (at bf16 one
    tensor-core consumer, csrc/guard_sweep.cuh) at an odd d: each against
    its plain version, and two calls give the same bits."""
    tdt, tol = DTYPES[dt]
    d = 4099
    cpu = torch.Generator().manual_seed(m * 31 + d)
    g = torch.randn(m, d, generator=cpu).to(tdt).to(cuda_device)
    B = (3.0 * torch.randn(m, d, generator=cpu)).to(tdt).to(cuda_device)
    delta = torch.randn(d, generator=cpu).to(tdt).to(cuda_device)
    gp = poison(g.clone()) if m > 1 else g.clone().fill_(float("nan"))
    operands = gen_operands(m, d, 1, cuda_device)
    calls = {"plain": (lambda: fused_guard_cuda(g, B, delta),
                       lambda: ref.fused_guard_ref(g, B, delta)),
             "sanitize": (lambda: fused_guard_cuda(gp, B, delta, sanitize=True),
                          lambda: ref.fused_guard_sanitize_ref(gp, B, delta)),
             "gen": (lambda: fused_guard_gen_cuda(B, delta, *operands),
                     lambda: ref.fused_guard_gen_ref(B, delta, *operands))}
    for name, (kernel, plain) in calls.items():
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again)), name
        assert torch.equal(got[3], want[3]), name
        for a, b in zip(got[:3], want[:3]):
            _within(a, b, tol)
        if name == "sanitize":
            assert torch.equal(got[4], want[4])


@pytest.mark.cuda
@pytest.mark.parametrize("aid", ROW_LOCAL_IDS)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_generating_sweep_equals_plain_sweep_on_the_plain_rows(cuda_device, aid, dt):
    """The generating sweep against the plain sweep fed the plain
    generator's rows (rounded once to the statistics type): all four
    outputs bit for bit, the kernel-level form of the main path's gate
    that generating and materialising runs give the same gaps."""
    tdt, _ = DTYPES[dt]
    m, d = 33, 1027
    cpu = torch.Generator().manual_seed(aid + d)
    B = (3.0 * torch.randn(m, d, generator=cpu)).to(tdt).to(cuda_device)
    delta = torch.randn(d, generator=cpu).to(tdt).to(cuda_device)
    operands = gen_operands(m, d, aid, cuda_device)
    rows = ref.gen_rows_ref(*operands).to(tdt)
    got = fused_guard_gen_cuda(B, delta, *operands)
    want = fused_guard_cuda(rows, B, delta)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("aid", MOMENT_IDS)
@pytest.mark.parametrize("m", [17, 129])
def test_shared_moments_equal_separate_moments(cuda_device, aid, m):
    """ALIE's moments handed from the sweep to gen_xi (one moments pass a
    step, as gen_step runs them) give gen_xi's own bits; the buffer holds
    the plain version's moments within 1e-6; a buffer of the wrong shape
    is refused."""
    d = 1027
    operands = gen_operands(m, d, aid, cuda_device)
    slot = operands[6]
    w_xi, w_byz = (slot == 0).float() / m, (slot > 0).float()
    B = torch.zeros(m, d, device=cuda_device)
    mom = torch.empty((2, d), device=cuda_device)
    fused_guard_gen_cuda(B, B[0], *operands, moments=mom)
    _within(mom, ref.gen_moments_ref(*operands), 1e-6)
    for tdt, _ in DTYPES.values():
        own = gen_xi_cuda(w_xi, w_byz, *operands, stats_dtype=tdt)
        shared = gen_xi_cuda(w_xi, w_byz, *operands, stats_dtype=tdt, moments=mom)
        assert all(torch.equal(a, b) for a, b in zip(own, shared))
    with pytest.raises(ValueError, match="moments"):
        gen_xi_cuda(w_xi, w_byz, *operands, moments=mom[:, :-1].contiguous())


@pytest.mark.cuda
def test_ops_generate_on_cuda_launch_the_kernels(cuda_device):
    m, d = 8, 300
    operands = gen_operands(m, d, 4, cuda_device)
    B = torch.zeros(m, d, device=cuda_device)
    before = fused_guard_gen_cuda.launches, gen_xi_cuda.launches
    ops.fused_guard_gen(B, B[0], *operands)
    ops.gen_xi(torch.ones(m, device=cuda_device), torch.ones(m, device=cuda_device), *operands)
    assert (fused_guard_gen_cuda.launches, gen_xi_cuda.launches) == (before[0] + 1,
                                                                      before[1] + 1)
    with pytest.raises(TypeError):
        ops.gen_xi(torch.ones(m, device=cuda_device), torch.ones(m, device=cuda_device),
                   *operands[:6], operands[6].long(), operands[7])
    # past the first version's 128 workers, up to the port's cap
    big = gen_operands(129, d, 4, cuda_device)
    B = 3 * torch.randn(129, d, device=cuda_device)
    for a, b in zip(ops.fused_guard_gen(B, B[0], *big), ref.fused_guard_gen_ref(B, B[0], *big)):
        _within(a.float(), b.float(), 1e-5)
    w = torch.ones(129, device=cuda_device)
    for a, b in zip(ops.gen_xi(w, w, *big), ref.gen_xi_ref(w, w, *big)):
        _within(a, b, 1e-5)
    with pytest.raises(ValueError, match=f"MAX_WORKERS = {MAX_WORKERS}"):
        ops.fused_guard_gen(torch.zeros(MAX_WORKERS + 1, d, device=cuda_device), B[0],
                            *gen_operands(MAX_WORKERS + 1, d, 1, cuda_device))


OVER_CAP_CALLS = {
    "fused_guard": lambda x, w, g: fused_guard_cuda(x, x, x[0]),
    "fused_guard_sanitize": lambda x, w, g: fused_guard_cuda(x, x, x[0], sanitize=True),
    "fused_guard_gen": lambda x, w, g: fused_guard_gen_cuda(x, x[0], *g),
    "gen_xi": lambda x, w, g: gen_xi_cuda(w, w, *g),
    "filtered_mean": lambda x, w, g: filtered_mean_cuda(x, w, 1.0),
    "filtered_mean_sanitize": lambda x, w, g: filtered_mean_cuda(x, w, 1.0, sanitize=True),
    "gram": lambda x, w, g: gram_cuda(x),
    "coordinate_median": lambda x, w, g: coordinate_median_cuda(x),
    "trimmed_mean": lambda x, w, g: trimmed_mean_cuda(x, 1),
    "countsketch": lambda x, w, g: countsketch_cuda(x, 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(OVER_CAP_CALLS))
def test_every_wrapper_takes_the_cap_and_refuses_past_it(cuda_device, name):
    """m = MAX_WORKERS runs (finite outputs); one worker more raises a
    ValueError naming the cap."""
    for m in (MAX_WORKERS, MAX_WORKERS + 1):
        x = torch.randn(m, 8, device=cuda_device)
        w = torch.ones(m, device=cuda_device)
        operands = gen_operands(m, 8, 1, cuda_device)
        if m > MAX_WORKERS:
            with pytest.raises(ValueError, match=f"MAX_WORKERS = {MAX_WORKERS}"):
                OVER_CAP_CALLS[name](x, w, operands)
            continue
        out = OVER_CAP_CALLS[name](x, w, operands)
        torch.cuda.synchronize()
        for t in out if isinstance(out, tuple) else (out,):
            assert not t.is_floating_point() or bool(torch.isfinite(t).all())


@pytest.mark.cuda
@pytest.mark.parametrize("attack", ["sign_flip", "alie"])
def test_gen_run_on_the_card_matches_the_cpu(cuda_device, attack):
    kw = dict(m=8, T=40, eta=0.05, alpha=0.25, aggregator="byzantine_sgd",
              guard_backend="fused", generate="kernel")
    adv = ScenarioAdversary(scenario_static(attack), 0.25)
    before = fused_guard_gen_cuda.launches, gen_xi_cuda.launches, fused_guard_cuda.launches
    got = run_sgd(make_generated_problem(d=4099, seed=1, device=cuda_device),
                  SolverConfig(**kw), prng.PRNGKey(1), adversary=adv, device=cuda_device)
    after = fused_guard_gen_cuda.launches, gen_xi_cuda.launches, fused_guard_cuda.launches
    assert tuple(a - b for a, b in zip(after, before)) == (40, 40, 0)
    want = run_sgd(make_generated_problem(d=4099, seed=1, device="cpu"), SolverConfig(**kw),
                   prng.PRNGKey(1), adversary=adv, device="cpu")
    assert torch.equal(got.n_alive.cpu(), want.n_alive)
    assert torch.equal(got.final_alive.cpu(), want.final_alive)
    _within(got.x_avg.cpu(), want.x_avg, 1e-5)


# the convex harness's widths: quickstart's d = 16 and the logistic
# problem's d = 10 (a bf16 row of 20 bytes, so rows after the first start
# off a 16-byte boundary), both below one tile of every sweep
@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 10])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_kernels_at_the_convex_harness_widths(cuda_device, d, dt):
    tdt, tol = DTYPES[dt]
    m = 16
    gen = torch.Generator(device=cuda_device).manual_seed(d * 31 + m)
    g = torch.randn(m, d, device=cuda_device, generator=gen).to(tdt)
    B = (3 * torch.randn(m, d, device=cuda_device, generator=gen)).to(tdt)
    dlt = torch.randn(d, device=cuda_device, generator=gen).to(tdt)
    w = (torch.rand(m, device=cuda_device, generator=gen) > 0.3).float()
    got, want = fused_guard_cuda(g, B, dlt), ref.fused_guard_ref(g, B, dlt)
    assert torch.equal(got[3], want[3])
    for a, b in zip(got[:3], want[:3]):
        _within(a, b, tol)
    _within(filtered_mean_cuda(g, w, 3.0), ref.filtered_mean_ref(g, w, 3.0), tol)
    _within(gram_cuda(g), ref.gram_ref(g), tol)
    assert torch.equal(coordinate_median_cuda(g), ref.coordinate_median_ref(g))
    _within(trimmed_mean_cuda(g, 7), ref.trimmed_mean_ref(g, 7), tol)
    for k in (4096, 8):
        _within(countsketch_cuda(g, k), ref.countsketch_ref(g, k), tol)
    p = poison(g)
    got, want = fused_guard_cuda(p, B, dlt, sanitize=True), ref.fused_guard_sanitize_ref(p, B, dlt)
    assert torch.equal(got[4], want[4]) and torch.equal(got[3], want[3])
    for a, b in zip(got[:3], want[:3]):
        _within(a, b, tol)
    _within(filtered_mean_cuda(p, w, 3.0, sanitize=True),
            ref.filtered_mean_sanitize_ref(p, w, 3.0), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("aggregator", ["byzantine_sgd", "krum", "coordinate_median"])
def test_quadratic_run_on_the_card_matches_the_cpu(cuda_device, aggregator):
    """The quickstart problem (sphere noise drawn by ``prng.normal``) under
    random_gaussian: the card decides as the CPU at every step."""
    kw = dict(m=16, T=60, eta=0.05, alpha=0.25, aggregator=aggregator,
              attack="random_gaussian", guard_backend="fused")
    got = run_sgd(make_quadratic_problem(d=16, L=8.0, device=cuda_device), SolverConfig(**kw),
                  prng.PRNGKey(0), device=cuda_device)
    want = run_sgd(make_quadratic_problem(d=16, L=8.0, device="cpu"), SolverConfig(**kw),
                   prng.PRNGKey(0), device="cpu")
    assert torch.equal(got.n_alive.cpu(), want.n_alive)
    assert torch.equal(got.final_alive.cpu(), want.final_alive)
    _within(got.x_avg.cpu(), want.x_avg, 1e-5)


# ---------------------------------------------------------------------------
# the run axis: one launch for a campaign group's R runs
# ---------------------------------------------------------------------------

RUN_SHAPES = [(17, 555), (32, 2048), (33, 1000)]


def _runs_operands(R: int, m: int, d: int, tdt, dev, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(R, m, d, device=dev, generator=gen).to(tdt)
    B = (3 * torch.randn(R, m, d, device=dev, generator=gen)).to(tdt)
    dlt = torch.randn(R, d, device=dev, generator=gen).to(tdt)
    w = (torch.rand(R, m, device=dev, generator=gen) > 0.3).float()
    return g, B, dlt, w


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 3, 4])
@pytest.mark.parametrize("m,d", RUN_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("sanitize", [False, True])
def test_batched_guard_kernels_equal_their_runs_alone(cuda_device, R, m, d, dt, sanitize):
    from repro_torch.kernels.fused_guard import fused_guard_runs_cuda
    from repro_torch.kernels.robust_reduce import filtered_mean_runs_cuda

    tdt, tol = DTYPES[dt]
    g, B, dlt, w = _runs_operands(R, m, d, tdt, cuda_device, R * 7919 + m * 31 + d)
    if sanitize:
        g = torch.stack([poison(row) for row in g])
    counter = "launches_sanitize" if sanitize else "launches"
    before = (getattr(fused_guard_cuda, counter), getattr(filtered_mean_cuda, counter))
    got = fused_guard_runs_cuda(g, B, dlt, sanitize=sanitize)
    xi = filtered_mean_runs_cuda(g, w, 3.0, sanitize=sanitize)
    assert (getattr(fused_guard_cuda, counter), getattr(filtered_mean_cuda, counter)) == (
        before[0] + 1, before[1] + 1)
    plain_guard = ref.fused_guard_sanitize_ref if sanitize else ref.fused_guard_ref
    plain_xi = ref.filtered_mean_sanitize_ref if sanitize else ref.filtered_mean_ref
    for r in range(R):
        alone = fused_guard_cuda(g[r], B[r], dlt[r], sanitize=sanitize)
        for a, b in zip(got, alone):
            assert torch.equal(a[r], b)
        assert torch.equal(xi[r], filtered_mean_cuda(g[r], w[r], 3.0, sanitize=sanitize))
        want = plain_guard(g[r], B[r], dlt[r])
        assert torch.equal(got[3][r], want[3])
        if sanitize:
            assert torch.equal(got[4][r], want[4])
        for a, b in zip(got[:3], want[:3]):
            _within(a[r], b, tol)
        _within(xi[r], plain_xi(g[r], w[r], 3.0), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 3, 4])
@pytest.mark.parametrize("m,d", RUN_SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_batched_gram_and_folded_kernels_equal_their_runs_alone(cuda_device, R, m, d, dt):
    from repro_torch.kernels.countsketch import countsketch_runs_cuda
    from repro_torch.kernels.pairdist import gram_runs_cuda
    from repro_torch.kernels.robust_reduce import (
        coordinate_median_runs_cuda,
        trimmed_mean_runs_cuda,
    )

    tdt, tol = DTYPES[dt]
    x = _runs_operands(R, m, d, tdt, cuda_device, R * 104729 + m * 31 + d)[0]
    before = gram_cuda.launches
    G = gram_runs_cuda(x)
    assert gram_cuda.launches == before + 1
    med = coordinate_median_runs_cuda(x)
    trim = trimmed_mean_runs_cuda(x, 2)
    sk = countsketch_runs_cuda(x, 64, 3)
    for r in range(R):
        assert torch.equal(G[r], gram_cuda(x[r]))
        _within(G[r], ref.gram_ref(x[r]), tol)
        assert torch.equal(med[r], coordinate_median_cuda(x[r]))
        assert torch.equal(trim[r], trimmed_mean_cuda(x[r], 2))
        assert torch.equal(sk[r], countsketch_cuda(x[r], 64, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_ops_under_vmap_launch_once_and_never_reach_a_plain_version(cuda_device, dt,
                                                                    monkeypatch):
    from torch.func import vmap

    tdt, _ = DTYPES[dt]
    R, m, d = 3, 17, 555
    g, B, dlt, w = _runs_operands(R, m, d, tdt, cuda_device, 11)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor under vmap reached a plain version")

    for name in ("fused_guard_ref", "fused_guard_sanitize_ref", "filtered_mean_ref",
                 "filtered_mean_sanitize_ref", "gram_ref", "coordinate_median_ref",
                 "trimmed_mean_ref", "countsketch_ref"):
        monkeypatch.setattr(ref, name, refuse)
    counters = [(fused_guard_cuda, "launches"), (fused_guard_cuda, "launches_sanitize"),
                (filtered_mean_cuda, "launches"), (filtered_mean_cuda, "launches_sanitize"),
                (gram_cuda, "launches"), (coordinate_median_cuda, "launches"),
                (trimmed_mean_cuda, "launches"), (countsketch_cuda, "launches")]
    before = [getattr(f, c) for f, c in counters]

    def step(g, B, dlt, w):
        out = ops.fused_guard(g, B, dlt)
        san = ops.fused_guard(g, B, dlt, sanitize=True)
        return (*out, *san, ops.filtered_mean(g, w, 1.0), ops.filtered_mean(g, w, 1.0, True),
                ops.gram(g), ops.coordinate_median(g), ops.trimmed_mean(g, 2),
                ops.countsketch(g, 64, 1))

    got = vmap(step)(g, B, dlt, w)
    assert [getattr(f, c) - b for (f, c), b in zip(counters, before)] == [1] * len(counters)
    for r in range(R):
        want = (*fused_guard_cuda(g[r], B[r], dlt[r]),
                *fused_guard_cuda(g[r], B[r], dlt[r], sanitize=True),
                filtered_mean_cuda(g[r], w[r], 1.0), filtered_mean_cuda(g[r], w[r], 1.0, True),
                gram_cuda(g[r]), coordinate_median_cuda(g[r]), trimmed_mean_cuda(g[r], 2),
                countsketch_cuda(g[r], 64, 1))
        for a, b in zip(got, want):
            assert torch.equal(a[r], b)
    # an operand the runs share is expanded, not refused
    shared = vmap(lambda g: ops.fused_guard(g, B[0], dlt[0]))(g)
    for r in range(R):
        for a, b in zip(shared, fused_guard_cuda(g[r], B[0], dlt[0])):
            assert torch.equal(a[r], b)
    # the generating kernels: one launch each for the R runs (their own
    # keys, slots and parameters; x* and h shared), never a plain version
    for name in ("fused_guard_gen_ref", "gen_xi_ref", "gen_moments_ref"):
        monkeypatch.setattr(ref, name, refuse)
    runs = [gen_operands(m, d, 4, cuda_device, seed=r) for r in range(R)]
    stacked = [torch.stack([o[q] for o in runs]) for q in range(8)]
    for q in (1, 2, 3):   # h, x*, het_dir: one for every run
        stacked[q] = runs[0][q]
        for o in runs:
            o[q] = runs[0][q]
    before = fused_guard_gen_cuda.launches, gen_xi_cuda.launches

    def gen_step(B, dlt, x, keys, skewsign, slot, params, w):
        ops_in = (x, stacked[1], stacked[2], stacked[3], keys, skewsign, slot, params)
        *out, mom = ops.fused_guard_gen(B, dlt, *ops_in, return_moments=True)
        return (*out, mom, *ops.gen_xi(w, w, *ops_in, stats_dtype=tdt, moments=mom))

    got = vmap(gen_step, in_dims=(0, 0, 0, 0, 0, 0, 0, 0))(
        B, dlt, stacked[0], *stacked[4:], w)
    assert (fused_guard_gen_cuda.launches - before[0], gen_xi_cuda.launches - before[1]) == (1, 1)
    for r in range(R):
        mom = torch.empty((2, d), device=cuda_device)
        want = fused_guard_gen_cuda(B[r], dlt[r], *runs[r], moments=mom)
        want = (*want, mom, *gen_xi_cuda(w[r], w[r], *runs[r], stats_dtype=tdt, moments=mom))
        for a, b in zip(got, want):
            assert torch.equal(a[r], b)


@pytest.mark.cuda
def test_campaign_rows_on_the_card_equal_their_runs_alone(cuda_device):
    from repro_torch.scenarios import expand_grid, run_campaign, scenario_churn

    prob = make_quadratic_problem(d=16, sigma=1.0, L=8.0, V=1.0, seed=0, device=cuda_device)
    cfg = SolverConfig(m=16, T=30, eta=0.05, alpha=0.25)
    grid = expand_grid([("sign_flip", scenario_static("sign_flip")),
                        ("churn", scenario_churn("sign_flip", 10, 2))], [0.25], range(3))
    aggs = ["krum", "coordinate_median", "byzantine_sgd@fused", "byzantine_sgd@fused@bf16",
            "byzantine_sgd@dense", "byzantine_sgd@dp_sketch"]
    before = fused_guard_cuda.launches
    res = run_campaign(prob, cfg, grid, aggs, return_gaps=True, device=cuda_device)
    # two groups (static, churn), two fused variants: T launches a group each
    assert fused_guard_cuda.launches - before == 2 * 2 * cfg.T
    assert res.memory["peak_bytes"] > 0
    for name in aggs:
        agg, _, be = name.partition("@")
        be, _, sd = be.partition("@")
        one = cfg._replace(aggregator=agg, guard_backend=be or "dense", stats_dtype=sd or "f32")
        st = res.stats[name]
        for i, e in enumerate(res.entries):
            scn = grid.scenarios[i]
            run = run_sgd(prob, one, prng.PRNGKey(e["seed"], device=cuda_device),
                          adversary=ScenarioAdversary(scn, e["alpha"]), device=cuda_device)
            assert int(st.n_alive_final[i]) == int(run.n_alive[-1]), (name, i)
            assert bool(st.ever_filtered_good[i]) == bool(run.ever_filtered_good)
            torch.testing.assert_close(st.gaps[i], run.gaps, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("m,d", [(17, 555), (33, 1000)])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("aid", (1, 4))
def test_batched_generating_kernels_equal_their_runs_alone(cuda_device, R, m, d, dt, aid):
    """``fused_guard_gen_runs_cuda`` and ``gen_xi_runs_cuda``: each run's
    outputs, ALIE's moments included, are the bits of its one-run launch;
    x per run, h, x* and het_dir shared (R = 3) or per run (R = 1); gen_xi
    with the sweep's moments and with its own moments pass."""
    from repro_torch.kernels.fused_guard import fused_guard_gen_runs_cuda, gen_xi_runs_cuda

    tdt, _ = DTYPES[dt]
    runs = [gen_operands(m, d, aid, cuda_device, seed=7 * r + 1) for r in range(R)]
    stacked = [torch.stack([o[q] for o in runs]) for q in range(8)]
    if R > 1:
        for q in (1, 2, 3):   # one h, x* and het_dir for every run
            stacked[q] = runs[0][q]
            for o in runs:
                o[q] = runs[0][q]
    gen = torch.Generator(device=cuda_device).manual_seed(R * 31 + m)
    B = (3 * torch.randn(R, m, d, device=cuda_device, generator=gen)).to(tdt)
    dlt = torch.randn(R, d, device=cuda_device, generator=gen).to(tdt)
    w_xi = torch.rand(R, m, device=cuda_device, generator=gen) / m
    w_byz = (torch.stack([o[6] for o in runs]) > 0).float()
    before = fused_guard_gen_cuda.launches, gen_xi_cuda.launches
    got = fused_guard_gen_runs_cuda(B, dlt, *stacked)
    xi = gen_xi_runs_cuda(w_xi, w_byz, *stacked, stats_dtype=tdt, moments=got[4])
    xi_own = gen_xi_runs_cuda(w_xi, w_byz, *stacked, stats_dtype=tdt)
    assert (fused_guard_gen_cuda.launches - before[0], gen_xi_cuda.launches - before[1]) == (1, 2)
    for r in range(R):
        mom = torch.empty((2, d), device=cuda_device)
        alone = fused_guard_gen_cuda(B[r], dlt[r], *runs[r], moments=mom)
        # the moments are written only when an ALIE id is in play
        for a, b in zip(got, (*alone, mom) if aid in MOMENT_IDS else alone):
            assert torch.equal(a[r], b)
        for a, b, c in zip(xi, xi_own, gen_xi_cuda(w_xi[r], w_byz[r], *runs[r],
                                                   stats_dtype=tdt)):
            assert torch.equal(a[r], c) and torch.equal(b[r], c)
    with pytest.raises(ValueError, match="moments"):
        gen_xi_runs_cuda(w_xi, w_byz, *stacked, moments=got[4][:, :, :-1].contiguous())


@pytest.mark.cuda
def test_gen_campaign_on_the_card_decides_as_fused(cuda_device):
    """A campaign's ``gen`` and ``gen@bf16`` variants on the card: the two
    generating kernels T times a group, no materialising guard kernel; the
    ``gen`` rows decide as the ``fused`` rows with gaps within 1e-6 (the
    reference's criterion, tests/test_campaign_chunked.py)."""
    from repro_torch.scenarios import expand_grid, run_campaign, scenario_churn

    prob = make_generated_problem(d=16, sigma=1.0, L=8.0, V=1.0, seed=0, device=cuda_device)
    cfg = SolverConfig(m=16, T=25, eta=0.05, alpha=0.25)
    grid = expand_grid([("static_sign_flip", scenario_static("sign_flip")),
                        ("churn", scenario_churn("sign_flip", period=10, stride=2))],
                       [0.125, 0.25], range(3))
    before = (fused_guard_cuda.launches, fused_guard_gen_cuda.launches, gen_xi_cuda.launches)
    res = run_campaign(prob, cfg, grid, ["byzantine_sgd"], backends=("gen", "gen@bf16"),
                       device=cuda_device)
    after = (fused_guard_cuda.launches, fused_guard_gen_cuda.launches, gen_xi_cuda.launches)
    # 4 groups (2 scenarios x 2 alphas), 2 generating variants
    assert [a - b for a, b in zip(after, before)] == [0, 2 * 4 * cfg.T, 2 * 4 * cfg.T]
    fused = run_campaign(prob, cfg, grid, ["byzantine_sgd"], backends=("fused",),
                         device=cuda_device).stats["byzantine_sgd@fused"]
    gen = res.stats["byzantine_sgd@gen"]
    assert torch.equal(gen.n_alive_final, fused.n_alive_final)
    assert torch.equal(gen.detect_latency, fused.detect_latency)
    torch.testing.assert_close(gen.gap_final, fused.gap_final, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_bitflip_fault_axis_runs_in_a_campaign_on_the_card(cuda_device):
    """A campaign with a ``bitflip`` fault axis (the flip is the custom op
    ``repro_torch::flip_bits`` with its own vmap rule): every row equals
    its run alone in decisions, and the flipped batch of one step is
    bit-equal to the single-run flip."""
    from torch.func import vmap

    from repro_torch.scenarios import expand_grid, faults, run_campaign

    prob = make_quadratic_problem(d=16, sigma=1.0, L=8.0, V=1.0, seed=0, device=cuda_device)
    cfg = SolverConfig(m=16, T=20, eta=0.05, alpha=0.25, sanitize="quarantine")
    plan = faults.fault_bitflip(0.125, start_step=5)
    grid = expand_grid([("sign_flip", scenario_static("sign_flip"))], [0.25], range(3),
                       faults=[("none", None), ("bitflip", plan)])
    res = run_campaign(prob, cfg, grid, ["byzantine_sgd@fused", "coordinate_median"],
                       device=cuda_device)
    for name, st in res.stats.items():
        agg, _, be = name.partition("@")
        one = cfg._replace(aggregator=agg, guard_backend=be or "dense")
        for i, e in enumerate(res.entries):
            run = run_sgd(prob, one, prng.PRNGKey(e["seed"], device=cuda_device),
                          adversary=ScenarioAdversary(grid.scenarios[i], e["alpha"],
                                                      faults=grid.faults[i]),
                          device=cuda_device)
            assert int(st.n_alive_final[i]) == int(run.n_alive[-1]), (name, i)
    keys = torch.stack([prng.PRNGKey(s, device=cuda_device) for s in range(3)])
    grads = torch.randn(3, 16, 64, device=cuda_device)
    rank = torch.arange(16, device=cuda_device)
    got = vmap(lambda k, g: faults.apply_fault_plan(plan, k, g, rank, 5))(keys, grads)
    for r in range(3):
        want = faults.apply_fault_plan(plan, keys[r], grads[r], rank, 5)
        assert torch.equal(got[r].view(torch.int32), want.view(torch.int32))


# a whole model's gradient rows: internlm2-1.8b at 2 layers (d = its
# parameter count) and the LM trainer's 8 workers, m·d between 2^31 and 2^32
LM_M, LM_D = 8, 504_899_584


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_guard", "filtered_mean", "countsketch"])
def test_lm_width_kernels_match_plain(cuda_device, kernel):
    """The LM path's kernels at m = 8, d = 504,899,584 in bf16 against their
    plain versions, taken by column blocks (no room for the f32 copies)."""
    gen = torch.Generator(device=cuda_device).manual_seed(LM_D % 7919)
    x = torch.randn(LM_M, LM_D, device=cuda_device, generator=gen, dtype=torch.bfloat16)
    if kernel == "fused_guard":
        B = torch.randn(LM_M, LM_D, device=cuda_device, generator=gen, dtype=torch.bfloat16)
        dlt = torch.randn(LM_D, device=cuda_device, generator=gen, dtype=torch.bfloat16)
        got = fused_guard_cuda(x, B, dlt)
        want = ref.fused_guard_ref_blocked(x, B, dlt)
        assert torch.equal(got[3], want[3])
        for a, b in zip(got[:3], want[:3]):
            _within(a, b, 1e-4)
    elif kernel == "filtered_mean":
        w = torch.tensor([1, 1, 0, 1, 1, 0, 1, 1], dtype=torch.float32, device=cuda_device)
        _within(filtered_mean_cuda(x, w, 6.0), ref.filtered_mean_ref_blocked(x, w, 6.0), 1e-4)
    else:
        _within(countsketch_cuda(x, 4096, 0), ref.countsketch_ref_blocked(x, 4096, 0), 1e-4)


# ---------------------------------------------------------------- checkpoints and serving

LAUNCH = dict(reduced=True, d_model=64, workers=4, seq_len=16, steps=12, log_every=4,
              guard_backend="fused", stats_dtype="bf16", guard_v=3.0, verbose=False)


def _leaves_equal(a, b) -> bool:
    from repro_torch.utils import tree_leaves
    return all((torch.equal(x.cpu(), y.cpu()) and x.dtype == y.dtype)
               if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.cuda
def test_lm_resume_on_the_card_equals_uninterrupted(cuda_device, tmp_path):
    """The launcher on the card (fused@bf16: the guard's B a bf16 leaf),
    stopped after 6 of 12 steps and resumed: the final state bit-equal to
    the uninterrupted run's, the history equal."""
    import numpy as np

    from repro_torch.launch.train import run_training
    full, hist = run_training("internlm2-1.8b", device=cuda_device, **LAUNCH)
    run_training("internlm2-1.8b", device=cuda_device, ckpt_dir=str(tmp_path), stop_after=6,
                 **LAUNCH)
    resumed, rhist = run_training("internlm2-1.8b", device=cuda_device, ckpt_dir=str(tmp_path),
                                  resume=True, **LAUNCH)
    assert full.guard.B.dtype == torch.bfloat16 and resumed.step == 12
    assert _leaves_equal(resumed, full)
    np.testing.assert_equal(rhist, hist)


@pytest.mark.cuda
def test_card_checkpoint_restores_on_the_cpu_and_back(cuda_device, tmp_path):
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.launch.train import run_training
    from repro_torch.utils import tree_map
    state, _ = run_training("internlm2-1.8b", device=cuda_device, stop_after=4, **LAUNCH)
    save_checkpoint(str(tmp_path / "card"), state.step, state)
    cpu_tmpl = tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t, state)
    on_cpu, step = restore_checkpoint(str(tmp_path / "card"), cpu_tmpl)
    assert step == 4 and on_cpu.anchor.device.type == "cpu" and _leaves_equal(on_cpu, state)
    save_checkpoint(str(tmp_path / "cpu"), on_cpu.step, on_cpu)
    back, _ = restore_checkpoint(str(tmp_path / "cpu"), state)
    assert back.anchor.device.type == "cuda" and _leaves_equal(back, state)


@pytest.mark.cuda
def test_full_width_serve_decodes_as_the_forward_at_one_layer(cuda_device):
    """internlm2-1.8b at every published width, one layer, bf16: prefill's
    last logits and 8 decode steps' within 5e-2 relative of a
    teacher-forced forward over the prompt and the greedy tokens (at 24
    layers the reference's init decorrelates the two; ``chip_smoke.py``'s
    lm_serve_full_width holds them with the attention rescaled)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.models.model import _lm_head
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), n_layers=1)
    model = build_model(cfg, device=cuda_device)
    key = prng.PRNGKey(0, device=cuda_device)
    params = model.init(key)
    prompt = prng.randint(key, (2, 64), 0, cfg.vocab_size)
    res = generate(model, params, prompt, gen_tokens=9, cache_len=128, keep_logits=True)
    seq = torch.cat([prompt, res.tokens[:, :-1]], dim=1)
    with torch.no_grad():
        h, _, _ = model.forward(params, {"tokens": seq})
        want = _lm_head(cfg, params, h[:, 63:]).float()
    got = torch.cat(res.logits, dim=1).float()
    err = (got - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(err.max()) <= 5e-2
    assert torch.equal(res.tokens, torch.argmax(got, -1).to(torch.int32))
