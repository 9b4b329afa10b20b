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
value or averages two, with no sum whose order could differ.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref
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
