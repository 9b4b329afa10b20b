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
``B_new`` is bit-equal.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_guard import fused_guard_cuda
from repro_torch.kernels.robust_reduce import filtered_mean_cuda

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
