"""The port's guard kernels: plain versions against the JAX Pallas kernels
(run in interpret mode, as the JAX package's own tests run them on the
CPU) and dispatch by device.  The CUDA kernels against their plain
versions are in ``test_torch_cuda.py``, which runs where JAX is absent.

Tolerance: ‖got − want‖ ≤ tol·‖want‖ + tol with tol = 1e-5 (f32) and 1e-2
(bf16), the JAX suite's own rule; the order of the f32 sums differs.
``B_new`` is one f32 add and one rounding, so it must be bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_guard import fused_guard_pallas
from repro.kernels.robust_reduce import filtered_mean_pallas
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.fused_guard import fused_guard_cuda
from repro_torch.kernels.robust_reduce import filtered_mean_cuda

SHAPES = [(4, 64), (17, 555), (32, 2048)]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    assert err <= tol * np.linalg.norm(want) + tol, (err, np.linalg.norm(want))


def _to_torch(a):
    """A jax array as a torch tensor of the same dtype (bf16 bit for bit)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _inputs(m, d, jdt, seed):
    rng = np.random.default_rng(seed)
    g = jnp.asarray(rng.normal(size=(m, d)), jnp.float32).astype(jdt)
    B = jnp.asarray(3.0 * rng.normal(size=(m, d)), jnp.float32).astype(jdt)
    dlt = jnp.asarray(rng.normal(size=(d,)), jnp.float32).astype(jdt)
    mask = jnp.asarray(rng.random(m) > 0.3, jnp.float32)
    return g, B, dlt, mask


@pytest.mark.parametrize("m,d", SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_fused_guard_ref_matches_pallas(m, d, dt):
    jdt, tdt, tol = DTYPES[dt]
    g, B, dlt, _ = _inputs(m, d, jdt, m * 1000 + d)
    want = fused_guard_pallas(g, B, dlt, d_block=512, interpret=True)
    got = ref.fused_guard_ref(_to_torch(g), _to_torch(B), _to_torch(dlt))
    assert got[3].dtype == tdt
    np.testing.assert_array_equal(got[3].view(torch.int16 if dt == "bf16" else torch.int32).numpy(),
                                  np.asarray(want[3]).view(np.int16 if dt == "bf16" else np.int32))
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == torch.float32
        _rel_close(a.numpy(), b, tol)


@pytest.mark.parametrize("m,d", SHAPES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_filtered_mean_ref_matches_pallas(m, d, dt):
    jdt, _, tol = DTYPES[dt]
    g, _, _, mask = _inputs(m, d, jdt, m + d)
    want = filtered_mean_pallas(g, mask, 3.0, d_block=512, interpret=True)
    got = ref.filtered_mean_ref(_to_torch(g), _to_torch(mask), 3.0)
    assert got.dtype == torch.float32 and got.shape == (d,)
    _rel_close(got.numpy(), want, tol)


def test_gram_ref_is_symmetric_f32():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(6, 50))).to(torch.bfloat16)
    G = ref.gram_ref(x)
    assert G.dtype == torch.float32 and G.shape == (6, 6)
    torch.testing.assert_close(G, G.T)


def test_ops_on_cpu_run_the_plain_versions():
    g, B, dlt, mask = (_to_torch(a) for a in _inputs(5, 77, jnp.float32, 1))
    before = (fused_guard_cuda.launches, filtered_mean_cuda.launches)
    assert not ops.runs_kernel(g)
    for a, b in zip(ops.fused_guard(g, B, dlt), ref.fused_guard_ref(g, B, dlt)):
        assert torch.equal(a, b)
    assert torch.equal(ops.filtered_mean(g, mask, 2.0), ref.filtered_mean_ref(g, mask, 2.0))
    assert (fused_guard_cuda.launches, filtered_mean_cuda.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    g = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fused_guard_cuda(g, g, torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA"):
        filtered_mean_cuda(g, torch.ones(4), 1.0)


def test_ptxas_report_reads_registers_stack_and_spills(monkeypatch):
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z3fooILi2EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooILi2EEvPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 380 bytes cmem[0]
ptxas info    : Function properties for __internal_slowpath
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z3barPf' for 'sm_90a'
ptxas info    : Function properties for _Z3barPf
    16 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 380 bytes cmem[0]
"""
    monkeypatch.setattr(_build, "build_log", lambda stem: log)
    assert _build.ptxas_report("sorted_reduce") == {
        "_Z3fooILi2EEvPf": {"registers": 40, "stack": 0, "spill_stores": 0, "spill_loads": 0},
        "_Z3barPf": {"registers": 255, "stack": 16, "spill_stores": 12, "spill_loads": 4}}


def test_build_names_libraries_by_source_hash():
    paths = {p.stem: _build.library_path(p) for p in _build.sources()}
    assert set(paths) == {"fused_guard", "filtered_mean", "gram", "sorted_reduce", "countsketch"}
    for stem, so in paths.items():
        assert so.parent == _build.BUILD_DIR
        assert so.name.startswith(stem + "-") and so.suffix == ".so"
        assert so == _build.library_path(_build.CSRC / f"{stem}.cu")   # stable
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
