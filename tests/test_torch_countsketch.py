"""The port's CountSketch against the JAX package's, on the CPU.

The same numpy-made inputs go through the JAX package's ``countsketch_ref``,
``countsketch_pallas`` (interpret mode) and the dp guard's ``sketch_tree``,
and through the port's ``countsketch_ref``, ``ops.countsketch`` (a CPU
tensor runs the plain version) and ``sketch_tree``.  The hashed signs are
bit-equal; the sketches, f32 sums taken in another order, agree within
rtol 1e-5 and atol 1e-6.  Inputs have the scale of gradient deviations
(entries ~ 1/√d), so the sums are O(1) and the atol is a bound on rounding,
not on the values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import byzantine_dp as jdp
from repro.kernels import countsketch as jcs
from repro.kernels import ref as jref
from repro_torch.distributed import byzantine_dp as tdp
from repro_torch.kernels import ops, ref
from repro_torch.kernels.countsketch import countsketch_cuda, n_chunks

# (m, d, k, salt): k not dividing d, k > d (the reference's default 4096
# at tiny d), a strided fold with a short tail, a long fold; salts 0 and 7
CASES = [(17, 555, 8, 0), (17, 555, 8, 7), (16, 16, 4096, 7), (8, 4099, 64, 0),
         (8, 4099, 64, 7), (4, 2048, 8, 0)]


def _x(m, d, dt, seed):
    x = np.random.default_rng(seed).normal(size=(m, d)) / np.sqrt(d)
    x = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16 if dt == "bf16" else jnp.float32)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16 if dt == "bf16" else torch.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,salt", [(1, 0), (4099, 0), (4099, 1), (20000, 7), (300, -3)])
def test_sketch_sign_is_bit_equal_to_jax(n, salt):
    want = np.asarray(jref.sketch_sign(n, salt))
    np.testing.assert_array_equal(ref.sketch_sign(n, salt).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jdp._sign_iota(n, salt)), want)
    np.testing.assert_array_equal(
        np.asarray(jcs._sign_hash(jnp.arange(n, dtype=jnp.uint32), salt)), want)


@pytest.mark.parametrize("m,d,k,salt", CASES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_countsketch_matches_jax(m, d, k, salt, dt):
    jx, tx = _x(m, d, dt, seed=m * d + k)
    want = np.asarray(jref.countsketch_ref(jx, k, salt))
    got = ref.countsketch_ref(tx, k, salt)
    assert got.dtype == torch.float32 and got.shape == (m, k)
    _close(got.numpy(), want)
    _close(ops.countsketch(tx, k, salt).numpy(), want)
    _close(got.numpy(), np.asarray(jcs.countsketch_pallas(jx, k, salt, interpret=True)))
    if k > d:
        assert not got[:, d:].any()   # buckets past d stay empty


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("k", [8, 64, 4096])
def test_sketch_tree_matches_jax_with_two_leaves(dt, k):
    """Leaf number s is sketched under salt s and the sketches add."""
    ja, ta = _x(8, 300, dt, seed=1)
    jb, tb = _x(8, 77, dt, seed=2)
    jb, tb = jb.reshape(8, 7, 11), tb.reshape(8, 7, 11)
    for lp in (False, True):
        want = np.asarray(jdp.sketch_tree([ja, jb], k, lp))
        _close(tdp.sketch_tree([ta, tb], k).numpy(), want)
    _close(tdp.sketch_tree(ta, k).numpy(), np.asarray(jdp.sketch_tree(ja, k)))


def test_sketch_tree_goes_through_ops(monkeypatch):
    calls = []

    def spy(x, k, salt=0):
        calls.append((tuple(x.shape), k, salt))
        return ref.countsketch_ref(x, k, salt)

    monkeypatch.setattr(ops, "countsketch", spy)
    tdp.sketch_tree([torch.ones(4, 10), torch.ones(4, 2, 3)], 8)
    assert calls == [((4, 10), 8, 0), ((4, 6), 8, 1)]


def test_countsketch_cuda_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        countsketch_cuda(torch.ones(4, 8), 4)


@pytest.mark.parametrize("m,d,k,want", [
    (32, 2 ** 20, 4096, 1),      # the main path: m·k outputs fill the card
    (17, 555, 8, 3),             # 70 terms in chunks of 24
    (16, 16, 4096, 1),           # one term each
    (32, 2 ** 20, 8, 512),       # 131,072 terms in chunks of 256
])
def test_chunking_depends_on_the_shape_only(m, d, k, want):
    assert n_chunks(m, d, k) == want
