"""The port's CountSketch against the JAX package's, on the CPU.

The same numpy-made inputs go through the JAX package's ``countsketch_ref``,
``countsketch_pallas`` (interpret mode) and the dp guard's ``sketch_tree``,
and through the port's ``countsketch_ref``, ``ops.countsketch`` (a CPU
tensor runs the plain version) and ``sketch_tree``.  The hashed signs are
bit-equal; the sketches, f32 sums taken in another order, agree within
rtol 1e-5 and atol 1e-6.  Inputs have the scale of gradient deviations
(entries ~ 1/√d), so the sums are O(1) and the atol is a bound on rounding,
not on the values.

The CUDA kernel's launch plan (``launch_plan``) is held here too: its
tiles, walked as ``csrc/countsketch.cu`` walks them, sum every (row,
bucket, term) exactly once; the main path's shape takes the 16-byte vector
path with no scratch, and a shape that a vector would not fit takes the
scalar loads; the plan is a function of the shape, dtype and alignment.
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
from repro_torch.kernels.countsketch import SketchPlan, countsketch_cuda, launch_plan

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


def _coverage(m, d, k, plan):
    """How many times the kernel's tiling sums each (row, bucket, term j),
    walked block by block and lane by lane as ``csrc/countsketch.cu`` does:
    grid (ceil(k / (lanes·v)), ceil(m / rows), chunks); warp q takes the
    block's terms from q·warp_terms on; lane (b, t) the bucket vector b and
    every (32 / lanes)-th of the warp's terms from t on."""
    n_terms = -(-d // k)
    lt, nb = 32 // plan.lanes, plan.lanes * plan.v
    hits = np.zeros((m, k, n_terms), np.uint8)
    for z in range(plan.chunks):
        jb = z * plan.chunk_terms
        for q in range(plan.warps):
            j0 = jb + q * plan.warp_terms
            j1 = min(j0 + plan.warp_terms, jb + plan.chunk_terms, n_terms)
            for lane in range(32):
                terms = np.arange(j0 + lane // plan.lanes, j1, lt)
                for bx in range(-(-k // nb)):
                    c0 = bx * nb + lane % plan.lanes * plan.v
                    if c0 >= k or not len(terms):
                        continue
                    cols = np.arange(c0, min(c0 + plan.v, k))
                    in_x = (cols[:, None] + terms[None, :] * k) < d
                    for r0 in range(0, m, plan.rows):
                        rows = np.arange(r0, min(r0 + plan.rows, m))
                        hits[np.ix_(rows, cols, terms)] += in_x[None].astype(np.uint8)
    return hits


# (m, d, k, dtype): the main path's shape, k not dividing d, k > d, k = d,
# k = 63 and 5 (scalar), d < V, a small k whose terms are cut into chunks,
# row tiles cut short (m = 17, 33)
PLAN_SHAPES = [(32, 2 ** 20, 4096, torch.bfloat16), (32, 2 ** 20, 4096, torch.float32),
               (17, 555, 8, torch.bfloat16), (16, 16, 4096, torch.float32),
               (8, 4096, 4096, torch.bfloat16), (33, 4099, 63, torch.bfloat16),
               (17, 1000, 5, torch.float32), (3, 3, 8, torch.bfloat16),
               (32, 2 ** 17, 8, torch.bfloat16), (33, 2 ** 12, 64, torch.float32)]


@pytest.mark.parametrize("m,d,k,dtype", PLAN_SHAPES)
def test_plan_tiles_cover_every_term_once(m, d, k, dtype):
    plan = launch_plan(m, d, k, dtype, aligned=True)
    terms = np.arange(-(-d // k))
    want = (np.arange(k)[:, None] + terms[None, :] * k) < d
    np.testing.assert_array_equal(_coverage(m, d, k, plan), np.broadcast_to(want, (m, *want.shape)))
    n_terms = -(-d // k)
    assert plan.chunks * plan.chunk_terms >= n_terms > (plan.chunks - 1) * plan.chunk_terms
    assert plan.warps * plan.warp_terms >= plan.chunk_terms


@pytest.mark.parametrize("dtype,v", [(torch.bfloat16, 8), (torch.float32, 4)])
def test_main_shape_takes_the_vector_path_without_scratch(dtype, v):
    plan = launch_plan(32, 2 ** 20, 4096, dtype, aligned=True)
    assert plan == SketchPlan(vec=True, v=v, rows=4, warps=8, lanes=32, chunks=1,
                              chunk_terms=256, warp_terms=32, wide=False)


@pytest.mark.parametrize("m,d,k,dtype,aligned", [
    (32, 2 ** 20, 4092, torch.bfloat16, True),   # k % 8 != 0 at bf16
    (32, 2 ** 20, 4090, torch.float32, True),    # k % 4 != 0 at f32
    (32, 2 ** 20 + 1, 4096, torch.bfloat16, True),  # odd d: rows not 16-byte aligned
    (32, 2 ** 20 + 2, 4096, torch.float32, True),   # d·4 % 16 != 0
    (32, 2 ** 20, 4096, torch.bfloat16, False),  # x itself not 16-byte aligned
    (4, 3, 8, torch.bfloat16, True),             # d < V
])
def test_scalar_path_where_a_vector_does_not_fit(m, d, k, dtype, aligned):
    plan = launch_plan(m, d, k, dtype, aligned)
    assert not plan.vec
    assert plan._replace(vec=True) == launch_plan(m, d, k, dtype, True)._replace(vec=True)


@pytest.mark.parametrize("shape,want", [
    # the main path: the blocks' warps fill the card
    ((32, 2 ** 20, 4096, torch.bfloat16), dict(warps=8, lanes=32, chunks=1)),
    # a small fold at tiny d: one warp, lanes on terms, no scratch
    ((17, 555, 8, torch.float32), dict(warps=1, lanes=2, chunks=1)),
    # one term each (k > d)
    ((16, 16, 4096, torch.bfloat16), dict(warps=1, lanes=32, chunks=1, chunk_terms=1)),
    # 131,072 terms of 8 buckets: 16 chunks through scratch
    ((32, 2 ** 20, 8, torch.bfloat16), dict(warps=8, lanes=1, chunks=16, chunk_terms=8192,
                                            warp_terms=1024)),
    # k = 64 at f32: 16 bucket vectors, lanes split between buckets and terms
    ((8, 4099, 64, torch.float32), dict(warps=4, lanes=16, chunks=1, warp_terms=17)),
    # d + k past 2^32: 64-bit offsets inside a row
    ((1, 2 ** 32, 4096, torch.bfloat16), dict(wide=True, vec=True)),
])
def test_chunking_depends_on_the_shape_only(shape, want):
    m, d, k, dtype = shape
    plan = launch_plan(m, d, k, dtype, aligned=True)
    assert {f: getattr(plan, f) for f in want} == want
    assert launch_plan(m, d, k, dtype, aligned=True) == plan   # a pure function
