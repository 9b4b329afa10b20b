"""The port's fault plans (``repro_torch.scenarios.faults``) and the
random draws they make (``repro_torch.prng.fold_in``/``uniform``/
``randint``) against the JAX package and live ``jax.random``.

Given the same key, ``apply_fault_plan`` is bit-equal to JAX's in all five
modes, f32 and bf16.  One documented difference: XLA on the CPU turns a
bf16 NaN that a bit flip made into the canonical NaN of its sign, where
the port keeps the payload, so bf16 NaNs are compared by position.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.scenarios import faults as jfaults
from repro_torch import prng
from repro_torch.scenarios import faults

M, D = 8, 257
DTYPES = {"f32": (jnp.float32, torch.float32, np.uint32, torch.int32),
          "bf16": (jnp.bfloat16, torch.bfloat16, np.uint16, torch.int16)}


def _plans(name, **kw):
    return jfaults.make_fault_plan(name, **kw), faults.make_fault_plan(name, **kw)


@pytest.mark.parametrize("name", jfaults.FAULT_TABLE)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_apply_fault_plan_matches_jax(name, dt):
    jdt, tdt, ubits, tbits = DTYPES[dt]
    rng = np.random.default_rng(3)
    g = rng.normal(size=(M, D)).astype(np.float32)
    rank = rng.permutation(M)
    jp, tp = _plans(name, frac=0.3, start_step=2, period=3)
    hits = 0
    for k in range(8):
        jkey = jax.random.fold_in(jax.random.PRNGKey(k), jfaults.FAULT_KEY_TAG)
        tkey = prng.fold_in(prng.PRNGKey(k), faults.FAULT_KEY_TAG)
        want = np.asarray(jfaults.apply_fault_plan(
            jp, jkey, jnp.asarray(g).astype(jdt), jnp.asarray(rank), jnp.int32(k)))
        got = faults.apply_fault_plan(tp, tkey, torch.from_numpy(g).to(tdt),
                                      torch.from_numpy(rank), k)
        assert got.dtype == tdt
        wbits, gbits = want.view(ubits), got.view(tbits).numpy().view(ubits)
        wnan, gnan = np.isnan(want.astype(np.float32)), torch.isnan(got).numpy()
        np.testing.assert_array_equal(gnan, wnan)
        if dt == "f32":
            np.testing.assert_array_equal(gbits, wbits)
        else:
            np.testing.assert_array_equal(gbits[~gnan], wbits[~wnan])
        hits += int((gbits != torch.from_numpy(g).to(tdt).view(tbits).numpy().view(ubits)).any())
    # steps 2 and 5 fire (start 2, period 3), and only they
    assert hits == (0 if name == "none" else 2)


def test_fault_modes_poison_as_described():
    g = torch.ones(M, D)
    rank = torch.arange(M)
    key = prng.PRNGKey(0)
    nan = faults.apply_fault_plan(faults.fault_nan_rows(0.25), key, g, rank, 0)
    assert torch.isnan(nan[6:]).all() and torch.isfinite(nan[:6]).all()
    inf = faults.apply_fault_plan(faults.fault_inf_rows(0.25), key, g, rank, 0)
    assert (inf[7, ::2] == float("inf")).all() and (inf[7, 1::2] == float("-inf")).all()
    garbage = faults.apply_fault_plan(faults.fault_garbage(0.25, magnitude=1e30), key, g,
                                      rank, 0)
    assert torch.isfinite(garbage).all() and float(garbage.abs().max()) > 1e28
    assert (garbage[6:, 1::4] == 1).all() and (garbage[:6] == 1).all()
    flip = faults.apply_fault_plan(faults.fault_bitflip(0.25), key, g, rank, 0)
    changed = (flip.view(torch.int32) ^ g.view(torch.int32))[6:]
    # exactly one bit of every affected element
    assert (torch.bitwise_and(changed, changed - 1) == 0).all() and (changed != 0).all()


def test_fault_none_is_the_identity_and_table_ids():
    g = torch.randn(M, D)
    for k in range(4):
        assert faults.apply_fault_plan(faults.fault_none(), prng.PRNGKey(k), g,
                                       torch.arange(M), k) is g
        assert not faults.fault_rows(faults.fault_none(), torch.arange(M), k).any()
    assert faults.FAULT_TABLE == jfaults.FAULT_TABLE
    assert faults.FAULT_KEY_TAG == jfaults.FAULT_KEY_TAG
    for i, name in enumerate(faults.FAULT_TABLE):
        assert faults.fault_id(name) == i
    with pytest.raises(KeyError, match="unknown"):
        faults.fault_id("rowhammer")
    for plan in (None, faults.fault_nan_rows(0.1)):
        jplan = None if plan is None else jfaults.fault_nan_rows(0.1)
        assert faults.fault_knobs(plan) == jfaults.fault_knobs(jplan)


@pytest.mark.parametrize("frac", [0.0, 0.1, 0.125, 0.25, 0.3, 1 / 3, 0.5])
def test_fault_rows_schedule_matches_jax(frac):
    for m in (3, 8, 32):
        rank = np.random.default_rng(m).permutation(m)
        jp, tp = _plans("inf_rows", frac=frac, start_step=3, period=2)
        assert faults.n_faulty(tp, m) == int(jfaults.n_faulty(jp, m))
        for k in range(9):
            np.testing.assert_array_equal(
                faults.fault_rows(tp, torch.from_numpy(rank), k).numpy(),
                np.asarray(jfaults.fault_rows(jp, jnp.asarray(rank), jnp.int32(k))))


def test_schedule_and_top_rank_victims():
    plan = faults.fault_nan_rows(0.25, start_step=3, period=2)
    rank = torch.arange(M)
    assert not faults.fault_rows(plan, rank, 2).any()
    assert faults.fault_rows(plan, rank, 3).tolist() == [False] * 6 + [True] * 2
    assert not faults.fault_rows(plan, rank, 4).any()
    assert faults.fault_rows(plan, rank, 5).any()


# ------------------------------------------------------------- prng

@pytest.mark.parametrize("seed", [0, 5, 2 ** 32 - 1])
def test_fold_in_matches_jax(seed):
    for data in (0, 1, 7919, faults.FAULT_KEY_TAG, 2 ** 32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(prng.PRNGKey(seed), data).numpy(),
            np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data)).astype(np.int64))


@pytest.mark.parametrize("shape", [(8, 257), (32, 64), (5,)])
@pytest.mark.parametrize("bounds", [(-1.0, 1.0), (0.0, 1.0), (2.5, 3.0)])
def test_uniform_matches_jax(shape, bounds):
    for seed in (0, 9):
        want = jax.random.uniform(jax.random.PRNGKey(seed), shape, jnp.float32, *bounds)
        got = prng.uniform(prng.PRNGKey(seed), shape, *bounds)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(8, 257), (32, 64)])
@pytest.mark.parametrize("bounds", [(0, 16), (0, 32), (0, 7), (-5, 1000)])
def test_randint_matches_jax(shape, bounds):
    for seed in (0, 9):
        want = jax.random.randint(jax.random.PRNGKey(seed), shape, *bounds, jnp.int32)
        got = prng.randint(prng.PRNGKey(seed), shape, *bounds)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
