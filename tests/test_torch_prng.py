"""The port's key chain against Random123 and live ``jax.random``.

``repro_torch.prng`` must give ``jax.random``'s bits for PRNGKey, split and
permutation, and the port's threefry/noise terms must equal the JAX
package's ``gradgen`` bit for bit: that is what lets the port rebuild the
reference's trajectory from the same seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solver import byz_rank as jax_byz_rank
from repro.kernels import gradgen as jax_gradgen
from repro_torch import prng
from repro_torch.core.solver import byz_rank
from repro_torch.kernels import gradgen

# Random123 v1.09 known-answer vectors for threefry2x32, 20 rounds:
# (ctr0, ctr1, key0, key1) -> (out0, out1)
_KAT = [
    ((0x00000000, 0x00000000, 0x00000000, 0x00000000),
     (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xC4923A9C, 0x483DF7A0)),
]


def _t(v):
    return torch.tensor(v, dtype=torch.int64)


@pytest.mark.parametrize("inputs,want", _KAT)
def test_threefry_random123_kat(inputs, want):
    c0, c1, k0, k1 = inputs
    x0, x1 = gradgen.threefry2x32(_t(k0), _t(k1), _t(c0), _t(c1))
    assert (int(x0), int(x1)) == want


def test_threefry_matches_jax_prng():
    from jax._src import prng as jax_prng

    key = jnp.asarray([0xDEADBEEF, 0x12345678], jnp.uint32)
    n = 64
    want = np.asarray(jax_prng.threefry_2x32(key, jnp.arange(n, dtype=jnp.uint32)))
    counts = torch.arange(n, dtype=torch.int64)
    x0, x1 = gradgen.threefry2x32(_t(0xDEADBEEF), _t(0x12345678),
                                  counts[: n // 2], counts[n // 2:])
    np.testing.assert_array_equal(torch.cat([x0, x1]).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 7, 19, 2 ** 32 - 1])
def test_prngkey_and_split_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    for n in (2, 3, 8, 33):
        np.testing.assert_array_equal(
            prng.split(tk, n).numpy(), np.asarray(jax.random.split(jk, n)).astype(np.int64))
    # a chain of splits, as run_sgd walks it
    for _ in range(3):
        jk, tk = jax.random.split(jk)[1], prng.split(tk)[1]
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))


@pytest.mark.parametrize("m", [1, 2, 5, 8, 32, 64, 2000])
def test_permutation_and_byz_rank_match_jax(m):
    for seed in range(0, 20, 3):
        jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        np.testing.assert_array_equal(prng.permutation(tk, m).numpy(),
                                      np.asarray(jax.random.permutation(jk, m)))
        np.testing.assert_array_equal(byz_rank(tk, m).numpy(),
                                      np.asarray(jax_byz_rank(jk, m)))


def test_prngkey_rejects_wide_seed():
    with pytest.raises(ValueError):
        prng.PRNGKey(2 ** 32)


def test_noise_terms_match_jax_gradgen():
    key = jax.random.PRNGKey(5)
    wk = jax.random.split(key, 4)
    kd = np.asarray(wk).astype(np.int64)
    j = np.arange(1000)
    want_bits = np.stack([np.asarray(jax_gradgen.noise_bits(w[0], w[1], jnp.asarray(j, jnp.uint32)))
                          for w in wk]).astype(np.int64)
    tkd = torch.from_numpy(kd)
    bits = gradgen.noise_bits(tkd[:, 0:1], tkd[:, 1:2], torch.from_numpy(j)[None, :])
    np.testing.assert_array_equal(bits.numpy(), want_bits)
    scale = np.float32(1.0) / np.sqrt(np.float32(1000))
    want = np.stack([np.asarray(jax_gradgen.noise_row(w, jnp.asarray(j, jnp.uint32), scale))
                     for w in wk])
    got = gradgen.noise_row(tkd[:, 0:1], tkd[:, 1:2], torch.from_numpy(j)[None, :], float(scale))
    np.testing.assert_array_equal(got.numpy(), want)
    u = gradgen.centered_uniform(bits)
    assert float(u.abs().max()) < 1.0
