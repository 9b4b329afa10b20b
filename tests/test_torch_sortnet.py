"""The order statistics' sorting network.

``csrc/sort_network.cuh`` sorts each column of the register path (m <= 32)
with Batcher's odd-even merge sort, unrolled at compile time;
:func:`batcher_network` below is the same loop in Python.  On the CPU the
Python network is held to the 0-1 principle, to ``torch.sort`` on random
columns, to Batcher's comparator count and to reachability (every input
reaches every output, which is what turns a column holding a NaN to NaN).
Then the kernel's arithmetic, mirrored in numpy f32 — the network with
NaN-propagating min/max, the kept window summed in order from −0, divided
by its width — is held to the JAX package's Pallas kernels in interpret
mode on inputs with NaN and ±Inf: the median bit for bit (NaNs by
position), the trimmed mean within 1e-6.  On a card (marked ``cuda``),
the network the kernels unroll, as ``rt_sort_network`` hands it to the
host, equals :func:`batcher_network` at every m.  The file imports JAX
only inside the test that calls the Pallas kernels, so that the card test
also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_sortnet.py
"""
import ctypes
import itertools

import numpy as np
import pytest
import torch


def batcher_network(m: int) -> list[tuple[int, int]]:
    """The comparators (lo, hi) of Batcher's odd-even merge sort on m
    wires, in order: ``sortnet::batcher`` of ``csrc/sort_network.cuh``
    written as the same four loops.  Built on the next power of two >= m,
    keeping the comparators whose upper wire is below m (all ascending, so
    the dropped wires act as +Inf pads); 191 comparators at m = 32."""
    out = []
    p = 1
    while p < m:
        k = p
        while k >= 1:
            j = k % p
            while j + k < m:
                i = 0
                while i < k and i + j + k < m:
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        out.append((i + j, i + j + k))
                    i += 1
                j += 2 * k
            k >>= 1
        p <<= 1
    return out


def apply_network(m: int, x: np.ndarray) -> np.ndarray:
    """Each column of the (m, n) array x sorted by the network, with
    NaN-propagating min/max as the kernel's min.NaN/max.NaN."""
    rows = [x[i].copy() for i in range(m)]
    for lo, hi in batcher_network(m):
        a, b = rows[lo], rows[hi]
        rows[lo], rows[hi] = np.minimum(a, b), np.maximum(a, b)
    return np.stack(rows)


def mirror_window_mean(x: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """The kernel's result in f32: sort, sum the kept rows lo .. hi−1 in
    order from −0, divide by hi − lo."""
    s = apply_network(x.shape[0], x.astype(np.float32))
    acc = np.full(x.shape[1], -0.0, dtype=np.float32)
    with np.errstate(invalid="ignore"):     # Inf − Inf is NaN, as on the card
        for i in range(lo, hi):
            acc = acc + s[i]
    return acc / np.float32(hi - lo)


@pytest.mark.parametrize("m", range(1, 17))
def test_network_sorts_every_zero_one_vector(m):
    """0-1 principle: a comparator network that sorts every 0/1 input
    sorts every input."""
    x = np.array(list(itertools.product((0, 1), repeat=m)), dtype=np.int8).T
    s = apply_network(m, x)
    assert np.array_equal(s, np.sort(x, axis=0))


@pytest.mark.parametrize("m", range(1, 33))
def test_network_sorts_random_columns_as_torch_sort(m):
    rng = np.random.default_rng(m)
    # real values, and small integers (many ties)
    for x in (rng.standard_normal((m, 257)).astype(np.float32),
              rng.integers(-3, 4, size=(m, 257)).astype(np.float32)):
        want = torch.sort(torch.from_numpy(x), dim=0).values.numpy()
        assert np.array_equal(apply_network(m, x), want)


def test_network_size_is_batchers():
    """(k² − k + 4)·2^(k−2) − 1 comparators on m = 2^k wires: 191 at
    m = 32, against the 496 of odd-even transposition; every comparator
    ascending."""
    for k in range(1, 6):
        assert len(batcher_network(2 ** k)) == (k * k - k + 4) * 2 ** (k - 2) - 1
    assert len(batcher_network(32)) == 191
    assert batcher_network(1) == []
    for m in range(1, 33):
        assert all(0 <= lo < hi < m for lo, hi in batcher_network(m))


@pytest.mark.parametrize("m", range(1, 33))
def test_every_input_reaches_every_output(m):
    """A NaN entering any wire reaches every output wire."""
    reach = [1 << i for i in range(m)]
    for lo, hi in batcher_network(m):
        reach[lo] = reach[hi] = reach[lo] | reach[hi]
    assert reach == [(1 << m) - 1] * m


def _poisoned(m: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    # one NaN in each row position in turn, and ±Inf, in columns of their own
    for r in range(m):
        x[r, 3 + r] = np.nan
        x[r, 40 + r] = np.inf
        x[(r + 1) % m, 40 + r] = -np.inf if m > 1 else np.inf
        x[r, 80 + r] = -np.inf
    x[m - 1, d - 1] = np.nan
    return x


def _same_bits_nan_by_position(got: np.ndarray, want: np.ndarray) -> None:
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))


@pytest.mark.parametrize("m", [1, 2, 17, 32])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mirror_matches_the_pallas_order_statistics(m, dt):
    import jax.numpy as jnp
    from repro.kernels.robust_reduce import coordinate_median_pallas, trimmed_mean_pallas

    x = _poisoned(m, 301, seed=m)
    xj = jnp.asarray(x, dtype=jnp.float32 if dt == "f32" else jnp.bfloat16)
    x32 = np.asarray(xj.astype(jnp.float32))    # the exact upcast both sides sort
    want = np.asarray(coordinate_median_pallas(xj, d_block=128, interpret=True))
    got = mirror_window_mean(x32, (m - 1) // 2, m // 2 + 1)
    _same_bits_nan_by_position(got, want)
    for n_trim in sorted({0, (m - 1) // 2, min(8, (m - 1) // 2)}):
        want = np.asarray(trimmed_mean_pallas(xj, n_trim, d_block=128, interpret=True))
        got = mirror_window_mean(x32, n_trim, m - n_trim)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_kernel_network_is_the_python_mirror():
    """``rt_sort_network`` evaluates on the host the constexpr network the
    kernels unroll; it equals ``batcher_network`` at every m."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc there)")
    from repro_torch.kernels import _build
    fn = _build.load_function("sorted_reduce", "rt_sort_network",
                              [ctypes.c_int64, ctypes.c_void_p])
    for m in range(1, 33):
        net = batcher_network(m)
        pairs = (ctypes.c_int32 * (2 * max(len(net), 1)))()
        assert fn(m, pairs) == len(net)
        assert [(pairs[2 * t], pairs[2 * t + 1]) for t in range(len(net))] == net
    assert fn(0, None) == -1 and fn(33, None) == -1
    assert fn(32, None) == 191
