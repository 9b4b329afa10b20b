"""The port's serving path (``models.attention``'s KV caches and decode,
``models.model``'s ``prefill``/``init_cache``/``decode_step``,
``distributed.trainer.build_serve_step``, ``launch.serve`` and
``convert``'s cache carriers) for the dense decoder against the JAX
package's, on the CPU (the Mamba cache: ``tests/test_torch_ssm.py``).

Sizes: internlm2-1.8b ``reduced(max_d_model=64)`` (2 layers, vocab 512;
its caches in f32, the reduced config's activation dtype, and int8), and
starcoder2-3b ``reduced()`` (window 32) whose prompt of 40 fills the ring
past its size before decode wraps it again.  Weights are the JAX
package's ``init(PRNGKey(0))`` carried over by ``convert``; the prompt
comes from a numpy seed.  Tolerances: logits and f32 caches within 1e-4
relative (‖got − want‖ ≤ tol·‖want‖ + tol: the same f32 products in
another order), int8 cache values and their f16 scales within the same
bound, ``pos`` and every greedy token exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed.trainer import build_serve_step as jbuild_serve_step
from repro.launch.serve import run_serving as jrun_serving
from repro.models.model import build_model as jbuild
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.distributed.trainer import build_serve_step
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models.model import _group_cache
from repro_torch.models.model import build_model as tbuild

TOL = 1e-4
B = 2


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    assert err <= tol * np.linalg.norm(want) + tol, (err, np.linalg.norm(want))


def _configs():
    jbase = jget_config("internlm2-1.8b").reduced(max_d_model=64)
    tbase = get_config("internlm2-1.8b").reduced(max_d_model=64)
    return {
        # name: (jax cfg, port cfg, prompt length, cache_len, decode steps)
        "kv": (jbase, tbase, 12, 24, 16),          # fills past 24: a full cache wraps
        "int8": (dataclasses.replace(jbase, kv_cache_dtype="int8"),
                 dataclasses.replace(tbase, kv_cache_dtype="int8"), 12, 32, 6),
        "swa_ring": (jget_config("starcoder2-3b").reduced(),
                     get_config("starcoder2-3b").reduced(), 40, 64, 6),
    }


CONFIGS = _configs()


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for name, (jcfg, tcfg, *_) in CONFIGS.items():
        jm = jbuild(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = tbuild(tcfg, device="cpu")
        tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        out[name] = (jm, jp, tm, tp)
    return out


def _prompt(cfg, S, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S), dtype=np.int32)


def _assert_caches_close(tcache, jcache):
    want = convert.kv_cache_to_numpy(convert.kv_cache_from_numpy(
        jax.tree_util.tree_map(np.asarray, jcache), "cpu"))
    got = convert.kv_cache_to_numpy(tcache)
    assert len(got["layers"]) == len(want["layers"])
    for g, w in zip(got["layers"], want["layers"]):
        assert g.keys() == w.keys()
        np.testing.assert_array_equal(g["pos"], w["pos"])
        for f in g:
            assert g[f].shape == w[f].shape, f
            _close(g[f], w[f])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_and_decode_match_jax(pairs, name):
    jm, jp, tm, tp = pairs[name]
    jcfg, tcfg, S, L, steps = CONFIGS[name]
    prompt = _prompt(tcfg, S)
    jlog, jcache = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=L))(
        jp, {"tokens": jnp.asarray(prompt)})
    tlog, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)}, cache_len=L)
    assert tlog.shape == (B, 1, tcfg.vocab_size)
    _close(tlog, jlog)
    _assert_caches_close(tcache, jcache)
    jdecode = jax.jit(jm.decode_step)
    tok = np.array(jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32))
    for _ in range(steps):
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(tok))
        tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok))
        _close(tlog, jlog)
        _assert_caches_close(tcache, jcache)
        tok = np.array(jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32))
    assert int(tcache["layers"][0].pos[0]) == S + steps


def test_jax_cache_carried_into_the_port_decodes_as_jax(pairs):
    """A JAX prefill cache through ``kv_cache_from_numpy``: the port's
    ``build_serve_step`` takes the greedy tokens JAX's serve step takes."""
    jm, jp, tm, tp = pairs["int8"]
    _, tcfg, S, L, steps = CONFIGS["int8"]
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(_prompt(tcfg, S, seed=5))},
                              cache_len=L)
    tcache = convert.kv_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache), "cpu")
    assert isinstance(tcache["layers"][0], tattn.QuantKVCache)
    jstep, tstep = jax.jit(jbuild_serve_step(jm)), build_serve_step(tm)
    jtok = jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32)
    ttok = torch.from_numpy(np.array(jtok))
    for _ in range(steps):
        jtok, jcache = jstep(jp, jcache, jtok)
        ttok, tcache = tstep(tp, tcache, ttok)
        assert ttok.dtype == torch.int32
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("name", ["kv", "int8", "swa_ring"])
def test_init_cache_then_decode_matches_jax(pairs, name):
    """Empty caches (``swa`` sized min(length, window)) and 40 decode steps
    of token 0, past a window of 32 (``tests/test_arch_smoke.py``'s ring
    case): logits within 1e-4 and pos 40 at the end."""
    jm, jp, tm, tp = pairs[name]
    length, steps = 32, 40 if name == "swa_ring" else 8
    jcache = jm.init_cache(B, length, jnp.float32)
    tcache = tm.init_cache(B, length, torch.float32)
    _assert_caches_close(tcache, jcache)
    jdecode = jax.jit(jm.decode_step)
    tok = np.zeros((B, 1), np.int32)
    for _ in range(steps):
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(tok))
        tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok))
    _close(tlog, jlog)
    _assert_caches_close(tcache, jcache)
    assert int(tcache["layers"][0].pos[0]) == steps


def test_quantize_and_ring_packing_match_jax():
    from repro.models import attention as jattn
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(2, 9, 3, 16)) * np.array([1e-3, 1.0, 40.0])[:, None]).astype(
        np.float32)
    x[0, 0] = 0.0   # an all-zero head: the 1e-8 floor on the scale
    jq, js = jattn._quantize(jnp.asarray(x))
    tq, ts = tattn._quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    pos = np.int32(9)
    for length in (4, 9, 12):
        for quant in (False, True):
            want = jattn.cache_from_prefill(jnp.asarray(x), jnp.asarray(-x), length,
                                            jnp.asarray(pos), quantize=quant)
            got = tattn.cache_from_prefill(torch.from_numpy(x), torch.from_numpy(-x), length,
                                           torch.tensor(pos), quantize=quant)
            assert type(got).__name__ == type(want).__name__
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_mla_and_mamba_caches_raise_naming_the_roadmap():
    """The MLA cache still raises; the Mamba cache, which raised before it
    was ported, is two zero MambaCaches stacked on the group's layer axis
    (held to the JAX package's in ``tests/test_torch_ssm.py``)."""
    from repro_torch.configs.base import BlockSpec
    cfg = get_config("internlm2-1.8b").reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _group_cache(BlockSpec(mixer="mla", ff="mlp", count=2), cfg, 1, 8, torch.float32, "cpu")
    mcfg = get_config("mamba2-130m").reduced()
    cache = _group_cache(BlockSpec(mixer="mamba", ff="none", count=2), mcfg, 1, 8,
                         torch.float32, "cpu")
    assert type(cache).__name__ == "MambaCache" and cache.state.shape[:2] == (2, 1)
    assert cache.state.dtype == torch.float32 and not any(bool(t.any()) for t in cache)


def test_run_serving_tokens_are_jaxs(tmp_path, capsys):
    kw = dict(batch=2, prompt_len=16, gen_tokens=6, cache_len=24, seed=1)
    want = np.asarray(jrun_serving("internlm2-1.8b", **kw))
    trace = tmp_path / "serve.jsonl"
    got = tserve.run_serving("internlm2-1.8b", device="cpu", trace=str(trace), **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), want)
    assert got.tokens.dtype == torch.int32 and got.peak_bytes is None
    assert got.ms_per_token > 0 and got.tokens_per_s > 0
    text = trace.read_text()
    for name in ("serve/prefill", "serve/decode", "serve/throughput"):
        assert name in text
    assert "sample:" in capsys.readouterr().out


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--arch", "internlm2-1.8b", "--batch", "1", "--prompt-len", "8", "--tokens",
                 "3", "--cache-len", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "ms/tok" in out and "sample:" in out
