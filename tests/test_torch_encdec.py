"""The port's encoder-decoder and frontends (``repro_torch.models.
attention``'s ``encoder_attn_apply``, ``cross_attn_apply``,
``project_memory``; ``models.model``'s encoder, cross attention and
frontend prefix; ``convert``'s ``memory_kv``; the launchers' frontends)
and ``prng.normal`` in bfloat16, against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed; both packages run on the CPU.  Sizes:
seamless-m4t-large-v2 ``reduced(max_d_model=64)`` (2 decoder and 2
encoder layers, 4 heads of 16, 64 frames of 64, vocab 512) and
internvl2-76b ``reduced(max_d_model=64)`` (2 layers, 4 heads over 4 KV
heads, 16 patches of 64 before the tokens); ``run_serving`` at its
``reduced()`` widths.  Tolerances (``tests/test_torch_lm_model.py``'s): a
layer within 1e-5 relative (‖got − want‖ ≤ tol·‖want‖ + tol), the model's
hidden states, loss, gradient tree, logits and caches within 1e-4, but
seamless's gradient tree within 2e-3 (as starcoder2's in
``tests/test_torch_lm_model.py``): its encoder and cross attention
amplify f32 rounding, and JAX's own f32 gradient sits up to 4.9e-4 from
the same function taken in f64 (the port's 3.4e-4);
greedy tokens, the frontend prefix and every filter decision exactly
equal; ``prng.normal`` in bf16 bit for bit (its uniform takes 128 values,
and at every one the port's f32 ``erf_inv`` rounds to jax's bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.serve import run_serving as jrun_serving
from repro.launch.train import run_training as jrun_training
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models.model import build_model as jbuild
from repro_torch import convert, prng, utils
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models.model import build_model as tbuild

REL, MODEL_TOL = 1e-5, 1e-4
ARCHS = ("seamless-m4t-large-v2", "internvl2-76b")
DECISIONS = ("n_alive", "byz_alive", "good_filtered", "n_byz")
GRAD_TOL = {"seamless-m4t-large-v2": 2e-3, "internvl2-76b": MODEL_TOL}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread: torch splits a CPU reduction by its thread team."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=REL):
    got = np.asarray(got.detach().double() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    assert err <= tol * np.linalg.norm(want) + tol, (err, np.linalg.norm(want))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jm = jbuild(jget_config(arch).reduced(max_d_model=64))
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        tm = tbuild(get_config(arch).reduced(max_d_model=64), device="cpu")
        out[arch] = (jm, jp, tm, convert.params_from_numpy(_np_tree(jp), "cpu"))
    return out


def _batch(cfg, seed, B=2, S=12):
    rng = np.random.default_rng(seed)
    fseq = cfg.enc_seq_len if cfg.enc_dec else cfg.frontend_seq
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "frontend": (0.02 * rng.normal(size=(B, fseq, cfg.frontend_dim))).astype(np.float32)}


def test_encoder_cross_attention_and_memory_match_jax():
    """The three encoder-decoder functions on one layer's weights (the
    cross attention's with as many KV heads as heads, as the model builds
    them) and a memory of another length than the queries."""
    jcfg = jget_config(ARCHS[0]).reduced(max_d_model=64)
    tcfg = get_config(ARCHS[0]).reduced(max_d_model=64)
    defs = jattn.attn_defs(dataclasses.replace(jcfg, n_kv_heads=jcfg.n_heads))
    p = _np_tree(jax.jit(lambda k: jcommon.init_params(k, defs, jnp.float32))(
        jax.random.PRNGKey(2)))
    tp = convert.params_from_numpy(p, "cpu")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 10, tcfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, 70, tcfg.d_model)).astype(np.float32)
    pos = np.arange(70, dtype=np.int32)
    _close(tattn.encoder_attn_apply(tp, tcfg, torch.from_numpy(mem), torch.from_numpy(pos)),
           jax.jit(jattn.encoder_attn_apply, static_argnums=(1,))(p, jcfg, mem, pos))
    jk, jv = jattn.project_memory(p, jnp.asarray(mem))
    k, v = tattn.project_memory(tp, torch.from_numpy(mem))
    _close(k, jk)
    _close(v, jv)
    _close(tattn.cross_attn_apply(tp, tcfg, torch.from_numpy(x), k, v),
           jax.jit(jattn.cross_attn_apply, static_argnums=(1,))(p, jcfg, x, jk, jv))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_jax(models, arch):
    jm, jp, tm, tp = models[arch]
    cfg = tm.cfg
    batch = _batch(cfg, seed=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jh, jprefix = jax.jit(lambda p, b: jm.forward(p, b)[::2])(jp, jb)
    th, _, prefix = tm.forward(tp, tb)
    assert prefix == int(jprefix) == (0 if cfg.enc_dec else cfg.frontend_seq)
    assert th.shape == (2, 12 + prefix, cfg.d_model)
    _close(th, jh, MODEL_TOL)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(jp, jb)
    grads, (loss, _) = torch.func.grad_and_value(tm.loss_fn, has_aux=True)(tp, tb)
    _close(loss, jloss, MODEL_TOL)
    jl, tl = jax.tree_util.tree_leaves(jgrads), utils.tree_leaves(grads)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        _close(b, a, GRAD_TOL[arch])
    assert ("enc" in tp) == cfg.enc_dec and ("frontend_proj" in tp) == (not cfg.enc_dec)


@pytest.mark.parametrize("arch,cache_len", [(ARCHS[0], 48), (ARCHS[1], 48), (ARCHS[1], 24)])
def test_prefill_then_decode_match_jax(models, arch, cache_len):
    """Prefill (the frontend in the positions, or the encoder's memory
    projected a layer) into caches of ``cache_len``, then 6 decode steps:
    logits and caches within 1e-4, greedy tokens equal.  At 24 slots
    internvl2's 16 patches and 12 prompt tokens wrap the ring already, so
    decode no longer sees the first patches, in the JAX package as in the
    port (``ROADMAP.md`` §3)."""
    jm, jp, tm, tp = models[arch]
    batch = _batch(tm.cfg, seed=5)
    del batch["labels"]
    jlog, jcache = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=cache_len))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tlog, tcache = tm.prefill(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                              cache_len=cache_len)
    _close(tlog, jlog, MODEL_TOL)
    assert ("memory_kv" in tcache) == tm.cfg.enc_dec
    jdecode = jax.jit(jm.decode_step)
    tok = np.array(jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32))
    for _ in range(6):
        assert np.array_equal(torch.argmax(tlog[:, -1:], -1).numpy(), tok)
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(tok))
        tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok))
        _close(tlog, jlog, MODEL_TOL)
        tok = np.array(jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32))
    got, want = convert.kv_cache_to_numpy(tcache), _np_tree(jcache)
    for g, w in zip(got["layers"], want["layers"]):
        np.testing.assert_array_equal(g["pos"], np.asarray(w.pos))
        _close(g["k"], w.k, MODEL_TOL)
        _close(g["v"], w.v, MODEL_TOL)
    for g, w in zip(got.get("memory_kv", []), want.get("memory_kv", [])):
        _close(g[0], w[0], MODEL_TOL)
        _close(g[1], w[1], MODEL_TOL)


def test_memory_kv_through_convert_both_ways(models):
    """An encoder-decoder's JAX cache into the port and back: the
    ``memory_kv`` pairs and the layers' caches equal to JAX's arrays, and
    ``init_cache``'s zero memory of enc_seq_len a layer as JAX's."""
    jm, jp, tm, tp = models[ARCHS[0]]
    batch = {k: jnp.asarray(v) for k, v in _batch(tm.cfg, seed=6).items() if k != "labels"}
    _, jcache = jm.prefill(jp, batch, cache_len=16)
    tcache = convert.kv_cache_from_numpy(_np_tree(jcache), "cpu")
    assert len(tcache["memory_kv"]) == len(tm.cfg.layer_plan())
    back = convert.kv_cache_to_numpy(tcache)
    for g, w in zip(back["memory_kv"], jcache["memory_kv"]):
        np.testing.assert_array_equal(g[0], np.asarray(w[0]))
        np.testing.assert_array_equal(g[1], np.asarray(w[1]))
    for g, w in zip(back["layers"], jcache["layers"]):
        for f in g:
            np.testing.assert_array_equal(g[f], np.asarray(getattr(w, f)))
    jz, tz = jm.init_cache(2, 16), tm.init_cache(2, 16)
    assert [tuple(a.shape) for a in tz["memory_kv"][0]] == \
        [tuple(a.shape) for a in jz["memory_kv"][0]] == [(2, 2, 64, 4, 16)] * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_run_serving_tokens_are_jaxs(arch):
    """Both launchers' run_serving at the reduced widths: the weights, the
    prompt and the f32 frontend all from PRNGKey(1)."""
    kw = dict(batch=2, prompt_len=16, gen_tokens=6, cache_len=32, seed=1)
    want = np.asarray(jrun_serving(arch, **kw))
    got = tserve.run_serving(arch, device="cpu", verbose=False, **kw)
    assert got.tokens.shape == want.shape == (2, 6)
    np.testing.assert_array_equal(got.tokens.numpy(), want)


@pytest.mark.parametrize("seed,shape,offset", [(0, (1 << 16,), 0), (7, (3, 5, 7), 0),
                                               (11, (4, 33), 100)])
def test_normal_in_bf16_is_jaxs_bit_for_bit(seed, shape, offset):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    tkey = prng.fold_in(prng.PRNGKey(seed), 3)
    n = int(np.prod(shape))
    whole = np.asarray(jax.random.normal(key, (offset + n,), jnp.bfloat16))
    want = whole[offset:].reshape(shape).astype(np.float32)
    got = prng.normal(tkey, shape, torch.bfloat16, offset=offset)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the f32 draw stays the f32 path's
    f32 = prng.normal(tkey, shape, offset=offset)
    assert f32.dtype == torch.float32 and not torch.equal(f32, got.float())


def test_training_frontend_is_jaxs_bf16_draw():
    """The launcher's frames at the published activation dtype (bf16):
    ``0.02·normal(fold_in(data_key, i))`` of (W, b, fseq, fdim), bit for bit
    the JAX launcher's expression (frames cut to 32 of 64)."""
    for arch in ARCHS:
        cfg = dataclasses.replace(get_config(arch), enc_seq_len=32, frontend_seq=32,
                                  frontend_dim=64)
        assert cfg.activation_dtype == "bfloat16"
        want = 0.02 * jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(9), 4),
                                        (4, 2, 32, 64), jnp.bfloat16)
        got = tlaunch.frontend_batch(cfg, prng.fold_in(prng.PRNGKey(9), 4), (4, 2))
        assert got.dtype == torch.bfloat16 and got.shape == (4, 2, 32, 64)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))


LAUNCH = dict(reduced=True, d_model=32, workers=4, per_worker_batch=1, seq_len=16, steps=3,
              alpha=0.25, attack="sign_flip", guard_backend="dp_exact", log_every=3)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_training_with_a_frontend_decides_as_jax(arch):
    """Three steps of both launchers, the frames drawn per step and mapped
    over the workers: decisions equal at every step, losses within 1e-4."""
    _, want = jrun_training(arch, driver="loop", **LAUNCH)
    _, got = tlaunch.run_training(arch, device="cpu", verbose=False, **LAUNCH)
    assert len(got) == len(want) == LAUNCH["steps"]
    for a, b in zip(want, got):
        for k in DECISIONS:
            assert a[k] == b[k], (a["step"], k)
        assert abs(b["loss_good_workers"] - a["loss_good_workers"]) <= \
            MODEL_TOL * abs(a["loss_good_workers"]), a["step"]
