"""The port's MLA (``repro_torch.models.attention``'s ``mla_*`` and
``MLACache``) and deepseek-v2-lite through ``models.model``, ``convert``
and ``launch.train``, against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed; both packages run on the CPU.  Sizes:
deepseek-v2-lite-16b ``reduced(max_d_model=64)`` (2 layers: a dense first
layer, then 4 experts top 2 with a shared one; 4 heads of 16, kv_lora 64,
RoPE 16, vocab 512), and the same with ``q_lora_rank`` 16 for the
low-rank query.  Tolerances (``tests/test_torch_lm_model.py``'s): a
layer's output and caches within 1e-5 relative (‖got − want‖ ≤
tol·‖want‖ + tol), the model's loss, gradient tree and logits within 1e-4,
the init within 1e-6 absolute on at most 2 % of draws; ``pos``, greedy
tokens and every filter decision exactly equal.

The reference's decode mask (``ROADMAP.md`` §3, "Caveats about the
reference"): ``mla_decode_apply`` keeps the slots ``<= pos % L``, so once
a cache wraps the older slots after the newest are masked out; the port
follows it (``test_mla_decode_masks_a_wrapped_cache_as_jax``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.train import run_training as jrun_training
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models.model import build_model as jbuild
from repro_torch import convert, prng, utils
from repro_torch.configs import get_config
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models.model import build_model as tbuild

REL, MODEL_TOL = 1e-5, 1e-4
ARCH = "deepseek-v2-lite-16b"
DECISIONS = ("n_alive", "byz_alive", "good_filtered", "n_byz")


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


def _cfgs(q_lora: int = 0):
    j, t = jget_config(ARCH).reduced(max_d_model=64), get_config(ARCH).reduced(max_d_model=64)
    if q_lora:
        j, t = dataclasses.replace(j, q_lora_rank=q_lora), dataclasses.replace(t, q_lora_rank=q_lora)
    return j, t


@pytest.fixture(scope="module")
def deepseek():
    jcfg, tcfg = _cfgs()
    jm = jbuild(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = tbuild(tcfg, device="cpu")
    return jm, jp, tm, convert.params_from_numpy(_np_tree(jp), "cpu")


@functools.lru_cache(maxsize=None)
def _layer_params(q_lora: int):
    """The first layer's MLA weights (the JAX init of its defs), both ways."""
    jcfg, tcfg = _cfgs(q_lora)
    defs = jattn.mla_defs(jcfg)
    p = _np_tree(jax.jit(lambda k: jcommon.init_params(k, defs, jnp.float32))(
        jax.random.PRNGKey(1)))
    return jcfg, tcfg, p, convert.params_from_numpy(p, "cpu")


# the JAX layer functions jitted (the config is static): op-by-op dispatch
# would compile every op of every call
_jmla_apply = jax.jit(jattn.mla_apply, static_argnums=(1,), static_argnames=("return_kv",))
_jmla_decode = jax.jit(jattn.mla_decode_apply, static_argnums=(1,))


def test_layer_plan_and_init_match_jax(deepseek):
    jm, jp, tm, _ = deepseek
    assert [(s.mixer, s.ff, s.count) for s in tm.cfg.layer_plan()] == \
        [("mla", "mlp", 1), ("mla", "moe", 1)]
    assert tm.n_params == jm.n_params
    got = tm.init(prng.PRNGKey(0))
    assert sorted(got["groups"][0]["mixer"]) == ["w_dkv", "w_uk", "w_uv", "wo", "wq"]
    jl, tl = jax.tree_util.tree_leaves(jp), utils.tree_leaves(got)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        diff = np.abs(b.numpy() - a)
        assert diff.max() <= 1e-6 and (diff > 0).mean() <= 0.02


def test_init_takes_the_head_count_as_an_mla_leafs_fan_in():
    """The reference's init scales a stacked leaf by 1/√shape[-2]: for
    deepseek-v2-lite's stacked MLA leaves that is the head count (wq
    (L, 2048, 16, 192) and w_uk, w_uv (L, 512, 16, 128): std 1/4), not the
    contracted 2048 or 512, so its attention is near one-hot at full width
    (``ROADMAP.md`` §3); the port draws the same scales."""
    from repro.models.model import model_defs as jdefs
    from repro_torch.models.model import model_defs as tdefs
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    jmix = jdefs(dataclasses.replace(jget_config(ARCH), n_layers=2))["groups"][1]["mixer"]
    tmix = tdefs(cfg)["groups"][1]["mixer"]
    fan = {k: tcommon._fan_in(d.shape) for k, d in tmix.items()}
    assert fan == {k: jcommon._fan_in(d.shape) for k, d in jmix.items()}
    assert fan == {"wq": cfg.n_heads, "w_uk": cfg.n_heads, "w_uv": cfg.n_heads,
                   "wo": cfg.head_dim, "w_dkv": cfg.d_model}


@pytest.mark.parametrize("q_lora", [0, 16])
def test_mla_apply_and_its_latent_match_jax(q_lora):
    jcfg, tcfg, p, tp = _layer_params(q_lora)
    assert ("w_dq" in p) == bool(q_lora)
    x = np.random.default_rng(2).normal(size=(2, 24, tcfg.d_model)).astype(np.float32)
    pos = np.arange(24, dtype=np.int32)
    want, (jc, jkr) = _jmla_apply(p, jcfg, jnp.asarray(x), jnp.asarray(pos), return_kv=True)
    got, (c, kr) = tattn.mla_apply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                                   return_kv=True)
    assert c.shape == (2, 24, tcfg.kv_lora_rank) and kr.shape == (2, 24, tcfg.rope_head_dim)
    _close(got, want)
    _close(c, jc)
    _close(kr, jkr)


def _cache_close(got: tattn.MLACache, want) -> None:
    assert int(got.pos) == int(want.pos)
    _close(got.ckv, want.ckv)
    _close(got.k_rope, want.k_rope)


@pytest.mark.parametrize("prompt,length,steps", [(4, 6, 5), (9, 6, 4), (3, 16, 3)])
def test_mla_decode_matches_jax_past_a_wrap(prompt, length, steps):
    """Prefill ``prompt`` tokens into a cache of ``length`` (rolled when
    longer), then decode ``steps`` tokens: the first two cases wrap."""
    jcfg, tcfg, p, tp = _layer_params(0)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, prompt, tcfg.d_model)).astype(np.float32)
    pos = np.arange(prompt, dtype=np.int32)
    _, (jc, jkr) = _jmla_apply(p, jcfg, jnp.asarray(x), jnp.asarray(pos), return_kv=True)
    jcache = jattn.mla_cache_from_prefill(jc, jkr, length, jnp.asarray(prompt, jnp.int32))
    _, (c, kr) = tattn.mla_apply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
                                 return_kv=True)
    cache = tattn.mla_cache_from_prefill(c, kr, length, torch.tensor(prompt, dtype=torch.int32))
    _cache_close(cache, jcache)
    for _ in range(steps):
        xt = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
        want, jcache = _jmla_decode(p, jcfg, jnp.asarray(xt), jcache)
        got, cache = tattn.mla_decode_apply(tp, tcfg, torch.from_numpy(xt), cache)
        _close(got, want)
        _cache_close(cache, jcache)


def test_mla_decode_masks_a_wrapped_cache_as_jax():
    """At pos = L + 1 (slot 1) only slots 0 and 1 are read, in the port as
    in the JAX package: the slots after the newest, which hold the older
    tokens of a wrapped cache, change nothing."""
    jcfg, tcfg, p, tp = _layer_params(0)
    rng = np.random.default_rng(4)
    L, B = 6, 2
    ckv = rng.normal(size=(B, L, tcfg.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(B, L, tcfg.rope_head_dim)).astype(np.float32)
    xt = rng.normal(size=(B, 1, tcfg.d_model)).astype(np.float32)
    pos = np.int32(L + 1)
    outs = []
    for scale in (1.0, 100.0):
        c2, k2 = ckv.copy(), kr.copy()
        c2[:, 2:] *= scale
        k2[:, 2:] *= scale
        want, _ = _jmla_decode(p, jcfg, jnp.asarray(xt), jattn.MLACache(
            jnp.asarray(c2), jnp.asarray(k2), jnp.asarray(pos)))
        got, nxt = tattn.mla_decode_apply(tp, tcfg, torch.from_numpy(xt), tattn.MLACache(
            torch.from_numpy(c2), torch.from_numpy(k2), torch.tensor(pos)))
        _close(got, want)
        assert int(nxt.pos) == L + 2
        outs.append(got)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_loss_and_gradient_tree_match_jax(deepseek):
    jm, jp, tm, tp = deepseek
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, 512, (2, 24)).astype(np.int32) for k in ("tokens", "labels")}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    grads, (loss, aux) = torch.func.grad_and_value(tm.loss_fn, has_aux=True)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(loss, jloss, MODEL_TOL)
    _close(aux["aux"], jaux["aux"], REL)
    jl, tl = jax.tree_util.tree_leaves(jgrads), utils.tree_leaves(grads)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        _close(b, a, MODEL_TOL)


def test_prefill_then_decode_tokens_match_jax(deepseek):
    """Prefill 12 tokens into caches of 16, then 8 decode steps (past the
    cache's capacity, so the MLA cache wraps): logits within 1e-4 and the
    greedy tokens equal."""
    jm, jp, tm, tp = deepseek
    prompt = np.random.default_rng(6).integers(0, 512, (2, 12)).astype(np.int32)
    jlog, jcache = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, cache_len=16))(
        jp, jnp.asarray(prompt))
    tlog, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)}, cache_len=16)
    assert isinstance(tcache["layers"][0], tattn.MLACache)
    _close(tlog, jlog, MODEL_TOL)
    jdecode = jax.jit(jm.decode_step)
    jtok = np.array(jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32))
    ttok = torch.argmax(tlog[:, -1:], dim=-1).to(torch.int32)
    for _ in range(8):
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(jtok))
        tlog, tcache = tm.decode_step(tp, tcache, ttok)
        _close(tlog, jlog, MODEL_TOL)
        jtok = np.array(jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32))
        ttok = torch.argmax(tlog[:, -1:], dim=-1).to(torch.int32)
    assert int(tcache["layers"][0].pos[0]) == 20


def test_mla_cache_through_convert_both_ways(deepseek):
    """A JAX prefill cache into the port (its groups as ``MLACache``) and
    back out equal to JAX's arrays; the port decodes on from it as JAX."""
    jm, jp, tm, tp = deepseek
    prompt = np.random.default_rng(7).integers(0, 512, (2, 10)).astype(np.int32)
    jlog, jcache = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, cache_len=12)
    tcache = convert.kv_cache_from_numpy(_np_tree(jcache), "cpu")
    assert all(isinstance(g, tattn.MLACache) for g in tcache["layers"])
    back = convert.kv_cache_to_numpy(tcache)
    for g, w in zip(back["layers"], jcache["layers"]):
        assert sorted(g) == ["ckv", "k_rope", "pos"]
        for f in g:
            np.testing.assert_array_equal(g[f], np.asarray(getattr(w, f)))
    tok = np.array(jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32))
    jlog2, _ = jm.decode_step(jp, jcache, jnp.asarray(tok))
    tlog2, _ = tm.decode_step(tp, tcache, torch.from_numpy(tok))
    _close(tlog2, jlog2, MODEL_TOL)


LAUNCH = dict(reduced=True, d_model=64, workers=8, per_worker_batch=1, seq_len=16, steps=4,
              alpha=0.25, attack="sign_flip", guard_backend="dp_exact", log_every=2)


def test_run_training_decides_as_jax():
    """Four steps of both launchers on deepseek-v2-lite reduced: every
    filter decision equal at every step, losses within 1e-4."""
    _, want = jrun_training(ARCH, driver="loop", **LAUNCH)
    _, got = tlaunch.run_training(ARCH, device="cpu", verbose=False, **LAUNCH)
    assert len(got) == len(want) == LAUNCH["steps"]
    for a, b in zip(want, got):
        for k in DECISIONS:
            assert a[k] == b[k], (a["step"], k)
        assert abs(b["loss_good_workers"] - a["loss_good_workers"]) <= \
            MODEL_TOL * abs(a["loss_good_workers"]), a["step"]
    assert got[-1]["byz_alive"] == 0 and all(r["good_filtered"] == 0 for r in got)
