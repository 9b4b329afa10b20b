"""The port's LM model stack (``repro_torch.configs``, ``models``,
``core.tree_harness``, the tree helpers of ``utils`` and
``prng.truncated_normal``) against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed; both packages run on the CPU.  Sizes:
internlm2-1.8b ``reduced(max_d_model=64)`` (2 layers, vocab 512), the
same with 2 KV heads for 4 query heads (grouped queries), and starcoder2-3b
``reduced()`` (sliding window 32).  Tolerances, each stated where used:
``truncated_normal`` and ``init`` within 1e-6 absolute on at most 2 % of
draws (the port's ``erf_inv`` uses torch's log1p and sqrt where XLA has
its own, ROADMAP.md "Documented differences"); numerics (norms, RoPE,
SwiGLU, attention, the loss) within 1e-5 relative
(‖got − want‖ ≤ tol·‖want‖ + tol); the gradient tree within 1e-4 relative a
leaf (f32 sums over a few thousand terms in another order), but 2e-3 on
starcoder2's ``reduced()`` (d_model 256): its backward amplifies f32
rounding toward the embedding, where JAX's own f32 gradient sits 5e-4
from the same function taken in f64 (and the port's 4e-4); the flat
vector bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import tree_harness as jth
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models.model import build_model as jbuild
from repro import utils as jutils
from repro_torch import configs as tconfigs
from repro_torch import convert, prng, utils
from repro_torch.core import tree_harness as tth
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models.model import build_model as tbuild

REL = 1e-5
GRAD_TOL = {"internlm2": 1e-4, "internlm2_gqa": 1e-4, "starcoder2_swa": 2e-3}


def _close(got, want, tol=REL):
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(got - want)
    assert err <= tol * np.linalg.norm(want) + tol, (err, np.linalg.norm(want))


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _configs():
    base = jconfigs.get_config("internlm2-1.8b").reduced(max_d_model=64)
    tbase = tconfigs.get_config("internlm2-1.8b").reduced(max_d_model=64)
    return {
        "internlm2": (base, tbase),
        "internlm2_gqa": (dataclasses.replace(base, n_kv_heads=2),
                          dataclasses.replace(tbase, n_kv_heads=2)),
        "starcoder2_swa": (jconfigs.get_config("starcoder2-3b").reduced(),
                           tconfigs.get_config("starcoder2-3b").reduced()),
    }


CONFIGS = _configs()


@pytest.fixture(scope="module")
def models():
    """Each configuration's JAX model, its parameters from PRNGKey(0) and
    the port's model on the CPU."""
    out = {}
    for name, (jcfg, tcfg) in CONFIGS.items():
        jm = jbuild(jcfg)
        out[name] = (jm, jm.init(jax.random.PRNGKey(0)), tbuild(tcfg, device="cpu"))
    return out


def _batch(cfg, seed, B=2, S=None):
    # past the sliding window where there is one (starcoder2's reduced 32)
    S = S or (40 if cfg.sliding_window else 24)
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_are_the_jax_packages(arch):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert dataclasses.asdict(jc.reduced()) == dataclasses.asdict(tc.reduced())
    assert [tuple(b.__dict__.values()) for b in jc.layer_plan()] == \
        [tuple(b.__dict__.values()) for b in tc.layer_plan()]
    assert tconfigs.list_configs() == jconfigs.list_configs()
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.INPUT_SHAPES.items()}


# ---------------------------------------------------------------- PRNG and init

@pytest.mark.parametrize("seed,shape", [(0, (1000, 37)), (7, (64, 3, 50)), (123, (5,))])
def test_truncated_normal_matches_jax(seed, shape):
    want = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(seed), -2.0, 2.0, shape))
    got = prng.truncated_normal(prng.PRNGKey(seed), -2.0, 2.0, shape).numpy()
    diff = np.abs(got - want)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert diff.max() <= 1e-6 and (diff > 0).mean() <= 0.02
    assert got.min() > -2.0 and got.max() < 2.0


def test_uniform_between_bounds_is_xlas_fma():
    """minval + u·(maxval − minval) is one fused multiply-add in XLA."""
    for seed in range(3):
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (4096,),
                                             minval=-0.954, maxval=0.9544))
        got = prng.uniform(prng.PRNGKey(seed), (4096,), -0.954, 0.9544).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_matches_jax(models, name):
    jm, jparams, tm = models[name]
    got = tm.init(prng.PRNGKey(0))
    jl, tl = jax.tree_util.tree_leaves(jparams), utils.tree_leaves(got)
    assert len(jl) == len(tl)
    assert tm.n_params == jm.n_params
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape) and str(a.dtype) == str(b.dtype).replace("torch.", "")
        diff = np.abs(b.numpy() - a)
        assert diff.max() <= 1e-6 and (diff > 0).mean() <= 0.02


def test_param_defs_flatten_in_jax_order(models):
    jm, _, tm = models["internlm2"]
    jdefs = jax.tree_util.tree_leaves(jm.defs, is_leaf=jcommon.is_def)
    tdefs = utils.tree_leaves(tm.defs, is_leaf=tcommon.is_def)
    assert [tuple(d.shape) for d in jdefs] == [tuple(d.shape) for d in tdefs]
    assert [d.init for d in jdefs] == [d.init for d in tdefs]
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jm.defs, is_leaf=jcommon.is_def)[0]]
    assert paths[:2] == ["['embed']", "['final_norm']"] and paths[-1] == "['lm_head']"


# ---------------------------------------------------------------- numerics

def test_rms_norm_swiglu_rope_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    _close(tcommon.rms_norm(_t(x), _t(w), 1e-5), jcommon.rms_norm(jnp.asarray(x), w, 1e-5))
    pos = np.arange(12, dtype=np.int32)
    for theta in (10_000.0, 500_000.0):
        _close(tcommon.apply_rope(_t(x), _t(pos), theta),
               jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    h = rng.normal(size=(3, 7, 16)).astype(np.float32)
    wg, wu = (rng.normal(size=(16, 40)).astype(np.float32) for _ in range(2))
    wd = rng.normal(size=(40, 16)).astype(np.float32)
    _close(tcommon.swiglu(_t(h), _t(wg), _t(wu), _t(wd)), jcommon.swiglu(h, wg, wu, wd))
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    tl, tm = tcommon.cross_entropy(_t(logits), _t(labels))
    jl, jm = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    _close(tl, jl)
    _close(tm["z"], jm["z"])


def test_bf16_rms_norm_and_swiglu_round_where_jax_rounds():
    """In bf16 the order of the casts decides the bits: f32 normalisation,
    cast back, then the weight product in bf16; silu in f32, cast back."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    got = tcommon.rms_norm(convert.tensor_from_numpy(np.asarray(xb), "cpu"),
                           convert.tensor_from_numpy(np.asarray(wb), "cpu"), 1e-5)
    want = np.asarray(jcommon.rms_norm(xb, wb, 1e-5).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("causal,window,chunk", [(True, None, 8), (True, 5, 8), (False, None, 7),
                                                 (True, 3, 64)])
def test_chunked_attention_matches_jax(causal, window, chunk):
    rng = np.random.default_rng(3)
    B, S, H, KV, hd = 2, 19, 4, 2, 8
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    got = tattn.chunked_attention(_t(q), _t(k), _t(v), _t(pos), _t(pos), causal=causal,
                                  window=window, chunk=chunk)
    want = jattn.chunked_attention(q, k, v, jnp.asarray(pos), jnp.asarray(pos), causal=causal,
                                   window=window, chunk=chunk)
    _close(got, want)


@pytest.mark.parametrize("name", ["internlm2_gqa", "starcoder2_swa"])
def test_gqa_apply_matches_jax(models, name):
    jm, jparams, _ = models[name]
    cfg = jm.cfg
    p = jax.tree_util.tree_map(lambda a: a[0], jparams["groups"][0]["mixer"])
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)
    window = cfg.sliding_window
    want = jattn.gqa_apply(p, cfg, jnp.asarray(x), jnp.asarray(pos), window=window)
    got = tattn.gqa_apply(convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu"),
                          CONFIGS[name][1], _t(x), _t(pos), window=window)
    _close(got, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_gradient_tree_match_jax(models, name):
    """loss_fn and its gradient on the JAX parameters carried over by
    ``convert.params_from_numpy``."""
    jm, jparams, tm = models[name]
    batch = _batch(jm.cfg, seed=5)
    (jloss, jaux), jgrads = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tbatch = {k: _t(v) for k, v in batch.items()}
    grads, (loss, aux) = torch.func.grad_and_value(tm.loss_fn, has_aux=True)(params, tbatch)
    _close(loss, jloss)
    _close(aux["ce"], jaux["ce"])
    jl, tl = jax.tree_util.tree_leaves(jgrads), utils.tree_leaves(grads)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        _close(b, a, GRAD_TOL[name])
    back = convert.params_to_numpy(params)
    for a, b in zip(jax.tree_util.tree_leaves(jparams), utils.tree_leaves(back)):
        np.testing.assert_array_equal(b, np.asarray(a))


def test_loss_chunks_only_when_the_chunk_divides_s(monkeypatch):
    """_chunked_ce takes S // LOSS_CHUNK chunks when the chunk divides S,
    else one: both give the JAX package's loss."""
    from repro.models import model as jmodel
    from repro_torch.models import model as tmodel
    jcfg, tcfg = CONFIGS["internlm2"]
    for chunk in (8, 7):
        monkeypatch.setattr(jmodel, "LOSS_CHUNK", chunk)
        monkeypatch.setattr(tmodel, "LOSS_CHUNK", chunk)
        jm, tm = jmodel.build_model(jcfg), tmodel.build_model(tcfg, device="cpu")
        jp = jm.init(jax.random.PRNGKey(1))
        batch = _batch(jcfg, seed=6, S=16)
        jloss, _ = jm.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
        params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        loss, _ = tm.loss_fn(params, {k: _t(v) for k, v in batch.items()})
        _close(loss, jloss)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "seamless-m4t-large-v2",
                                  "internvl2-76b"])
def test_other_families_raise_naming_the_roadmap(arch):
    """MLA, the encoder-decoder and the frontends, the last families that
    raised, build now with the JAX package's parameter count and leaf
    shapes (held to it in ``tests/test_torch_mla.py`` and
    ``tests/test_torch_encdec.py``)."""
    jm = jbuild(jconfigs.get_config(arch).reduced())
    tm = tbuild(tconfigs.get_config(arch).reduced(), device="cpu")
    assert tm.n_params == jm.n_params
    assert [tuple(a.shape) for a in utils.tree_leaves(tm.abstract())] == \
        [tuple(a.shape) for a in jax.tree_util.tree_leaves(jm.abstract())]


def test_serving_raises_naming_the_roadmap(models):
    """The dense decoder serves (``tests/test_torch_serve.py``), and the
    Mamba cache with it (``tests/test_torch_ssm.py``); the MLA decode cache,
    the last that raised, is built now."""
    from repro_torch.configs.base import BlockSpec
    from repro_torch.models.model import _group_cache
    tm = models["internlm2"][2]
    cache = tm.init_cache(2, 8)
    assert [tuple(c.k.shape) for c in cache["layers"]] == [(2, 2, 8, 4, 16)]
    dcfg = tconfigs.get_config("deepseek-v2-lite-16b").reduced()
    mla = _group_cache(BlockSpec(mixer="mla", ff="mlp", count=1), dcfg, 2, 8, torch.float32,
                       "cpu")
    assert tuple(mla.ckv.shape) == (1, 2, 8, dcfg.kv_lora_rank)


# ---------------------------------------------------------------- tree harness

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_harness_ravel_is_jaxs_flat_vector(models, name):
    jm, jparams, tm = models[name]
    jh, th = jth.params_harness(jm), tth.params_harness(tm)
    assert (th.d, th.d_raw, th.shapes) == (jh.d, jh.d_raw, jh.shapes)
    assert th.d % tth.LANE == 0 and str(th.flat_dtype) == f"torch.{jh.flat_dtype}"
    params = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    flat = th.ravel(params)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jh.ravel(jparams)))
    assert not flat[th.d_raw:].any()
    back = th.unravel(flat)
    for a, b in zip(utils.tree_leaves(params), utils.tree_leaves(back)):
        assert torch.equal(a, b)
    # the worker-stacked view, and a cast once at ravel (bf16)
    stacked = jax.tree_util.tree_map(lambda a: jnp.stack([a, -a, 2 * a]), jparams)
    tstacked = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, stacked), "cpu")
    np.testing.assert_array_equal(th.ravel_workers(tstacked).numpy(),
                                  np.asarray(jh.ravel_workers(stacked)))
    want16 = np.asarray(jh.ravel_workers(stacked, dtype=jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(th.ravel_workers(tstacked, torch.bfloat16).float().numpy(),
                                  want16)
    for w in range(3):
        np.testing.assert_array_equal(th.ravel(utils.tree_map(lambda a: a[w], tstacked)).numpy(),
                                      np.asarray(jh.ravel_workers(stacked))[w])


def test_tree_helpers_match_jax(models):
    _, jparams, _ = models["internlm2"]
    a = jparams
    b = jax.tree_util.tree_map(lambda x: 0.5 * x + 0.01, jparams)
    ta, tb = (convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, t), "cpu")
              for t in (a, b))
    assert [tuple(x.shape) for x in utils.tree_leaves(ta)] == \
        [x.shape for x in jax.tree_util.tree_leaves(a)]
    _close(utils.tree_vdot(ta, tb), jutils.tree_vdot(a, b))
    _close(utils.global_norm(ta), jutils.global_norm(a))
    for got, want in ((utils.clip_by_global_norm(ta, 1.0), jutils.clip_by_global_norm(a, 1.0)),
                      (utils.project_ball(ta, tb, 0.5), jutils.project_ball(a, b, 0.5)),
                      (utils.tree_sub(ta, tb), jutils.tree_sub(a, b)),
                      (utils.tree_add(ta, tb), jutils.tree_add(a, b)),
                      (utils.tree_scale(ta, 0.3), jutils.tree_scale(a, 0.3)),
                      (utils.tree_zeros_like(ta), jutils.tree_zeros_like(a))):
        for x, y in zip(utils.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            _close(x, y)


def test_clip_promotes_a_bf16_tree_as_jnp_does():
    """A 0-d f32 factor lifts bf16 leaves to f32, as jnp promotes."""
    x = np.linspace(-3, 3, 64, dtype=np.float32).reshape(8, 8)
    jt = {"w": jnp.asarray(x, jnp.bfloat16)}
    tt = {"w": convert.tensor_from_numpy(np.asarray(jt["w"]), "cpu")}
    want = jutils.clip_by_global_norm(jt, 1.0)["w"]
    got = utils.clip_by_global_norm(tt, 1.0)["w"]
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want)
