"""The port's MoE layer (``repro_torch.models.moe``), the MoE decoder
(kimi-k2) through ``models.model``, ``distributed.trainer`` and
``convert``, and the key chain's draws past 2³² elements, against the JAX
package's, on the CPU.

Inputs are numpy arrays from a seed; both packages run on the CPU.  Sizes:
the reference's own ``TestMoE`` layer (``tests/test_models.py``: d 32,
4 experts, top 2, expert width 32, capacity factor 2), with drops (0.1)
and with a shared expert; kimi-k2-1t-a32b ``reduced(max_d_model=64)`` (a
dense first layer, then 4 experts top 2 with one shared expert, vocab 512).
Tolerances, each stated where used: the layer's output and aux within 1e-5
relative (‖got − want‖ ≤ tol·‖want‖ + tol), its routes, positions and
kept/dropped choices exactly equal; the model's init within 1e-6 absolute
on at most 2 % of draws (``prng.normal``'s few ulps), its loss, gradient
tree and logits within 1e-4; a train step's decisions exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from repro.configs import get_config as jget_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.core.solver import SolverConfig as JConfig
from repro.core.solver import byz_rank as jbyz_rank
from repro.data import synthetic as jsyn
from repro.distributed import trainer as jtrainer
from repro.models import moe as jmoe
from repro.models.common import init_params as jinit_params
from repro.models.model import build_model as jbuild
from repro.optim import optimizers as jopt
from repro_torch import convert, prng, utils
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.solver import SolverConfig, byz_rank
from repro_torch.data import synthetic as tsyn
from repro_torch.distributed import trainer as ttrainer
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build_model as tbuild
from repro_torch.optim import optimizers as topt

REL, MODEL_TOL = 1e-5, 1e-4
ARCH = "kimi-k2-1t-a32b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread: the vmap and piecewise checks compare bits, and
    torch splits a CPU reduction by the size of its thread team."""
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


# ---------------------------------------------------------------- the layer

LAYER_CASES = {
    # name: (config overrides, x shape) — tests/test_models.py::TestMoE
    "plain": ({}, (2, 8, 32)),
    "drops": ({"capacity_factor": 0.1}, (2, 16, 32)),
    "shared": ({"n_shared_experts": 1}, (1, 4, 32)),
}


def _layer_cfgs(**kw):
    base = dict(name="t", arch_type="moe", source="t", n_layers=1, d_model=32,
                n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=64,
                n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=2.0)
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _layer(case, seed=0):
    over, shape = LAYER_CASES[case]
    jcfg, tcfg = _layer_cfgs(**over)
    jp = jax.jit(lambda k: jinit_params(k, jmoe.moe_defs(jcfg), jnp.float32))(
        jax.random.PRNGKey(seed))
    x = (0.1 * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)
    return jcfg, tcfg, jp, convert.params_from_numpy(_np_tree(jp), "cpu"), x


def _jax_routes(jp, cfg, x):
    """The reference's routing and positions (``src/repro/models/moe.py``,
    its lines as they stand), for the kept/dropped comparison."""
    E, K = cfg.n_experts, cfg.top_k
    T = x.shape[0] * x.shape[1]
    C = min(max(int(T * K / E * cfg.capacity_factor), 4), T)

    @jax.jit
    def routes(router, x):
        xt = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(jnp.einsum("td,de->te", xt, router), axis=-1)
        _, top_e = jax.lax.top_k(probs, K)
        onehot = jax.nn.one_hot(top_e.T.reshape(K * T), E, dtype=jnp.int32)
        return top_e, jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=1)

    top_e, flat_pos = (np.asarray(a) for a in routes(jp["router"], jnp.asarray(x)))
    return top_e, flat_pos.reshape(K, T), (flat_pos < C).reshape(K, T), C


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_apply_matches_jax(case):
    """Out and aux within 1e-5; the experts chosen, their positions, the
    capacity and the kept/dropped choices exactly the reference's."""
    jcfg, tcfg, jp, tp, x = _layer(case)
    jout, jaux = jax.jit(lambda p, x: jmoe.moe_apply(p, jcfg, x))(jp, jnp.asarray(x))
    out, aux = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    assert out.shape == x.shape and aux.dtype == torch.float32
    _close(out, jout)
    _close(aux, jaux)
    top_e, pos, keep, C = _jax_routes(jp, jcfg, x)
    routes = tmoe.route(tp["router"], torch.from_numpy(x).reshape(-1, x.shape[-1]), tcfg.top_k)
    T = top_e.shape[0]
    assert tmoe.capacity(tcfg, T) == C
    tpos, tkeep = tmoe.dispatch(routes.top_e, tcfg.n_experts, C)
    np.testing.assert_array_equal(routes.top_e.numpy(), top_e)
    np.testing.assert_array_equal(tpos.numpy(), pos)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    # the drop case drops: a choice past capacity adds nothing
    assert (not keep.all()) == (case == "drops")


def test_shared_expert_stays_when_the_routed_experts_are_zero():
    """tests/test_models.py::TestMoE::test_shared_expert_always_active on
    the port, against the reference's output."""
    jcfg, tcfg, jp, tp, x = _layer("shared")
    jp2 = dict(jp, down=jnp.zeros_like(jp["down"]))
    tp2 = dict(tp, down=torch.zeros_like(tp["down"]))
    jout, _ = jax.jit(lambda p, x: jmoe.moe_apply(p, jcfg, x))(jp2, jnp.asarray(x))
    out, _ = tmoe.moe_apply(tp2, tcfg, torch.from_numpy(x))
    _close(out, jout)
    assert float(out.abs().max()) > 0.0


def test_top_k_ties_take_the_lower_index_as_jax():
    """Equal probabilities (a zero router) route to experts 0..K−1, as
    ``jax.lax.top_k`` orders ties; and a row with ties in its middle."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3], [0.4, 0.2, 0.4, 0.0]],
                     np.float32)
    jtop_p, jtop_e = jax.lax.top_k(jnp.asarray(probs), 2)
    # route() normalises the top-k of softmax(x @ router): feed the
    # logits whose softmax is probs (log, then an identity router)
    x = torch.from_numpy(np.log(np.maximum(probs, 1e-30)))
    routes = tmoe.route(torch.eye(4), x, 2)
    np.testing.assert_array_equal(routes.top_e.numpy(), np.asarray(jtop_e))
    want = np.asarray(jtop_p) / np.asarray(jtop_p).sum(-1, keepdims=True)
    np.testing.assert_allclose(routes.top_p.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("T,K,E,cf,want", [(256, 8, 384, 1.25, 6), (4, 8, 384, 1.25, 4),
                                           (256, 8, 384, 384.0, 256), (16, 2, 4, 0.1, 4),
                                           (3, 2, 4, 2.0, 3), (4096, 2, 16, 1.25, 640)])
def test_capacity_is_the_jax_expression(T, K, E, cf, want):
    """kimi-k2's prefill (T = 256: 6 slots) and decode (T = 4: 4 = T), the
    chip check's capacity_factor = E (C = T), and the small cases."""
    _, tcfg = _layer_cfgs(n_experts=E, top_k=K, capacity_factor=cf)
    assert tmoe.capacity(tcfg, T) == want == min(max(int(T * K / E * cf), 4), T)


@pytest.mark.parametrize("case", ["plain", "drops"])
def test_moe_under_vmap_is_a_loop_over_workers(case):
    """The trainer's vmap over workers: out and aux bit-equal to one call a
    worker, gradients within 1e-6 (batched products sum in another order)."""
    _, tcfg, _, tp, _ = _layer(case)
    _, shape = LAYER_CASES[case]
    xs = torch.from_numpy((0.1 * np.random.default_rng(9).normal(size=(3, *shape)))
                          .astype(np.float32))

    def loss(p, x):
        out, aux = tmoe.moe_apply(p, tcfg, x)
        return torch.sum(out * out) + aux

    out, aux = torch.func.vmap(lambda x: tmoe.moe_apply(tp, tcfg, x))(xs)
    grads = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(tp, xs)
    for w in range(xs.shape[0]):
        o1, a1 = tmoe.moe_apply(tp, tcfg, xs[w])
        assert torch.equal(o1, out[w]) and torch.equal(a1, aux[w])
        g1 = torch.func.grad(loss)(tp, xs[w])
        for a, b in zip(utils.tree_leaves(grads), utils.tree_leaves(g1)):
            _close(a[w], b, 1e-6)


# ---------------------------------------------------------------- draws past 2^32

@pytest.mark.parametrize("seed", [0, 7])
def test_threefry_counters_past_2_32_are_jaxs(seed):
    """Element i ≥ 2³² draws from the words (i >> 32, i & 0xFFFFFFFF), as
    jax's partitionable threefry: the port's bits at 2³² + j and 2³³ + j
    against ``threefry2x32_p`` at those words; below 2³² as
    ``jax.random.bits``."""
    assert jax.config.jax_threefry_partitionable
    k = np.asarray(jax.random.PRNGKey(seed))
    j = np.arange(6, dtype=np.int64)
    for base in (2 ** 32, 2 ** 33, 2 ** 32 * 3 - 3):
        c = base + j
        x0, x1 = jprng.threefry2x32_p.bind(
            jnp.uint32(k[0]), jnp.uint32(k[1]), jnp.asarray((c >> 32).astype(np.uint32)),
            jnp.asarray((c & 0xFFFFFFFF).astype(np.uint32)))
        want = (np.asarray(x0) ^ np.asarray(x1)).astype(np.int64)
        got = prng._random_bits32(prng.PRNGKey(seed), len(j), base)
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (4099,), jnp.uint32))
    np.testing.assert_array_equal(prng._random_bits32(prng.PRNGKey(seed), 4099).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("kind", ["normal", "truncated_normal", "init_normal", "init_embed"])
def test_a_leaf_drawn_in_pieces_is_the_whole_draw(kind):
    """Pieces of 1000 (not a divisor of 5550) written into the leaf equal one
    draw bit for bit: ``prng.normal``/``truncated_normal`` with ``offset``
    and ``init_param``'s piecewise path (bf16 for the embed leaf)."""
    key, shape = prng.PRNGKey(3), (3, 50, 37)
    n = 3 * 50 * 37
    if kind in ("normal", "truncated_normal"):
        draw = ((lambda s, o=0: prng.normal(key, s, offset=o)) if kind == "normal" else
                (lambda s, o=0: prng.truncated_normal(key, -2.0, 2.0, s, offset=o)))
        whole = draw(shape).reshape(-1)
        parts = torch.cat([draw((min(1000, n - lo),), lo) for lo in range(0, n, 1000)])
        assert torch.equal(parts, whole)
        return
    init, dtype = ("normal", torch.float32) if kind == "init_normal" else ("embed",
                                                                          torch.bfloat16)
    d = tcommon.ParamDef(shape, (None, None, None), init=init, scale=0.5)
    whole = tcommon.init_param(key, d, dtype)
    pieces = tcommon.init_param(key, d, dtype, piece=1000)
    assert whole.dtype == pieces.dtype == dtype and torch.equal(whole, pieces)


# ---------------------------------------------------------------- kimi-k2 reduced

@pytest.fixture(scope="module")
def kimi():
    jcfg = jget_config(ARCH).reduced(max_d_model=64)
    jm = jbuild(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = tbuild(get_config(ARCH).reduced(max_d_model=64), device="cpu")
    return jm, jp, tm, convert.params_from_numpy(_np_tree(jp), "cpu")


def test_kimi_layer_plan_and_init_match_jax(kimi):
    jm, jp, tm, _ = kimi
    assert [(s.mixer, s.ff, s.count) for s in tm.cfg.layer_plan()] == \
        [("attn", "mlp", 1), ("attn", "moe", 1)]
    got = tm.init(prng.PRNGKey(0))
    assert tm.n_params == jm.n_params
    jl, tl = jax.tree_util.tree_leaves(jp), utils.tree_leaves(got)
    assert len(jl) == len(tl)
    assert "shared" in got["groups"][1]["ff"]
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        diff = np.abs(b.numpy() - a)
        assert diff.max() <= 1e-6 and (diff > 0).mean() <= 0.02


def test_kimi_loss_aux_and_gradient_tree_match_jax(kimi):
    jm, jp, tm, tp = kimi
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, 512, (2, 24)).astype(np.int32) for k in ("tokens", "labels")}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    grads, (loss, aux) = torch.func.grad_and_value(tm.loss_fn, has_aux=True)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(loss, jloss, MODEL_TOL)
    _close(aux["aux"], jaux["aux"], REL)
    assert float(aux["aux"]) > 0.0
    jl, tl = jax.tree_util.tree_leaves(jgrads), utils.tree_leaves(grads)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        _close(b, a, MODEL_TOL)


def test_kimi_prefill_and_decode_match_jax(kimi):
    """Prefill (T = 2·12: capacity 12) then 4 decode steps (T = 2: capacity
    2), each pass at the published factor; logits within 1e-4."""
    jm, jp, tm, tp = kimi
    prompt = np.random.default_rng(6).integers(0, 512, (2, 12)).astype(np.int32)
    jlog, jcache = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, cache_len=24))(
        jp, jnp.asarray(prompt))
    tlog, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)}, cache_len=24)
    _close(tlog, jlog, MODEL_TOL)
    jdecode = jax.jit(jm.decode_step)
    tok = np.array(jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32))
    for _ in range(4):
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(tok))
        tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok))
        _close(tlog, jlog, MODEL_TOL)
        tok = np.array(jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32))


def test_kimi_train_step_matches_jax(kimi):
    """One step of ``build_train_step`` (dp_exact, W = 8, sign_flip) from
    the JAX package's initial state: decisions exactly equal, losses and
    parameters within 1e-4."""
    jm, _, tm, _ = kimi
    W, steps = 8, 1
    base = dict(m=W, T=steps, eta=3e-3, alpha=0.25, attack="sign_flip", mean_over_alive=True,
                guard_backend="dp_exact")
    jcfg, tcfg = JConfig(**base), SolverConfig(**base)
    jo = jopt.adamw(jopt.linear_warmup_cosine(3e-3, 1, steps), grad_clip=1.0)
    to = topt.adamw(topt.linear_warmup_cosine(3e-3, 1, steps), grad_clip=1.0)
    jstep = jax.jit(jtrainer.build_train_step(jm, jo, jcfg))
    tstep = ttrainer.build_train_step(tm, to, tcfg)
    jstate = jax.jit(lambda k: jtrainer.init_train_state(jm, jo, jcfg, k))(
        jax.random.PRNGKey(0))
    tstate = convert.train_state_from_numpy(*_np_tree(jstate), device="cpu")
    jrank, trank = jbyz_rank(jax.random.PRNGKey(1), W), byz_rank(prng.PRNGKey(1), W)
    js, ts = jsyn.SyntheticTokens(512, 16, seed=2), tsyn.SyntheticTokens(512, 16, seed=2)
    for i in range(steps):
        jstate, jm_ = jstep(jstate, jsyn.make_worker_batch(js, W, 2, jnp.asarray(i)), jrank,
                            jax.random.fold_in(jax.random.PRNGKey(3), i))
        tstate, tm_ = tstep(tstate, tsyn.make_worker_batch(ts, W, 2, i, device="cpu"), trank,
                            prng.fold_in(prng.PRNGKey(3), i))
        for k in ("n_alive", "byz_alive", "good_filtered", "n_byz"):
            assert int(tm_[k]) == int(jm_[k]), (i, k)
        np.testing.assert_array_equal(tstate.prev_alive.numpy(), np.asarray(jstate.prev_alive))
        _close(tm_["loss_good_workers"], jm_["loss_good_workers"], MODEL_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(jstate.params), utils.tree_leaves(tstate.params)):
        _close(b, a, MODEL_TOL)


def test_mla_and_the_other_families_still_raise():
    """deepseek-v2-lite (MLA), the last MoE config that raised, builds now
    (its MLA held to the JAX package's in ``tests/test_torch_mla.py``): MLA
    mixers over a dense first layer and routed layers, with and without
    MLA, and nothing raises."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    tm = tbuild(cfg, device="cpu")
    assert [(s.mixer, s.ff) for s in tm.cfg.layer_plan()] == [("mla", "mlp"), ("mla", "moe")]
    assert tm.n_params == jbuild(jget_config("deepseek-v2-lite-16b").reduced()).n_params
    tm = tbuild(dataclasses.replace(cfg, use_mla=False), device="cpu")
    assert any(s.ff == "moe" for s in tm.cfg.layer_plan())
