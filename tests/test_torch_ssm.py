"""The port's Mamba2/SSD mixer (``repro_torch.models.ssm``), the pure SSM
(mamba2-130m) and the hybrid (jamba) through ``models.model``,
``distributed.trainer``, ``launch.serve`` and ``convert``'s Mamba cache,
against the JAX package's, on the CPU.

Inputs are numpy arrays from a seed; both packages run on the CPU.  Sizes:
the SSD scan at B 2, S 64, H 4 heads in 2 groups, P 8, N 8, chunks of 16
(four chunks, with and without an initial state) and of 64; the mixer at
mamba2-130m ``reduced(max_d_model=64)`` widths (d_inner 128, 8 heads of
16, N 16, chunk 32) over S = 32 and S = 2 (shorter than the conv's W − 1
= 3 taps of tail); the models at ``reduced(max_d_model=64)``: mamba2-130m
(2 Mamba layers, no FFN) and jamba (a Mamba layer with 4 experts top 2,
then an attention layer with an MLP).  Tolerances: the scan, the mixer and
its decode within 1e-5 relative (‖got − want‖ ≤ tol·‖want‖ + tol); the
models' init within 1e-6 absolute on at most 2 % of draws; loss, gradient
tree, logits and caches within 1e-4; a train step's decisions and the
greedy tokens of a carried cache exactly equal.

The SSD mask (``ROADMAP.md`` §3, "Caveats about the reference"): at one
chunk of Q = 32 and 96 the port's gradients equal the JAX package's; at
Q = 128 and 256 (unit-normal dt, A = −1: Σdt passes 88) the JAX package's
are non-finite and the port's are finite and equal those of the same scan
with the mask taken before the ``exp``, written below in JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.solver import SolverConfig as JConfig
from repro.core.solver import byz_rank as jbyz_rank
from repro.data import synthetic as jsyn
from repro.distributed import trainer as jtrainer
from repro.models import ssm as jssm
from repro.models.model import build_model as jbuild
from repro.optim import optimizers as jopt
from repro_torch import convert, prng, utils
from repro_torch.configs import get_config
from repro_torch.core.solver import SolverConfig, byz_rank
from repro_torch.data import synthetic as tsyn
from repro_torch.distributed import trainer as ttrainer
from repro_torch.models import ssm as tssm
from repro_torch.models.model import build_model as tbuild
from repro_torch.optim import optimizers as topt

REL, MODEL_TOL = 1e-5, 1e-4
ARCHS = ("mamba2-130m", "jamba-v0.1-52b")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread: torch splits a CPU reduction by the size of its
    thread team, and the served tokens are compared exactly."""
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


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _scan_inputs(B, S, H, P, G, N, seed=0, a_scale=0.3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(jnp.asarray(rng.normal(size=(B, S, H)).astype(np.float32))))
    A = (-np.exp(rng.normal(size=(H,)) * a_scale)).astype(np.float32)
    Bm = (0.5 * rng.normal(size=(B, S, G, N))).astype(np.float32)
    Cm = (0.5 * rng.normal(size=(B, S, G, N))).astype(np.float32)
    return x, dt, A, Bm, Cm


# ---------------------------------------------------------------- the scan and the conv

@pytest.mark.parametrize("chunk,initial", [(16, False), (16, True), (64, False)])
def test_ssd_scan_matches_jax(chunk, initial):
    x, dt, A, Bm, Cm = _scan_inputs(2, 64, 4, 8, 2, 8)
    s0 = (np.random.default_rng(1).normal(size=(2, 4, 8, 8)).astype(np.float32)
          if initial else None)
    jy, js = jax.jit(lambda *a: jssm._ssd_scan(*a[:5], chunk, initial_state=a[5]))(
        x, dt, A, Bm, Cm, None if s0 is None else jnp.asarray(s0))
    y, s = tssm._ssd_scan(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk,
                          initial_state=None if s0 is None else _t(s0))
    assert y.dtype == torch.float32 and s.shape == (2, 4, 8, 8)
    _close(y, jy)
    _close(s, js)


def test_ssd_scan_refuses_a_ragged_last_chunk():
    """S % Q ≠ 0 is refused, as the reference's assert refuses it."""
    x, dt, A, Bm, Cm = _scan_inputs(1, 24, 2, 4, 1, 4)
    with pytest.raises(ValueError, match="not divisible"):
        tssm._ssd_scan(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), 16)


def test_causal_conv_and_softplus_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 11, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    _close(tssm._causal_conv(_t(x), _t(w)), jssm._causal_conv(jnp.asarray(x), jnp.asarray(w)))
    z = np.concatenate([rng.normal(size=100) * 10, [0.0, -90.0, 90.0]]).astype(np.float32)
    _close(tssm.softplus(_t(z)), jax.nn.softplus(jnp.asarray(z)))


def _masked_ssd_scan(xh, dt, A, Bm, Cm, chunk):
    """The reference's ``_ssd_scan`` (one chunk, no initial state) with the
    non-causal decays set to 0 before the ``exp``: the port's repair."""
    Bsz, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G
    Q = min(chunk, S)
    nc = S // Q
    f32 = jnp.float32
    xc = xh.reshape(Bsz, nc, Q, H, P).astype(f32)
    dtc = dt.reshape(Bsz, nc, Q, H).astype(f32)
    Bc = Bm.reshape(Bsz, nc, Q, G, N).astype(f32)
    Cc = Cm.reshape(Bsz, nc, Q, G, N).astype(f32)
    dtx = dtc[..., None] * xc
    cum = jnp.cumsum(A.astype(f32) * dtc, axis=2)
    cum_last = cum[:, :, -1]
    s = jnp.repeat(jnp.einsum("bcign,bcjgn->bcgij", Cc, Bc), R, axis=2)
    decay = jnp.moveaxis(cum[:, :, :, None, :] - cum[:, :, None, :, :], -1, 2)
    iq = jnp.arange(Q)
    causal = (iq[:, None] >= iq[None, :])[None, None, None]
    M = jnp.where(causal, s * jnp.exp(jnp.where(causal, decay, 0.0)), 0.0)
    y_intra = jnp.einsum("bchij,bcjhp->bcihp", M, dtx)
    w_end = jnp.exp(cum_last[:, :, None, :] - cum)
    Bfull = jnp.repeat(Bc, R, axis=3)
    chunk_states = jnp.einsum("bcjhn,bcjhp,bcjh->bchnp", Bfull, dtx, w_end)
    assert nc == 1   # one chunk: the recurrence adds exp(cum)·C·0
    return y_intra.reshape(Bsz, S, H, P), chunk_states[:, 0]


@pytest.mark.parametrize("Q", [32, 96, 128, 256])
def test_ssd_gradients_are_finite_past_sum_dt_88(Q):
    """∂/∂(x, dt, B, C) of Σ ct·y + Σ cs·state at one chunk of Q with A = −1
    and dt = softplus(unit normals), H = 2: equal to the JAX package's
    where those are finite (Q ≤ 96); past Σdt ≈ 88 (Q ≥ 128) the JAX
    package's are non-finite, the port's finite and equal to the masked
    expression's.  The forward is the JAX package's either way."""
    x, dt, _, Bm, Cm = _scan_inputs(1, Q, 2, 4, 1, 4, seed=3)
    A = -np.ones(2, np.float32)
    rng = np.random.default_rng(4)
    ct = rng.normal(size=x.shape).astype(np.float32)
    cs = rng.normal(size=(1, 2, 4, 4)).astype(np.float32)
    assert (Q >= 128) == (float(dt.sum(1).max()) > 88.0)

    def jloss(scan):
        def f(xx, dd, bb, cc):
            y, st = scan(xx, dd, jnp.asarray(A), bb, cc, Q)
            return jnp.sum(y * ct) + jnp.sum(st * cs)
        grad = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))
        return grad(*(jnp.asarray(a) for a in (x, dt, Bm, Cm)))

    def tloss(xx, dd, bb, cc):
        y, st = tssm._ssd_scan(xx, dd, _t(A), bb, cc, Q)
        return torch.sum(y * _t(ct)) + torch.sum(st * _t(cs))

    got = torch.func.grad(tloss, argnums=(0, 1, 2, 3))(*(_t(a) for a in (x, dt, Bm, Cm)))
    want = jloss(jssm._ssd_scan)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    ref_finite = all(bool(jnp.isfinite(w).all()) for w in want)
    assert ref_finite == (Q < 128)
    if not ref_finite:
        want = jloss(_masked_ssd_scan)
        assert all(bool(jnp.isfinite(w).all()) for w in want)
    for g, w in zip(got, want):
        _close(g, w, MODEL_TOL)
    # the forward values are the reference's
    jy, _ = jax.jit(lambda *a: jssm._ssd_scan(*a, Q))(*(jnp.asarray(a) for a in (x, dt, A, Bm,
                                                                                Cm)))
    y, _ = tssm._ssd_scan(*(_t(a) for a in (x, dt, A, Bm, Cm)), Q)
    _close(y, jy)


# ---------------------------------------------------------------- the mixer and its decode

@pytest.fixture(scope="module")
def mixer():
    jcfg = jget_config("mamba2-130m").reduced(max_d_model=64)
    tcfg = get_config("mamba2-130m").reduced(max_d_model=64)
    from repro.models.common import init_params as jinit
    jp = jax.jit(lambda k: jinit(k, jssm.mamba_defs(jcfg), jnp.float32))(jax.random.PRNGKey(0))
    # A_log and dt_bias init at zeros: move them off so the rates differ by head
    rng = np.random.default_rng(8)
    jp = dict(jp, A_log=jnp.asarray(0.3 * rng.normal(size=jp["A_log"].shape), jnp.float32),
              dt_bias=jnp.asarray(0.3 * rng.normal(size=jp["dt_bias"].shape), jnp.float32))
    return jcfg, tcfg, jp, convert.params_from_numpy(_np_tree(jp), "cpu")


@pytest.mark.parametrize("S", [32, 2])
def test_mamba_apply_state_and_decode_match_jax(mixer, S):
    """``mamba_apply(return_state=True)`` (conv tails padded at the front
    when S < W − 1) then 3 steps of ``mamba_decode_apply`` on its cache."""
    jcfg, tcfg, jp, tp = mixer
    x = np.random.default_rng(S).normal(size=(2, S, 64)).astype(np.float32)
    jout, jcache = jax.jit(lambda p, x: jssm.mamba_apply(p, jcfg, x, return_state=True))(
        jp, jnp.asarray(x))
    out, cache = tssm.mamba_apply(tp, tcfg, _t(x), return_state=True)
    _close(out, jout)
    _close(tssm.mamba_apply(tp, tcfg, _t(x)), jout)
    assert type(cache).__name__ == "MambaCache" and cache._fields == jcache._fields
    for f in cache._fields:
        assert tuple(getattr(cache, f).shape) == getattr(jcache, f).shape, f
        _close(getattr(cache, f), getattr(jcache, f))
    assert cache.state.dtype == torch.float32
    jdecode = jax.jit(lambda p, x, c: jssm.mamba_decode_apply(p, jcfg, x, c))
    for step in range(3):
        xs = np.random.default_rng(100 + step).normal(size=(2, 1, 64)).astype(np.float32)
        jo, jcache = jdecode(jp, jnp.asarray(xs), jcache)
        o, cache = tssm.mamba_decode_apply(tp, tcfg, _t(xs), cache)
        _close(o, jo)
        for f in cache._fields:
            _close(getattr(cache, f), getattr(jcache, f))


# ---------------------------------------------------------------- the models

@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jm = jbuild(jget_config(arch).reduced(max_d_model=64))
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        out[arch] = (jm, jp, tbuild(get_config(arch).reduced(max_d_model=64), device="cpu"),
                     convert.params_from_numpy(_np_tree(jp), "cpu"))
    return out


PLANS = {"mamba2-130m": [("mamba", "none", 2)],
         "jamba-v0.1-52b": [("mamba", "moe", 1), ("attn", "mlp", 1)]}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax(models, arch):
    jm, jp, tm, _ = models[arch]
    assert [(s.mixer, s.ff, s.count) for s in tm.cfg.layer_plan()] == PLANS[arch]
    got = tm.init(prng.PRNGKey(0))
    assert tm.n_params == jm.n_params
    jl, tl = jax.tree_util.tree_leaves(jp), utils.tree_leaves(got)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        diff = np.abs(b.numpy() - a)
        assert diff.max() <= 1e-6 and (diff > 0).mean() <= 0.02
    # the carried tree holds every leaf of the mixer (A_log, conv_*)
    mixer = utils.tree_map(lambda a: a, got["groups"][0]["mixer"])
    assert {"A_log", "D", "dt_bias", "conv_x", "conv_B", "conv_C", "norm"} <= set(mixer)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_tree_match_jax(models, arch):
    jm, jp, tm, tp = models[arch]
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, 512, (2, 32)).astype(np.int32) for k in ("tokens", "labels")}
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    grads, (loss, aux) = torch.func.grad_and_value(tm.loss_fn, has_aux=True)(
        tp, {k: _t(v) for k, v in batch.items()})
    _close(loss, jloss, MODEL_TOL)
    _close(aux["aux"], jaux["aux"], REL)
    jl, tl = jax.tree_util.tree_leaves(jgrads), utils.tree_leaves(grads)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        _close(b, a, MODEL_TOL)


def _assert_caches_close(tcache, jcache):
    want = convert.kv_cache_to_numpy(convert.kv_cache_from_numpy(_np_tree(jcache), "cpu"))
    got = convert.kv_cache_to_numpy(tcache)
    assert len(got["layers"]) == len(want["layers"])
    for g, w in zip(got["layers"], want["layers"]):
        assert g.keys() == w.keys()
        for f in g:
            assert g[f].shape == w[f].shape, f
            _close(g[f], w[f], MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(models, arch):
    jm, jp, tm, tp = models[arch]
    prompt = np.random.default_rng(6).integers(0, 512, (2, 32)).astype(np.int32)
    jlog, jcache = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, cache_len=48))(
        jp, jnp.asarray(prompt))
    tlog, tcache = tm.prefill(tp, {"tokens": _t(prompt)}, cache_len=48)
    _close(tlog, jlog, MODEL_TOL)
    _assert_caches_close(tcache, jcache)
    assert type(tcache["layers"][0]).__name__ == "MambaCache"
    jdecode = jax.jit(jm.decode_step)
    tok = np.array(jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32))
    for _ in range(4):
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(tok))
        tlog, tcache = tm.decode_step(tp, tcache, _t(tok))
        _close(tlog, jlog, MODEL_TOL)
        tok = np.array(jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32))
    _assert_caches_close(tcache, jcache)


def test_jax_hybrid_cache_carried_into_the_port_decodes_as_jax(models):
    """jamba's JAX caches (a MambaCache and a KVCache group) through
    ``kv_cache_from_numpy``, from an empty ``init_cache`` and from a
    prefill: the port's decode takes JAX's greedy tokens."""
    jm, jp, tm, tp = models["jamba-v0.1-52b"]
    jempty, tempty = jm.init_cache(2, 16, jnp.float32), tm.init_cache(2, 16, torch.float32)
    _assert_caches_close(tempty, jempty)
    prompt = np.random.default_rng(7).integers(0, 512, (2, 16)).astype(np.int32)
    jlog, jcache = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, cache_len=32))(
        jp, jnp.asarray(prompt))
    tcache = convert.kv_cache_from_numpy(_np_tree(jcache), "cpu")
    assert [type(c).__name__ for c in tcache["layers"]] == ["MambaCache", "KVCache"]
    jdecode = jax.jit(jm.decode_step)
    tok = np.array(jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32))
    ttok = tok
    for _ in range(5):
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(tok))
        tlog, tcache = tm.decode_step(tp, tcache, _t(ttok))
        tok = np.array(jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32))
        ttok = torch.argmax(tlog[:, -1:], dim=-1).to(torch.int32).numpy()
        np.testing.assert_array_equal(ttok, tok)


def test_mamba2_train_step_matches_jax(models):
    """One step of ``build_train_step`` (dp_exact, W = 8, sign_flip, seq 32
    = one chunk) from the JAX package's initial state: decisions exactly
    equal, losses and parameters within 1e-4."""
    jm, _, tm, _ = models["mamba2-130m"]
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
    js, ts = jsyn.SyntheticTokens(512, 32, seed=2), tsyn.SyntheticTokens(512, 32, seed=2)
    for i in range(steps):
        jstate, jm_ = jstep(jstate, jsyn.make_worker_batch(js, W, 2, jnp.asarray(i)), jrank,
                            jax.random.fold_in(jax.random.PRNGKey(3), i))
        tstate, tm_ = tstep(tstate, tsyn.make_worker_batch(ts, W, 2, i, device="cpu"), trank,
                            prng.fold_in(prng.PRNGKey(3), i))
        for k in ("n_alive", "byz_alive", "good_filtered", "n_byz"):
            assert int(tm_[k]) == int(jm_[k]), (i, k)
        np.testing.assert_array_equal(tstate.prev_alive.numpy(), np.asarray(jstate.prev_alive))
        _close(tm_["loss_good_workers"], jm_["loss_good_workers"], MODEL_TOL)
        _close(tm_["v_est"], jm_["v_est"], MODEL_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(jstate.params), utils.tree_leaves(tstate.params)):
        _close(b, a, MODEL_TOL)
