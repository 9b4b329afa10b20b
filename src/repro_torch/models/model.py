"""Model assembly: config → (param defs, init, forward, loss_fn, and the
serving entry points prefill, init_cache, decode_step) — the counterpart
of :mod:`repro.models.model`.

Layer stacks are grouped into homogeneous :class:`BlockSpec` groups
(``cfg.layer_plan()``) with each group's parameters stacked on a leading
layer axis, as in the JAX package; the JAX ``lax.scan`` over that axis is
a Python loop over it here.  The JAX package's per-layer
``jax.checkpoint`` changes no value and is left out; ``shard_act`` (mesh
annotations) has no counterpart on one card.

The LM loss is computed in sequence chunks of ``LOSS_CHUNK`` (one chunk
when the chunk does not divide S), so the (B, S, V) logits exist one
chunk at a time.

The port holds every mixer (``attn``/``swa``/``mla``: :mod:`.attention`;
``mamba``: :mod:`.ssm`) and feed-forward (``mlp``, ``moe``: :mod:`.moe`,
``none``), the encoder-decoder (a bidirectional encoder over the
frontend's frames, cross attention in every decoder block against the
encoder's output projected a layer) and the frontends without an encoder
(the frames projected and put before the tokens; ``forward`` returns that
prefix and ``loss_fn`` drops it), so every config of
:mod:`repro_torch.configs` runs for training (``init``, ``abstract``,
``forward``, ``loss_fn``; the MoE layers' aux loss summed over layers into
``router_aux_weight·aux``) and for serving (``prefill``, ``init_cache``,
``decode_step`` on the KV, int8, MLA and Mamba caches, with the
cross-attention memory in ``cache["memory_kv"]``; serving drops the aux).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (
    ParamDef,
    init_params,
    meta_params,
    mlp_apply,
    mlp_defs,
    param_count,
    resolve_dtype,
    rms_norm,
)
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32
LOSS_CHUNK = 512  # sequence chunk of the CE loss


# ---------------------------------------------------------------------------
# parameter definitions
# ---------------------------------------------------------------------------

def _norm_def(d: int) -> ParamDef:
    return ParamDef((d,), ("embed",), init="ones")


def _mixer_defs(spec: BlockSpec, cfg: ModelConfig) -> dict:
    if spec.mixer in ("attn", "swa"):
        return attn_lib.attn_defs(cfg)
    if spec.mixer == "mla":
        return attn_lib.mla_defs(cfg)
    if spec.mixer == "mamba":
        return ssm_lib.mamba_defs(cfg)
    raise ValueError(spec.mixer)


def _ff_defs(spec: BlockSpec, cfg: ModelConfig) -> dict:
    if spec.ff == "mlp":
        return mlp_defs(cfg.d_model, cfg.d_ff)
    if spec.ff == "moe":
        return moe_lib.moe_defs(cfg)
    if spec.ff == "none":
        return {}
    raise ValueError(spec.ff)


def _block_defs(spec: BlockSpec, cfg: ModelConfig, cross: bool) -> dict:
    d = {
        "norm1": _norm_def(cfg.d_model),
        "mixer": _mixer_defs(spec, cfg),
        "norm2": _norm_def(cfg.d_model),
        "ff": _ff_defs(spec, cfg),
    }
    if cross:
        d["cross_norm"] = _norm_def(cfg.d_model)
        d["cross"] = attn_lib.attn_defs(dataclasses.replace(cfg, n_kv_heads=cfg.n_heads))
    return d


def _stack_defs(defs: dict, n: int) -> dict:
    return tree_map(lambda d: d.with_leading(n), defs, is_leaf=lambda x: isinstance(x, ParamDef))


def model_defs(cfg: ModelConfig) -> dict:
    """Full ParamDef tree for the model."""
    defs: dict[str, Any] = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed_table"), init="embed"),
        "final_norm": _norm_def(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    defs["groups"] = [_stack_defs(_block_defs(spec, cfg, cross=cfg.enc_dec), spec.count)
                      for spec in cfg.layer_plan()]
    if cfg.frontend != "none" and not cfg.enc_dec:
        defs["frontend_proj"] = ParamDef((cfg.frontend_dim, cfg.d_model), (None, "embed"))
    if cfg.enc_dec:
        enc_spec = BlockSpec(mixer="attn", ff="mlp", count=cfg.n_enc_layers)
        defs["enc"] = {
            "proj": ParamDef((cfg.frontend_dim or cfg.d_model, cfg.d_model), (None, "embed")),
            "group": _stack_defs(_block_defs(enc_spec, cfg, cross=False), cfg.n_enc_layers),
            "norm": _norm_def(cfg.d_model),
        }
    return defs


# ---------------------------------------------------------------------------
# forward blocks
# ---------------------------------------------------------------------------

def _apply_mixer(spec: BlockSpec, cfg: ModelConfig, p: dict, x, positions):
    if spec.mixer == "attn":
        return attn_lib.gqa_apply(p, cfg, x, positions, window=None)
    if spec.mixer == "swa":
        return attn_lib.gqa_apply(p, cfg, x, positions, window=cfg.sliding_window)
    if spec.mixer == "mla":
        return attn_lib.mla_apply(p, cfg, x, positions)
    if spec.mixer == "mamba":
        return ssm_lib.mamba_apply(p, cfg, x)
    raise ValueError(spec.mixer)


def _apply_ff(spec: BlockSpec, cfg: ModelConfig, p: dict, x):
    """The block's feed-forward and its aux loss (the MoE router's, else 0)."""
    if spec.ff == "mlp":
        return mlp_apply(p, x), 0.0
    if spec.ff == "moe":
        return moe_lib.moe_apply(p, cfg, x)
    return torch.zeros_like(x), 0.0


def _block_apply(spec: BlockSpec, cfg: ModelConfig, p: dict, x, positions, memory_kv=None):
    """One transformer block (pre-norm residual), with the cross attention
    over ``memory_kv`` after the mixer when given.  Returns (x, aux)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + _apply_mixer(spec, cfg, p["mixer"], h, positions)
    if memory_kv is not None:
        h = rms_norm(x, p["cross_norm"], cfg.norm_eps)
        x = x + attn_lib.cross_attn_apply(p["cross"], cfg, h, *memory_kv)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    ff, aux = _apply_ff(spec, cfg, p["ff"], h)
    return x + ff, aux


def _unstack(tree, n: int) -> list:
    """A group's stacked leaves as ``n`` per-layer trees, by ``torch.unbind``:
    its backward stacks the layers' gradients in one op, where indexing layer
    by layer would add ``n`` zero-padded full-size gradients a leaf (the same
    values either way)."""
    parts = [torch.unbind(a, 0) for a in tree_leaves(tree)]
    return [tree_unflatten(tree, [p[i] for p in parts]) for i in range(n)]


def _run_groups(cfg: ModelConfig, groups_params, x, positions, memory=None):
    """Each homogeneous group, layer by layer along its stacked axis; with
    the encoder's ``memory`` each layer projects it for its cross
    attention.  Returns (x, aux) with aux an f32 0-d tensor."""
    aux_total = torch.zeros((), dtype=F32, device=x.device)
    for spec, gp in zip(cfg.layer_plan(), groups_params):
        for lp in _unstack(gp, spec.count):
            mem_kv = None if memory is None else attn_lib.project_memory(lp["cross"], memory)
            x, a = _block_apply(spec, cfg, lp, x, positions, mem_kv)
            aux_total = aux_total + a
    return x, aux_total


def _run_encoder(cfg: ModelConfig, enc_params, frames):
    """The bidirectional encoder over the frontend's frames: (B, Sm, F) →
    (B, Sm, D)."""
    x = torch.einsum("bsf,fd->bsd", frames, enc_params["proj"]).to(frames.dtype)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for lp in _unstack(enc_params["group"], cfg.n_enc_layers):
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        x = x + attn_lib.encoder_attn_apply(lp["mixer"], cfg, h, positions)
        h = rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + mlp_apply(lp["ff"], h)
    return rms_norm(x, enc_params["norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# losses (chunked)
# ---------------------------------------------------------------------------

def _lm_head(cfg: ModelConfig, params, h):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w


def _chunked_ce(cfg: ModelConfig, params, h, labels, mask):
    """CE over sequence chunks; h: (B,S,D), labels/mask: (B,S)."""
    B, S, D = h.shape
    c = min(LOSS_CHUNK, S)
    n = S // c if S % c == 0 else 1
    c = S // n
    tot = torch.zeros((), dtype=F32, device=h.device)
    cnt = torch.zeros((), dtype=F32, device=h.device)
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        logits32 = _lm_head(cfg, params, h[:, sl]).to(F32)
        lse = torch.logsumexp(logits32, dim=-1)
        gold = torch.gather(logits32, -1, labels[:, sl, None].long())[..., 0]
        nll = (lse - gold) * mask[:, sl]
        tot = tot + torch.sum(nll)
        cnt = cnt + torch.sum(mask[:, sl])
    return tot / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _cache_len(spec: BlockSpec, cfg: ModelConfig, length: int) -> int:
    """A group's cache capacity: ``swa`` layers keep min(length, window)."""
    if spec.mixer == "swa" and cfg.sliding_window:
        return min(length, cfg.sliding_window)
    return length


def _group_cache(spec: BlockSpec, cfg: ModelConfig, batch: int, length: int, dtype, device):
    """One empty cache a layer of the group, stacked on a leading layer axis."""
    if spec.mixer in ("attn", "swa"):
        one = attn_lib.init_kv_cache(cfg, batch, _cache_len(spec, cfg, length), dtype, device)
    elif spec.mixer == "mla":
        one = attn_lib.init_mla_cache(cfg, batch, length, dtype, device)
    elif spec.mixer == "mamba":
        one = ssm_lib.init_mamba_cache(cfg, batch, dtype, device)
    else:
        raise ValueError(spec.mixer)
    return tree_map(lambda a: a.expand(spec.count, *a.shape).clone(), one)


def _stack_layers(caches: list):
    """Per-layer caches of one group as one cache with a leading layer axis."""
    return tree_map(lambda *xs: torch.stack(xs), caches[0], *caches[1:])


# ---------------------------------------------------------------------------
# public bundle
# ---------------------------------------------------------------------------

class LanguageModel(NamedTuple):
    cfg: ModelConfig
    defs: dict
    init: Callable            # (key) -> params, on the model's device
    abstract: Callable        # () -> meta-device tree (shapes and dtypes only)
    loss_fn: Callable         # (params, batch) -> (loss, metrics)
    forward: Callable         # (params, batch) -> (hidden (B,S,D), aux, prefix)
    prefill: Callable         # (params, batch, cache_len) -> (last_logits, cache)
    decode_step: Callable     # (params, cache, token, extras) -> (logits, cache)
    init_cache: Callable      # (batch, length, dtype) -> cache
    n_params: int
    device: torch.device


def build_model(cfg: ModelConfig, device="cuda") -> LanguageModel:
    """The model of ``cfg`` on ``device`` (the card unless the caller asks
    for the CPU): ``init(key)`` draws the parameters there."""
    defs = model_defs(cfg)
    dev = resolve_device(device)
    pdt = resolve_dtype(cfg.param_dtype)
    adt = resolve_dtype(cfg.activation_dtype)

    def embed_inputs(params, batch):
        """The tokens' embeddings, after the frontend's projected frames when
        the model has a frontend and no encoder; and that prefix's length."""
        x = params["embed"][batch["tokens"].long()].to(adt)
        if cfg.frontend != "none" and not cfg.enc_dec:
            fe = batch["frontend"].to(adt)                                  # (B, F, fd)
            fx = torch.einsum("bfe,ed->bfd", fe, params["frontend_proj"]).to(adt)
            return torch.cat([fx, x], dim=1), fe.shape[1]
        return x, 0

    def encode(params, batch):
        return (_run_encoder(cfg, params["enc"], batch["frontend"].to(adt)) if cfg.enc_dec
                else None)

    def forward(params, batch):
        x, prefix = embed_inputs(params, batch)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        x, aux = _run_groups(cfg, params["groups"], x, positions, memory=encode(params, batch))
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux, prefix

    def loss_fn(params, batch):
        h, aux, prefix = forward(params, batch)
        labels = batch["labels"]
        if prefix:
            h = h[:, prefix:]
        mask = batch.get("loss_mask")
        mask = torch.ones_like(labels, dtype=F32) if mask is None else mask.to(F32)
        ce = _chunked_ce(cfg, params, h, labels, mask)
        loss = ce + cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    def prefill(params, batch, cache_len: int):
        """A whole prompt (with its frontend, when the model has one) →
        (last-token logits (B, 1, V), decode cache)."""
        x, _ = embed_inputs(params, batch)
        S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        pos_final = torch.full((), S, dtype=torch.int32, device=x.device)
        memory = encode(params, batch)
        layer_caches, memory_kvs = [], []
        for spec, gp in zip(cfg.layer_plan(), params["groups"]):
            win = cfg.sliding_window if spec.mixer == "swa" else None
            caches, mems = [], []
            for lp in _unstack(gp, spec.count):
                h = rms_norm(x, lp["norm1"], cfg.norm_eps)
                if spec.mixer == "mamba":
                    o, lc = ssm_lib.mamba_apply(lp["mixer"], cfg, h, return_state=True)
                elif spec.mixer == "mla":
                    o, (c, kr) = attn_lib.mla_apply(lp["mixer"], cfg, h, positions,
                                                    return_kv=True)
                    lc = attn_lib.mla_cache_from_prefill(c, kr, cache_len, pos_final)
                else:
                    o, (k, v) = attn_lib.gqa_apply(lp["mixer"], cfg, h, positions, window=win,
                                                   return_kv=True)
                    lc = attn_lib.cache_from_prefill(
                        k, v, _cache_len(spec, cfg, cache_len), pos_final,
                        quantize=cfg.kv_cache_dtype == "int8")
                caches.append(lc)
                x = x + o
                if memory is not None:
                    hh = rms_norm(x, lp["cross_norm"], cfg.norm_eps)
                    mem_kv = attn_lib.project_memory(lp["cross"], memory)
                    x = x + attn_lib.cross_attn_apply(lp["cross"], cfg, hh, *mem_kv)
                    mems.append(mem_kv)
                h = rms_norm(x, lp["norm2"], cfg.norm_eps)
                ff, _ = _apply_ff(spec, cfg, lp["ff"], h)
                x = x + ff
            layer_caches.append(_stack_layers(caches))
            if memory is not None:
                memory_kvs.append(tuple(torch.stack(t) for t in zip(*mems)))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        cache = {"layers": layer_caches}
        if cfg.enc_dec:
            cache["memory_kv"] = memory_kvs
        return _lm_head(cfg, params, x[:, -1:, :]), cache

    def init_cache(batch: int, length: int, dtype=None):
        """Empty caches of capacity ``length`` on the model's device; an
        encoder-decoder's also holds a zero cross-attention memory of
        ``enc_seq_len`` a layer (all heads)."""
        dtype = dtype or adt
        cache = {"layers": [_group_cache(spec, cfg, batch, length, dtype, dev)
                            for spec in cfg.layer_plan()]}
        if cfg.enc_dec:
            shape = (batch, cfg.enc_seq_len, cfg.n_heads, cfg.head_dim)
            cache["memory_kv"] = [
                tuple(torch.zeros((spec.count, *shape), dtype=dtype, device=dev)
                      for _ in range(2))
                for spec in cfg.layer_plan()]
        return cache

    def decode_step(params, cache, token, extras=None):
        """token: (B, 1) int → (logits (B, 1, V), cache')."""
        x = params["embed"][token.long()].to(adt)
        new_layers = []
        for gi, (spec, gp) in enumerate(zip(cfg.layer_plan(), params["groups"])):
            gcache = cache["layers"][gi]
            mems = ([tuple(pair) for pair in zip(*(torch.unbind(t, 0)
                                                  for t in cache["memory_kv"][gi]))]
                    if cfg.enc_dec else [None] * spec.count)
            caches = []
            for lp, lc, mem in zip(_unstack(gp, spec.count), _unstack(gcache, spec.count), mems):
                h = rms_norm(x, lp["norm1"], cfg.norm_eps)
                if spec.mixer == "mamba":
                    o, lc = ssm_lib.mamba_decode_apply(lp["mixer"], cfg, h, lc)
                elif spec.mixer == "mla":
                    o, lc = attn_lib.mla_decode_apply(lp["mixer"], cfg, h, lc)
                else:
                    o, lc = attn_lib.gqa_decode_apply(lp["mixer"], cfg, h, lc)
                x = x + o
                if mem is not None:
                    hh = rms_norm(x, lp["cross_norm"], cfg.norm_eps)
                    x = x + attn_lib.cross_attn_apply(lp["cross"], cfg, hh, *mem)
                h = rms_norm(x, lp["norm2"], cfg.norm_eps)
                ff, _ = _apply_ff(spec, cfg, lp["ff"], h)
                x = x + ff
                caches.append(lc)
            new_layers.append(_stack_layers(caches))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        new = dict(cache)
        new["layers"] = new_layers
        return _lm_head(cfg, params, x), new

    def init(key):
        return init_params(key.to(dev), defs, pdt)

    return LanguageModel(
        cfg=cfg, defs=defs, init=init, abstract=lambda: meta_params(defs, pdt),
        loss_fn=loss_fn, forward=forward, prefill=prefill, decode_step=decode_step,
        init_cache=init_cache, n_params=param_count(defs), device=dev,
    )
