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

The port holds the ``attn``/``swa`` (:mod:`.attention`) and ``mamba``
(:mod:`.ssm`) mixers and the ``mlp``, ``moe`` (:mod:`.moe`) and ``none``
feed-forwards, so the dense decoders, the MoE decoder (kimi-k2), the pure
SSM (mamba2) and the hybrid (jamba) run for training (``init``,
``abstract``, ``forward``, ``loss_fn``; the MoE layers' aux loss summed
over layers into ``router_aux_weight·aux``) and for serving (``prefill``,
``init_cache``, ``decode_step`` on the KV, int8 and Mamba caches; serving
drops the aux).  MLA, encoder–decoder and frontend configs, and the MLA
cache, raise NotImplementedError (``ROADMAP.md`` §1 item 8).
"""
from __future__ import annotations

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
_LATER = "is not ported yet (ROADMAP.md §1 item 8)"


def _later(what: str):
    raise NotImplementedError(f"repro_torch.models: {what} {_LATER}")


# ---------------------------------------------------------------------------
# parameter definitions
# ---------------------------------------------------------------------------

def _norm_def(d: int) -> ParamDef:
    return ParamDef((d,), ("embed",), init="ones")


def _mixer_defs(spec: BlockSpec, cfg: ModelConfig) -> dict:
    if spec.mixer in ("attn", "swa"):
        return attn_lib.attn_defs(cfg)
    if spec.mixer == "mamba":
        return ssm_lib.mamba_defs(cfg)
    if spec.mixer == "mla":
        _later("the 'mla' mixer")
    raise ValueError(spec.mixer)


def _ff_defs(spec: BlockSpec, cfg: ModelConfig) -> dict:
    if spec.ff == "mlp":
        return mlp_defs(cfg.d_model, cfg.d_ff)
    if spec.ff == "moe":
        return moe_lib.moe_defs(cfg)
    if spec.ff == "none":
        return {}
    raise ValueError(spec.ff)


def _block_defs(spec: BlockSpec, cfg: ModelConfig) -> dict:
    return {
        "norm1": _norm_def(cfg.d_model),
        "mixer": _mixer_defs(spec, cfg),
        "norm2": _norm_def(cfg.d_model),
        "ff": _ff_defs(spec, cfg),
    }


def _stack_defs(defs: dict, n: int) -> dict:
    return tree_map(lambda d: d.with_leading(n), defs, is_leaf=lambda x: isinstance(x, ParamDef))


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.enc_dec:
        _later("the encoder-decoder model")
    if cfg.frontend != "none":
        _later(f"the {cfg.frontend!r} frontend")


def model_defs(cfg: ModelConfig) -> dict:
    """Full ParamDef tree for the model."""
    _check_supported(cfg)
    defs: dict[str, Any] = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed_table"), init="embed"),
        "final_norm": _norm_def(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    defs["groups"] = [_stack_defs(_block_defs(spec, cfg), spec.count)
                      for spec in cfg.layer_plan()]
    return defs


# ---------------------------------------------------------------------------
# forward blocks
# ---------------------------------------------------------------------------

def _apply_mixer(spec: BlockSpec, cfg: ModelConfig, p: dict, x, positions):
    if spec.mixer == "attn":
        return attn_lib.gqa_apply(p, cfg, x, positions, window=None)
    if spec.mixer == "swa":
        return attn_lib.gqa_apply(p, cfg, x, positions, window=cfg.sliding_window)
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


def _block_apply(spec: BlockSpec, cfg: ModelConfig, p: dict, x, positions):
    """One transformer block (pre-norm residual).  Returns (x, aux)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + _apply_mixer(spec, cfg, p["mixer"], h, positions)
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


def _run_groups(cfg: ModelConfig, groups_params, x, positions):
    """Each homogeneous group, layer by layer along its stacked axis.
    Returns (x, aux) with aux an f32 0-d tensor."""
    aux_total = torch.zeros((), dtype=F32, device=x.device)
    for spec, gp in zip(cfg.layer_plan(), groups_params):
        for lp in _unstack(gp, spec.count):
            x, a = _block_apply(spec, cfg, lp, x, positions)
            aux_total = aux_total + a
    return x, aux_total


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
    elif spec.mixer == "mamba":
        one = ssm_lib.init_mamba_cache(cfg, batch, dtype, device)
    elif spec.mixer == "mla":
        _later("the 'mla' decode cache")
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

    def forward(params, batch):
        tokens = batch["tokens"]
        x = params["embed"][tokens.long()].to(adt)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        x, aux = _run_groups(cfg, params["groups"], x, positions)
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux, 0

    def loss_fn(params, batch):
        h, aux, _ = forward(params, batch)
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        mask = torch.ones_like(labels, dtype=F32) if mask is None else mask.to(F32)
        ce = _chunked_ce(cfg, params, h, labels, mask)
        loss = ce + cfg.router_aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    def prefill(params, batch, cache_len: int):
        """A whole prompt → (last-token logits (B, 1, V), decode cache)."""
        tokens = batch["tokens"]
        x = params["embed"][tokens.long()].to(adt)
        S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        pos_final = torch.full((), S, dtype=torch.int32, device=x.device)
        layer_caches = []
        for spec, gp in zip(cfg.layer_plan(), params["groups"]):
            win = cfg.sliding_window if spec.mixer == "swa" else None
            caches = []
            for lp in _unstack(gp, spec.count):
                h = rms_norm(x, lp["norm1"], cfg.norm_eps)
                if spec.mixer == "mamba":
                    o, lc = ssm_lib.mamba_apply(lp["mixer"], cfg, h, return_state=True)
                else:
                    o, (k, v) = attn_lib.gqa_apply(lp["mixer"], cfg, h, positions, window=win,
                                                   return_kv=True)
                    lc = attn_lib.cache_from_prefill(
                        k, v, _cache_len(spec, cfg, cache_len), pos_final,
                        quantize=cfg.kv_cache_dtype == "int8")
                caches.append(lc)
                x = x + o
                h = rms_norm(x, lp["norm2"], cfg.norm_eps)
                ff, _ = _apply_ff(spec, cfg, lp["ff"], h)
                x = x + ff
            layer_caches.append(_stack_layers(caches))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return _lm_head(cfg, params, x[:, -1:, :]), {"layers": layer_caches}

    def init_cache(batch: int, length: int, dtype=None):
        """Empty caches of capacity ``length`` on the model's device."""
        return {"layers": [_group_cache(spec, cfg, batch, length, dtype or adt, dev)
                           for spec in cfg.layer_plan()]}

    def decode_step(params, cache, token, extras=None):
        """token: (B, 1) int → (logits (B, 1, V), cache')."""
        x = params["embed"][token.long()].to(adt)
        new_layers = []
        for gi, (spec, gp) in enumerate(zip(cfg.layer_plan(), params["groups"])):
            gcache = cache["layers"][gi]
            caches = []
            for lp, lc in zip(_unstack(gp, spec.count), _unstack(gcache, spec.count)):
                h = rms_norm(x, lp["norm1"], cfg.norm_eps)
                if spec.mixer == "mamba":
                    o, lc = ssm_lib.mamba_decode_apply(lp["mixer"], cfg, h, lc)
                else:
                    o, lc = attn_lib.gqa_decode_apply(lp["mixer"], cfg, h, lc)
                x = x + o
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
