"""Model assembly, the training half: config → (param defs, init,
forward, loss_fn) — the counterpart of :mod:`repro.models.model`.

Layer stacks are grouped into homogeneous :class:`BlockSpec` groups
(``cfg.layer_plan()``) with each group's parameters stacked on a leading
layer axis, as in the JAX package; the JAX ``lax.scan`` over that axis is
a Python loop over it here.  The JAX package's per-layer
``jax.checkpoint`` changes no value and is left out; ``shard_act`` (mesh
annotations) has no counterpart on one card.

The LM loss is computed in sequence chunks of ``LOSS_CHUNK`` (one chunk
when the chunk does not divide S), so the (B, S, V) logits exist one
chunk at a time.

This slice ports the dense decoder: the ``attn``/``swa`` mixers and the
``mlp``/``none`` feed-forward.  MLA, Mamba, MoE, encoder–decoder and
frontend configs, and ``prefill``, ``decode_step``, ``init_cache`` and
``abstract``, raise NotImplementedError (``ROADMAP.md`` §1 item 8).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models import attention as attn_lib
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
from repro_torch.utils import tree_map

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
    if spec.mixer in ("mla", "mamba"):
        _later(f"the {spec.mixer!r} mixer")
    raise ValueError(spec.mixer)


def _ff_defs(spec: BlockSpec, cfg: ModelConfig) -> dict:
    if spec.ff == "mlp":
        return mlp_defs(cfg.d_model, cfg.d_ff)
    if spec.ff == "moe":
        _later("the 'moe' feed-forward")
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
    raise ValueError(spec.mixer)


def _apply_ff(spec: BlockSpec, cfg: ModelConfig, p: dict, x):
    if spec.ff == "mlp":
        return mlp_apply(p, x), 0.0
    return torch.zeros_like(x), 0.0


def _block_apply(spec: BlockSpec, cfg: ModelConfig, p: dict, x, positions):
    """One transformer block (pre-norm residual).  Returns (x, aux)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + _apply_mixer(spec, cfg, p["mixer"], h, positions)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    ff, aux = _apply_ff(spec, cfg, p["ff"], h)
    return x + ff, aux


def _run_groups(cfg: ModelConfig, groups_params, x, positions):
    """Each homogeneous group, layer by layer along its stacked axis.
    Returns (x, aux) with aux an f32 0-d tensor."""
    aux_total = torch.zeros((), dtype=F32, device=x.device)
    for spec, gp in zip(cfg.layer_plan(), groups_params):
        for i in range(spec.count):
            lp = tree_map(lambda a: a[i], gp)
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
# public bundle
# ---------------------------------------------------------------------------

class LanguageModel(NamedTuple):
    cfg: ModelConfig
    defs: dict
    init: Callable            # (key) -> params, on the model's device
    abstract: Callable        # () -> meta-device tree (shapes and dtypes only)
    loss_fn: Callable         # (params, batch) -> (loss, metrics)
    forward: Callable         # (params, batch) -> (hidden (B,S,D), aux, prefix)
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    n_params: int
    device: torch.device


def build_model(cfg: ModelConfig, device="cuda") -> LanguageModel:
    """The dense decoder of ``cfg`` on ``device`` (the card unless the
    caller asks for the CPU): ``init(key)`` draws the parameters there."""
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

    def serving(*args, **kwargs):
        _later("serving (prefill, decode_step, init_cache)")

    def init(key):
        return init_params(key.to(dev), defs, pdt)

    return LanguageModel(
        cfg=cfg, defs=defs, init=init, abstract=lambda: meta_params(defs, pdt),
        loss_fn=loss_fn, forward=forward, prefill=serving, decode_step=serving,
        init_cache=serving, n_params=param_count(defs), device=dev,
    )
