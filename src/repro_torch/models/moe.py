"""Mixture-of-Experts FFN with capacity-based scatter dispatch (the
counterpart of :mod:`repro.models.moe`).

Each token's top-k choices are scattered into a per-expert capacity
buffer ``(E, C, D)``, the experts' SwiGLU runs as batched products over
that buffer, and the outputs are gathered back, combine-weighted.  The
numerics follow the JAX package step for step:

* the router product and its softmax in f32; the top k sorted, the lower
  expert index first on ties (``jax.lax.top_k``); the top-k weights
  normalised by ``max(Σ, 1e-9)``;
* the Switch-style aux loss ``E·Σ(mean(probs)·mean(onehot)/K)``;
* ``C = min(max(int(T·K/E·capacity_factor), 4), T)``;
* positions in an expert's buffer are choice-major (every token's first
  choice before any token's second), a cumsum of the one-hot;
* a dropped choice adds a zero update at slot ``min(pos, C − 1)``;
* ``silu`` in f32, cast back; the combine sums ``w·h`` in f32 over the
  choices in order, casts to x's dtype, then adds the shared expert.

The buffer is built out of place (``index_add`` on a fresh zeros) and the
one-hot is a comparison with ``arange(E)``, so the layer runs under the
trainer's ``torch.func.vmap`` over workers.  A kept (expert, slot) holds
exactly one token, so the buffer is the JAX package's bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, swiglu

F32 = torch.float32


def moe_defs(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    defs = {
        "router": ParamDef((d, e), ("embed", None), scale=0.1),
        "gate": ParamDef((e, d, f), ("experts", "embed", "mlp")),
        "up": ParamDef((e, d, f), ("experts", "embed", "mlp")),
        "down": ParamDef((e, f, d), ("experts", "mlp", "embed")),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        defs["shared"] = {
            "gate": ParamDef((d, fs), ("embed", "mlp")),
            "up": ParamDef((d, fs), ("embed", "mlp")),
            "down": ParamDef((fs, d), ("mlp", "embed")),
        }
    return defs


class Routes(NamedTuple):
    probs: torch.Tensor   # (T, E) f32 softmax of the router logits
    top_p: torch.Tensor   # (T, K) f32 normalised weights of the choices
    top_e: torch.Tensor   # (T, K) int64 experts, best first


def route(router: torch.Tensor, xt: torch.Tensor, k: int) -> Routes:
    """The router over tokens ``xt`` (T, D): f32 product, softmax, the top
    ``k`` (ties to the lower index, as ``jax.lax.top_k``) and their
    normalised weights."""
    probs = torch.softmax(xt.to(F32) @ router.to(F32), dim=-1)
    # a stable descending sort keeps equal probabilities in index order
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp(torch.sum(top_p, dim=-1, keepdim=True), min=1e-9)
    return Routes(probs, top_p, top_e)


def capacity(cfg: ModelConfig, T: int) -> int:
    """Slots an expert's buffer holds for T tokens (the JAX package's float
    expression, in its order)."""
    return min(max(int(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 4), T)


def _onehot(e: torch.Tensor, E: int, dtype) -> torch.Tensor:
    return (e[..., None] == torch.arange(E, device=e.device)).to(dtype)


def dispatch(top_e: torch.Tensor, E: int, C: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Choice-major positions of each (token, choice) in its expert's
    buffer, (K, T) int64, and whether it fits, (K, T) bool."""
    T, K = top_e.shape
    flat_e = top_e.T.reshape(K * T)
    onehot = _onehot(flat_e, E, torch.int64)                    # (K·T, E)
    pos = torch.sum((torch.cumsum(onehot, dim=0) - 1) * onehot, dim=1)
    return pos.reshape(K, T), (pos < C).reshape(K, T)


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out (B, S, D), aux_loss () f32)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    probs, top_p, top_e = route(p["router"], xt, K)

    # Switch-style load-balance aux loss
    me = torch.mean(probs, dim=0)
    onehot_tot = _onehot(top_e[:, 0], E, F32)
    for j in range(1, K):
        onehot_tot = onehot_tot + _onehot(top_e[:, j], E, F32)
    ce = torch.mean(onehot_tot, dim=0) / K
    aux = E * torch.sum(me * ce)

    C = capacity(cfg, T)
    pos, keep = dispatch(top_e, E, C)
    slot = torch.clamp(pos, max=C - 1)
    flat_slot = top_e.T * C + slot                               # (K, T) into E·C rows

    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    buf = torch.zeros((E * C, D), dtype=x.dtype, device=x.device)
    for j in range(K):
        # a dropped choice adds zeros at its clamped slot
        buf = buf.index_add(0, flat_slot[j], torch.where(keep[j][:, None], xt, zero))
    buf = buf.reshape(E, C, D)

    g = torch.bmm(buf, p["gate"])
    u = torch.bmm(buf, p["up"])
    hmid = F.silu(g.to(F32)).to(buf.dtype) * u
    h = torch.bmm(hmid, p["down"]).reshape(E * C, D)

    out = torch.zeros((T, D), dtype=F32, device=x.device)
    for j in range(K):
        w = torch.where(keep[j], top_p[:, j], zero.to(F32))
        out = out + w[:, None] * h[flat_slot[j]].to(F32)

    out = out.to(x.dtype).reshape(B, S, D)
    if "shared" in p:
        sh = p["shared"]
        out = out + swiglu(x, sh["gate"], sh["up"], sh["down"])
    return out, aux.to(F32)
