"""Attention mixers for training: GQA and sliding-window GQA (the
counterpart of the train half of :mod:`repro.models.attention`).

Attention is chunked over KV blocks with an online softmax (the
flash-attention recurrence in plain PyTorch): the (S, S) score matrix never
materialises, the peak temporary is (Sq, chunk).  The JAX package's
``lax.scan`` over blocks is a Python loop over the same blocks, in the
same order, with the same guards for a block where every score is masked
and for a −inf running maximum.

MLA, the encoder and cross attention and the decode caches (KV, int8)
wait for a later slice (``ROADMAP.md`` §1 item 8).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, apply_rope

F32 = torch.float32


def attn_defs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": ParamDef((d, h, hd), ("embed", "heads", None)),
        "wk": ParamDef((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": ParamDef((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": ParamDef((h, hd, d), ("heads", None, "embed")),
    }


def _chunk_pad(x: torch.Tensor, chunk: int, axis: int):
    """Zero-pad ``axis`` to a multiple of ``chunk`` and split it into
    (n_chunks, chunk)."""
    s = x.shape[axis]
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        tail = list(x.shape)
        tail[axis] = pad
        x = torch.cat([x, torch.zeros(tail, dtype=x.dtype, device=x.device)], dim=axis)
    new_shape = x.shape[:axis] + (n_chunks, chunk) + x.shape[axis + 1:]
    return x.reshape(new_shape), n_chunks


def chunked_attention(
    q: torch.Tensor,            # (B, Sq, H, hd)   — RoPE already applied
    k: torch.Tensor,            # (B, Sk, KV, hd)  — RoPE already applied
    v: torch.Tensor,            # (B, Sk, KV, dv)
    q_positions: torch.Tensor,  # (Sq,)
    k_positions: torch.Tensor,  # (Sk,)
    causal: bool = True,
    window: Optional[int] = None,
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ``chunk``; the output
    takes v's head dim and q's dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    dv = v.shape[-1]
    R = H // KV
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))

    qg = q.reshape(B, Sq, KV, R, hd).to(F32)
    kc, n_chunks = _chunk_pad(k, chunk, axis=1)                         # (B, C, ck, KV, hd)
    vc, _ = _chunk_pad(v, chunk, axis=1)
    pc, _ = _chunk_pad(k_positions.to(torch.int32), chunk, axis=0)      # (C, ck)
    valid_c, _ = _chunk_pad(torch.ones_like(k_positions, dtype=torch.bool), chunk, axis=0)

    m = torch.full((B, KV, R, Sq), -math.inf, dtype=F32, device=q.device)
    l = torch.zeros((B, KV, R, Sq), dtype=F32, device=q.device)
    acc = torch.zeros((B, KV, R, Sq, dv), dtype=F32, device=q.device)
    for c in range(n_chunks):
        k_blk, v_blk, p_blk, ok_blk = kc[:, c], vc[:, c], pc[c], valid_c[c]
        s = torch.einsum("bqkrh,bckh->bkrqc", qg, k_blk.to(F32)) * scale   # (B,KV,R,Sq,ck)
        mask = ok_blk[None, :]
        if causal:
            mask = mask & (q_positions[:, None] >= p_blk[None, :])
        if window is not None:
            mask = mask & (q_positions[:, None] - p_blk[None, :] < window)
        s = torch.where(mask[None, None, None], s, -math.inf)

        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # the all-masked case (exp(-inf - -inf)) contributes 0
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = corr * l + torch.sum(p, dim=-1)
        pv = torch.einsum("bkrqc,bckh->bkrqh", p, v_blk.to(F32))
        acc = corr[..., None] * acc + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = torch.movedim(out, 3, 1)                                      # (B, Sq, KV, R, dv)
    return out.reshape(B, Sq, H, dv).to(q.dtype)


def gqa_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
              window: Optional[int] = None) -> torch.Tensor:
    """x: (B, S, D) → (B, S, D), causal, sliding when ``window`` is set."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = chunked_attention(q, k, v, positions, positions, causal=True, window=window,
                          chunk=cfg.attn_chunk)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])
