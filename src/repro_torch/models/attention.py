"""Attention mixers: GQA, sliding-window GQA and MLA (DeepSeek's latent
KV) for training and prefill, the encoder's bidirectional attention and
the decoder's cross attention, and the decode caches (the counterpart of
:mod:`repro.models.attention`).

Attention is chunked over KV blocks with an online softmax (the
flash-attention recurrence in plain PyTorch): the (S, S) score matrix never
materialises, the peak temporary is (Sq, chunk).  The JAX package's
``lax.scan`` over blocks is a Python loop over the same blocks, in the
same order, with the same guards for a block where every score is masked
and for a −inf running maximum.

Decode keeps a preallocated cache: :class:`KVCache` (the activations'
dtype) or :class:`QuantKVCache` (int8 values, f16 absmax scales a slot
and head), written as a ring (slot = pos % L) and read by a one-query
attention.  MLA's :class:`MLACache` keeps the latent and the shared RoPE
key a token, and its decode scores in the absorbed form (q·W_uk against
the latent); its mask keeps the slots ``<= pos % L``, where GQA's keeps
``< min(pos + 1, L)``, as in the JAX package (``ROADMAP.md`` §3).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

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


def mla_defs(cfg: ModelConfig) -> dict:
    d, h, hd, r = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    lk = cfg.kv_lora_rank
    defs = {
        "w_dkv": ParamDef((d, lk + r), ("embed", None)),      # latent + rope key
        "w_uk": ParamDef((lk, h, hd), (None, "heads", None)),
        "w_uv": ParamDef((lk, h, hd), (None, "heads", None)),
        "wo": ParamDef((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.q_lora_rank:
        defs["w_dq"] = ParamDef((d, cfg.q_lora_rank), ("embed", None))
        defs["w_uq"] = ParamDef((cfg.q_lora_rank, h, hd + r), (None, "heads", None))
    else:
        defs["wq"] = ParamDef((d, h, hd + r), ("embed", "heads", None))
    return defs


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
              window: Optional[int] = None, return_kv: bool = False):
    """x: (B, S, D) → (B, S, D), causal, sliding when ``window`` is set;
    with ``return_kv`` also the RoPE'd keys and the values (B, S, KV, hd)
    for a prefill cache."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = chunked_attention(q, k, v, positions, positions, causal=True, window=window,
                          chunk=cfg.attn_chunk)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def encoder_attn_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
    """Bidirectional self-attention (the encoder of an encoder-decoder),
    RoPE on q and k."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = chunked_attention(q, k, v, positions, positions, causal=False, chunk=cfg.attn_chunk)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def cross_attn_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, memory_k: torch.Tensor,
                     memory_v: torch.Tensor) -> torch.Tensor:
    """The decoder's attention over the encoder's projected keys and values
    (B, Sm, KV, hd): no RoPE, every position 0, not causal."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    pos_q = torch.zeros((x.shape[1],), dtype=torch.int32, device=x.device)
    pos_k = torch.zeros((memory_k.shape[1],), dtype=torch.int32, device=x.device)
    o = chunked_attention(q, memory_k, memory_v, pos_q, pos_k, causal=False,
                          chunk=cfg.attn_chunk)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def project_memory(p: dict, memory: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder's output → the cross attention's keys and values (once a
    request)."""
    k = torch.einsum("bsd,dhk->bshk", memory, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", memory, p["wv"])
    return k, v


# ---------------------------------------------------------------------------
# KV caches + decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Preallocated decode cache; ``L = k.shape[1]`` is its capacity (the
    window or the longest sequence), ``pos`` the tokens seen so far."""

    k: torch.Tensor     # (B, L, KV, hd) — RoPE-applied keys
    v: torch.Tensor     # (B, L, KV, hd)
    pos: torch.Tensor   # () int32


class QuantKVCache(NamedTuple):
    """int8 KV cache: per-(batch, slot, head) absmax scales, dequantized
    inside the decode attention's products."""

    k: torch.Tensor        # (B, L, KV, hd) int8
    v: torch.Tensor        # (B, L, KV, hd) int8
    k_scale: torch.Tensor  # (B, L, KV) f16
    v_scale: torch.Tensor  # (B, L, KV) f16
    pos: torch.Tensor      # () int32


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (..., hd) → (int8 values, (...) f16 absmax scales)."""
    x32 = x.to(F32)
    scale = torch.amax(torch.abs(x32), dim=-1) / 127.0
    safe = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(x32 / safe[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def init_kv_cache(cfg: ModelConfig, batch: int, length: int, dtype: torch.dtype,
                  device="cpu"):
    """An empty cache of capacity ``length``: int8 when
    ``cfg.kv_cache_dtype == "int8"``, else ``dtype``."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    pos = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.kv_cache_dtype == "int8":
        return QuantKVCache(
            k=torch.zeros((batch, length, kv, hd), dtype=torch.int8, device=device),
            v=torch.zeros((batch, length, kv, hd), dtype=torch.int8, device=device),
            k_scale=torch.zeros((batch, length, kv), dtype=torch.float16, device=device),
            v_scale=torch.zeros((batch, length, kv), dtype=torch.float16, device=device),
            pos=pos)
    return KVCache(k=torch.zeros((batch, length, kv, hd), dtype=dtype, device=device),
                   v=torch.zeros((batch, length, kv, hd), dtype=dtype, device=device),
                   pos=pos)


def cache_from_prefill(k: torch.Tensor, v: torch.Tensor, length: int, pos: torch.Tensor,
                       quantize: bool = False):
    """Prefill K/V (B, S, KV, hd) as a decode cache of capacity ``length``,
    ring-aligned (position p in slot p % length)."""
    S = k.shape[1]
    if S <= length:
        pad = (0, 0, 0, 0, 0, length - S)
        k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    else:
        off = S % length
        k = torch.roll(k[:, -length:], off, dims=1)
        v = torch.roll(v[:, -length:], off, dims=1)
    if quantize:
        kq, ks = _quantize(k)
        vq, vs = _quantize(v)
        return QuantKVCache(k=kq, v=vq, k_scale=ks, v_scale=vs, pos=pos)
    return KVCache(k=k, v=v, pos=pos)


def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """``cache`` with ``new`` (B, 1, ...) in slot ``slot`` (a 0-d tensor) of
    axis 1, out of place and without reading the slot on the host."""
    return torch.index_copy(cache, 1, slot.reshape(1).long(), new.to(cache.dtype))


def gqa_decode_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, cache,
                     window: Optional[int] = None):
    """One-token decode.  x: (B, 1, D) → ((B, 1, D), cache').  The new key
    and value go to slot pos % L, so a cache of the window's size is a
    ring and a full one whose pos passes L wraps as well; ``window`` is
    not read (the cache's capacity is the window), as in the JAX
    package.  Takes a :class:`KVCache` or a :class:`QuantKVCache`."""
    B = x.shape[0]
    L = cache.k.shape[1]
    pos = cache.pos
    quant = isinstance(cache, QuantKVCache)
    slot = torch.remainder(pos, L)

    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k_new = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v_new = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    positions = pos.reshape(1).to(torch.int32)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)

    if quant:
        kq, ks = _quantize(k_new)
        vq, vs = _quantize(v_new)
        k_cache, v_cache = _write_slot(cache.k, kq, slot), _write_slot(cache.v, vq, slot)
        ks_cache = _write_slot(cache.k_scale, ks, slot)
        vs_cache = _write_slot(cache.v_scale, vs, slot)
    else:
        k_cache, v_cache = _write_slot(cache.k, k_new, slot), _write_slot(cache.v, v_new, slot)

    KV, hd, H = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    R = H // KV
    qg = q.reshape(B, KV, R, hd)
    s = torch.einsum("bkrh,blkh->bkrl", qg.to(F32), k_cache.to(F32))
    if quant:
        s = s * ks_cache.to(F32).permute(0, 2, 1)[:, :, None, :]
    s = s / float(np.sqrt(np.float32(hd)))
    # slots < min(pos + 1, L) hold real tokens (a ring fills L)
    valid = torch.arange(L, device=x.device) < torch.clamp(pos + 1, max=L)
    s = torch.where(valid[None, None, None, :], s, -math.inf)
    w = torch.softmax(s, dim=-1)
    if quant:
        w = w * vs_cache.to(F32).permute(0, 2, 1)[:, :, None, :]
    o = torch.einsum("bkrl,blkh->bkrh", w, v_cache.to(F32))
    o = o.reshape(B, 1, H, hd).to(x.dtype)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    if quant:
        return out, QuantKVCache(k=k_cache, v=v_cache, k_scale=ks_cache, v_scale=vs_cache,
                                 pos=pos + 1)
    return out, KVCache(k=k_cache, v=v_cache, pos=pos + 1)


# ---------------------------------------------------------------------------
# MLA (train / prefill / decode)
# ---------------------------------------------------------------------------

def _mla_q(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.q_lora_rank:
        cq = torch.einsum("bsd,dr->bsr", x, p["w_dq"])
        return torch.einsum("bsr,rhk->bshk", cq, p["w_uq"])
    return torch.einsum("bsd,dhk->bshk", x, p["wq"])


def mla_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
              return_kv: bool = False):
    """Training and prefill: the latent expanded into per-head keys and
    values, the shared RoPE key broadcast to every head, then the chunked
    attention (q and k of head dim hd + r, v of hd).  With ``return_kv``
    also the latent (B, S, lk) and the RoPE'd shared key (B, S, r)."""
    hd, r, lk = cfg.head_dim, cfg.rope_head_dim, cfg.kv_lora_rank
    q = _mla_q(p, cfg, x)                                       # (B,S,H,hd+r)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv = torch.einsum("bsd,dr->bsr", x, p["w_dkv"])            # (B,S,lk+r)
    c, k_rope = ckv[..., :lk], ckv[..., lk:]
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)   # (B,S,1,r)
    k_nope = torch.einsum("bsr,rhk->bshk", c, p["w_uk"])        # (B,S,H,hd)
    v = torch.einsum("bsr,rhk->bshk", c, p["w_uv"])             # (B,S,H,hd)

    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3], r)], dim=-1)
    o = chunked_attention(qf, kf, v, positions, positions, causal=True, chunk=cfg.attn_chunk)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    if return_kv:
        return out, (c, k_rope[:, :, 0, :])
    return out


class MLACache(NamedTuple):
    ckv: torch.Tensor     # (B, L, lk) — the latent
    k_rope: torch.Tensor  # (B, L, r)  — the RoPE'd shared key
    pos: torch.Tensor     # () int32


def init_mla_cache(cfg: ModelConfig, batch: int, length: int, dtype: torch.dtype,
                   device="cpu") -> MLACache:
    return MLACache(
        ckv=torch.zeros((batch, length, cfg.kv_lora_rank), dtype=dtype, device=device),
        k_rope=torch.zeros((batch, length, cfg.rope_head_dim), dtype=dtype, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device))


def mla_cache_from_prefill(c: torch.Tensor, k_rope: torch.Tensor, length: int,
                           pos: torch.Tensor) -> MLACache:
    """Prefill's latent and RoPE key (B, S, ·) as a cache of capacity
    ``length``; past it the last ``length`` tokens, rolled by S % length."""
    S = c.shape[1]
    if S <= length:
        pad = (0, 0, 0, length - S)
        return MLACache(ckv=torch.nn.functional.pad(c, pad),
                        k_rope=torch.nn.functional.pad(k_rope, pad), pos=pos)
    off = S % length
    return MLACache(ckv=torch.roll(c[:, -length:], off, dims=1),
                    k_rope=torch.roll(k_rope[:, -length:], off, dims=1), pos=pos)


def mla_decode_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: MLACache) -> tuple[torch.Tensor, MLACache]:
    """One-token decode in the absorbed form: q·W_uk (f32) scores against
    the latent cache plus q_rope against the RoPE-key cache, over √(hd + r);
    the slots ``<= pos % L`` are kept (the JAX package's mask, which drops
    the older slots after the newest once the cache wraps); the weighted
    latent goes back through W_uv in f32 and is cast to x's dtype before
    ``wo``."""
    hd, r, lk = cfg.head_dim, cfg.rope_head_dim, cfg.kv_lora_rank
    L = cache.ckv.shape[1]
    pos = cache.pos
    slot = torch.remainder(pos, L)
    positions = pos.reshape(1).to(torch.int32)

    q = _mla_q(p, cfg, x)[:, 0]                                 # (B,H,hd+r)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = apply_rope(q_rope[:, None], positions, cfg.rope_theta)[:, 0]

    ckv_new = torch.einsum("bsd,dr->bsr", x, p["w_dkv"])        # (B,1,lk+r)
    c_new, kr_new = ckv_new[..., :lk], ckv_new[..., lk:]
    kr_new = apply_rope(kr_new[:, :, None], positions, cfg.rope_theta)[:, :, 0]

    ckv_cache = _write_slot(cache.ckv, c_new, slot)
    kr_cache = _write_slot(cache.k_rope, kr_new, slot)

    q_eff = torch.einsum("bhk,rhk->bhr", q_nope.to(F32), p["w_uk"].to(F32))   # (B,H,lk)
    s = torch.einsum("bhr,blr->bhl", q_eff, ckv_cache.to(F32))
    s = s + torch.einsum("bhk,blk->bhl", q_rope.to(F32), kr_cache.to(F32))
    s = s / float(np.sqrt(np.float32(hd + r)))
    valid = torch.arange(L, device=x.device) <= slot
    s = torch.where(valid[None, None], s, -math.inf)
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhl,blr->bhr", w, ckv_cache.to(F32))                # (B,H,lk)
    o = torch.einsum("bhr,rhk->bhk", o_lat, p["w_uv"].to(F32))                # (B,H,hd)
    out = torch.einsum("bshk,hkd->bsd", o[:, None].to(x.dtype), p["wo"])
    return out, MLACache(ckv=ckv_cache, k_rope=kr_cache, pos=pos + 1)
