"""Mamba2 (SSD, state-space duality) mixer, arXiv:2405.21060 (the
counterpart of :mod:`repro.models.ssm`).

Training and prefill run the chunked SSD algorithm: quadratic within
chunks of Q = min(ssm_chunk, S) steps, a linear recurrence across chunks
(a Python loop over them, the JAX package's ``lax.scan``).  Decode is the
exact one-token recurrence on a :class:`MambaCache` (the (H, N, P) state
and the last W − 1 conv inputs).  The projections are the JAX package's
separate z/x/B/C/dt matrices, each of x, B, C with its own depthwise causal
conv.

One change from the JAX package, in the intra-chunk mask: its
``where(causal, s·exp(decay), 0)`` takes ``exp`` of the upper triangle,
where ``decay = cum_i − cum_j > 0`` overflows once a chunk's Σdt passes
~88, and the backward then multiplies a zero cotangent by inf (NaN
gradients from Q ≈ 128 at unit-normal dt).  Here the non-causal decays
are set to 0 before the ``exp``.  The causal entries have decay ≤ 0 and
are unchanged, so every forward value is the JAX package's bit for bit,
and the gradients are its own wherever those are finite
(``ROADMAP.md`` §3, "Caveats about the reference").
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, rms_norm

F32 = torch.float32


def mamba_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.d_inner_ssm
    H = cfg.n_ssm_heads
    G, N, W = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv_width
    return {
        "w_z": ParamDef((d, di), ("embed", "mlp")),
        "w_x": ParamDef((d, di), ("embed", "mlp")),
        "w_B": ParamDef((d, G * N), ("embed", None)),
        "w_C": ParamDef((d, G * N), ("embed", None)),
        "w_dt": ParamDef((d, H), ("embed", "heads")),
        "conv_x": ParamDef((W, di), (None, "mlp"), init="normal", scale=1.0),
        "conv_B": ParamDef((W, G * N), (None, None)),
        "conv_C": ParamDef((W, G * N), (None, None)),
        "A_log": ParamDef((H,), ("heads",), init="zeros"),
        "D": ParamDef((H,), ("heads",), init="ones"),
        "dt_bias": ParamDef((H,), ("heads",), init="zeros"),
        "norm": ParamDef((di,), ("mlp",), init="ones"),
        "w_out": ParamDef((di, d), ("mlp", "embed")),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(−|x|))``."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S, an f32 sum over the W taps in order.
    x: (B, S, C); w: (W, C)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = xp[:, 0:S].to(F32) * w[0].to(F32)
    for i in range(1, W):
        out = out + xp[:, i:i + S].to(F32) * w[i].to(F32)
    return out.to(x.dtype)


def _ssd_scan(
    xh: torch.Tensor,    # (B, S, H, P)  conv'd, silu'd inputs
    dt: torch.Tensor,    # (B, S, H)     softplus'd step sizes
    A: torch.Tensor,     # (H,)          negative decay rates
    Bm: torch.Tensor,    # (B, S, G, N)
    Cm: torch.Tensor,    # (B, S, G, N)
    chunk: int,
    initial_state: torch.Tensor | None = None,   # (B, H, N, P)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  Returns (y (B, S, H, P) in xh's dtype, final state
    (B, H, N, P) f32).  S must be a multiple of Q = min(chunk, S), as the
    JAX package asserts."""
    Bsz, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc = S // Q

    xc = xh.reshape(Bsz, nc, Q, H, P).to(F32)
    dtc = dt.reshape(Bsz, nc, Q, H).to(F32)
    Bc = Bm.reshape(Bsz, nc, Q, G, N).to(F32)
    Cc = Cm.reshape(Bsz, nc, Q, G, N).to(F32)

    dtx = dtc[..., None] * xc                                   # (B,nc,Q,H,P)
    log_a = A.to(F32) * dtc                                     # negative
    cum = torch.cumsum(log_a, dim=2)                            # inclusive
    cum_last = cum[:, :, -1]                                    # (B,nc,H)

    # ---- intra-chunk (quadratic within Q) ----
    s = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)              # (B,nc,G,Q,Q)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # cum_i − cum_j (B,nc,Q,Q,H)
    decay = torch.movedim(decay, -1, 2)                         # (B,nc,H,Q,Q)
    iq = torch.arange(Q, device=xh.device)
    causal = iq[:, None] >= iq[None, :]
    zero = torch.zeros((), dtype=F32, device=xh.device)
    # the non-causal decays are positive: 0 before the exp keeps its
    # backward finite (module docstring)
    decay = torch.where(causal, decay, zero)
    # group g's scores serve its R heads (jnp.repeat along the head axis)
    sd = s[:, :, :, None] * torch.exp(decay).reshape(Bsz, nc, G, R, Q, Q)
    M = torch.where(causal, sd.reshape(Bsz, nc, H, Q, Q), zero)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", M, dtx)

    # ---- per-chunk outgoing state ----
    w_end = torch.exp(cum_last[:, :, None, :] - cum)            # decay to chunk end (B,nc,Q,H)
    Bfull = torch.repeat_interleave(Bc, R, dim=3)               # (B,nc,Q,H,N)
    chunk_states = torch.einsum("bcjhn,bcjhp->bchnp", Bfull, dtx * w_end[..., None])

    # ---- inter-chunk recurrence (sequential over the nc chunks) ----
    state = (initial_state.to(F32) if initial_state is not None
             else torch.zeros((Bsz, H, N, P), dtype=F32, device=xh.device))
    Cfull = torch.repeat_interleave(Cc, R, dim=3)               # (B,nc,Q,H,N)
    y_inter = []
    for c in range(nc):
        # y_inter[i] = exp(cum_i) · C_i · state_prev
        w_in = torch.exp(cum[:, c])                             # (B,Q,H)
        y_inter.append(torch.einsum("bqhn,bhnp->bqhp", Cfull[:, c] * w_in[..., None], state))
        state = torch.exp(cum_last[:, c])[..., None, None] * state + chunk_states[:, c]
    y = (y_intra + torch.stack(y_inter, dim=1)).reshape(Bsz, S, H, P)
    return y.to(xh.dtype), state


class MambaCache(NamedTuple):
    """Decode-time state: SSM state and the conv tails (last W − 1 inputs)."""

    state: torch.Tensor     # (B, H, N, P) f32
    conv_x: torch.Tensor    # (B, W-1, di)
    conv_B: torch.Tensor    # (B, W-1, G·N)
    conv_C: torch.Tensor    # (B, W-1, G·N)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device=None) -> MambaCache:
    H, N, P = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    W, G = cfg.ssm_conv_width, cfg.ssm_groups
    return MambaCache(
        state=torch.zeros((batch, H, N, P), dtype=F32, device=device),
        conv_x=torch.zeros((batch, W - 1, cfg.d_inner_ssm), dtype=dtype, device=device),
        conv_B=torch.zeros((batch, W - 1, G * N), dtype=dtype, device=device),
        conv_C=torch.zeros((batch, W - 1, G * N), dtype=dtype, device=device),
    )


def _proj_zxbcdt(p: dict, x: torch.Tensor):
    return x @ p["w_z"], x @ p["w_x"], x @ p["w_B"], x @ p["w_C"], x @ p["w_dt"]


def mamba_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, return_state: bool = False):
    """Train/prefill SSD pass.  x: (B, S, D) → (B, S, D) [, MambaCache]."""
    Bsz, S, _ = x.shape
    H, N, P, G = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_groups
    W = cfg.ssm_conv_width

    z, xr_raw, Br_raw, Cr_raw, dt = _proj_zxbcdt(p, x)
    xr = F.silu(_causal_conv(xr_raw, p["conv_x"]).to(F32)).to(x.dtype)
    Br = F.silu(_causal_conv(Br_raw, p["conv_B"]).to(F32)).to(x.dtype)
    Cr = F.silu(_causal_conv(Cr_raw, p["conv_C"]).to(F32)).to(x.dtype)

    xh = xr.reshape(Bsz, S, H, P)
    Bm = Br.reshape(Bsz, S, G, N)
    Cm = Cr.reshape(Bsz, S, G, N)
    dt = softplus(dt.to(F32) + p["dt_bias"].to(F32))
    A = -torch.exp(p["A_log"].to(F32))

    y, final_state = _ssd_scan(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(Bsz, S, H * P)
    y = rms_norm(y * F.silu(z.to(F32)).to(y.dtype), p["norm"], cfg.norm_eps)
    out = y @ p["w_out"]
    if not return_state:
        return out

    def tail(raw):
        t = raw[:, -(W - 1):]
        pad = (W - 1) - t.shape[1]
        return F.pad(t, (0, 0, pad, 0)) if pad else t

    return out, MambaCache(state=final_state, conv_x=tail(xr_raw), conv_B=tail(Br_raw),
                           conv_C=tail(Cr_raw))


def _step_conv(tail: torch.Tensor, new: torch.Tensor, w: torch.Tensor):
    """tail: (B, W-1, C); new: (B, 1, C) → (conv output (B, C) f32, new tail)."""
    window = torch.cat([tail, new.to(tail.dtype)], dim=1)       # (B, W, C)
    out = torch.einsum("bwc,wc->bc", window.to(F32), w.to(F32))
    return out, window[:, 1:]


def mamba_decode_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       cache: MambaCache) -> tuple[torch.Tensor, MambaCache]:
    """One-token recurrence.  x: (B, 1, D)."""
    Bsz = x.shape[0]
    H, N, P, G = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_groups

    z, xr, Br, Cr, dt = _proj_zxbcdt(p, x)
    cx, tail_x = _step_conv(cache.conv_x, xr, p["conv_x"])
    cB, tail_B = _step_conv(cache.conv_B, Br, p["conv_B"])
    cC, tail_C = _step_conv(cache.conv_C, Cr, p["conv_C"])
    xh = F.silu(cx).reshape(Bsz, H, P)
    Bm = F.silu(cB).reshape(Bsz, G, N)
    Cm = F.silu(cC).reshape(Bsz, G, N)

    dt1 = softplus(dt[:, 0].to(F32) + p["dt_bias"].to(F32))                # (B,H)
    a = torch.exp(-torch.exp(p["A_log"].to(F32)) * dt1)                    # (B,H)

    R = H // G
    Bfull = torch.repeat_interleave(Bm, R, dim=1)                          # (B,H,N)
    Cfull = torch.repeat_interleave(Cm, R, dim=1)
    dtx = dt1[..., None] * xh.to(F32)                                      # (B,H,P)
    state = a[..., None, None] * cache.state + Bfull[..., None] * dtx[:, :, None, :]
    y = torch.einsum("bhn,bhnp->bhp", Cfull.to(F32), state)
    y = y + p["D"].to(F32)[None, :, None] * xh.to(F32)
    y = y.reshape(Bsz, 1, H * P).to(x.dtype)
    y = rms_norm(y * F.silu(z.to(F32)).to(y.dtype), p["norm"], cfg.norm_eps)
    out = y @ p["w_out"]
    return out, MambaCache(state=state, conv_x=tail_x, conv_B=tail_B, conv_C=tail_C)
