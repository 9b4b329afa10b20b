"""Shared model building blocks: parameter definitions, norms, RoPE, the
SwiGLU MLP and the cross entropy (the counterpart of
:mod:`repro.models.common`).

Parameters are declared as :class:`ParamDef` trees, the one source of
shape and initialization; :func:`init_params` turns a tree of them into
tensors.  Leaves are visited in ``jax.tree_util`` order (a dict's keys
sorted), and :func:`init_params` splits one key per leaf in that order,
so ``init_params(PRNGKey(s), defs, dtype)`` draws the JAX package's
parameters (within :func:`repro_torch.prng.normal`'s and
``truncated_normal``'s few ulps).

The numerics keep the JAX package's casts: ``rms_norm`` normalises in f32,
casts back, then multiplies by the weight in the parameter dtype;
``swiglu`` applies ``silu`` in f32 and casts back before the product;
RoPE rotates interleaved (0::2, 1::2) pairs in f32.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(name: str) -> torch.dtype:
    """``'float32' | 'bfloat16'`` (a config's ``param_dtype`` /
    ``activation_dtype``) → torch dtype."""
    try:
        return DTYPES[name]
    except KeyError:
        raise KeyError(f"unknown dtype {name!r}; have {sorted(DTYPES)}") from None


class ParamDef(NamedTuple):
    shape: tuple
    axes: tuple                 # logical axis names, len == len(shape)
    init: str = "normal"        # normal | zeros | ones | embed
    scale: float = 1.0          # stddev multiplier (normal) / fan-in handled below

    def with_leading(self, n: int, axis_name: str | None = None) -> "ParamDef":
        """Stack this def along a new leading 'layers' axis."""
        return self._replace(shape=(n, *self.shape), axes=(axis_name, *self.axes))


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _fan_in(shape: tuple) -> int:
    return int(shape[-2]) if len(shape) >= 2 else int(shape[-1])


# elements of a leaf drawn at once.  A larger leaf (kimi-k2's stacked
# experts hold 5.6e9) is drawn piece by piece over its flat counter range,
# each piece written into the leaf in the parameter dtype, so the draw's
# int64 and f64 temporaries are one piece's; the bits are the whole draw's.
INIT_PIECE = 1 << 25


def init_param(key: torch.Tensor, d: ParamDef, dtype: torch.dtype,
               piece: int = INIT_PIECE) -> torch.Tensor:
    """One leaf on ``key``'s device: zeros, ones, ``scale·normal`` (embed)
    or ``scale/√fan_in · truncated_normal(−2, 2)``; the fan-in of a stacked
    leaf is ``shape[-2]`` of the stacked shape, as in the JAX package.  A
    leaf of more than ``piece`` elements is drawn in pieces of ``piece``."""
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=key.device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=key.device)
    if d.init == "embed":
        def draw(shape, offset=0):
            return (d.scale * prng.normal(key, shape, offset=offset)).to(dtype)
    else:
        std = float(np.float32(d.scale / np.sqrt(max(_fan_in(d.shape), 1))))

        def draw(shape, offset=0):
            return (std * prng.truncated_normal(key, -2.0, 2.0, shape, offset=offset)).to(dtype)
    n = math.prod(d.shape)
    if n <= piece:
        # one draw, out of place (a campaign draws its runs' leaves under vmap)
        return draw(d.shape)
    out = torch.empty(d.shape, dtype=dtype, device=key.device)
    flat = out.view(-1)
    for lo in range(0, n, piece):
        hi = min(lo + piece, n)
        flat[lo:hi] = draw((hi - lo,), lo)
    return out


def init_params(key: torch.Tensor, defs: Any, dtype: torch.dtype) -> Any:
    """A tree of ParamDef as tensors: ``split(key, n_leaves)`` in leaf order,
    one key a leaf."""
    leaves = tree_leaves(defs, is_leaf=is_def)
    keys = prng.split(key, max(len(leaves), 1))
    return tree_unflatten(defs, [init_param(keys[i], d, dtype) for i, d in enumerate(leaves)],
                          is_leaf=is_def)


def meta_params(defs: Any, dtype: torch.dtype) -> Any:
    """The tree as tensors on the ``meta`` device: shapes and dtypes, no
    memory (the JAX package's ``abstract_params``)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"), defs,
                    is_leaf=is_def)


def param_count(defs: Any) -> int:
    return int(sum(math.prod(d.shape) for d in tree_leaves(defs, is_leaf=is_def)))


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(F32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.to(F32)).to(x.dtype) * u
    return h @ w_down


def mlp_defs(d_model: int, d_ff: int) -> dict:
    return {
        "gate": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "up": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "down": ParamDef((d_ff, d_model), ("mlp", "embed")),
    }


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return swiglu(x, p["gate"], p["up"], p["down"])


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=F32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                            # (hd/2,)
    angles = positions[..., :, None, None].to(F32) * freqs             # (...,S,1,hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x32 = x.to(F32)
    x1, x2 = x32[..., 0::2], x32[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, z_loss: float = 1e-4):
    """Mean next-token cross entropy in f32 with optional z-loss.

    logits: (..., V); labels: (...,) int.  Returns (loss, metrics)."""
    logits32 = logits.to(F32)
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    loss = torch.mean(nll)
    if z_loss:
        loss = loss + z_loss * torch.mean(lse * lse)
    return loss, {"nll": torch.mean(nll), "z": torch.mean(lse * lse)}
