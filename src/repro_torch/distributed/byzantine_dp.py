"""ByzantineSGD as a data-parallel aggregation guard: the counterpart of
:mod:`repro.distributed.byzantine_dp` (its ``exact`` and ``sketch`` guards;
the flat harness's ``dp_exact``/``dp_sketch`` backends wrap them).

The filter is the same :func:`~repro_torch.core.byzantine_sgd.filter_update`
as the single-host guard's; only the Gram matrices are produced
differently.

* ``exact`` — B is a full pytree per worker; the Grams are f32 products of
  the worker-stacked leaves, and ``gram_B`` is rank-updated from the
  gradients (``G_B += B gᵀ + g Bᵀ + g gᵀ``) and re-derived from B every
  ``gram_resync_every`` steps, or every step with
  ``incremental_gram=False``.
* ``sketch`` — each worker's centred gradient is CountSketched into
  ``sketch_dim`` buckets (:func:`sketch_tree`, the CUDA kernel of
  :mod:`repro_torch.kernels.countsketch` on the card), B is the running sum
  of the sketches, cross-worker products come from the sketches and the
  diagonals stay exact; V is widened by ``sketch_slack``.

V is calibrated online (``auto_v``) as an EMA of half the 25th-percentile
pairwise distance between fresh gradients, kept on the device as a 0-d f32
tensor, so a step never waits for the device.  The step count ``k`` is a
host int, as in the port's ``GuardState``.

A "pytree" here is one tensor (one leaf) or a list of tensors in
``jax.tree_util.tree_leaves`` order; worker-stacked leaves carry a leading
W axis.  Every output has the structure of the input it mirrors (B and ξ
that of the gradients).  Numerics follow the JAX package's rounding
points: gradients are rounded to the stats dtype on entry; with
``low_precision_stats`` δ and the centring mean are rounded to the
gradients' dtype before use and ξ's weights before the sum; every product
accumulates in f32 (bf16 operands are upcast first, which is exact, so
bf16 × bf16 products are exact as under ``preferred_element_type=f32``).
On a GPU the f32 products need ``torch.backends.cuda.matmul.allow_tf32``
False, PyTorch's default.

The step's diag carries ``sq_norm_mean``, the workers' mean ‖g_i‖², as in
the JAX package.  Every worker-axis product takes a leaf by column blocks
of ``COL_BLOCK``, so a leaf the size of a whole model keeps its f32
temporaries small; a leaf within one block is contracted whole.
:func:`apply_tree_attack` is the gradient-level attack simulation on
worker-stacked pytrees.  Not ported here: the mesh code
(``distributed/sharding.py``, ``specs.py``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.byzantine_sgd import (
    GuardConfig,
    filter_update,
    masked_quantile,
    pairwise_sq_dists_from_gram,
    resolve_stats_dtype,
)
from repro_torch import prng
from repro_torch.kernels import ops, ref
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


class DPGuardConfig(NamedTuple):
    """The JAX ``DPGuardConfig``, field for field."""

    n_workers: int
    T: int
    V: float = 0.0
    D: float = 10.0
    delta: float = 1e-3
    mode: str = "sketch"         # 'exact' | 'sketch'
    sketch_dim: int = 4096
    sketch_slack: float = 1.5
    threshold_mode: str = "anytime"
    mean_over_alive: bool = True
    auto_v: bool = True
    v_ema: float = 0.9
    grad_radius_mult: float = 4.0
    low_precision_stats: bool = False
    stats_dtype: str = "f32"
    incremental_gram: bool = True
    gram_resync_every: int = 64

    def guard_config(self, v_eff) -> GuardConfig:
        return GuardConfig(
            m=self.n_workers, T=self.T, V=v_eff, D=self.D, delta=self.delta,
            threshold_mode=self.threshold_mode, mean_over_alive=self.mean_over_alive,
            grad_radius_mult=self.grad_radius_mult,
        )


class DPGuardState(NamedTuple):
    """The JAX ``DPGuardState``, with ``k`` a host int."""

    A: torch.Tensor        # (W,) f32
    B: object              # sketch: (W, k); exact: pytree of (W, *leaf), stats dtype
    alive: torch.Tensor    # (W,) bool
    k: int                 # iterations done
    v_est: torch.Tensor    # () f32 calibrated V
    gram_B: torch.Tensor   # (W, W) f32 ⟨B_i, B_j⟩


def _leaves(tree) -> list:
    return [tree] if isinstance(tree, torch.Tensor) else list(tree)


def _like(tree, leaves: list):
    """``leaves`` in the structure of ``tree``."""
    return leaves[0] if isinstance(tree, torch.Tensor) else list(leaves)


def _sum(parts: list) -> torch.Tensor:
    return functools.reduce(torch.add, parts)


# ---------------------------------------------------------------------------
# tree ↔ worker-axis algebra
# ---------------------------------------------------------------------------

# columns of a (W, n) leaf that one f32 product takes at once: a leaf the
# size of a whole model (d = 5·10⁸) is contracted in blocks, so its f32
# temporaries stay at W·2²⁴ floats; a leaf within one block is contracted
# whole, as before
COL_BLOCK = 1 << 24


# a block's Gram is taken as a batch of products over pieces of SPLIT_K
# columns, summed: one long, thin f32 product (8 × 2²⁴ by 2²⁴ × 8) keeps
# too few of the card's SMs busy (PERF.md §6, PR 30)
SPLIT_K = 1 << 16


def col_blocks(n: int) -> list:
    """Slices of COL_BLOCK columns covering a leaf's n."""
    return ref.column_blocks(n, COL_BLOCK)


def _gram_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(W, V) a bᵀ of two f32 (·, n) blocks, by pieces of SPLIT_K columns
    when n holds at least two."""
    n = a.shape[1]
    pieces = n // SPLIT_K
    if pieces < 2:
        return a @ b.T
    main = pieces * SPLIT_K
    a3 = a[:, :main].reshape(a.shape[0], pieces, SPLIT_K).transpose(0, 1)
    b3 = b[:, :main].reshape(b.shape[0], pieces, SPLIT_K).transpose(0, 1)
    out = torch.sum(torch.bmm(a3, b3.transpose(1, 2)), dim=0)
    return out + a[:, main:] @ b[:, main:].T if main < n else out


def worker_vdot(ga, gb, low_precision: bool = False) -> torch.Tensor:
    """(W,) ⟨g_i, h_i⟩ per worker.  gb's leaves share ga's leading W or are
    unbatched (broadcast).  With ``low_precision`` an operand of another
    dtype is rounded to ga's first (the JAX package's rounding of δ)."""
    def one(a, b):
        if low_precision and a.dtype != b.dtype:
            b = b.to(a.dtype)
        a2 = a.reshape(a.shape[0], -1)
        shared = b.dim() == a.dim() - 1
        b2 = b.reshape(-1) if shared else b.reshape(b.shape[0], -1)
        parts = []
        for blk in col_blocks(a2.shape[1]):
            x = a2[:, blk].to(F32)
            if shared:
                parts.append(x @ b2[blk].to(F32))
            else:
                parts.append(torch.sum(x * b2[:, blk].to(F32), dim=1))
        return _sum(parts)
    return _sum([one(a, b) for a, b in zip(_leaves(ga), _leaves(gb))])


def worker_sq_norms(g, low_precision: bool = False) -> torch.Tensor:
    return worker_vdot(g, g, low_precision)


def worker_pair_gram(ga, gb, low_precision: bool = False) -> torch.Tensor:
    """(W, W) ⟨a_i, b_j⟩ between two worker-stacked pytrees (the ``B gᵀ``
    term of the incremental Gram).  With ``low_precision`` ga is rounded to
    gb's dtype first."""
    def one(a, b):
        if low_precision:
            a = a.to(b.dtype)
        a2 = a.reshape(a.shape[0], -1)
        b2 = b.reshape(b.shape[0], -1)
        return _sum([_gram_f32(a2[:, blk].to(F32), b2[:, blk].to(F32))
                     for blk in col_blocks(a2.shape[1])])
    return _sum([one(a, b) for a, b in zip(_leaves(ga), _leaves(gb))])


def worker_cross_gram(g, low_precision: bool = False) -> torch.Tensor:
    """(W, W) Gram of a worker-stacked pytree (exact mode)."""
    return worker_pair_gram(g, g, low_precision)


def _worker_sum(x: torch.Tensor) -> torch.Tensor:
    """(1, ...) f32 sum over the leading worker axis, by column blocks
    (out of place, so a campaign's vmap batches it)."""
    x2 = x.reshape(x.shape[0], -1)
    parts = [torch.sum(x2[:, blk].to(F32), dim=0, keepdim=True)
             for blk in col_blocks(x2.shape[1])]
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return out.reshape((1, *x.shape[1:]))


# ---------------------------------------------------------------------------
# CountSketch (sketch mode)
# ---------------------------------------------------------------------------

def sketch_tree(g, k: int) -> torch.Tensor:
    """(W, k) f32 CountSketch of each worker's gradient pytree: leaf number
    ``salt`` is sketched by :func:`repro_torch.kernels.ops.countsketch` under
    that salt (bucket i mod k, hashed signs) and the leaves' sketches are
    added.  The kernel reads f32 or bf16 and upcasts in registers, so the
    JAX package's ``low_precision`` switch (which only chose where the
    upcast happens) changes nothing here and has no counterpart."""
    out = None
    for salt, leaf in enumerate(_leaves(g)):
        flat = leaf.reshape(leaf.shape[0], -1)
        if flat.dtype not in (F32, torch.bfloat16):
            flat = flat.to(F32)
        s = ops.countsketch(flat, k, salt)
        out = s if out is None else out + s
    return out


def sketch_gram(s: torch.Tensor, sq_norms: torch.Tensor) -> torch.Tensor:
    """Gram of the sketches with the diagonal replaced by ``sq_norms``."""
    return torch.diagonal_scatter(s @ s.T, sq_norms)


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------

def init_guard_state(cfg: DPGuardConfig, params_like) -> DPGuardState:
    """Zero state on the device of ``params_like``, a pytree of unbatched
    leaves."""
    W = cfg.n_workers
    sdt = resolve_stats_dtype(cfg.stats_dtype)
    dev = _leaves(params_like)[0].device
    if cfg.mode == "sketch":
        B = torch.zeros((W, cfg.sketch_dim), dtype=sdt, device=dev)
    else:
        B = _like(params_like, [torch.zeros((W, *p.shape), dtype=sdt, device=dev)
                                for p in _leaves(params_like)])
    return DPGuardState(
        A=torch.zeros((W,), dtype=F32, device=dev), B=B,
        alive=torch.ones((W,), dtype=torch.bool, device=dev), k=0,
        v_est=torch.zeros((), dtype=F32, device=dev),
        gram_B=torch.zeros((W, W), dtype=F32, device=dev),
    )


def v_from_gram(gram_g: torch.Tensor, report=None) -> torch.Tensor:
    """Half the 25th-percentile pairwise distance from a fresh-gradient
    Gram, over the pairs i < j in ``triu_indices`` order (and, with
    ``report``, only pairs where both reported).  The quantile is the
    masked formula on an all-true mask too, as in the JAX package's
    documentation (:func:`~repro_torch.core.byzantine_sgd.masked_quantile`
    says how far that equals ``jnp.quantile``)."""
    d2 = pairwise_sq_dists_from_gram(gram_g)
    W = d2.shape[0]
    iu, ju = torch.triu_indices(W, W, 1, device=d2.device)
    off = d2[iu, ju]
    mask = torch.ones_like(off, dtype=torch.bool) if report is None else report[iu] & report[ju]
    return torch.sqrt(masked_quantile(off, mask, 0.25)) * 0.5


def _calibrate_v(cfg: DPGuardConfig, gram_g: torch.Tensor, v_prev: torch.Tensor,
                 report=None) -> torch.Tensor:
    if not cfg.auto_v:
        # a fill kernel, not a host-to-device copy: no sync
        return torch.full((), float(np.float32(cfg.V)), dtype=F32, device=gram_g.device)
    v_now = v_from_gram(gram_g, report)
    v_new = torch.where(v_prev > 0, cfg.v_ema * v_prev + (1 - cfg.v_ema) * v_now, v_now)
    return torch.clamp(v_new, min=1e-12)


def guard_step(cfg: DPGuardConfig, state: DPGuardState, grads_w, params, anchor,
               report=None):
    """One filter and aggregation step; returns ``(state', ξ, diag)`` with
    ξ in the structure of ``grads_w`` and diag = {"n_alive", "v_est",
    "sq_norm_mean"}.
    ``report`` ((W,) bool) zeroes the other workers' rows on entry and
    restricts the medians and the V quantile to reporters."""
    W = cfg.n_workers
    k_new = state.k + 1
    lp = cfg.low_precision_stats
    sdt = resolve_stats_dtype(cfg.stats_dtype)
    g = _leaves(grads_w)
    if sdt != F32:
        # the single entry rounding of the stats axis
        g = [x.to(sdt) for x in g]

    def mask_workers(xs):
        return [torch.where(report.reshape((-1,) + (1,) * (x.dim() - 1)), x, 0.0)
                for x in xs]

    if report is not None:
        g = mask_workers(g)

    # --- martingale updates ------------------------------------------------
    delta = [p.to(F32) - a.to(F32) for p, a in zip(_leaves(params), _leaves(anchor))]
    if lp:
        delta = [dl.to(p.dtype) for dl, p in zip(delta, _leaves(params))]
    A = state.A + worker_vdot(g, delta, lp)
    sq_g = worker_sq_norms(g, lp)

    if cfg.mode == "sketch":
        # centre before sketching: the distances do not move, the sketch
        # noise scales with ‖g_i − ḡ‖ instead of ‖g_i‖
        n_mean = W if report is None else torch.clamp(torch.sum(report), min=1).to(F32)
        g_mean = [_worker_sum(x) / n_mean for x in g]
        if lp:
            g_cent = [x - c.to(x.dtype) for x, c in zip(g, g_mean)]
        else:
            g_cent = [x.to(F32) - c for x, c in zip(g, g_mean)]
        if report is not None:
            # a non-reporter's centred row would be −ḡ, not 0
            g_cent = mask_workers(g_cent)
        sq_cent = worker_sq_norms(g_cent, lp)
        s_g = sketch_tree(g_cent, cfg.sketch_dim)
        B = (state.B.to(F32) + s_g).to(sdt)
        gram_g = sketch_gram(s_g, sq_cent)
        B32 = B.to(F32)
        gram_B = sketch_gram(B32, torch.sum(B32 * B32, dim=-1))
    else:
        # B and g are both in the stats dtype: a bf16 add rounds the f32 sum
        # once, which is the JAX package's rounding under either switch
        # (an f32 B takes a bf16 g's exact upcast inside the add)
        B = _like(state.B, [b + x if b.dtype == F32 else b + x.to(b.dtype)
                            for b, x in zip(_leaves(state.B), g)])
        gram_g = worker_cross_gram(g, lp)
        resync = cfg.gram_resync_every > 0 and k_new % cfg.gram_resync_every == 0
        if cfg.incremental_gram and not resync:
            cross = worker_pair_gram(state.B, g, lp)
            gram_B = state.gram_B + cross + cross.T + gram_g
        else:
            gram_B = worker_cross_gram(B, lp)

    # --- V calibration and filter ------------------------------------------
    v_eff = _calibrate_v(cfg, gram_g, state.v_est, report)
    slack = cfg.sketch_slack if cfg.mode == "sketch" else 1.0
    good_k, diag = filter_update(A, gram_B, gram_g, state.alive, k_new,
                                 cfg.guard_config(v_eff * slack), report)

    # --- the filtered mean ξ over good ∩ reporting ---------------------------
    contrib = good_k if report is None else good_k & report
    denom = (torch.clamp(torch.sum(contrib), min=1).to(F32) if cfg.mean_over_alive
             else float(W))
    w = contrib.to(F32) / denom
    xi = []
    for x in g:
        wx = w.to(x.dtype).to(F32) if lp else w
        xi.append(ops.filtered_mean(x.reshape(W, -1), wx, 1.0)
                  .reshape(x.shape[1:]).to(x.dtype))

    diag = dict(diag, v_est=v_eff, sq_norm_mean=torch.mean(sq_g))
    new_state = DPGuardState(A=A, B=B, alive=good_k, k=k_new, v_est=v_eff, gram_B=gram_B)
    return new_state, _like(grads_w, xi), diag


# ---------------------------------------------------------------------------
# gradient-level attack simulation on the worker axis
# ---------------------------------------------------------------------------

def apply_tree_attack(name: str, key: torch.Tensor, grads_w, byz_mask: torch.Tensor,
                      scale: float = 3.0):
    """Overwrite Byzantine workers' gradient trees (leaves lead with W);
    ``byz_mask``: (W,) bool.  ``noise`` draws :func:`repro_torch.prng.normal`
    under ``split(key, n_leaves)``, one key a leaf in leaf order (f32
    leaves: jax draws another dtype from other bits)."""
    def mask_like(leaf):
        return byz_mask.reshape((-1,) + (1,) * (leaf.dim() - 1))

    if name == "none":
        return grads_w
    if name == "sign_flip":
        return tree_map(lambda g: torch.where(mask_like(g), -scale * g, g), grads_w)
    if name == "noise":
        leaves = tree_leaves(grads_w)
        keys = prng.split(key, len(leaves))
        noisy = [torch.where(mask_like(g), scale * prng.normal(keys[i], g.shape, g.dtype), g)
                 for i, g in enumerate(leaves)]
        return tree_unflatten(grads_w, noisy)
    if name == "constant_drift":
        def drift(g):
            fill = float(np.float32(scale) / np.sqrt(np.float32(g[0].numel())))
            return torch.where(mask_like(g), torch.full_like(g, fill), g)
        return tree_map(drift, grads_w)
    if name == "scaled_copy":
        # colluders send mean-of-good × scale: inflates the step magnitude
        def one(g):
            mu = torch.mean(torch.where(mask_like(g), 0.0, g), dim=0, keepdim=True)
            n_good = torch.clamp(torch.sum(~byz_mask, dtype=torch.int32), min=1)
            mu = mu * (byz_mask.shape[0] / n_good.to(F32))
            return torch.where(mask_like(g), scale * mu, g)
        return tree_map(one, grads_w)
    raise KeyError(f"unknown tree attack {name!r}")
