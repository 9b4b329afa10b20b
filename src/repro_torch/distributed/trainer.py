"""The Byzantine training step: per-worker gradients → attack → guard
backend → optimizer (the counterpart of :mod:`repro.distributed.trainer`,
DESIGN.md §10).

``build_train_step`` returns

    state', metrics = train_step(state, batch, byz_rank, key)

* ``batch`` leaves are (W, per_worker_batch, ...): W workers simulated on
  one device.  The per-worker gradients are ``torch.func.vmap`` of
  ``torch.func.grad_and_value`` of the model's loss over the worker axis,
  as the JAX package vmaps ``value_and_grad``: one batched forward and
  backward for all W workers.  The worker-stacked gradient tree is
  ravelled into the (W, d) matrix and dropped at once, so the two never
  outlive the ravel together.
* the flat matrix goes to the same aggregation layer as the convex
  harness: :func:`repro_torch.core.solver.make_aggregator` on a
  :class:`~repro_torch.core.tree_harness.FlatSpec`, so
  ``SolverConfig.guard_backend`` selects ``dense`` / ``fused`` /
  ``dp_exact`` / ``dp_sketch`` (the card's guard kernels) and every
  stateless baseline comes from the same factory.  ξ is unravelled into a
  parameter-shaped update for the optimizer.
* ``byz_rank`` is the (W,) int per-worker rank (worker w is Byzantine iff
  its rank is below the realised count); the adversary is the static
  ``cfg.attack`` or a :class:`~repro_torch.scenarios.adversary.
  ScenarioAdversary` (its profile's stale buffer and reporting mask
  included), fed the previous step's feedback in ``ctx``.
* ``ctx["true_grad"]`` is the mean of the honest rows, ``ctx["V"]`` the
  explicit V or an instantaneous estimate from the pre-attack rows (half
  the 25th-percentile pairwise distance of their f32 Gram, taken by column
  blocks).

The step count is a host int, as the guards' ``k``; metrics stay 0-d
device tensors, so a step never waits for the device.  Rows are stored in
the guard's statistics dtype when it is lowered, else in the harness's
``flat_dtype`` (bf16 for a bf16 model), as in the JAX package.

``telemetry`` (:class:`repro_torch.obs.TelemetryConfig`) arms the flight
recorder: the aggregator's frame joins ``metrics`` under ``tel/`` keys.
``timer`` (a callable taking a phase name) is called as each phase of the
step ends — ``forward_backward``, ``ravel``, ``attack``, ``guard`` and
``optimizer`` — for a caller that times the phases with CUDA events;
None (the default) adds nothing.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import prng
from repro_torch.core import attacks as attack_lib
from repro_torch.core.byzantine_sgd import resolve_stats_dtype
from repro_torch.core.solver import SolverConfig, make_aggregator
from repro_torch.core.tree_harness import FlatSpec, params_harness
from repro_torch.distributed.byzantine_dp import col_blocks, v_from_gram, worker_cross_gram
from repro_torch.obs.telemetry import telemetry_on
from repro_torch.optim.optimizers import Optimizer
from repro_torch.utils import tree_add

PyTree = Any
F32 = torch.float32


class TrainState(NamedTuple):
    """Everything one training run carries across steps."""

    params: PyTree
    opt_state: PyTree
    guard: PyTree             # backend-specific aggregator state
    anchor: torch.Tensor      # (d,) flat x₁ — the A-statistic reference point
    step: int                 # host int
    ever_byz: torch.Tensor    # (W,) bool — workers that were ever Byzantine
    adv: PyTree               # adversary memory (scalar zero when static)
    prev_xi: torch.Tensor     # (d,) ξ_{k-1} — Remark-2.3 feedback
    prev_alive: torch.Tensor  # (W,) bool — good_{k-1}
    prev_n_alive: torch.Tensor  # () int32
    grad_buf: PyTree = ()     # (W, d) stale-gradient buffer when the run's
    #                           WorkerProfile arms cfg.max_delay, else ()


def rank_from_mask(mask: torch.Tensor) -> torch.Tensor:
    """(W,) int32 rank with the mask's Byzantine workers ranked first, so
    ``rank < sum(mask)`` reproduces ``mask``."""
    order = torch.argsort((~mask).to(torch.int32), stable=True)
    return torch.argsort(order, stable=True).to(torch.int32)


def _estimate_v(flat: torch.Tensor) -> torch.Tensor:
    """Instantaneous Assumption-2.2 scale from the pre-attack rows: the
    guards' :func:`v_from_gram` convention on their f32 Gram (exact
    upcasts, summed by column blocks)."""
    return torch.clamp(v_from_gram(worker_cross_gram(flat)), min=1e-12)


def _honest_mean(flat: torch.Tensor, good_w: torch.Tensor) -> torch.Tensor:
    """Σ good_w[i]·row_i / max(Σ good_w, 1) in the rows' dtype, by column
    blocks (good_w (W, 1) in the rows' dtype)."""
    parts = [torch.sum(flat[:, blk] * good_w, dim=0) for blk in col_blocks(flat.shape[1])]
    out = parts[0] if len(parts) == 1 else torch.cat(parts)
    return out / torch.clamp(torch.sum(good_w), min=1.0)


def _grad_dtype(cfg: SolverConfig, harness) -> torch.dtype:
    """Storage dtype of the (W, d) flat gradient view: the guard's
    statistics dtype when lowered, else the harness dtype."""
    stats = resolve_stats_dtype(cfg.stats_dtype)
    return stats if stats != F32 else harness.flat_dtype


def _validate(cfg: SolverConfig, V: float) -> None:
    if (cfg.aggregator == "byzantine_sgd"
            and cfg.guard_backend in ("dense", "fused") and V <= 0):
        raise ValueError(
            f"guard backend {cfg.guard_backend!r} has no online auto-V; "
            "pass an explicit V (Assumption-2.2 deviation bound) or select "
            "an auto-V-capable backend (dp_exact / dp_sketch)"
        )


def init_train_state(model, optimizer: Optimizer, cfg: SolverConfig, key: torch.Tensor, *,
                     V: float = 0.0, D: float = 10.0, adversary=None) -> TrainState:
    """Parameters from ``model.init(key)`` and every carried piece, on the
    model's device."""
    _validate(cfg, V)
    dev = model.device
    harness = params_harness(model)
    params = model.init(key)
    guard0, _ = make_aggregator(FlatSpec(harness.d, V, D), cfg, dev)
    adv0 = (adversary.init_state(cfg.m, harness.d, device=dev) if adversary is not None
            else torch.zeros((), device=dev))
    stale_on = getattr(adversary, "profile", None) is not None and cfg.max_delay > 0
    grad_buf0 = (torch.zeros((cfg.m, harness.d), dtype=_grad_dtype(cfg, harness), device=dev)
                 if stale_on else ())
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        guard=guard0,
        anchor=harness.ravel(params),
        step=0,
        ever_byz=torch.zeros((cfg.m,), dtype=torch.bool, device=dev),
        adv=adv0,
        prev_xi=torch.zeros((harness.d,), dtype=harness.flat_dtype, device=dev),
        prev_alive=torch.ones((cfg.m,), dtype=torch.bool, device=dev),
        prev_n_alive=torch.full((), cfg.m, dtype=torch.int32, device=dev),
        grad_buf=grad_buf0,
    )


def build_train_step(model, optimizer: Optimizer, cfg: SolverConfig, *, V: float = 0.0,
                     D: float = 10.0, adversary=None, telemetry=None,
                     timer: Callable[[str], None] | None = None) -> Callable:
    """Returns ``train_step(state, batch, byz_rank, key) -> (state',
    metrics)`` (module docstring).  ``cfg`` is the convex harness's
    :class:`~repro_torch.core.solver.SolverConfig`; ``cfg.eta`` is unused
    (the optimizer owns the learning rate).  ``key`` is the step's
    attack/adversary key (``fold_in(loop_key, step)`` in
    :mod:`repro_torch.launch.train`)."""
    _validate(cfg, V)
    dev = model.device
    harness = params_harness(model)
    tel_on = telemetry_on(telemetry)
    _, agg_step = make_aggregator(FlatSpec(harness.d, V, D), cfg, dev, telemetry)
    grad_dtype = _grad_dtype(cfg, harness)
    profile = getattr(adversary, "profile", None)
    stale_on = profile is not None and cfg.max_delay > 0
    part_on = profile is not None and cfg.partial_participation
    if adversary is None:
        attack_fn = attack_lib.get_attack(cfg.attack)
        attack_kwargs = dict(cfg.attack_kwargs)
    mark = timer if timer is not None else (lambda phase: None)
    grads_fn = torch.func.vmap(torch.func.grad_and_value(model.loss_fn, has_aux=True),
                               in_dims=(None, 0))

    def train_step(state: TrainState, batch: dict, byz_rank: torch.Tensor, key: torch.Tensor):
        k = state.step
        grads_w, (losses_w, _) = grads_fn(state.params, batch)
        mark("forward_backward")
        flat = harness.ravel_workers(grads_w, dtype=grad_dtype)   # (W, d) view
        del grads_w
        mark("ravel")
        x = harness.ravel(state.params)

        grad_buf = state.grad_buf
        if stale_on:
            # between refreshes a straggler's carried row (a gradient of
            # older params) is what reaches the attack and the guard
            refresh = adversary.refresh_at(k, cfg.max_delay)
            grad_buf = torch.where(refresh[:, None], flat, grad_buf)
            flat = grad_buf

        mask_k = (byz_rank < cfg.n_byzantine if adversary is None
                  else adversary.mask_at(byz_rank, k))
        good_w = (~mask_k).to(flat.dtype)[:, None]
        honest_mean = _honest_mean(flat, good_w)
        v_ctx = (torch.full((), V, dtype=F32, device=dev) if V > 0
                 else _estimate_v(flat))     # flat is pre-attack: all honest
        ctx = {"true_grad": honest_mean, "V": v_ctx, "step": k,
               "alive": state.prev_alive, "n_alive": state.prev_n_alive,
               "prev_xi": state.prev_xi}
        if adversary is None:
            flat = attack_fn(key, flat, mask_k, ctx, **attack_kwargs)
        else:
            flat = adversary.attack(key, flat, mask_k, ctx, state.adv)

        report = None
        if part_on:
            # fold_in leaves the attack's own key stream untouched
            report = adversary.report_at(prng.fold_in(key, 7919), mask_k)
            n_rep = torch.sum(report, dtype=torch.int32)
        mark("attack")

        guard, xi_flat, n_alive, alive, *frame = agg_step(state.guard, flat, x, state.anchor,
                                                         report)
        adv = state.adv
        if adversary is not None:
            adv = adversary.update_state(state.adv, mask_k, flat, xi_flat, alive, n_alive, ctx)
        # the rows are done with: free them before the optimizer's moments
        del flat, ctx, honest_mean
        mark("guard")

        updates, opt_state = optimizer.update(harness.unravel(xi_flat), state.opt_state,
                                              state.params, k)
        params = tree_add(state.params, updates)
        mark("optimizer")

        ever_byz = state.ever_byz | mask_k
        good = (~mask_k).to(F32)
        n_alive = torch.as_tensor(n_alive, device=dev).to(torch.int32)
        metrics = {
            "loss_good_workers": torch.sum(losses_w * good) / torch.clamp(torch.sum(good), min=1),
            "loss_all_workers": torch.mean(losses_w),
            "n_alive": n_alive,
            "good_filtered": torch.sum((~alive) & (~ever_byz), dtype=torch.int32),
            "byz_alive": torch.sum(alive & mask_k, dtype=torch.int32),
            "n_byz": torch.sum(mask_k, dtype=torch.int32),
            # one schema for every aggregator: NaN where nothing calibrates V
            "v_est": (guard.v_est if hasattr(guard, "v_est")
                      else torch.full((), float("nan"), dtype=F32, device=dev)),
            "n_reporting": (n_rep.to(F32) if part_on
                            else torch.full((), float("nan"), dtype=F32, device=dev)),
        }
        if tel_on:
            frame = frame[0]
            frame["step"] = torch.full((), k + 1, dtype=F32, device=dev)
            frame["xi_norm"] = torch.linalg.vector_norm(xi_flat.to(F32))
            scale = getattr(adv, "adapt_scale", None)
            if scale is not None:
                frame["adapt_scale"] = scale.to(F32)
            if part_on:
                frame["n_reporting"] = n_rep.to(F32)
            if stale_on:
                frame["staleness"] = torch.mean(
                    adversary.staleness_at(k, cfg.max_delay).to(F32))
            metrics.update({f"tel/{name}": val for name, val in frame.items()})
        new_state = TrainState(
            params=params, opt_state=opt_state, guard=guard, anchor=state.anchor, step=k + 1,
            ever_byz=ever_byz, adv=adv, prev_xi=xi_flat.to(state.prev_xi.dtype),
            prev_alive=alive, prev_n_alive=n_alive, grad_buf=grad_buf,
        )
        return new_state, metrics

    return train_step
