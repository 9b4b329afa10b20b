"""Train campaigns — a grid of LM training runs (the counterpart of
:mod:`repro.scenarios.train_campaign`).

Every grid row is a whole ``build_train_step`` run: real per-worker
gradients of a (reduced) LM, the tree harness's flat rows, any guard
backend and the scenario adversary's carried state.  As in
:mod:`repro_torch.scenarios.campaign`, the rows are split into groups that
share their host decisions (:func:`~repro_torch.scenarios.campaign.
run_groups`: scenario, α, whether a profile is armed) and each group is one
``torch.func.vmap`` of the run over its seeds (and profile leaves): each
row's parameters, optimizer moments and guard state ride a leading run
axis around the step's own ``vmap`` over the workers, and on the card each
guard kernel launches once a step for the group (``fused_guard`` and
``filtered_mean`` over the run axis, ``countsketch`` folded).  The rows
come back in grid order; ``chunk_size`` runs a group in chunks of at most
that many rows.  Every row of a group reads the same token stream, as in
the JAX package (``make_worker_batch`` takes the step, not the seed).

Memory: a group replicates parameters, optimizer and guard state once a
row, so use reduced configs.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.solver import SolverConfig, byz_rank
from repro_torch.data.synthetic import SyntheticTokens, make_worker_batch
from repro_torch.distributed.trainer import build_train_step, init_train_state
from repro_torch.scenarios.adversary import ScenarioAdversary
from repro_torch.scenarios.campaign import (
    _chunked_vmap,
    _kernels_build_s,
    _rows,
    expand_variants,
    run_groups,
)
from repro_torch.scenarios.spec import CampaignGrid, WorkerProfile


class TrainRunStats(NamedTuple):
    """Per-run training summaries; every tensor has leading axis N (the grid)."""

    loss_first: torch.Tensor        # loss_good_workers at step 0
    loss_final: torch.Tensor        # loss_good_workers at the last step
    n_alive_final: torch.Tensor     # |good_T|, int32
    byz_alive_final: torch.Tensor   # the last step's Byzantine survivors (the
    #                                 trainer's byz_alive: under churn a reformed
    #                                 worker staying alive does not count), int32
    n_byz_ever: torch.Tensor        # |{workers ever Byzantine}|, int32
    ever_filtered_good: torch.Tensor  # did the filter ever drop an honest worker


class TrainCampaignResult(NamedTuple):
    stats: dict[str, TrainRunStats]  # variant name → per-run stats in grid order
    entries: list[dict]              # grid row metadata (scenario, α, seed)
    wall_s: float                    # host clock over every run, to the device's end
    compile_s: float                 # the kernels' build inside the call (0 when built)
    n_runs: int                      # grid rows per variant
    steps: int
    memory: dict | None = None       # {"peak_bytes": …} over the call; None on the CPU


def build_train_campaign_fn(model, optimizer, base_cfg: SolverConfig,
                            aggregators: Sequence[str], *, steps: int, stream: SyntheticTokens,
                            per_worker_batch: int = 1, backends: Sequence[str] | None = None,
                            V: float = 0.0, D: float = 10.0, chunk_size: int | None = None):
    """The ``campaign(grid) -> {variant: TrainRunStats}`` function on the
    model's device.  Each group of :func:`run_groups` is one ``vmap`` of
    the run (in chunks of at most ``chunk_size`` rows), each variant in
    turn; a row's profile skews its data and arms the trainer's gates."""
    cfgs = expand_variants(base_cfg, aggregators, backends)
    W = base_cfg.m
    dev = model.device

    def campaign(grid: CampaignGrid) -> dict[str, TrainRunStats]:
        groups = run_groups(grid)
        order = torch.tensor([i for idx in groups for i in idx])
        inverse = torch.argsort(order).to(dev)
        keys = torch.stack([prng.PRNGKey(int(s), device=dev) for s in grid.seeds])
        out = {}
        for name, cfg in cfgs.items():
            parts = []
            for idx in groups:
                scn, alpha = grid.scenarios[idx[0]], grid.alpha[idx[0]]
                rows = torch.tensor(idx, device=dev)
                axes = (keys[rows],)
                if grid.profiles is not None:
                    axes += (_rows(grid.profiles, rows),)

                def one(key, prof=None, cfg=cfg, scn=scn, alpha=alpha):
                    prof = None if prof is None else WorkerProfile(*prof)
                    adv = ScenarioAdversary(scenario=scn, alpha=alpha, profile=prof)
                    train_step = build_train_step(model, optimizer, cfg, V=V, D=D,
                                                  adversary=adv)
                    init_key, mask_key, loop_key = prng.split(key, 3)
                    state = init_train_state(model, optimizer, cfg, init_key, V=V, D=D,
                                             adversary=adv)
                    rank = byz_rank(mask_key, W)
                    losses, goodf = [], []
                    for i in range(steps):
                        batch = make_worker_batch(stream, W, per_worker_batch, i,
                                                  skew=None if prof is None else prof.skew,
                                                  device=dev)
                        state, m = train_step(state, batch, rank, prng.fold_in(loop_key, i))
                        losses.append(m["loss_good_workers"])
                        goodf.append(m["good_filtered"])
                    return {"loss_first": losses[0], "loss_final": losses[-1],
                            "n_alive_final": state.prev_n_alive,
                            "byz_alive_final": m["byz_alive"].to(torch.int32),
                            "n_byz_ever": torch.sum(state.ever_byz, dtype=torch.int32),
                            "ever_filtered_good": torch.any(torch.stack(goodf) > 0)}

                parts.append(_chunked_vmap(one, axes, len(idx), chunk_size))
            out[name] = TrainRunStats(**{k: torch.cat([p[k] for p in parts])[inverse]
                                         for k in parts[0]})
        return out

    return campaign


def run_train_campaign(model, optimizer, base_cfg: SolverConfig, grid: CampaignGrid, *,
                       steps: int, stream: SyntheticTokens, per_worker_batch: int = 1,
                       aggregators: Sequence[str] = ("byzantine_sgd",),
                       backends: Sequence[str] | None = None, V: float = 0.0, D: float = 10.0,
                       chunk_size: int | None = None) -> TrainCampaignResult:
    """Every (aggregator × backend) variant over the whole grid on the
    model's device.  ``wall_s`` is the host clock over the runs, up to
    ``torch.cuda.synchronize()`` on the card; ``compile_s`` the kernels'
    build inside the call (0 when built); ``memory`` the device's peak
    allocation over the call (None on the CPU)."""
    dev = model.device
    fn = build_train_campaign_fn(model, optimizer, base_cfg, aggregators, steps=steps,
                                 stream=stream, per_worker_batch=per_worker_batch,
                                 backends=backends, V=V, D=D, chunk_size=chunk_size)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    compile_s = _kernels_build_s(dev)
    t0 = time.perf_counter()
    out = fn(grid)
    if cuda:
        torch.cuda.synchronize(dev)
    wall_s = time.perf_counter() - t0
    return TrainCampaignResult(
        stats=out, entries=grid.entries, wall_s=wall_s, compile_s=compile_s,
        n_runs=grid.n_runs, steps=steps,
        memory={"peak_bytes": int(torch.cuda.max_memory_allocated(dev))} if cuda else None)


def summarize_train_campaign(result: TrainCampaignResult, base_cfg: SolverConfig) -> dict:
    """The per-run stats reduced to the JAX package's leaderboard: one row
    per (scenario, α, variant), medians and extremes over the seeds."""
    from repro_torch.scenarios.report import _entry_label

    variants = sorted(result.stats)
    groups: dict[tuple[str, float], list[int]] = {}
    for i, e in enumerate(result.entries):
        groups.setdefault((_entry_label(e), e["alpha"]), []).append(i)

    def col(t: torch.Tensor, idx: list) -> np.ndarray:
        return t.detach().cpu().numpy()[idx]

    rows = []
    for (scn, alpha), idx in sorted(groups.items()):
        for name in variants:
            st = result.stats[name]
            rows.append({
                "scenario": scn,
                "alpha": alpha,
                "variant": name,
                "n_seeds": len(idx),
                "loss_first_med": float(np.median(col(st.loss_first, idx))),
                "loss_final_med": float(np.median(col(st.loss_final, idx))),
                "n_alive_final_min": int(col(st.n_alive_final, idx).min()),
                "byz_alive_final_max": int(col(st.byz_alive_final, idx).max()),
                "n_byz_ever_max": int(col(st.n_byz_ever, idx).max()),
                "ever_filtered_good": bool(col(st.ever_filtered_good, idx).any()),
            })
    return {
        "config": {"m": base_cfg.m, "steps": result.steps},
        "variants": variants,
        "n_runs_per_variant": result.n_runs,
        "wall_clock": {"batched_s": result.wall_s, "compile_s": result.compile_s,
                       "runs_total": result.n_runs * len(variants)},
        "leaderboard": rows,
    }
