"""Campaign runner — the counterpart of :mod:`repro.scenarios.campaign`.

The JAX package lowers a whole (scenario × α × seed × profile × fault)
grid, for every aggregator, into one ``jit(vmap(run_sgd))``.  The port
keeps each run's host decisions on the host — the scenario, α (which sets
the Byzantine count), the fault plan and whether a worker profile is
armed — so it splits the grid into *groups* of rows that share them,
and maps one ``run_sgd`` over each group with ``torch.func.vmap``: the
seeds (and the profiles' leaves) ride a leading run axis, every step of
the group is one pass of the single-run code, and on the card each
kernel launches once a step for the whole group
(:mod:`repro_torch.kernels.run_axis`).  The rows come back in grid order.
A row gives what ``run_sgd`` of that row alone gives, decisions exactly;
values can move by an ulp where a batched product sums in another order
than the single run's.

**Variants.**  ``"byzantine_sgd"`` expands to one ``"byzantine_sgd@<b>"``
variant per entry of ``backends``; ``"agg@backend"`` spellings pass
through; a backend may carry a stats-dtype suffix (``"fused@bf16"``).  The
pseudo-backend ``"gen"`` maps to the fused guard with
``generate="kernel"``, as in the JAX package: its group's steps launch the
two generating kernels once each for the group's runs, and no (m, d)
batch is built.

**Chunking.**  ``chunk_size=c`` runs each group in chunks of at most c
runs, one after another, so at most c runs are live on the device; any c
gives the same decisions, and the guard variants' stats (their telemetry
rings included) bit for bit.

**Telemetry.**  ``telemetry=`` (a :class:`repro_torch.obs.TelemetryConfig`)
arms the flight recorder in every run: ``RunStats.telemetry`` is the JAX
package's block, ``{"ring": TelemetryRing(lanes (N, ring_size, width),
head (N,)), "first_filter_step": (N, m), "byz_alive": (N, T), "byz_mask":
(N, m)}`` in grid order.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import torch
from torch.func import vmap

from repro_torch import prng, resolve_device
from repro_torch.core.guard_backends import parse_backend_spec
from repro_torch.core.solver import Problem, SolverConfig, run_sgd
from repro_torch.kernels import _build
from repro_torch.obs.telemetry import TelemetryRing, telemetry_on
from repro_torch.scenarios.adversary import ScenarioAdversary
from repro_torch.scenarios.spec import CampaignGrid, WorkerProfile


class RunStats(NamedTuple):
    """Per-run summaries; every tensor has leading axis N (the grid)."""

    gap_avg: torch.Tensor        # f(x̄) − f*   (Theorem-3.8 average iterate)
    gap_final: torch.Tensor      # f(x_T) − f*
    n_alive_final: torch.Tensor  # |good_T|, int32
    n_byz_ever: torch.Tensor     # |{workers ever Byzantine}|, int32
    detect_latency: torch.Tensor  # first k with |good_k| ≤ m − n_byz_ever; -1 = never
    ever_filtered_good: torch.Tensor  # did the filter ever drop a never-Byzantine worker
    gaps: torch.Tensor | None = None  # (N, T) traces, only when return_gaps
    telemetry: dict | None = None     # the flight recorder's block when armed
    #                                   (module docstring), else None
    report_frac: torch.Tensor | None = None  # mean reporter fraction a step under
    #                                          partial participation, else None


class CampaignResult(NamedTuple):
    stats: dict[str, RunStats]   # variant name → per-run stats in grid order
    entries: list[dict]          # grid row metadata (scenario name, α, seed, …)
    wall_s: float                # host clock over every run, to the device's end
    compile_s: float             # the kernels' build and load inside the call;
    #                              0 when they are already built (no XLA compile here)
    n_runs: int                  # grid rows per variant
    memory: dict | None = None   # {"peak_bytes": torch.cuda.max_memory_allocated}
    #                              over the call; None on the CPU


def _summarize(problem: Problem, cfg: SolverConfig, res, return_gaps: bool) -> dict:
    """One run's summaries (vmapped over a group), as a dict of tensors."""
    f_star = problem.f(problem.x_star)
    n_byz_ever = torch.sum(res.byz_mask, dtype=torch.int32)
    hit = res.n_alive <= (cfg.m - n_byz_ever)
    detect = torch.where(torch.any(hit) & (n_byz_ever > 0),
                         torch.argmax(hit.to(torch.int32)).to(torch.int32) + 1,
                         torch.tensor(-1, dtype=torch.int32, device=hit.device))
    out = {
        "gap_avg": problem.f(res.x_avg) - f_star,
        "gap_final": problem.f(res.x_final) - f_star,
        "n_alive_final": res.n_alive[-1].to(torch.int32),
        "n_byz_ever": n_byz_ever,
        "detect_latency": detect,
        "ever_filtered_good": res.ever_filtered_good,
    }
    if return_gaps:
        out["gaps"] = res.gaps
    if res.n_reporting is not None:
        out["report_frac"] = torch.mean(res.n_reporting.to(torch.float32)) / cfg.m
    if res.telemetry is not None:
        # byz_mask rides along so the report splits timelines into
        # Byzantine and good workers
        out.update({"telemetry.lanes": res.telemetry.ring.lanes,
                    "telemetry.first_filter_step": res.telemetry.first_filter_step,
                    "telemetry.byz_alive": res.telemetry.byz_alive,
                    "telemetry.byz_mask": res.byz_mask})
    return out


def _telemetry_block(stats: dict, T: int) -> dict:
    """The flat ``telemetry.*`` columns of a variant's stats as the JAX
    package's block (every run pushed one frame a step)."""
    lanes = stats.pop("telemetry.lanes")
    head = torch.full((lanes.shape[0],), T, dtype=torch.int32, device=lanes.device)
    return {"ring": TelemetryRing(lanes=lanes, head=head),
            "first_filter_step": stats.pop("telemetry.first_filter_step"),
            "byz_alive": stats.pop("telemetry.byz_alive"),
            "byz_mask": stats.pop("telemetry.byz_mask")}


GUARD_AGGREGATOR = "byzantine_sgd"


def expand_variants(base_cfg: SolverConfig, aggregators: Sequence[str],
                    backends: Sequence[str] | None = None) -> dict[str, SolverConfig]:
    """Variant name → SolverConfig for the (aggregator × guard backend ×
    stats dtype) axes, as the JAX package spells them: ``"byzantine_sgd"``
    expands to ``"byzantine_sgd@<backend>"`` per entry of ``backends``;
    ``"agg@backend"`` passes through (only the guard has backends, else
    ValueError); a ``@<stats_dtype>`` suffix sets ``stats_dtype``; the
    pseudo-backend ``"gen"`` is the fused guard with ``generate="kernel"``."""
    def _guard_cfg(spec: str) -> SolverConfig:
        be, sdt = parse_backend_spec(spec)
        generate = "kernel" if be == "gen" else base_cfg.generate
        be = "fused" if be == "gen" else be
        return base_cfg._replace(
            aggregator=GUARD_AGGREGATOR, guard_backend=be, generate=generate,
            stats_dtype=sdt if sdt is not None else base_cfg.stats_dtype)

    cfgs: dict[str, SolverConfig] = {}
    for name in aggregators:
        agg, _, be = name.partition("@")
        if be:
            if agg != GUARD_AGGREGATOR:
                raise ValueError(f"{name!r}: only {GUARD_AGGREGATOR!r} has guard backends")
            cfgs[name] = _guard_cfg(be)
        elif agg == GUARD_AGGREGATOR and backends:
            for b in backends:
                cfgs[f"{agg}@{b}"] = _guard_cfg(b)
        else:
            cfgs[name] = base_cfg._replace(aggregator=agg)
    return cfgs


def run_groups(grid: CampaignGrid) -> list[list[int]]:
    """The grid's rows split into groups that share every host decision of
    a run — scenario, α, fault plan, and whether a profile is armed (a
    grid has one profile axis or none) — in order of first appearance,
    each group's rows in grid order.  Only seeds and profile leaves differ
    inside a group."""
    groups: dict[tuple, list[int]] = {}
    for i in range(grid.n_runs):
        plan = None if grid.faults is None else grid.faults[i]
        groups.setdefault((grid.scenarios[i], float(grid.alpha[i]), plan), []).append(i)
    return list(groups.values())


def _chunked_vmap(one, axes: tuple, n: int, chunk_size: int | None) -> dict:
    """``vmap(one)`` over the leading axis of ``axes`` (n runs), or over
    chunks of at most ``chunk_size`` runs in turn, so only one chunk is live
    on the device at a time.  No padding is needed: a short last chunk is
    just a narrower vmap."""
    if chunk_size is not None and chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    if chunk_size is None or chunk_size >= n:
        return vmap(one)(*axes)
    parts = [vmap(one)(*(_rows(a, slice(i, i + chunk_size)) for a in axes))
             for i in range(0, n, chunk_size)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _rows(tree, idx):
    """Rows ``idx`` of a tensor or of a record of tensors (a profile)."""
    if isinstance(tree, torch.Tensor):
        return tree[idx]
    return type(tree)(*(leaf[idx] for leaf in tree))


def build_campaign_fn(problem: Problem, base_cfg: SolverConfig, aggregators: Sequence[str],
                      return_gaps: bool = False, backends: Sequence[str] | None = None,
                      telemetry=None, chunk_size: int | None = None, device="cuda"):
    """The ``campaign(grid) -> {variant: RunStats}`` function on ``device``
    (the card unless the caller asks for the CPU).

    ``base_cfg`` supplies everything shared: m, T, η, thresholds and the
    nominal α that sizes Krum's f and the trimmed-mean fraction; each run's
    own α is a grid axis the adversary owns.  Each group of
    :func:`run_groups` is one ``vmap`` of ``run_sgd`` (in chunks of at most
    ``chunk_size`` runs), each variant in turn; ``telemetry`` arms the
    flight recorder in every run."""
    cfgs = expand_variants(base_cfg, aggregators, backends)
    tel_on = telemetry_on(telemetry)
    dev = resolve_device(device)

    def campaign(grid: CampaignGrid) -> dict[str, RunStats]:
        if grid.profiles is not None and grid.profiles.skew.device.type != dev.type:
            raise ValueError(f"the grid's profiles live on {grid.profiles.skew.device}, "
                             f"the campaign on {dev}")
        groups = run_groups(grid)
        order = torch.tensor([i for idx in groups for i in idx])
        inverse = torch.argsort(order).to(dev)
        keys = torch.stack([prng.PRNGKey(int(s), device=dev) for s in grid.seeds])
        out = {}
        for name, cfg in cfgs.items():
            parts = []
            for idx in groups:
                i0 = idx[0]
                scn, alpha = grid.scenarios[i0], grid.alpha[i0]
                plan = None if grid.faults is None else grid.faults[i0]
                rows = torch.tensor(idx, device=dev)
                axes = (keys[rows],)
                if grid.profiles is not None:
                    axes += (_rows(grid.profiles, rows),)

                def one(key, prof=None, cfg=cfg, scn=scn, alpha=alpha, plan=plan):
                    prof = None if prof is None else WorkerProfile(*prof)
                    adv = ScenarioAdversary(scenario=scn, alpha=alpha, profile=prof,
                                            faults=plan)
                    res = run_sgd(problem, cfg, key, adversary=adv, telemetry=telemetry,
                                  device=dev)
                    return _summarize(problem, cfg, res, return_gaps)

                parts.append(_chunked_vmap(one, axes, len(idx), chunk_size))
            stats = {k: torch.cat([p[k] for p in parts])[inverse] for k in parts[0]}
            if tel_on:
                stats["telemetry"] = _telemetry_block(stats, cfg.T)
            out[name] = RunStats(**stats)
        return out

    return campaign


def _kernels_build_s(dev: torch.device) -> float:
    """Seconds to build the kernels that are not built yet (0 when all
    are, and on the CPU, which runs none)."""
    if dev.type != "cuda" or all(_build.library_path(src).exists() for src in _build.sources()):
        return 0.0
    t0 = time.perf_counter()
    _build.build_all()
    return time.perf_counter() - t0


def run_campaign(problem: Problem, base_cfg: SolverConfig, grid: CampaignGrid,
                 aggregators: Sequence[str], return_gaps: bool = False,
                 backends: Sequence[str] | None = None, telemetry=None,
                 chunk_size: int | None = None, device="cuda") -> CampaignResult:
    """Every (aggregator × backend) variant over the whole grid on
    ``device``.  ``wall_s`` is the host clock over the runs, up to
    ``torch.cuda.synchronize()`` on the card; ``compile_s`` the kernels'
    build inside the call (0 when built); ``memory`` the device's peak
    allocation over the call, ``{"peak_bytes": …}`` (None on the CPU)."""
    dev = resolve_device(device)
    fn = build_campaign_fn(problem, base_cfg, aggregators, return_gaps, backends, telemetry,
                           chunk_size, dev)
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
    return CampaignResult(
        stats=out, entries=grid.entries, wall_s=wall_s, compile_s=compile_s,
        n_runs=grid.n_runs,
        memory={"peak_bytes": int(torch.cuda.max_memory_allocated(dev))} if cuda else None)


def run_campaign_looped(problem: Problem, base_cfg: SolverConfig, grid: CampaignGrid,
                        aggregators: Sequence[str], backends: Sequence[str] | None = None,
                        device="cuda") -> tuple[dict[str, list[float]], float]:
    """The baseline without a run axis: one ``run_sgd`` per grid row per
    variant.  Returns each variant's gaps f(x̄) − f* in grid order and the
    total seconds."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    cfgs = expand_variants(base_cfg, aggregators, backends)
    gaps: dict[str, list[float]] = {name: [] for name in cfgs}
    f_star = problem.f(problem.x_star)
    for name, cfg in cfgs.items():
        for i in range(grid.n_runs):
            prof = (None if grid.profiles is None
                    else WorkerProfile(*(leaf[i] for leaf in grid.profiles)))
            plan = None if grid.faults is None else grid.faults[i]
            adv = ScenarioAdversary(scenario=grid.scenarios[i], alpha=grid.alpha[i],
                                    profile=prof, faults=plan)
            res = run_sgd(problem, cfg, prng.PRNGKey(int(grid.seeds[i]), device=dev),
                          adversary=adv, device=dev)
            gaps[name].append(float(problem.f(res.x_avg) - f_star))
    return gaps, time.perf_counter() - t0
