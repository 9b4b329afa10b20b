"""Campaign reporting — the counterpart of :mod:`repro.scenarios.report`.

Reduces a :class:`repro_torch.scenarios.campaign.CampaignResult` across
seeds into the JAX package's record:

* the **leaderboard** — median + IQR suboptimality and detection-latency
  percentiles per (scenario, α, aggregator);
* the **degradation table** — each dynamic adversary beside its static
  counterpart, per aggregator;
* the **guard bound check** — each guard variant's gap against the
  Theorem-3.8 prediction at the run's realized ever-Byzantine fraction;
* the **aggregator ranking** — mean rank, worst-case gap and break count
  per aggregator over every (scenario × α) cell;
* the **filter timelines** (when the campaign ran with the flight
  recorder armed) — per cell, how fast the guard caught the corrupted
  workers, whether it spent a good one, and a Byzantine survival curve.

:func:`campaign_trace_events` drains an armed campaign's rings into an
:class:`~repro_torch.obs.events.EventLog`.  :func:`write_report` takes its
path with no default.
"""
from __future__ import annotations

import json
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.solver import Problem, SolverConfig
from repro_torch.obs.provenance import provenance_meta
from repro_torch.obs.telemetry import TelemetryRing, ring_read
from repro_torch.scenarios.campaign import CampaignResult

# "survives" / "breaks" thresholds on f(x̄) − f*, in units of the
# Theorem-3.8 α-term DVα/√T
_SURVIVE_MULT = 2.0
_BREAK_MULT = 6.0


def theorem38_bound(problem: Problem, cfg: SolverConfig, alpha: float, c: float = 3.0,
                    V: float | None = None, m_eff: float | None = None) -> float:
    """c · (DVα/√T + DV/√(mT) + D²L/T): the Theorem-3.8 guarantee with the
    constant c = 3.  ``V`` overrides ``problem.V`` (a non-iid row's
    realized V), ``m_eff`` overrides ``cfg.m`` in the statistical term
    (partial participation)."""
    D, L, T = problem.D, problem.L, cfg.T
    V = problem.V if V is None else V
    m = cfg.m if m_eff is None else max(m_eff, 1.0)
    return c * (D * V * alpha / math.sqrt(T) + D * V / math.sqrt(m * T)
                + D * D * max(L, 1.0) / T)


def _entry_label(e: dict) -> str:
    """The scenario name, suffixed with the profile's for non-iid rows."""
    prof = e.get("profile", "iid")
    return e["scenario"] if prof == "iid" else f"{e['scenario']}+{prof}"


def _percentile(xs: np.ndarray, q: float) -> float:
    return float(np.percentile(xs, q)) if xs.size else float("nan")


def _survival_curve(series: np.ndarray, max_points: int = 64) -> list[list[int]]:
    """A (T,) step series as at most ``max_points`` ``[step, value]``
    change points (1-based steps, both ends kept; strided when it changes
    more often than that)."""
    series = np.asarray(series)
    keep = np.flatnonzero(np.diff(series, prepend=series[0] + 1))
    keep = np.union1d(keep, [0, series.size - 1])
    if keep.size > max_points:
        keep = keep[np.linspace(0, keep.size - 1, max_points).astype(int)]
    return [[int(k) + 1, int(series[k])] for k in keep]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def filter_timelines(result: CampaignResult, max_curve_points: int = 64) -> list[dict]:
    """The flight recorder's reduction: one row per (scenario, α, variant)
    cell of an armed campaign.  Splits each worker's first-filter step by
    its ever-Byzantine flag (how fast the guard catches corrupted workers,
    and whether it ever spent a good one) and attaches a Byzantine
    survival curve from the cell's first seed.  Empty when the campaign
    ran without telemetry."""
    groups: dict[tuple[str, float], list[int]] = {}
    for i, e in enumerate(result.entries):
        groups.setdefault((_entry_label(e), e["alpha"]), []).append(i)

    rows = []
    for agg in sorted(result.stats):
        tel = result.stats[agg].telemetry
        if tel is None:
            continue
        ffs = _np(tel["first_filter_step"])          # (N, m), -1 = never
        byz = _np(tel["byz_mask"]).astype(bool)      # (N, m)
        surv = _np(tel["byz_alive"])                 # (N, T)
        for (scn, alpha), idx in sorted(groups.items()):
            ii = np.asarray(idx)
            byz_ffs = ffs[ii][byz[ii]]
            good_ffs = ffs[ii][~byz[ii]]
            caught = byz_ffs[byz_ffs > 0].astype(float)
            rep = ii[0]  # the seed whose curve is kept
            rows.append({
                "scenario": scn,
                "alpha": alpha,
                "aggregator": agg,
                "n_seeds": len(idx),
                "n_byz_workers": int(byz[ii].sum()),
                "n_byz_caught": int((byz_ffs > 0).sum()),
                "first_filter_byz_med": _percentile(caught, 50) if caught.size else -1.0,
                "first_filter_byz_p90": _percentile(caught, 90) if caught.size else -1.0,
                "n_good_filtered": int((good_ffs > 0).sum()),
                "byz_survival": _survival_curve(surv[rep], max_curve_points),
                "survival_seed": int(result.entries[rep]["seed"]),
            })
    return rows


def campaign_trace_events(result: CampaignResult, log, select=None) -> int:
    """Drain an armed campaign's per-cell rings into an ``EventLog``: one
    ``guard_step`` event per kept frame and one ``timeline`` event
    (first-filter steps, the Byzantine mask, the survival curve) per
    selected cell, labelled ``<scenario>/a<alpha>/<variant>/s<seed>``.
    ``select(entry) -> bool`` filters grid rows.  Each variant's block
    goes to the host in one copy.  Returns the number of cells exported."""
    n_cells = 0
    for agg in sorted(result.stats):
        tel = result.stats[agg].telemetry
        if tel is None:
            continue
        lanes, head = _np(tel["ring"].lanes), _np(tel["ring"].head)
        ffs, mask = _np(tel["first_filter_step"]), _np(tel["byz_mask"])
        surv = _np(tel["byz_alive"])
        for i, e in enumerate(result.entries):
            if select is not None and not select(e):
                continue
            run = f"{_entry_label(e)}/a{e['alpha']:g}/{agg}/s{e['seed']}"
            for frame in ring_read(TelemetryRing(lanes=lanes[i], head=int(head[i]))):
                log.guard_step(frame, run=run)
            log.event("timeline", run=run, first_filter_step=ffs[i], byz_mask=mask[i],
                      # the whole horizon (the ring keeps only its last
                      # frames), change-point compressed
                      byz_survival=_survival_curve(surv[i]))
            n_cells += 1
    return n_cells


def summarize_campaign(result: CampaignResult, problem: Problem, base_cfg: SolverConfig,
                       static_of: dict[str, str] | None = None,
                       guard_name: str = "byzantine_sgd") -> dict:
    """Per-run stats reduced across seeds into the report record (the JAX
    package's keys).  ``static_of`` maps each dynamic scenario name to the
    static one it is compared with in the degradation table."""
    entries = result.entries
    aggregators = sorted(result.stats)
    groups: dict[tuple[str, float], list[int]] = {}
    for i, e in enumerate(entries):
        groups.setdefault((_entry_label(e), e["alpha"]), []).append(i)

    def _eps(alpha: float) -> tuple[float, float]:
        t = (problem.D * problem.V * max(alpha, 1.0 / base_cfg.m) / math.sqrt(base_cfg.T))
        return _SURVIVE_MULT * t, _BREAK_MULT * t

    table = []
    med: dict[tuple[str, float, str], float] = {}
    for (scn, alpha), idx in sorted(groups.items()):
        _, break_eps = _eps(alpha)
        for agg in aggregators:
            st = result.stats[agg]
            g = _np(st.gap_avg)[idx]
            lat = _np(st.detect_latency)[idx]
            lat_hit = lat[lat > 0]
            row = {
                "scenario": scn, "alpha": alpha, "aggregator": agg, "n_seeds": len(idx),
                "gap_med": _percentile(g, 50),
                "gap_p25": _percentile(g, 25),
                "gap_p75": _percentile(g, 75),
                "detect_p50": _percentile(lat_hit, 50) if lat_hit.size else -1,
                "detect_p90": _percentile(lat_hit, 90) if lat_hit.size else -1,
                "detect_rate": float((lat > 0).mean()) if lat.size else 0.0,
                "n_byz_ever_max": int(_np(st.n_byz_ever)[idx].max()),
                "ever_filtered_good": bool(_np(st.ever_filtered_good)[idx].any()),
            }
            row["breaks"] = bool(row["gap_med"] > break_eps)
            table.append(row)
            med[(scn, alpha, agg)] = row["gap_med"]

    # every guard variant gets its own Theorem-3.8 check
    guard_keys = [a for a in aggregators if a == guard_name or a.startswith(guard_name + "@")]
    guard_bound = []
    for gk in guard_keys:
        st = result.stats[gk]
        for (scn, alpha), idx in sorted(groups.items()):
            e0 = entries[idx[0]]
            alpha_ever = float(_np(st.n_byz_ever)[idx].max() / base_cfg.m)
            # the theorem's regime is α_ever < 1/2; out of it the row says so
            in_regime = alpha_ever < 0.5
            skew = float(e0.get("skew", 0.0))
            v_real = (problem.het["V0"] + skew * problem.het["cmax"]
                      if problem.het is not None else problem.V)
            m_eff = None
            if st.report_frac is not None:
                m_eff = float(_np(st.report_frac)[idx].mean() * base_cfg.m)
            bound = theorem38_bound(problem, base_cfg, alpha_ever, V=v_real, m_eff=m_eff)
            gap_med = med[(scn, alpha, gk)]
            guard_bound.append({
                "scenario": scn, "alpha": alpha, "aggregator": gk,
                "alpha_ever": alpha_ever, "in_regime": in_regime,
                "profile": e0.get("profile", "iid"), "skew": skew,
                "max_delay": int(e0.get("max_delay", 0)),
                "participation": float(e0.get("participation", 1.0)),
                "V_realized": v_real,
                **({"m_eff": m_eff} if m_eff is not None else {}),
                "bound": bound, "gap_med": gap_med,
                "within": bool(gap_med <= bound) if in_regime else None,
            })

    # the cross ranking: mean rank (1 = best) over every grid cell, the
    # worst median gap and the break count per aggregator
    ranking = []
    ranks: dict[str, list[float]] = {a: [] for a in aggregators}
    for (scn, alpha), _ in sorted(groups.items()):
        cell_gaps = sorted(med[(scn, alpha, a)] for a in aggregators)
        for a in aggregators:
            ranks[a].append(1 + cell_gaps.index(med[(scn, alpha, a)]))
    for a in aggregators:
        gaps = [med[k] for k in med if k[2] == a]
        ranking.append({
            "aggregator": a,
            "mean_rank": float(np.mean(ranks[a])),
            "gap_med_median": float(np.median(gaps)),
            "gap_med_worst": float(np.max(gaps)),
            "n_breaks": sum(1 for r in table if r["aggregator"] == a and r["breaks"]),
            "n_cells": len(ranks[a]),
        })
    ranking.sort(key=lambda r: r["mean_rank"])

    degradation = []
    for dyn, stat in (static_of or {}).items():
        for alpha in sorted({e["alpha"] for e in entries}):
            survive_eps, break_eps = _eps(alpha)
            for agg in aggregators:
                gd = med.get((dyn, alpha, agg))
                gs = med.get((stat, alpha, agg))
                if gd is None or gs is None:
                    continue
                degradation.append({
                    "aggregator": agg, "dynamic": dyn, "static": stat, "alpha": alpha,
                    "gap_dynamic": gd, "gap_static": gs, "ratio": gd / max(gs, 1e-12),
                    "survives_static": bool(gs < survive_eps),
                    "degraded": bool(gs < survive_eps and gd > break_eps),
                })

    timelines = filter_timelines(result)
    return {
        "problem": {"d": problem.d, "D": problem.D, "V": problem.V, "L": problem.L,
                    "sigma": problem.sigma},
        "config": {"m": base_cfg.m, "T": base_cfg.T, "eta": base_cfg.eta},
        "aggregators": aggregators,
        "n_runs_per_aggregator": result.n_runs,
        "thresholds": {
            str(alpha): dict(zip(("survive_eps", "break_eps"), _eps(alpha)))
            for alpha in sorted({e["alpha"] for e in entries})
        },
        "wall_clock": {"batched_s": result.wall_s, "compile_s": result.compile_s,
                       "runs_total": result.n_runs * len(aggregators)},
        "leaderboard": table,
        "aggregator_ranking": ranking,
        "guard_bound": guard_bound,
        "degradation": degradation,
        **({"filter_timelines": timelines} if timelines else {}),
    }


def write_report(record: dict, path: str) -> None:
    """Write ``record`` as JSON to ``path`` with a provenance ``meta`` block
    (an existing ``meta`` is kept)."""
    record.setdefault("meta", provenance_meta())
    with open(path, "w") as f:
        json.dump(record, f, indent=2)


def degraded_pairs(record: dict) -> Sequence[dict]:
    """Rows of the degradation table where a rule that survives the static
    attack breaks under its dynamic counterpart."""
    return [r for r in record["degradation"] if r["degraded"]]
