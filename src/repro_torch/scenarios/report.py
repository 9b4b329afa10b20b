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
  per aggregator over every (scenario × α) cell.

The flight recorder is not ported (ROADMAP.md §1, item 7): a campaign
carries no telemetry, :func:`filter_timelines` gives ``[]`` as the JAX
package's does for such a campaign, and ``campaign_trace_events`` is not
here.  :func:`write_report` takes its path with no default.
"""
from __future__ import annotations

import json
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.solver import Problem, SolverConfig
from repro_torch.obs.provenance import provenance_meta
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
    """The flight recorder's per-cell forensics (first-filter steps, the
    Byzantine survival curve): empty when the campaign ran without
    telemetry, which every campaign of the port does until the recorder is
    ported (ROADMAP.md §1, item 7)."""
    if any(st.telemetry is not None for st in result.stats.values()):
        raise NotImplementedError("not ported yet (ROADMAP.md §1): telemetry")
    return []


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
