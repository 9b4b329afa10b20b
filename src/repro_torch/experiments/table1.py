"""Table 1 — sample complexity: iterations-to-ε per aggregator, α, guard
backend and m (the counterpart of ``benchmarks/bench_table1.py``).

The paper's claims, measured on ``make_quadratic_problem(d=16, σ=1, L=8,
V=1, seed=0)`` at ε = 2e-2, T = 4000, over 5 seeds:

* α = 0: mini-batch SGD (mean) matches ByzantineSGD;
* the α sweep (0.125, 0.25, 0.375) under sign_flip: mean breaks while the
  guard's T-to-ε grows only by the α term; coordinate_median, krum and
  trimmed_mean beside it;
* the guard backends (dense, fused, dp_sketch with ``sketch_dim`` 8 < d)
  land the same T-to-ε distribution;
* the parallel speedup in m (4, 8, 16, 32; Remark 1.2).

Every point is one :func:`repro_torch.scenarios.run_campaign`: the seeds
ride the run axis, so each variant's 5 seeds are one group, each step one
pass for all of them.  Run it as::

    python -m repro_torch.experiments.table1 [--T N] [--device cpu] [--section NAME]

It prints one JSON line per point (the quantiles of iterations-to-ε over
the seeds that reach ε, as the reference's emit lines), and writes no
file.  It is the paper's experiment, not the port's benchmark.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.core.solver import SolverConfig
from repro_torch.data.problems import make_quadratic_problem
from repro_torch.scenarios.campaign import run_campaign
from repro_torch.scenarios.spec import expand_grid, scenario_static

SEEDS = range(5)
EPS = 2e-2
T_PAPER = 4000
ALPHAS = (0.125, 0.25, 0.375)
ALPHA_AGGREGATORS = ("mean", "byzantine_sgd", "coordinate_median", "krum", "trimmed_mean")
BACKENDS = ("dense", "fused", "dp_sketch")
WORKERS = (4, 8, 16, 32)
SECTIONS = ("alpha0", "alpha", "backend", "speedup")


def iters_to_eps_batch(gaps: np.ndarray, eps: float) -> np.ndarray:
    """First iteration (1-based) whose running-min gap is ≤ eps, per run;
    -1 where the run never reaches eps.  ``gaps`` is (N, T)."""
    below = np.minimum.accumulate(np.asarray(gaps), axis=1) <= eps
    hit = below.any(axis=1)
    return np.where(hit, below.argmax(axis=1) + 1, -1)


def quantiles(t: np.ndarray) -> dict:
    """The reference's quantile line: median and IQR of iterations-to-ε
    over the seeds that reach ε (median -1 when none does)."""
    ok = t[t > 0]
    if ok.size == 0:
        return {"iters_to_eps_med": -1, "iqr": None, "reached": 0, "n_seeds": int(t.size)}
    p25, med, p75 = np.percentile(ok, [25, 50, 75])
    return {"iters_to_eps_med": int(med), "iqr": [int(p25), int(p75)],
            "reached": int(ok.size), "n_seeds": int(t.size)}


def problem(device="cuda"):
    return make_quadratic_problem(d=16, sigma=1.0, L=8.0, V=1.0, seed=0, device=device)


def _point(name: str, st, T: int, seconds: float) -> dict:
    """One printed point: the quantiles, and each seed's iterations-to-ε,
    decisions and final gap."""
    gaps = st.gaps.detach().cpu().numpy()
    t = iters_to_eps_batch(gaps, EPS)
    return {"point": name, "T": T, **quantiles(t), "iters_to_eps": t.tolist(),
            "n_alive_final": st.n_alive_final.tolist(),
            "detect_latency": st.detect_latency.tolist(),
            "ever_filtered_good": st.ever_filtered_good.tolist(),
            "gap_final": st.gap_final.tolist(), "gap_avg": st.gap_avg.tolist(),
            "campaign_seconds": seconds}


def _campaign(prob, cfg: SolverConfig, alpha: float, aggregators, device, backends=None):
    grid = expand_grid([("sign_flip" if alpha else "none",
                         scenario_static("sign_flip" if alpha else "none"))], [alpha], SEEDS)
    return run_campaign(prob, cfg, grid, list(aggregators), return_gaps=True,
                        backends=backends, device=device)


def section(name: str, T: int = T_PAPER, device="cuda", alphas=ALPHAS,
            aggregators=ALPHA_AGGREGATORS, workers=WORKERS, prob=None) -> list[dict]:
    """The points of one section of Table 1 at horizon ``T``; ``alphas``,
    ``aggregators`` and ``workers`` cut the α sweep and the m sweep to a
    part of them (a part's points equal the whole section's)."""
    prob = problem(device) if prob is None else prob
    base = SolverConfig(m=16, T=T, eta=0.05, alpha=0.0, aggregator="mean", attack="none")
    points = []
    if name == "alpha0":
        # the guard matches the mean without an attack (one campaign)
        res = _campaign(prob, base, 0.0, ["mean", "byzantine_sgd"], device)
        points += [_point(f"table1/alpha0/{agg}", res.stats[agg], T, res.wall_s)
                   for agg in ("mean", "byzantine_sgd")]
    elif name == "alpha":
        # one campaign per α, so Krum's f and the trim fraction are sized for it
        for alpha in alphas:
            cfg = base._replace(alpha=alpha, attack="sign_flip")
            res = _campaign(prob, cfg, alpha, aggregators, device)
            points += [_point(f"table1/alpha{alpha}/{agg}", res.stats[agg], T, res.wall_s)
                       for agg in aggregators]
    elif name == "backend":
        # the guard's realizations land one T-to-ε distribution; sketch_dim
        # 8 < d, so the sketch rows carry real compression noise
        cfg = base._replace(alpha=0.25, attack="sign_flip", guard_opts=(("sketch_dim", 8),))
        res = _campaign(prob, cfg, 0.25, ["byzantine_sgd"], device, backends=BACKENDS)
        points += [_point(f"table1/backend/{key.partition('@')[2]}", res.stats[key], T,
                          res.wall_s) for key in sorted(res.stats)]
    elif name == "speedup":
        # the parallel speedup in m (Remark 1.2)
        for m in workers:
            cfg = SolverConfig(m=m, T=T, eta=0.05, alpha=0.25, aggregator="byzantine_sgd",
                               attack="sign_flip")
            res = _campaign(prob, cfg, 0.25, ["byzantine_sgd"], device)
            points.append(_point(f"table1/speedup/m{m}", res.stats["byzantine_sgd"], T,
                                 res.wall_s))
    else:
        raise ValueError(f"unknown section {name!r}; have {SECTIONS}")
    return points


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--T", type=int, default=T_PAPER, help="iterations a run (paper: 4000)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--section", action="append", choices=SECTIONS,
                    help="run only these sections (repeatable); all by default")
    args = ap.parse_args(argv)
    prob = problem(args.device)
    for name in args.section or SECTIONS:
        for point in section(name, args.T, args.device, prob=prob):
            print(json.dumps(point), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
