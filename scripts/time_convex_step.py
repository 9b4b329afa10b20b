#!/usr/bin/env python3
"""Times the convex harness's step on the card in a fresh process, before
and after one ``torch.profiler`` session in that process: does tracing
slow the launches that follow it?

    python3 scripts/time_convex_step.py [--steps 200] [--repeats 3]

The step is quickstart's (``make_quadratic_problem(d=16)``, m = 16, the
mean under sign_flip), a host-bound step of ~1100 tiny launches.  The
script times ``--repeats`` runs of ``--steps`` steps, traces 20 calls of
``filtered_mean_cuda`` at m = 32, d = 2^20 with ``torch.profiler`` (as
``chip_smoke.py``'s timing phase does), then times the same runs again.
Prints one JSON line: the card's name and power limit, and ms a step
before and after the trace.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import prng  # noqa: E402
from repro_torch.core.solver import SolverConfig, run_sgd  # noqa: E402
from repro_torch.data.problems import make_quadratic_problem  # noqa: E402
from repro_torch.kernels.robust_reduce import filtered_mean_cuda  # noqa: E402


def ms_a_step(problem, cfg) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_sgd(problem, cfg, prng.PRNGKey(0), device="cuda")
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / cfg.T


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_convex_step: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    problem = make_quadratic_problem(d=16, sigma=1.0, L=8.0, V=1.0, seed=0, device="cuda")
    cfg = SolverConfig(m=16, T=args.steps, eta=0.05, alpha=0.25, aggregator="mean",
                       attack="sign_flip")
    ms_a_step(problem, cfg._replace(T=10))   # the first run's one-time costs
    before = [ms_a_step(problem, cfg) for _ in range(args.repeats)]

    x = torch.randn(32, 2 ** 20, device="cuda")
    w = torch.full((32,), 1.0 / 32, device="cuda")
    filtered_mean_cuda(x, w, 1.0)
    kern = []
    # chip_smoke.kernel_and_host_ms's trace: a warm-up cycle, then 20 calls
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: kern.extend(
                e for e in p.events() if e.device_type == torch.autograd.DeviceType.CUDA)) as prof:
        for _ in range(2):
            for _ in range(20):
                filtered_mean_cuda(x, w, 1.0)
            torch.cuda.synchronize()
            prof.step()
    traced = sum("filtered_mean" in e.name for e in kern)
    del x, w

    after = [ms_a_step(problem, cfg) for _ in range(args.repeats)]
    print(json.dumps({"card": card, "steps": args.steps, "ms_per_step_before_trace": before,
                      "ms_per_step_after_trace": after, "kernels_traced": traced}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
