#!/usr/bin/env python3
"""How often a ``torch.profiler`` trace of 20 launches holds all 20, with
and without a margin around the traced calls.

    python3 scripts/probe_trace_window.py [--rounds 20]

Traces bf16 ``trimmed_mean_cuda`` and ``coordinate_median_cuda`` at the
main path's shape (m = 32, d = 2^20) with ``chip_smoke.kernel_and_host_ms``,
in turns with ``margin_s`` = 0 (the window closing right after the
synchronisation) and ``chip_smoke.TRACE_MARGIN_S``, ``--rounds`` times
each.  Prints one JSON line: the card's name and power limit, and per
kernel and margin the number of traces that held every launch and the
launch count of each trace.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_trace_window: no CUDA device is available", file=sys.stderr)
        return 1
    cs = importlib.import_module("chip_smoke")   # puts the checkout's src on sys.path
    from repro_torch.kernels.robust_reduce import coordinate_median_cuda, trimmed_mean_cuda

    x = torch.randn(cs.M, cs.D, device="cuda", dtype=torch.bfloat16)
    fns = {"trimmed_mean[bf16]": lambda: trimmed_mean_cuda(x, cs.N_TRIM),
           "coordinate_median[bf16]": lambda: coordinate_median_cuda(x)}
    margins = (0.0, cs.TRACE_MARGIN_S)
    seen = {name: {m: [] for m in margins} for name in fns}
    for _ in range(args.rounds):
        for name, fn in fns.items():
            for margin in margins:
                got = cs.kernel_and_host_ms(fn, 20, only="sorted_mean", margin_s=margin)
                seen[name][margin].append(sum(got["kernels"].values()))
    out = {name: {f"margin_{m}_s": {"whole": sum(c == 20 for c in cnts), "traces": len(cnts),
                                     "launches": cnts}
                  for m, cnts in per.items()}
           for name, per in seen.items()}
    print(json.dumps({"card": cs.card_line(), "rounds": args.rounds, "traces": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
