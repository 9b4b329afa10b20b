#!/usr/bin/env python3
"""Times the guard sweep's kernels of one checkout of the PyTorch/CUDA port
on one GPU, so two checkouts can be compared in one run on one card.

    python3 scripts/time_guard_sweep.py [--root DIR] [--label NAME]

``--root`` is the root of the checkout whose kernels are built and timed
(default: this one).  At the main path's shape (m = 32, d = 2^20) it prints
one JSON line: the plain, sanitizing and generating sweeps at f32 and bf16
(sanitizing on input holding 4 non-finite rows, generating on the main
path's step-0 operands under sign_flip and ALIE), ``gen_xi`` under ALIE,
and, where the checkout's wrappers take ``moments``, ``gen_xi`` reading the
sweep's moments.  Times are ``chip_smoke.median_ms`` of that checkout:
median over 7 batches of 20 back-to-back calls, by CUDA events.  Run
checkouts in turns (A, B, B, A) and compare within one run.  Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    cs = importlib.import_module("chip_smoke")   # puts root/src on sys.path first
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_guard import (fused_guard_cuda, fused_guard_gen_cuda,
                                                 gen_xi_cuda)
    if not torch.cuda.is_available():
        print("time_guard_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    if Path(_build.__file__).resolve().parents[3] != root:
        print(f"time_guard_sweep: imported {_build.__file__}, not from {root}", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _build.build_all()
    shared = "moments" in inspect.signature(gen_xi_cuda).parameters
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"label": args.label or str(root), "card": card, "ms": {}}
    ms = out["ms"]
    gen = torch.Generator(device=dev).manual_seed(5)
    for dt in ("f32", "bf16"):
        tdt = cs.DTYPES[dt]
        g = torch.randn(cs.M, cs.D, device=dev, generator=gen, dtype=tdt)
        B = torch.randn(cs.M, cs.D, device=dev, generator=gen, dtype=tdt)
        dlt = torch.randn(cs.D, device=dev, generator=gen, dtype=tdt)
        gp = cs.poison(g.clone())
        ms[f"fused_guard[{dt}]"] = cs.median_ms(lambda: fused_guard_cuda(g, B, dlt))
        ms[f"fused_guard_sanitize[{dt}]"] = cs.median_ms(
            lambda: fused_guard_cuda(gp, B, dlt, sanitize=True))
        for attack in ("sign_flip", "alie"):
            operands, w_byz = cs.main_gen_operands(attack, dev)
            ms[f"fused_guard_gen[{dt}] {attack}"] = cs.median_ms(
                lambda: fused_guard_gen_cuda(B, dlt, *operands))
        w_xi = (operands[6] == 0).float() / cs.M
        ms[f"gen_xi[{dt}] alie"] = cs.median_ms(
            lambda: gen_xi_cuda(w_xi, w_byz, *operands, stats_dtype=tdt))
        if shared:
            mom = torch.empty((2, cs.D), device=dev)
            fused_guard_gen_cuda(B, dlt, *operands, moments=mom)
            ms[f"gen_xi[{dt}] alie, sweep's moments"] = cs.median_ms(
                lambda: gen_xi_cuda(w_xi, w_byz, *operands, stats_dtype=tdt, moments=mom))
        del g, B, dlt, gp, operands
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
