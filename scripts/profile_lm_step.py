#!/usr/bin/env python3
"""Where a training step's forward and backward spend the card's time: the
trainer's per-worker gradients (``torch.func.vmap`` over W workers of
``torch.func.grad_and_value`` of the model's loss, as
``distributed.trainer.build_train_step`` takes them) for one
configuration at its published widths, under ``torch.profiler``.

    PYTHONPATH=src python3 scripts/profile_lm_step.py [--arch mamba2-130m] \\
        [--layers N] [--workers 8] [--batch 2] [--seq 256] [--top 25]

One warm call, then ``--calls`` calls timed with CUDA events and one call
traced.  Prints one JSON line: the card and its power limit, ms a call,
the launches a call, the device time summed by kernel name (the ``--top``
largest, with their calls and share), the device-busy share of the traced
call, and the allocator's peak GB.  Needs a CUDA device; weights are
``init(PRNGKey(0))``, tokens from a numpy seed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import prng  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--layers", type=int, default=0, help="depth cut (0: as published)")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_lm_step: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg, device=dev)
    params = model.init(prng.PRNGKey(0, device=dev))
    rng = np.random.default_rng(0)
    shape = (args.workers, args.batch, args.seq)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, shape).astype(np.int32)).to(dev)
             for k in ("tokens", "labels")}
    grads_fn = torch.func.vmap(torch.func.grad_and_value(model.loss_fn, has_aux=True),
                               in_dims=(None, 0))

    def call():
        grads, _ = grads_fn(params, batch)
        del grads

    call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(args.calls):
        call()
    stop.record()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / args.calls
    ms = start.elapsed_time(stop) / args.calls
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    rows, kernels, busy_us = [], 0, 0.0
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            kernels += e.count
            busy_us += dev_us
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    print(json.dumps({
        "card": card_line(), "arch": args.arch, "n_layers": cfg.n_layers,
        "workers": args.workers, "batch": args.batch, "seq": args.seq,
        "ms_per_call": ms, "host_ms_per_call": host_ms, "launches_per_call": kernels,
        "device_busy_ms": busy_us / 1e3, "busy_share": busy_us / 1e3 / ms,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "top": [{"kernel": k[:120], "ms": us / 1e3, "calls": n, "share": us / busy_us}
                for us, n, k in rows[:args.top]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
