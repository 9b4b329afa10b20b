#!/usr/bin/env python3
"""Times the guard sweep's, the order statistics', the CountSketch's or
the filtered mean's and Gram's kernels of one checkout of the
PyTorch/CUDA port on one GPU, so two
checkouts can be compared in one run on one card.

    python3 scripts/time_guard_sweep.py [--root DIR] [--label NAME]
                                        [--kernels guard_sweep|order_stats|countsketch|reduce]

``--root`` is the root of the checkout whose kernels are built and timed
(default: this one).  At the main path's shape (m = 32, d = 2^20) it prints
one JSON line.  Times are ``chip_smoke.median_ms`` of that checkout: median
over 7 batches of 20 back-to-back calls, by CUDA events.

``--kernels guard_sweep`` (the default): the plain, sanitizing and
generating sweeps at f32 and bf16 (sanitizing on input holding 4
non-finite rows, generating on the main path's step-0 operands under
sign_flip and ALIE), ``gen_xi`` under ALIE, and, where the checkout's
wrappers take ``moments``, ``gen_xi`` reading the sweep's moments.

``--kernels order_stats``: ``coordinate_median`` and ``trimmed_mean``
(n_trim = 8) at f32 and bf16, as ``ms`` (the kernel launched through the
checkout's C entry point into a preallocated output), ``wrapper_ms`` (the
same through the Python wrapper, as ``chip_smoke.py``'s kernels line times
it) and, where the checkout's ``chip_smoke.kernel_and_host_ms`` takes
``only``, ``card_ms``: the card's time a launch in the ``sorted_mean``
kernels from a ``torch.profiler`` trace of 20 wrapper calls, with
``traced_launches`` (the launches in that trace; 20 when none went
unrecorded, else ``card_ms`` is null).

``--kernels countsketch``: ``countsketch`` at f32 and bf16 into k = 4096
buckets (``chip_smoke.SKETCH_K``), salt 0, as ``ms`` (the kernel launched
through the checkout's C entry point into a preallocated sketch: by its
launch plan, ``kernels.countsketch.run_plan``, where the checkout has one,
else with ``n_chunks``) and ``card_ms``: the card's time a launch in the
``countsketch`` kernels from a ``torch.profiler`` trace of 20 such
launches, with ``traced_launches`` (20 when none went unrecorded, else
``card_ms`` is null); ``plan`` is the launch plan where there is one.

``--kernels reduce``: ``filtered_mean`` (plain and sanitizing, on input
holding 4 non-finite rows) and ``gram`` at f32 and bf16, each through its
Python wrapper (one run, as ``chip_smoke.py``'s kernels line times it).

Run checkouts in turns (A, B, B, A) and compare within one run.  Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import inspect
import json
import subprocess
import sys
from pathlib import Path


def guard_sweep_ms(cs, dev, out: dict) -> None:
    import torch
    from repro_torch.kernels.fused_guard import (fused_guard_cuda, fused_guard_gen_cuda,
                                                 gen_xi_cuda)
    shared = "moments" in inspect.signature(gen_xi_cuda).parameters
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


def order_stats_ms(cs, dev, out: dict) -> None:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.robust_reduce import coordinate_median_cuda, trimmed_mean_cuda
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    entry = {"coordinate_median": _build.load_function(
                 "sorted_reduce", "rt_coordinate_median", [i64, ptr, ptr, i64, i64, i64, ptr]),
             "trimmed_mean": _build.load_function(
                 "sorted_reduce", "rt_trimmed_mean", [i64, ptr, ptr, i64, i64, i64, i64, ptr])}
    traced = "only" in inspect.signature(cs.kernel_and_host_ms).parameters
    out.update(n_trim=cs.N_TRIM, wrapper_ms={}, card_ms={}, traced_launches={})
    gen = torch.Generator(device=dev).manual_seed(5)
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = torch.empty(cs.D, dtype=torch.float32, device=dev)
    for code, dt in enumerate(("f32", "bf16")):
        x = torch.randn(cs.M, cs.D, device=dev, generator=gen, dtype=cs.DTYPES[dt])
        wrappers = {"coordinate_median": lambda: coordinate_median_cuda(x),
                    "trimmed_mean": lambda: trimmed_mean_cuda(x, cs.N_TRIM)}
        for name, fn in entry.items():
            key = f"{name}[{dt}]"
            extra = () if name == "coordinate_median" else (cs.N_TRIM,)

            def launch(fn=fn, extra=extra):
                rc = fn(code, x.data_ptr(), res.data_ptr(), cs.M, cs.D, *extra, dev.index,
                        stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA error {rc}")
            out["ms"][key] = cs.median_ms(launch)
            out["wrapper_ms"][key] = cs.median_ms(wrappers[name])
            if traced:
                t = cs.traced_launches(wrappers[name], only="sorted_mean")
                out["card_ms"][key] = t["kernel_ms"] if t["every_launch_traced"] else None
                out["traced_launches"][key] = sum(t["kernels"].values())
        del x
        torch.cuda.empty_cache()


def countsketch_ms(cs, dev, out: dict) -> None:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import countsketch as ck
    out.update(k=cs.SKETCH_K, card_ms={}, traced_launches={}, plan={})
    gen = torch.Generator(device=dev).manual_seed(5)
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = torch.empty((cs.M, cs.SKETCH_K), dtype=torch.float32, device=dev)
    for code, dt in enumerate(("f32", "bf16")):
        key = f"countsketch[{dt}]"
        x = torch.randn(cs.M, cs.D, device=dev, generator=gen, dtype=cs.DTYPES[dt])
        if hasattr(ck, "launch_plan"):
            plan = ck.launch_plan(cs.M, cs.D, cs.SKETCH_K, x.dtype, x.data_ptr() % 16 == 0)
            out["plan"][key] = plan._asdict()
            part = (torch.empty((plan.chunks, cs.M, cs.SKETCH_K), device=dev)
                    if plan.chunks > 1 else None)

            def launch(plan=plan, part=part, x=x):
                ck.run_plan(x, cs.SKETCH_K, 0, plan, res, part)
        else:   # a checkout from before the launch plan: rt_countsketch takes n_chunks
            chunks = ck.n_chunks(cs.M, cs.D, cs.SKETCH_K)
            part = torch.empty((chunks, cs.M, cs.SKETCH_K) if chunks > 1 else (0,), device=dev)
            fn = _build.load_function("countsketch", "rt_countsketch", ck._ARGTYPES)

            def launch(chunks=chunks, part=part, x=x, code=code):
                rc = fn(code, x.data_ptr(), part.data_ptr(), res.data_ptr(), cs.M, cs.D,
                        cs.SKETCH_K, chunks, 1, dev.index, stream)
                if rc != 0:
                    raise RuntimeError(f"countsketch: CUDA error {rc}")
        out["ms"][key] = cs.median_ms(launch)
        t = cs.traced_launches(launch, only="countsketch")
        out["card_ms"][key] = t["kernel_ms"] if t["every_launch_traced"] else None
        out["traced_launches"][key] = sum(t["kernels"].values())
        del x, part
        torch.cuda.empty_cache()


def reduce_ms(cs, dev, out: dict) -> None:
    import torch
    from repro_torch.kernels.pairdist import gram_cuda
    from repro_torch.kernels.robust_reduce import filtered_mean_cuda
    gen = torch.Generator(device=dev).manual_seed(5)
    for dt in ("f32", "bf16"):
        x = torch.randn(cs.M, cs.D, device=dev, generator=gen, dtype=cs.DTYPES[dt])
        xp = cs.poison(x.clone())
        w = torch.rand(cs.M, device=dev, generator=gen) / cs.M
        out["ms"][f"filtered_mean[{dt}]"] = cs.median_ms(lambda: filtered_mean_cuda(x, w, 1.0))
        out["ms"][f"filtered_mean_sanitize[{dt}]"] = cs.median_ms(
            lambda: filtered_mean_cuda(xp, w, 1.0, sanitize=True))
        out["ms"][f"gram[{dt}]"] = cs.median_ms(lambda: gram_cuda(x))
        del x, xp
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default=None)
    ap.add_argument("--kernels", choices=tuple(TIMERS), default="guard_sweep")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    cs = importlib.import_module("chip_smoke")   # puts root/src on sys.path first
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("time_guard_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    if Path(_build.__file__).resolve().parents[3] != root:
        print(f"time_guard_sweep: imported {_build.__file__}, not from {root}", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"label": args.label or str(root), "card": card, "kernels": args.kernels,
           "m": cs.M, "d": cs.D, "ms": {}}
    TIMERS[args.kernels](cs, dev, out)
    print(json.dumps(out), flush=True)
    return 0


TIMERS = {"guard_sweep": guard_sweep_ms, "order_stats": order_stats_ms,
          "countsketch": countsketch_ms, "reduce": reduce_ms}


if __name__ == "__main__":
    sys.exit(main())
