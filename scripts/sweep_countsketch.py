#!/usr/bin/env python3
"""Times variants of the CountSketch kernel (``csrc/countsketch.cu``) at the
main path's shape (m = 32, d = 2^20, k = 4096, f32 and bf16) on one GPU.

    python3 scripts/sweep_countsketch.py

Source variants are copies of the checkout's ``csrc/countsketch.cu`` with
one constant edited: ``R`` (rows a block sums) and ``UNROLL`` (terms a
group loads, two groups in turn), built with the port's ``nvcc`` flags
into ``build/sweep_countsketch/``.  Each runs under ``launch_plan``'s plan
(rows set to its ``R``) and with 4 warps a block in place of 8.  One JSON
line per (dtype, source variant, warps): ``ms`` (``chip_smoke.median_ms``
over direct launches through the variant's ``rt_countsketch``),
``card_ms`` (``torch.profiler``, only the ``countsketch`` kernels; null
unless the trace holds all 20 launches), ``max_abs_vs_plain``; first one
line a variant with its ``-Xptxas -v`` registers and spills.  A
development tool: the port runs the checkout's source as it is.  Imports
nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (puts ROOT/src on sys.path)
import torch  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import countsketch as ck  # noqa: E402

ROWS = "constexpr int R = 4;"
UNROLL = "constexpr int UNROLL = VEC ? 2 : 1;"
# label: (text edits of the source, rows of the plan)
VARIANTS = {
    "R4 U2": ([], 4),
    "R4 U1": ([(UNROLL, UNROLL.replace("? 2", "? 1"))], 4),
    "R4 U4": ([(UNROLL, UNROLL.replace("? 2", "? 4"))], 4),
    "R2 U2": ([(ROWS, ROWS.replace("4", "2"))], 2),
    "R2 U4": ([(ROWS, ROWS.replace("4", "2")), (UNROLL, UNROLL.replace("? 2", "? 4"))], 2),
}


def build() -> dict:
    """One library a variant, all ``nvcc`` at once; prints their reports."""
    out = ROOT / "build" / "sweep_countsketch"
    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "countsketch.cu").read_text()
    procs = {}
    for label, (edits, _) in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{label}: {old!r} is not in csrc/countsketch.cu")
            src = src.replace(old, new)
        name = label.replace(" ", "_")
        (out / f"{name}.cu").write_text(src)
        procs[label] = (out / f"{name}.so", subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {label}:\n{log}")
        print(json.dumps({"variant": label, "ptxas": [
            ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]}))
        fn = ctypes.CDLL(str(so)).rt_countsketch
        fn.argtypes, fn.restype = ck._ARGTYPES, ctypes.c_int
        libs[label] = fn
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_countsketch: no CUDA device is available", file=sys.stderr)
        return 1
    libs = build()
    dev = torch.device("cuda", 0)
    k = cs.SKETCH_K
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty(cs.M, k, device=dev)
    for code, dt in enumerate(("f32", "bf16")):
        gen = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn(cs.M, cs.D, device=dev, generator=gen, dtype=cs.DTYPES[dt])
        want = ref.countsketch_ref(x, k)
        base = ck.launch_plan(cs.M, cs.D, k, x.dtype, x.data_ptr() % 16 == 0)
        for label, fn in libs.items():
            for warps in (8, 4):
                p = base._replace(rows=VARIANTS[label][1], warps=warps,
                                  warp_terms=-(-base.chunk_terms // warps))

                def launch(p=p, fn=fn):
                    rc = fn(code, x.data_ptr(), out.data_ptr(), out.data_ptr(), cs.M, cs.D, k, 1,
                            p.vec, p.wide, p.rows, p.warps, p.lanes, p.chunks, p.chunk_terms,
                            p.warp_terms, dev.index, stream)
                    if rc != 0:
                        raise RuntimeError(f"{label}: CUDA error {rc}")
                launch()
                torch.cuda.synchronize()
                err = float((out.double() - want.double()).abs().max())
                t = cs.traced_launches(launch, only="countsketch")
                print(json.dumps({"dtype": dt, "variant": label, "warps": warps,
                                  "ms": cs.median_ms(launch),
                                  "card_ms": t["kernel_ms"] if t["every_launch_traced"] else None,
                                  "max_abs_vs_plain": err}), flush=True)
        del x, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
