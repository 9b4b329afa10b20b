"""Builds the port's CUDA kernels on first use and loads them with ctypes.

Every ``csrc/*.cu`` compiles with its own ``nvcc`` process (all started
together) into a shared library with a plain C interface, under
``build/repro_torch_kernels/`` at the root of the checkout.  A library's
file name carries a hash of its source, of the shared headers and of the
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built at import time.

The flags target ``sm_90a`` (Hopper).  ``--use_fast_math`` is left out on
purpose: it flushes denormals and would move results away from the plain
versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``; raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path(src: Path) -> Path:
    h = hashlib.sha256()
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all running at once; returns ``{stem: library path}``.  The compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) is kept
    beside each library as ``<library>.log``.  Waits for every compile,
    then raises if any failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for src in sources():
        so = library_path(src)
        if not so.exists():
            tmp = so.with_name(f"{so.name}.tmp-{os.getpid()}")
            running.append((src, so, tmp, subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, so, tmp, proc in running:
        out, _ = proc.communicate()
        so.with_name(so.name + ".log").write_text(out)
        if proc.returncode == 0:
            os.replace(tmp, so)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {src.name} (exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return {src.stem: library_path(src) for src in sources()}


def build_log(stem: str) -> str:
    """The compiler output kept for ``csrc/<stem>.cu`` (after a build)."""
    so = library_path(CSRC / f"{stem}.cu")
    log = so.with_name(so.name + ".log")
    return log.read_text() if log.exists() else ""


def ptxas_report(stem: str) -> dict[str, dict[str, int]]:
    """Per kernel (entry function, by mangled name) of ``csrc/<stem>.cu``,
    from the kept ``-Xptxas -v`` output: its ``registers`` and its bytes of
    ``stack`` frame, ``spill_stores`` and ``spill_loads``."""
    report: dict[str, dict[str, int]] = {}
    entry = props = None
    for line in build_log(stem).splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = m.group(1)
            report[entry] = {}
        elif m := re.search(r"Function properties for (\S+)", line):
            props = m.group(1)
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            if props in report:
                report[props].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                     spill_loads=int(m.group(3)))
        elif (m := re.search(r"Used (\d+) registers", line)) and entry in report:
            report[entry]["registers"] = int(m.group(1))
    return report


def load_function(stem: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of ``csrc/<stem>.cu``, built if needed,
    with its argument types declared and an ``int`` (CUDA error) result."""
    key = (stem, symbol)
    if key not in _FUNCS:
        lib = ctypes.CDLL(str(build_all()[stem]))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[key] = fn
    return _FUNCS[key]
