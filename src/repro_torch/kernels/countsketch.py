"""The strided-fold CountSketch: the wrapper of the CUDA kernel
``csrc/countsketch.cu``, which replaces the JAX package's
``countsketch_pallas``.

``countsketch_cuda(x, k, salt=0)`` maps a CUDA tensor x of shape (m, d),
f32 or bf16, to its (m, k) f32 sketch: bucket ``i mod k`` with the hashed
±1 sign of coordinate i under ``salt``.  The dp_sketch guard sketches each
worker's centred gradient with it (:func:`repro_torch.distributed.
byzantine_dp.sketch_tree`).  The plain version is
:func:`repro_torch.kernels.ref.countsketch_ref`; :mod:`ops` chooses between
the two by the tensor's device.  The TPU's ``d_block`` strip width has no
counterpart here: the kernel takes any d and k without padding.

How the kernel cuts the work is :func:`launch_plan`'s, a function of the
shape, the dtype and x's alignment only, so the order of the sums, and
the bits, repeat from run to run.  ``countsketch_cuda.launches`` counts
launches.  ``countsketch_runs_cuda`` takes a leading run axis (a campaign
group's runs) in one launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_guard import check_cuda_inputs, check_runs, check_workers
from repro_torch.kernels.gradgen import MASK32

ROWS = 4            # rows of x a block sums (csrc/countsketch.cu's R)
MAX_WARPS = 8       # warps a block; they split the block's terms
MIN_TERMS = 8       # terms a thread sums, at least, before the terms are split further
TARGET_WARPS = 1024  # warps in flight that fill an H100 (~8 an SM): fewer take scratch
MAX_CHUNKS = 65535  # the grid's z limit
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int64] + [ctypes.c_void_p] * 3
             + [ctypes.c_int64] * 13 + [ctypes.c_void_p])


class SketchPlan(NamedTuple):
    """How ``rt_countsketch`` cuts one call (see ``csrc/countsketch.cu``)."""
    vec: bool          # one 16-byte load of V buckets a row and term, else V scalar loads
    v: int             # adjacent buckets a thread owns: 16 bytes of x's dtype
    rows: int          # R: rows of x a block sums
    warps: int         # W: warps of a block, each a run of warp_terms of its terms
    lanes: int         # LB: a warp's lanes on bucket vectors; the 32 // LB others on terms
    chunks: int        # S: slices of the terms; S > 1 sums S partial sketches from scratch
    chunk_terms: int   # jc: terms of a chunk (the last may hold fewer)
    warp_terms: int    # jw: terms of a warp's run (the last may hold fewer)
    wide: bool         # 64-bit offsets inside a row (d + k > 2^32), else 32-bit


@functools.lru_cache(maxsize=256)
def launch_plan(m: int, d: int, k: int, dtype: torch.dtype, aligned: bool) -> SketchPlan:
    """The kernel's tiling for x of shape (m, d) and ``dtype`` (f32 or
    bf16) into k buckets; ``aligned``: x starts on a 16-byte boundary.

    A block takes ``lanes``·v buckets × ``rows`` rows; its warps split the
    terms into runs of at least 32 // lanes · MIN_TERMS; when the blocks'
    warps fall short of TARGET_WARPS, the terms are cut into chunks too.
    The vector path needs k % v == 0 and d·itemsize % 16 == 0 (each term's v
    buckets one aligned vector) and ``aligned``.  Pure, so kept per shape."""
    size = dtype.itemsize
    v = 16 // size
    vec = bool(aligned) and k % v == 0 and (d * size) % 16 == 0
    n_terms = -(-d // k)
    vectors = -(-k // v)
    lanes = min(32, 1 << (vectors - 1).bit_length())
    per_warp = 32 // lanes * MIN_TERMS
    warps = max(1, min(MAX_WARPS, n_terms // per_warp))
    blocks = -(-vectors // lanes) * -(-m // ROWS)
    chunks = max(1, min(-(-TARGET_WARPS // (blocks * warps)), n_terms // (warps * per_warp),
                        MAX_CHUNKS))
    chunk_terms = -(-n_terms // chunks)
    return SketchPlan(vec=vec, v=v, rows=ROWS, warps=warps, lanes=lanes,
                      chunks=-(-n_terms // chunk_terms), chunk_terms=chunk_terms,
                      warp_terms=-(-chunk_terms // warps), wide=d + k > 1 << 32)


def run_plan(x: torch.Tensor, k: int, salt: int, plan: SketchPlan, out: torch.Tensor,
             part: torch.Tensor | None = None) -> None:
    """One launch of ``rt_countsketch`` by ``plan`` into ``out`` ((m, k)
    f32), with ``part`` as scratch of ``plan.chunks``·m·k floats when
    ``plan.chunks > 1`` (unused otherwise); raises if the launch fails.
    Checks nothing else: :func:`countsketch_cuda` is the entry point."""
    m, d = x.shape
    s = (int(salt) * 0x9E3779B9 + 1) & MASK32
    fn = _build.load_function("countsketch", "rt_countsketch", _ARGTYPES)
    rc = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), None if part is None else part.data_ptr(),
            out.data_ptr(), m, d, k, s,
            plan.vec, plan.wide, plan.rows, plan.warps, plan.lanes, plan.chunks,
            plan.chunk_terms, plan.warp_terms, x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"countsketch: kernel launch failed with CUDA error {rc}")


def countsketch_cuda(x: torch.Tensor, k: int, salt: int = 0) -> torch.Tensor:
    """Launch the CountSketch kernel; raises on anything it does not take."""
    dev = check_cuda_inputs("countsketch", {"x": x}, tuple(_DTYPE_CODES))
    if x.dim() != 2:
        raise ValueError(f"countsketch: expected an (m, d) tensor, got shape {tuple(x.shape)}")
    m, d = x.shape
    k = int(k)
    check_workers("countsketch", m)
    if d < 1 or k < 1:
        raise ValueError(f"countsketch: needs d >= 1 and k >= 1, got d={d}, k={k}")
    plan = launch_plan(m, d, k, x.dtype, x.data_ptr() % 16 == 0)
    out = torch.empty((m, k), dtype=torch.float32, device=dev)
    part = (torch.empty((plan.chunks, m, k), dtype=torch.float32, device=dev)
            if plan.chunks > 1 else None)
    run_plan(x, k, salt, plan, out, part)
    countsketch_cuda.launches += 1
    return out


countsketch_cuda.launches = 0


def countsketch_runs_cuda(x: torch.Tensor, k: int, salt: int = 0) -> torch.Tensor:
    """:func:`countsketch_cuda` over a leading run axis, in one launch: x
    (R, m, d) → (R, m, k).  The runs fold into R·m rows (each row's sketch
    is its own) under the plan of one run, so each row's sums take the
    order, and the bits, of ``countsketch_cuda(x[r])``.  Counts one launch."""
    dev = check_cuda_inputs("countsketch", {"x": x}, tuple(_DTYPE_CODES))
    R = check_runs("countsketch", x, {})
    _, m, d = x.shape
    k = int(k)
    check_workers("countsketch", m)
    if d < 1 or k < 1:
        raise ValueError(f"countsketch: needs d >= 1 and k >= 1, got d={d}, k={k}")
    if -(-R * m // ROWS) > MAX_CHUNKS:
        raise ValueError(f"countsketch: {R} runs of {m} rows pass the grid's "
                         f"{ROWS * MAX_CHUNKS} rows")
    rows = x.reshape(R * m, d)
    plan = launch_plan(m, d, k, x.dtype, x.data_ptr() % 16 == 0)
    out = torch.empty((R * m, k), dtype=torch.float32, device=dev)
    part = (torch.empty((plan.chunks, R * m, k), dtype=torch.float32, device=dev)
            if plan.chunks > 1 else None)
    run_plan(rows, k, salt, plan, out, part)
    countsketch_cuda.launches += 1
    return out.view(R, m, k)
