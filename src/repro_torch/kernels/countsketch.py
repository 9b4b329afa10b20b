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

``countsketch_cuda.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_guard import check_cuda_inputs, check_workers
from repro_torch.kernels.gradgen import MASK32

MIN_THREADS = 1 << 17  # enough outputs·chunks in flight to fill an H100
MIN_TERMS = 32        # terms per chunk before the terms are split further
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int64] + [ctypes.c_void_p] * 3
             + [ctypes.c_int64] * 6 + [ctypes.c_void_p])


def n_chunks(m: int, d: int, k: int) -> int:
    """How many chunks each output's ceil(d / k) terms are cut into: one
    when the m·k outputs alone fill the card, else enough for about
    MIN_THREADS threads with at least MIN_TERMS terms each (at most 65535,
    the grid's y limit).  A function of the shape only, so the order of
    the sums, and the bits, repeat from run to run."""
    n_terms = -(-d // k)
    want = min(-(-MIN_THREADS // (m * k)), -(-n_terms // MIN_TERMS), 65535)
    if want <= 1:
        return 1
    per = -(-n_terms // want)
    return -(-n_terms // per)


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
    s = (int(salt) * 0x9E3779B9 + 1) & MASK32
    chunks = n_chunks(m, d, k)
    out = torch.empty((m, k), dtype=torch.float32, device=dev)
    part = torch.empty((chunks, m, k) if chunks > 1 else (0,), dtype=torch.float32,
                       device=dev)
    fn = _build.load_function("countsketch", "rt_countsketch", _ARGTYPES)
    rc = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), part.data_ptr(), out.data_ptr(), m, d, k,
            chunks, s, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"countsketch: kernel launch failed with CUDA error {rc}")
    countsketch_cuda.launches += 1
    return out


countsketch_cuda.launches = 0
