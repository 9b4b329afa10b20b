"""One-pass guard statistics: the wrapper of the CUDA kernel
``csrc/fused_guard.cu``, which replaces the JAX package's
``fused_guard_pallas`` (``sanitize=False``).

``fused_guard_cuda(grads, B, delta)`` returns ``(gram_g, cross, a_inc,
B_new)`` = (g gᵀ, B gᵀ, g·δ, B + g) for CUDA tensors, with f32 Grams and
A-increments and ``B_new`` in ``B.dtype`` (f32 or bf16).  The plain version
is :func:`repro_torch.kernels.ref.fused_guard_ref`; :mod:`ops` chooses
between the two by the tensor's device.  The TPU's ``d_block`` strip
width has no counterpart here: the kernel takes any d without padding.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

MAX_WORKERS = 128   # four 32-row worker tiles
_TILE = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int64] + [ctypes.c_void_p] * 10
             + [ctypes.c_int64] * 4 + [ctypes.c_void_p])


def check_cuda_inputs(name: str, tensors: dict, dtypes) -> torch.device:
    """Raise unless every tensor is a contiguous CUDA tensor of one of
    ``dtypes`` on one device; returns that device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors on one device, got "
                         + ", ".join(f"{k} on {t.device}" for k, t in tensors.items()))
    for k, t in tensors.items():
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {k} has dtype {t.dtype}, expected one of {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    return next(iter(devices))


def fused_guard_cuda(grads: torch.Tensor, B: torch.Tensor, delta: torch.Tensor):
    """Launch the fused guard kernel; raises on anything it does not take."""
    dev = check_cuda_inputs("fused_guard", {"grads": grads, "B": B, "delta": delta},
                            tuple(_DTYPE_CODES))
    if grads.dim() != 2 or B.shape != grads.shape or delta.shape != grads.shape[1:]:
        raise ValueError(f"fused_guard: shapes grads {tuple(grads.shape)}, "
                         f"B {tuple(B.shape)}, delta {tuple(delta.shape)}")
    if not grads.dtype == B.dtype == delta.dtype:
        raise TypeError("fused_guard: grads, B and delta must share a dtype")
    m, d = grads.shape
    if not 1 <= m <= MAX_WORKERS or d < 1:
        raise ValueError(f"fused_guard: needs 1 <= m <= {MAX_WORKERS} and d >= 1, "
                         f"got m={m}, d={d}")
    mp = _TILE * -(-m // _TILE)
    # two blocks per SM of 64-column tiles, or fewer when d is small
    n_tiles = -(-d // 64)
    nb = min(n_tiles, 2 * torch.cuda.get_device_properties(dev).multi_processor_count)
    f32 = dict(dtype=torch.float32, device=dev)
    parts = torch.empty((2, nb, mp, mp), **f32)
    a_part = torch.empty((nb, mp), **f32)
    gram_g = torch.empty((m, m), **f32)
    cross = torch.empty((m, m), **f32)
    a_inc = torch.empty((m,), **f32)
    B_new = torch.empty_like(B)
    fn = _build.load_function("fused_guard", "rt_fused_guard", _ARGTYPES)
    rc = fn(_DTYPE_CODES[grads.dtype], grads.data_ptr(), B.data_ptr(),
            delta.data_ptr(), B_new.data_ptr(), parts[0].data_ptr(),
            parts[1].data_ptr(), a_part.data_ptr(), gram_g.data_ptr(),
            cross.data_ptr(), a_inc.data_ptr(), m, d, nb, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_guard: kernel launch failed with CUDA error {rc}")
    fused_guard_cuda.launches += 1
    return gram_g, cross, a_inc, B_new


fused_guard_cuda.launches = 0
