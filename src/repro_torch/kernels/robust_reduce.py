"""The filtered mean ξ: the wrapper of the CUDA kernel
``csrc/filtered_mean.cu``, which replaces the JAX package's
``filtered_mean_pallas`` (``sanitize=False``).

``filtered_mean_cuda(x, mask, denom)`` returns Σᵢ (maskᵢ/denom)·xᵢ in f32
for a CUDA tensor x of shape (m, d), f32 or bf16.  The plain version is
:func:`repro_torch.kernels.ref.filtered_mean_ref`.  The coordinate median
and trimmed mean of the JAX module are not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_guard import check_cuda_inputs

MAX_WORKERS = 12288   # the weights fit in 48 KB of shared memory
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_void_p]


def filtered_mean_cuda(x: torch.Tensor, mask: torch.Tensor, denom: float) -> torch.Tensor:
    """Launch the filtered-mean kernel; raises on anything it does not take."""
    dev = check_cuda_inputs("filtered_mean", {"x": x}, tuple(_DTYPE_CODES))
    if x.dim() != 2 or mask.shape != x.shape[:1]:
        raise ValueError(f"filtered_mean: shapes x {tuple(x.shape)}, "
                         f"mask {tuple(mask.shape)}")
    m, d = x.shape
    if not 1 <= m <= MAX_WORKERS or d < 1:
        raise ValueError(f"filtered_mean: needs 1 <= m <= {MAX_WORKERS} and "
                         f"d >= 1, got m={m}, d={d}")
    if mask.device != dev:
        raise ValueError(f"filtered_mean: mask on {mask.device}, x on {dev}")
    w = mask.to(torch.float32).contiguous()
    out = torch.empty((d,), dtype=torch.float32, device=dev)
    fn = _build.load_function("filtered_mean", "rt_filtered_mean", _ARGTYPES)
    rc = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(), float(denom),
            out.data_ptr(), m, d, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"filtered_mean: kernel launch failed with CUDA error {rc}")
    filtered_mean_cuda.launches += 1
    return out


filtered_mean_cuda.launches = 0
