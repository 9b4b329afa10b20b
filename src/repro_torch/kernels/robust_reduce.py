"""Coordinate-wise reductions over the worker axis: the wrappers of the CUDA
kernels that replace the JAX package's ``robust_reduce`` Pallas kernels.

* ``filtered_mean_cuda(x, mask, denom, sanitize=False)`` — Σᵢ
  (maskᵢ/denom)·xᵢ, the guard's ξ (``csrc/filtered_mean.cu``, replacing
  ``filtered_mean_pallas``); ``sanitize=True`` launches the variant that
  zeroes NaN/Inf entries of x first, since a zero weight alone leaves
  0·Inf = NaN (counted apart, in ``filtered_mean_cuda.launches_sanitize``);
* ``coordinate_median_cuda(x)`` — each column's median, the mean of the two
  middle values for even m (``csrc/sorted_reduce.cu``, replacing
  ``coordinate_median_pallas``): Yin et al.'s Median-GD;
* ``trimmed_mean_cuda(x, n_trim)`` — the mean of each column's sorted
  values n_trim .. m−n_trim−1 (``csrc/sorted_reduce.cu``, replacing
  ``trimmed_mean_pallas``): trimmed-mean-GD.

Each maps a CUDA tensor x of shape (m, d), f32 or bf16, to a (d,) f32
tensor.  The plain versions are in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_guard import check_cuda_inputs, check_workers

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_void_p]
_MEDIAN_ARGTYPES = ([ctypes.c_int64] + [ctypes.c_void_p] * 2
                    + [ctypes.c_int64] * 3 + [ctypes.c_void_p])
_TRIM_ARGTYPES = ([ctypes.c_int64] + [ctypes.c_void_p] * 2
                  + [ctypes.c_int64] * 4 + [ctypes.c_void_p])


def filtered_mean_cuda(x: torch.Tensor, mask: torch.Tensor, denom: float,
                       sanitize: bool = False) -> torch.Tensor:
    """Launch the filtered-mean kernel (its sanitizing variant when
    ``sanitize``); raises on anything it does not take."""
    dev = check_cuda_inputs("filtered_mean", {"x": x}, tuple(_DTYPE_CODES))
    if x.dim() != 2 or mask.shape != x.shape[:1]:
        raise ValueError(f"filtered_mean: shapes x {tuple(x.shape)}, "
                         f"mask {tuple(mask.shape)}")
    m, d = x.shape
    check_workers("filtered_mean", m)
    if d < 1:
        raise ValueError(f"filtered_mean: needs d >= 1, got d={d}")
    if mask.device != dev:
        raise ValueError(f"filtered_mean: mask on {mask.device}, x on {dev}")
    w = mask.to(torch.float32).contiguous()
    out = torch.empty((d,), dtype=torch.float32, device=dev)
    symbol = "rt_filtered_mean_sanitize" if sanitize else "rt_filtered_mean"
    fn = _build.load_function("filtered_mean", symbol, _ARGTYPES)
    rc = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(), float(denom),
            out.data_ptr(), m, d, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"filtered_mean: kernel launch failed with CUDA error {rc}")
    if sanitize:
        filtered_mean_cuda.launches_sanitize += 1
    else:
        filtered_mean_cuda.launches += 1
    return out


filtered_mean_cuda.launches = 0
filtered_mean_cuda.launches_sanitize = 0


def _check_sort_input(name: str, x: torch.Tensor) -> torch.device:
    dev = check_cuda_inputs(name, {"x": x}, tuple(_DTYPE_CODES))
    if x.dim() != 2:
        raise ValueError(f"{name}: expected an (m, d) tensor, got shape {tuple(x.shape)}")
    m, d = x.shape
    check_workers(name, m)
    if d < 1:
        raise ValueError(f"{name}: needs d >= 1, got d={d}")
    return dev


def coordinate_median_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the coordinate-median kernel; raises on anything it does not take."""
    dev = _check_sort_input("coordinate_median", x)
    m, d = x.shape
    out = torch.empty((d,), dtype=torch.float32, device=dev)
    fn = _build.load_function("sorted_reduce", "rt_coordinate_median", _MEDIAN_ARGTYPES)
    rc = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(), m, d, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"coordinate_median: kernel launch failed with CUDA error {rc}")
    coordinate_median_cuda.launches += 1
    return out


coordinate_median_cuda.launches = 0


def trimmed_mean_cuda(x: torch.Tensor, n_trim: int) -> torch.Tensor:
    """Launch the trimmed-mean kernel; raises on anything it does not take,
    and when ``2·n_trim >= m`` (nothing would be left)."""
    dev = _check_sort_input("trimmed_mean", x)
    m, d = x.shape
    n_trim = int(n_trim)
    if not 0 <= 2 * n_trim < m:
        raise ValueError(f"trimmed_mean: n_trim={n_trim} trims everything for m={m}")
    out = torch.empty((d,), dtype=torch.float32, device=dev)
    fn = _build.load_function("sorted_reduce", "rt_trimmed_mean", _TRIM_ARGTYPES)
    rc = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(), m, d, n_trim, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"trimmed_mean: kernel launch failed with CUDA error {rc}")
    trimmed_mean_cuda.launches += 1
    return out


trimmed_mean_cuda.launches = 0
