"""The worker Gram matrix: the wrapper of the CUDA kernel ``csrc/gram.cu``,
which replaces the JAX package's ``gram_pallas``.

``gram_cuda(x)`` returns X Xᵀ in f32 for a CUDA tensor x of shape (m, d),
f32 or bf16.  Krum, multi-Krum and the medoid take their pairwise distances
from it.  The plain version is :func:`repro_torch.kernels.ref.gram_ref`;
:mod:`ops` chooses between the two by the tensor's device.  The TPU's
``d_block`` strip width has no counterpart here: the kernel takes any d
without padding.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_guard import check_cuda_inputs, check_workers, d_splits

_TILE = 32
_TILE_BYTES = 512   # bytes of a row per d-tile: 128 f32 or 256 bf16 columns
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int64] + [ctypes.c_void_p] * 3
             + [ctypes.c_int64] * 4 + [ctypes.c_void_p])


def gram_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the Gram kernel; raises on anything it does not take."""
    dev = check_cuda_inputs("gram", {"x": x}, tuple(_DTYPE_CODES))
    if x.dim() != 2:
        raise ValueError(f"gram: expected an (m, d) tensor, got shape {tuple(x.shape)}")
    m, d = x.shape
    check_workers("gram", m)
    if d < 1:
        raise ValueError(f"gram: needs d >= 1, got d={d}")
    nt = -(-m // _TILE)
    mp = _TILE * nt
    # only the worker-tile pairs ti <= tj run (G is symmetric)
    nb = d_splits(-(-d // (_TILE_BYTES // x.element_size())), nt * (nt + 1) // 2, dev)
    part = torch.empty((nb, mp, mp), dtype=torch.float32, device=dev)
    out = torch.empty((m, m), dtype=torch.float32, device=dev)
    fn = _build.load_function("gram", "rt_gram", _ARGTYPES)
    rc = fn(_DTYPE_CODES[x.dtype], x.data_ptr(), part.data_ptr(), out.data_ptr(),
            m, d, nb, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gram: kernel launch failed with CUDA error {rc}")
    gram_cuda.launches += 1
    return out


gram_cuda.launches = 0
