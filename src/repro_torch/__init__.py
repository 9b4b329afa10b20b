"""repro_torch — the PyTorch/CUDA port of :mod:`repro` for NVIDIA Hopper.

Subpackages mirror the JAX package by name (``core``, ``kernels``,
``data``), so every ported module has a counterpart under the same path.
The port imports ``torch`` and ``numpy`` only; it never imports ``jax`` or
``repro``.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.  There is no silent fallback: asking for CUDA on a
machine without a GPU raises.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if CUDA is asked for
    and no GPU is visible (the port never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run the plain versions")
    return dev
