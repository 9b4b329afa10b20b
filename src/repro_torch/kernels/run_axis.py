"""The kernels under ``torch.func.vmap``: one launch for a group of runs.

A campaign (:mod:`repro_torch.scenarios.campaign`) maps the single-run
``run_sgd`` over a group of runs with ``torch.func.vmap``, as the JAX
package maps it with ``jax.vmap``; under ``vmap`` each Pallas call gains a
grid axis over the runs, and this module gives each CUDA kernel the same.
Every kernel of :mod:`ops` is a ``torch.library.custom_op`` here whose
vmap rule stacks the operands along a leading run axis R (an operand the
runs share is expanded) and calls the wrapper's ``*_runs_cuda`` form: one
launch for the R runs, counted once in the wrapper's ``launches``.

* ``fused_guard``, ``filtered_mean`` (plain and sanitizing) and ``gram``
  launch their kernels' own run axis; run r's outputs are the bits of its
  own launch;
* ``coordinate_median`` and ``trimmed_mean`` run over the (m, R·d)
  columns of one copy, ``countsketch`` over R·m rows.

:mod:`ops` calls these ops only for a CUDA tensor under ``vmap``, so the
single-run path launches as before; a CPU tensor runs the plain versions,
which ``vmap`` batches by itself.  There is no other route: a CUDA tensor
under ``vmap`` reaches a batched launch or raises, never a loop of R
launches and never a plain version.  The generating kernels have no run
axis yet (a campaign's ``gen`` variant raises).
"""
from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.kernels.countsketch import countsketch_cuda, countsketch_runs_cuda
from repro_torch.kernels.fused_guard import fused_guard_cuda, fused_guard_runs_cuda
from repro_torch.kernels.pairdist import gram_cuda, gram_runs_cuda
from repro_torch.kernels.robust_reduce import (
    coordinate_median_cuda,
    coordinate_median_runs_cuda,
    filtered_mean_cuda,
    filtered_mean_runs_cuda,
    trimmed_mean_cuda,
    trimmed_mean_runs_cuda,
)


def under_vmap(*tensors) -> bool:
    """True when any of ``tensors`` is batched by ``torch.func.vmap``."""
    return any(isinstance(t, Tensor) and torch._C._functorch.is_batchedtensor(t)
               for t in tensors)


def _stacked(info, in_dims, *tensors) -> list[Tensor]:
    """Each operand with the run axis first and contiguous; an operand the
    runs share (in_dim None) is repeated R times."""
    out = []
    for t, dim in zip(tensors, in_dims):
        t = t.expand(info.batch_size, *t.shape) if dim is None else t.movedim(dim, 0)
        out.append(t.contiguous())
    return out


@torch.library.custom_op("repro_torch::fused_guard", mutates_args=())
def fused_guard(grads: Tensor, B: Tensor, delta: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    return fused_guard_cuda(grads, B, delta)


@fused_guard.register_vmap
def _(info, in_dims, grads, B, delta):
    return fused_guard_runs_cuda(*_stacked(info, in_dims, grads, B, delta)), (0, 0, 0, 0)


@torch.library.custom_op("repro_torch::fused_guard_sanitize", mutates_args=())
def fused_guard_sanitize(grads: Tensor, B: Tensor,
                         delta: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    return fused_guard_cuda(grads, B, delta, sanitize=True)


@fused_guard_sanitize.register_vmap
def _(info, in_dims, grads, B, delta):
    return (fused_guard_runs_cuda(*_stacked(info, in_dims, grads, B, delta), sanitize=True),
            (0, 0, 0, 0, 0))


@torch.library.custom_op("repro_torch::filtered_mean", mutates_args=())
def filtered_mean(x: Tensor, mask: Tensor, denom: float, sanitize: bool) -> Tensor:
    return filtered_mean_cuda(x, mask, denom, sanitize=sanitize)


@filtered_mean.register_vmap
def _(info, in_dims, x, mask, denom, sanitize):
    x, mask = _stacked(info, in_dims[:2], x, mask)
    return filtered_mean_runs_cuda(x, mask, denom, sanitize=sanitize), 0


@torch.library.custom_op("repro_torch::gram", mutates_args=())
def gram(x: Tensor) -> Tensor:
    return gram_cuda(x)


@gram.register_vmap
def _(info, in_dims, x):
    return gram_runs_cuda(*_stacked(info, in_dims, x)), 0


@torch.library.custom_op("repro_torch::coordinate_median", mutates_args=())
def coordinate_median(x: Tensor) -> Tensor:
    return coordinate_median_cuda(x)


@coordinate_median.register_vmap
def _(info, in_dims, x):
    return coordinate_median_runs_cuda(*_stacked(info, in_dims, x)), 0


@torch.library.custom_op("repro_torch::trimmed_mean", mutates_args=())
def trimmed_mean(x: Tensor, n_trim: int) -> Tensor:
    return trimmed_mean_cuda(x, n_trim)


@trimmed_mean.register_vmap
def _(info, in_dims, x, n_trim):
    return trimmed_mean_runs_cuda(*_stacked(info, in_dims[:1], x), n_trim), 0


@torch.library.custom_op("repro_torch::countsketch", mutates_args=())
def countsketch(x: Tensor, k: int, salt: int) -> Tensor:
    return countsketch_cuda(x, k, salt)


@countsketch.register_vmap
def _(info, in_dims, x, k, salt):
    return countsketch_runs_cuda(*_stacked(info, in_dims[:1], x), k, salt), 0
