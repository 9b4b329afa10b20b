"""Pytree ⇄ flat-harness adapter (the counterpart of
:mod:`repro.core.tree_harness`, DESIGN.md §10).

Every guard backend consumes the flat ``(m, d)`` stacked view of the
workers' gradients; :class:`TreeHarness` presents per-worker gradient
pytrees as that matrix and maps the filtered mean ξ back to a
parameter-shaped update.  Three properties make it exact:

* **zero padding** — ``d`` is padded up to a multiple of ``LANE`` (128);
  padded coordinates are zero in every row, so Grams, norms and every
  filter decision are unchanged;
* **fixed leaf order** — ``jax.tree_util``'s (a dict's keys sorted), so the
  flat vector is the JAX package's bit for bit and ``unravel(ravel(t))``
  gives ``t`` back;
* **dtype discipline** — ravelling promotes to the widest leaf float dtype
  (``flat_dtype``: bf16 survives when every leaf is bf16) unless a
  ``dtype`` is given, and unravel casts each slice back to its leaf dtype.

:class:`FlatSpec` duck-types the
``problem`` argument of :func:`repro_torch.core.solver.make_aggregator`
(it reads only ``d``, ``V`` and ``D``).  :class:`VectorModel` wraps a
convex problem in the minimal model surface the trainer needs.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.utils import tree_leaves, tree_unflatten

PyTree = Any

LANE = 128  # the default ravel padding multiple


class FlatSpec(NamedTuple):
    """The guard-backend factories' view of a problem: dimension and the
    Assumption-2.2 constants.  ``V = 0`` means "unknown — calibrate
    online" (the ``dp_*`` backends only)."""

    d: int
    V: float = 0.0
    D: float = 10.0


class TreeHarness:
    """Ravel/unravel between a parameter-shaped pytree and the flat ``(d,)``
    (or worker-stacked ``(W, d)``) view, with lane padding.  Built once
    from a template tree whose leaves have ``shape`` and ``dtype`` (tensors,
    meta tensors included)."""

    def __init__(self, template: PyTree, pad_to: int = LANE):
        leaves = tree_leaves(template)
        # the structure alone: a placeholder in each leaf's place
        self.template = tree_unflatten(template, [0] * len(leaves))
        self.shapes = tuple(tuple(l.shape) for l in leaves)
        self.dtypes = tuple(l.dtype for l in leaves)
        self.sizes = tuple(math.prod(s) for s in self.shapes)
        self.d_raw = int(sum(self.sizes))
        pad_to = max(int(pad_to), 1)
        self.d = -(-self.d_raw // pad_to) * pad_to
        floats = [dt for dt in self.dtypes if dt.is_floating_point]
        flat = torch.float32
        if floats:
            flat = floats[0]
            for dt in floats[1:]:
                flat = torch.promote_types(flat, dt)
        self.flat_dtype = flat

    # -- tree → flat ---------------------------------------------------------

    def ravel(self, tree: PyTree, dtype: torch.dtype | None = None) -> torch.Tensor:
        """(d,) flat view of a parameter-shaped tree (zero-padded), in
        ``flat_dtype`` or ``dtype``; each leaf is cast as it is copied in."""
        leaves = tree_leaves(tree)
        out = torch.empty((self.d,), dtype=dtype or self.flat_dtype, device=leaves[0].device)
        ofs = 0
        for leaf, size in zip(leaves, self.sizes):
            out[ofs: ofs + size].copy_(leaf.reshape(-1))
            ofs += size
        out[self.d_raw:].zero_()
        return out

    def ravel_workers(self, tree: PyTree, dtype: torch.dtype | None = None) -> torch.Tensor:
        """(W, d) flat view of a worker-stacked tree (leaves lead with W)."""
        leaves = tree_leaves(tree)
        W = leaves[0].shape[0]
        out = torch.empty((W, self.d), dtype=dtype or self.flat_dtype, device=leaves[0].device)
        ofs = 0
        for leaf, size in zip(leaves, self.sizes):
            out[:, ofs: ofs + size].copy_(leaf.reshape(W, -1))
            ofs += size
        out[:, self.d_raw:].zero_()
        return out

    # -- flat → tree ---------------------------------------------------------

    def unravel(self, vec: torch.Tensor) -> PyTree:
        """Parameter-shaped tree from a (d,) flat vector (padding dropped,
        leaves cast back to their template dtypes)."""
        out, ofs = [], 0
        for shape, dtype, size in zip(self.shapes, self.dtypes, self.sizes):
            out.append(vec[ofs: ofs + size].reshape(shape).to(dtype))
            ofs += size
        return tree_unflatten(self.template, out)


def params_harness(model, pad_to: int = LANE) -> TreeHarness:
    """Harness over a model's parameter tree, built shape-only: from
    ``model.abstract()`` (meta tensors from the param defs, nothing
    allocated) where the model has it, else from ``model.init``."""
    abstract = getattr(model, "abstract", None)
    template = abstract() if abstract is not None else model.init(None)
    return TreeHarness(template, pad_to=pad_to)


class VectorModel:
    """A convex :class:`~repro_torch.core.solver.Problem` wearing the
    minimal model surface the trainer consumes: params are ``{"x": (d,)}``
    and each worker's batch carries a ``noise`` vector, so its gradient is
    exactly ``∇f(x) + noise``."""

    def __init__(self, problem):
        self.problem = problem
        self.device = problem.x1.device

    def init(self, key: torch.Tensor) -> PyTree:
        del key  # the paper's x₁ is deterministic
        return {"x": self.problem.x1.to(torch.float32)}

    def loss_fn(self, params: PyTree, tb: dict):
        x = params["x"]
        # ⟨noise, x⟩ has gradient `noise`: grad(loss) = ∇f(x) + noise
        return self.problem.f(x) + torch.dot(tb["noise"][0], x), {}
