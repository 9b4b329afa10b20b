"""Helpers of :mod:`repro.utils` that the port needs, copied so the port
imports nothing of the JAX package: ``log_c`` and the pytree arithmetic.

A pytree here is a nested ``dict`` / ``list`` / ``tuple`` (a NamedTuple
included) of tensors; ``None`` is an empty subtree.  Leaves come in
``jax.tree_util``'s order: a dict's keys sorted, a sequence in order, so a
tree ravels to the JAX package's flat vector.  Every reduction accumulates
in f32 from exact upcasts, leaf by leaf in that order, as the JAX package
does.  A 0-d tensor factor promotes as ``jnp`` promotes a 0-d array (a
bf16 leaf times an f32 scalar gives f32), not as torch would.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np
import torch

PyTree = Any
F32 = torch.float32


@functools.lru_cache(maxsize=None)
def log_c(m: int, T: int, delta: float) -> float:
    """The paper's C = log(16 m T / δ) (Section 3.1)."""
    return float(np.log(16.0 * m * T / delta))


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

def _children(node) -> list | None:
    """The subtrees of a container node in jax's order, or None for a leaf."""
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    return None


def _rebuild(node, children: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if hasattr(node, "_fields"):
        return type(node)(*children)
    return type(node)(children)


def tree_leaves(tree: PyTree, is_leaf: Callable | None = None) -> list:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid, is_leaf)]


def _path_names(node) -> list | None:
    """A container's child names as ``jax.tree_util.keystr`` pieces of a
    checkpoint key: a dict's keys (sorted), a NamedTuple's fields as
    ``.name`` (jax's ``GetAttrKey``), a sequence's indices."""
    if isinstance(node, dict):
        return [str(k) for k in sorted(node)]
    if hasattr(node, "_fields"):
        return [f".{f}" for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [str(i) for i in range(len(node))]
    return None


def tree_flatten_with_path(tree: PyTree) -> list[tuple[str, Any]]:
    """``(key, leaf)`` pairs in :func:`tree_leaves` order, each key the
    ``/``-joined path that the JAX package's checkpoint writes for the same
    leaf (``jax.tree_util.tree_flatten_with_path``): ``{"b": [x]}`` gives
    ``"b/0"``, a NamedTuple field ``.params``."""
    out: list = []

    def walk(node, prefix):
        if node is None:
            return
        names = _path_names(node)
        if names is None:
            out.append(("/".join(prefix), node))
            return
        for name, kid in zip(names, _children(node)):
            walk(kid, prefix + [name])

    walk(tree, [])
    return out


def tree_unflatten(template: PyTree, leaves, is_leaf: Callable | None = None) -> PyTree:
    """``template``'s structure holding ``leaves`` (in :func:`tree_leaves`
    order) in place of its own."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if is_leaf is not None and is_leaf(node):
            return next(it)
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [build(k) for k in kids])

    return build(template)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree, is_leaf: Callable | None = None) -> PyTree:
    """``fn`` leaf by leaf over trees of one structure (that of ``tree``)."""
    others = [tree_leaves(r, is_leaf) for r in rest]
    leaves = tree_leaves(tree, is_leaf)
    return tree_unflatten(tree, [fn(*xs) for xs in zip(leaves, *others)], is_leaf)


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.add, a, b)


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.sub, a, b)


def _scale_leaf(x: torch.Tensor, s) -> torch.Tensor:
    """``x * s`` with jnp's promotion: a tensor ``s`` (0-d f32) lifts a
    narrower leaf to its dtype first; a Python float keeps the leaf's."""
    if isinstance(s, torch.Tensor):
        dt = torch.promote_types(x.dtype, s.dtype)
        return x.to(dt) * s
    return x * s


def tree_scale(a: PyTree, s) -> PyTree:
    return tree_map(lambda x: _scale_leaf(x, s), a)


def tree_zeros_like(a: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, a)


def tree_vdot(a: PyTree, b: PyTree) -> torch.Tensor:
    """Σ over leaves of Σ x·y in f32, added leaf by leaf from 0."""
    xs, ys = tree_leaves(a), tree_leaves(b)
    total = torch.zeros((), dtype=F32, device=xs[0].device)
    for x, y in zip(xs, ys):
        total = total + torch.sum(x.to(F32) * y.to(F32))
    return total


def tree_sq_norm(a: PyTree) -> torch.Tensor:
    return tree_vdot(a, a)


def tree_norm(a: PyTree) -> torch.Tensor:
    return torch.sqrt(tree_sq_norm(a))


def global_norm(a: PyTree) -> torch.Tensor:
    return tree_norm(a)


def _shrink(norm: torch.Tensor, limit) -> torch.Tensor:
    """min(1, limit / max(norm, 1e-30)) in f32."""
    return torch.clamp(limit / torch.clamp(norm, min=1e-30), max=1.0)


def project_ball(x: PyTree, center: PyTree, radius) -> PyTree:
    """Euclidean projection of ``x`` onto {y : ‖y − center‖ ≤ radius}, with
    the global l2 norm over the whole tree (the paper's Fact 2.5)."""
    delta = tree_sub(x, center)
    return tree_add(center, tree_scale(delta, _shrink(tree_norm(delta), radius)))


def clip_by_global_norm(g: PyTree, max_norm) -> PyTree:
    return tree_scale(g, _shrink(tree_norm(g), max_norm))
