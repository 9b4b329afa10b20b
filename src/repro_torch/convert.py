"""Carry state between the JAX package and the port as numpy arrays.

The port never imports JAX; a caller holding the JAX package's
``Problem``, ``GuardState`` or ``DPGuardState`` passes its arrays through
``numpy.asarray`` and hands them here.  bf16 arrays arrive with numpy's ``bfloat16`` extension
dtype (two bytes per element) and are reinterpreted bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.byzantine_sgd import GuardState
from repro_torch.core.solver import Problem
from repro_torch.data.problems import generated_problem
from repro_torch.distributed.byzantine_dp import DPGuardState


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """A numpy array (f32, bool, ints, or 2-byte bfloat16) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(resolve_device(device))
    return torch.as_tensor(np.array(a), device=resolve_device(device))


def problem_from_numpy(h, x_star, x1, D, V, L, sigma, noise_scale,
                       device="cuda") -> Problem:
    """The port's generated problem from the arrays of the JAX package's
    ``make_generated_problem`` (``problem.gen.h``, ``problem.x_star``, …)."""
    return generated_problem(h, x_star, x1, D, V, L, sigma, noise_scale, device)


def guard_state_from_numpy(A, B, alive, k, gram_B, device="cuda") -> GuardState:
    """The port's ``GuardState`` from the JAX package's (k becomes a host int)."""
    return GuardState(A=tensor_from_numpy(A, device), B=tensor_from_numpy(B, device),
                      alive=tensor_from_numpy(alive, device).to(torch.bool),
                      k=int(k), gram_B=tensor_from_numpy(gram_B, device))


def guard_state_to_numpy(state: GuardState) -> dict:
    """The state's arrays as numpy; a bf16 ``B`` comes back upcast to f32
    (exact)."""
    B = state.B
    if B.dtype == torch.bfloat16:
        B = B.to(torch.float32)
    return {"A": state.A.cpu().numpy(), "B": B.cpu().numpy(),
            "alive": state.alive.cpu().numpy(), "k": state.k,
            "gram_B": state.gram_B.cpu().numpy()}


def _tree_from_numpy(tree, device):
    if isinstance(tree, (list, tuple)):
        return [tensor_from_numpy(a, device) for a in tree]
    return tensor_from_numpy(tree, device)


def _f32_numpy(t: torch.Tensor) -> np.ndarray:
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).cpu().numpy()


def dp_guard_state_from_numpy(A, B, alive, k, v_est, gram_B, device="cuda") -> DPGuardState:
    """The port's ``DPGuardState`` from the JAX package's: ``B`` is one
    array (the sketch, or the flat harness's one-leaf exact B) or a list of
    leaves, each kept in its dtype (bf16 bit for bit); k becomes a host
    int."""
    return DPGuardState(A=tensor_from_numpy(A, device), B=_tree_from_numpy(B, device),
                        alive=tensor_from_numpy(alive, device).to(torch.bool), k=int(k),
                        v_est=tensor_from_numpy(v_est, device),
                        gram_B=tensor_from_numpy(gram_B, device))


def dp_guard_state_to_numpy(state: DPGuardState) -> dict:
    """The state's arrays as numpy, ``B`` in its structure; a bf16 leaf comes
    back upcast to f32 (exact, so it equals the JAX package's
    ``B.astype(float32)`` bit for bit)."""
    B = ([_f32_numpy(b) for b in state.B] if isinstance(state.B, list)
         else _f32_numpy(state.B))
    return {"A": state.A.cpu().numpy(), "B": B, "alive": state.alive.cpu().numpy(),
            "k": state.k, "v_est": state.v_est.cpu().numpy(),
            "gram_B": state.gram_B.cpu().numpy()}
