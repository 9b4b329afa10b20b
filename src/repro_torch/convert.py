"""Carry state between the JAX package and the port as numpy arrays.

The port never imports JAX; a caller holding the JAX package's
``Problem`` (generated, quadratic, least squares or logistic),
``GuardState``, ``DPGuardState``, ``Scenario``, ``AdvState``,
``WorkerProfile``, ``FaultPlan``, LM parameters, ``TrainState`` or decode
caches passes its arrays through
``numpy.asarray`` and hands them here.  bf16 arrays arrive with numpy's
``bfloat16`` extension dtype (two bytes per element) and are
reinterpreted bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.byzantine_sgd import GuardState
from repro_torch.core.solver import Problem
from repro_torch.data import problems
from repro_torch.distributed.byzantine_dp import DPGuardState
from repro_torch.distributed.trainer import TrainState
from repro_torch.models.attention import KVCache, QuantKVCache
from repro_torch.models.ssm import MambaCache
from repro_torch.scenarios.adversary import AdvState
from repro_torch.scenarios.faults import FaultPlan
from repro_torch.scenarios.spec import Scenario, WorkerProfile
from repro_torch.utils import tree_map


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
    ``make_generated_problem`` (``problem.gen.h``, ``problem.x_star``, …);
    ``noise_scale`` (``problem.gen.noise_scale``) is both the sampler's
    and the ``GenSpec``'s."""
    return problems.generated_problem(h, x_star, x1, D, V, L, sigma, noise_scale, device)


def quadratic_problem_from_numpy(H, x_star, x1, D, V, L, sigma, device="cuda") -> Problem:
    """The port's quadratic problem from the JAX package's
    ``make_quadratic_problem`` arrays (H, x*, x1) and scalars."""
    return problems.quadratic_problem(H, x_star, x1, D, V, L, sigma, device)


def least_squares_problem_from_numpy(A, b, x_star, x1, D, V, L, sigma,
                                     device="cuda") -> Problem:
    """The port's least-squares problem from the JAX package's
    ``make_least_squares_problem`` arrays (A, b, x*, x1) and scalars."""
    return problems.least_squares_problem(A, b, x_star, x1, D, V, L, sigma, device)


def logistic_problem_from_numpy(A, y, reg, x_star, x1, D, V, L, device="cuda") -> Problem:
    """The port's logistic problem from the JAX package's
    ``make_logistic_problem`` arrays (A, y, x*, x1) and scalars: its x*
    is the reference's, not the port's own descent."""
    return problems.logistic_problem(A, y, reg, x_star, x1, D, V, L, device)


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


def scenario_from_numpy(attack_a, attack_b, switch_step, coalition_frac, churn_period,
                        churn_stride, join_step, attack_scale, adapt_rate) -> Scenario:
    """The port's ``Scenario`` from the JAX package's 0-d leaves, in its
    field order (``scenario_from_numpy(*map(np.asarray, jax_scenario))``):
    ints as Python ints, fractions and magnitudes as numpy f32."""
    i, f = (lambda a: int(np.asarray(a))), (lambda a: np.float32(np.asarray(a)))
    return Scenario(attack_a=i(attack_a), attack_b=i(attack_b), switch_step=i(switch_step),
                    coalition_frac=f(coalition_frac), churn_period=i(churn_period),
                    churn_stride=i(churn_stride), join_step=i(join_step),
                    attack_scale=f(attack_scale), adapt_rate=f(adapt_rate))


def adv_state_from_numpy(adapt_scale, device="cuda") -> AdvState:
    """The port's ``AdvState`` from the JAX package's ``adapt_scale``."""
    return AdvState(adapt_scale=tensor_from_numpy(np.float32(adapt_scale), device))


def profile_from_numpy(skew, delay, p_report, device="cuda") -> WorkerProfile:
    """The port's ``WorkerProfile`` from the JAX package's (m,) leaves, in
    its field order (``profile_from_numpy(*map(np.asarray, jax_profile))``),
    on ``device``."""
    return WorkerProfile(
        skew=tensor_from_numpy(np.asarray(skew, np.float32), device),
        delay=tensor_from_numpy(np.asarray(delay, np.int32), device),
        p_report=tensor_from_numpy(np.asarray(p_report, np.float32), device))


def fault_plan_from_numpy(mode, frac, start_step, period, magnitude) -> FaultPlan:
    """The port's ``FaultPlan`` from the JAX package's 0-d leaves, in its
    field order (``fault_plan_from_numpy(*map(np.asarray, jax_plan))``):
    ids and steps as Python ints, ``frac`` and ``magnitude`` as numpy f32."""
    i, f = (lambda a: int(np.asarray(a))), (lambda a: np.float32(np.asarray(a)))
    return FaultPlan(mode=i(mode), frac=f(frac), start_step=i(start_step), period=i(period),
                     magnitude=f(magnitude))


# ---------------------------------------------------------------------------
# the LM training path: parameters and the trainer's state
# ---------------------------------------------------------------------------

def params_from_numpy(tree, device="cuda"):
    """A parameter (or optimizer-moment) tree of numpy arrays — the JAX
    package's, through ``numpy.asarray`` — as tensors on ``device``; dicts
    and lists keep their structure, bf16 arrays their bits."""
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def params_to_numpy(params):
    """The tree's tensors as numpy arrays; a bf16 leaf comes back upcast to
    f32 (exact)."""
    return tree_map(_f32_numpy, params)


def _guard_from_numpy(guard, device):
    if guard is None:
        return None
    if hasattr(guard, "v_est"):
        return dp_guard_state_from_numpy(*guard, device=device)
    if hasattr(guard, "gram_B"):
        return guard_state_from_numpy(*guard, device=device)
    return params_from_numpy(guard, device)


def train_state_from_numpy(params, opt_state, guard, anchor, step, ever_byz, adv, prev_xi,
                           prev_alive, prev_n_alive, grad_buf=(), device="cuda") -> TrainState:
    """The port's ``TrainState`` from the JAX package's fields, in its field
    order (``train_state_from_numpy(*jax.tree_util.tree_map(np.asarray,
    state), device=...)``): the guard state through
    :func:`guard_state_from_numpy` or :func:`dp_guard_state_from_numpy`, an
    ``AdvState`` through :func:`adv_state_from_numpy`, ``step`` a host int."""
    adv = (adv_state_from_numpy(adv.adapt_scale, device) if hasattr(adv, "adapt_scale")
           else tensor_from_numpy(adv, device))
    buf = () if isinstance(grad_buf, tuple) and not grad_buf else tensor_from_numpy(grad_buf,
                                                                                    device)
    return TrainState(
        params=params_from_numpy(params, device), opt_state=params_from_numpy(opt_state, device),
        guard=_guard_from_numpy(guard, device), anchor=tensor_from_numpy(anchor, device),
        step=int(np.asarray(step)), ever_byz=tensor_from_numpy(ever_byz, device).to(torch.bool),
        adv=adv, prev_xi=tensor_from_numpy(prev_xi, device),
        prev_alive=tensor_from_numpy(prev_alive, device).to(torch.bool),
        prev_n_alive=tensor_from_numpy(np.asarray(prev_n_alive, np.int32), device),
        grad_buf=buf)


def train_state_to_numpy(state: TrainState) -> dict:
    """The state's fields as numpy (bf16 upcast to f32, exactly); the guard
    state through :func:`guard_state_to_numpy` or
    :func:`dp_guard_state_to_numpy`."""
    guard = state.guard
    if isinstance(guard, DPGuardState):
        guard = dp_guard_state_to_numpy(guard)
    elif isinstance(guard, GuardState):
        guard = guard_state_to_numpy(guard)
    elif guard is not None:
        guard = params_to_numpy(guard)
    adv = state.adv
    adv = ({"adapt_scale": adv.adapt_scale.cpu().numpy()} if isinstance(adv, AdvState)
           else _f32_numpy(adv))
    return {"params": params_to_numpy(state.params),
            "opt_state": params_to_numpy(state.opt_state), "guard": guard,
            "anchor": _f32_numpy(state.anchor), "step": state.step,
            "ever_byz": state.ever_byz.cpu().numpy(), "adv": adv,
            "prev_xi": _f32_numpy(state.prev_xi), "prev_alive": state.prev_alive.cpu().numpy(),
            "prev_n_alive": state.prev_n_alive.cpu().numpy(),
            "grad_buf": (_f32_numpy(state.grad_buf) if isinstance(state.grad_buf, torch.Tensor)
                         else ())}


# ---------------------------------------------------------------------------
# serving: the decode caches
# ---------------------------------------------------------------------------

def kv_cache_from_numpy(cache, device="cuda") -> dict:
    """The port's decode cache from the JAX package's (``{"layers": [one
    KVCache, QuantKVCache or MambaCache a layer group, leaves stacked on the
    group's layer axis]}`` through ``numpy.asarray`` leaf by leaf): a group
    with ``k_scale`` becomes a ``QuantKVCache``, one with ``conv_x`` a
    ``MambaCache``; bf16 leaves keep their bits."""
    def group(c):
        kind = (QuantKVCache if hasattr(c, "k_scale") else
                MambaCache if hasattr(c, "conv_x") else KVCache)
        return kind(*(tensor_from_numpy(getattr(c, f), device) for f in kind._fields))

    return {"layers": [group(c) for c in cache["layers"]]}


def kv_cache_to_numpy(cache: dict) -> dict:
    """The cache's groups as dicts of numpy arrays by field (bf16 upcast to
    f32, exactly)."""
    return {"layers": [{f: _f32_numpy(getattr(c, f)) for f in c._fields}
                       for c in cache["layers"]]}
