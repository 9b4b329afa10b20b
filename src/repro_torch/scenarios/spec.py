"""Scenario specs, the counterpart of :mod:`repro.scenarios.spec`: one
adversary dynamic as a record of scalars.

At step k a Byzantine worker with coalition rank r (its 0-based index
within the current Byzantine set) plays::

    attack_b  if  (k >= switch_step) or (r >= ceil(coalition_frac · n_byz))
    attack_a  otherwise

and the Byzantine set is a schedule: workers join at ``join_step`` and
rotate by ``churn_stride`` every ``churn_period`` steps (see
:meth:`repro_torch.scenarios.adversary.ScenarioAdversary.mask_at`).

The fields are host scalars: ids and steps Python ints, fractions and
magnitudes numpy f32 as the JAX scenario's f32 leaves, so every schedule
is decided on the host and a step never waits for the device.  The JAX
package stacks scenarios into one ``jit(vmap)``; the port's
:class:`CampaignGrid` (:func:`expand_grid`) keeps each row's scenario, α
and fault plan on the host and stacks what is a tensor (the seeds and the
profiles' leaves), and the campaign runner maps one ``run_sgd`` over each
group of rows that share the host decisions
(:mod:`repro_torch.scenarios.campaign`).

A :class:`WorkerProfile` parameterizes the honest side of a run, per
worker: data skew, a staleness period and a reporting probability.  Its
leaves are (m,) tensors on the run's device, so the step's refresh and
reporting masks are device ops that need no copy from the host.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import resolve_device

# sentinel for "this schedule never fires"
NEVER = 1 << 30


class WorkerProfile(NamedTuple):
    """Per-worker state, three (m,) leaves (meanings as in the JAX
    ``WorkerProfile``): worker w's gradient is biased by ``skew[w]·C[w]``
    (:func:`repro_torch.data.problems.heterogenize_problem`), refreshed only
    on steps with ``k % (min(delay[w], max_delay) + 1) == 0``, and reported
    with probability ``p_report[w]`` a step.  The degenerate profile (skew
    0, delay 0, p_report 1) runs bit for bit as no profile."""

    skew: torch.Tensor      # (m,) f32 data-skew magnitude
    delay: torch.Tensor     # (m,) int32 staleness period − 1
    p_report: torch.Tensor  # (m,) f32 participation probability a step


def worker_profile(m: int, *, skew=0.0, delay=0, p_report=1.0,
                   device="cuda") -> WorkerProfile:
    """Scalars broadcast to (m,), sequences are taken per worker; the
    defaults give the degenerate profile."""
    dev = resolve_device(device)

    def vec(x, dtype):
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()
        arr = np.asarray(x, dtype)
        arr = np.full((m,), arr, dtype) if arr.ndim == 0 else arr.reshape((m,)).astype(dtype)
        return torch.from_numpy(arr).to(dev)

    return WorkerProfile(skew=vec(skew, np.float32), delay=vec(delay, np.int32),
                         p_report=vec(p_report, np.float32))


def profile_iid(m: int, device="cuda") -> WorkerProfile:
    """The degenerate profile: runs bit for bit as ``profile=None``."""
    return worker_profile(m, device=device)


def linspace_f32(stop: float, m: int) -> np.ndarray:
    """``jnp.linspace(0.0, stop, m)`` bit for bit as the JAX package gets it
    on the CPU: XLA turns the division by m − 1 into a product with its f32
    reciprocal and reassociates, so element i is ``(stop · (1/(m−1))) · i``
    (rounded at each product) and the last is ``stop``; ``i · stop / (m−1)``
    would differ by an ulp at some i."""
    if m <= 1:
        return np.zeros((m,), np.float32)
    i = np.arange(m - 1, dtype=np.float32)
    ramp = (np.float32(stop) * (np.float32(1.0) / np.float32(m - 1))) * i
    return np.concatenate([ramp, [np.float32(stop)]]).astype(np.float32)


def profile_linear_skew(m: int, skew_max: float, device="cuda") -> WorkerProfile:
    """Worker w's bias ramps linearly from 0 to ``skew_max`` across the fleet."""
    return worker_profile(m, skew=linspace_f32(skew_max, m), device=device)


def profile_stragglers(m: int, frac: float, delay: int, device="cuda") -> WorkerProfile:
    """The last ``min(max(round(frac·m), 1 if frac > 0 else 0), m)`` workers
    refresh their gradient only every ``delay + 1`` steps."""
    n_slow = min(max(int(round(frac * m)), 1 if frac > 0 else 0), m)
    delays = np.zeros((m,), np.int32)
    if n_slow:
        delays[m - n_slow:] = delay
    return worker_profile(m, delay=delays, device=device)


def profile_partial(m: int, p: float, device="cuda") -> WorkerProfile:
    """Every worker reports independently with probability ``p`` a step."""
    return worker_profile(m, p_report=p, device=device)


def profile_knobs(profile: WorkerProfile | None) -> dict:
    """Summary knobs of a profile, for result rows."""
    if profile is None:
        return {"skew": 0.0, "max_delay": 0, "participation": 1.0}
    return {"skew": float(torch.max(profile.skew)),
            "max_delay": int(torch.max(profile.delay)),
            "participation": float(torch.min(profile.p_report))}


class Scenario(NamedTuple):
    """One adversary dynamic (field meanings as in the JAX ``Scenario``)."""

    attack_a: int               # id into ATTACK_TABLE
    attack_b: int
    switch_step: int            # k ≥ switch → coalition A plays b
    coalition_frac: np.float32  # fraction of the Byzantine set in coalition A
    churn_period: int           # 0 = static membership
    churn_stride: int           # workers rotated per churn event
    join_step: int              # Byzantine workers honest before this step
    attack_scale: np.float32    # multiplier on the attack's default magnitude
    adapt_rate: np.float32      # 0 = no feedback adaptation


def make_scenario(attack: str | None = None, *, attack_a: str | None = None,
                  attack_b: str | None = None, switch_step: int = NEVER,
                  coalition_frac: float = 1.0, churn_period: int = 0,
                  churn_stride: int = 1, join_step: int = 0,
                  attack_scale: float = 1.0, adapt_rate: float = 0.0) -> Scenario:
    """General constructor; ``attack`` is shorthand for attack_a = attack_b."""
    from repro_torch.scenarios.adversary import attack_id  # avoid an import cycle

    a = attack_a if attack_a is not None else attack
    b = attack_b if attack_b is not None else a
    if a is None:
        raise ValueError("make_scenario needs `attack` or `attack_a`")
    return Scenario(attack_a=attack_id(a), attack_b=attack_id(b),
                    switch_step=int(switch_step), coalition_frac=np.float32(coalition_frac),
                    churn_period=int(churn_period), churn_stride=int(churn_stride),
                    join_step=int(join_step), attack_scale=np.float32(attack_scale),
                    adapt_rate=np.float32(adapt_rate))


def scenario_static(attack: str, attack_scale: float = 1.0) -> Scenario:
    """The stateless zoo, unchanged."""
    return make_scenario(attack, attack_scale=attack_scale)


def scenario_lie_low_then_strike(attack: str, switch_step: int,
                                 attack_scale: float = 1.0) -> Scenario:
    """Honest until ``switch_step``, then strike."""
    return make_scenario(attack_a="none", attack_b=attack, switch_step=switch_step,
                         attack_scale=attack_scale)


def scenario_churn(attack: str, period: int, stride: int,
                   attack_scale: float = 1.0) -> Scenario:
    """The Byzantine set rotates by ``stride`` workers every ``period`` steps."""
    return make_scenario(attack, churn_period=period, churn_stride=stride,
                         attack_scale=attack_scale)


def scenario_late_join(attack: str, join_step: int, attack_scale: float = 1.0) -> Scenario:
    """Workers are honest until ``join_step``, Byzantine afterwards."""
    return make_scenario(attack, join_step=join_step, attack_scale=attack_scale)


def scenario_coalition(attack_a: str, attack_b: str, frac: float = 0.5) -> Scenario:
    """⌈frac·n_byz⌉ workers play ``attack_a``, the rest ``attack_b``."""
    return make_scenario(attack_a=attack_a, attack_b=attack_b, coalition_frac=frac)


def scenario_adaptive(attack: str, adapt_rate: float = 0.5,
                      attack_scale: float = 1.0) -> Scenario:
    """Multiplicative-weights magnitude driven by the filter's feedback."""
    return make_scenario(attack, adapt_rate=adapt_rate, attack_scale=attack_scale)


class GridEntry(NamedTuple):
    """Row metadata of one campaign run, for reports (as the JAX
    ``GridEntry``)."""

    scenario: str
    alpha: float
    seed: int
    profile: str = "iid"
    skew: float = 0.0
    max_delay: int = 0
    participation: float = 1.0
    fault: str = "none"
    fault_frac: float = 0.0


@dataclasses.dataclass(init=False)
class CampaignGrid:
    """A cartesian product of (scenario × α × seed × profile × fault) runs,
    N = ``n_runs`` rows.

    ``scenarios`` and ``faults`` hold each row's host record, ``alpha``
    each row's α (an (N,) f32 array): the host decisions a run is built
    from.  ``seeds`` is an (N,) int32 tensor and ``profiles`` a
    :class:`WorkerProfile` whose leaves are (N, m) tensors on the run's
    device, or None for a homogeneous grid; ``faults`` is None for a
    fault-free grid.  ``rows`` keeps one :class:`GridEntry` a run."""

    scenarios: tuple
    alpha: np.ndarray
    seeds: torch.Tensor
    rows: tuple
    profiles: WorkerProfile | None = None
    faults: tuple | None = None

    def __init__(self, scenarios, alpha, seeds, entries, profiles=None, faults=None):
        self.scenarios = tuple(scenarios)
        self.alpha = np.asarray(alpha, np.float32)
        self.seeds = torch.as_tensor(seeds, dtype=torch.int32)
        self.rows = tuple(e if isinstance(e, GridEntry) else GridEntry(**e) for e in entries)
        self.profiles = profiles
        self.faults = None if faults is None else tuple(faults)

    @property
    def entries(self) -> list[dict]:
        """The rows as dicts."""
        return [e._asdict() for e in self.rows]

    @property
    def n_runs(self) -> int:
        return len(self.rows)


def _structure(tree) -> str:
    return f"{type(tree).__name__}{getattr(tree, '_fields', ())}"


def _stack_axis(axis: str, trees):
    """One grid axis' per-run records, checked to share one structure and
    one shape per leaf (naming the axis and the member that differs, as
    the JAX package does); records of tensors come back stacked along a
    new leading axis, host records as a tuple."""
    t0 = trees[0]
    if all(tree is None for tree in trees):
        return None
    for i, tree in enumerate(trees[1:], start=1):
        if _structure(tree) != _structure(t0):
            raise ValueError(
                f"expand_grid: axis {axis!r} member {i} has structure {_structure(tree)}, but "
                f"member 0 has {_structure(t0)} — every member of a grid axis must share one "
                f"structure")
        for field in t0._fields:
            shape0 = tuple(np.shape(getattr(t0, field)))
            shape = tuple(np.shape(getattr(tree, field)))
            if shape != shape0:
                raise ValueError(
                    f"expand_grid: axis {axis!r} stacks disagree in leading shape: member {i} "
                    f"leaf {'.' + field!r} has shape {shape}, but member 0 has {shape0} (e.g. "
                    f"WorkerProfiles built for different m)")
    if any(isinstance(leaf, torch.Tensor) for leaf in t0):
        return type(t0)(*(torch.stack(leaves) for leaves in zip(*trees)))
    return tuple(trees)


def expand_grid(named_scenarios: Sequence[tuple[str, Scenario]], alphas: Sequence[float],
                seeds: Sequence[int],
                profiles: Sequence[tuple[str, WorkerProfile]] | None = None,
                faults: Sequence[tuple[str, object]] | None = None) -> CampaignGrid:
    """Cartesian product (scenario × α × seed [× profile] [× fault]) → one
    grid, rows in the JAX package's order.  ``profiles`` is an optional
    named axis of :class:`WorkerProfile` values (each row records the
    profile's knobs); ``faults`` an optional named axis of
    :class:`~repro_torch.scenarios.faults.FaultPlan` values, where a None
    member is the inert plan ``fault_none()``."""
    from repro_torch.scenarios import faults as faults_mod

    prof_axis = profiles if profiles is not None else [("iid", None)]
    fault_axis = ([(n, p if p is not None else faults_mod.fault_none()) for n, p in faults]
                  if faults is not None else [("none", None)])
    rows, entries, profs, plans = [], [], [], []
    for name, scn in named_scenarios:
        for alpha in alphas:
            for seed in seeds:
                for pname, prof in prof_axis:
                    for fname, plan in fault_axis:
                        rows.append((scn, float(alpha), int(seed)))
                        profs.append(prof)
                        plans.append(plan)
                        entries.append(GridEntry(
                            scenario=name, alpha=float(alpha), seed=int(seed), profile=pname,
                            **profile_knobs(prof), **faults_mod.fault_knobs(plan)))
    if not rows:
        raise ValueError("empty grid")
    stacked = _stack_axis("scenarios", [r[0] for r in rows])
    alpha = np.asarray([r[1] for r in rows], np.float32)
    seed = torch.tensor([r[2] for r in rows], dtype=torch.int32)
    stacked_prof = _stack_axis("profiles", profs) if profiles is not None else None
    stacked_fault = _stack_axis("faults", plans) if faults is not None else None
    return CampaignGrid(stacked, alpha, seed, entries, stacked_prof, stacked_fault)
