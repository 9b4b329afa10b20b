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
package stacks scenarios into one ``jit(vmap)``; the port runs one
scenario per run.  ``WorkerProfile``, ``CampaignGrid`` and ``expand_grid``
are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

# sentinel for "this schedule never fires"
NEVER = 1 << 30


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
