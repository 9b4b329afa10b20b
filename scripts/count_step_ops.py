#!/usr/bin/env python3
"""Counts the torch operations one ``run_sgd`` step of the convex harness
dispatches, on the CPU, and splits them between the key chain, the
sampler and the rest.  On the card each operation is at least one kernel
launch, so at d = 16 the count is what sets a step's time there.

    PYTHONPATH=src python3 scripts/count_step_ops.py [--steps 10]

Prints one JSON line: for quickstart's problem (``make_quadratic_problem``,
d = 16, m = 16) under sign_flip, the operations a step of the fused and
the dense guard and of the mean, and those of ``prng.split`` (one
threefry evaluation), of the per-step key chain and of one sphere-noise
batch.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import prng  # noqa: E402
from repro_torch.core.solver import SolverConfig, run_sgd  # noqa: E402
from repro_torch.data.problems import _sphere_noise, make_quadratic_problem  # noqa: E402


class CountOps(TorchDispatchMode):
    """Counts every operation dispatched inside the ``with`` block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def count(fn) -> int:
    with CountOps() as c:
        fn()
    return c.n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    m, d, T = 16, 16, args.steps
    problem = make_quadratic_problem(d=d, sigma=1.0, L=8.0, V=1.0, seed=0, device="cpu")
    per_step = {}
    for name, over in (("byzantine_sgd fused", dict(guard_backend="fused")),
                       ("byzantine_sgd dense", dict(guard_backend="dense")),
                       ("mean", dict(aggregator="mean"))):
        cfg = SolverConfig(**{**dict(m=m, T=T, eta=0.05, alpha=0.25, attack="sign_flip"),
                              **over})
        per_step[name] = count(lambda: run_sgd(problem, cfg, prng.PRNGKey(0),
                                               device="cpu")) / T
    key = prng.PRNGKey(1)
    worker_keys = prng.split(key, m)
    print(json.dumps({
        "problem": "quadratic d=16, m=16, sign_flip", "steps": T,
        "ops_per_step": per_step,
        "split": count(lambda: prng.split(key)),
        "key_chain": count(lambda: prng.split(prng.split(key, 3)[1], m)),
        "sphere_noise": count(lambda: _sphere_noise(worker_keys, d, 1.0)),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
