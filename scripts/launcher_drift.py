#!/usr/bin/env python3
"""How far the port's launcher losses drift from the JAX package's over a
run, both on the CPU: the bound ``chip_smoke.py`` holds the card's
launcher runs to against the CPU's (``LM_LOSS_TOL``, ``MOE_SSM_LOSS_TOL``).
A CPU parity check like the tests (it imports both packages); it never
runs on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/launcher_drift.py \\
        --arch jamba-v0.1-52b [--steps 40]

``run_training`` of both packages at the launcher phase's sizes (reduced,
d_model 128, W = 8, seq 64, dp_exact, α = 0.25, sign_flip; the JAX
package's loop driver).  Prints one JSON line: whether every step's
decisions are equal, and the relative difference of the honest workers'
loss at each step, its largest over the first 10 steps and over the run.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro.launch.train import run_training as jax_run_training  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402

DECISIONS = ("n_alive", "byz_alive", "good_filtered", "n_byz")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="jamba-v0.1-52b")
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    kw = dict(reduced=True, d_model=128, workers=8, seq_len=64, steps=args.steps,
              guard_backend="dp_exact", log_every=10)
    with contextlib.redirect_stdout(sys.stderr):   # the JAX launcher's chunk lines
        _, want = jax_run_training(args.arch, driver="loop", **kw)
    _, got = run_training(args.arch, device="cpu", verbose=False, **kw)
    rel = [abs(a["loss_good_workers"] - b["loss_good_workers"]) / abs(a["loss_good_workers"])
           for a, b in zip(want, got)]
    print(json.dumps({
        "arch": args.arch, **kw, "device": "cpu",
        "decisions_equal": all(a[k] == b[k] for a, b in zip(want, got) for k in DECISIONS),
        "loss_rel_max_first_10": max(rel[:10]), "loss_rel_max": max(rel),
        "loss_rel": [float(f"{r:.2e}") for r in rel]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
