"""Chaos-injection harness (the counterpart of the JAX package's
``scripts/chaos.py``): the fault matrix the checkpoint layer and the
sanitize stage promise to survive, end to end through the port's entry
points (``python -m repro_torch.launch.train`` subprocesses for the crash
cases, ``repro_torch.scenarios.run_campaign`` in process for the
value-corruption case), on the card unless ``--device cpu``.

==================  =======================================================
``baseline``        the uninterrupted run; its final checkpoint is the
                    parity target of every crash case
``kill_resume``     SIGKILL the trainer right after its first periodic
                    checkpoint lands, resume with ``--resume``: the final
                    checkpoint must be **bit-identical** to the baseline's
``truncate``        truncate the newest checkpoint file (a torn write);
                    ``latest_step`` skips it and the run resumes from the
                    previous complete one, still bit-identical at the end
``corrupt``         change a stored leaf under an intact container and a
                    stale checksum (silent bit rot): restore quarantines the
                    file (``*.corrupt``) with a warning and falls back to the
                    previous valid checkpoint, still bit-identical
``sigterm``         SIGTERM mid-run (a preemption notice): the trainer exits
                    0 with a flushed, resumable final checkpoint, and resumes
                    to bit-parity
``nonfinite``       a campaign with NaN/Inf/bitflip fault plans over every
                    guard backend under ``sanitize="quarantine"``: every
                    gap finite, the victims counted as Byzantine
==================  =======================================================

Bit-parity compares the raw stored arrays of the final checkpoint, not a
float tolerance.  The crash cases train mamba2-130m reduced (W = 4,
``dp_exact``, sign_flip) with the JAX package's flags plus ``--device``.
The report has the JAX harness's keys and goes to ``--out`` (no default).

Usage::

    PYTHONPATH=src python -m repro_torch.chaos --mini --out build/chaos.json
    PYTHONPATH=src python -m repro_torch.chaos --device cpu --out /tmp/chaos.json
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

SRC = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(SRC)


def _train_cmd(ckpt_dir: str, steps: int, d_model: int, device: str, *extra: str) -> list[str]:
    return [
        sys.executable, "-m", "repro_torch.launch.train",
        "--arch", "mamba2-130m", "--reduced",
        "--workers", "4", "--per-worker-batch", "1",
        "--seq-len", "32", "--d-model", str(d_model),
        "--steps", str(steps), "--log-every", "4",
        "--alpha", "0.25", "--attack", "sign_flip",
        "--guard-backend", "dp_exact", "--seed", "0",
        "--ckpt-dir", ckpt_dir, "--device", device, *extra,
    ]


def _env(device: str) -> dict:
    """The trainer's environment: the port on the path; on the CPU one
    thread, since torch's CPU reductions and MKL's products split their sums
    by the size of the thread team, which MKL may change under load (and
    bit-parity between two processes would go with it)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    if device == "cpu":
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return env


def _run(cmd: list[str], device: str, timeout: int = 900) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, env=_env(device), cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


def _ckpt_names(ckpt_dir: str) -> list[str]:
    return sorted(f for f in os.listdir(ckpt_dir) if f.startswith("ckpt_") and f.endswith(".npz"))


def _wait_for_ckpt(ckpt_dir: str, proc: subprocess.Popen, timeout: float = 600.0) -> str | None:
    """Poll until the first committed ``ckpt_*.npz`` appears (or the
    process exits, or the time runs out); its path or None."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        if os.path.isdir(ckpt_dir):
            names = _ckpt_names(ckpt_dir)
            if names:
                return os.path.join(ckpt_dir, names[0])
        if proc.poll() is not None:
            return None
        time.sleep(0.25)
    return None


def _final_ckpt_arrays(ckpt_dir: str, step: int) -> dict:
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    with np.load(path, allow_pickle=False) as data:
        return {k: np.array(data[k]) for k in data.files}


def _bit_identical(a: dict, b: dict) -> bool:
    def eq(x, y):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        # equal_nan exists for float dtypes only; exact compare elsewhere
        if np.issubdtype(x.dtype, np.floating):
            return bool(np.array_equal(x, y, equal_nan=True))
        return bool(np.array_equal(x, y))

    return set(a) == set(b) and all(eq(a[k], b[k]) for k in a)


def _stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.kill()
    proc.wait()


def case_baseline(work: str, steps: int, d_model: int, device: str) -> tuple[dict, dict]:
    """The uninterrupted run; its final checkpoint is every crash case's
    parity target."""
    ckpt = os.path.join(work, "baseline")
    p = _run(_train_cmd(ckpt, steps, d_model, device, "--ckpt-every", "8"), device)
    ok = p.returncode == 0
    arrays = _final_ckpt_arrays(ckpt, steps) if ok else {}
    return {"ok": ok, "detail": p.stderr[-2000:] if not ok else ""}, arrays


def _resume_and_compare(ckpt: str, steps: int, d_model: int, device: str, baseline: dict,
                        expect_warn: bool = False) -> dict:
    p = _run(_train_cmd(ckpt, steps, d_model, device, "--ckpt-every", "8", "--resume"), device)
    if p.returncode != 0:
        return {"ok": False, "detail": f"resume failed: {p.stderr[-2000:]}"}
    out = {"ok": True, "resumed_line": next(
        (ln for ln in p.stdout.splitlines() if ln.startswith("resumed")), "")}
    if expect_warn and "quarantined" not in p.stderr:
        return {"ok": False, "detail": "expected a quarantine warning"}
    if not _bit_identical(_final_ckpt_arrays(ckpt, steps), baseline):
        return {"ok": False, "detail": "final checkpoint differs from the uninterrupted run "
                                       "(bit-parity broken)"}
    out["bit_identical"] = True
    return out


def case_kill_resume(work: str, steps: int, d_model: int, baseline: dict,
                     device: str = "cuda") -> dict:
    """SIGKILL right after the first periodic checkpoint commits."""
    ckpt = os.path.join(work, "kill")
    proc = subprocess.Popen(_train_cmd(ckpt, steps, d_model, device, "--ckpt-every", "8"),
                            env=_env(device), cwd=ROOT, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    if _wait_for_ckpt(ckpt, proc) is None:
        _stop(proc)
        return {"ok": False, "detail": "no checkpoint appeared before exit"}
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    return _resume_and_compare(ckpt, steps, d_model, device, baseline)


def _seed_two_checkpoints(work: str, name: str, steps: int, d_model: int,
                          device: str) -> str | None:
    """A prefix run that leaves at least two committed checkpoints."""
    ckpt = os.path.join(work, name)
    p = _run(_train_cmd(ckpt, steps, d_model, device, "--ckpt-every", "8", "--stop-after", "16"),
             device)
    if p.returncode != 0:
        return None
    return ckpt if len(_ckpt_names(ckpt)) >= 2 else None


def case_truncate(work: str, steps: int, d_model: int, baseline: dict,
                  device: str = "cuda") -> dict:
    """A torn write: the newest checkpoint is half a file."""
    ckpt = _seed_two_checkpoints(work, "truncate", steps, d_model, device)
    if ckpt is None:
        return {"ok": False, "detail": "could not seed two checkpoints"}
    path = os.path.join(ckpt, _ckpt_names(ckpt)[-1])
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    # a truncated zip is an incomplete unit: latest_step does not list it,
    # so the resume starts from the previous complete checkpoint
    return _resume_and_compare(ckpt, steps, d_model, device, baseline)


def case_corrupt(work: str, steps: int, d_model: int, baseline: dict,
                 device: str = "cuda") -> dict:
    """Silent bit rot: an intact container whose first leaf no longer
    matches its manifest checksum; restore quarantines it and falls back."""
    ckpt = _seed_two_checkpoints(work, "corrupt", steps, d_model, device)
    if ckpt is None:
        return {"ok": False, "detail": "could not seed two checkpoints"}
    path = os.path.join(ckpt, _ckpt_names(ckpt)[-1])
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: np.array(data[k]) for k in data.files}
    flat = arrays["leaf_0"].reshape(-1)
    flat[: max(1, flat.size // 8)] = flat[: max(1, flat.size // 8)] + 1
    with open(path, "wb") as f:
        np.savez(f, **arrays)   # the container is valid, the checksum stale
    res = _resume_and_compare(ckpt, steps, d_model, device, baseline, expect_warn=True)
    if res.get("ok") and not any(f.endswith(".corrupt") for f in os.listdir(ckpt)):
        return {"ok": False, "detail": "corrupt file was not quarantined"}
    return res


def case_sigterm(work: str, steps: int, d_model: int, baseline: dict,
                 device: str = "cuda") -> dict:
    """A preemption notice: SIGTERM after the first periodic checkpoint;
    the trainer exits 0 with a flushed, resumable checkpoint."""
    from repro_torch.checkpoint import latest_step

    ckpt = os.path.join(work, "sigterm")
    proc = subprocess.Popen(_train_cmd(ckpt, steps, d_model, device, "--ckpt-every", "8"),
                            env=_env(device), cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)
    if _wait_for_ckpt(ckpt, proc) is None:
        _stop(proc)
        return {"ok": False, "detail": "no checkpoint appeared before exit"}
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=300)
    except subprocess.TimeoutExpired:
        _stop(proc)
        return {"ok": False, "detail": "trainer ignored SIGTERM (grace budget exceeded)"}
    if proc.returncode != 0:
        return {"ok": False, "detail": f"exit code {proc.returncode} after SIGTERM "
                                       "(expected a graceful flush)"}
    flushed = latest_step(ckpt)
    if flushed is None:
        return {"ok": False, "detail": "no complete checkpoint after SIGTERM"}
    res = ({"ok": True, "note": "run completed before the signal landed"}
           if flushed >= steps else _resume_and_compare(ckpt, steps, d_model, device, baseline))
    res["flushed_step"] = int(flushed)
    return res


def case_nonfinite(steps: int, device: str = "cuda") -> dict:
    """The NaN/Inf/bitflip fault sweep through one campaign: every guard
    backend returns finite gaps and counts the victims as Byzantine."""
    from repro_torch.core.solver import SolverConfig
    from repro_torch.data.problems import make_quadratic_problem
    from repro_torch.scenarios import (
        expand_grid,
        fault_bitflip,
        fault_inf_rows,
        fault_nan_rows,
        fault_none,
        run_campaign,
        scenario_static,
    )

    quad = make_quadratic_problem(d=24, sigma=1.0, L=8.0, V=1.0, seed=1, device=device)
    cfg = SolverConfig(m=8, T=steps, eta=0.05, alpha=0.25, aggregator="byzantine_sgd",
                       attack="sign_flip", sanitize="quarantine")
    grid = expand_grid(
        [("static", scenario_static("sign_flip"))], [0.125], [0, 1],
        faults=[("none", fault_none()),
                ("nan", fault_nan_rows(0.25)),
                ("inf", fault_inf_rows(0.25, period=2)),
                ("bitflip", fault_bitflip(0.25, start_step=4))],
    )
    result = run_campaign(quad, cfg, grid, ["byzantine_sgd", "mean", "coordinate_median"],
                          backends=["dense", "fused", "dp_exact", "dp_sketch"], device=device)
    cells, bad = 0, []
    for name, stats in result.stats.items():
        for field in ("gap_avg", "gap_final"):
            vals = getattr(stats, field).detach().cpu().numpy()
            cells += vals.size
            if not np.all(np.isfinite(vals)):
                bad.append(f"{name}.{field}")
    # the guard counts the fault victims toward the realised Byzantine set
    n_ever = result.stats["byzantine_sgd@dense"].n_byz_ever.cpu().numpy().reshape(2, 4)
    filtered = bool(np.all(n_ever[:, 1:] > n_ever[:, :1]))
    return {"ok": not bad and filtered, "cells_checked": cells, "non_finite_cells": bad,
            "victims_filtered": filtered, "variants": sorted(result.stats)}


CRASH_CASES = (("kill_resume", case_kill_resume), ("truncate", case_truncate),
               ("corrupt", case_corrupt), ("sigterm", case_sigterm))


def run_chaos(steps: int = 24, d_model: int = 64, device: str = "cuda",
              nonfinite_steps: int = 20, keep_work: bool = False,
              verbose: bool = True) -> dict:
    """Every case, in the report in the JAX harness's order; the report as
    a dict (``ok`` when every case is).  The cases after the baseline run
    at once: the four crash cases each in its own directory with its own
    trainer processes, ``nonfinite`` in this process."""
    report: dict = {"steps": steps, "d_model": d_model, "device": device, "cases": {}}
    work = tempfile.mkdtemp(prefix="chaos_")

    def timed(fn, *args):
        t = time.time()
        res = fn(*args)
        res["wall_s"] = round(time.time() - t, 2)
        return res

    try:
        t0 = time.time()
        base_res, base_arrays = case_baseline(work, steps, d_model, device)
        base_res["wall_s"] = round(time.time() - t0, 2)
        report["cases"]["baseline"] = base_res
        cases = [(name, (fn, work, steps, d_model, base_arrays, device))
                 for name, fn in CRASH_CASES] if base_res["ok"] else []
        cases.append(("nonfinite", (case_nonfinite, nonfinite_steps, device)))
        with concurrent.futures.ThreadPoolExecutor(max_workers=len(cases)) as pool:
            done = [(name, pool.submit(timed, *call)) for name, call in cases]
            for name, fut in done:
                res = report["cases"][name] = fut.result()
                if verbose:
                    print(f"{name}: {'PASS' if res['ok'] else 'FAIL'} ({res['wall_s']}s)  "
                          f"{res.get('detail', '')}", flush=True)
        report["wall_s"] = round(time.time() - t0, 2)
    finally:
        if keep_work:
            print(f"work dir kept: {work}")
        else:
            shutil.rmtree(work, ignore_errors=True)
    report["ok"] = all(c.get("ok") for c in report["cases"].values())
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=24,
                    help="trainer steps a crash case (>= 17 so two periodic checkpoints "
                         "land before the end)")
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--mini", action="store_true",
                    help="the JAX harness's CI shape (the defaults)")
    ap.add_argument("--out", required=True, help="where the JSON report goes")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--keep-work", action="store_true",
                    help="keep the scratch checkpoint directories")
    args = ap.parse_args(argv)
    report = run_chaos(args.steps, args.d_model, args.device, keep_work=args.keep_work)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.out}  (matrix {'GREEN' if report['ok'] else 'RED'})")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
