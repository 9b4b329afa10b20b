#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc``; it imports nothing of JAX or of the
JAX package.  Phases, in order (any failure raises and exits non-zero,
and then no result line is printed):

1. device  — a CUDA device must be visible; prints ``nvidia-smi``'s name
   and power limit;
2. build   — compiles ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a
   into ``build/repro_torch_kernels/`` and prints the build seconds and
   each kernel's registers and spills;
3. kernels — both kernels against their plain versions at m=32, d=2^20
   and m=17, d=555 (f32, bf16) and m=32, d=2^26+3 (bf16, m·d > 2^31):
   ``B_new`` bit-equal, the rest within ‖got−want‖ ≤ tol·‖want‖ + tol,
   tol = 1e-5 (f32) / 1e-4 (bf16: both sides sum exact f32 upcasts, so
   only the order of the sums differs);
4. main path — ``run_sgd`` on ``make_generated_problem(d=2^20, seed=0)``,
   m=32, T=128, α=0.25, ``sign_flip``: ``fused@f32``, ``fused@bf16``,
   ``dense@f32`` and the ``mean`` baseline, each with the launch counts
   set to 0 just before and read just after; then the same run on the
   card and on the CPU at d=4099, m=8, T=70 (decisions equal, values
   within 1e-5);
5. timing — each kernel's median time at m=32, d=2^20 beside its bound,
   its plain version and (filtered mean) one library call, and the split
   of one main-path step between its parts;
6. the kernels line, the card line and the result line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import prng  # noqa: E402
from repro_torch.core import attacks  # noqa: E402
from repro_torch.core.guard_backends import make_guard_backend  # noqa: E402
from repro_torch.core.solver import SolverConfig, run_sgd  # noqa: E402
from repro_torch.data.problems import make_generated_problem  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.fused_guard import fused_guard_cuda  # noqa: E402
from repro_torch.kernels.robust_reduce import filtered_mean_cuda  # noqa: E402

M, D, T = 32, 2 ** 20, 128
# Kernel against plain version on the card: both upcast bf16 to f32 exactly
# and sum in f32, so only the order of the sums differs.  The bf16 limit is
# about 10x the largest such error read on an H100 (8.1e-6 relative, gram_g
# at m=32, d=2^26+3); a kernel that rounded its sums to bf16 would miss it.
TOL = {"f32": 1e-5, "bf16": 1e-4}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# NVIDIA H100 SXM data sheet: HBM rate, dense peaks by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
KERNELS = {
    "fused_guard": ("src/repro_torch/kernels/csrc/fused_guard.cu",
                    "src/repro/kernels/fused_guard.py:112"),
    "filtered_mean": ("src/repro_torch/kernels/csrc/filtered_mean.cu",
                      "src/repro/kernels/robust_reduce.py:108"),
}


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(‖got − want‖ / ‖want‖, max |got − want|), in f64."""
    diff = got.double() - want.double()
    return (float(diff.norm() / want.double().norm().clamp_min(1e-300)),
            float(diff.abs().max()))


def within(got: torch.Tensor, want: torch.Tensor, tol: float) -> bool:
    diff = (got.double() - want.double()).norm()
    return bool(diff <= tol * want.double().norm() + tol)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def reset_counts() -> None:
    fused_guard_cuda.launches = 0
    filtered_mean_cuda.launches = 0


def read_counts() -> dict:
    return {"fused_guard": fused_guard_cuda.launches,
            "filtered_mean": filtered_mean_cuda.launches}


# ---------------------------------------------------------------- phase 3

def check_kernels(dev) -> dict:
    """Both kernels against their plain versions; returns the errors at the
    main-path shape by (kernel, dtype)."""
    errs = {}
    cases = [(M, D, "f32"), (M, D, "bf16"), (17, 555, "f32"), (17, 555, "bf16"),
             (M, 2 ** 26 + 3, "bf16")]
    for m, d, dt in cases:
        gen = torch.Generator(device=dev).manual_seed(m * 7919 + d)
        g = torch.randn(m, d, device=dev, generator=gen, dtype=DTYPES[dt])
        B = torch.randn(m, d, device=dev, generator=gen, dtype=DTYPES[dt]).mul_(3)
        dlt = torch.randn(d, device=dev, generator=gen, dtype=DTYPES[dt])
        w = (torch.rand(m, device=dev, generator=gen) > 0.3).float() / m
        got = fused_guard_cuda(g, B, dlt)
        torch.cuda.synchronize()
        want = ref.fused_guard_ref(g, B, dlt)
        b_equal = torch.equal(got[3], want[3])
        del B
        fg = [rel_err(a, b) for a, b in zip(got[:3], want[:3])]
        fg_ok = all(within(a, b, TOL[dt]) for a, b in zip(got[:3], want[:3]))
        del got, want
        xi = filtered_mean_cuda(g, w, 1.0)
        torch.cuda.synchronize()
        xi_ref = ref.filtered_mean_ref(g, w, 1.0)
        fm = rel_err(xi, xi_ref)
        fm_ok = within(xi, xi_ref, TOL[dt])
        emit("kernels", m=m, d=d, dtype=dt, B_new_bit_equal=b_equal,
             fused_guard_rel_abs={"gram_g": fg[0], "cross": fg[1], "a_inc": fg[2]},
             filtered_mean_rel_abs=fm, tol=TOL[dt])
        require(b_equal, f"fused_guard B_new bit-equal at m={m} d={d} {dt}")
        require(fg_ok, f"fused_guard within {TOL[dt]} at m={m} d={d} {dt}")
        require(fm_ok, f"filtered_mean within {TOL[dt]} at m={m} d={d} {dt}")
        if (m, d) == (M, D):
            errs[("fused_guard", dt)] = max(e[1] for e in fg)
            errs[("filtered_mean", dt)] = fm[1]
        del g, dlt, xi, xi_ref
        torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------- phase 4

RUNS = [
    ("fused@f32", dict(guard_backend="fused", stats_dtype="f32")),
    ("fused@bf16", dict(guard_backend="fused", stats_dtype="bf16")),
    ("dense@f32", dict(guard_backend="dense", stats_dtype="f32")),
    ("mean", dict(aggregator="mean")),
]
BASE = dict(m=M, T=T, eta=0.05, alpha=0.25, attack="sign_flip", aggregator="byzantine_sgd")


def main_path(dev) -> dict:
    problem = make_generated_problem(d=D, seed=0, device=dev)
    results, launches = {}, {}
    for name, over in RUNS:
        cfg = SolverConfig(**{**BASE, **over})
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = run_sgd(problem, cfg, prng.PRNGKey(0), device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[name] = read_counts()
        results[name] = res
        finite = bool(torch.isfinite(res.x_avg).all() and torch.isfinite(res.gaps).all())
        emit("main_path", run=name, final_gap=float(res.gaps[-1]),
             gap_at_x_avg=float(problem.f(res.x_avg)),
             n_alive_last=int(res.n_alive[-1]), n_byzantine=int(res.byz_mask.sum()),
             byzantine_alive=int((res.final_alive & res.byz_mask).sum()),
             ever_filtered_good=bool(res.ever_filtered_good),
             ms_per_step=1e3 * seconds / T, launches=launches[name], finite=finite)
        require(finite, f"{name}: finite x_avg and gaps")
        require(res.x_avg.shape == (D,) and res.gaps.shape == (T,), f"{name}: shapes")

    fused, bf16, dense, mean = (results[n] for n, _ in RUNS)
    require(torch.equal(fused.n_alive, dense.n_alive), "fused and dense n_alive series equal")
    require(torch.equal(fused.final_alive, dense.final_alive), "fused and dense final_alive equal")
    for name in ("fused@f32", "fused@bf16"):
        require(launches[name] == {"fused_guard": T, "filtered_mean": T},
                f"{name} launched each kernel T times: {launches[name]}")
    for name in ("dense@f32", "mean"):
        require(launches[name] == {"fused_guard": 0, "filtered_mean": 0},
                f"{name} launched no kernel: {launches[name]}")
    n_byz = int(BASE["alpha"] * M)
    for name in ("fused@f32", "fused@bf16", "dense@f32"):
        res = results[name]
        require(int(res.byz_mask.sum()) == n_byz, f"{name}: {n_byz} Byzantine workers")
        require(not bool((res.final_alive & res.byz_mask).any()),
                f"{name}: every Byzantine worker filtered")
        require(int(res.n_alive[-1]) == M - n_byz, f"{name}: n_alive[-1] == {M - n_byz}")
        require(not bool(res.ever_filtered_good), f"{name}: no honest worker filtered")
    require(float(mean.gaps[-1]) > 10 * float(fused.gaps[-1]),
            "mean's final gap far above byzantine_sgd's")
    emit("main_path", check="passed", fused_equals_dense=True, bf16_equals_f32_decisions=bool(
        torch.equal(bf16.n_alive, fused.n_alive)))
    return launches


def small_reference(dev) -> None:
    """The card's run against the CPU's plain-version run on a small input."""
    kw = dict(m=8, T=70, eta=0.05, alpha=0.25, attack="sign_flip",
              aggregator="byzantine_sgd", guard_backend="fused")
    got = run_sgd(make_generated_problem(d=4099, seed=1, device=dev), SolverConfig(**kw),
                  prng.PRNGKey(1), device=dev)
    want = run_sgd(make_generated_problem(d=4099, seed=1, device="cpu"), SolverConfig(**kw),
                   prng.PRNGKey(1), device="cpu")
    same = torch.equal(got.n_alive.cpu(), want.n_alive) and torch.equal(
        got.final_alive.cpu(), want.final_alive)
    err = rel_err(got.x_avg.cpu(), want.x_avg)
    emit("small_reference", decisions_equal=same, x_avg_rel_abs=err)
    require(same, "card and CPU decisions equal on the small input")
    require(within(got.x_avg.cpu(), want.x_avg, 1e-5), "card and CPU x_avg within 1e-5")


# ---------------------------------------------------------------- phase 5

def median_ms(fn, batches: int = 7, per_batch: int = 20) -> float:
    """Median over batches of the mean time of ``per_batch`` back-to-back
    calls, by CUDA events (the queue stays full, so host overhead hides)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def bound(nbytes: float, flops: float, dt: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dt]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_kernels(dev, errs, launches) -> list:
    entries = []
    for dt in ("f32", "bf16"):
        e = torch.tensor([], dtype=DTYPES[dt]).element_size()
        gen = torch.Generator(device=dev).manual_seed(5)
        g = torch.randn(M, D, device=dev, generator=gen, dtype=DTYPES[dt])
        B = torch.randn(M, D, device=dev, generator=gen, dtype=DTYPES[dt])
        dlt = torch.randn(D, device=dev, generator=gen, dtype=DTYPES[dt])
        w = torch.rand(M, device=dev, generator=gen) / M
        run = "fused@f32" if dt == "f32" else "fused@bf16"

        fg_bytes = 3 * M * D * e + D * e + (2 * M * M + M) * 4
        fg_flops = 4 * M * M * D + 2 * M * D + M * D
        b_ms, b_by = bound(fg_bytes, fg_flops, dt)
        entries.append({
            "name": f"fused_guard[{dt}]", "route": "cuda",
            "source": KERNELS["fused_guard"][0], "replaces": KERNELS["fused_guard"][1],
            "launches": launches[run]["fused_guard"],
            "max_abs_err": errs[("fused_guard", dt)],
            "ms": median_ms(lambda: fused_guard_cuda(g, B, dlt)),
            "plain_ms": median_ms(lambda: ref.fused_guard_ref(g, B, dlt)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        emit("bound", kernel=f"fused_guard[{dt}]", shape=[M, D], bytes=fg_bytes,
             flops=fg_flops)
        fm_bytes = M * D * e + M * 4 + D * 4
        fm_flops = 2 * M * D
        b_ms, b_by = bound(fm_bytes, fm_flops, dt)
        w_lib = w.to(DTYPES[dt])
        entries.append({
            "name": f"filtered_mean[{dt}]", "route": "cuda",
            "source": KERNELS["filtered_mean"][0], "replaces": KERNELS["filtered_mean"][1],
            "launches": launches[run]["filtered_mean"],
            "max_abs_err": errs[("filtered_mean", dt)],
            "ms": median_ms(lambda: filtered_mean_cuda(g, w, 1.0)),
            "plain_ms": median_ms(lambda: ref.filtered_mean_ref(g, w, 1.0)),
            "bound_ms": b_ms, "bound_by": b_by,
            # one library call, w @ x in the input dtype: a yardstick only
            "library_ms": median_ms(lambda: w_lib @ g),
        })
        emit("bound", kernel=f"filtered_mean[{dt}]", shape=[M, D], bytes=fm_bytes,
             flops=fm_flops)
        del g, B, dlt
        torch.cuda.empty_cache()
    return entries


def step_split(dev) -> None:
    """Where one main-path step (fused@f32) goes: CUDA events around the
    sampler, the attack, the guard step and the projected update."""
    problem = make_generated_problem(d=D, seed=0, device=dev)
    cfg = SolverConfig(**{**BASE, **RUNS[0][1]})
    state, step = make_guard_backend("fused", problem, cfg, dev)
    x1 = problem.x1
    x = x1
    byz = torch.zeros(M, dtype=torch.bool, device=dev)
    byz[: int(cfg.alpha * M)] = True
    rng = prng.PRNGKey(0, device=dev)
    parts = {"keys": [], "sampler": [], "attack": [], "guard": [], "update": []}
    for _ in range(12):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        rng, gkey, akey = prng.split(rng, 3)
        keys = prng.split(gkey, M)
        ev[1].record()
        grads = problem.stoch_grad(keys, x)
        ev[2].record()
        grads = attacks.attack_sign_flip(akey, grads, byz, {})
        ev[3].record()
        state, xi, _, _ = step(state, grads, x, x1)
        ev[4].record()
        x_new = x - cfg.eta * xi
        dx = x_new - x1
        x = x1 + dx * torch.clamp(problem.D / torch.clamp(torch.linalg.vector_norm(dx),
                                                          min=1e-30), max=1.0)
        ev[5].record()
        ev[5].synchronize()
        for i, name in enumerate(parts):
            parts[name].append(ev[i].elapsed_time(ev[i + 1]))
    ms = {name: statistics.median(v[2:]) for name, v in parts.items()}
    emit("step_split", run="fused@f32", ms=ms, total_ms=sum(ms.values()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    # full f32 products in the plain versions and the resync Gram
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    emit("device", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {stem: [ln.strip() for ln in _build.build_log(stem).splitlines()
                    if "registers" in ln or "spill" in ln] for stem in libs}
    emit("build", seconds=build_s, libraries=[str(p) for p in libs.values()], ptxas=ptxas)

    errs = check_kernels(dev)
    launches = main_path(dev)
    small_reference(dev)
    entries = time_kernels(dev, errs, launches)
    step_split(dev)

    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
