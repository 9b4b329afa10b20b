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
3. kernels — the guard kernels against their plain versions at m=32,
   d=2^20 and m=17, d=555 (f32, bf16) and m=32, d=2^26+3 (bf16, m·d >
   2^31): ``B_new`` bit-equal, the rest within ‖got−want‖ ≤ tol·‖want‖ +
   tol, tol = 1e-5 (f32) / 1e-4 (bf16: both sides sum exact f32 upcasts,
   so only the order of the sums differs); then ``gram``,
   ``coordinate_median`` and ``trimmed_mean`` (n_trim = min(8, (m−1)//2))
   at m=32, d=2^20; m=17, d=555; m=16, d=4099; m=32, d=2^26+3, in f32 and
   bf16: the median bit-equal, the rest within the same tol; then the
   sanitizing ``fused_guard`` and ``filtered_mean`` against their plain
   versions at the guard kernels' shapes, on input holding a whole NaN
   row, a ±Inf row and single NaN/Inf entries (one in the last column):
   ``nf`` equal, ``B_new`` bit-equal, the rest within tol; and on finite
   input bit-equal to the plain kernels;
4. main path — ``run_sgd`` on ``make_generated_problem(d=2^20, seed=0)``,
   m=32, T=128, α=0.25, ``sign_flip``: ``fused@f32``, ``fused@bf16``,
   ``dense@f32`` and the ``mean`` baseline, each with the launch counts
   set to 0 just before and read just after; then the same run on the
   card and on the CPU at d=4099, m=8, T=70 (decisions equal, values
   within 1e-5); then ``quarantine_main_path``: the three guard runs again
   with ``sanitize="quarantine"``, bit-equal to the runs without it, the
   sanitizing kernels launched T times each and the plain ones never;
5. baselines — the same ``run_sgd`` once per baseline of the registry and
   ``bucket2:krum`` under ``sign_flip``, then krum, coordinate_median and
   the fused guard under ``alie``: every run finite, every kernel launched
   exactly as its path says (T or 0 times); then krum, coordinate_median,
   trimmed_mean and bucket2:krum on the card and on the CPU at d=4099,
   m=8, T=16 (``x_avg`` within 1e-5 relative);
6. quarantine — 64 steps of ``make_aggregator``'s guard step under
   ``sanitize="quarantine"``, driven by ``run_sgd``'s loop with a fault
   plan applied after the attack (``nan_rows``, ``inf_rows``, ``bitflip``,
   ``garbage``; 4 victims from step 8), fused and dense at f32 and bf16:
   ξ finite at every step, fused decisions equal to dense, the same
   count of poisoned rows; for NaN/Inf also every victim dead from its
   first fault step, every Byzantine worker filtered and no other honest
   one; then one sanitized step of every baseline over a batch with 4
   NaN rows and 1 Inf row (ξ finite, those 5 rows dead, n_alive = 27,
   each kernel launched once); then both on the card and on the CPU at
   d=4099, m=8, T=16 (decisions equal, ξ and ``x_avg`` within 1e-5);
7. dp — ``countsketch`` against its plain version at m=32, d=2^20, k=4096
   (f32, bf16), m=17, d=555, k=8; m=16, d=16, k=4096 (k > d); m=8, d=4099,
   k=64 and m=32, d=2^26+3, k=4096 (bf16, m·d > 2^31), salts 0 and 7,
   within the same tol, and its signs bit-equal to ``ref.sketch_sign``;
   then ``run_sgd`` at the main path's shape with ``dp_exact@f32``,
   ``dp_exact@bf16``, ``dp_sketch@f32``, ``dp_sketch@bf16`` (sketch_dim
   4096) and ``dp_exact@f32`` with ``auto_v=False``: every run finite,
   ``countsketch`` launched T times on dp_sketch and never on dp_exact,
   ``filtered_mean`` T times on each, no other kernel; then
   ``dp_exact(auto_v=False)`` against ``dense@f32`` step by step (alive
   equal at every step); then ``dp_exact@f32`` and ``dp_sketch@f32`` with
   ``sanitize="quarantine"`` under ``nan_rows`` (64 steps, 4 victims from
   step 8): ξ finite, every victim dead from step 8; then both backends on
   the card and on the CPU at d=4099, m=8, T=70 (decisions equal,
   ``x_avg`` within 1e-5);
8. timing — each kernel's median time at m=32, d=2^20 beside its bound,
   its plain version and one library call where there is one (the
   sanitizing variants on input holding 4 non-finite rows), the bounds
   of the two generating kernels still to port (nothing launched), and
   the split of one main-path step between its parts;
9. the kernels line (16 entries), the card line and the result line.
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
from repro_torch.core import aggregators, attacks  # noqa: E402
from repro_torch.core.guard_backends import make_guard_backend  # noqa: E402
from repro_torch.core.solver import (  # noqa: E402
    SolverConfig,
    byz_rank,
    make_aggregator,
    run_sgd,
)
from repro_torch.data.problems import make_generated_problem  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.countsketch import countsketch_cuda  # noqa: E402
from repro_torch.kernels.fused_guard import fused_guard_cuda  # noqa: E402
from repro_torch.kernels.pairdist import gram_cuda  # noqa: E402
from repro_torch.kernels.robust_reduce import (  # noqa: E402
    coordinate_median_cuda,
    filtered_mean_cuda,
    trimmed_mean_cuda,
)
from repro_torch.scenarios import faults  # noqa: E402

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
    "gram": ("src/repro_torch/kernels/csrc/gram.cu", "src/repro/kernels/pairdist.py:33"),
    "coordinate_median": ("src/repro_torch/kernels/csrc/sorted_reduce.cu",
                          "src/repro/kernels/robust_reduce.py:88"),
    "trimmed_mean": ("src/repro_torch/kernels/csrc/sorted_reduce.cu",
                     "src/repro/kernels/robust_reduce.py:95"),
    # fused_guard_pallas(sanitize=True): body _fused_guard_sanitize_kernel;
    # filtered_mean_pallas(sanitize=True): the kernel body's sanitize branch
    "fused_guard_sanitize": ("src/repro_torch/kernels/csrc/fused_guard.cu",
                             "src/repro/kernels/fused_guard.py:73"),
    "filtered_mean_sanitize": ("src/repro_torch/kernels/csrc/filtered_mean.cu",
                               "src/repro/kernels/robust_reduce.py:60"),
    "countsketch": ("src/repro_torch/kernels/csrc/countsketch.cu",
                    "src/repro/kernels/countsketch.py:49"),
}
# each kernel's launch count: (wrapper, attribute); a sanitizing variant is
# counted on its wrapper apart from the plain one
COUNTERS = {"fused_guard": (fused_guard_cuda, "launches"),
            "filtered_mean": (filtered_mean_cuda, "launches"),
            "gram": (gram_cuda, "launches"),
            "coordinate_median": (coordinate_median_cuda, "launches"),
            "trimmed_mean": (trimmed_mean_cuda, "launches"),
            "fused_guard_sanitize": (fused_guard_cuda, "launches_sanitize"),
            "filtered_mean_sanitize": (filtered_mean_cuda, "launches_sanitize"),
            "countsketch": (countsketch_cuda, "launches")}
N_TRIM = 8   # the trimmed mean's count at m = 32 (capped at (m-1)//2 below)
# odd m with a masked tail, even m, and m·d > 2^31 (int64 offsets)
ORDER_SHAPES = ((M, D), (17, 555), (16, 4099), (M, 2 ** 26 + 3))


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
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def counts(**launched) -> dict:
    """The launch counts of a run that launched only the named kernels."""
    return {name: launched.get(name, 0) for name in COUNTERS}


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


def by_columns(fn, x: torch.Tensor, cols: int = 1 << 22) -> torch.Tensor:
    """``fn`` (a column-wise plain version) over column chunks of ``x``, so
    the plain sort of an (m, 2^26) input fits beside it."""
    return torch.cat([fn(x[:, i:i + cols]) for i in range(0, x.shape[1], cols)])


def check_order_kernels(dev, errs: dict) -> None:
    """gram, coordinate_median and trimmed_mean against their plain
    versions; adds the errors at the main-path shape to ``errs``."""
    for m, d in ORDER_SHAPES:
        n_trim = min(N_TRIM, (m - 1) // 2)
        for dt in ("f32", "bf16"):
            gen = torch.Generator(device=dev).manual_seed(m * 104729 + d)
            x = torch.randn(m, d, device=dev, generator=gen, dtype=DTYPES[dt])
            got = {"gram": gram_cuda(x), "coordinate_median": coordinate_median_cuda(x),
                   "trimmed_mean": trimmed_mean_cuda(x, n_trim)}
            torch.cuda.synchronize()
            want = {"gram": ref.gram_ref(x),
                    "coordinate_median": by_columns(ref.coordinate_median_ref, x),
                    "trimmed_mean": by_columns(lambda c: ref.trimmed_mean_ref(c, n_trim), x)}
            med_equal = torch.equal(got["coordinate_median"], want["coordinate_median"])
            rel_abs = {k: rel_err(got[k], want[k]) for k in got}
            emit("kernels", m=m, d=d, dtype=dt, n_trim=n_trim, median_bit_equal=med_equal,
                 rel_abs=rel_abs, tol=TOL[dt])
            require(med_equal, f"coordinate_median bit-equal at m={m} d={d} {dt}")
            for k in ("gram", "trimmed_mean"):
                require(within(got[k], want[k], TOL[dt]),
                        f"{k} within {TOL[dt]} at m={m} d={d} {dt}")
            if (m, d) == (M, D):
                for k, (_, abs_err) in rel_abs.items():
                    errs[(k, dt)] = abs_err
            del x, got, want
            torch.cuda.empty_cache()


def poison(x: torch.Tensor) -> torch.Tensor:
    """x with 4 non-finite rows, in place: row 0 all NaN, row m//2 ±Inf by
    column parity, row 1 a single +Inf and a single -Inf, row m−1 a single
    NaN in the last column (the masked tail when d % 64 != 0)."""
    m, d = x.shape
    x[0] = float("nan")
    x[m // 2, 0::2] = float("inf")
    x[m // 2, 1::2] = float("-inf")
    x[1, d // 2] = float("inf")
    x[1, 0] = float("-inf")
    x[m - 1, d - 1] = float("nan")
    return x


def check_sanitize_kernels(dev, errs: dict) -> None:
    """The sanitizing fused_guard and filtered_mean: on finite input
    bit-equal to the plain kernels, on poisoned input against their plain
    versions; adds the errors at the main-path shape to ``errs``."""
    cases = [(M, D, "f32"), (M, D, "bf16"), (17, 555, "f32"), (17, 555, "bf16"),
             (M, 2 ** 26 + 3, "bf16")]
    for m, d, dt in cases:
        gen = torch.Generator(device=dev).manual_seed(m * 6151 + d)
        g = torch.randn(m, d, device=dev, generator=gen, dtype=DTYPES[dt])
        B = torch.randn(m, d, device=dev, generator=gen, dtype=DTYPES[dt]).mul_(3)
        dlt = torch.randn(d, device=dev, generator=gen, dtype=DTYPES[dt])
        w = (torch.rand(m, device=dev, generator=gen) > 0.3).float() / m
        san, plain = fused_guard_cuda(g, B, dlt, sanitize=True), fused_guard_cuda(g, B, dlt)
        clean_equal = all(torch.equal(a, b) for a, b in zip(san[:4], plain)) and bool(
            (san[4] == 0).all())
        del san, plain
        clean_equal = clean_equal and torch.equal(filtered_mean_cuda(g, w, 1.0, sanitize=True),
                                                  filtered_mean_cuda(g, w, 1.0))
        poison(g)
        got = fused_guard_cuda(g, B, dlt, sanitize=True)
        torch.cuda.synchronize()
        want = ref.fused_guard_sanitize_ref(g, B, dlt)
        nf_equal = torch.equal(got[4], want[4])
        b_equal = torch.equal(got[3], want[3])
        del B
        fg = [rel_err(a, b) for a, b in zip(got[:3], want[:3])]
        fg_ok = all(within(a, b, TOL[dt]) for a, b in zip(got[:3], want[:3]))
        nf = got[4].tolist()
        del got, want
        xi = filtered_mean_cuda(g, w, 1.0, sanitize=True)
        torch.cuda.synchronize()
        xi_ref = ref.filtered_mean_sanitize_ref(g, w, 1.0)
        fm = rel_err(xi, xi_ref)
        fm_ok = within(xi, xi_ref, TOL[dt]) and bool(torch.isfinite(xi).all())
        emit("kernels", variant="sanitize", m=m, d=d, dtype=dt, clean_bit_equal=clean_equal,
             nf_equal=nf_equal, nf_nonzero={i: c for i, c in enumerate(nf) if c},
             B_new_bit_equal=b_equal,
             fused_guard_rel_abs={"gram_g": fg[0], "cross": fg[1], "a_inc": fg[2]},
             filtered_mean_rel_abs=fm, tol=TOL[dt])
        where = f"at m={m} d={d} {dt}"
        require(clean_equal, f"sanitizing kernels bit-equal to the plain ones on finite input {where}")
        require(nf_equal, f"fused_guard_sanitize nf equal {where}")
        require(b_equal, f"fused_guard_sanitize B_new bit-equal {where}")
        require(fg_ok, f"fused_guard_sanitize within {TOL[dt]} {where}")
        require(fm_ok, f"filtered_mean_sanitize finite and within {TOL[dt]} {where}")
        if (m, d) == (M, D):
            errs[("fused_guard_sanitize", dt)] = max(e[1] for e in fg)
            errs[("filtered_mean_sanitize", dt)] = fm[1]
        del g, dlt, xi, xi_ref
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4

RUNS = [
    ("fused@f32", dict(guard_backend="fused", stats_dtype="f32")),
    ("fused@bf16", dict(guard_backend="fused", stats_dtype="bf16")),
    ("dense@f32", dict(guard_backend="dense", stats_dtype="f32")),
    ("mean", dict(aggregator="mean")),
]
BASE = dict(m=M, T=T, eta=0.05, alpha=0.25, attack="sign_flip", aggregator="byzantine_sgd")


def main_path(dev) -> tuple[dict, dict]:
    """The four main-path runs; returns their launch counts and results."""
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
        require(launches[name] == counts(fused_guard=T, filtered_mean=T),
                f"{name} launched each guard kernel T times: {launches[name]}")
    for name in ("dense@f32", "mean"):
        require(launches[name] == counts(), f"{name} launched no kernel: {launches[name]}")
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
    return launches, results


def quarantine_main_path(dev, off: dict) -> dict:
    """The guard runs of the main path with ``sanitize="quarantine"``: on
    this finite input bit-equal to the runs without it (``off``), through
    the sanitizing kernels only.  Returns the launch counts."""
    problem = make_generated_problem(d=D, seed=0, device=dev)
    launches = {}
    for name, over in RUNS[:3]:
        cfg = SolverConfig(**{**BASE, **over, "sanitize": "quarantine"})
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = run_sgd(problem, cfg, prng.PRNGKey(0), device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = launches[name] = read_counts()
        same = {f: torch.equal(getattr(res, f), getattr(off[name], f))
                for f in ("n_alive", "final_alive", "x_avg", "x_final", "gaps")}
        emit("quarantine_main_path", run=name, ms_per_step=1e3 * seconds / T,
             final_gap=float(res.gaps[-1]), n_alive_last=int(res.n_alive[-1]),
             bit_equal_to_sanitize_off=same, launches=got)
        require(all(same.values()), f"{name}: sanitize on equals sanitize off bit for bit: {same}")
        want = (counts(fused_guard_sanitize=T, filtered_mean_sanitize=T)
                if name.startswith("fused") else counts())
        require(got == want, f"{name} with sanitize: launches {got}, expected {want}")
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

GRAM_RULES = ("krum", "multi_krum", "medoid", "bucket2:krum")
BASELINE_RUNS = ([(name, "sign_flip") for name in aggregators.aggregator_names()]
                 + [("bucket2:krum", "sign_flip"), ("krum", "alie"),
                    ("coordinate_median", "alie"), ("byzantine_sgd", "alie")])


def expected_counts(name: str, steps: int) -> dict:
    """The launch counts of a ``steps``-step run of aggregator ``name``."""
    if name == "byzantine_sgd":
        return counts(fused_guard=steps, filtered_mean=steps)
    if name in GRAM_RULES:
        return counts(gram=steps)
    if name in ("coordinate_median", "trimmed_mean"):
        return counts(**{name: steps})
    return counts()


def baselines(dev) -> dict:
    """Every baseline through ``run_sgd`` at the main path's shape; returns
    the launch counts by (aggregator, attack)."""
    problem = make_generated_problem(d=D, seed=0, device=dev)
    launches = {}
    for name, attack in BASELINE_RUNS:
        cfg = SolverConfig(**{**BASE, "aggregator": name, "attack": attack,
                              "guard_backend": "fused"})
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = run_sgd(problem, cfg, prng.PRNGKey(0), device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = launches[(name, attack)] = read_counts()
        finite = bool(torch.isfinite(res.x_avg).all() and torch.isfinite(res.gaps).all())
        emit("baselines", run=name, attack=attack, ms_per_step=1e3 * seconds / T,
             final_gap=float(res.gaps[-1]), gap_at_x_avg=float(problem.f(res.x_avg)),
             n_alive_last=int(res.n_alive[-1]), finite=finite, launches=got)
        require(finite, f"{name} under {attack}: finite x_avg and gaps")
        require(got == expected_counts(name, T),
                f"{name} under {attack}: launches {got}, expected {expected_counts(name, T)}")
    return launches


def baselines_reference(dev) -> None:
    """The kernel-backed baselines on the card against the CPU's plain
    versions on a small input."""
    steps = 16
    for name in ("krum", "coordinate_median", "trimmed_mean", "bucket2:krum"):
        kw = dict(m=8, T=steps, eta=0.05, alpha=0.25, attack="sign_flip", aggregator=name)
        reset_counts()
        got = run_sgd(make_generated_problem(d=4099, seed=2, device=dev), SolverConfig(**kw),
                      prng.PRNGKey(2), device=dev)
        launched = read_counts()
        want = run_sgd(make_generated_problem(d=4099, seed=2, device="cpu"),
                       SolverConfig(**kw), prng.PRNGKey(2), device="cpu")
        err = rel_err(got.x_avg.cpu(), want.x_avg)
        emit("baselines_reference", run=name, x_avg_rel_abs=err, launches=launched)
        require(launched == expected_counts(name, steps),
                f"{name}: the card's run launched {launched}")
        require(within(got.x_avg.cpu(), want.x_avg, 1e-5),
                f"{name}: card and CPU x_avg within 1e-5")


# ---------------------------------------------------------------- phase 6

QUARANTINE_STEPS = 64
FAULT_START = 8
FAULT_PLANS = {
    "nan_rows": faults.fault_nan_rows(0.125, start_step=FAULT_START),
    "inf_rows": faults.fault_inf_rows(0.125, start_step=FAULT_START, period=4),
    "bitflip": faults.fault_bitflip(0.125, start_step=FAULT_START),
    "garbage": faults.fault_garbage(0.125, start_step=FAULT_START),
}
# fused against dense at each stats dtype: the dense guard is the oracle
GUARD_RUNS = (("fused@f32", "fused", "f32"), ("dense@f32", "dense", "f32"),
              ("fused@bf16", "fused", "bf16"), ("dense@bf16", "dense", "bf16"))
QUARANTINE_BASE = dict(eta=0.05, alpha=0.25, attack="sign_flip", aggregator="byzantine_sgd",
                       sanitize="quarantine")


def guard_loop(problem, cfg, plan, dev) -> dict:
    """cfg.T steps of ``make_aggregator``'s step, driven by ``run_sgd``'s
    loop (key chain, sampler, attack, projected step) with ``plan`` (or no
    fault when None) applied after the attack under ``fold_in(akey,
    FAULT_KEY_TAG)``, as the JAX ``run_sgd`` applies a fault plan.  Returns
    the per-step series."""
    key = prng.PRNGKey(0, device=dev)
    key, mask_key = prng.split(key)
    rank = byz_rank(mask_key, cfg.m)
    byz = rank < cfg.n_byzantine
    attack_fn = attacks.get_attack(cfg.attack)
    state, step = make_aggregator(problem, cfg, dev)
    x1 = problem.x1
    x, x_sum, rng = x1, torch.zeros_like(x1), key
    alive_s, xi_finite, poisoned = [], [], []
    for k in range(cfg.T):
        rng, gkey, akey = prng.split(rng, 3)
        grads = problem.stoch_grad(prng.split(gkey, cfg.m), x)
        grads = attack_fn(akey, grads, byz, {"true_grad": problem.grad(x), "V": problem.V})
        if plan is not None:
            grads = faults.apply_fault_plan(plan, prng.fold_in(akey, faults.FAULT_KEY_TAG),
                                            grads, rank, k)
        # the rows the sanitizer must catch: non-finite once in the stats dtype
        poisoned.append(~torch.isfinite(grads.to(DTYPES[cfg.stats_dtype])).all(dim=1))
        state, xi, _, alive = step(state, grads, x, x1)
        xi_finite.append(torch.isfinite(xi).all())
        alive_s.append(alive)
        delta = x - cfg.eta * xi - x1
        nrm = torch.linalg.vector_norm(delta)
        x_sum = x_sum + x
        x = x1 + delta * torch.clamp(problem.D / torch.clamp(nrm, min=1e-30), max=1.0)
    return {"alive": torch.stack(alive_s).cpu(), "xi_finite": torch.stack(xi_finite).cpu(),
            "poisoned": torch.stack(poisoned).cpu(), "x_avg": (x_sum / cfg.T).cpu(),
            "byz": byz.cpu(),
            "victims": (torch.zeros_like(byz) if plan is None
                        else faults.fault_rows(plan, rank, plan.start_step)).cpu()}


def quarantine_checks(fault: str, runs: dict) -> None:
    """The gates of one fault plan over the GUARD_RUNS series."""
    for name, r in runs.items():
        n_alive = r["alive"].sum(dim=1).tolist()
        honest = ~r["byz"] & ~r["victims"]
        emit("quarantine", fault=fault, run=name, steps=len(n_alive),
             n_alive_at={k: n_alive[k] for k in (0, FAULT_START - 1, FAULT_START,
                                                 len(n_alive) - 1)},
             n_poisoned_rows=int(r["poisoned"].sum()),
             victims_alive_last=int((r["alive"][-1] & r["victims"]).sum()),
             byzantine_alive_last=int((r["alive"][-1] & r["byz"]).sum()),
             other_honest_filtered=int((~r["alive"][:, honest]).any(dim=0).sum()),
             xi_finite=bool(r["xi_finite"].all()))
        require(bool(r["xi_finite"].all()), f"{fault} {name}: ξ finite at every step")
        require(not bool((r["alive"] & r["poisoned"]).any()),
                f"{fault} {name}: every row holding a non-finite entry dead at that step")
        if fault in ("nan_rows", "inf_rows"):
            require(not bool(r["alive"][FAULT_START:, r["victims"]].any()),
                    f"{fault} {name}: every victim dead from its first fault step on")
            require(not bool((r["alive"][-1] & r["byz"]).any()),
                    f"{fault} {name}: every Byzantine worker filtered")
            require(bool(r["alive"][:, honest].all()),
                    f"{fault} {name}: no other honest worker filtered")
    for fused, dense in (("fused@f32", "dense@f32"), ("fused@bf16", "dense@bf16")):
        same = torch.equal(runs[fused]["alive"], runs[dense]["alive"])
        same_count = torch.equal(runs[fused]["poisoned"].sum(dim=1),
                                 runs[dense]["poisoned"].sum(dim=1))
        emit("quarantine", fault=fault, compare=f"{fused} vs {dense}",
             decisions_equal=same, n_nonfinite_equal=same_count)
        require(same, f"{fault}: {fused} decisions equal {dense}'s at every step")
        require(same_count, f"{fault}: {fused} and {dense} see the same poisoned rows")


def quarantine(dev) -> None:
    problem = make_generated_problem(d=D, seed=0, device=dev)
    for fault, plan in FAULT_PLANS.items():
        runs = {}
        for name, backend, sd in GUARD_RUNS:
            cfg = SolverConfig(**QUARANTINE_BASE, m=M, T=QUARANTINE_STEPS,
                               guard_backend=backend, stats_dtype=sd)
            torch.cuda.synchronize()
            reset_counts()
            runs[name] = guard_loop(problem, cfg, plan, dev)
            got = read_counts()
            want = (counts(fused_guard_sanitize=QUARANTINE_STEPS,
                           filtered_mean_sanitize=QUARANTINE_STEPS)
                    if backend == "fused" else counts())
            require(got == want, f"{fault} {name}: launches {got}, expected {want}")
        quarantine_checks(fault, runs)


def poisoned_batch(problem, m: int, dev) -> tuple[torch.Tensor, list]:
    """One honest batch at x1 with 4 NaN rows and 1 +Inf row."""
    grads = problem.stoch_grad(prng.split(prng.PRNGKey(3, device=dev), m), problem.x1)
    bad = [0, m // 4 + 1, m // 2 + 1, m - 2, m - 1]
    grads[bad[:4]] = float("nan")
    grads[bad[4]] = float("inf")
    return grads, bad


# every rule of the registry, bucket2:krum and the guard, one sanitized step
QUARANTINE_RULES = ([(name, "fused") for name in aggregators.aggregator_names()]
                    + [("bucket2:krum", "fused"), ("byzantine_sgd", "fused"),
                       ("byzantine_sgd", "dense")])


def sanitized_step(problem, name: str, backend: str, m: int, dev):
    cfg = SolverConfig(m=m, T=1, eta=0.05, alpha=0.25, aggregator=name, attack="none",
                       guard_backend=backend, sanitize="quarantine")
    grads, bad = poisoned_batch(problem, m, dev)
    state, step = make_aggregator(problem, cfg, dev)
    _, xi, n_alive, alive = step(state, grads, problem.x1, problem.x1)
    return xi, int(n_alive), alive, bad


def quarantine_baselines(dev) -> None:
    problem = make_generated_problem(d=D, seed=0, device=dev)
    for name, backend in QUARANTINE_RULES:
        torch.cuda.synchronize()
        reset_counts()
        xi, n_alive, alive, bad = sanitized_step(problem, name, backend, M, dev)
        torch.cuda.synchronize()
        got = read_counts()
        if name == "byzantine_sgd":
            want = counts(fused_guard_sanitize=1, filtered_mean_sanitize=1) if (
                backend == "fused") else counts()
        else:
            want = expected_counts(name, 1)
        finite = bool(torch.isfinite(xi).all())
        dead = not bool(alive[bad].any())
        emit("quarantine_baselines", run=f"{name}@{backend}" if name == "byzantine_sgd" else name,
             xi_finite=finite, poisoned_rows_dead=dead, n_alive=n_alive, launches=got)
        require(finite, f"{name}: ξ finite over a poisoned batch")
        require(dead, f"{name}: the 5 poisoned rows reported dead")
        require(n_alive == M - len(bad), f"{name}: n_alive {n_alive} == {M - len(bad)}")
        require(got == want, f"{name}: launches {got}, expected {want}")


def quarantine_reference(dev) -> None:
    """The quarantine loop and the sanitized baseline step on the card
    against the CPU's plain versions on a small input."""
    m, d = 8, 4099
    for fault, plan in FAULT_PLANS.items():
        for name, backend, sd in GUARD_RUNS[:2]:
            cfg = SolverConfig(**QUARANTINE_BASE, m=m, T=16, guard_backend=backend,
                               stats_dtype=sd)
            got = guard_loop(make_generated_problem(d=d, seed=3, device=dev), cfg, plan, dev)
            want = guard_loop(make_generated_problem(d=d, seed=3, device="cpu"), cfg, plan,
                                  "cpu")
            same = torch.equal(got["alive"], want["alive"])
            err = rel_err(got["x_avg"], want["x_avg"])
            emit("quarantine_reference", fault=fault, run=name, decisions_equal=same,
                 x_avg_rel_abs=err, n_alive_last=int(got["alive"][-1].sum()))
            require(same, f"{fault} {name}: card and CPU decisions equal")
            require(within(got["x_avg"], want["x_avg"], 1e-5),
                    f"{fault} {name}: card and CPU x_avg within 1e-5")
    problem = make_generated_problem(d=d, seed=3, device=dev)
    problem_cpu = make_generated_problem(d=d, seed=3, device="cpu")
    for name, backend in QUARANTINE_RULES:
        xi, n_alive, alive, _ = sanitized_step(problem, name, backend, m, dev)
        xi_cpu, n_alive_cpu, alive_cpu, _ = sanitized_step(problem_cpu, name, backend, m, "cpu")
        same = n_alive == n_alive_cpu and torch.equal(alive.cpu(), alive_cpu)
        err = rel_err(xi.cpu(), xi_cpu)
        emit("quarantine_reference", run=name, backend=backend, decisions_equal=same,
             xi_rel_abs=err)
        require(same, f"{name}: card and CPU decisions equal on the poisoned batch")
        require(within(xi.cpu(), xi_cpu, 1e-5), f"{name}: card and CPU ξ within 1e-5")


# ---------------------------------------------------------------- phase 7

SKETCH_K = 4096   # the dp guards' default sketch_dim
# (m, d, k, dtype, salt): the main path's shape, k not dividing d, k > d (the
# reference's default at tiny d), a small strided fold, m·d > 2^31
SKETCH_CASES = [(M, D, SKETCH_K, "f32", 0), (M, D, SKETCH_K, "bf16", 0),
                (M, D, SKETCH_K, "f32", 7), (17, 555, 8, "f32", 0), (17, 555, 8, "bf16", 7),
                (16, 16, SKETCH_K, "f32", 7), (16, 16, SKETCH_K, "bf16", 0),
                (8, 4099, 64, "f32", 7), (8, 4099, 64, "bf16", 0),
                (M, 2 ** 26 + 3, SKETCH_K, "bf16", 7)]
DP_RUNS = [
    ("dp_exact@f32", dict(guard_backend="dp_exact", stats_dtype="f32")),
    ("dp_exact@bf16", dict(guard_backend="dp_exact", stats_dtype="bf16")),
    ("dp_sketch@f32", dict(guard_backend="dp_sketch", stats_dtype="f32")),
    ("dp_sketch@bf16", dict(guard_backend="dp_sketch", stats_dtype="bf16")),
    ("dp_exact@f32,auto_v=False", dict(guard_backend="dp_exact", stats_dtype="f32",
                                       guard_opts=(("auto_v", False),))),
]


def dp_counts(backend: str, steps: int) -> dict:
    """The launch counts of a ``steps``-step run of a dp guard backend."""
    if backend == "dp_sketch":
        return counts(countsketch=steps, filtered_mean=steps)
    return counts(filtered_mean=steps)


def check_countsketch(dev, errs: dict) -> None:
    """countsketch against its plain version, and its signs against
    ``sketch_sign``; adds the errors at the main-path shape to ``errs``."""
    for m, d, k, dt, salt in SKETCH_CASES:
        gen = torch.Generator(device=dev).manual_seed(m * 7411 + d + k + salt)
        x = torch.randn(m, d, device=dev, generator=gen, dtype=DTYPES[dt])
        got = countsketch_cuda(x, k, salt)
        torch.cuda.synchronize()
        want = ref.countsketch_ref(x, k, salt)
        err = rel_err(got, want)
        emit("dp", check="countsketch", m=m, d=d, k=k, dtype=dt, salt=salt, rel_abs=err,
             tol=TOL[dt])
        require(got.shape == (m, k) and within(got, want, TOL[dt]),
                f"countsketch within {TOL[dt]} at m={m} d={d} k={k} {dt} salt={salt}")
        if (m, d, k, salt) == (M, D, SKETCH_K, 0):
            errs[("countsketch", dt)] = err[1]
        del x, got, want
        torch.cuda.empty_cache()
    n = D + 3
    for salt in (0, 7):
        signs = countsketch_cuda(torch.ones(1, n, device=dev), n, salt)[0]
        same = torch.equal(signs, ref.sketch_sign(n, salt, dev))
        emit("dp", check="countsketch_signs", n=n, salt=salt, bit_equal=same)
        require(same, f"countsketch signs bit-equal to sketch_sign, salt={salt}")


def dp_main_path(dev) -> dict:
    """The dp backends through ``run_sgd`` at the main path's shape; returns
    their launch counts."""
    problem = make_generated_problem(d=D, seed=0, device=dev)
    launches = {}
    for name, over in DP_RUNS:
        cfg = SolverConfig(**{**BASE, **over})
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = run_sgd(problem, cfg, prng.PRNGKey(0), device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = launches[name] = read_counts()
        finite = bool(torch.isfinite(res.x_avg).all() and torch.isfinite(res.gaps).all())
        emit("dp", run=name, ms_per_step=1e3 * seconds / T, final_gap=float(res.gaps[-1]),
             gap_at_x_avg=float(problem.f(res.x_avg)), n_alive_first=int(res.n_alive[0]),
             n_alive_last=int(res.n_alive[-1]),
             byzantine_alive=int((res.final_alive & res.byz_mask).sum()),
             ever_filtered_good=bool(res.ever_filtered_good), launches=got, finite=finite)
        require(finite, f"{name}: finite x_avg and gaps")
        require(res.x_avg.shape == (D,) and res.gaps.shape == (T,), f"{name}: shapes")
        want = dp_counts(over["guard_backend"], T)
        require(got == want, f"{name}: launches {got}, expected {want}")
    return launches


def dp_oracle(dev) -> None:
    """dp_exact with auto_v=False against the dense oracle, step by step."""
    problem = make_generated_problem(d=D, seed=0, device=dev)
    cfg = SolverConfig(**{**BASE, "guard_backend": "dense"})
    series = {}
    for name, over in (("dense@f32", {}),
                       ("dp_exact@f32,auto_v=False", dict(guard_backend="dp_exact",
                                                          guard_opts=(("auto_v", False),)))):
        torch.cuda.synchronize()
        reset_counts()
        series[name] = guard_loop(problem, cfg._replace(**over), None, dev)
        got = read_counts()
        want = counts() if name == "dense@f32" else dp_counts("dp_exact", T)
        require(got == want, f"{name} step loop: launches {got}, expected {want}")
    dense, dp = series["dense@f32"]["alive"], series["dp_exact@f32,auto_v=False"]["alive"]
    same = torch.equal(dense, dp)
    emit("dp", check="oracle", steps=T, decisions_equal_at_every_step=same,
         n_alive_last=int(dp[-1].sum()), x_avg_rel_abs=rel_err(
             series["dp_exact@f32,auto_v=False"]["x_avg"], series["dense@f32"]["x_avg"]))
    require(same, "dp_exact(auto_v=False) decisions equal dense@f32's at every step")


def dp_quarantine(dev) -> None:
    """Both dp backends with sanitize="quarantine" under nan_rows."""
    problem = make_generated_problem(d=D, seed=0, device=dev)
    plan = FAULT_PLANS["nan_rows"]
    for backend in ("dp_exact", "dp_sketch"):
        cfg = SolverConfig(**QUARANTINE_BASE, m=M, T=QUARANTINE_STEPS, guard_backend=backend)
        torch.cuda.synchronize()
        reset_counts()
        r = guard_loop(problem, cfg, plan, dev)
        got = read_counts()
        n_alive = r["alive"].sum(dim=1).tolist()
        honest = ~r["byz"] & ~r["victims"]
        emit("dp", check="quarantine", fault="nan_rows", run=f"{backend}@f32",
             n_alive_at={k: n_alive[k] for k in (0, FAULT_START - 1, FAULT_START,
                                                 len(n_alive) - 1)},
             n_poisoned_rows=int(r["poisoned"].sum()),
             victims_alive_after_start=int(r["alive"][FAULT_START:, r["victims"]].sum()),
             byzantine_alive_last=int((r["alive"][-1] & r["byz"]).sum()),
             other_honest_filtered=int((~r["alive"][:, honest]).any(dim=0).sum()),
             xi_finite=bool(r["xi_finite"].all()), launches=got)
        require(bool(r["xi_finite"].all()), f"nan_rows {backend}: ξ finite at every step")
        require(not bool(r["alive"][FAULT_START:, r["victims"]].any()),
                f"nan_rows {backend}: every victim dead from step {FAULT_START} on")
        require(not bool((r["alive"] & r["poisoned"]).any()),
                f"nan_rows {backend}: every poisoned row dead at that step")
        want = dp_counts(backend, QUARANTINE_STEPS)
        require(got == want, f"nan_rows {backend}: launches {got}, expected {want}")


def dp_reference(dev) -> None:
    """Both dp backends on the card against the CPU's plain versions."""
    for backend in ("dp_exact", "dp_sketch"):
        kw = dict(m=8, T=70, eta=0.05, alpha=0.25, attack="sign_flip",
                  aggregator="byzantine_sgd", guard_backend=backend)
        got = run_sgd(make_generated_problem(d=4099, seed=1, device=dev), SolverConfig(**kw),
                      prng.PRNGKey(1), device=dev)
        want = run_sgd(make_generated_problem(d=4099, seed=1, device="cpu"),
                       SolverConfig(**kw), prng.PRNGKey(1), device="cpu")
        same = torch.equal(got.n_alive.cpu(), want.n_alive) and torch.equal(
            got.final_alive.cpu(), want.final_alive)
        err = rel_err(got.x_avg.cpu(), want.x_avg)
        emit("dp", check="reference", run=f"{backend}@f32", decisions_equal=same,
             x_avg_rel_abs=err, n_alive_last=int(got.n_alive[-1]))
        require(same, f"{backend}: card and CPU decisions equal on the small input")
        require(within(got.x_avg.cpu(), want.x_avg, 1e-5),
                f"{backend}: card and CPU x_avg within 1e-5")


# ---------------------------------------------------------------- phase 8

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


def bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """The least time the card could take, in ms: the larger of the bytes
    over the HBM rate and the operations over ``peak`` (per second)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_kernels(dev, errs, launches, base_launches, q_launches, dp_launches) -> list:
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
        b_ms, b_by = bound(fg_bytes, fg_flops, PEAK_FLOPS[dt])
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
        b_ms, b_by = bound(fm_bytes, fm_flops, PEAK_FLOPS[dt])
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

        gr_bytes = M * D * e + M * M * 4
        gr_flops = 2 * M * M * D
        b_ms, b_by = bound(gr_bytes, gr_flops, PEAK_FLOPS[dt])
        entries.append({
            "name": f"gram[{dt}]", "route": "cuda",
            "source": KERNELS["gram"][0], "replaces": KERNELS["gram"][1],
            "launches": base_launches[("krum", "sign_flip")]["gram"],
            "max_abs_err": errs[("gram", dt)],
            "ms": median_ms(lambda: gram_cuda(g)),
            "plain_ms": median_ms(lambda: ref.gram_ref(g)),
            "bound_ms": b_ms, "bound_by": b_by,
            # one library call, x @ xᵀ in the input dtype (TF32 off): a yardstick only
            "library_ms": median_ms(lambda: g @ g.T),
        })
        emit("bound", kernel=f"gram[{dt}]", shape=[M, D], bytes=gr_bytes, flops=gr_flops)
        # the sort network's m(m-1)/2 compare-exchanges, two min/max each, on
        # f32 CUDA cores whatever the input type (no tensor-core min/max)
        os_bytes = M * D * e + D * 4
        os_ops = M * (M - 1) * D
        b_ms, b_by = bound(os_bytes, os_ops, PEAK_FLOPS["f32"])
        order_stats = (("coordinate_median", lambda: coordinate_median_cuda(g),
                        lambda: ref.coordinate_median_ref(g)),
                       ("trimmed_mean", lambda: trimmed_mean_cuda(g, N_TRIM),
                        lambda: ref.trimmed_mean_ref(g, N_TRIM)))
        lib_sort = median_ms(lambda: torch.sort(g, dim=0))
        for name, kernel, plain in order_stats:
            entries.append({
                "name": f"{name}[{dt}]", "route": "cuda",
                "source": KERNELS[name][0], "replaces": KERNELS[name][1],
                "launches": base_launches[(name, "sign_flip")][name],
                "max_abs_err": errs[(name, dt)],
                "ms": median_ms(kernel), "plain_ms": median_ms(plain),
                "bound_ms": b_ms, "bound_by": b_by,
                # one library call, torch.sort(x, dim=0): the sort both reduce
                # from (torch.quantile refuses inputs over 2^24 elements)
                "library_ms": lib_sort,
            })
            emit("bound", kernel=f"{name}[{dt}]", shape=[M, D], bytes=os_bytes,
                 min_max_ops=os_ops)
        # the sanitizing variants on input holding 4 non-finite rows; the
        # bytes are the plain variants' (plus nf), the operations add one
        # finiteness test per entry
        gp = poison(g.clone())
        sg_bytes, sg_ops = fg_bytes + M * 4, fg_flops + M * D
        b_ms, b_by = bound(sg_bytes, sg_ops, PEAK_FLOPS[dt])
        entries.append({
            "name": f"fused_guard_sanitize[{dt}]", "route": "cuda",
            "source": KERNELS["fused_guard_sanitize"][0],
            "replaces": KERNELS["fused_guard_sanitize"][1],
            "launches": q_launches[run]["fused_guard_sanitize"],
            "max_abs_err": errs[("fused_guard_sanitize", dt)],
            "ms": median_ms(lambda: fused_guard_cuda(gp, B, dlt, sanitize=True)),
            "plain_ms": median_ms(lambda: ref.fused_guard_sanitize_ref(gp, B, dlt)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        emit("bound", kernel=f"fused_guard_sanitize[{dt}]", shape=[M, D], bytes=sg_bytes,
             flops=sg_ops)
        sm_ops = fm_flops + M * D
        b_ms, b_by = bound(fm_bytes, sm_ops, PEAK_FLOPS[dt])
        entries.append({
            "name": f"filtered_mean_sanitize[{dt}]", "route": "cuda",
            "source": KERNELS["filtered_mean_sanitize"][0],
            "replaces": KERNELS["filtered_mean_sanitize"][1],
            "launches": q_launches[run]["filtered_mean_sanitize"],
            "max_abs_err": errs[("filtered_mean_sanitize", dt)],
            "ms": median_ms(lambda: filtered_mean_cuda(gp, w, 1.0, sanitize=True)),
            "plain_ms": median_ms(lambda: ref.filtered_mean_sanitize_ref(gp, w, 1.0)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        emit("bound", kernel=f"filtered_mean_sanitize[{dt}]", shape=[M, D], bytes=fm_bytes,
             flops=sm_ops)
        # one read of x, one write of the (m, k) f32 sketch; a sign and an add
        # per entry on f32 CUDA cores whatever the input type
        cs_bytes = M * D * e + M * SKETCH_K * 4
        cs_ops = 2 * M * D
        b_ms, b_by = bound(cs_bytes, cs_ops, PEAK_FLOPS["f32"])
        entries.append({
            "name": f"countsketch[{dt}]", "route": "cuda",
            "source": KERNELS["countsketch"][0], "replaces": KERNELS["countsketch"][1],
            "launches": dp_launches[f"dp_sketch@{dt}"]["countsketch"],
            "max_abs_err": errs[("countsketch", dt)],
            "ms": median_ms(lambda: countsketch_cuda(g, SKETCH_K)),
            "plain_ms": median_ms(lambda: ref.countsketch_ref(g, SKETCH_K)),
            "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes a hashed-sign stride fold
            "library_ms": None,
        })
        emit("bound", kernel=f"countsketch[{dt}]", shape=[M, D, SKETCH_K], bytes=cs_bytes,
             flops=cs_ops)
        del g, gp, B, dlt
        torch.cuda.empty_cache()
    return entries


# Threefry-2x32 per generated element: two key adds, then five groups of
# four rounds (add, rotate as shift-shift-or, xor) and a key injection of
# three adds.  Counted at the f32 CUDA-core rate for want of an int32 rate
# in the data sheet's table; integer and float work run on separate units,
# so the least time is the larger of the two, not their sum.
THREEFRY_OPS = 2 + 5 * (4 * 5 + 3)


def gen_bounds() -> None:
    """The bounds of the two generating kernels still to port
    (``fused_guard_gen_pallas``, ``gen_xi_pallas``) at the main path's
    shape, from their operands: nothing is launched."""
    vec_bytes = 4 * D * 4 + M * (2 + 1 + 1) * 4   # x, h, x*, het_dir; keys, skew, slot
    for dt in ("f32", "bf16"):
        e = torch.tensor([], dtype=DTYPES[dt]).element_size()
        # B read and B_new written in the stats dtype, δ, the vectors, both Grams
        # and A; the Grams, A and B + g as in fused_guard, plus the generation
        fg_bytes = 2 * M * D * e + D * e + vec_bytes + (2 * M * M + M) * 4
        gen_ops = THREEFRY_OPS * M * D
        t_ops = max((4 * M * M * D + 3 * M * D) / PEAK_FLOPS[dt], gen_ops / PEAK_FLOPS["f32"])
        t_bytes = fg_bytes / HBM_BYTES_PER_S
        emit("bound", kernel=f"fused_guard_gen[{dt}]", status="to port", shape=[M, D],
             bytes=fg_bytes, threefry_ops=gen_ops, bound_ms=1e3 * max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations")
    # gen_xi: the two weight vectors in, ξ and the Byzantine row sum out; the
    # rows are generated once and each summed twice
    gx_bytes = vec_bytes + 2 * M * 4 + 2 * D * 4
    t_ops = max(THREEFRY_OPS * M * D, 4 * M * D) / PEAK_FLOPS["f32"]
    t_bytes = gx_bytes / HBM_BYTES_PER_S
    emit("bound", kernel="gen_xi", status="to port", shape=[M, D], bytes=gx_bytes,
         threefry_ops=THREEFRY_OPS * M * D, bound_ms=1e3 * max(t_bytes, t_ops),
         bound_by="bytes" if t_bytes >= t_ops else "operations")


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
    check_order_kernels(dev, errs)
    check_sanitize_kernels(dev, errs)
    launches, off = main_path(dev)
    q_launches = quarantine_main_path(dev, off)
    small_reference(dev)
    base_launches = baselines(dev)
    baselines_reference(dev)
    quarantine(dev)
    quarantine_baselines(dev)
    quarantine_reference(dev)
    check_countsketch(dev, errs)
    dp_launches = dp_main_path(dev)
    dp_oracle(dev)
    dp_quarantine(dev)
    dp_reference(dev)
    entries = time_kernels(dev, errs, launches, base_launches, q_launches, dp_launches)
    require(len(entries) == 2 * len(KERNELS), f"{len(entries)} kernel entries")
    gen_bounds()
    step_split(dev)

    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
