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
   each kernel's registers and spills; the order statistics' register
   path (m ≤ 32): its sort network's size (``rt_sort_network``, the
   kernels' own constexpr evaluated on the host) is Batcher's at every
   power of two up to 32 (191 comparators at m = 32; 17 and 31 printed
   too), and each of its 128 kernels has no stack frame and no spill; the
   CountSketch's instantiations (dtype × vector or scalar loads × 32- or
   64-bit offsets) print their registers and have no stack frame and no
   spill;
3. kernels — the guard kernels against their plain versions at m=32,
   d=2^20 and m=17, d=555 (f32, bf16) and m=32, d=2^26+3 (bf16, m·d >
   2^31): ``B_new`` bit-equal, the rest within ‖got−want‖ ≤ tol·‖want‖ +
   tol, tol = 1e-5 (f32) / 1e-4 (bf16: both sides sum exact f32 upcasts,
   so only the order of the sums differs), and at d=2^26+3 both sides'
   Grams beside f64 sums of the exact products (reported); then ``gram``,
   ``coordinate_median`` and ``trimmed_mean`` (n_trim = min(8, (m−1)//2))
   at m=32, d=2^20; m=17, d=555; m=16, d=4099; m=32, d=2^26+3, in f32 and
   bf16: the median bit-equal, the rest within the same tol; then the
   sanitizing ``fused_guard`` and ``filtered_mean`` against their plain
   versions at the guard kernels' shapes, on input holding a whole NaN
   row, a ±Inf row and single NaN/Inf entries (one in the last column):
   ``nf`` equal, ``B_new`` bit-equal, the rest within tol; and on finite
   input bit-equal to the plain kernels; then ``small_width_kernels``:
   every kernel of the convex harness's paths (the guard kernels plain and
   sanitizing, ``gram``, the order statistics, ``countsketch`` at k = 4096
   and 8) at m = 16, d = 16 and 10, f32 and bf16, the same way (a bf16
   row of d = 10 is 20 bytes, so rows start off 16-byte boundaries);
4. main path — ``run_sgd`` on ``make_generated_problem(d=2^20, seed=0)``,
   m=32, T=128, α=0.25, ``sign_flip``: ``fused@f32``, ``fused@bf16``,
   ``dense@f32`` and the ``mean`` baseline, each with the launch counts
   set to 0 just before and read just after; then the same run on the
   card and on the CPU at d=4099, m=8, T=70 (decisions equal, values
   within 1e-5); then ``quarantine_main_path``: the three guard runs again
   with ``sanitize="quarantine"``, bit-equal to the runs without it, the
   sanitizing kernels launched T times each and the plain ones never;
5. baselines — the same ``run_sgd`` (T = 64) once per baseline of the
   registry and ``bucket2:krum`` under ``sign_flip``, then krum, coordinate_median and
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
   (f32, bf16; ``launch_plan`` takes the 16-byte vector path there, with
   no scratch), m=17, d=555, k=8; m=16, d=16, k=4096 (k > d); m=8, d=4099,
   k=64; m=33, d=4099, k=63 (scalar loads, a row tile cut short) and
   m=32, d=2^26+3, k=4096 (bf16, m·d > 2^31), salts 0 and 7, within the
   same tol, and its signs bit-equal to ``ref.sketch_sign``;
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
8. gen — ``fused_guard_gen`` and ``gen_xi`` against their plain versions
   at m=32, d=2^20 (f32, bf16) for every attack id the generator takes
   and at m=32, d=2^26+3 (bf16, sign_flip; m·d > 2^31, the plain version
   by column chunks): ``B_new`` bit-equal but for ALIE's ids 4 and 8, the
   rest within tol, and on their own rows materialised ``fused_guard`` and
   ``filtered_mean`` give the same bits, and ``gen_xi`` reading the
   sweep's moments gives its own bits; then ``run_sgd`` at the main
   path's shape under ``scenario_static("sign_flip")`` and
   ``scenario_static("alie")``, f32 and bf16, ``generate="kernel"``
   against ``"off"``: ms/step, peak memory, final gap, n_alive, launches
   (``fused_guard_gen`` and ``gen_xi`` T times on the generating runs and
   nothing else), decisions equal at every step, gaps bit-equal (required
   under sign_flip, reported under ALIE, whose moments sum in another
   order), the generating run's peak memory below the materialising
   run's by at least the (m, d) f32 batch;
   then both attacks' generating runs on the card and on the CPU at
   d=4099, m=8, T=40 (decisions equal, ``x_avg`` within 1e-5);
9. workers — every kernel and variant (the guard kernels plain and
   sanitizing, both generating kernels under sign_flip and ALIE,
   ``gram``, the order statistics, ``countsketch``) against its plain
   version at m = 33, 129, 257, 1000 (d = 4099) and m = MAX_WORKERS =
   12288 (d = 257), f32 and bf16: the median and ``B_new`` bit-equal (but
   ALIE's), two ``gram`` calls bit-equal, the rest within tol; every
   wrapper raises a ValueError naming the cap at m = 12289; then
   ``workers_main_path``: ``run_sgd`` at m = 256, d = 2^18, T = 8 under
   ``scenario_static("sign_flip")`` with the fused guard materialising and
   generating, dense, krum, coordinate_median, trimmed_mean and
   dp_sketch (launches exact, results finite, fused and generating
   n_alive equal to dense at every step, generating gaps bit-equal to
   the materialising ones); then ``gram_main``: two ``gram`` calls at
   m = 32, d = 2^20 give the same bits, and its time beside ``x @ xᵀ``;
10. timing — each kernel's median time at m=32, d=2^20 beside its bound,
   its plain version and one library call where there is one (the
   sanitizing variants on input holding 4 non-finite rows, the generating
   ones on the main path's step-0 operands under sign_flip, and under
   ALIE apart, with gen_xi running its own moments pass and reading the
   sweep's); for each guard sweep (plain, sanitizing, generating; f32 and
   bf16) a ``guard_sweep`` line: two calls give the same bits, the card's
   time in its kernels (``torch.profiler``) and the host's time a call
   beside the median time, the SM clock and power while it runs, and its
   time before the redesign as PERF.md records it (not measured here);
   the same card and host times for each order statistic (an
   ``order_stats`` line; its card time counts only the ``sorted_mean``
   kernels, and every launch must be in the trace); the order statistics'
   bound counts Batcher's
   comparators, two min/max each, at 64 ALU instructions a clock per SM
   (at bf16 one instruction orders two columns), beside the bytes; for
   ``countsketch`` at f32 and bf16 a ``countsketch`` line: two calls give
   the same bits, the card's time in the ``countsketch`` kernels (every
   one of the 20 launches in the trace) and the host's time a call beside
   the median time, and its time before the redesign as PERF.md records
   it; its bound counts one hash (9 integer operations) a coordinate at
   the same ALU rate beside the bytes, and its library call is
   ``torch.einsum`` of x's (m, J, k) view with the (J, k) signs;
   then the split of one materialising and one generating step between
   their parts;
11. profiles and faults — ``run_sgd`` at the main path's shape under
   ``scenario_static("sign_flip")`` with worker profiles: a skewed fleet
   (``heterogenize_generated`` with ``profile_linear_skew(32, 0.5)``) at
   fused@f32 and fused@bf16, ``generate="kernel"`` against ``"off"``
   (decisions equal at every step, gaps bit-equal, launches T each); a
   fleet whose last 8 workers straggle (delay 3, ``max_delay=3``) and
   whose honest workers report with probability 0.75
   (``partial_participation=True``) at fused@f32, fused@bf16 and
   dense@f32 (fused decisions and ``n_reporting`` equal dense's at every
   step, every sign-flipper filtered and no honest worker); the
   degenerate profile, every axis armed, bit-equal to no profile (T =
   32); ms/step and peak memory of each run; then ``fault_main_path``:
   each fault plan of phase 6 on the adversary through ``run_sgd`` with
   ``sanitize="quarantine"`` at fused@f32 (the n_alive series equal to
   phase 6's loop step for step, every victim in ``byz_mask``, the
   sanitizing kernels T times each); then ``profile_reference``: the
   skewed (both paths), straggling and partial runs on the card against
   the CPU at d=4099, m=8, T=40 (decisions equal, ``x_avg`` within 1e-5);
12. random_gaussian_main_path (after ``step_split``) — ``run_sgd`` at
   the main path's shape (T = 32) under ``scenario_static("random_gaussian")``:
   fused@f32 and fused@bf16 decide as dense@f32 at every step, every
   attacker filtered and no honest worker, ms/step and peak memory;
   ``generate="kernel"`` refuses id 2 with the reference's ValueError;
12b. campaign_main_path — ``run_campaign`` at the main path's width
   (m=32, d=2^20, T=16, α=0.25): static and churning sign_flip × seeds
   0–3, two groups of R = 4 runs on one run axis, for the fused guard at
   f32 and bf16, the dense guard, krum and coordinate_median: each kernel
   launched exactly T times a group (not T·R); one row of each group
   against its ``run_sgd`` alone (decisions equal, gaps within 1e-6
   relative, whether bit-equal printed), ms a batched step against R × a
   step alone, peak memory; fused deciding as dense on every row; 8 runs
   at chunk_size 2 within 1.25 × a 2-run campaign's peak; then
   ``campaign_kernels``: one batched launch of each run-axis kernel at
   R = 4 (fused_guard, filtered_mean, gram; the folded coordinate_median
   and countsketch) against 4 launches alone, bit-equal, with the folding
   copy's time, and one batched bf16 fused_guard and filtered_mean launch
   with R·m·d > 2^31 against the plain versions (``B_new`` bit-equal);
12c. gen_campaign_kernels — ``fused_guard_gen`` (f32, bf16 sweeps) and
   ``gen_xi`` (f32 and bf16 statistics, reading the batched sweep's
   moments) over a run axis at R = 4, m = 32, d = 2^20, on the main
   path's step-0 operands of seeds 0–3 under sign_flip and ALIE: each
   run's outputs (and, under ALIE, moments) bit-equal to its own one-run
   launch, the batched ms against 4 launches; one bf16 launch with R·m·d
   > 2^31 (d = 2^24 + 3) bit-equal to its runs' own launches;
   campaign_gen_main_path — campaign_main_path's grid with the ``gen`` and
   ``gen@bf16`` variants: ``fused_guard_gen`` and ``gen_xi`` launched
   exactly T times a group and no materialising guard kernel, every row
   deciding as the ``fused`` (``fused@bf16``) row with ``gap_final``
   within 1e-6, the peak memory below the materialising variant's by at
   least R × the (m, d) f32 batch, ms a batched step against R × one
   generating step alone; then the kernels line's run-axis entries
   (R = 4 runs against the plain versions within tol);
12d. telemetry — ``run_sgd`` at the main path's shape (T = 32, the Gram
   re-derived every 16 steps) with the flight recorder armed against off,
   for fused@f32, fused@bf16, gen, dense, krum, dp_sketch and fused under
   ``sanitize="quarantine"``: bits and launch counts equal, ``gram_drift``
   finite at the resync steps and NaN between (0 at every step on dense,
   NaN on the others), ms a step armed against off; the same runs armed on
   the card and on the CPU at d = 4099, m = 8, T = 70 (``alive``,
   ``n_alive``, ``step`` and the first-filter and survival series equal,
   the rest within tol); one armed campaign (fused and gen, d = 2^16)
   through ``campaign_trace_events`` into an ``EventLog``, its JSONL and
   Chrome trace written under ``build/telemetry/`` and read back; the
   guard step alone (fused, dense, gen at f32 and bf16) against
   guard_cost's H100 bytes figure (``roofline_rows``);
12e. bitflip_campaign — a campaign with a ``bitflip`` fault axis on the
   card's torch (sanitize on, m = 32, d = 4099, T = 16): every row decides
   as its run alone, and the flip under ``vmap`` is bit-equal to each
   run's own;
13. the convex harness, after every phase above.  ``convex_step_alone``:
   with nothing else on the card or the host, STEP_ALONE_T (100) steps of each of
   mean, krum, coordinate_median, the dense, fused and dp_sketch guards
   (quickstart's problem) and the logistic run, and a campaign step of
   the fused guard over Table 1's 5 seeds on one run axis (against 5 ×
   the fused step alone), in a fresh process on
   the card and then on the CPU (one thread), and on the card in this
   process: ms/step of each; then the lower bound's experiments on the
   card.  ``convex_pool``: the full-length runs below, and Table 1's,
   on the card, then the same runs on the CPU, in a pool of
   POOL_PROCESSES processes that share the card and the host (their
   steps are host-bound, ~1200 tiny launches at d = 16; no time is read
   from them but each run's seconds); each card run with the launch
   counts set to 0 just before it and read just after.  The phase lines
   print once the results are in:
   quickstart — ``examples/quickstart.py``:
   ``make_quadratic_problem(d=16, σ=1, L=8, V=1)`` (sphere noise from
   ``prng.normal``), m = 16, α = 0.25, ``PRNGKey(0)``: mean, krum,
   coordinate_median and byzantine_sgd (fused guard) under sign_flip at T
   = 2000, the dense, fused and dp_sketch guards at T = 500, hidden_shift
   at T = 2000; each run's launches exact, its decisions equal to the same
   run on the CPU at every step and its final gap within 1e-3 relative of
   it; mean's gap above 0.1, the guard 12/16 alive with no honest worker
   filtered, the three backends deciding alike at every step;
14. detection_latency — ``bench_filtering.bench_detection_latency``'s
   loop (fused guard): per attack (sign_flip, random_gaussian, alie,
   constant_drift, inner_product, hidden_shift; the first and last are
   quickstart's runs) the first step the alive count reaches m − n_byz,
   the final alive count, whether an honest worker was filtered and the
   gap; each below 2e-2 with no honest worker filtered, deciding as its
   CPU run;
15. convex_harness — least squares (d = 16) and logistic regression (d =
   10, n = 256, reg 1e-2, seed 2) under sign_flip through the fused guard
   at T = 2000 (gap below 3·αDV/√T, no honest worker filtered, decisions
   as the CPU's); ``solve_strongly_convex`` on the seed-1 quadratic (ε
   2e-3, t_scale 0.05, 2000 steps an epoch at most, cut from the
   reference test's 4000 (PERF.md §4); last gap below
   5e-3); both distinguishing experiments at m = 16, α = 0.3, 48 trials,
   T = 2 and 1024 (success as the CPU's, below 0.75 and above 0.9);
16. table1 — ``repro_torch.experiments.table1`` (``benchmarks/
   bench_table1.py``'s Table 1, quadratic d = 16, ε = 2e-2, 5 seeds on one
   run axis): the α = 0.25 section (mean, byzantine_sgd, coordinate_median,
   krum, trimmed_mean) at T = 4000, one pool task a variant (every gap
   finite, the guard reaching ε on every seed with no honest worker
   filtered); the same section at T = 500 on the card and on the CPU
   (iterations-to-ε and decisions equal, gaps within 1e-3 relative); the
   α = 0, 0.125 and 0.375, backend and m sections at TABLE1_OTHER_T
   (``T_reduced_from`` 4000); each part's kernels launched T times, once
   a step for its group;
17. lm_train_launcher — ``repro_torch.launch.train.run_training`` of
   internlm2-1.8b at its reduced width (d_model 128, 2 layers, vocab
   512), W = 8, seq 64, 40 steps, dp_exact, sign_flip, on the card and
   then on the CPU: ``filtered_mean`` launched once a step and nothing
   else, decisions equal to the CPU's at every step, losses within 1e-4
   relative over the first 10 steps and 1e-3 over all 40 (AdamW
   amplifies f32 rounding: the JAX package and the port on one CPU part
   by 3.3e-4 at step 36), n_alive 6 at the end;
18. lm_train_full_width — the LM trainer at internlm2-1.8b's published
   widths cut to 2 layers (d = 504,899,584 parameters, bf16), W = 8, α =
   0.25, sign_flip, per-worker batch 2, seq 128, AdamW, T = 20 steps (40
   on dp_sketch, whose V is widened 1.5×: one attacker outlives step 20),
   built as ``run_training`` builds it (``build_model``,
   ``init_train_state``, ``build_train_step``, ``make_worker_batch``):
   ``dp_exact@bf16``, ``dp_sketch@bf16``, ``fused@bf16`` (V the step-0
   v_est of dp_exact@bf16) and ``dp_exact@f32`` where its peak, reckoned
   from the code's allocations and printed first, is at most
   LM_PEAK_LIMIT_GB: every kernel of the run launched exactly T times
   and no other, no honest worker filtered at any step, no Byzantine
   worker alive at the end, the loss falling; step 0's operands of each
   launched kernel held against its plain version by column blocks, with
   the kernel's and the plain version's ms beside the bound; ms a step
   split by CUDA events into forward/backward, ravel, attack, guard and
   optimizer, and the peak memory;
19. lm_checkpoint — ``run_training`` at phase 17's width (40 steps) on
   dp_exact@f32 and fused@bf16 (V the dp_exact run's step-0 v_est; the
   guard's B a bf16 leaf): uninterrupted, then stopped after 20 steps
   with ``ckpt_dir`` and resumed — the final state bit-equal leaf by leaf
   and the history equal, each kernel of the run 40 times over the two
   halves; save and restore seconds and the file's MB; the card's
   checkpoint restored on the CPU and a CPU-written one on the card, bit
   for bit, each on its template's device; the newest file truncated
   (skipped: no complete unit) and then silently corrupted (quarantined),
   restore falling back to step 20;
20. lm_train_campaign — ``run_train_campaign`` of internlm2-1.8b at that
   width (per-worker batch 1, W = 8, α = 0.25, T = 10) over static and
   churning sign_flip × 2 seeds (2 groups of 2 rows) for
   byzantine_sgd@dp_exact, @dp_sketch, @fused and @fused@bf16 (V a
   dp_exact step's v_est) and mean, each with the counts set to 0 just
   before it: each kernel T times a group; every row deciding as its run
   alone with losses within 1e-5; the CPU's campaign deciding alike
   (losses within 1e-4); no honest worker filtered by a guard; the
   batched seconds against the rows run alone;
21. lm_serve_full_width — ``launch.serve.run_serving(reduced=False)``:
   internlm2-1.8b at all 24 layers and every published width (1.89·10⁹
   bf16 parameters from PRNGKey(0)), batch 4, prompt 64, 32 tokens,
   cache 256: no guard kernel launched, prefill ms, ms a token, tokens/s,
   peak GB, its logits against a teacher-forced forward (printed; the
   reference's init leaves 24 layers of near one-hot attention, which
   decorrelates two orders of the same sums); the same weights with the
   attention projections rescaled to their fan-in, in bf16 and f32,
   through ``generate``: every position within 5e-2 / 1e-5 of the
   teacher-forced forward; then at the reduced width the card's greedy
   tokens equal to the CPU's for the plain cache, the int8 cache and a
   starcoder2-3b window-32 ring that wraps (prompt 16, 40 steps);
22. lm_train_ssm_full_width — mamba2-130m at every published width and
   all 24 layers (d = 167,573,952), W = 8, α = 0.25, sign_flip,
   per-worker batch 2 × 256 tokens (one published SSD chunk), T = 20, on
   ``dp_sketch@bf16`` and ``fused@bf16``: each guard kernel of the path
   launched T times and held to its plain version at that d, both
   attackers filtered and no honest worker, every worker's gradient
   finite at every step (the SSD mask of ``models/ssm.py``); ms a phase,
   peak GB against a reckoning;
23. moe_ssm_reduced — kimi-k2 and jamba at their reduced widths through
   ``launch.train.run_training`` on the card and on the CPU (decisions
   equal, losses within the launcher's drift), and the greedy tokens of
   the reduced kimi-k2, jamba and mamba2-130m, the card's equal to the
   CPU's;
24. lm_serve_moe_full_width, lm_serve_hybrid_full_width — kimi-k2 (2
   layers: the dense first and one of 384 experts, top 8, a shared one)
   and jamba (8 layers, one period) at every published width, bf16,
   weights drawn once each: ``generate`` at serving's sizes, no guard
   kernel launched; init seconds, prefill ms, ms a token against every
   weight read once, tokens/s, peak GB, the share of prefill's choices
   dropped at the published capacity_factor; then the same weights with
   the attention rescaled and C = T (capacity_factor = E) against a
   teacher-forced forward: at most ROUTE_DIFF_BOUND of the positions
   routed apart, and at the positions whose routes (and those a later
   mixer carries in) agree within 5e-2 (kimi-k2) or SSM_SERVE_LOGIT_RTOL
   (jamba, whose Mamba layers amplify rounding), and jamba again on f32
   weights, where no route flips and every position is held;
25. lm_serve_ssm_full_width — ``run_serving(reduced=False)`` of
   mamba2-130m (its whole published configuration): ms a token against
   its bound, and its logits against the teacher-forced forward in bf16
   and f32 (0.25 / 1e-4 at every position, SSM_SERVE_LOGIT_RTOL);
26. the script's total seconds, the kernels line (24 entries: twelve
   kernels, the generating two over a run axis among them, × f32/bf16;
   each also with ``lm_train_launches``, its launches in phases 17–18,
   ``lm_checkpoint_launches`` and ``lm_train_campaign_launches``, its
   launches in phases 19 and 20, and ``lm_moe_ssm_launches``, in phases
   22–23), the card line and the result line.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import gc
import json
import math
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

# before torch reaches the card: the full-width LM runs (phase 18) allocate
# and free (8, d) blocks of 8–16 GB, which fragment the fixed segments of
# the default allocator past the card's 80 GB
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import prng  # noqa: E402
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tree_harness import params_harness  # noqa: E402
from repro_torch.data.synthetic import SyntheticTokens, make_worker_batch  # noqa: E402
from repro_torch.distributed.trainer import build_train_step, init_train_state  # noqa: E402
from repro_torch.launch.serve import generate, run_serving  # noqa: E402
from repro_torch.launch.train import fetch_metrics, run_training  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.model import _lm_head  # noqa: E402
from repro_torch.optim import adamw, linear_warmup_cosine  # noqa: E402
from repro_torch.core import aggregators, attacks  # noqa: E402
from repro_torch.core.attacks import alie_z_max  # noqa: E402
from repro_torch.core.epoch_solver import EpochSolverConfig, solve_strongly_convex  # noqa: E402
from repro_torch.core.guard_backends import make_guard_backend  # noqa: E402
from repro_torch.core.lower_bound import (  # noqa: E402
    distinguishing_experiment_linear,
    distinguishing_experiment_strongly_convex,
)
from repro_torch.core.solver import (  # noqa: E402
    SolverConfig,
    byz_rank,
    make_aggregator,
    run_sgd,
)
from repro_torch.data.problems import (  # noqa: E402
    heterogenize_generated,
    make_generated_problem,
    make_least_squares_problem,
    make_logistic_problem,
    make_quadratic_problem,
)
from repro_torch.kernels import _build, gradgen, ops, ref  # noqa: E402
from repro_torch.kernels.countsketch import countsketch_cuda, launch_plan  # noqa: E402
from repro_torch.kernels.fused_guard import (  # noqa: E402
    MAX_WORKERS,
    fused_guard_cuda,
    fused_guard_gen_cuda,
    gen_xi_cuda,
)
from repro_torch.kernels.pairdist import gram_cuda  # noqa: E402
from repro_torch.kernels.robust_reduce import (  # noqa: E402
    coordinate_median_cuda,
    filtered_mean_cuda,
    trimmed_mean_cuda,
)
from repro_torch.experiments import table1  # noqa: E402
from repro_torch.kernels.countsketch import countsketch_runs_cuda  # noqa: E402
from repro_torch.kernels.fused_guard import (  # noqa: E402
    fused_guard_gen_runs_cuda,
    fused_guard_runs_cuda,
    gen_xi_runs_cuda,
)
from repro_torch.obs import EventLog, TelemetryConfig, ring_read, roofline_rows  # noqa: E402
from repro_torch.roofline import guard_cost  # noqa: E402
from repro_torch.kernels.pairdist import gram_runs_cuda  # noqa: E402
from repro_torch.kernels.robust_reduce import (  # noqa: E402
    coordinate_median_runs_cuda,
    filtered_mean_runs_cuda,
    fold_runs,
)
from repro_torch.scenarios import (  # noqa: E402
    ScenarioAdversary,
    expand_grid,
    faults,
    profile_iid,
    profile_linear_skew,
    run_campaign,
    scenario_churn,
    scenario_static,
    worker_profile,
)
from repro_torch.scenarios.campaign import _summarize, expand_variants, run_groups  # noqa: E402
from repro_torch.scenarios.train_campaign import run_train_campaign  # noqa: E402
from repro_torch.utils import tree_flatten_with_path, tree_leaves, tree_map  # noqa: E402

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
    # the generator of both is csrc/gen_rows.cuh
    "fused_guard_gen": ("src/repro_torch/kernels/csrc/fused_guard.cu",
                        "src/repro/kernels/fused_guard.py:256"),
    "gen_xi": ("src/repro_torch/kernels/csrc/filtered_mean.cu",
               "src/repro/kernels/fused_guard.py:349"),
    # the same two kernels over a campaign group's run axis (what vmap of
    # the Pallas calls computes): rt_fused_guard_gen_runs, rt_gen_xi_runs
    "fused_guard_gen_runs": ("src/repro_torch/kernels/csrc/fused_guard.cu",
                             "src/repro/kernels/fused_guard.py:256"),
    "gen_xi_runs": ("src/repro_torch/kernels/csrc/filtered_mean.cu",
                    "src/repro/kernels/fused_guard.py:349"),
}
# The bf16 guard sweep (plain, sanitizing, generating) is a kernel of the
# header that csrc/fused_guard.cu includes.
SWEEP_HEADER = "src/repro_torch/kernels/csrc/guard_sweep.cuh"
# Recorded, not measured here: each guard sweep's, order statistic's and
# CountSketch's time before its redesign at m = 32, d = 2^20 as PERF.md §6 holds it
# (NVIDIA H100 80GB HBM3 at 700 W), under sign_flip and under ALIE (the
# generating kernels, each with its own moments pass).  Phase lines print
# it beside this run's time; the kernels line carries only what this run
# measured.
RECORDED_BEFORE_MS = {("fused_guard", "f32"): 0.1734, ("fused_guard", "bf16"): 0.2415,
                      ("fused_guard_sanitize", "f32"): 0.2028,
                      ("fused_guard_sanitize", "bf16"): 0.2630,
                      ("fused_guard_gen", "f32"): 0.3748, ("fused_guard_gen", "bf16"): 0.4147,
                      ("coordinate_median", "f32"): 0.0850,
                      ("coordinate_median", "bf16"): 0.0809,
                      ("trimmed_mean", "f32"): 0.0836, ("trimmed_mean", "bf16"): 0.0808,
                      ("countsketch", "f32"): 0.0518, ("countsketch", "bf16"): 0.0574}
RECORDED_BEFORE_ALIE_MS = {("fused_guard_gen", "f32"): 0.6209,
                           ("fused_guard_gen", "bf16"): 0.6469,
                           ("gen_xi", "f32"): 0.3750, ("gen_xi", "bf16"): 0.3734}


def source_of(name: str, dt: str) -> str:
    """The file that holds the kernel of ``name`` at ``dt``."""
    if (name in ("fused_guard", "fused_guard_sanitize", "fused_guard_gen", "fused_guard_gen_runs")
            and dt == "bf16"):
        return SWEEP_HEADER
    return KERNELS[name][0]


# each kernel's launch count: (wrapper, attribute); a sanitizing variant is
# counted on its wrapper apart from the plain one
COUNTERS = {"fused_guard": (fused_guard_cuda, "launches"),
            "filtered_mean": (filtered_mean_cuda, "launches"),
            "gram": (gram_cuda, "launches"),
            "coordinate_median": (coordinate_median_cuda, "launches"),
            "trimmed_mean": (trimmed_mean_cuda, "launches"),
            "fused_guard_sanitize": (fused_guard_cuda, "launches_sanitize"),
            "filtered_mean_sanitize": (filtered_mean_cuda, "launches_sanitize"),
            "countsketch": (countsketch_cuda, "launches"),
            "fused_guard_gen": (fused_guard_gen_cuda, "launches"),
            "gen_xi": (gen_xi_cuda, "launches")}
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


# ---------------------------------------------------------------- phase 2

def free_card() -> None:
    """Collect the host's garbage before emptying the allocator's cache:
    a reference cycle (a trainer's closures, an exception's frames) can
    hold a run's state or a phase's weights until Python's collector
    runs."""
    gc.collect()
    torch.cuda.empty_cache()


def sort_network_size(m: int) -> int:
    """The comparators of the register path's network on m wires
    (``rt_sort_network``: the kernels' constexpr network evaluated on the
    host)."""
    fn = _build.load_function("sorted_reduce", "rt_sort_network",
                              [ctypes.c_int64, ctypes.c_void_p])
    return fn(m, None)


def sort_network_report() -> dict:
    """The register path of ``csrc/sorted_reduce.cu`` as built: its network
    has Batcher's (k² − k + 4)·2^(k−2) − 1 comparators on 2^k wires, k = 1
    .. 5 (191 at m = 32; two odd m printed too), and every instantiation
    of its kernels has no stack frame and no spill in ``-Xptxas -v``'s
    report (the network's values stayed in registers)."""
    for k in range(1, 6):
        require(sort_network_size(2 ** k) == (k * k - k + 4) * 2 ** (k - 2) - 1,
                f"the kernels' sort network on {2 ** k} wires has Batcher's size")
    kernels = {name: props for name, props in _build.ptxas_report("sorted_reduce").items()
               if "sorted_mean_kernel" in name or "sorted_mean_bf16x2_kernel" in name}
    # 32 widths × (median, trimmed mean) × (f32, bf16 pairs)
    require(len(kernels) == 32 * 2 * 2, f"{len(kernels)} register-path kernels in the build log")
    costly = [n for n, p in kernels.items()
              if p["stack"] or p["spill_stores"] or p["spill_loads"]]
    require(not costly, f"register-path kernels with stack or spills: {costly[:4]}")
    return {"comparators": {m: sort_network_size(m) for m in (32, 17, 31)},
            "min_max_a_column_m32": 2 * sort_network_size(32),
            "register_path_kernels": len(kernels), "stack_or_spill_bytes": 0,
            "max_registers": max(p["registers"] for p in kernels.values())}


def countsketch_report() -> dict:
    """The CountSketch's kernels of ``csrc/countsketch.cu`` as built: each
    instantiation's registers (dtype/loads/offsets), none with a stack
    frame or a spill in ``-Xptxas -v``'s report."""
    kernels = {}
    for name, props in _build.ptxas_report("countsketch").items():
        if "countsketch" not in name:
            continue
        t = re.search(r"countsketch_kernelI(f|13__nv_bfloat16)Lb([01])E([jl])E", name)
        key = ("/".join(("f32" if t[1] == "f" else "bf16", "vector" if t[2] == "1" else "scalar",
                         "u32" if t[3] == "j" else "i64")) if t
               else "reduce" if "reduce" in name else name)
        kernels[key] = props
    # dtype × loads × offsets, and the scratch sum
    require(len(kernels) == 2 * 2 * 2 + 1,
            f"{len(kernels)} countsketch kernels in the build log: {sorted(kernels)}")
    costly = [n for n, p in kernels.items()
              if p["stack"] or p["spill_stores"] or p["spill_loads"]]
    require(not costly, f"countsketch kernels with stack or spills: {costly}")
    return {"registers": {n: p["registers"] for n, p in sorted(kernels.items())},
            "stack_or_spill_bytes": 0}


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
        # at m·d > 2^31 both Grams against f64 sums of the exact products:
        # what each of kernel and plain version (an f32 GEMM) errs by
        vs_f64 = grams_vs_f64(g, B, got, want) if d > D else None
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
             filtered_mean_rel_abs=fm, tol=TOL[dt],
             **({"grams_rel_to_f64": vs_f64} if vs_f64 else {}))
        require(b_equal, f"fused_guard B_new bit-equal at m={m} d={d} {dt}")
        require(fg_ok, f"fused_guard within {TOL[dt]} at m={m} d={d} {dt}")
        require(fm_ok, f"filtered_mean within {TOL[dt]} at m={m} d={d} {dt}")
        if (m, d) == (M, D):
            errs[("fused_guard", dt)] = max(e[1] for e in fg)
            errs[("filtered_mean", dt)] = fm[1]
        del g, dlt, xi, xi_ref
        torch.cuda.empty_cache()
    return errs


def grams_vs_f64(g, B, got, want, cols: int = 1 << 22) -> dict:
    """‖X − exact‖ / ‖exact‖ of gram_g and cross for the kernel (``got``)
    and the plain version (``want``), exact = f64 sums of the exact
    products, by column chunks."""
    m = g.shape[0]
    exact = [torch.zeros((m, m), dtype=torch.float64, device=g.device) for _ in range(2)]
    for lo in range(0, g.shape[1], cols):
        gc, bc = g[:, lo:lo + cols].double(), B[:, lo:lo + cols].double()
        exact[0] += gc @ gc.T
        exact[1] += bc @ gc.T
    return {who: {name: rel_err(t, e)[0] for name, t, e in zip(("gram_g", "cross"), out, exact)}
            for who, out in (("kernel", got), ("plain", want))}


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
# the baselines' runs at the main path's width, cut from T = 128 to keep
# the script inside its time with Table 1's runs
BASELINE_T = 64
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
                              "guard_backend": "fused", "T": BASELINE_T})
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = run_sgd(problem, cfg, prng.PRNGKey(0), device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = launches[(name, attack)] = read_counts()
        finite = bool(torch.isfinite(res.x_avg).all() and torch.isfinite(res.gaps).all())
        emit("baselines", run=name, attack=attack, T=BASELINE_T,
             ms_per_step=1e3 * seconds / BASELINE_T, final_gap=float(res.gaps[-1]),
             gap_at_x_avg=float(problem.f(res.x_avg)), n_alive_last=int(res.n_alive[-1]),
             finite=finite, launches=got)
        require(finite, f"{name} under {attack}: finite x_avg and gaps")
        want = expected_counts(name, BASELINE_T)
        require(got == want, f"{name} under {attack}: launches {got}, expected {want}")
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


def quarantine(dev) -> dict:
    """Returns each plan's series, by plan and run."""
    problem = make_generated_problem(d=D, seed=0, device=dev)
    series = {}
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
        series[fault] = runs
    return series


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
# reference's default at tiny d), a small strided fold, scalar loads with a
# row tile cut short, m·d > 2^31
SKETCH_CASES = [(M, D, SKETCH_K, "f32", 0), (M, D, SKETCH_K, "bf16", 0),
                (M, D, SKETCH_K, "f32", 7), (17, 555, 8, "f32", 0), (17, 555, 8, "bf16", 7),
                (16, 16, SKETCH_K, "f32", 7), (16, 16, SKETCH_K, "bf16", 0),
                (8, 4099, 64, "f32", 7), (8, 4099, 64, "bf16", 0),
                (33, 4099, 63, "f32", 0), (33, 4099, 63, "bf16", 7),
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
        plan = launch_plan(m, d, k, x.dtype, x.data_ptr() % 16 == 0)
        got = countsketch_cuda(x, k, salt)
        torch.cuda.synchronize()
        want = ref.countsketch_ref(x, k, salt)
        err = rel_err(got, want)
        emit("dp", check="countsketch", m=m, d=d, k=k, dtype=dt, salt=salt, rel_abs=err,
             tol=TOL[dt], plan=plan._asdict())
        require(got.shape == (m, k) and within(got, want, TOL[dt]),
                f"countsketch within {TOL[dt]} at m={m} d={d} k={k} {dt} salt={salt}")
        if (m, d, k) == (M, D, SKETCH_K):
            require(plan.vec and plan.chunks == 1,
                    f"countsketch at the main shape ({dt}): vector path, no scratch")
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

MOMENT_IDS = (4, 8)   # ALIE and alie_update: rows read the honest column moments
GEN_BIG_D = 2 ** 26 + 3   # m·d > 2^31 at m = 32: int64 offsets
GEN_CHUNK = 1 << 22       # columns per chunk of the plain version at GEN_BIG_D


def gen_operands(m: int, d: int, aid: int, dev, seed: int = 0) -> list:
    """The generator's operands for a kernel check: a quarter of the fleet
    plays ``aid`` (phase a), two rows sign_flip (phase b), the last row is
    padding (slot −1); every third worker carries a ±0.3 skew along a unit
    ``het_dir``."""
    gen = torch.Generator(device=dev).manual_seed(seed + 31 * m + d)
    h = torch.logspace(0.0, 3.0, d, base=2.0, device=dev)
    x_star = torch.randn(d, device=dev, generator=gen) / d ** 0.5
    x = 0.1 * torch.randn(d, device=dev, generator=gen)
    het_dir = torch.randn(d, device=dev, generator=gen)
    het_dir /= het_dir.norm()
    keys = prng.split(prng.PRNGKey(seed + m, device=dev), m)
    w = torch.arange(m, device=dev)
    skewsign = 0.3 * (1.0 - 2.0 * (w % 2).float()) * (w % 3 == 0).float()
    n_a = max(m // 4, 1)
    slot = torch.zeros(m, dtype=torch.int32, device=dev)
    slot[:n_a] = 1
    slot[n_a:n_a + 2] = 2
    slot[-1] = -1
    params = torch.zeros(gradgen.GEN_NPARAMS, device=dev)
    params[gradgen.P_ID_A], params[gradgen.P_SF_A] = float(aid), -3.0
    params[gradgen.P_CONST_A], params[gradgen.P_IPC_A] = 10.0 / d ** 0.5, 2.0
    params[gradgen.P_ID_B], params[gradgen.P_SF_B] = 1.0, -1.5
    params[gradgen.P_Z_A] = alie_z_max(m, torch.sum(slot > 0))
    params[gradgen.P_TGNRM] = torch.clamp(torch.linalg.vector_norm(h * (x - x_star)), min=1e-12)
    params[gradgen.P_NSCALE] = 1.0 / d ** 0.5
    return [x, h, x_star, het_dir, keys, skewsign, slot, params]


def main_gen_operands(attack: str, dev, seed: int = 0) -> list:
    """The operands the main path hands the generating kernels at step 0
    under ``scenario_static(attack)``, α = 0.25, from ``PRNGKey(seed)``."""
    problem = make_generated_problem(d=D, seed=0, device=dev)
    adv = ScenarioAdversary(scenario_static(attack), 0.25)
    key, mask_key = prng.split(prng.PRNGKey(seed, device=dev))
    mask = adv.mask_at(byz_rank(mask_key, M), 0)
    gkey = prng.split(key, 3)[1]
    x = problem.x1
    ctx = {"true_grad": problem.grad(x), "V": problem.V, "step": 0,
           "alive": torch.ones(M, dtype=torch.bool, device=dev),
           "n_alive": torch.tensor(M, device=dev), "prev_xi": torch.zeros_like(x)}
    slot, params, w_byz = adv.gen_attack_ctx(mask, ctx, adv.init_state(M, D, device=dev),
                                             problem.gen.noise_scale)
    return [x, problem.gen.h, problem.gen.x_star, problem.gen.het_dir,
            prng.split(gkey, M), torch.zeros(M, device=dev), slot, params], w_byz


def plain_gen_chunked(B, dlt, operands, stats_dtype):
    """The plain versions of both generating kernels over column chunks
    (the rows are column-local): (gram_g, cross, a_inc, B_new, ξ, byz)."""
    x, h, xs, hd, keys, skew, slot, params = operands
    m, d = B.shape
    w_xi = (slot == 0).float() / m
    w_byz = (slot > 0).float()
    acc = [torch.zeros((m, m), dtype=torch.float64, device=B.device) for _ in range(2)]
    a_inc = torch.zeros(m, dtype=torch.float64, device=B.device)
    b_new, xi, byz = [], [], []
    for lo in range(0, d, GEN_CHUNK):
        hi = min(lo + GEN_CHUNK, d)
        j = torch.arange(lo, hi, device=B.device)
        rows = gradgen.gen_worker_rows(x[lo:hi], h[lo:hi], xs[lo:hi], hd[lo:hi], keys, skew,
                                       slot, params, j, d)
        g, bn = rows.to(B.dtype).float(), B[:, lo:hi].float()
        acc[0] += (g @ g.T).double()
        acc[1] += (bn @ g.T).double()
        a_inc += (g @ dlt[lo:hi].float()).double()
        b_new.append((bn + g).to(B.dtype))
        xi.append(w_xi @ rows.to(stats_dtype).float())
        byz.append(torch.sum(rows * w_byz[:, None], dim=0))
        del rows, g, bn
    return (acc[0].float(), acc[1].float(), a_inc.float(), torch.cat(b_new, dim=1),
            torch.cat(xi), torch.cat(byz))


def check_gen_kernels(dev, errs: dict) -> None:
    """Both generating kernels against their plain versions on the card, at
    the main path's shape (f32, bf16) for every supported attack id and at
    m·d > 2^31 (bf16, sign_flip): ``B_new`` bit-equal but for ALIE's ids,
    the rest within tol; given their own rows materialised, ``fused_guard``
    gives the same four outputs and ``filtered_mean`` the same ξ, bit for
    bit.  Adds the largest errors at the main shape to ``errs``."""
    for m, d, dt in ((M, D, "f32"), (M, D, "bf16"), (M, GEN_BIG_D, "bf16")):
        tdt, tol = DTYPES[dt], TOL[dt]
        gen = torch.Generator(device=dev).manual_seed(m * 7 + d)
        B = torch.randn(m, d, device=dev, generator=gen, dtype=tdt).mul_(3)
        dlt = torch.randn(d, device=dev, generator=gen, dtype=tdt)
        for aid in (gradgen.GEN_SUPPORTED_IDS if d == D else (1,)):
            operands = gen_operands(m, d, aid, dev)
            slot = operands[6]
            w_xi, w_byz = (slot == 0).float() / m, (slot > 0).float()
            got = fused_guard_gen_cuda(B, dlt, *operands)
            xi, byz = gen_xi_cuda(w_xi, w_byz, *operands, stats_dtype=tdt)
            torch.cuda.synchronize()
            if d == D:
                want = ref.fused_guard_gen_ref(B, dlt, *operands)
                want_xi = ref.gen_xi_ref(w_xi, w_byz, *operands, stats_dtype=tdt)
            else:
                *want, xw, bw = plain_gen_chunked(B, dlt, operands, tdt)
                want_xi = (xw, bw)
            b_equal = torch.equal(got[3], want[3])
            b_ok = b_equal if aid not in MOMENT_IDS else within(got[3].float(), want[3].float(),
                                                                tol)
            fg = [rel_err(a, b) for a, b in zip(got[:3], want[:3])]
            fg_ok = all(within(a, b, tol) for a, b in zip(got[:3], want[:3]))
            del want
            gx = [rel_err(a, b) for a, b in zip((xi, byz), want_xi)]
            gx_ok = all(within(a, b, tol) for a, b in zip((xi, byz), want_xi))
            del want_xi
            rows = fused_guard_gen_cuda(torch.zeros_like(B), dlt, *operands)[3]
            same_fg = all(torch.equal(a, b) for a, b in zip(got, fused_guard_cuda(rows, B, dlt)))
            same_xi = torch.equal(xi, filtered_mean_cuda(rows, w_xi, 1.0))
            # the moments handed from the sweep to gen_xi, as gen_step runs
            # them, give gen_xi's own bits
            mom = torch.empty((2, d), device=dev)
            fused_guard_gen_cuda(B, dlt, *operands, moments=mom)
            shared = gen_xi_cuda(w_xi, w_byz, *operands, stats_dtype=tdt, moments=mom)
            same_shared = torch.equal(shared[0], xi) and torch.equal(shared[1], byz)
            del rows, got, mom, shared
            emit("gen_kernels", m=m, d=d, dtype=dt, attack_id=aid, B_new_bit_equal=b_equal,
                 fused_guard_gen_rel_abs={"gram_g": fg[0], "cross": fg[1], "a_inc": fg[2]},
                 gen_xi_rel_abs={"xi": gx[0], "byz": gx[1]},
                 equals_fused_guard_on_its_rows=same_fg,
                 xi_equals_filtered_mean_on_its_rows=same_xi,
                 shared_moments_bit_equal=same_shared, tol=tol)
            where = f"at m={m} d={d} {dt} id {aid}"
            require(b_ok, f"fused_guard_gen B_new {'within tol' if aid in MOMENT_IDS else 'bit-equal'} {where}")
            require(fg_ok, f"fused_guard_gen within {tol} {where}")
            require(gx_ok, f"gen_xi within {tol} {where}")
            require(same_fg, f"fused_guard_gen equals fused_guard on its own rows {where}")
            require(same_xi, f"gen_xi's xi equals filtered_mean on its own rows {where}")
            require(same_shared, f"gen_xi with the sweep's moments equals its own {where}")
            if d == D:
                for name, e in (("fused_guard_gen", max(x[1] for x in fg)),
                                ("gen_xi", max(x[1] for x in gx))):
                    errs[(name, dt)] = max(errs.get((name, dt), 0.0), e)
            del operands, xi, byz
            torch.cuda.empty_cache()
        del B, dlt
        torch.cuda.empty_cache()


def profiled_run(problem, cfg, adv, dev, telemetry=None) -> tuple:
    """One ``run_sgd``: (result, ms/step, launch counts, peak bytes), the
    counts set to 0 just before and read just after."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    res = run_sgd(problem, cfg, prng.PRNGKey(0), adversary=adv, telemetry=telemetry, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return res, 1e3 * seconds / cfg.T, read_counts(), torch.cuda.max_memory_allocated(dev)


GEN_RUNS = [(f"{attack}@{sd}", attack, sd) for attack in ("sign_flip", "alie")
            for sd in ("f32", "bf16")]


def gen_main_path(dev) -> dict:
    """``run_sgd`` with ``scenario_static`` adversaries at the main path's
    shape, ``generate="kernel"`` against ``"off"``: ms/step, peak memory,
    launches, and decisions at every step.  Returns the generating runs'
    launch counts."""
    problem = make_generated_problem(d=D, seed=0, device=dev)
    gen_launches = {}
    n_byz = int(BASE["alpha"] * M)
    for name, attack, sd in GEN_RUNS:
        adv = ScenarioAdversary(scenario_static(attack), BASE["alpha"])
        out = {generate: profiled_run(problem, SolverConfig(**{
            **BASE, "guard_backend": "fused", "stats_dtype": sd, "generate": generate}), adv, dev)
            for generate in ("off", "kernel")}
        (off, off_ms, off_n, off_mem), (gen, gen_ms, gen_n, gen_mem) = out["off"], out["kernel"]
        gen_launches[name] = gen_n
        decisions = all(torch.equal(getattr(off, f), getattr(gen, f))
                        for f in ("n_alive", "final_alive", "byz_mask"))
        gaps_equal = torch.equal(off.gaps, gen.gaps)
        finite = all(bool(torch.isfinite(r.x_avg).all() and torch.isfinite(r.gaps).all())
                     for r in (off, gen))
        emit("gen_main_path", run=name, ms_per_step={"off": off_ms, "kernel": gen_ms},
             max_memory_allocated_bytes={"off": off_mem, "kernel": gen_mem},
             final_gap={"off": float(off.gaps[-1]), "kernel": float(gen.gaps[-1])},
             n_alive_first_last={"off": [int(off.n_alive[0]), int(off.n_alive[-1])],
                                 "kernel": [int(gen.n_alive[0]), int(gen.n_alive[-1])]},
             byzantine_alive=int((gen.final_alive & gen.byz_mask).sum()),
             ever_filtered_good=bool(gen.ever_filtered_good),
             launches={"off": off_n, "kernel": gen_n},
             decisions_equal_at_every_step=decisions, gaps_bit_equal=gaps_equal,
             x_avg_rel_abs=rel_err(gen.x_avg, off.x_avg), finite=finite)
        require(finite, f"{name}: finite x_avg and gaps on both paths")
        require(gen_n == counts(fused_guard_gen=T, gen_xi=T),
                f"{name} generate='kernel': launches {gen_n}")
        require(off_n == counts(fused_guard=T, filtered_mean=T),
                f"{name} generate='off': launches {off_n}")
        require(decisions, f"{name}: generating run decides as the materialising run at every step")
        require(gen_mem + M * D * 4 <= off_mem,
                f"{name}: generating peak {gen_mem} B not below the materialising "
                f"{off_mem} B by the (m, d) f32 batch")
        if attack == "sign_flip":
            require(int(gen.byz_mask.sum()) == n_byz and
                    not bool((gen.final_alive & gen.byz_mask).any()),
                    f"{name}: all {n_byz} sign-flippers filtered")
            require(not bool(gen.ever_filtered_good) and int(gen.n_alive[-1]) == M - n_byz,
                    f"{name}: no honest worker filtered")
            # no row reads a sum over rows, so the generated rows equal the
            # sampled ones and every later sum runs in the same order
            require(gaps_equal, f"{name}: gaps bit-equal to the materialising run's")
        del off, gen, out
    return gen_launches


def gen_reference(dev) -> None:
    """The generating run on the card against the CPU's plain-version run
    on a small input."""
    for attack in ("sign_flip", "alie"):
        kw = dict(m=8, T=40, eta=0.05, alpha=0.25, aggregator="byzantine_sgd",
                  guard_backend="fused", generate="kernel")
        adv = ScenarioAdversary(scenario_static(attack), 0.25)
        got = run_sgd(make_generated_problem(d=4099, seed=1, device=dev), SolverConfig(**kw),
                      prng.PRNGKey(1), adversary=adv, device=dev)
        want = run_sgd(make_generated_problem(d=4099, seed=1, device="cpu"),
                       SolverConfig(**kw), prng.PRNGKey(1), adversary=adv, device="cpu")
        same = all(torch.equal(getattr(got, f).cpu(), getattr(want, f))
                   for f in ("n_alive", "final_alive", "byz_mask"))
        err = rel_err(got.x_avg.cpu(), want.x_avg)
        emit("gen_reference", attack=attack, decisions_equal=same, x_avg_rel_abs=err)
        require(same, f"{attack}: card and CPU decisions equal on the small input")
        require(within(got.x_avg.cpu(), want.x_avg, 1e-5),
                f"{attack}: card and CPU x_avg within 1e-5")


# ---------------------------------------------------------------- phase 9

WORKER_SHAPES = ((33, 4099), (129, 4099), (257, 4099), (1000, 4099), (MAX_WORKERS, 257))
WORKER_SKETCH_K = 64


def worker_checks(m: int, d: int, dt: str, dev) -> dict:
    """Every kernel and variant against its plain version at (m, d, dt):
    returns {check: passed}; emits the errors."""
    tdt, tol = DTYPES[dt], TOL[dt]
    gen = torch.Generator(device=dev).manual_seed(m * 613 + d)
    x = torch.randn(m, d, device=dev, generator=gen, dtype=tdt)
    B = torch.randn(m, d, device=dev, generator=gen, dtype=tdt).mul_(3)
    dlt = torch.randn(d, device=dev, generator=gen, dtype=tdt)
    w = (torch.rand(m, device=dev, generator=gen) > 0.3).float() / m
    n_trim = min(N_TRIM, (m - 1) // 2)
    ok, err = {}, {}

    def held(name, got, want):
        err[name] = rel_err(got, want)
        ok[name] = within(got, want, tol)

    got, want = fused_guard_cuda(x, B, dlt), ref.fused_guard_ref(x, B, dlt)
    ok["fused_guard.B_new_bit_equal"] = torch.equal(got[3], want[3])
    for i, name in enumerate(("gram_g", "cross", "a_inc")):
        held(f"fused_guard.{name}", got[i], want[i])
    del got, want
    held("filtered_mean", filtered_mean_cuda(x, w, 1.0), ref.filtered_mean_ref(x, w, 1.0))
    g1, g2 = gram_cuda(x), gram_cuda(x)
    held("gram", g1, ref.gram_ref(x))
    ok["gram.repeat_bit_equal"] = torch.equal(g1, g2)
    del g1, g2
    ok["coordinate_median.bit_equal"] = torch.equal(coordinate_median_cuda(x),
                                                    ref.coordinate_median_ref(x))
    held("trimmed_mean", trimmed_mean_cuda(x, n_trim), ref.trimmed_mean_ref(x, n_trim))
    held("countsketch", countsketch_cuda(x, WORKER_SKETCH_K),
         ref.countsketch_ref(x, WORKER_SKETCH_K))
    xp = poison(x.clone())
    got = fused_guard_cuda(xp, B, dlt, sanitize=True)
    want = ref.fused_guard_sanitize_ref(xp, B, dlt)
    ok["fused_guard_sanitize.nf_equal"] = torch.equal(got[4], want[4])
    ok["fused_guard_sanitize.B_new_bit_equal"] = torch.equal(got[3], want[3])
    for i, name in enumerate(("gram_g", "cross", "a_inc")):
        held(f"fused_guard_sanitize.{name}", got[i], want[i])
    del got, want
    held("filtered_mean_sanitize", filtered_mean_cuda(xp, w, 1.0, sanitize=True),
         ref.filtered_mean_sanitize_ref(xp, w, 1.0))
    del xp
    # the generating kernels under sign_flip (id 1: rows bit-equal) and ALIE
    # (id 4: the moments pass over all m honest rows, in chunks of 128)
    for aid in (1, 4):
        operands = gen_operands(m, d, aid, dev)
        slot = operands[6]
        got, want = (fused_guard_gen_cuda(B, dlt, *operands),
                     ref.fused_guard_gen_ref(B, dlt, *operands))
        if aid in MOMENT_IDS:
            held(f"fused_guard_gen[{aid}].B_new", got[3].float(), want[3].float())
        else:
            ok[f"fused_guard_gen[{aid}].B_new_bit_equal"] = torch.equal(got[3], want[3])
        for i, name in enumerate(("gram_g", "cross", "a_inc")):
            held(f"fused_guard_gen[{aid}].{name}", got[i], want[i])
        del got, want
        w_xi, w_byz = (slot == 0).float() / m, (slot > 0).float()
        got = gen_xi_cuda(w_xi, w_byz, *operands, stats_dtype=tdt)
        want = ref.gen_xi_ref(w_xi, w_byz, *operands, stats_dtype=tdt)
        held(f"gen_xi[{aid}].xi", got[0], want[0])
        held(f"gen_xi[{aid}].byz", got[1], want[1])
        del got, want, operands
    torch.cuda.synchronize()
    emit("workers", m=m, d=d, dtype=dt, n_trim=n_trim, rel_abs=err, tol=tol,
         failed=[k for k, v in ok.items() if not v])
    del x, B, dlt
    torch.cuda.empty_cache()
    return ok


def wrappers_over_cap(dev) -> dict:
    """Each CUDA wrapper at m = MAX_WORKERS + 1: {wrapper: raised a
    ValueError naming the cap}."""
    m, d = MAX_WORKERS + 1, 8
    x = torch.zeros(m, d, device=dev)
    w = torch.ones(m, device=dev)
    operands = gen_operands(m, d, 1, dev)
    calls = {
        "fused_guard": lambda: fused_guard_cuda(x, x, x[0]),
        "fused_guard_sanitize": lambda: fused_guard_cuda(x, x, x[0], sanitize=True),
        "fused_guard_gen": lambda: fused_guard_gen_cuda(x, x[0], *operands),
        "gen_xi": lambda: gen_xi_cuda(w, w, *operands),
        "filtered_mean": lambda: filtered_mean_cuda(x, w, 1.0),
        "filtered_mean_sanitize": lambda: filtered_mean_cuda(x, w, 1.0, sanitize=True),
        "gram": lambda: gram_cuda(x),
        "coordinate_median": lambda: coordinate_median_cuda(x),
        "trimmed_mean": lambda: trimmed_mean_cuda(x, 1),
        "countsketch": lambda: countsketch_cuda(x, 4),
    }
    raised = {}
    for name, call in calls.items():
        try:
            call()
            raised[name] = False
        except ValueError as e:
            raised[name] = f"MAX_WORKERS = {MAX_WORKERS}" in str(e)
    return raised


def workers(dev) -> None:
    """Every kernel and variant at worker counts past the main path's
    32, up to the port's cap, against its plain version; and every
    wrapper refusing one worker more than the cap."""
    failed = []
    for m, d in WORKER_SHAPES:
        for dt in ("f32", "bf16"):
            ok = worker_checks(m, d, dt, dev)
            failed += [f"{k} at m={m} d={d} {dt}" for k, v in ok.items() if not v]
    raised = wrappers_over_cap(dev)
    emit("workers", check="over_cap", m=MAX_WORKERS + 1, raised=raised)
    require(not failed, f"workers: {failed}")
    require(all(raised.values()), f"every wrapper raises past the cap: {raised}")


WORKERS_M, WORKERS_D, WORKERS_T = 256, 2 ** 18, 8
# (run, config over BASE, launch counts of a WORKERS_T-step run)
WORKERS_RUNS = [
    ("fused", dict(guard_backend="fused"), dict(fused_guard=1, filtered_mean=1)),
    ("fused_gen", dict(guard_backend="fused", generate="kernel"),
     dict(fused_guard_gen=1, gen_xi=1)),
    ("dense", dict(guard_backend="dense"), {}),
    ("krum", dict(aggregator="krum"), dict(gram=1)),
    ("coordinate_median", dict(aggregator="coordinate_median"), dict(coordinate_median=1)),
    ("trimmed_mean", dict(aggregator="trimmed_mean"), dict(trimmed_mean=1)),
    ("dp_sketch", dict(guard_backend="dp_sketch"), dict(countsketch=1, filtered_mean=1)),
]


def workers_main_path(dev) -> None:
    """``run_sgd`` at m = 256 workers under ``scenario_static("sign_flip")``:
    the fused guard materialising and generating, dense as the oracle,
    the kernel-backed baselines and dp_sketch; launches exact, results
    finite, fused and the generating run deciding as dense at every step."""
    problem = make_generated_problem(d=WORKERS_D, seed=0, device=dev)
    adv = ScenarioAdversary(scenario_static("sign_flip"), BASE["alpha"])
    results = {}
    for name, over, per_step in WORKERS_RUNS:
        cfg = SolverConfig(**{**BASE, "m": WORKERS_M, "T": WORKERS_T, **over})
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = run_sgd(problem, cfg, prng.PRNGKey(0), adversary=adv, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = read_counts()
        want = counts(**{k: WORKERS_T * v for k, v in per_step.items()})
        finite = bool(torch.isfinite(res.x_avg).all() and torch.isfinite(res.gaps).all())
        results[name] = res
        emit("workers_main_path", run=name, m=WORKERS_M, d=WORKERS_D, T=WORKERS_T,
             ms_per_step=1e3 * seconds / WORKERS_T, final_gap=float(res.gaps[-1]),
             n_alive=[int(v) for v in res.n_alive], n_byzantine=int(res.byz_mask.sum()),
             byzantine_alive=int((res.final_alive & res.byz_mask).sum()),
             launches=got, finite=finite)
        require(finite, f"workers_main_path {name}: finite x_avg and gaps")
        require(got == want, f"workers_main_path {name}: launches {got}, expected {want}")
    dense = results["dense"]
    for name in ("fused", "fused_gen", "dp_sketch"):
        same = torch.equal(results[name].n_alive, dense.n_alive)
        emit("workers_main_path", check="n_alive_equal_to_dense", run=name, equal=same)
        if name != "dp_sketch":
            require(same, f"workers_main_path {name}: n_alive equal to dense at every step")
    require(torch.equal(results["fused_gen"].gaps, results["fused"].gaps),
            "workers_main_path: generating gaps bit-equal to the materialising run's")


GRAM_FIRST_DESIGN_MS = {"f32": 0.0818, "bf16": 0.0826}   # PERF.md §6, the first design
# The profiler keeps only the kernels whose card timestamps, mapped to the
# host's clock, fall inside its window; a trace whose window closed right
# after the synchronisation held 11 of 20 launches three times in a row
# (PERF.md §7), so the window opens and closes this far from the calls.
TRACE_MARGIN_S = 0.01


def clocks_during(fn, seconds: float = 1.0) -> dict:
    """Median SM clock (MHz) and power draw (W) that ``nvidia-smi`` samples
    every 50 ms while ``fn`` runs back to back for about ``seconds``."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "50"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    rows = [[float(v) for v in ln.split(",")] for ln in out.strip().splitlines()
            if ln.count(",") == 1 and "[" not in ln]
    if not rows:
        return {"sm_mhz": None, "power_w": None, "samples": 0}
    return {"sm_mhz": statistics.median(r[0] for r in rows),
            "power_w": statistics.median(r[1] for r in rows), "samples": len(rows)}


def gram_main(dev) -> None:
    """The redesigned gram at the main shape: two calls give the same bits,
    and its time beside the library call (x @ xᵀ, TF32 off), with the SM
    clock and power the card held while it ran."""
    for dt in ("f32", "bf16"):
        e = torch.tensor([], dtype=DTYPES[dt]).element_size()
        x = torch.randn(M, D, device=dev, generator=torch.Generator(device=dev).manual_seed(9),
                        dtype=DTYPES[dt])
        same = torch.equal(gram_cuda(x), gram_cuda(x))
        b_ms, b_by = bound(M * D * e + M * M * 4, 2 * M * M * D, PEAK_FLOPS[dt])
        emit("gram_main", dtype=dt, repeat_bit_equal=same, ms=median_ms(lambda: gram_cuda(x)),
             library_ms=median_ms(lambda: x @ x.T), bound_ms=b_ms, bound_by=b_by,
             first_design_ms=GRAM_FIRST_DESIGN_MS[dt],
             while_running=clocks_during(lambda: gram_cuda(x)))
        require(same, f"gram: two calls give the same bits at the main shape {dt}")
        del x
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 10

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


def kernel_and_host_ms(fn, calls: int = 20, only: str = "",
                       margin_s: float = TRACE_MARGIN_S) -> dict:
    """Per call of ``fn``: the host's time to return from it while the card
    works through the queue (``time.perf_counter``, no synchronisation
    between the calls); then, from a ``torch.profiler`` trace of ``calls``
    more, the card's time in the kernels they launch whose names start
    with ``only``, the span from the first such kernel's start to the last
    one's end, and each kernel's count (each of them ``calls`` times when
    none went unrecorded).  The trace's window opens ``margin_s`` before
    the first traced call and closes ``margin_s`` after the card is done."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    # a warm-up cycle starts the tracer (the first launches after it starts
    # can go unrecorded), then ``calls`` calls are traced
    kern = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: kern.extend(
                e for e in p.events() if e.device_type == torch.autograd.DeviceType.CUDA)) as prof:
        for _ in range(2):
            time.sleep(margin_s)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(margin_s)
            prof.step()
    counts: dict = {}
    named = []
    for e in kern:
        # "void (anonymous namespace)::fused_guard_kernel<true, ...>(...)" -> "fused_guard_kernel"
        name = e.name.removeprefix("void ").replace("(anonymous namespace)::", "")
        name = name.split("<")[0].split("(")[0].split("::")[-1]
        if name.startswith(only):
            counts[name] = counts.get(name, 0) + 1
            named.append(e)
    kern = named
    if not kern:
        return {"host_ms": host_ms, "kernel_ms": None, "span_ms": None, "kernels": {},
                "every_launch_traced": False}
    span = max(e.time_range.end for e in kern) - min(e.time_range.start for e in kern)
    return {"host_ms": host_ms,
            "kernel_ms": sum(e.time_range.elapsed_us() for e in kern) / 1e3 / calls,
            "span_ms": span / 1e3 / calls, "kernels": counts,
            "every_launch_traced": all(c % calls == 0 for c in counts.values())}


def traced_launches(fn, only: str, calls: int = 20, tries: int = 3) -> dict:
    """``kernel_and_host_ms`` of a ``fn`` that launches one kernel named
    ``only``…, traced again, up to ``tries`` times in all, until the trace
    holds every one of its ``calls`` launches and no other (the tracer can
    miss launches); ``traces`` is the number of traces taken."""
    for t in range(1, tries + 1):
        traced = kernel_and_host_ms(fn, calls, only=only)
        traced["every_launch_traced"] = sum(traced["kernels"].values()) == calls
        if traced["every_launch_traced"]:
            break
    return {**traced, "traces": t}


def ms_of(entries: list, name: str) -> float:
    """The kernels-line time of the entry ``name``."""
    return next(e["ms"] for e in entries if e["name"] == name)


def guard_sweep_line(name: str, dt: str, fn, ms: float) -> None:
    """The ``guard_sweep`` line of one sweep, beside its kernels-line time
    ``ms``: two calls give the same bits, the card's and the host's time a
    call (``kernel_and_host_ms``), the SM clock and power while it runs,
    and its recorded time before the redesign."""
    same = all(torch.equal(a, b) for a, b in zip(fn(), fn()))
    emit("guard_sweep", kernel=f"{name}[{dt}]", source=source_of(name, dt),
         repeat_bit_equal=same, ms=ms, **kernel_and_host_ms(fn),
         recorded_before_redesign_ms=RECORDED_BEFORE_MS[(name, dt)],
         while_running=clocks_during(fn))
    require(same, f"{name}[{dt}]: two calls give the same bits at the main shape")


def bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """The least time the card could take, in ms: the larger of the bytes
    over the HBM rate and the operations over ``peak`` (per second)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_kernels(dev, errs, launches, base_launches, q_launches, dp_launches,
                 gen_launches, gen_bound) -> list:
    entries = []
    alu_rate = (torch.cuda.get_device_properties(dev).multi_processor_count
                * INT_OPS_PER_CLOCK_PER_SM * max_sm_clock_hz())
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
            "source": source_of("fused_guard", dt), "replaces": KERNELS["fused_guard"][1],
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
            "source": source_of("filtered_mean", dt), "replaces": KERNELS["filtered_mean"][1],
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
            "source": source_of("gram", dt), "replaces": KERNELS["gram"][1],
            "launches": base_launches[("krum", "sign_flip")]["gram"],
            "max_abs_err": errs[("gram", dt)],
            "ms": median_ms(lambda: gram_cuda(g)),
            "plain_ms": median_ms(lambda: ref.gram_ref(g)),
            "bound_ms": b_ms, "bound_by": b_by,
            # one library call, x @ xᵀ in the input dtype (TF32 off): a yardstick only
            "library_ms": median_ms(lambda: g @ g.T),
        })
        emit("bound", kernel=f"gram[{dt}]", shape=[M, D], bytes=gr_bytes, flops=gr_flops)
        # the register path's network: Batcher's odd-even merge sort on M
        # wires, two min/max a comparator, each one instruction on the ALU
        # pipe (64 a clock per SM, as the generator's integer operations);
        # at bf16 one min.NaN.bf16x2 / max.NaN.bf16x2 orders two columns
        os_bytes = M * D * e + D * 4
        os_comparators = sort_network_size(M)
        os_ops = 2 * os_comparators * D // (2 if dt == "bf16" else 1)
        b_ms, b_by = bound(os_bytes, os_ops, alu_rate)
        order_stats = (("coordinate_median", lambda: coordinate_median_cuda(g),
                        lambda: ref.coordinate_median_ref(g)),
                       ("trimmed_mean", lambda: trimmed_mean_cuda(g, N_TRIM),
                        lambda: ref.trimmed_mean_ref(g, N_TRIM)))
        lib_sort = median_ms(lambda: torch.sort(g, dim=0))
        for name, kernel, plain in order_stats:
            entries.append({
                "name": f"{name}[{dt}]", "route": "cuda",
                "source": source_of(name, dt), "replaces": KERNELS[name][1],
                "launches": base_launches[(name, "sign_flip")][name],
                "max_abs_err": errs[(name, dt)],
                "ms": median_ms(kernel), "plain_ms": median_ms(plain),
                "bound_ms": b_ms, "bound_by": b_by,
                # one library call, torch.sort(x, dim=0): the sort both reduce
                # from (torch.quantile refuses inputs over 2^24 elements)
                "library_ms": lib_sort,
            })
            emit("bound", kernel=f"{name}[{dt}]", shape=[M, D], bytes=os_bytes,
                 bytes_ms=1e3 * os_bytes / HBM_BYTES_PER_S, comparators=os_comparators,
                 min_max_instructions=os_ops, min_max_per_s=alu_rate,
                 operations_ms=1e3 * os_ops / alu_rate, bound_ms=b_ms, bound_by=b_by)
            # the card's time in the kernel apart from the wrapper's host time,
            # which can pass a bf16 kernel's and then sets the events' reading
            traced = traced_launches(kernel, only="sorted_mean")
            emit("order_stats", kernel=f"{name}[{dt}]", ms=entries[-1]["ms"], **traced,
                 recorded_before_redesign_ms=RECORDED_BEFORE_MS[(name, dt)])
            require(traced["every_launch_traced"],
                    f"{name}[{dt}]: every launch in the trace ({traced['kernels']})")
        # the sanitizing variants on input holding 4 non-finite rows; the
        # bytes are the plain variants' (plus nf), the operations add one
        # finiteness test per entry
        gp = poison(g.clone())
        sg_bytes, sg_ops = fg_bytes + M * 4, fg_flops + M * D
        b_ms, b_by = bound(sg_bytes, sg_ops, PEAK_FLOPS[dt])
        entries.append({
            "name": f"fused_guard_sanitize[{dt}]", "route": "cuda",
            "source": source_of("fused_guard_sanitize", dt),
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
            "source": source_of("filtered_mean_sanitize", dt),
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
        # per entry on f32 CUDA cores whatever the input type, and one hash a
        # coordinate (HASH_OPS integer operations) on the ALU pipe
        cs_bytes = M * D * e + M * SKETCH_K * 4
        cs_flops, cs_hash = 2 * M * D, HASH_OPS * D
        cs_ops_ms = 1e3 * (cs_flops / PEAK_FLOPS["f32"] + cs_hash / alu_rate)
        b_ms = max(1e3 * cs_bytes / HBM_BYTES_PER_S, cs_ops_ms)
        b_by = "bytes" if b_ms > cs_ops_ms else "operations"
        sketch = lambda: countsketch_cuda(g, SKETCH_K)  # noqa: E731
        # the library's yardstick: one einsum of x's (m, J, k) view with the
        # (J, k) signs, made once here; it reads d sign values more than the
        # kernel, which makes them in registers
        sgn = ref.sketch_sign(D, 0, dev).to(DTYPES[dt]).view(-1, SKETCH_K)
        gv = g.view(M, -1, SKETCH_K)
        entries.append({
            "name": f"countsketch[{dt}]", "route": "cuda",
            "source": source_of("countsketch", dt), "replaces": KERNELS["countsketch"][1],
            "launches": dp_launches[f"dp_sketch@{dt}"]["countsketch"],
            "max_abs_err": errs[("countsketch", dt)],
            "ms": median_ms(sketch),
            "plain_ms": median_ms(lambda: ref.countsketch_ref(g, SKETCH_K)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": median_ms(lambda: torch.einsum("mjk,jk->mk", gv, sgn)),
        })
        emit("bound", kernel=f"countsketch[{dt}]", shape=[M, D, SKETCH_K], bytes=cs_bytes,
             bytes_ms=1e3 * cs_bytes / HBM_BYTES_PER_S, flops=cs_flops,
             hash_operations=cs_hash, hash_operations_per_s=alu_rate,
             operations_ms=cs_ops_ms, bound_ms=b_ms, bound_by=b_by)
        del sgn, gv
        same = torch.equal(sketch(), sketch())
        traced = traced_launches(sketch, only="countsketch")
        emit("countsketch", kernel=f"countsketch[{dt}]", repeat_bit_equal=same,
             plan=launch_plan(M, D, SKETCH_K, g.dtype, g.data_ptr() % 16 == 0)._asdict(),
             ms=entries[-1]["ms"], **traced,
             recorded_before_redesign_ms=RECORDED_BEFORE_MS[("countsketch", dt)])
        require(same, f"countsketch[{dt}]: two calls give the same bits at the main shape")
        require(traced["every_launch_traced"],
                f"countsketch[{dt}]: every launch in the trace ({traced['kernels']})")
        guard_sweep_line("fused_guard", dt, lambda: fused_guard_cuda(g, B, dlt),
                         ms_of(entries, f"fused_guard[{dt}]"))
        guard_sweep_line("fused_guard_sanitize", dt,
                         lambda: fused_guard_cuda(gp, B, dlt, sanitize=True),
                         ms_of(entries, f"fused_guard_sanitize[{dt}]"))
        del g, gp
        # the generating kernels on the main path's step-0 operands under
        # sign_flip; their plain versions run threefry in int64 torch (~40
        # ms a call), so they are timed over fewer calls
        operands, w_byz = main_gen_operands("sign_flip", dev)
        w_xi = (operands[6] == 0).float() / M
        run = f"sign_flip@{dt}"
        gen_calls = {
            "fused_guard_gen": (lambda: fused_guard_gen_cuda(B, dlt, *operands),
                                lambda: ref.fused_guard_gen_ref(B, dlt, *operands)),
            "gen_xi": (lambda: gen_xi_cuda(w_xi, w_byz, *operands, stats_dtype=DTYPES[dt]),
                       lambda: ref.gen_xi_ref(w_xi, w_byz, *operands,
                                              stats_dtype=DTYPES[dt])),
        }
        for name, (kernel, plain) in gen_calls.items():
            b_ms, b_by = gen_bound[(name, dt)]
            entries.append({
                "name": f"{name}[{dt}]", "route": "cuda",
                "source": source_of(name, dt), "replaces": KERNELS[name][1],
                "launches": gen_launches[run][name],
                "max_abs_err": errs[(name, dt)],
                "ms": median_ms(kernel),
                "plain_ms": median_ms(plain, batches=5, per_batch=3),
                "bound_ms": b_ms, "bound_by": b_by,
                # no single PyTorch call generates the batch in place
                "library_ms": None,
            })
        # ALIE's rows read the honest moments: the sweep's moments pass,
        # then gen_xi with its own pass (separate) or reading the sweep's
        # (shared, as gen_step runs them: one pass a step)
        alie, _ = main_gen_operands("alie", dev)
        mom = torch.empty((2, D), device=dev)
        fused_guard_gen_cuda(B, dlt, *alie, moments=mom)
        sd = DTYPES[dt]
        emit("gen_timing", attack="alie", dtype=dt,
             fused_guard_gen_ms=median_ms(lambda: fused_guard_gen_cuda(B, dlt, *alie)),
             gen_xi_ms=median_ms(lambda: gen_xi_cuda(w_xi, w_byz, *alie, stats_dtype=sd)),
             gen_xi_shared_moments_ms=median_ms(
                 lambda: gen_xi_cuda(w_xi, w_byz, *alie, stats_dtype=sd, moments=mom)),
             both_kernels_ms={
                 "separate_moments": median_ms(lambda: (
                     fused_guard_gen_cuda(B, dlt, *alie),
                     gen_xi_cuda(w_xi, w_byz, *alie, stats_dtype=sd))),
                 "shared_moments": median_ms(lambda: (
                     fused_guard_gen_cuda(B, dlt, *alie, moments=mom),
                     gen_xi_cuda(w_xi, w_byz, *alie, stats_dtype=sd, moments=mom)))},
             recorded_before_redesign_ms={name: RECORDED_BEFORE_ALIE_MS[(name, dt)]
                                          for name in ("fused_guard_gen", "gen_xi")})
        guard_sweep_line("fused_guard_gen", dt, lambda: fused_guard_gen_cuda(B, dlt, *operands),
                         ms_of(entries, f"fused_guard_gen[{dt}]"))
        del B, dlt, operands, alie, mom
        torch.cuda.empty_cache()
    return entries


# Integer operations the generator issues per generated element, counted
# from csrc/gen_rows.cuh (and matched against cuobjdump -sass of gen_xi's
# loop): threefry2x32 is one three-way XOR for the key parity, one add for
# the counter word, 20 rounds of add, funnel-shift rotate and XOR, four key
# injections of two adds (the constant folds into a three-input add) and a
# last add, 71 in all; the >> 9 of the mantissa ladder makes 72.  The
# float work per element (t = h·(x − x*), the ladder, ns·u + t: 8 flops) is
# counted at the f32 rate on its own pipe.
GEN_INT_OPS = 1 + 1 + 20 * 3 + 4 * 2 + 1 + 1
GEN_FLOPS = 8
# ALU issue rate per SM and clock on Hopper, for 32-bit integer operations
# and for compare, minimum and maximum (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0)
INT_OPS_PER_CLOCK_PER_SM = 64
# integer operations of the CountSketch's sign hash a coordinate: the add of
# the salt, two multiplies, two shift-xors (two each) and the sign bit's
# shift and or
HASH_OPS = 9


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def gen_bounds(dev, runs: int = 1) -> dict:
    """The bounds of the two generating kernels at the main path's shape
    under sign_flip (no moments pass: this run's data needs none), for one
    launch over ``runs`` runs (each with its own x, keys, slots, skews and
    parameters; h, x* and het_dir read once for all): the larger of the
    bytes over the HBM rate and the operations over their rate, the
    integer operations at 64 a clock per SM (SM count from
    ``torch.cuda.get_device_properties``, maximum SM clock from
    ``nvidia-smi``), the float operations at their type's peak."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = max_sm_clock_hz()
    int_rate = sms * INT_OPS_PER_CLOCK_PER_SM * clock
    R = runs
    vec_bytes = (R + 3) * D * 4 + R * (M * (2 + 1 + 1) + gradgen.GEN_NPARAMS) * 4
    int_ops = GEN_INT_OPS * R * M * D
    suffix = "" if R == 1 else "_runs"
    out = {}
    for dt in ("f32", "bf16"):
        e = torch.tensor([], dtype=DTYPES[dt]).element_size()
        # B read and B_new written in the stats dtype, δ, the generator's
        # operands, both Grams and A; the Grams, A and B + g as in
        # fused_guard, plus the generator's float work
        fg_bytes = R * (2 * M * D * e + D * e + (2 * M * M + M) * 4) + vec_bytes
        fg_flops = R * (4 * M * M * D + 2 * M * D + M * D)
        t_ops = max(fg_flops / PEAK_FLOPS[dt] + GEN_FLOPS * R * M * D / PEAK_FLOPS["f32"],
                    int_ops / int_rate)
        t_bytes = fg_bytes / HBM_BYTES_PER_S
        out[(f"fused_guard_gen{suffix}", dt)] = (1e3 * max(t_bytes, t_ops),
                                                 "bytes" if t_bytes >= t_ops else "operations")
        # gen_xi: the weights in, ξ and the Byzantine row sum out; two FMAs
        # per element besides the generator
        gx_bytes = vec_bytes + R * (2 * M * 4 + 2 * D * 4)
        t_ops = max((GEN_FLOPS + 4) * R * M * D / PEAK_FLOPS["f32"], int_ops / int_rate)
        t_bytes = gx_bytes / HBM_BYTES_PER_S
        out[(f"gen_xi{suffix}", dt)] = (1e3 * max(t_bytes, t_ops),
                                        "bytes" if t_bytes >= t_ops else "operations")
        for name, nbytes in ((f"fused_guard_gen{suffix}", fg_bytes), (f"gen_xi{suffix}", gx_bytes)):
            emit("bound", kernel=f"{name}[{dt}]", shape=[R, M, D] if R > 1 else [M, D],
                 bytes=nbytes, int_ops=int_ops, int_ops_per_element=GEN_INT_OPS, sm_count=sms,
                 max_sm_clock_hz=clock, int_ops_per_s=int_rate,
                 bound_ms=out[(name, dt)][0], bound_by=out[(name, dt)][1])
    return out


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

    # the generating step (generate="kernel", fused@f32) under each
    # scenario_static adversary of gen_main_path: no sampler and no attack
    # on the batch; the adversary's O(m) parameters, then the guard's two
    # generating kernels and the filter, then the adversary's feedback
    cfg = cfg._replace(generate="kernel")
    for attack in ("sign_flip", "alie"):
        state, step = make_guard_backend("fused", problem, cfg, dev)
        adv = ScenarioAdversary(scenario_static(attack), BASE["alpha"])
        adv_state = adv.init_state(M, D, device=dev)
        rank = byz_rank(prng.split(prng.PRNGKey(0, device=dev))[1], M)
        x, xi = x1, torch.zeros_like(x1)
        alive, n_alive = torch.ones(M, dtype=torch.bool, device=dev), torch.tensor(M, device=dev)
        rng = prng.PRNGKey(0, device=dev)
        parts = {"keys": [], "adversary": [], "guard": [], "feedback": [], "update": []}
        for k in range(12):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            rng, gkey, akey = prng.split(rng, 3)
            keys = prng.split(gkey, M)
            ev[1].record()
            mask = adv.mask_at(rank, k)
            ctx = {"true_grad": problem.grad(x), "V": problem.V, "step": k, "alive": alive,
                   "n_alive": n_alive, "prev_xi": xi}
            slot, params, w_byz = adv.gen_attack_ctx(mask, ctx, adv_state,
                                                     problem.gen.noise_scale)
            genctx = gradgen.GenStepCtx(worker_keys=keys, skewsign=torch.zeros(M, device=dev),
                                        slot=slot, params=params, w_byz=w_byz)
            ev[2].record()
            state, xi, n_alive, alive, byz_sum = step(state, genctx, x, x1)
            ev[3].record()
            byz_row = byz_sum / torch.clamp(torch.sum(mask), min=1)
            adv_state = adv.update_state_from_byz_row(adv_state, mask, byz_row, xi, alive,
                                                      n_alive, ctx)
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
        emit("step_split", run=f"{attack}@f32, generate='kernel'", ms=ms,
             total_ms=sum(ms.values()))


# ---------------------------------------------------------------- phase 11

SKEW_MAX = 0.5
SLOW_DELAY = 3
N_SLOW = 8            # the last 8 workers straggle
P_REPORT = 0.75
DEGENERATE_T = 32
# (run, config over BASE) of the straggling, partially participating fleet;
# dense@f32 is the oracle
FLEET_RUNS = (("fused@f32", dict(guard_backend="fused", stats_dtype="f32")),
              ("fused@bf16", dict(guard_backend="fused", stats_dtype="bf16")),
              ("dense@f32", dict(guard_backend="dense", stats_dtype="f32")))
FLEET_OPTS = dict(max_delay=SLOW_DELAY, partial_participation=True)


def fleet_profile(m: int, dev):
    """The last N_SLOW/32 of the workers refresh every SLOW_DELAY + 1 steps;
    each honest worker reports with probability P_REPORT a step."""
    n_slow = m * N_SLOW // M
    return worker_profile(m, delay=[0] * (m - n_slow) + [SLOW_DELAY] * n_slow,
                          p_report=P_REPORT, device=dev)


def require_clean_filter(name: str, res, n_byz: int) -> None:
    """Every sign-flipper filtered and no honest worker."""
    require(int(res.byz_mask.sum()) == n_byz
            and not bool((res.final_alive & res.byz_mask).any()),
            f"{name}: all {n_byz} sign-flippers filtered")
    require(not bool(res.ever_filtered_good), f"{name}: no honest worker filtered")


def profile_main_path(dev) -> None:
    """``run_sgd`` with worker profiles at the main path's shape under
    ``scenario_static("sign_flip")``: a skewed fleet on the materialising and
    the generating path, a straggling and partially participating fleet on
    the fused guard at f32 and bf16 against dense@f32, and the degenerate
    profile, armed, against no profile."""
    n_byz = int(BASE["alpha"] * M)
    sign_flip = scenario_static("sign_flip")
    het = heterogenize_generated(make_generated_problem(d=D, seed=0, device=dev), m=M,
                                 skew_max=SKEW_MAX)
    skewed = ScenarioAdversary(sign_flip, BASE["alpha"],
                               profile=profile_linear_skew(M, SKEW_MAX, device=dev))
    for sd in ("f32", "bf16"):
        out = {}
        for generate in ("off", "kernel"):
            cfg = SolverConfig(**{**BASE, "guard_backend": "fused", "stats_dtype": sd,
                                  "generate": generate})
            out[generate] = profiled_run(het, cfg, skewed, dev)
        (off, off_ms, off_n, off_mem), (gen, gen_ms, gen_n, gen_mem) = out["off"], out["kernel"]
        decisions = all(torch.equal(getattr(off, f), getattr(gen, f))
                        for f in ("n_alive", "final_alive", "byz_mask"))
        gaps_equal = torch.equal(off.gaps, gen.gaps)
        finite = all(bool(torch.isfinite(r.x_avg).all() and torch.isfinite(r.gaps).all())
                     for r in (off, gen))
        emit("profile_main_path", run=f"linear_skew@{sd}", skew_max=SKEW_MAX, V=het.V,
             ms_per_step={"off": off_ms, "kernel": gen_ms},
             max_memory_allocated_bytes={"off": off_mem, "kernel": gen_mem},
             final_gap={"off": float(off.gaps[-1]), "kernel": float(gen.gaps[-1])},
             n_alive_first_last=[int(off.n_alive[0]), int(off.n_alive[-1])],
             launches={"off": off_n, "kernel": gen_n},
             decisions_equal_at_every_step=decisions, gaps_bit_equal=gaps_equal,
             gaps_max_abs_diff=float((off.gaps - gen.gaps).abs().max()),
             x_avg_rel_abs=rel_err(gen.x_avg, off.x_avg), finite=finite)
        require(finite, f"linear_skew@{sd}: finite x_avg and gaps on both paths")
        require(gen_n == counts(fused_guard_gen=T, gen_xi=T),
                f"linear_skew@{sd} generate='kernel': launches {gen_n}")
        require(off_n == counts(fused_guard=T, filtered_mean=T),
                f"linear_skew@{sd} generate='off': launches {off_n}")
        require(decisions, f"linear_skew@{sd}: generating run decides as the materialising "
                           "run at every step")
        # (skew·sign)·het_dir in the kernels is skew·(sign·het_dir) on the
        # host (sign is ±1), so the generated rows are the sampled ones
        require(gaps_equal, f"linear_skew@{sd}: gaps bit-equal to the materialising run's")
        for r, path in ((off, "off"), (gen, "kernel")):
            require_clean_filter(f"linear_skew@{sd} {path}", r, n_byz)
        del off, gen, out

    problem = make_generated_problem(d=D, seed=0, device=dev)
    fleet = ScenarioAdversary(sign_flip, BASE["alpha"], profile=fleet_profile(M, dev))
    runs = {}
    for name, over in FLEET_RUNS:
        cfg = SolverConfig(**{**BASE, **over, **FLEET_OPTS})
        res, ms, got, mem = profiled_run(problem, cfg, fleet, dev)
        runs[name] = res
        finite = bool(torch.isfinite(res.x_avg).all() and torch.isfinite(res.gaps).all())
        emit("profile_main_path", run=f"stragglers_partial {name}", n_slow=N_SLOW,
             delay=SLOW_DELAY, p_report=P_REPORT, ms_per_step=ms,
             max_memory_allocated_bytes=mem, final_gap=float(res.gaps[-1]),
             n_alive_first_last=[int(res.n_alive[0]), int(res.n_alive[-1])],
             n_reporting_min_mean_max=[int(res.n_reporting.min()),
                                       float(res.n_reporting.float().mean()),
                                       int(res.n_reporting.max())],
             launches=got, finite=finite)
        require(finite, f"stragglers_partial {name}: finite x_avg and gaps")
        want = counts(fused_guard=T, filtered_mean=T) if name.startswith("fused") else counts()
        require(got == want, f"stragglers_partial {name}: launches {got}, expected {want}")
        require_clean_filter(f"stragglers_partial {name}", res, n_byz)
    dense = runs["dense@f32"]
    for name in ("fused@f32", "fused@bf16"):
        same = {f: torch.equal(getattr(runs[name], f), getattr(dense, f))
                for f in ("n_alive", "final_alive", "byz_mask", "n_reporting")}
        emit("profile_main_path", check="fleet_equal_to_dense", run=name, equal=same)
        require(all(same.values()), f"stragglers_partial {name}: decisions and n_reporting "
                                    f"equal dense@f32's at every step: {same}")
    del runs, dense

    cfg = SolverConfig(**{**BASE, "guard_backend": "fused", "T": DEGENERATE_T, **FLEET_OPTS})
    armed, armed_ms, armed_n, armed_mem = profiled_run(
        het, cfg, ScenarioAdversary(sign_flip, BASE["alpha"], profile=profile_iid(M, device=dev)),
        dev)
    plain, plain_ms, _, plain_mem = profiled_run(het, cfg, ScenarioAdversary(sign_flip,
                                                                             BASE["alpha"]), dev)
    same = {f: torch.equal(getattr(armed, f), getattr(plain, f))
            for f in ("x_final", "x_avg", "gaps", "n_alive", "final_alive", "byz_mask")}
    reporting = bool((armed.n_reporting == M).all())
    emit("profile_main_path", run="degenerate fused@f32", T=DEGENERATE_T,
         ms_per_step={"profile_iid": armed_ms, "none": plain_ms},
         max_memory_allocated_bytes={"profile_iid": armed_mem, "none": plain_mem},
         bit_equal_to_no_profile=same, n_reporting_all_m=reporting, launches=armed_n)
    require(all(same.values()), f"degenerate profile equals no profile bit for bit: {same}")
    require(reporting and plain.n_reporting is None, "degenerate profile: every worker reports")
    require(armed_n == counts(fused_guard=DEGENERATE_T, filtered_mean=DEGENERATE_T),
            f"degenerate profile: launches {armed_n}")


def fault_main_path(dev, series: dict) -> None:
    """Each plan of FAULT_PLANS on the adversary through ``run_sgd`` with
    ``sanitize="quarantine"`` at fused@f32: the n_alive series equals the
    one ``guard_loop`` gave for the plan, every victim is in ``byz_mask``,
    and only the sanitizing kernels run, T times each."""
    problem = make_generated_problem(d=D, seed=0, device=dev)
    steps = QUARANTINE_STEPS
    cfg = SolverConfig(**QUARANTINE_BASE, m=M, T=steps, guard_backend="fused",
                       stats_dtype="f32")
    for fault, plan in FAULT_PLANS.items():
        adv = ScenarioAdversary(scenario_static("sign_flip"), BASE["alpha"], faults=plan)
        res, ms, got, mem = profiled_run(problem, cfg, adv, dev)
        loop = series[fault]["fused@f32"]
        want_alive = loop["alive"].sum(dim=1)
        same = torch.equal(res.n_alive.cpu().to(want_alive.dtype), want_alive)
        victims = loop["victims"]
        held = bool(res.byz_mask.cpu()[victims].all())
        x_avg_equal = torch.equal(res.x_avg.cpu(), loop["x_avg"])
        emit("fault_main_path", fault=fault, run="fused@f32", T=steps, ms_per_step=ms,
             max_memory_allocated_bytes=mem, n_alive_at={k: int(res.n_alive[k]) for k in (
                 0, FAULT_START - 1, FAULT_START, steps - 1)},
             n_alive_equal_to_guard_loop=same, x_avg_bit_equal_to_guard_loop=x_avg_equal,
             victims=int(victims.sum()), victims_in_byz_mask=held,
             n_byz_mask=int(res.byz_mask.sum()),
             ever_filtered_good=bool(res.ever_filtered_good),
             xi_finite=bool(torch.isfinite(res.x_avg).all()), launches=got)
        require(same, f"fault_main_path {fault}: n_alive equals guard_loop's at every step")
        require(held and int(victims.sum()) > 0, f"fault_main_path {fault}: every victim in "
                                                 "byz_mask")
        require(bool(torch.isfinite(res.x_avg).all()), f"fault_main_path {fault}: finite x_avg")
        want = counts(fused_guard_sanitize=steps, filtered_mean_sanitize=steps)
        require(got == want, f"fault_main_path {fault}: launches {got}, expected {want}")


PROFILE_REF = [("linear_skew", "off"), ("linear_skew", "kernel"), ("stragglers", "off"),
               ("partial", "off")]


def profile_reference(dev) -> None:
    """The skewed (both paths), straggling and partial runs on the card
    against the CPU's plain-version runs on a small input."""
    m, d, steps = 8, 4099, 40
    for name, generate in PROFILE_REF:
        over = {"stragglers": dict(max_delay=SLOW_DELAY),
                "partial": dict(partial_participation=True)}.get(name, {})
        kw = dict(m=m, T=steps, eta=0.05, alpha=0.25, aggregator="byzantine_sgd",
                  guard_backend="fused", generate=generate, **over)
        out = {}
        for where in (dev, "cpu"):
            problem = make_generated_problem(d=d, seed=1, device=where)
            if name == "linear_skew":
                problem = heterogenize_generated(problem, m=m, skew_max=SKEW_MAX)
                profile = profile_linear_skew(m, SKEW_MAX, device=where)
            else:
                profile = fleet_profile(m, where)
            adv = ScenarioAdversary(scenario_static("sign_flip"), 0.25, profile=profile)
            reset_counts()
            out[where] = run_sgd(problem, SolverConfig(**kw), prng.PRNGKey(1), adversary=adv,
                                 device=where)
            if where == dev:
                launched = read_counts()
        got, want = out[dev], out["cpu"]
        fields = ["n_alive", "final_alive", "byz_mask"] + (
            ["n_reporting"] if name == "partial" else [])
        same = all(torch.equal(getattr(got, f).cpu(), getattr(want, f)) for f in fields)
        err = rel_err(got.x_avg.cpu(), want.x_avg)
        emit("profile_reference", run=f"{name} generate={generate}", decisions_equal=same,
             x_avg_rel_abs=err, launches=launched)
        require(same, f"{name} generate={generate}: card and CPU decisions equal")
        require(within(got.x_avg.cpu(), want.x_avg, 1e-5),
                f"{name} generate={generate}: card and CPU x_avg within 1e-5")
        per = (dict(fused_guard_gen=steps, gen_xi=steps) if generate == "kernel"
               else dict(fused_guard=steps, filtered_mean=steps))
        require(launched == counts(**per), f"{name} generate={generate}: launches {launched}")


# ---------------------------------------------------------------- campaigns

CAMPAIGN_T = 16   # cut from 32 for the MoE and Mamba phases (PERF.md §4)
CAMPAIGN_SEEDS = range(4)
# variant -> the kernels one step of a group launches, once for its R runs
CAMPAIGN_VARIANTS = {
    "byzantine_sgd@fused": {"fused_guard": 1, "filtered_mean": 1},
    "byzantine_sgd@fused@bf16": {"fused_guard": 1, "filtered_mean": 1},
    "byzantine_sgd@dense": {},
    "krum": {"gram": 1},
    "coordinate_median": {"coordinate_median": 1},
}
CAMPAIGN_GAP_RTOL = 1e-6   # a row against its run alone: batched products
CAMPAIGN_CHUNK_PEAK = 1.25  # the chunked campaign's peak against a chunk's
RUNS_R = 4                  # the run axis of the kernel timings
RUNS_BIG_D = 2 ** 24 + 3    # R·m·d > 2^31 at R = 4, m = 32 (bf16)


def campaign_grid(seeds=CAMPAIGN_SEEDS, churn: bool = True):
    scenarios = [("static", scenario_static("sign_flip"))]
    if churn:
        # one rotation at mid-run
        scenarios.append(("churn", scenario_churn("sign_flip", period=CAMPAIGN_T // 2,
                                                  stride=4)))
    return expand_grid(scenarios, [BASE["alpha"]], seeds)


def campaign_main_path(dev) -> tuple[dict, dict]:
    """``run_campaign`` at the main path's width: 2 groups (static and
    churning sign_flip) of R = 4 seeds, T = CAMPAIGN_T, each variant of
    CAMPAIGN_VARIANTS with the launch counts set to 0 just before it and
    read just after (each kernel T times a group, not T·R); one row of each
    group against its ``run_sgd`` alone (decisions equal, gaps within
    CAMPAIGN_GAP_RTOL); fused deciding as dense on every row; an 8-run
    campaign at chunk_size 2 against a 2-run campaign's peak memory; then
    the batched kernels' times at R = 4 against 4 launches of R = 1, the
    folding copy's, and one batched bf16 launch with R·m·d > 2^31 against
    its plain version.  Returns each variant's stats and peak bytes."""
    t0 = time.perf_counter()
    problem = make_generated_problem(d=D, seed=0, device=dev)
    cfg = SolverConfig(**{**BASE, "T": CAMPAIGN_T})
    grid = campaign_grid()
    groups = run_groups(grid)
    require(len(groups) == 2 and all(len(g) == 4 for g in groups), "2 groups of 4 runs")
    stats, peaks_of = {}, {}
    for variant, per_step in CAMPAIGN_VARIANTS.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reset_counts()
        res = run_campaign(problem, cfg, grid, [variant], return_gaps=True, device=dev)
        got = read_counts()
        st = stats[variant] = res.stats[variant]
        peaks_of[variant] = res.memory["peak_bytes"]
        want = counts(**{k: v * CAMPAIGN_T * len(groups) for k, v in per_step.items()})
        require(got == want, f"campaign {variant}: launches {got}, expected {want} "
                             f"(T a group, not T·R)")
        require(bool(torch.isfinite(st.gaps).all()), f"campaign {variant}: finite gaps")
        ms_batched = 1e3 * res.wall_s / (CAMPAIGN_T * len(groups))
        vcfg = expand_variants(cfg, [variant])[variant]
        rows = []
        for idx in groups:
            i = idx[1]
            adv = ScenarioAdversary(grid.scenarios[i], grid.alpha[i])
            torch.cuda.synchronize()
            ta = time.perf_counter()
            alone = run_sgd(problem, vcfg, prng.PRNGKey(int(grid.seeds[i])), adversary=adv,
                            device=dev)
            torch.cuda.synchronize()
            ms_alone = 1e3 * (time.perf_counter() - ta) / CAMPAIGN_T
            summary = _summarize(problem, vcfg, alone, True)
            decisions = all(torch.equal(getattr(st, f)[i], summary[f])
                            for f in ("n_alive_final", "n_byz_ever", "detect_latency",
                                      "ever_filtered_good"))
            gap_err = float((st.gaps[i] - alone.gaps).double().norm()
                            / alone.gaps.double().norm())
            rows.append({"row": i, "scenario": grid.entries[i]["scenario"],
                         "seed": int(grid.seeds[i]), "decisions_equal": decisions,
                         "gaps_rel_err": gap_err,
                         "gaps_bit_equal": bool(torch.equal(st.gaps[i], alone.gaps)),
                         "ms_per_step_alone": ms_alone})
            require(decisions and gap_err <= CAMPAIGN_GAP_RTOL,
                    f"campaign {variant} row {i}: equal to its run alone ({rows[-1]})")
        ms_alone = statistics.mean(r["ms_per_step_alone"] for r in rows)
        emit("campaign_main_path", variant=variant, runs=grid.n_runs, groups=len(groups),
             R=len(groups[0]), T=CAMPAIGN_T, launches=got, ms_per_batched_step=ms_batched,
             R_times_ms_per_step_alone=len(groups[0]) * ms_alone,
             peak_bytes=res.memory["peak_bytes"], compile_s=res.compile_s,
             n_alive_final=st.n_alive_final.tolist(), n_byz_ever=st.n_byz_ever.tolist(),
             detect_latency=st.detect_latency.tolist(), rows_alone=rows)

    fused, dense = stats["byzantine_sgd@fused"], stats["byzantine_sgd@dense"]
    same = {f: torch.equal(getattr(fused, f), getattr(dense, f))
            for f in ("n_alive_final", "n_byz_ever", "detect_latency", "ever_filtered_good")}
    emit("campaign_main_path", check="fused_decides_as_dense", equal=same)
    require(all(same.values()), f"campaign: fused decides as dense on every row: {same}")

    peaks = {}
    for name, n, chunk in (("2 runs", 2, None), ("8 runs at chunk_size 2", 8, 2)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        res = run_campaign(problem, cfg, campaign_grid(range(n), churn=False),
                           ["byzantine_sgd@fused"], chunk_size=chunk, device=dev)
        peaks[name] = res.memory["peak_bytes"]
    ratio = peaks["8 runs at chunk_size 2"] / peaks["2 runs"]
    emit("campaign_main_path", check="chunked_peak", peak_bytes=peaks, ratio=ratio,
         limit=CAMPAIGN_CHUNK_PEAK)
    require(ratio <= CAMPAIGN_CHUNK_PEAK, f"campaign: chunked peak {ratio:.3f}x a chunk's")
    del problem, fused, dense
    torch.cuda.empty_cache()
    batched_kernel_times(dev)
    batched_big_launch(dev)
    emit("campaign_main_path", seconds=time.perf_counter() - t0)
    return stats, peaks_of


def batched_kernel_times(dev) -> None:
    """One batched launch at R = 4 (m = 32, d = 2^20) against 4 launches
    of R = 1, by CUDA events (median_ms); the folding copy of the order
    statistics alone."""
    for dt in ("f32", "bf16"):
        gen = torch.Generator(device=dev).manual_seed(17)
        g = torch.randn(RUNS_R, M, D, device=dev, generator=gen, dtype=DTYPES[dt])
        B = torch.randn(RUNS_R, M, D, device=dev, generator=gen, dtype=DTYPES[dt])
        dlt = torch.randn(RUNS_R, D, device=dev, generator=gen, dtype=DTYPES[dt])
        w = torch.rand(RUNS_R, M, device=dev, generator=gen) / M
        cases = {
            "fused_guard": (lambda: fused_guard_runs_cuda(g, B, dlt),
                            lambda: [fused_guard_cuda(g[r], B[r], dlt[r]) for r in range(RUNS_R)]),
            "filtered_mean": (lambda: filtered_mean_runs_cuda(g, w, 1.0),
                              lambda: [filtered_mean_cuda(g[r], w[r], 1.0)
                                       for r in range(RUNS_R)]),
            "gram": (lambda: gram_runs_cuda(g),
                     lambda: [gram_cuda(g[r]) for r in range(RUNS_R)]),
            "coordinate_median": (lambda: coordinate_median_runs_cuda(g),
                                  lambda: [coordinate_median_cuda(g[r]) for r in range(RUNS_R)]),
            "countsketch": (lambda: countsketch_runs_cuda(g, SKETCH_K),
                            lambda: [countsketch_cuda(g[r], SKETCH_K) for r in range(RUNS_R)]),
        }
        def outs(x):
            return x if isinstance(x, tuple) else (x,)

        for name, (batched, alone) in cases.items():
            once = outs(batched())
            bits = all(torch.equal(a[r], b) for r, each in enumerate(alone())
                       for a, b in zip(once, outs(each)))
            emit("campaign_kernels", kernel=f"{name}[{dt}]", R=RUNS_R, shape=[M, D],
                 batched_ms=median_ms(batched, batches=5, per_batch=10),
                 R_launches_alone_ms=median_ms(alone, batches=5, per_batch=10),
                 bit_equal_to_runs_alone=bits)
            require(bits, f"{name}[{dt}] at R = {RUNS_R}: each run the bits of its launch")
        emit("campaign_kernels", kernel=f"fold_runs[{dt}]", R=RUNS_R, shape=[M, D],
             copy_ms=median_ms(lambda: fold_runs(g), batches=5, per_batch=10),
             copy_bytes=2 * g.numel() * g.element_size())
        del g, B, dlt
        torch.cuda.empty_cache()


def batched_big_launch(dev) -> None:
    """One batched bf16 ``fused_guard`` and ``filtered_mean`` launch with
    R·m·d > 2^31 (int64 run offsets) against the plain versions, run by
    run: ``B_new`` bit-equal, the rest within TOL, and each run equal to
    its own launch."""
    tdt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(23)
    g = torch.randn(RUNS_R, M, RUNS_BIG_D, device=dev, generator=gen, dtype=tdt)
    B = torch.randn(RUNS_R, M, RUNS_BIG_D, device=dev, generator=gen, dtype=tdt)
    dlt = torch.randn(RUNS_R, RUNS_BIG_D, device=dev, generator=gen, dtype=tdt)
    w = torch.rand(RUNS_R, M, device=dev, generator=gen) / M
    got = fused_guard_runs_cuda(g, B, dlt)
    xi = filtered_mean_runs_cuda(g, w, 1.0)
    errs, bits = [], []
    for r in range(RUNS_R):
        want = ref.fused_guard_ref(g[r], B[r], dlt[r])
        errs.append([rel_err(got[k][r], want[k])[0] for k in range(3)]
                    + [rel_err(xi[r], ref.filtered_mean_ref(g[r], w[r], 1.0))[0]])
        bits.append(bool(torch.equal(got[3][r], want[3])))
        del want
        alone = fused_guard_cuda(g[r], B[r], dlt[r])
        bits.append(all(torch.equal(got[k][r], alone[k]) for k in range(4))
                    and bool(torch.equal(xi[r], filtered_mean_cuda(g[r], w[r], 1.0))))
        del alone
    within_tol = all(e <= TOL["bf16"] for run in errs for e in run)   # a NaN fails
    emit("campaign_kernels", check="big_batched_launch", R=RUNS_R, m=M, d=RUNS_BIG_D,
         elements=RUNS_R * M * RUNS_BIG_D, rel_err=errs, tol=TOL["bf16"],
         B_new_and_runs_alone_bit_equal=all(bits))
    require(within_tol and all(bits),
            f"batched bf16 launch with R·m·d > 2^31: rel err {errs}, bits {bits}")
    del g, B, dlt, got, xi
    torch.cuda.empty_cache()


# ------------------------------------------- the generating kernels' run axis

# a campaign's gen variant -> the materialising variant it decides as
CAMPAIGN_GEN_VARIANTS = {"byzantine_sgd@gen": "byzantine_sgd@fused",
                         "byzantine_sgd@gen@bf16": "byzantine_sgd@fused@bf16"}
CAMPAIGN_GEN_GAP_ATOL = 1e-6   # the reference's criterion (tests/test_campaign_chunked.py)


def stacked_gen_operands(runs: list) -> list:
    """R runs' generator operands as the run entries take them: x, keys,
    skews, slots and parameters stacked; h, x* and het_dir the first
    run's, one for all (each run's own list is made to hold the same)."""
    stacked = [torch.stack([o[q] for o in runs]) for q in range(8)]
    for q in (1, 2, 3):
        stacked[q] = runs[0][q]
        for o in runs:
            o[q] = runs[0][q]
    return stacked


def gen_campaign_kernels(dev) -> None:
    """``fused_guard_gen`` and ``gen_xi`` over a run axis at R = 4 (m = 32,
    d = 2^20) on the main path's step-0 operands of seeds 0–3, under
    sign_flip and ALIE, f32 and bf16 sweeps, gen_xi at f32 and bf16
    statistics reading the batched sweep's moments: every run's outputs
    and moments bit-equal to its own one-run launch; the batched launch's
    ms against R launches alone (CUDA events); then one bf16 launch with
    R·m·d > 2^31 against its runs' own launches."""
    t0 = time.perf_counter()
    for attack in ("sign_flip", "alie"):
        made = [main_gen_operands(attack, dev, seed=r) for r in range(RUNS_R)]
        runs = [ops for ops, _ in made]
        stacked = stacked_gen_operands(runs)
        w_byz = torch.stack([w for _, w in made])
        w_xi = (stacked[6] == 0).float() / M
        for dt in ("f32", "bf16"):
            gen = torch.Generator(device=dev).manual_seed(29)
            B = torch.randn(RUNS_R, M, D, device=dev, generator=gen, dtype=DTYPES[dt])
            dlt = torch.randn(RUNS_R, D, device=dev, generator=gen, dtype=DTYPES[dt])
            got = fused_guard_gen_runs_cuda(B, dlt, *stacked)
            xi = {sd: gen_xi_runs_cuda(w_xi, w_byz, *stacked, stats_dtype=DTYPES[sd],
                                       moments=got[4]) for sd in DTYPES}
            # the moments are written only when an ALIE id is in play
            bits = {"fused_guard_gen": True, "gen_xi": True}
            if attack == "alie":
                bits["moments"] = True
            for r in range(RUNS_R):
                mom = torch.empty((2, D), device=dev)
                alone = fused_guard_gen_cuda(B[r], dlt[r], *runs[r], moments=mom)
                bits["fused_guard_gen"] &= all(torch.equal(a[r], b) for a, b in zip(got, alone))
                if attack == "alie":
                    bits["moments"] &= bool(torch.equal(got[4][r], mom))
                for sd in DTYPES:
                    own = gen_xi_cuda(w_xi[r], w_byz[r], *runs[r], stats_dtype=DTYPES[sd],
                                      moments=mom)
                    bits["gen_xi"] &= all(torch.equal(a[r], b) for a, b in zip(xi[sd], own))
            sd = DTYPES[dt]
            emit("gen_campaign_kernels", attack=attack, dtype=dt, R=RUNS_R, shape=[M, D],
                 bit_equal_to_runs_alone=bits,
                 fused_guard_gen_batched_ms=median_ms(
                     lambda: fused_guard_gen_runs_cuda(B, dlt, *stacked), batches=5, per_batch=5),
                 fused_guard_gen_R_launches_alone_ms=median_ms(
                     lambda: [fused_guard_gen_cuda(B[r], dlt[r], *runs[r]) for r in range(RUNS_R)],
                     batches=5, per_batch=5),
                 gen_xi_batched_ms=median_ms(
                     lambda: gen_xi_runs_cuda(w_xi, w_byz, *stacked, stats_dtype=sd,
                                              moments=got[4]), batches=5, per_batch=5),
                 gen_xi_R_launches_alone_ms=median_ms(
                     lambda: [gen_xi_cuda(w_xi[r], w_byz[r], *runs[r], stats_dtype=sd,
                                          moments=got[4][r]) for r in range(RUNS_R)],
                     batches=5, per_batch=5))
            require(all(bits.values()), f"gen kernels at R = {RUNS_R} ({attack}, {dt}): "
                                        f"each run the bits of its own launch: {bits}")
            del B, dlt, got, xi
            torch.cuda.empty_cache()
    # R·m·d > 2^31 (int64 run offsets), bf16, sign_flip
    runs = [gen_operands(M, RUNS_BIG_D, 1, dev, seed=r) for r in range(RUNS_R)]
    stacked = stacked_gen_operands(runs)
    gen = torch.Generator(device=dev).manual_seed(31)
    B = torch.randn(RUNS_R, M, RUNS_BIG_D, device=dev, generator=gen, dtype=torch.bfloat16)
    dlt = torch.randn(RUNS_R, RUNS_BIG_D, device=dev, generator=gen, dtype=torch.bfloat16)
    w_xi = (stacked[6] == 0).float() / M
    w_byz = (stacked[6] > 0).float()
    got = fused_guard_gen_runs_cuda(B, dlt, *stacked)
    xi = gen_xi_runs_cuda(w_xi, w_byz, *stacked, stats_dtype=torch.bfloat16, moments=got[4])
    bits = []
    for r in range(RUNS_R):
        mom = torch.empty((2, RUNS_BIG_D), device=dev)
        alone = fused_guard_gen_cuda(B[r], dlt[r], *runs[r], moments=mom)
        own = gen_xi_cuda(w_xi[r], w_byz[r], *runs[r], stats_dtype=torch.bfloat16, moments=mom)
        bits.append(all(torch.equal(a[r], b) for a, b in zip(got, alone))
                    and all(torch.equal(a[r], b) for a, b in zip(xi, own)))
        del alone, own, mom
    emit("gen_campaign_kernels", check="big_batched_launch", R=RUNS_R, m=M, d=RUNS_BIG_D,
         elements=RUNS_R * M * RUNS_BIG_D, bit_equal_to_runs_alone=bits)
    require(all(bits), f"batched bf16 gen launch with R·m·d > 2^31: runs alone {bits}")
    del B, dlt, got, xi, runs, stacked
    torch.cuda.empty_cache()
    emit("gen_campaign_kernels", seconds=time.perf_counter() - t0)


def campaign_gen_main_path(dev, fused_stats: dict, fused_peaks: dict) -> dict:
    """``run_campaign`` at campaign_main_path's grid (m = 32, d = 2^20,
    T = CAMPAIGN_T, static and churning sign_flip × seeds 0–3) with the variants
    ``gen`` and ``gen@bf16``, the launch counts set to 0 just before each
    and read just after: ``fused_guard_gen`` and ``gen_xi`` T times a group
    and no other kernel; every row decides as the materialising variant's
    row of campaign_main_path (``n_alive_final``, ``detect_latency``
    equal, ``gap_final`` within 1e-6); the peak memory below the
    materialising variant's by at least R × the (m, d) f32 batch; ms a
    batched step against R × one generating step alone.  Returns the
    launch counts."""
    t0 = time.perf_counter()
    problem = make_generated_problem(d=D, seed=0, device=dev)
    cfg = SolverConfig(**{**BASE, "T": CAMPAIGN_T})
    grid = campaign_grid()
    groups = run_groups(grid)
    R = len(groups[0])
    launches = {}
    for variant, fused_name in CAMPAIGN_GEN_VARIANTS.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reset_counts()
        res = run_campaign(problem, cfg, grid, [variant], return_gaps=True, device=dev)
        got = launches[variant] = read_counts()
        st, fu = res.stats[variant], fused_stats[fused_name]
        want = counts(fused_guard_gen=CAMPAIGN_T * len(groups), gen_xi=CAMPAIGN_T * len(groups))
        require(got == want, f"campaign {variant}: launches {got}, expected {want}")
        same = {f: bool(torch.equal(getattr(st, f), getattr(fu, f)))
                for f in ("n_alive_final", "detect_latency", "n_byz_ever", "ever_filtered_good")}
        gap_err = float((st.gap_final - fu.gap_final).abs().max())
        peak, batch = res.memory["peak_bytes"], R * M * D * 4
        vcfg = expand_variants(cfg, [variant])[variant]
        i = groups[0][0]
        _, ms_alone, _, _ = profiled_run(problem, vcfg,
                                         ScenarioAdversary(grid.scenarios[i], grid.alpha[i]), dev)
        emit("campaign_gen_main_path", variant=variant, decides_as=fused_name,
             runs=grid.n_runs, groups=len(groups), R=R, T=CAMPAIGN_T, launches=got,
             decisions_equal=same, gap_final_max_abs_diff=gap_err,
             ms_per_batched_step=1e3 * res.wall_s / (CAMPAIGN_T * len(groups)),
             R_times_ms_per_step_alone=R * ms_alone,
             peak_bytes=peak, materialising_peak_bytes=fused_peaks[fused_name],
             R_times_batch_bytes=batch, n_alive_final=st.n_alive_final.tolist(),
             detect_latency=st.detect_latency.tolist())
        require(all(same.values()) and gap_err <= CAMPAIGN_GEN_GAP_ATOL,
                f"campaign {variant}: decides as {fused_name} ({same}, gap diff {gap_err})")
        require(bool(torch.isfinite(st.gaps).all()), f"campaign {variant}: finite gaps")
        require(peak + batch <= fused_peaks[fused_name],
                f"campaign {variant}: peak {peak} B not below {fused_name}'s "
                f"{fused_peaks[fused_name]} B by R x the (m, d) f32 batch")
    emit("campaign_gen_main_path", seconds=time.perf_counter() - t0)
    return launches


def gen_runs_entries(dev, launches: dict) -> list:
    """The kernels line's entries of the two generating kernels over a run
    axis: R = 4 runs of the main path's step-0 operands under sign_flip
    (seeds 0–3), the launch count from campaign_gen_main_path, the batched
    launch's ms, the plain versions over the R runs, and the bound of the
    R runs' work."""
    bounds = gen_bounds(dev, runs=RUNS_R)
    made = [main_gen_operands("sign_flip", dev, seed=r) for r in range(RUNS_R)]
    runs = [ops for ops, _ in made]
    stacked = stacked_gen_operands(runs)
    w_byz = torch.stack([w for _, w in made])
    w_xi = (stacked[6] == 0).float() / M
    entries = []
    for dt, variant in (("f32", "byzantine_sgd@gen"), ("bf16", "byzantine_sgd@gen@bf16")):
        sd = DTYPES[dt]
        gen = torch.Generator(device=dev).manual_seed(37)
        B = torch.randn(RUNS_R, M, D, device=dev, generator=gen, dtype=sd)
        dlt = torch.randn(RUNS_R, D, device=dev, generator=gen, dtype=sd)
        calls = {
            "fused_guard_gen_runs": (
                lambda: fused_guard_gen_runs_cuda(B, dlt, *stacked)[:4],
                lambda: [ref.fused_guard_gen_ref(B[r], dlt[r], *runs[r]) for r in range(RUNS_R)]),
            "gen_xi_runs": (
                lambda: gen_xi_runs_cuda(w_xi, w_byz, *stacked, stats_dtype=sd),
                lambda: [ref.gen_xi_ref(w_xi[r], w_byz[r], *runs[r], stats_dtype=sd)
                         for r in range(RUNS_R)]),
        }
        for name, (kernel, plain) in calls.items():
            got, want = kernel(), plain()
            pairs = [(a[r], b) for r in range(RUNS_R) for a, b in zip(got, want[r])]
            err = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
            rel = max(rel_err(a, b)[0] for a, b in pairs)
            emit("gen_runs_check", kernel=f"{name}[{dt}]", R=RUNS_R, max_rel_err=rel,
                 max_abs_err=err, tol=TOL[dt])
            require(all(within(a.float(), b.float(), TOL[dt]) for a, b in pairs),
                    f"{name}[{dt}] at R = {RUNS_R} within {TOL[dt]} of the plain version")
            b_ms, b_by = bounds[(name, dt)]
            entries.append({
                "name": f"{name}[{dt}]", "route": "cuda", "source": source_of(name, dt),
                "replaces": KERNELS[name][1],
                "launches": launches[variant][name.removesuffix("_runs")],
                "max_abs_err": err, "ms": median_ms(kernel, batches=5, per_batch=5),
                "plain_ms": median_ms(plain, batches=3, per_batch=1),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            })
            del got, want
        del B, dlt
        torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------- telemetry

TELEMETRY_T = 32
TELEMETRY_RESYNC = 16   # resyncs at steps 16 and 32 (the default 64 cut to T)
TELEMETRY_RUNS = {
    "fused@f32": dict(guard_backend="fused", stats_dtype="f32"),
    "fused@bf16": dict(guard_backend="fused", stats_dtype="bf16"),
    "gen": dict(guard_backend="fused", generate="kernel"),
    "dense@f32": dict(guard_backend="dense"),
    "krum": dict(aggregator="krum"),
    "dp_sketch": dict(guard_backend="dp_sketch"),
    "fused_quarantine": dict(guard_backend="fused", sanitize="quarantine"),
}
# where each run's frames hold a finite gram_drift: at resync steps
# (fused, generating), every step (dense: 0), never (the rest)
DRIFT_AT = {"fused@f32": "resync", "fused@bf16": "resync", "gen": "resync",
            "fused_quarantine": "resync", "dense@f32": "every"}
FRAME_EXACT = ("alive", "n_alive", "step")


def frames_close(got: list, want: list, tol: float) -> dict:
    """Frames of one run on the card against the CPU's: the exact keys
    equal, NaN where the other has NaN, every other float within ``tol``
    relative (‖got − want‖ ≤ tol·‖want‖ + tol); ``gram_drift`` within tol
    relative plus 1e-6·𝔗_B² (at f32 the incremental Gram's rounding
    noise, which moves with the order of the sums).  Returns the failing
    keys."""
    bad = set()
    for a, b in zip(got, want):
        for k in a:
            x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
            if not np.array_equal(np.isnan(x), np.isnan(y)):
                bad.add(k)
            elif k in FRAME_EXACT:
                if not np.array_equal(x, y):
                    bad.add(k)
            elif k == "gram_drift":
                if not np.isnan(y) and abs(x - y) > tol * abs(y) + 1e-6 * float(b["thr_b"]) ** 2:
                    bad.add(k)
            else:
                x, y = np.nan_to_num(x), np.nan_to_num(y)
                if np.linalg.norm(x - y) > tol * np.linalg.norm(y) + tol:
                    bad.add(k)
    return {"n_frames": [len(got), len(want)], "failed": sorted(bad)}


def telemetry_phase(dev) -> None:
    """The flight recorder through ``run_sgd`` at the main path's shape
    (T = 32, the guard's Gram re-derived every 16 steps): each run of
    TELEMETRY_RUNS armed against off, bits and kernel
    launches equal, ``gram_drift`` finite where DRIFT_AT says and NaN
    elsewhere, ms a step armed against off; the same runs armed on the
    card and on the CPU at d = 4099, m = 8, T = 70 (frames_close); one
    armed campaign (fused and gen) through ``campaign_trace_events`` into
    an ``EventLog``, its JSONL and Chrome trace written under build/ and
    read back; the guard steps' time against guard_cost's H100 figure."""
    t0 = time.perf_counter()
    problem = make_generated_problem(d=D, seed=0, device=dev)
    adv = ScenarioAdversary(scenario_static("sign_flip"), BASE["alpha"])
    tel = TelemetryConfig(ring_size=128)
    for name, over in TELEMETRY_RUNS.items():
        cfg = SolverConfig(**{**BASE, "T": TELEMETRY_T, **over,
                              "guard_opts": (("gram_resync_every", TELEMETRY_RESYNC),)})
        off, off_ms, off_n, _ = profiled_run(problem, cfg, adv, dev)
        on, on_ms, on_n, _ = profiled_run(problem, cfg, adv, dev, telemetry=tel)
        bits = all(torch.equal(getattr(on, f), getattr(off, f))
                   for f in on._fields if f not in ("telemetry", "n_reporting"))
        frames = ring_read(on.telemetry.ring)
        drift = np.array([f["gram_drift"] for f in frames], np.float64)
        steps = np.array([f["step"] for f in frames], np.int64)
        where = DRIFT_AT.get(name)
        want_finite = (steps % TELEMETRY_RESYNC == 0 if where == "resync"
                       else np.full(len(steps), where == "every"))
        emit("telemetry", run=name, T=TELEMETRY_T, frames=len(frames),
             ms_per_step={"off": off_ms, "armed": on_ms}, launches={"off": off_n, "armed": on_n},
             bit_equal_to_off=bits, gram_drift_finite_steps=steps[np.isfinite(drift)].tolist(),
             gram_drift=[float(v) for v in drift[np.isfinite(drift)]],
             first_filter_step=on.telemetry.first_filter_step.tolist(),
             byz_alive_last=int(on.telemetry.byz_alive[-1]),
             last_frame={k: float(frames[-1][k]) for k in ("n_alive", "thr_a", "thr_b", "thr_g",
                                                           "xi_norm", "v_est", "adapt_scale")})
        require(bits and on_n == off_n, f"telemetry {name}: armed equals off (bits {bits}, "
                                        f"launches {on_n} vs {off_n})")
        require(len(frames) == TELEMETRY_T and np.array_equal(np.isfinite(drift), want_finite),
                f"telemetry {name}: gram_drift finite at {steps[np.isfinite(drift)].tolist()}")
        del off, on
    # the card against the CPU on a small input
    for name, over in TELEMETRY_RUNS.items():
        kw = {**dict(m=8, T=70, eta=0.05, alpha=0.25, aggregator="byzantine_sgd"), **over}
        got = run_sgd(make_generated_problem(d=4099, seed=1, device=dev), SolverConfig(**kw),
                      prng.PRNGKey(1), adversary=adv, telemetry=tel, device=dev)
        want = run_sgd(make_generated_problem(d=4099, seed=1, device="cpu"), SolverConfig(**kw),
                       prng.PRNGKey(1), adversary=adv, telemetry=tel, device="cpu")
        close = frames_close(ring_read(got.telemetry.ring), ring_read(want.telemetry.ring),
                             TOL[over.get("stats_dtype", "f32")])
        series = all(torch.equal(getattr(got.telemetry, f).cpu(), getattr(want.telemetry, f))
                     for f in ("first_filter_step", "byz_alive"))
        emit("telemetry_reference", run=name, **close, series_equal=series)
        require(not close["failed"] and series, f"telemetry {name}: card frames as the CPU's")
    telemetry_campaign(dev)
    guard_step_roofline(dev)
    emit("telemetry", seconds=time.perf_counter() - t0)


def telemetry_campaign(dev) -> None:
    """One armed campaign (fused and gen; m = 32, d = 2^16, T = CAMPAIGN_T, static
    and churning sign_flip × seeds 0–3) drained into an ``EventLog``; the
    JSONL and the Chrome trace written under build/telemetry/ and read
    back."""
    from repro_torch.scenarios import campaign_trace_events

    problem = make_generated_problem(d=2 ** 16, seed=0, device=dev)
    cfg = SolverConfig(**{**BASE, "T": CAMPAIGN_T})
    grid = campaign_grid()
    res = run_campaign(problem, cfg, grid, ["byzantine_sgd"], backends=("fused", "gen"),
                       telemetry=TelemetryConfig(ring_size=16), device=dev)
    log = EventLog(phase="telemetry_campaign")
    n_cells = campaign_trace_events(res, log)
    out = Path(__file__).resolve().parent / "build" / "telemetry"
    out.mkdir(parents=True, exist_ok=True)
    log.write_jsonl(str(out / "campaign.jsonl"))
    log.write_chrome_trace(str(out / "campaign_trace.json"))
    meta, events = EventLog.read_jsonl(str(out / "campaign.jsonl"))
    trace = json.loads((out / "campaign_trace.json").read_text())
    n_steps = sum(e["type"] == "guard_step" for e in events)
    counters = sum(e["ph"] == "C" for e in trace["traceEvents"])
    emit("telemetry_campaign", cells=n_cells, events=len(events), guard_step_events=n_steps,
         chrome_counter_events=counters, card=meta.get("card_name"),
         power_limit=meta.get("power_limit"), path=str(out.relative_to(out.parents[1])))
    require(n_cells == 2 * grid.n_runs and n_steps == n_cells * 16 and counters >= 2 * n_steps,
            f"telemetry campaign: {n_cells} cells, {n_steps} frames, {counters} counters")


def guard_step_roofline(dev) -> None:
    """The guard's step alone (``make_aggregator``'s step on the main
    path's step-0 batch or generator operands; CUDA events, median) for
    the fused, dense and generating guards at f32 and bf16, beside
    guard_cost's bytes-bound H100 figure (``obs.roofline_rows``)."""
    problem = make_generated_problem(d=D, seed=0, device=dev)
    keys = prng.split(prng.PRNGKey(3, device=dev), M)
    grads = problem.stoch_grad(keys, problem.x1)
    x1 = problem.x1
    operands, w_byz = main_gen_operands("sign_flip", dev)
    genctx = gradgen.GenStepCtx(worker_keys=operands[4], skewsign=operands[5], slot=operands[6],
                                params=operands[7], w_byz=w_byz)
    measured = {}
    for spec, over in (("fused", {}), ("fused@bf16", dict(stats_dtype="bf16")),
                       ("dense", dict(guard_backend="dense")),
                       ("gen", dict(generate="kernel")),
                       ("gen@bf16", dict(generate="kernel", stats_dtype="bf16"))):
        cfg = SolverConfig(**{**BASE, "guard_backend": "fused", **over})
        state0, step = make_aggregator(problem, cfg, dev)
        batch = genctx if cfg.generate == "kernel" else grads
        measured[spec] = 1e3 * median_ms(lambda: step(state0, batch, x1, x1), batches=5,
                                         per_batch=10)
    for row in roofline_rows(measured, M, D):
        emit("guard_roofline", **row, hbm_bytes_per_s=guard_cost.H100.hbm_bw)


def bitflip_campaign(dev) -> None:
    """A campaign with a ``bitflip`` fault axis on the card's torch (the
    flip is ``repro_torch::flip_bits``, a custom op with its own vmap
    rule): m = 32, d = 4099, T = 16, ``sanitize="quarantine"``, static
    sign_flip × seeds 0–1 × {none, bitflip on 4 workers from step 4}, the
    fused guard and coordinate_median; every row's n_alive series and
    final membership equal to its run alone; then the flip of a (4, 32,
    2^20) f32 stack under vmap bit-equal to each run's own flip."""
    from torch.func import vmap

    t0 = time.perf_counter()
    problem = make_generated_problem(d=4099, seed=0, device=dev)
    cfg = SolverConfig(**{**BASE, "T": 16, "sanitize": "quarantine"})
    plan = faults.fault_bitflip(0.125, start_step=4)
    grid = expand_grid([("static", scenario_static("sign_flip"))], [BASE["alpha"]],
                       range(2), faults=[("none", None), ("bitflip", plan)])
    variants = ["byzantine_sgd@fused", "coordinate_median"]
    res = run_campaign(problem, cfg, grid, variants, return_gaps=True, device=dev)
    rows_equal = {}
    for name in variants:
        vcfg = expand_variants(cfg, [name])[name]
        st = res.stats[name]
        ok = True
        for i, e in enumerate(res.entries):
            alone = run_sgd(problem, vcfg, prng.PRNGKey(int(grid.seeds[i]), device=dev),
                            adversary=ScenarioAdversary(grid.scenarios[i], grid.alpha[i],
                                                        faults=grid.faults[i]), device=dev)
            summary = _summarize(problem, vcfg, alone, True)
            ok &= all(torch.equal(getattr(st, f)[i], summary[f])
                      for f in ("n_alive_final", "n_byz_ever", "detect_latency",
                                "ever_filtered_good"))
        rows_equal[name] = ok
    keys = torch.stack([prng.PRNGKey(s, device=dev) for s in CAMPAIGN_SEEDS])
    gen = torch.Generator(device=dev).manual_seed(41)
    stack = torch.randn(len(CAMPAIGN_SEEDS), M, D, device=dev, generator=gen)
    rank = torch.arange(M, device=dev)
    flipped = vmap(lambda k, g: faults.apply_fault_plan(plan, k, g, rank, 4))(keys, stack)
    flip_bits = all(torch.equal(flipped[r].view(torch.int32),
                                faults.apply_fault_plan(plan, keys[r], stack[r], rank, 4)
                                .view(torch.int32)) for r in range(len(CAMPAIGN_SEEDS)))
    emit("bitflip_campaign", torch=torch.__version__, runs=grid.n_runs, T=cfg.T,
         rows_equal_to_runs_alone=rows_equal, vmapped_flip_bit_equal=flip_bits,
         n_alive_final={n: res.stats[n].n_alive_final.tolist() for n in variants},
         seconds=time.perf_counter() - t0)
    require(all(rows_equal.values()) and flip_bits,
            f"bitflip campaign: rows {rows_equal}, flip bits {flip_bits}")


# ---------------------------------------------------------------- phase 12

# quickstart's d, and the logistic problem's (a bf16 row of 20 bytes: every
# row after the first starts off a 16-byte boundary)
SMALL_WIDTHS = ((16, 16), (16, 10))
SMALL_SKETCH_K = (4096, 8)   # the dp guards' default sketch_dim (k > d), and k < d


def small_width_kernels(dev) -> None:
    """Every kernel of the convex harness's paths against its plain version
    at m = 16 and d = 16 and 10, f32 and bf16: the median and ``B_new``
    bit-equal, the rest within TOL; the sanitizing guard kernels on
    poisoned input, as in phase 3."""
    t0 = time.perf_counter()
    for m, d in SMALL_WIDTHS:
        n_trim = min(N_TRIM, (m - 1) // 2)
        for dt in ("f32", "bf16"):
            tol = TOL[dt]
            gen = torch.Generator(device=dev).manual_seed(m * 613 + d)
            g = torch.randn(m, d, device=dev, generator=gen, dtype=DTYPES[dt])
            B = torch.randn(m, d, device=dev, generator=gen, dtype=DTYPES[dt]).mul_(3)
            dlt = torch.randn(d, device=dev, generator=gen, dtype=DTYPES[dt])
            w = (torch.rand(m, device=dev, generator=gen) > 0.3).float() / m
            ok, err = {}, {}

            def close(name, got, want):
                ok[name] = bool(got.shape == want.shape) and within(got, want, tol)
                err[name] = rel_err(got, want)[1]

            got, want = fused_guard_cuda(g, B, dlt), ref.fused_guard_ref(g, B, dlt)
            ok["fused_guard B_new bit-equal"] = torch.equal(got[3], want[3])
            for name, a, b in zip(("gram_g", "cross", "a_inc"), got[:3], want[:3]):
                close(f"fused_guard {name}", a, b)
            close("filtered_mean", filtered_mean_cuda(g, w, 1.0), ref.filtered_mean_ref(g, w, 1.0))
            close("gram", gram_cuda(g), ref.gram_ref(g))
            ok["coordinate_median bit-equal"] = torch.equal(coordinate_median_cuda(g),
                                                            ref.coordinate_median_ref(g))
            close("trimmed_mean", trimmed_mean_cuda(g, n_trim), ref.trimmed_mean_ref(g, n_trim))
            for k in SMALL_SKETCH_K:
                close(f"countsketch k={k}", countsketch_cuda(g, k), ref.countsketch_ref(g, k))
            p = poison(g.clone())
            got = fused_guard_cuda(p, B, dlt, sanitize=True)
            want = ref.fused_guard_sanitize_ref(p, B, dlt)
            ok["fused_guard_sanitize nf equal"] = torch.equal(got[4], want[4])
            ok["fused_guard_sanitize B_new bit-equal"] = torch.equal(got[3], want[3])
            for name, a, b in zip(("gram_g", "cross", "a_inc"), got[:3], want[:3]):
                close(f"fused_guard_sanitize {name}", a, b)
            xi = filtered_mean_cuda(p, w, 1.0, sanitize=True)
            close("filtered_mean_sanitize", xi, ref.filtered_mean_sanitize_ref(p, w, 1.0))
            ok["filtered_mean_sanitize finite"] = bool(torch.isfinite(xi).all())
            torch.cuda.synchronize()
            failed = [name for name, good in ok.items() if not good]
            emit("small_width_kernels", m=m, d=d, dtype=dt, n_trim=n_trim, tol=tol,
                 checks=len(ok), failed=failed, max_abs_err=err)
            require(not failed, f"small widths m={m} d={d} {dt}: {failed}")
    emit("small_width_kernels", seconds=time.perf_counter() - t0)


# The convex harness: the problems of the paper's own experiments, each
# configuration as its source in the JAX package sets it.
CONVEX_PROBLEMS = {
    # examples/quickstart.py and benchmarks/bench_filtering.bench_detection_latency
    "quadratic": lambda dev: make_quadratic_problem(d=16, sigma=1.0, L=8.0, V=1.0, seed=0,
                                                    device=dev),
    # tests/test_convergence.py's fixture (the epoch solver's problem)
    "quadratic_seed1": lambda dev: make_quadratic_problem(d=16, sigma=1.0, L=8.0, V=1.0,
                                                          seed=1, device=dev),
    "least_squares": lambda dev: make_least_squares_problem(d=16, seed=0, device=dev),
    # tests/test_convergence.py::test_logistic_regression_under_attack
    "logistic": lambda dev: make_logistic_problem(d=10, n_data=256, reg=1e-2, seed=2,
                                                  device=dev),
}
CONVEX_BASE = dict(m=16, eta=0.05, alpha=0.25, attack="sign_flip", aggregator="byzantine_sgd")
# name -> (problem, config over CONVEX_BASE, the kernels a step launches)
FUSED = {"fused_guard": 1, "filtered_mean": 1}
QUICKSTART_RUNS = {
    "mean": ("quadratic", dict(aggregator="mean", T=2000), {}),
    "krum": ("quadratic", dict(aggregator="krum", T=2000), {"gram": 1}),
    "coordinate_median": ("quadratic", dict(aggregator="coordinate_median", T=2000),
                          {"coordinate_median": 1}),
    "byzantine_sgd": ("quadratic", dict(guard_backend="fused", T=2000), FUSED),
    "guard_backend=dense": ("quadratic", dict(guard_backend="dense", T=500), {}),
    "guard_backend=fused": ("quadratic", dict(guard_backend="fused", T=500), FUSED),
    "guard_backend=dp_sketch": ("quadratic", dict(guard_backend="dp_sketch", T=500),
                                {"countsketch": 1, "filtered_mean": 1}),
    "hidden_shift": ("quadratic", dict(attack="hidden_shift", guard_backend="fused", T=2000),
                     FUSED),
}
DETECTION_ATTACKS = ("sign_flip", "random_gaussian", "alie", "constant_drift",
                     "inner_product", "hidden_shift")
# the detection loop's runs; sign_flip and hidden_shift are quickstart's
DETECTION_SAME_AS = {"sign_flip": "byzantine_sgd", "hidden_shift": "hidden_shift"}
DETECTION_RUNS = {f"detection {a}": ("quadratic", dict(attack=a, guard_backend="fused",
                                                       T=2000), FUSED)
                  for a in DETECTION_ATTACKS if a not in DETECTION_SAME_AS}
HARNESS_RUNS = {
    "least_squares": ("least_squares", dict(guard_backend="fused", T=2000), FUSED),
    "logistic": ("logistic", dict(guard_backend="fused", T=2000, eta=0.1), FUSED),
}
CONVEX_RUNS = {**QUICKSTART_RUNS, **DETECTION_RUNS, **HARNESS_RUNS}
# tests/test_convergence.py::TestScaling::test_epoch_solver_reaches_epsilon,
# its epochs cut from 4000 steps to 2000: the pool's longest task (306 s of
# a 320 s pool at 4000) made room for the MoE and Mamba phases (PERF.md
# §4); the last gap is still held below 5e-3 (it read 9.8e-6 at 4000)
EPOCH_CFG = dict(m=16, alpha=0.25, epsilon=2e-3, attack="sign_flip", t_scale=0.05,
                 max_t_per_epoch=2000)
EPOCH = "epoch_solver"
# the lower bound's experiments as tests/test_lower_bound.py runs them
LOWER_BOUND = {"linear": (distinguishing_experiment_linear, 0, dict(eps=0.05)),
               "strongly_convex": (distinguishing_experiment_strongly_convex, 1,
                                   dict(eps_hat=0.05))}
LOWER_BOUND_T = (2, 1024)
LOWER_BOUND_TRIALS = 48
# the card's final gap against the CPU's: both sum in another order
GAP_RTOL, GAP_ATOL = 1e-3, 1e-7
# the runs whose step is timed alone, on the card and on the CPU, and their T
STEP_ALONE_RUNS = ("mean", "krum", "coordinate_median", "guard_backend=dense",
                   "guard_backend=fused", "guard_backend=dp_sketch", "logistic")
STEP_ALONE_T = 100   # cut from 200 for the MoE and Mamba phases (PERF.md §4)
# the fused guard's step over Table 1's 5 seeds on one run axis
CAMPAIGN_STEP = "campaign fused x5 seeds"
# the pool of the convex runs: the epoch solver in one process, the rest
# (the card runs, Table 1's, then the CPU references) in the others
POOL_PROCESSES = 7   # the card machine's 8 cores less this waiting process
POOL_WAIT_S = 900
# Table 1 (repro_torch.experiments.table1): the α = 0.25 section at the
# paper's T, one task a variant; the same section at TABLE1_CHECK_T on the
# card and on the CPU; the other sections cut to TABLE1_OTHER_T, in parts
TABLE1_CHECK_T = 500
TABLE1_OTHER_T = 500
TABLE1_MAIN = tuple(("alpha", {"alphas": (0.25,), "aggregators": (agg,)})
                    for agg in table1.ALPHA_AGGREGATORS)
TABLE1_OTHER = (("alpha0", {}), ("alpha", {"alphas": (0.125,)}),
                ("alpha", {"alphas": (0.375,)}), ("backend", {}),
                ("speedup", {"workers": (4, 8)}), ("speedup", {"workers": (16, 32)}))
# the kernels one step of a Table 1 variant launches (the guard's default
# backend is dense; its group of 5 seeds launches once a step)
TABLE1_STEP_KERNELS = {"mean": {}, "byzantine_sgd": {}, "krum": {"gram": 1},
                       "coordinate_median": {"coordinate_median": 1},
                       "trimmed_mean": {"trimmed_mean": 1}, "dense": {}, "fused": FUSED,
                       "dp_sketch": {"countsketch": 1, "filtered_mean": 1},
                       **{f"m{m}": {} for m in table1.WORKERS}}


@functools.lru_cache(maxsize=None)
def convex_problem(name: str, device: str):
    return CONVEX_PROBLEMS[name](device)


def convex_run(name: str, device: str, T: int | None = None) -> dict:
    """One run of CONVEX_RUNS on ``device`` from PRNGKey(0) (``T`` steps
    if given): host copies of its decisions, its final gap f(x̄) − f(x*)
    and its seconds."""
    problem_name, over, _ = CONVEX_RUNS[name]
    problem = convex_problem(problem_name, device)
    cfg = SolverConfig(**{**CONVEX_BASE, **over, **({"T": T} if T else {})})
    t0 = time.perf_counter()
    res = run_sgd(problem, cfg, prng.PRNGKey(0), device=device)
    gap = float(problem.f(res.x_avg) - problem.f(problem.x_star))
    seconds = time.perf_counter() - t0
    # numpy, so the result pickles across processes as plain bytes
    return {"n_alive": res.n_alive.cpu().numpy(), "final_alive": res.final_alive.cpu().numpy(),
            "byz_mask": res.byz_mask.cpu().numpy(),
            "ever_filtered_good": bool(res.ever_filtered_good),
            "gap": gap, "finite": bool(torch.isfinite(res.x_avg).all()
                                       and torch.isfinite(res.gaps).all()),
            "T": cfg.T, "D": problem.D, "V": problem.V, "seconds": seconds}


def lower_bound_run(kind: str, T: int, device: str) -> dict:
    fn, seed, kw = LOWER_BOUND[kind]
    t0 = time.perf_counter()
    res = fn(prng.PRNGKey(seed), m=16, T=T, n_trials=LOWER_BOUND_TRIALS, alpha=0.3,
             device=device, **kw)
    return {"success_rate": res.success_rate, "threshold_T": res.threshold_T,
            "seconds": time.perf_counter() - t0}


def _pool_init() -> None:
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False


def campaign_step_ms(device: str, T: int) -> float:
    """ms a step of a campaign group: the fused guard (quickstart's
    problem, sign_flip, α = 0.25) over Table 1's 5 seeds on one run axis."""
    grid = expand_grid([("sign_flip", scenario_static("sign_flip"))], [0.25], table1.SEEDS)
    cfg = SolverConfig(**{**CONVEX_BASE, "guard_backend": "fused", "T": T})
    res = run_campaign(convex_problem("quadratic", device), cfg, grid, ["byzantine_sgd"],
                       device=device)
    require(bool(torch.isfinite(res.stats["byzantine_sgd"].gap_avg).all()),
            f"campaign of 5 seeds on {device}: finite gaps")
    return 1e3 * res.wall_s / T


def step_alone_runs(device: str) -> dict:
    """STEP_ALONE_T steps of each of STEP_ALONE_RUNS on ``device``, one
    after another, then a campaign step of 5 seeds (CAMPAIGN_STEP):
    {name: ms a step}."""
    convex_run("mean", device, T=10)   # the first run's one-time costs
    out = {}
    for name in STEP_ALONE_RUNS:
        got = convex_run(name, device, T=STEP_ALONE_T)
        require(got["finite"], f"{name} alone on {device}: finite x_avg and gaps")
        out[name] = 1e3 * got["seconds"] / STEP_ALONE_T
    campaign_step_ms(device, 10)
    out[CAMPAIGN_STEP] = campaign_step_ms(device, STEP_ALONE_T)
    return out


def convex_step_alone(dev) -> dict:
    """The convex harness's step with nothing else on the card or the
    host: STEP_ALONE_RUNS in a fresh process on the card, then on the CPU
    (one thread, as the pool's CPU runs), while this process waits; then
    the same card runs in this process, which has run every phase above
    (torch.profiler's traces among them); then the lower bound's
    experiments on the card, whose results the pool's CPU runs check
    later.  Returns those results."""
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(1, initializer=_pool_init) as pool:
        fresh = pool.apply(step_alone_runs, ("cuda:0",))
        cpu = pool.apply(step_alone_runs, ("cpu",))
    here = step_alone_runs(str(dev))
    for name in STEP_ALONE_RUNS:
        emit("convex_step_alone", run=name, T=STEP_ALONE_T, ms_per_step=fresh[name],
             cpu_ms_per_step=cpu[name], main_process_ms_per_step=here[name])
    # one step of the group serves its 5 runs: against 5 steps alone
    alone = "guard_backend=fused"
    emit("convex_step_alone", run=CAMPAIGN_STEP, T=STEP_ALONE_T, runs=5,
         ms_per_batched_step=fresh[CAMPAIGN_STEP], five_steps_alone_ms=5 * fresh[alone],
         cpu_ms_per_batched_step=cpu[CAMPAIGN_STEP], cpu_five_steps_alone_ms=5 * cpu[alone],
         main_process_ms_per_batched_step=here[CAMPAIGN_STEP])
    lower = {(kind, T_lb): lower_bound_run(kind, T_lb, str(dev))
             for kind in LOWER_BOUND for T_lb in LOWER_BOUND_T}
    emit("convex_step_alone", seconds=time.perf_counter() - t0)
    return lower


def card_task(name: str, dev: str) -> dict:
    """One card run of the pool, the launch counts set to 0 just before
    it and read just after."""
    torch.cuda.synchronize()
    reset_counts()
    if name == EPOCH:
        t0 = time.perf_counter()
        res = solve_strongly_convex(convex_problem("quadratic_seed1", dev),
                                    EpochSolverConfig(**EPOCH_CFG), prng.PRNGKey(0), device=dev)
        torch.cuda.synchronize()
        out = {"per_epoch_T": res.per_epoch_T, "per_epoch_gap": res.per_epoch_gap,
               "epochs": res.epochs, "T": res.total_iters,
               "seconds": time.perf_counter() - t0}
    else:
        out = convex_run(name, dev)
        torch.cuda.synchronize()
    out["launches"] = read_counts()
    return out


def table1_task(section: str, kw: dict, T: int, device: str) -> dict:
    """One part of a Table 1 section on ``device``: its points, seconds and
    (on the card) the launch counts, set to 0 just before it and read just
    after."""
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    points = table1.section(section, T=T, device=device, **kw)
    if cuda:
        torch.cuda.synchronize()
    return {"points": points, "seconds": time.perf_counter() - t0,
            "launches": read_counts() if cuda else None}


def convex_pool() -> tuple[dict, dict]:
    """The convex runs at full length: the epoch solver and every run of
    CONVEX_RUNS on the card, then each run and the lower bound's
    experiments on the CPU, in POOL_PROCESSES processes that share the
    card and the host (no step is timed here: ``convex_step_alone``
    times it alone).  Returns ({name: card result}, {name: CPU result});
    the pool's processes are gone when it returns."""
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(POOL_PROCESSES, initializer=_pool_init) as pool:
        card = {name: pool.apply_async(card_task, (name, "cuda:0")) for name in (EPOCH,)}
        for i, (section, kw) in enumerate(TABLE1_MAIN):
            card[("table1", "main", i)] = pool.apply_async(
                table1_task, (section, kw, table1.T_PAPER, "cuda:0"))
        card.update({name: pool.apply_async(card_task, (name, "cuda:0"))
                     for name in CONVEX_RUNS})
        card[("table1", "check")] = pool.apply_async(
            table1_task, ("alpha", {"alphas": (0.25,)}, TABLE1_CHECK_T, "cuda:0"))
        for i, (section, kw) in enumerate(TABLE1_OTHER):
            card[("table1", "other", i)] = pool.apply_async(
                table1_task, (section, kw, TABLE1_OTHER_T, "cuda:0"))
        cpu = {("table1", "check"): pool.apply_async(
            table1_task, ("alpha", {"alphas": (0.25,)}, TABLE1_CHECK_T, "cpu"))}
        cpu.update({name: pool.apply_async(convex_run, (name, "cpu")) for name in CONVEX_RUNS})
        for kind in LOWER_BOUND:
            for T_lb in LOWER_BOUND_T:
                cpu[(kind, T_lb)] = pool.apply_async(lower_bound_run, (kind, T_lb, "cpu"))
        deadline = time.monotonic() + POOL_WAIT_S
        card, cpu = ({name: job.get(max(1.0, deadline - time.monotonic()))
                      for name, job in jobs.items()} for jobs in (card, cpu))
    emit("convex_pool", processes=POOL_PROCESSES, seconds=time.perf_counter() - t0,
         card_seconds={str(name): res["seconds"] for name, res in card.items()},
         cpu_seconds={str(name): res["seconds"] for name, res in cpu.items()})
    return card, cpu


def table1_launches_ok(task: dict, T: int) -> bool:
    """Each point's variant launched its kernels T times (once a step for
    its group of seeds), and no other kernel ran."""
    want = counts()
    for p in task["points"]:
        for k, v in TABLE1_STEP_KERNELS[p["point"].rsplit("/", 1)[1]].items():
            want[k] += v * T
    return task["launches"] == want


def table1_phase(card: dict, cpu: dict) -> None:
    """Table 1 on the card: the α = 0.25 section at the paper's T (every
    point finite, the guard reaching ε on every seed, no honest worker
    filtered); the same section at TABLE1_CHECK_T on the card and on the CPU
    (iterations-to-ε and decisions equal, gaps within GAP_RTOL); the other
    sections at TABLE1_OTHER_T (printed with ``T_reduced_from``).  Every
    card part launches exactly its variants' kernels."""
    main = [card[("table1", "main", i)] for i in range(len(TABLE1_MAIN))]
    for task in main:
        require(table1_launches_ok(task, table1.T_PAPER),
                f"table1 {task['points'][0]['point']}: launches {task['launches']}")
        for p in task["points"]:
            emit("table1", section="alpha", point=p["point"], T=p["T"],
                 iters_to_eps_med=p["iters_to_eps_med"], iqr=p["iqr"], reached=p["reached"],
                 n_seeds=p["n_seeds"], iters_to_eps=p["iters_to_eps"],
                 n_alive_final=p["n_alive_final"], gap_final=p["gap_final"],
                 ever_filtered_good=p["ever_filtered_good"], seconds=task["seconds"],
                 launches=task["launches"])
            require(all(np.isfinite(p["gap_final"])), f"{p['point']}: finite gaps")
            if p["point"].endswith("/byzantine_sgd"):
                require(p["reached"] == p["n_seeds"] and not any(p["ever_filtered_good"]),
                        f"{p['point']}: every seed reaches ε, no honest worker filtered")
    got, want = card[("table1", "check")], cpu[("table1", "check")]
    require(table1_launches_ok(got, TABLE1_CHECK_T), f"table1 check: {got['launches']}")
    for a, b in zip(got["points"], want["points"]):
        ints = all(a[f] == b[f] for f in ("iters_to_eps", "n_alive_final", "detect_latency",
                                          "ever_filtered_good"))
        rel = [abs(x - y) / (abs(y) + GAP_ATOL / GAP_RTOL)
               for f in ("gap_final", "gap_avg") for x, y in zip(a[f], b[f])]
        gap = float("nan") if any(np.isnan(rel)) else max(rel)
        emit("table1", check="card_equals_cpu", point=a["point"], T=TABLE1_CHECK_T,
             integers_equal=ints, gap_rel_err_max=gap, iters_to_eps=a["iters_to_eps"],
             cpu_iters_to_eps=b["iters_to_eps"], card_seconds=got["seconds"],
             cpu_seconds=want["seconds"])
        require(ints and gap <= GAP_RTOL, f"table1 {a['point']} at T={TABLE1_CHECK_T}: "
                                          f"card as the CPU (ints {ints}, gaps {gap})")
    for i in range(len(TABLE1_OTHER)):
        task = card[("table1", "other", i)]
        require(table1_launches_ok(task, TABLE1_OTHER_T),
                f"table1 {task['points'][0]['point']}: launches {task['launches']}")
        for p in task["points"]:
            require(all(np.isfinite(p["gap_final"])), f"{p['point']}: finite gaps")
            emit("table1", section=TABLE1_OTHER[i][0], point=p["point"], T=p["T"],
                 T_reduced_from=table1.T_PAPER, iters_to_eps_med=p["iters_to_eps_med"],
                 iqr=p["iqr"], reached=p["reached"], n_seeds=p["n_seeds"],
                 iters_to_eps=p["iters_to_eps"], n_alive_final=p["n_alive_final"],
                 seconds=task["seconds"], launches=task["launches"])
    emit("table1", seconds_in_pool=sum(card[k]["seconds"] for k in card
                                       if isinstance(k, tuple) and k[0] == "table1"))


def check_card_run(name: str, got: dict) -> None:
    per_step = CONVEX_RUNS[name][2]
    want = counts(**{k: got["T"] * v for k, v in per_step.items()})
    require(got["launches"] == want, f"{name}: launches {got['launches']}, expected {want}")
    require(got["finite"], f"{name}: finite x_avg and gaps")


def same_as_cpu(name: str, got: dict, cpu: dict) -> dict:
    """Decisions equal to the CPU run's at every step and the final gap
    within GAP_RTOL; returns what the phase line prints."""
    decisions = all(np.array_equal(got[f], cpu[f]) for f in ("n_alive", "final_alive", "byz_mask"))
    decisions = decisions and got["ever_filtered_good"] == cpu["ever_filtered_good"]
    gap_ok = abs(got["gap"] - cpu["gap"]) <= GAP_RTOL * abs(cpu["gap"]) + GAP_ATOL
    require(decisions, f"{name}: decisions equal to the CPU run's at every step")
    require(gap_ok, f"{name}: final gap {got['gap']} within {GAP_RTOL} of the CPU's {cpu['gap']}")
    return {"decisions_equal_to_cpu": decisions, "cpu_gap": cpu["gap"]}


def run_line(got: dict) -> dict:
    return {"T": got["T"], "gap": got["gap"], "n_alive_last": int(got["n_alive"][-1]),
            "byzantine_alive": int((got["final_alive"] & got["byz_mask"]).sum()),
            "good_filtered": got["ever_filtered_good"], "launches": got["launches"]}


def quickstart(card: dict, cpu: dict) -> None:
    """examples/quickstart.py on the card: the four aggregators under
    sign_flip (T = 2000; the guard fused), the three guard backends (T =
    500) and hidden_shift; each against its CPU run."""
    for name in QUICKSTART_RUNS:
        got = card[name]
        check_card_run(name, got)
        emit("quickstart", run=name, **run_line(got), **same_as_cpu(name, got, cpu[name]))
    n_byz = 4
    require(card["mean"]["gap"] > 0.1, "quickstart: the mean's gap above 0.1 under sign_flip")
    for name in ("byzantine_sgd", "hidden_shift"):
        got = card[name]
        require(int(got["n_alive"][-1]) == 16 - n_byz and not got["ever_filtered_good"]
                and not bool((got["final_alive"] & got["byz_mask"]).any()),
                f"quickstart {name}: 12/16 alive, every attacker filtered, no honest worker")
    backends = [card[f"guard_backend={b}"] for b in ("dense", "fused", "dp_sketch")]
    alike = all(np.array_equal(b["n_alive"], backends[0]["n_alive"])
                and np.array_equal(b["final_alive"], backends[0]["final_alive"])
                for b in backends)
    emit("quickstart", check="backends_decide_alike_at_every_step", equal=alike,
         seconds_in_pool=sum(card[name]["seconds"] for name in QUICKSTART_RUNS))
    require(alike, "quickstart: dense, fused and dp_sketch decide alike at every step")


def detection_latency(card: dict, cpu: dict) -> None:
    """bench_filtering.bench_detection_latency's loop on the card: per
    attack the first step at which the alive count reaches m − n_byz, the
    final alive count, whether an honest worker was filtered and the gap;
    each guarded run below 2e-2 with no honest worker filtered and deciding
    as its CPU run."""
    for attack in DETECTION_ATTACKS:
        name = DETECTION_SAME_AS.get(attack, f"detection {attack}")
        got = card[name]
        check_card_run(name, got)
        cmp = same_as_cpu(name, got, cpu[name])
        n_alive = got["n_alive"]
        detected = np.flatnonzero(n_alive <= 16 - int(got["byz_mask"].sum()))
        latency = int(detected[0]) + 1 if detected.size else -1
        emit("detection_latency", attack=attack, detect_iter=latency,
             final_alive=int(n_alive[-1]), good_filtered=got["ever_filtered_good"],
             gap=got["gap"], launches=got["launches"], **cmp,
             **({"same_run_as": f"quickstart {name}"} if name in QUICKSTART_RUNS else {}))
        require(got["gap"] < 2e-2 and not got["ever_filtered_good"],
                f"detection {attack}: gap {got['gap']} < 2e-2, no honest worker filtered")
    emit("detection_latency", seconds_in_pool=sum(card[name]["seconds"]
                                                  for name in DETECTION_RUNS))


# cut from T = 128 to keep the script inside its time with Table 1's runs,
# and from 64 for the MoE and Mamba phases (PERF.md §4)
RG_T = 32
RG_RUNS = (("fused@f32", dict(guard_backend="fused", stats_dtype="f32")),
           ("fused@bf16", dict(guard_backend="fused", stats_dtype="bf16")),
           ("dense@f32", dict(guard_backend="dense", stats_dtype="f32")))


def random_gaussian_main_path(dev) -> None:
    """``run_sgd`` at the main path's shape under
    ``scenario_static("random_gaussian")``: fused@f32 and fused@bf16
    deciding as dense@f32 at every step, every attacker filtered and no
    honest worker; the generating path refuses id 2 with the reference's
    ValueError."""
    t0 = time.perf_counter()
    problem = make_generated_problem(d=D, seed=0, device=dev)
    adv = ScenarioAdversary(scenario_static("random_gaussian"), BASE["alpha"])
    n_byz = int(BASE["alpha"] * M)
    runs = {}
    for name, over in RG_RUNS:
        cfg = SolverConfig(**{**BASE, **over, "T": RG_T})
        res, ms, got, mem = profiled_run(problem, cfg, adv, dev)
        runs[name] = res
        finite = bool(torch.isfinite(res.x_avg).all() and torch.isfinite(res.gaps).all())
        emit("random_gaussian_main_path", run=name, ms_per_step=ms,
             max_memory_allocated_bytes=mem, final_gap=float(res.gaps[-1]),
             n_alive_first_last=[int(res.n_alive[0]), int(res.n_alive[-1])],
             launches=got, finite=finite)
        require(finite, f"random_gaussian {name}: finite x_avg and gaps")
        want = (counts(fused_guard=RG_T, filtered_mean=RG_T) if name.startswith("fused")
                else counts())
        require(got == want, f"random_gaussian {name}: launches {got}, expected {want}")
        require_clean_filter(f"random_gaussian {name}", res, n_byz)
    dense = runs["dense@f32"]
    for name in ("fused@f32", "fused@bf16"):
        same = {f: torch.equal(getattr(runs[name], f), getattr(dense, f))
                for f in ("n_alive", "final_alive", "byz_mask")}
        emit("random_gaussian_main_path", check="decisions_equal_to_dense", run=name,
             equal=same)
        require(all(same.values()), f"random_gaussian {name}: decides as dense@f32: {same}")
    del runs, dense
    try:
        run_sgd(problem, SolverConfig(**{**BASE, "guard_backend": "fused", "T": 1,
                                         "generate": "kernel"}),
                prng.PRNGKey(0), adversary=adv, device=dev)
        refused = ""
    except ValueError as e:
        refused = str(e)
    emit("random_gaussian_main_path", check="generate_kernel_refused", message=refused,
         seconds=time.perf_counter() - t0)
    require("not in-kernel generatable" in refused,
            "generate='kernel' refuses random_gaussian with the reference's ValueError")


def convex_harness(card: dict, cpu: dict, lower: dict) -> None:
    """Least squares and logistic regression under sign_flip through the
    fused guard (each within 3·αDV/√T, Theorem 3.9's term as the reference
    test reads it, and no honest worker filtered), the Section-4 epoch
    solver (last gap below 5e-3) and both Section-5 distinguishing
    experiments (``lower``, run alone on the card: success as the CPU's,
    below 0.75 at T = 2 and above 0.9 at T = 1024)."""
    for name in HARNESS_RUNS:
        got = card[name]
        check_card_run(name, got)
        bound = 3.0 * CONVEX_BASE["alpha"] * got["D"] * got["V"] / got["T"] ** 0.5
        emit("convex_harness", run=name, **run_line(got), bound=bound,
             **same_as_cpu(name, got, cpu[name]))
        require(got["gap"] < bound and not got["ever_filtered_good"],
                f"{name}: gap {got['gap']} below {bound}, no honest worker filtered")

    ep = card[EPOCH]
    emit("convex_harness", run=EPOCH, per_epoch_T=ep["per_epoch_T"],
         per_epoch_gap=ep["per_epoch_gap"], epochs=ep["epochs"], total_iters=ep["T"],
         seconds_in_pool=ep["seconds"], launches=ep["launches"])
    require(ep["launches"] == counts(), "epoch solver (dense guard): no kernel launched")
    require(ep["per_epoch_gap"][-1] < 5e-3, f"epoch solver: last gap {ep['per_epoch_gap'][-1]}")

    for kind in LOWER_BOUND:
        rates = {}
        for T_lb in LOWER_BOUND_T:
            got, want = lower[(kind, T_lb)], cpu[(kind, T_lb)]
            rates[T_lb] = got["success_rate"]
            emit("convex_harness", run=f"lower_bound {kind}", T=T_lb, m=16, alpha=0.3,
                 n_trials=LOWER_BOUND_TRIALS, success_rate=got["success_rate"],
                 cpu_success_rate=want["success_rate"], threshold_T=got["threshold_T"],
                 seconds=got["seconds"])
            require(got["success_rate"] == want["success_rate"],
                    f"lower bound {kind} T={T_lb}: success as the CPU's")
        lo, hi = rates[LOWER_BOUND_T[0]], rates[LOWER_BOUND_T[-1]]
        require(lo < 0.75 and hi > 0.9,
                f"lower bound {kind}: success {rates} (< 0.75 at T=2, > 0.9 at T=1024)")
    emit("convex_harness", seconds_in_pool=sum(card[name]["seconds"]
                                               for name in (*HARNESS_RUNS, EPOCH)),
         lower_bound_seconds=sum(res["seconds"] for res in lower.values()))


# ---------------------------------------------------------------- phase 18: the LM path

LM_ARCH = "internlm2-1.8b"
LM_LAYERS = 2            # the depth cut from 24; every width as published
LM_D = 504_899_584       # its parameter count, already a multiple of 128
LM_W, LM_ALPHA, LM_BATCH, LM_SEQ, LM_LR = 8, 0.25, 2, 128, 3e-3
# steps a run: 20, and 40 for the sketch guard, whose V carries a 1.5 slack
LM_T = {"dp_exact": 20, "fused": 20, "dp_sketch": 40}
LM_SKETCH_K = 4096
LM_PEAK_LIMIT_GB = 72.0  # dp_exact@f32 runs at full width only below this reckoning
LM_STEP_PHASES = ("forward_backward", "ravel", "attack", "guard", "optimizer")
# the kernels each full-width run launches, T times each, and no other
LM_RUN_KERNELS = {"dp_exact": ("filtered_mean",), "dp_sketch": ("countsketch", "filtered_mean"),
                  "fused": ("fused_guard", "filtered_mean")}
# the launcher phase (repro_torch.launch.train at its reduced width)
LM_LAUNCH = dict(reduced=True, d_model=128, workers=8, seq_len=64, steps=40,
                 guard_backend="dp_exact", log_every=10)
# its losses against the CPU's: 1e-4 relative over the first LM_LOSS_FIRST
# steps, 1e-3 over all 40.  AdamW amplifies f32 rounding from step to
# step: the JAX package and the port, both on one CPU, drift apart by up
# to 3.3e-4 at step 36 of this run (their decisions equal throughout)
LM_LOSS_FIRST, LM_LOSS_TOL = 10, (1e-4, 1e-3)


class PhaseTimer:
    """CUDA events at the trainer's phase marks: ms a phase, summed over the
    steps between :meth:`start` and :meth:`stop`, and ms a step; and each
    phase's peak memory (the allocator's peak since the previous mark, a
    host-side count that waits for nothing)."""

    def __init__(self):
        self.events: list = []
        self.peaks: dict = {}
        self.on = False

    def _record(self, name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))
        if name != "start":
            self.peaks[name] = max(self.peaks.get(name, 0), torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    def start(self) -> None:
        self.on = True
        self._record("start")

    def stop(self) -> None:
        self._record("stop")
        self.on = False

    def __call__(self, name: str) -> None:
        if self.on:
            self._record(name)

    def totals(self) -> tuple[dict, list]:
        torch.cuda.synchronize()
        split, steps, t0, prev = dict.fromkeys(LM_STEP_PHASES, 0.0), [], None, None
        for name, ev in self.events:
            if name == "start":
                t0 = ev
            elif name == "stop":
                steps.append(t0.elapsed_time(ev))
            else:
                split[name] += prev.elapsed_time(ev)
            prev = ev
        return split, steps


@contextlib.contextmanager
def first_call_operands(names):
    """Route ``ops.<name>`` through a recorder that keeps the first call's
    arguments (references: the step drops, the check holds them) and
    calls through; the launch counts are the run's own."""
    saved = {n: getattr(ops, n) for n in names}
    calls: dict = {}

    def recorder(name):
        def call(*args, **kwargs):
            calls.setdefault(name, args)
            return saved[name](*args, **kwargs)
        return call

    for n in names:
        setattr(ops, n, recorder(n))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


@contextlib.contextmanager
def finite_rows(on: bool):
    """With ``on``, route ``ops.filtered_mean`` through a recorder that
    appends, a call, whether its rows are all finite and calls through.
    The test is one f32 sum of the rows (a NaN or an infinity anywhere
    makes it non-finite; one pass and no temporary the rows' size) kept as
    a device bool, so no step waits for it."""
    saved = ops.filtered_mean
    flags: list = []

    def call(x, *args, **kwargs):
        flags.append(torch.isfinite(torch.sum(x, dtype=torch.float32)))
        return saved(x, *args, **kwargs)

    if on:
        ops.filtered_mean = call
    try:
        yield flags
    finally:
        ops.filtered_mean = saved


def lm_kernel_checks(calls: dict, dt: str) -> dict:
    """Each kernel the run launched against its plain version (by column
    blocks: the rows have no room for f32 copies) on step 0's operands,
    with the kernel's and the plain version's ms beside its bound; the
    launches made here are put back out of the run's counts."""
    saved = read_counts()
    out = {}
    elt = DTYPES[dt].itemsize
    for name, args in calls.items():
        if name == "fused_guard":
            g, B, dlt = args[:3]
            m, d = g.shape
            got = fused_guard_cuda(g, B, dlt)
            want = ref.fused_guard_ref_blocked(g, B, dlt)
            fields = {"B_new_bit_equal": torch.equal(got[3], want[3]),
                      "rel_abs": {k: rel_err(a, b) for k, a, b in
                                  zip(("gram_g", "cross", "a_inc"), got[:3], want[:3])}}
            ok = fields["B_new_bit_equal"] and all(
                within(a, b, TOL[dt]) for a, b in zip(got[:3], want[:3]))
            del got, want
            ms = median_ms(lambda: fused_guard_cuda(g, B, dlt), batches=3, per_batch=5)
            plain = median_ms(lambda: ref.fused_guard_ref_blocked(g, B, dlt), batches=3,
                              per_batch=1)
            nbytes, nops = (3 * m * d + d) * elt, 2.0 * (2 * m * m + m) * d + m * d
        elif name == "filtered_mean":
            x, w, denom = args[:3]
            m, d = x.shape
            got = filtered_mean_cuda(x, w, denom)
            want = ref.filtered_mean_ref_blocked(x, w, denom)
            fields = {"rel_abs": rel_err(got, want)}
            ok = within(got, want, TOL[dt])
            del got, want
            ms = median_ms(lambda: filtered_mean_cuda(x, w, denom), batches=3, per_batch=5)
            plain = median_ms(lambda: ref.filtered_mean_ref_blocked(x, w, denom), batches=3,
                              per_batch=1)
            nbytes, nops = m * d * elt + 4 * d, 2.0 * m * d
        else:
            x, k, salt = args[:3]
            m, d = x.shape
            got = countsketch_cuda(x, k, salt)
            want = ref.countsketch_ref_blocked(x, k, salt)
            fields = {"rel_abs": rel_err(got, want), "plan": launch_plan(
                m, d, k, x.dtype, x.data_ptr() % 16 == 0)._asdict()}
            ok = within(got, want, TOL[dt])
            del got, want
            ms = median_ms(lambda: countsketch_cuda(x, k, salt), batches=3, per_batch=5)
            plain = median_ms(lambda: ref.countsketch_ref_blocked(x, k, salt), batches=3,
                              per_batch=1)
            nbytes, nops = m * d * elt + 4 * m * k, 2.0 * m * d + 9.0 * d
        b_ms, b_by = bound(nbytes, nops, PEAK_FLOPS[dt])
        out[name] = {"m": m, "d": d, "dtype": dt, "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by, "tol": TOL[dt], **fields}
        require(ok, f"lm_train_full_width: {name} {dt} against its plain version at d={d}")
        torch.cuda.empty_cache()
    for name, (fn, attr) in COUNTERS.items():
        setattr(fn, attr, saved[name])
    return out


def lm_reckon_gb(backend: str, stats: str, n_params: int, d: int, W: int) -> dict:
    """The run's peak memory reckoned from the code's allocations, in GB:
    what lives across steps, then the largest of the gradients' moment
    (the worker-stacked tree and the rows), the attack's (the pre-attack
    rows, the attack's −scale·g and its output), the guard's (the attacked
    rows, B and B_new, the f32 ξ) and the optimizer's."""
    p = 2.0 * n_params                                  # bf16 parameters
    rows = W * d * 2.0                                  # bf16 rows at either stats dtype
    b = 0.0 if backend == "dp_sketch" else W * d * (4.0 if stats == "f32" else 2.0)
    cent = rows if backend == "dp_sketch" else 0.0      # the centred rows
    static = p + 8.0 * n_params + 2.0 * d + 2.0 * d + b  # params, moments, anchor, prev ξ, B
    # the worker-stacked gradient tree beside the matrix it is ravelled into
    gradients = 2.0 * d + 2 * rows
    attack = 2.0 * d + 3 * rows
    guard = 2.0 * d + rows + b + cent + 4.0 * d
    # B_new beside the old B, ξ in f32 and unravelled, AdamW's new m, v
    # and their bias-corrected copies
    optimizer = 2.0 * d + b + 6.0 * d + 16.0 * n_params
    stages = {"gradients": gradients, "attack": attack, "guard": guard,
              "optimizer": optimizer}
    out = {f"{k}_gb": (static + v) / 1e9 for k, v in stages.items()}
    return {"static_gb": static / 1e9, **out,
            "peak_gb": (static + max(stages.values())) / 1e9}


def lm_run(model, backend: str, stats: str, V: float, T: int, dev, seq: int = LM_SEQ,
           attack_kwargs: tuple = (), check_finite: bool = False) -> dict:
    """T steps of the trainer at full width over sequences of ``seq``
    tokens (sign_flip with ``attack_kwargs``), built as ``run_training``
    builds them; step 0's kernel operands are held against the plain
    versions, and with ``check_finite`` every step's rows into
    ``filtered_mean`` (every worker's gradient, attacked or not, in each
    backend) are checked finite; returns the run's summary."""
    cfg = model.cfg
    stream = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=seq, seed=0)
    opt = adamw(linear_warmup_cosine(LM_LR, warmup=max(T // 20, 1), total_steps=T),
                grad_clip=1.0)
    scfg = SolverConfig(m=LM_W, T=T, eta=LM_LR, alpha=LM_ALPHA, attack="sign_flip",
                        attack_kwargs=attack_kwargs,
                        mean_over_alive=True, guard_backend=backend, stats_dtype=stats,
                        guard_opts=(("sketch_dim", LM_SKETCH_K),) if backend == "dp_sketch"
                        else ())
    timer = PhaseTimer()
    step = build_train_step(model, opt, scfg, V=V, timer=timer)
    init_key, mask_key, _, loop_key = prng.split(prng.PRNGKey(0, device=dev), 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, opt, scfg, init_key, V=V)
    rank = byz_rank(mask_key, LM_W)
    torch.cuda.synchronize()
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    metrics, checks = [], {}
    with finite_rows(check_finite) as rows_finite:
        for i in range(T):
            batch = make_worker_batch(stream, LM_W, LM_BATCH, i, device=dev)
            if i == 0:
                with first_call_operands(LM_RUN_KERNELS[backend]) as calls:
                    state, m = step(state, batch, rank, prng.fold_in(loop_key, i))
                torch.cuda.synchronize()
                checks = lm_kernel_checks(calls, "bf16")
                del calls
                # the peak is the steps' (the checks hold step 0's operands)
                check_peak_gb = torch.cuda.max_memory_allocated() / 1e9
                torch.cuda.reset_peak_memory_stats()
            else:
                timer.start()
                state, m = step(state, batch, rank, prng.fold_in(loop_key, i))
                timer.stop()
            metrics.append(m)
    torch.cuda.synchronize()
    launches = read_counts()
    split, steps = timer.totals()
    phase_peak_gb = {k: timer.peaks[k] / 1e9 for k in LM_STEP_PHASES}
    peak_gb = max(phase_peak_gb.values())
    hist = fetch_metrics(metrics)
    del state, step, metrics
    # the trainer's state sits in reference cycles (closures and frames of
    # the step): without a collection the next run can start beside it
    free_card()
    loss = [float(h["loss_good_workers"]) for h in hist]
    out = {"backend": f"{backend}@{stats}", "ms_per_step": statistics.mean(steps),
           "split_ms_per_step": {k: v / len(steps) for k, v in split.items()},
           "peak_gb": peak_gb, "peak_gb_by_phase": phase_peak_gb, "init_peak_gb": init_peak_gb,
           "step0_check_peak_gb": check_peak_gb,
           "launches": launches,
           "n_alive": [int(h["n_alive"]) for h in hist],
           "byz_alive": [int(h["byz_alive"]) for h in hist],
           "good_filtered": [int(h["good_filtered"]) for h in hist],
           "loss_good_workers": loss, "v_est_step0": float(hist[0]["v_est"]),
           "rows_finite_every_step": (bool(torch.stack(rows_finite).all()) and
                                      len(rows_finite) == T) if check_finite else None,
           "kernels": checks}
    return out


def lm_checks(out: dict, backend: str, T: int, n_byz: int) -> None:
    """The full-width run's requirements (emitted first, so a failed one
    leaves its numbers)."""
    stats = out["backend"]
    launches, loss = out["launches"], out["loss_good_workers"]
    want = counts(**{k: T for k in LM_RUN_KERNELS[backend]})
    require(launches == want, f"lm {stats}: launches {launches} != {want}")
    require(all(g == 0 for g in out["good_filtered"]), f"lm {stats}: an honest worker was "
            "filtered")
    require(out["byz_alive"][-1] == 0, f"lm {stats}: a Byzantine worker survived")
    require(out["n_alive"][-1] == LM_W - n_byz, f"lm {stats}: n_alive at the end")
    require(all(math.isfinite(v) for v in loss), f"lm {stats}: finite losses")
    require(out["rows_finite_every_step"] is not False,
            f"lm {stats}: every worker's gradient finite")
    require(statistics.mean(loss[-3:]) < statistics.mean(loss[:3]), f"lm {stats}: the loss falls")


def lm_train_full_width(dev) -> dict:
    """internlm2-1.8b at its published widths, 2 layers (d = 504,899,584),
    W = 8, α = 0.25, sign_flip, per-worker batch 2, seq 128, T = LM_T[backend]:
    dp_exact@bf16, dp_sketch@bf16, fused@bf16 (its V the step-0 v_est
    dp_exact@bf16 printed) and, where its reckoned peak is at most
    LM_PEAK_LIMIT_GB, dp_exact@f32.  Returns the launches of the kernels
    by (name, dtype)."""
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    model = build_model(cfg, device=dev)
    harness = params_harness(model)
    require(model.n_params == LM_D and harness.d == LM_D,
            f"internlm2-1.8b at 2 layers has d = {model.n_params} (pad {harness.d})")
    launches: dict = {}
    plan = [("dp_exact", "bf16"), ("dp_sketch", "bf16"), ("fused", "bf16"), ("dp_exact", "f32")]
    v_fused, failures = None, []
    for backend, stats in plan:
        reckon = lm_reckon_gb(backend, stats, model.n_params, harness.d, LM_W)
        if reckon["peak_gb"] > LM_PEAK_LIMIT_GB:
            emit("lm_train_full_width", backend=f"{backend}@{stats}", skipped=True,
                 reckoned=reckon, limit_gb=LM_PEAK_LIMIT_GB)
            continue
        V = v_fused if backend == "fused" else 0.0
        t0 = time.perf_counter()
        T = LM_T[backend]
        res = lm_run(model, backend, stats, V, T, dev)
        if (backend, stats) == ("dp_exact", "bf16"):
            v_fused = res["v_est_step0"]
        emit("lm_train_full_width", arch=LM_ARCH, n_layers=LM_LAYERS, d=harness.d, W=LM_W,
             alpha=LM_ALPHA, attack="sign_flip", T=T, batch=LM_BATCH, seq_len=LM_SEQ,
             V=V, reckoned=reckon, seconds=time.perf_counter() - t0, card=card_line(), **res)
        try:
            lm_checks(res, backend, T, int(LM_ALPHA * LM_W))
        except RuntimeError as err:   # every configuration runs; all failures reported
            failures.append(str(err))
        for name, n in res["launches"].items():
            if n:
                launches[(name, "bf16")] = launches.get((name, "bf16"), 0) + n
    require(not failures, "; ".join(failures))
    return launches


def lm_train_launcher(dev) -> dict:
    """``run_training`` of the launcher at its reduced width on the card and
    on the CPU: decisions equal at every step, losses within LM_LOSS_TOL,
    n_alive 6 at the end (the JAX package's own system test expects it).
    Returns the card run's launches by (name, dtype)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    _, card = run_training(LM_ARCH, device=dev, verbose=False, **LM_LAUNCH)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = read_counts()
    t0 = time.perf_counter()
    _, cpu = run_training(LM_ARCH, device="cpu", verbose=False, **LM_LAUNCH)
    cpu_s = time.perf_counter() - t0
    keys = ("n_alive", "byz_alive", "good_filtered", "n_byz")
    decisions_equal = all(a[k] == b[k] for a, b in zip(card, cpu) for k in keys)
    rel = [abs(a["loss_good_workers"] - b["loss_good_workers"]) / abs(b["loss_good_workers"])
           for a, b in zip(card, cpu)]
    loss_rel, loss_rel_first = max(rel), max(rel[:LM_LOSS_FIRST])
    steps = LM_LAUNCH["steps"]
    emit("lm_train_launcher", **{k: v for k, v in LM_LAUNCH.items()}, card_seconds=card_s,
         cpu_seconds=cpu_s, launches=launches, decisions_equal=decisions_equal,
         loss_rel_max=loss_rel, loss_rel_max_first_steps=loss_rel_first,
         n_alive=[int(r["n_alive"]) for r in card],
         loss_first_last=[card[0]["loss_good_workers"], card[-1]["loss_good_workers"]])
    require(launches == counts(filtered_mean=steps), f"lm launcher launches {launches}")
    require(decisions_equal, "lm launcher: decisions equal to the CPU's at every step")
    require(loss_rel_first <= LM_LOSS_TOL[0] and loss_rel <= LM_LOSS_TOL[1],
            f"lm launcher: losses within {LM_LOSS_TOL} of the CPU's ({loss_rel_first}, "
            f"{loss_rel})")
    require(int(card[-1]["n_alive"]) == 6, "lm launcher: n_alive 6 at the end")
    return {("filtered_mean", "f32"): steps}


# ---------------------------------------------------------------- phases 19-21: checkpoints,
# train campaigns, serving

CKPT_STOP = 20            # lm_checkpoint stops after 20 of LM_LAUNCH's 40 steps
CKPT_DIR = Path(__file__).resolve().parent / "build" / "lm_checkpoint"
# (name, run_training overrides); fused@bf16's V is the step-0 v_est of the
# dp_exact run, and its guard state carries a bf16 B leaf
CKPT_RUNS = (("dp_exact@f32", dict(guard_backend="dp_exact", stats_dtype="f32")),
             ("fused@bf16", dict(guard_backend="fused", stats_dtype="bf16")))
CKPT_KERNELS = {"dp_exact": ("filtered_mean",), "fused": ("fused_guard", "filtered_mean")}


def leaves_differ(a, b) -> list:
    """The checkpoint keys at which two trees of one structure differ in
    bits (a tensor's device aside), or in a host number."""
    out = []
    for (k, x), (_, y) in zip(tree_flatten_with_path(a), tree_flatten_with_path(b)):
        if isinstance(x, torch.Tensor):
            same = x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
        else:
            same = x == y
        if not same:
            out.append(k)
    return out


def histories_equal(a: list, b: list) -> bool:
    """Two run histories equal record by record (NaN equal to NaN)."""
    try:
        np.testing.assert_equal(a, b)
    except AssertionError:
        return False
    return True


def lm_checkpoint(dev) -> dict:
    """``run_training`` at LM_LAUNCH's reduced width, uninterrupted and then
    stopped after CKPT_STOP steps with a checkpoint and resumed, on
    dp_exact@f32 and fused@bf16 (its guard's B a bf16 leaf): the final
    state bit-equal to the uninterrupted one leaf by leaf and the history
    equal; a card-written checkpoint restored on the CPU and a CPU-written
    one on the card, bit for bit; a truncated newest checkpoint skipped and
    a silently corrupted one quarantined, restore falling back to the one
    before.  The stopped and resumed runs count their launches.  Returns
    them by (name, dtype)."""
    t_phase = time.perf_counter()
    steps = LM_LAUNCH["steps"]
    launches: dict = {}
    v_given = None
    for name, over in CKPT_RUNS:
        backend, stats = name.split("@")
        kw = {**LM_LAUNCH, **over}
        if backend == "fused":
            kw["guard_v"] = v_given
        d = CKPT_DIR / name
        shutil.rmtree(d, ignore_errors=True)
        t0 = time.perf_counter()
        full, full_hist = run_training(LM_ARCH, device=dev, verbose=False, **kw)
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        if backend == "dp_exact":
            v_given = full_hist[0]["v_est"]
        reset_counts()
        t0 = time.perf_counter()
        run_training(LM_ARCH, device=dev, verbose=False, ckpt_dir=str(d), stop_after=CKPT_STOP,
                     **kw)
        stopped_at = latest_step(str(d))
        resumed, hist = run_training(LM_ARCH, device=dev, verbose=False, ckpt_dir=str(d),
                                     resume=True, **kw)
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        got = read_counts()
        want = counts(**{k: steps for k in CKPT_KERNELS[backend]})
        for k, n in got.items():
            if n:
                launches[(k, stats)] = launches.get((k, stats), 0) + n
        differ = leaves_differ(full, resumed)
        b_dtype = str(full.guard.B.dtype)

        # save and restore alone, timed; the file's size
        sd = d / "timed"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(str(sd), resumed.step, resumed)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, _ = restore_checkpoint(str(sd), resumed)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        mb = os.path.getsize(path) / 1e6
        # across devices: the card's checkpoint restored on the CPU, and a
        # CPU-written one restored on the card
        cpu_tmpl = to_cpu(resumed)
        on_cpu, _ = restore_checkpoint(str(sd), cpu_tmpl)
        cd = d / "from_cpu"
        save_checkpoint(str(cd), on_cpu.step, on_cpu)
        on_card, _ = restore_checkpoint(str(cd), resumed)
        cross = {"restore_on_card_differs": leaves_differ(back, resumed),
                 "card_to_cpu_differs": leaves_differ(on_cpu, resumed),
                 "cpu_to_card_differs": leaves_differ(on_card, resumed),
                 "cpu_restore_device": str(first_tensor(on_cpu).device),
                 "card_restore_device": str(first_tensor(on_card).device)}
        # damage: the newest truncated (not a complete unit: skipped), then
        # rewritten with a leaf changed under its old checksum (quarantined)
        newest = d / f"ckpt_{steps:08d}.npz"
        with open(newest, "r+b") as f:
            f.truncate(os.path.getsize(newest) // 2)
        truncated_latest = latest_step(str(d))
        fell_back, at = restore_checkpoint(str(d), resumed)
        damage = {"truncated_latest_step": truncated_latest, "truncated_restored_step": at}
        os.remove(newest)
        save_checkpoint(str(d), steps, resumed)
        with np.load(newest) as data:
            arrays = {k: data[k] for k in data.files}
        arrays["leaf_0"] = arrays["leaf_0"] + np.float32(1.0)
        np.savez(newest, **arrays)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, q_at = restore_checkpoint(str(d), resumed)
        damage.update(corrupt_restored_step=q_at,
                      quarantined=os.path.exists(str(newest) + ".corrupt"),
                      warned=any("quarantined" in str(w.message) for w in caught))
        emit("lm_checkpoint", run=name, arch=LM_ARCH, d_model=LM_LAUNCH["d_model"],
             W=LM_LAUNCH["workers"], steps=steps, stop_after=CKPT_STOP, stopped_at=stopped_at,
             guard_v=kw.get("guard_v", 0.0), guard_B_dtype=b_dtype, launches=got,
             resume_differs=differ, history_equal=histories_equal(hist, full_hist),
             n_alive_last=int(hist[-1]["n_alive"]), uninterrupted_s=full_s,
             stopped_and_resumed_s=resumed_s, save_s=save_s, restore_s=restore_s,
             checkpoint_mb=mb, cross_device=cross, damage=damage, card=card_line())
        require(got == want, f"lm_checkpoint {name}: launches {got} != {want}")
        require(stopped_at == CKPT_STOP, f"lm_checkpoint {name}: stopped at {stopped_at}")
        require(not differ, f"lm_checkpoint {name}: resumed state differs at {differ}")
        require(histories_equal(hist, full_hist), f"lm_checkpoint {name}: history")
        require(b_dtype == ("torch.bfloat16" if stats == "bf16" else "torch.float32"),
                f"lm_checkpoint {name}: the guard's B is {b_dtype}")
        require(not any(v for k, v in cross.items() if k.endswith("differs")),
                f"lm_checkpoint {name}: across devices {cross}")
        require(cross["cpu_restore_device"] == "cpu"
                and cross["card_restore_device"].startswith("cuda"),
                f"lm_checkpoint {name}: restored onto the template's device")
        require(truncated_latest == CKPT_STOP and at == CKPT_STOP,
                f"lm_checkpoint {name}: the truncated newest is skipped {damage}")
        require(q_at == CKPT_STOP and damage["quarantined"] and damage["warned"],
                f"lm_checkpoint {name}: the corrupted newest is quarantined {damage}")
        del full, resumed, back, on_cpu, on_card, fell_back
    emit("lm_checkpoint", seconds=time.perf_counter() - t_phase)
    return launches


def to_cpu(tree):
    return tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t, tree)


def first_tensor(tree) -> torch.Tensor:
    return next(t for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


# the campaign phase: the launcher's reduced width, per-worker batch 1
TC_T, TC_SEEDS, TC_BATCH = 10, (0, 1), 1
TC_LOSS_RTOL = 1e-5          # a row against its run alone
TC_CPU_LOSS_RTOL = 1e-4      # the card's rows against the CPU's
# variant -> the kernels one step of a group launches, once for its runs;
# the fused variants take the V of a dp_exact step (TC_FUSED)
TC_VARIANTS = {"byzantine_sgd@dp_exact": ("filtered_mean",),
               "byzantine_sgd@dp_sketch": ("countsketch", "filtered_mean"),
               "byzantine_sgd@fused": ("fused_guard", "filtered_mean"),
               "byzantine_sgd@fused@bf16": ("fused_guard", "filtered_mean"),
               "mean": ()}
TC_FUSED = ("byzantine_sgd@fused", "byzantine_sgd@fused@bf16")
TC_DECISIONS = ("n_alive_final", "byz_alive_final", "n_byz_ever", "ever_filtered_good")


def tc_setup(dev):
    cfg = get_config(LM_ARCH).reduced(max_d_model=LM_LAUNCH["d_model"])
    model = build_model(cfg, device=dev)
    stream = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=LM_LAUNCH["seq_len"], seed=0)
    opt = adamw(linear_warmup_cosine(LM_LR, warmup=max(TC_T // 20, 1), total_steps=TC_T),
                grad_clip=1.0)
    scfg = SolverConfig(m=LM_LAUNCH["workers"], T=TC_T, eta=LM_LR, alpha=LM_ALPHA,
                        attack="sign_flip", mean_over_alive=True)
    grid = expand_grid([("static", scenario_static("sign_flip")),
                        ("churn", scenario_churn("sign_flip", period=TC_T // 2, stride=1))],
                       [LM_ALPHA], TC_SEEDS)
    return model, stream, opt, scfg, grid


def tc_row_alone(model, opt, cfg, grid, i: int, V: float, stream) -> dict:
    """Grid row ``i`` as a run of its own (no run axis), as the campaign
    runs a row."""
    dev = model.device
    adv = ScenarioAdversary(scenario=grid.scenarios[i], alpha=grid.alpha[i])
    step = build_train_step(model, opt, cfg, V=V, adversary=adv)
    init_key, mask_key, loop_key = prng.split(prng.PRNGKey(int(grid.seeds[i]), device=dev), 3)
    state = init_train_state(model, opt, cfg, init_key, V=V, adversary=adv)
    rank = byz_rank(mask_key, cfg.m)
    losses, goodf = [], []
    for k in range(TC_T):
        batch = make_worker_batch(stream, cfg.m, TC_BATCH, k, device=dev)
        state, m = step(state, batch, rank, prng.fold_in(loop_key, k))
        losses.append(m["loss_good_workers"])
        goodf.append(m["good_filtered"])
    return {"loss_first": float(losses[0]), "loss_final": float(losses[-1]),
            "n_alive_final": int(state.prev_n_alive), "byz_alive_final": int(m["byz_alive"]),
            "n_byz_ever": int(state.ever_byz.sum()),
            "ever_filtered_good": bool(any(int(g) > 0 for g in goodf))}


def tc_rows(st) -> list:
    """A variant's stats as one dict a row."""
    cols = {f: getattr(st, f).cpu().tolist() for f in st._fields}
    return [{f: cols[f][i] for f in cols} for i in range(len(cols["loss_first"]))]


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def lm_train_campaign(dev) -> dict:
    """``run_train_campaign`` of internlm2-1.8b at the launcher's reduced
    width (d_model 128, seq 64, per-worker batch 1, W = 8, α = 0.25, T =
    TC_T) over static and churning sign_flip × 2 seeds (2 groups of 2
    rows), each variant of TC_VARIANTS with the launch counts set to 0 just
    before it and read just after: each kernel T times a group; every row
    deciding as its run alone (losses within TC_LOSS_RTOL); the same
    campaign on the CPU deciding alike (losses within TC_CPU_LOSS_RTOL); no
    honest worker filtered by a guard; the batched wall time against the
    rows' alone.  Returns the launches by (name, dtype)."""
    t_phase = time.perf_counter()
    model, stream, opt, scfg, grid = tc_setup(dev)
    groups = run_groups(grid)
    require(len(groups) == 2 and all(len(g) == 2 for g in groups), "2 groups of 2 rows")
    # the fused guards' V: a dp_exact step's v_est at this width and batch
    _, h = run_training(LM_ARCH, device=dev, verbose=False, d_model=LM_LAUNCH["d_model"],
                        workers=scfg.m, seq_len=LM_LAUNCH["seq_len"],
                        per_worker_batch=TC_BATCH, steps=TC_T, stop_after=1)
    v_fused = h[0]["v_est"]
    cpu_model, cpu_stream, cpu_opt, _, cpu_grid = tc_setup("cpu")
    launches: dict = {}
    for variant, kernels in TC_VARIANTS.items():
        V = v_fused if variant in TC_FUSED else 0.0
        vcfg = expand_variants(scfg, [variant])[variant]
        torch.cuda.synchronize()
        reset_counts()
        res = run_train_campaign(model, opt, scfg, grid, steps=TC_T, stream=stream,
                                 per_worker_batch=TC_BATCH, aggregators=[variant], V=V)
        got = read_counts()
        want = counts(**{k: TC_T * len(groups) for k in kernels})
        dt = vcfg.stats_dtype
        for k, n in got.items():
            if n:
                launches[(k, dt)] = launches.get((k, dt), 0) + n
        rows = tc_rows(res.stats[variant])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alone = [tc_row_alone(model, opt, vcfg, grid, i, V, stream) for i in range(grid.n_runs)]
        torch.cuda.synchronize()
        alone_s = time.perf_counter() - t0
        cpu = tc_rows(run_train_campaign(cpu_model, cpu_opt, scfg, cpu_grid, steps=TC_T,
                                         stream=cpu_stream, per_worker_batch=TC_BATCH,
                                         aggregators=[variant], V=V).stats[variant])
        alone_equal = all(r[f] == a[f] for r, a in zip(rows, alone) for f in TC_DECISIONS)
        alone_rel = max(rel(r[f], a[f]) for r, a in zip(rows, alone)
                        for f in ("loss_first", "loss_final"))
        cpu_equal = all(r[f] == c[f] for r, c in zip(rows, cpu) for f in TC_DECISIONS)
        cpu_rel = max(rel(r[f], c[f]) for r, c in zip(rows, cpu)
                      for f in ("loss_first", "loss_final"))
        emit("lm_train_campaign", variant=variant, arch=LM_ARCH, d_model=LM_LAUNCH["d_model"],
             W=scfg.m, T=TC_T, batch=TC_BATCH, seq_len=LM_LAUNCH["seq_len"], V=V,
             runs=grid.n_runs, groups=len(groups), launches=got, rows=rows,
             rows_alone_decisions_equal=alone_equal, rows_alone_loss_rel_max=alone_rel,
             cpu_decisions_equal=cpu_equal, cpu_loss_rel_max=cpu_rel,
             batched_s=res.wall_s, rows_alone_s=alone_s, compile_s=res.compile_s,
             peak_bytes=res.memory["peak_bytes"], card=card_line())
        require(got == want, f"lm_train_campaign {variant}: launches {got} != {want}")
        require(alone_equal and alone_rel <= TC_LOSS_RTOL,
                f"lm_train_campaign {variant}: rows as their runs alone ({alone_rel})")
        require(cpu_equal and cpu_rel <= TC_CPU_LOSS_RTOL,
                f"lm_train_campaign {variant}: the card decides as the CPU ({cpu_rel})")
        require(all(math.isfinite(r["loss_final"]) for r in rows),
                f"lm_train_campaign {variant}: finite losses")
        if variant != "mean":
            require(not any(r["ever_filtered_good"] for r in rows),
                    f"lm_train_campaign {variant}: an honest worker was filtered")
    emit("lm_train_campaign", seconds=time.perf_counter() - t_phase)
    return launches


# the serve phase: internlm2-1.8b at its full published configuration
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS, SERVE_CACHE = 4, 64, 32, 256
SERVE_PARAMS = 1_889_110_016   # every layer and width as published
# Decoded logits against a teacher-forced forward over the prompt and the
# generated tokens: ‖got − want‖ ≤ rtol·‖want‖ at each position.  The two
# take each product in another shape (B x 1 against B x S rows): in bf16
# each layer rounds its outputs apart, and 5e-2 is about 13 units of 2^-8
# after 24 layers; in f32, 1e-5.  The argmax is held where the forward's
# top two logits lie further apart than twice rtol·max|logit|.
SERVE_LOGIT_RTOL = {"bfloat16": 5e-2, "float32": 1e-5}
SERVE_RING = dict(window=32, prompt=16, steps=40)   # a swa ring that wraps


def attention_rescaled(params: dict, cfg) -> dict:
    """The weights with each attention projection scaled to 1/√(its
    contracted fan-in).  The reference's init takes a stacked (L, d, H, hd)
    leaf's fan-in as H (wq std 1/4, wk and wv 1/√8, wo 1/√128 at
    internlm2-1.8b's widths), which leaves the attention near one-hot at
    full width: one rounding apart in any layer flips a head's choice, and
    by layer 24 the logits of two equal computations in two orders
    decorrelate.  Rescaled, the same weights hold a decode check."""
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    factor = {"wq": math.sqrt(H / d), "wk": math.sqrt(KV / d), "wv": math.sqrt(KV / d),
              "wo": 1.0 / math.sqrt(H)}
    out = dict(params)
    out["groups"] = [
        {**gp, "mixer": {k: (w.float() * factor[k]).to(w.dtype) for k, w in gp["mixer"].items()}}
        if "wq" in gp["mixer"] else gp for gp in params["groups"]]
    return out


def serve_logit_check(model, params, res, rtols: dict | None = None) -> dict:
    """Prefill's last logits and each decode step's (``res.logits``) against
    a teacher-forced ``forward`` over the prompt and ``res.tokens``, within
    ``rtols`` (SERVE_LOGIT_RTOL by default) for the model's dtype."""
    cfg = model.cfg
    rtol = (rtols or SERVE_LOGIT_RTOL)[cfg.activation_dtype]
    key = prng.PRNGKey(0, device=model.device)
    prompt = prng.randint(key, (SERVE_BATCH, SERVE_PROMPT), 0, cfg.vocab_size)
    seq = torch.cat([prompt, res.tokens[:, :-1]], dim=1)
    with torch.no_grad():
        h, _, _ = model.forward(params, {"tokens": seq})
        want = _lm_head(cfg, params, h[:, SERVE_PROMPT - 1:]).float()   # (B, T, V)
    got = torch.cat(res.logits, dim=1).float()
    err = (got - want).norm(dim=-1) / want.norm(dim=-1)                 # (B, T)
    top2 = torch.topk(want, 2, dim=-1).values
    held = top2[..., 0] - top2[..., 1] > 2 * rtol * want.abs().amax(-1)
    argmax_equal = torch.argmax(got, -1) == torch.argmax(want, -1)
    return {"dtype": cfg.activation_dtype, "rtol": rtol,
            "logits_rel_err_max": float(err.max()), "logits_rel_err_mean": float(err.mean()),
            "rel_err_max_by_step": [round(float(e), 6) for e in err.amax(0)],
            "argmax_held": int(held.sum()), "argmax_held_equal": bool(argmax_equal[held].all()),
            "argmax_equal": int(argmax_equal.sum()), "positions": int(err.numel()),
            "tokens_are_argmax": bool(torch.equal(res.tokens,
                                                  torch.argmax(got, -1).to(torch.int32)))}


def serve_check_passed(check: dict) -> bool:
    return (check["logits_rel_err_max"] <= check["rtol"] and check["argmax_held_equal"]
            and check["tokens_are_argmax"])


def serve_reduced(cfg, device, ring: bool = False):
    """Greedy tokens of a reduced config from PRNGKey(0): ``run_serving``'s
    sizes, or the ring's (prompt 16, 40 decode steps into caches of the
    window's size)."""
    model = build_model(cfg, device=device)
    key = prng.PRNGKey(0, device=model.device)
    params = model.init(key)
    if ring:
        prompt = prng.randint(key, (SERVE_BATCH, SERVE_RING["prompt"]), 0, cfg.vocab_size)
        res = generate(model, params, prompt, gen_tokens=SERVE_RING["steps"] + 1,
                       cache_len=SERVE_RING["window"])
    else:
        prompt = prng.randint(key, (SERVE_BATCH, SERVE_PROMPT), 0, cfg.vocab_size)
        res = generate(model, params, prompt, gen_tokens=SERVE_TOKENS, cache_len=SERVE_CACHE)
    return res.tokens.cpu()


def lm_serve_full_width(dev) -> None:
    """``run_serving(reduced=False)`` of internlm2-1.8b (24 layers, every
    published width, bf16, weights from PRNGKey(0)): batch 4, prompt 64, 32
    tokens, cache_len 256, with the launch counts set to 0 just before and
    read just after (no guard kernel launches); prefill ms, ms a decoded
    token, tokens/s, peak GB, and its logits against the teacher-forced
    forward (printed: with the reference's init they decorrelate by layer
    24, see attention_rescaled).  The held check: the same weights with
    the attention rescaled, through ``generate`` (run_serving's loop), in
    bf16 and in f32, each within SERVE_LOGIT_RTOL of the teacher-forced
    forward at every position.  Then at the reduced width the card's
    greedy tokens against the CPU's for the plain cache, the int8 cache and
    a sliding-window ring that wraps."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_counts()
    res = run_serving(LM_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                      gen_tokens=SERVE_TOKENS, cache_len=SERVE_CACHE, seed=0, reduced=False,
                      device=dev, keep_logits=True, verbose=False)
    got = read_counts()
    cfg = get_config(LM_ARCH)
    model = build_model(cfg, device=dev)
    key = prng.PRNGKey(0, device=dev)
    params = model.init(key)
    as_initialized = serve_logit_check(model, params, res)
    emit("lm_serve_full_width", arch=LM_ARCH, n_layers=cfg.n_layers, d_model=cfg.d_model,
         n_params=model.n_params, dtype=cfg.param_dtype, batch=SERVE_BATCH,
         prompt_len=SERVE_PROMPT, gen_tokens=SERVE_TOKENS, cache_len=SERVE_CACHE,
         prefill_ms=1e3 * res.prefill_s, ms_per_token=res.ms_per_token,
         tokens_per_s=res.tokens_per_s, peak_gb=res.peak_bytes / 1e9,
         # a token's least time: every bf16 weight read once
         decode_bound_ms=1e3 * 2.0 * model.n_params / HBM_BYTES_PER_S, launches=got,
         sample=res.tokens[0, :16].tolist(), logits_as_initialized=as_initialized,
         card=card_line())
    require(model.n_params == SERVE_PARAMS, f"lm_serve_full_width: {model.n_params} parameters")
    require(got == counts(), f"lm_serve_full_width: guard kernels launched {got}")
    require(res.tokens.shape == (SERVE_BATCH, SERVE_TOKENS) and as_initialized[
        "tokens_are_argmax"], "lm_serve_full_width: greedy tokens")
    prompt = prng.randint(key, (SERVE_BATCH, SERVE_PROMPT), 0, cfg.vocab_size)
    for dtype in ("bfloat16", "float32"):
        if dtype == "float32":
            cfg = dataclasses.replace(cfg, param_dtype=dtype, activation_dtype=dtype)
            model = build_model(cfg, device=dev)
            params = model.init(key)
        scaled = attention_rescaled(params, cfg)
        del params
        reset_counts()
        out = generate(model, scaled, prompt, gen_tokens=SERVE_TOKENS, cache_len=SERVE_CACHE,
                       keep_logits=True)
        launches = read_counts()
        check = serve_logit_check(model, scaled, out)
        emit("lm_serve_full_width", check="attention_rescaled",
             ms_per_token=out.ms_per_token, peak_gb=out.peak_bytes / 1e9, launches=launches,
             **check)
        require(serve_check_passed(check) and launches == counts(),
                f"lm_serve_full_width: decode against the teacher-forced forward ({dtype})")
        del scaled, out
    del model
    torch.cuda.empty_cache()

    reduced = get_config(LM_ARCH).reduced()
    ring = get_config("starcoder2-3b").reduced()   # its window cut to 32
    require(ring.sliding_window == SERVE_RING["window"], "starcoder2-3b reduced: window 32")
    cases = {"plain_cache": (reduced, False),
             "int8_cache": (dataclasses.replace(reduced, kv_cache_dtype="int8"), False),
             "swa_ring": (ring, True)}
    for name, (rcfg, is_ring) in cases.items():
        reset_counts()
        card = serve_reduced(rcfg, dev, is_ring)
        card_launches = read_counts()
        cpu = serve_reduced(rcfg, "cpu", is_ring)
        equal = bool(torch.equal(card, cpu))
        emit("lm_serve_full_width", case=name, arch=rcfg.name, d_model=rcfg.d_model,
             kv_cache_dtype=rcfg.kv_cache_dtype, activation_dtype=rcfg.activation_dtype,
             sliding_window=rcfg.sliding_window,
             tokens=card.shape[1], tokens_equal_to_cpu=equal, launches=card_launches,
             first_row=card[0, :16].tolist())
        require(equal, f"lm_serve_full_width {name}: the card's greedy tokens are the CPU's")
        require(card_launches == counts(), f"lm_serve_full_width {name}: launches")
    emit("lm_serve_full_width", seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------- phases 22-25: MoE and
# Mamba2/SSD

SSM_ARCH = "mamba2-130m"
SSM_D = 167_573_952       # its parameter count: all 24 layers at every published width
SSM_SEQ = 256             # one published SSD chunk
SSM_T = 20
# (backend, stats, sign_flip's scale): dp_sketch@bf16 first, fused@bf16 at
# its step-0 v_est.  The sketch guard runs sign_flip at twice its default
# scale (−6g), as the reference's own train benchmark runs it
# (benchmarks/bench_train.py, attack_scale=2): at the synthetic-LM
# gradient geometry −3g sits inside the 1.5× slack its threshold carries
# by design, and 20 steps filtered neither attacker on an H100 (PERF.md §5)
SSM_RUNS = (("dp_sketch", "bf16", 6.0), ("fused", "bf16", 3.0))
# (phase, arch, layers kept, parameters at that depth, the decode check's
# dtypes): every width as published.  kimi-k2's f32 weights (80 GB) do
# not fit the card; jamba's (53 GB) do, and in f32 no route flips, so
# every position is held
MOE_SERVE = (("lm_serve_moe_full_width", "kimi-k2-1t-a32b", 2, 19_934_645_248, ("bfloat16",)),
             ("lm_serve_hybrid_full_width", "jamba-v0.1-52b", 8, 13_267_598_848,
              ("bfloat16", "float32")))
# The share of positions that some MoE layer routes to other experts in
# the served pass than in the teacher-forced one (bf16, C = T in both):
# the bound PERF.md §5 derives from bf16 rounding before the first chip
# run (kimi-k2 ~6 %, jamba ~6 % predicted)
ROUTE_DIFF_BOUND = 0.25
MOE_SSM_REDUCED = ("kimi-k2-1t-a32b", "jamba-v0.1-52b")
# The card's launcher losses against the CPU's: LM_LOSS_TOL's 1e-4 over
# the first LM_LOSS_FIRST steps, and over all 40 the drift the JAX package
# and the port show against each other on one CPU in the same run
# (scripts/launcher_drift.py, decisions equal throughout): kimi-k2 1.0e-4,
# within LM_LOSS_TOL; jamba 1.8e-3 at step 30 (its Mamba layers amplify
# AdamW's f32 rounding more than the dense decoder's 3.3e-4), so 3e-3
MOE_SSM_LOSS_TOL = {"kimi-k2-1t-a32b": LM_LOSS_TOL, "jamba-v0.1-52b": (1e-4, 3e-3)}
# Decode against the teacher-forced forward where Mamba layers carry the
# state (mamba2-130m, and jamba in f32).  The 24 Mamba layers at the
# reference's init amplify rounding: on the CPU mamba2-130m's f32 forward
# itself sits up to 2.4e-5 from the same function taken in f64, and the
# decoded logits 2.1e-5 (scripts/check_ssm_decode.py), so f32 is held to
# 1e-4; in bf16 decode and forward round in different places (the
# recurrence keeps x, B, C and y in f32 where the chunked form rounds
# them to bf16) and the CPU run read 0.13 at the 18th decoded token, so
# bf16 is held to 0.25 and to its argmax where the top two lie apart.
SSM_SERVE_LOGIT_RTOL = {"bfloat16": 0.25, "float32": 1e-4}


def ssm_activation_gb(cfg, rows: int, seq: int) -> dict:
    """The Mamba layers' activations the backward keeps, in GB, for
    ``rows`` sequences of ``seq`` tokens (every worker's batch under the
    trainer's vmap): a layer's Q×Q f32 scores a head, four of them (the
    masked decay, its exp, the scores times it, the masked product), and
    a token's twelve f32 vectors of d_inner (the conv outputs and their
    silu, the SSD's f32 inputs, dtx, the two partial outputs and their
    sum, the gate's silu, the norm's f32 input); then the f32 logits and
    their gradient."""
    Q = min(cfg.ssm_chunk, seq)
    scores = 4 * rows * (seq // Q) * cfg.n_ssm_heads * Q * Q * 4.0
    tokens = 12 * rows * seq * cfg.d_inner_ssm * 4.0
    logits = 2 * rows * seq * cfg.vocab_size * 4.0
    layers = cfg.n_layers * (scores + tokens)
    return {"scores_gb": cfg.n_layers * scores / 1e9, "token_vectors_gb": cfg.n_layers * tokens
            / 1e9, "logits_gb": logits / 1e9, "activations_gb": (layers + logits) / 1e9}


def lm_train_ssm_full_width(dev) -> dict:
    """mamba2-130m at every published width and all 24 layers (d =
    167,573,952 parameters, padded to a multiple of 128 as the harness
    pads), W = 8, α = 0.25, sign_flip, per-worker batch 2, seq 256 (one
    published SSD chunk, whose Σdt passes 88: the reference's SSD backward
    gives NaN there, the port's masked one does not), T = 20: dp_sketch@bf16,
    then fused@bf16 at dp_sketch's step-0 v_est.  Each run launches every
    guard kernel of its path T times (held to its plain version at this d
    on step 0's operands), filters both attackers and no honest worker,
    and has every worker's gradient finite at every step; ms a phase, peak
    GB against a reckoning.  Returns the launches by (name, dtype)."""
    t_phase = time.perf_counter()
    free_card()
    cfg = get_config(SSM_ARCH)
    model = build_model(cfg, device=dev)
    harness = params_harness(model)
    require(model.n_params == SSM_D and harness.d == -(-SSM_D // 128) * 128,
            f"mamba2-130m has d = {model.n_params} (pad {harness.d})")
    launches: dict = {}
    failures, V = [], 0.0
    for backend, stats, scale in SSM_RUNS:
        reckon = lm_reckon_gb(backend, stats, model.n_params, harness.d, LM_W)
        acts = ssm_activation_gb(cfg, LM_W * LM_BATCH, SSM_SEQ)
        reckon = dict(reckon, **acts, gradients_with_activations_gb=reckon["gradients_gb"]
                      + acts["activations_gb"])
        t0 = time.perf_counter()
        res = lm_run(model, backend, stats, V, SSM_T, dev, seq=SSM_SEQ,
                     attack_kwargs=(("scale", scale),), check_finite=True)
        emit("lm_train_ssm_full_width", arch=SSM_ARCH, n_layers=cfg.n_layers, d=harness.d,
             W=LM_W, alpha=LM_ALPHA, attack="sign_flip", attack_scale=scale, T=SSM_T,
             batch=LM_BATCH,
             seq_len=SSM_SEQ, ssm_chunk=cfg.ssm_chunk, V=V, reckoned=reckon,
             seconds=time.perf_counter() - t0, card=card_line(), **res)
        if backend == "dp_sketch":
            V = res["v_est_step0"]
        try:
            lm_checks(res, backend, SSM_T, int(LM_ALPHA * LM_W))
        except RuntimeError as err:   # both configurations run; all failures reported
            failures.append(str(err))
        for name, n in res["launches"].items():
            if n:
                launches[(name, "bf16")] = launches.get((name, "bf16"), 0) + n
    del model
    free_card()
    require(not failures, "; ".join(failures))
    emit("lm_train_ssm_full_width", seconds=time.perf_counter() - t_phase)
    return launches


@contextlib.contextmanager
def recorded_routes():
    """Route ``models.moe.moe_apply`` through a recorder that keeps, a
    call, its tokens' expert sets ((B, S, K), sorted) and whether each
    choice fit its expert's capacity ((K, B·S) bool), and calls through."""
    saved = moe_lib.moe_apply
    calls: list = []

    def call(p, cfg, x):
        xt = x.reshape(-1, x.shape[-1])
        routes = moe_lib.route(p["router"], xt, cfg.top_k)
        _, keep = moe_lib.dispatch(routes.top_e, cfg.n_experts,
                                   moe_lib.capacity(cfg, xt.shape[0]))
        calls.append((torch.sort(routes.top_e, dim=-1).values.reshape(*x.shape[:2], -1), keep))
        return saved(p, cfg, x)

    moe_lib.moe_apply = call
    try:
        yield calls
    finally:
        moe_lib.moe_apply = saved


def moe_decode_check(model, params, res, served_calls: list, rtols: dict) -> dict:
    """``generate``'s logits (``res``, its routes ``served_calls``) against
    a teacher-forced ``forward`` over the prompt and ``res.tokens``, both
    with C = T (``capacity_factor`` = E), so no choice drops in any pass.
    A position is held when every MoE layer routed it to the same experts
    in both passes, and, for a MoE layer that a later layer's mixer
    follows, every earlier position of its sequence too (the mixer
    carries them into it); the logits at held positions are within
    ``rtols`` for the model's dtype, and their argmax equal where the top
    two lie apart."""
    cfg = model.cfg
    rtol = rtols[cfg.activation_dtype]
    key = prng.PRNGKey(0, device=model.device)
    prompt = prng.randint(key, (SERVE_BATCH, SERVE_PROMPT), 0, cfg.vocab_size)
    seq = torch.cat([prompt, res.tokens[:, :-1]], dim=1)
    with torch.no_grad(), recorded_routes() as forced_calls:
        h, _, _ = model.forward(params, {"tokens": seq})
        want = _lm_head(cfg, params, h[:, SERVE_PROMPT - 1:]).float()    # (B, T, V)
    got = torch.cat(res.logits, dim=1).float()
    moe_layers = [i for i in range(cfg.n_layers) if cfg.ff_for_layer(i) == "moe"]
    n = len(moe_layers)
    require(len(forced_calls) == n and len(served_calls) == n * SERVE_TOKENS,
            f"{cfg.name}: MoE calls {len(forced_calls)}, {len(served_calls)}")
    # the served pass: prefill's n calls, then n a decode step, in layer order
    served = [torch.cat([c[0] for c in served_calls[j::n]], dim=1) for j in range(n)]
    same = torch.stack([(a == b[0]).all(-1) for a, b in zip(served, forced_calls)])  # (n, B, S)
    own = same.all(0)
    carried = [same[j] for j, i in enumerate(moe_layers) if i < cfg.n_layers - 1]
    prefix = (torch.cummin(torch.stack(carried).all(0).to(torch.int32), dim=1).values.bool()
              if carried else torch.ones_like(own))
    held = (own & prefix)[:, SERVE_PROMPT - 1:]                          # (B, T)
    err = (got - want).norm(dim=-1) / want.norm(dim=-1)
    top2 = torch.topk(want, 2, dim=-1).values
    apart = held & (top2[..., 0] - top2[..., 1] > 2 * rtol * want.abs().amax(-1))
    argmax_equal = torch.argmax(got, -1) == torch.argmax(want, -1)
    return {"dtype": cfg.activation_dtype, "rtol": rtol, "capacity_factor": cfg.capacity_factor,
            "moe_layers": moe_layers, "positions": int(own.numel()),
            "route_differs_share": float(1.0 - own.float().mean()),
            "route_differs_share_by_layer": [float(1.0 - s.float().mean()) for s in same],
            "route_differs_bound": ROUTE_DIFF_BOUND,
            "logit_positions": int(held.numel()), "logit_positions_held": int(held.sum()),
            "logits_rel_err_max_held": float(err[held].max()) if held.any() else None,
            "logits_rel_err_max": float(err.max()), "logits_rel_err_mean": float(err.mean()),
            "argmax_apart": int(apart.sum()), "argmax_apart_equal": bool(argmax_equal[apart].all()),
            "tokens_are_argmax": bool(torch.equal(res.tokens,
                                                  torch.argmax(got, -1).to(torch.int32)))}


def moe_check_passed(check: dict) -> bool:
    rel = check["logits_rel_err_max_held"]
    return (check["route_differs_share"] <= check["route_differs_bound"]
            and (rel is None or rel <= check["rtol"]) and check["argmax_apart_equal"]
            and check["tokens_are_argmax"])


def moe_serve_full_width(dev, phase: str, arch: str, n_layers: int, n_params: int,
                         check_dtypes: tuple) -> None:
    """``arch`` at every published width with the depth cut to ``n_layers``
    (bf16, weights from PRNGKey(0), drawn once): ``generate``
    (``run_serving``'s loop) at batch 4, prompt 64, 32 tokens, cache 256
    with no guard kernel launched; init seconds, prefill ms, ms a token
    against every weight read once, tokens/s, peak GB, and the share of
    prefill's choices dropped at the published capacity_factor; then the
    decode check (``moe_decode_check``) on the same weights with the
    attention rescaled (``attention_rescaled``) and C = T, and in each
    other dtype of ``check_dtypes`` on weights drawn again in it; a model
    with Mamba layers is held to SSM_SERVE_LOGIT_RTOL, else to
    SERVE_LOGIT_RTOL.  The weights are freed at the end."""
    t_phase = time.perf_counter()
    free_card()
    at_start_gb = torch.cuda.memory_allocated() / 1e9
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    rtols = (SSM_SERVE_LOGIT_RTOL if any(s.mixer == "mamba" for s in cfg.layer_plan())
             else SERVE_LOGIT_RTOL)
    model = build_model(cfg, device=dev)
    require(model.n_params == n_params, f"{phase}: {model.n_params} parameters")
    key = prng.PRNGKey(0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(key)
    torch.cuda.synchronize()
    init_s, init_peak_gb = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9
    prompt = prng.randint(key, (SERVE_BATCH, SERVE_PROMPT), 0, cfg.vocab_size)
    reset_counts()
    res = generate(model, params, prompt, gen_tokens=SERVE_TOKENS, cache_len=SERVE_CACHE)
    launches = read_counts()
    with torch.no_grad(), recorded_routes() as calls:
        model.prefill(params, {"tokens": prompt}, cache_len=SERVE_CACHE)
    keep = torch.cat([k.reshape(-1) for _, k in calls])
    emit(phase, arch=arch, n_layers=n_layers, n_layers_published=get_config(arch).n_layers,
         d_model=cfg.d_model, n_experts=cfg.n_experts, top_k=cfg.top_k,
         n_shared_experts=cfg.n_shared_experts, layer_plan=[(s.mixer, s.ff, s.count)
                                                            for s in cfg.layer_plan()],
         n_params=model.n_params, dtype=cfg.param_dtype, batch=SERVE_BATCH,
         prompt_len=SERVE_PROMPT, gen_tokens=SERVE_TOKENS, cache_len=SERVE_CACHE,
         allocated_at_start_gb=at_start_gb, init_seconds=init_s, init_peak_gb=init_peak_gb,
         prefill_ms=1e3 * res.prefill_s, ms_per_token=res.ms_per_token,
         tokens_per_s=res.tokens_per_s, peak_gb=res.peak_bytes / 1e9,
         # a token's least time: every bf16 weight read once
         decode_bound_ms=1e3 * 2.0 * model.n_params / HBM_BYTES_PER_S, launches=launches,
         capacity_factor=cfg.capacity_factor,
         prefill_capacity=moe_lib.capacity(cfg, SERVE_BATCH * SERVE_PROMPT),
         decode_capacity=moe_lib.capacity(cfg, SERVE_BATCH),
         prefill_choices_dropped_share=float(1.0 - keep.float().mean()),
         sample=res.tokens[0, :16].tolist(), card=card_line())
    require(launches == counts(), f"{phase}: guard kernels launched {launches}")
    require(res.tokens.shape == (SERVE_BATCH, SERVE_TOKENS), f"{phase}: greedy tokens")
    del res, calls, model
    for dtype in check_dtypes:
        dcfg = dataclasses.replace(cfg, param_dtype=dtype, activation_dtype=dtype,
                                   capacity_factor=float(cfg.n_experts))
        model = build_model(dcfg, device=dev)
        if dtype != cfg.param_dtype:
            free_card()
            params = model.init(key)
        scaled = attention_rescaled(params, dcfg)
        del params
        reset_counts()
        with recorded_routes() as served:
            out = generate(model, scaled, prompt, gen_tokens=SERVE_TOKENS,
                           cache_len=SERVE_CACHE, keep_logits=True)
        check = moe_decode_check(model, scaled, out, served, rtols)
        emit(phase, check="attention_rescaled_capacity_T", launches=read_counts(),
             ms_per_token=out.ms_per_token, peak_gb=out.peak_bytes / 1e9, **check)
        require(moe_check_passed(check),
                f"{phase}: decode against the teacher-forced forward ({dtype})")
        del scaled, out, served, model
        params = None
    free_card()
    emit(phase, seconds=time.perf_counter() - t_phase)


def ssm_serve_full_width(dev) -> None:
    """``run_serving(reduced=False)`` of mamba2-130m, its whole published
    configuration (24 layers, bf16, PRNGKey(0)): batch 4, prompt 64, 32
    tokens, cache 256, no guard kernel launched; prefill ms, ms a token
    against every weight read once, tokens/s, peak GB; then its logits
    against the teacher-forced forward in bf16 (the same weights) and in
    f32 (drawn again in f32, through ``generate``), every position within
    SSM_SERVE_LOGIT_RTOL (no attention and no router: nothing to rescale
    or to exclude)."""
    t_phase = time.perf_counter()
    free_card()
    at_start_gb = torch.cuda.memory_allocated() / 1e9
    reset_counts()
    res = run_serving(SSM_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                      gen_tokens=SERVE_TOKENS, cache_len=SERVE_CACHE, seed=0, reduced=False,
                      device=dev, keep_logits=True, verbose=False)
    launches = read_counts()
    cfg = get_config(SSM_ARCH)
    key = prng.PRNGKey(0, device=dev)
    prompt = prng.randint(key, (SERVE_BATCH, SERVE_PROMPT), 0, cfg.vocab_size)
    emit("lm_serve_ssm_full_width", arch=SSM_ARCH, n_layers=cfg.n_layers, n_params=SSM_D,
         dtype=cfg.param_dtype, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
         gen_tokens=SERVE_TOKENS, cache_len=SERVE_CACHE, prefill_ms=1e3 * res.prefill_s,
         ms_per_token=res.ms_per_token, tokens_per_s=res.tokens_per_s,
         peak_gb=res.peak_bytes / 1e9, decode_bound_ms=1e3 * 2.0 * SSM_D / HBM_BYTES_PER_S,
         allocated_at_start_gb=at_start_gb, launches=launches,
         sample=res.tokens[0, :16].tolist(), card=card_line())
    require(launches == counts(), f"lm_serve_ssm_full_width: guard kernels launched {launches}")
    for dtype in ("bfloat16", "float32"):
        dcfg = dataclasses.replace(cfg, param_dtype=dtype, activation_dtype=dtype)
        model = build_model(dcfg, device=dev)
        params = model.init(key)
        require(model.n_params == SSM_D, f"mamba2-130m: {model.n_params} parameters")
        if dtype == "float32":
            res = generate(model, params, prompt, gen_tokens=SERVE_TOKENS,
                           cache_len=SERVE_CACHE, keep_logits=True)
        check = serve_logit_check(model, params, res, SSM_SERVE_LOGIT_RTOL)
        emit("lm_serve_ssm_full_width", check="decode_against_forward", ms_per_token=
             res.ms_per_token, peak_gb=res.peak_bytes / 1e9, **check)
        require(serve_check_passed(check),
                f"lm_serve_ssm_full_width: decode against the teacher-forced forward ({dtype})")
        del model, params
    del res
    free_card()
    emit("lm_serve_ssm_full_width", seconds=time.perf_counter() - t_phase)


def moe_ssm_reduced(dev) -> dict:
    """kimi-k2 and jamba at their reduced widths through ``launch.train.
    run_training`` (the launcher phase's sizes) on the card and on the
    CPU: decisions equal at every step, losses within MOE_SSM_LOSS_TOL; then
    the greedy tokens of the three reduced configs (kimi-k2, jamba,
    mamba2-130m; ``run_serving``'s sizes), the card's equal to the CPU's.
    Returns the card runs' launches by (name, dtype)."""
    t_phase = time.perf_counter()
    steps = LM_LAUNCH["steps"]
    keys = ("n_alive", "byz_alive", "good_filtered", "n_byz")
    for arch in MOE_SSM_REDUCED:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        _, card = run_training(arch, device=dev, verbose=False, **LM_LAUNCH)
        torch.cuda.synchronize()
        card_s, launches = time.perf_counter() - t0, read_counts()
        t0 = time.perf_counter()
        _, cpu = run_training(arch, device="cpu", verbose=False, **LM_LAUNCH)
        cpu_s = time.perf_counter() - t0
        decisions_equal = all(a[k] == b[k] for a, b in zip(card, cpu) for k in keys)
        rel = [abs(a["loss_good_workers"] - b["loss_good_workers"]) / abs(b["loss_good_workers"])
               for a, b in zip(card, cpu)]
        loss_rel, loss_rel_first = max(rel), max(rel[:LM_LOSS_FIRST])
        tol = MOE_SSM_LOSS_TOL[arch]
        emit("moe_ssm_reduced", arch=arch, **LM_LAUNCH, card_seconds=card_s, cpu_seconds=cpu_s,
             launches=launches, decisions_equal=decisions_equal, loss_rel_max=loss_rel,
             loss_rel_max_first_steps=loss_rel_first, loss_tol=tol,
             n_alive=[int(r["n_alive"]) for r in card],
             loss_first_last=[card[0]["loss_good_workers"], card[-1]["loss_good_workers"]])
        require(launches == counts(filtered_mean=steps), f"{arch} launcher launches {launches}")
        require(decisions_equal, f"{arch} launcher: decisions equal to the CPU's at every step")
        require(loss_rel_first <= tol[0] and loss_rel <= tol[1],
                f"{arch} launcher: losses within {tol} of the CPU's ({loss_rel_first}, "
                f"{loss_rel})")
    for arch in (*MOE_SSM_REDUCED, SSM_ARCH):
        rcfg = get_config(arch).reduced()
        reset_counts()
        card = serve_reduced(rcfg, dev)
        card_launches = read_counts()
        cpu = serve_reduced(rcfg, "cpu")
        equal = bool(torch.equal(card, cpu))
        emit("moe_ssm_reduced", case="greedy_tokens", arch=arch, d_model=rcfg.d_model,
             tokens=card.shape[1], tokens_equal_to_cpu=equal, launches=card_launches,
             first_row=card[0, :16].tolist())
        require(equal, f"{arch} reduced: the card's greedy tokens are the CPU's")
        require(card_launches == counts(), f"{arch} reduced serving: launches")
    emit("moe_ssm_reduced", seconds=time.perf_counter() - t_phase)
    return {("filtered_mean", "f32"): steps * len(MOE_SSM_REDUCED)}


def main() -> int:
    t_start = time.perf_counter()
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
    emit("build", seconds=build_s, libraries=[str(p) for p in libs.values()],
         ptxas={stem: [ln.strip() for ln in _build.build_log(stem).splitlines()
                       if "registers" in ln or "spill" in ln] for stem in libs},
         sort_network=sort_network_report(), countsketch=countsketch_report())
    errs = check_kernels(dev)
    check_order_kernels(dev, errs)
    check_sanitize_kernels(dev, errs)
    small_width_kernels(dev)
    launches, off = main_path(dev)
    q_launches = quarantine_main_path(dev, off)
    small_reference(dev)
    base_launches = baselines(dev)
    baselines_reference(dev)
    q_series = quarantine(dev)
    quarantine_baselines(dev)
    quarantine_reference(dev)
    check_countsketch(dev, errs)
    dp_launches = dp_main_path(dev)
    dp_oracle(dev)
    dp_quarantine(dev)
    dp_reference(dev)
    check_gen_kernels(dev, errs)
    gen_launches = gen_main_path(dev)
    gen_reference(dev)
    workers(dev)
    workers_main_path(dev)
    gram_main(dev)
    entries = time_kernels(dev, errs, launches, base_launches, q_launches, dp_launches,
                           gen_launches, gen_bounds(dev))
    step_split(dev)
    random_gaussian_main_path(dev)
    profile_main_path(dev)
    fault_main_path(dev, q_series)
    profile_reference(dev)
    campaign_stats, campaign_peaks = campaign_main_path(dev)
    gen_campaign_kernels(dev)
    gen_campaign_launches = campaign_gen_main_path(dev, campaign_stats, campaign_peaks)
    entries += gen_runs_entries(dev, gen_campaign_launches)
    require(len(entries) == 2 * len(KERNELS), f"{len(entries)} kernel entries")
    telemetry_phase(dev)
    bitflip_campaign(dev)
    lower = convex_step_alone(dev)
    convex, cpu = convex_pool()
    quickstart(convex, cpu)
    detection_latency(convex, cpu)
    convex_harness(convex, cpu, lower)
    table1_phase(convex, cpu)
    lm_launches = lm_train_launcher(dev)
    for key, n in lm_train_full_width(dev).items():
        lm_launches[key] = lm_launches.get(key, 0) + n
    ckpt_launches = lm_checkpoint(dev)
    tc_launches = lm_train_campaign(dev)
    lm_serve_full_width(dev)
    moe_ssm_launches = lm_train_ssm_full_width(dev)
    for key, n in moe_ssm_reduced(dev).items():
        moe_ssm_launches[key] = moe_ssm_launches.get(key, 0) + n
    for row in MOE_SERVE:
        moe_serve_full_width(dev, *row)
    ssm_serve_full_width(dev)
    for e in entries:
        # the LM phases' launches of this kernel at this dtype (their own
        # runs, counted from 0 before each); serving launches none
        name, dt = e["name"].rstrip("]").split("[")
        e["lm_train_launches"] = lm_launches.get((name, dt), 0)
        e["lm_checkpoint_launches"] = ckpt_launches.get((name, dt), 0)
        e["lm_train_campaign_launches"] = tc_launches.get((name, dt), 0)
        e["lm_moe_ssm_launches"] = moe_ssm_launches.get((name, dt), 0)

    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
