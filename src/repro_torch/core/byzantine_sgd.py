"""ByzantineSGD — Algorithm 1 of Alistarh, Allen-Zhu & Li (NeurIPS 2018),
the PyTorch counterpart of :mod:`repro.core.byzantine_sgd`.

Per worker i the guard keeps the scalar martingale ``A_i = Σ ⟨∇_{t,i},
x_t − x_1⟩`` and the vector martingale ``B_i = Σ ∇_{t,i}``, and each step
filters workers against the median of A (radius 𝔗_A), a counting
vector-median of B (radius 𝔗_B) and a counting vector-median of the fresh
gradients (radius 4V).  Every distance comes from a Gram matrix,
‖v_i − v_j‖² = G_ii + G_jj − 2 G_ij.

Two forms of the step, as in the JAX package: ``dense`` re-derives the B
Gram every step (the oracle), ``fused`` runs the one-pass kernel
(:func:`repro_torch.kernels.ops.fused_guard`), updates the B Gram
incrementally and re-derives it every ``gram_resync_every`` steps.  The
step count ``k`` is a host integer, so the resync is a Python ``if`` and
a step never waits for the device.

Thresholds are computed on the host in f32 (numpy float32 scalars), which
reproduces the JAX package's f32 threshold arithmetic bit for bit.  The
dp guards (:mod:`repro_torch.distributed.byzantine_dp`) calibrate V on the
device and pass it as a 0-d f32 tensor: ``GuardConfig.thresholds``,
:func:`counting_median_index` and :func:`filter_update` then compute the
radii on the device in the JAX package's f32 order for a traced V, with no
host sync.

``report`` (an (m,) bool mask of the workers that reported this step)
zeroes the other rows on entry and restricts the medians to reporters;
a worker that did not report keeps its status.  ``sanitize=True`` is the
quarantine stage of DESIGN.md §15: NaN/Inf gradient entries are zeroed
before every statistic (dense: explicitly; fused: inside the kernel's
sweep, which also counts them per row), rows that held one are not
scored (they enter the filter as non-reporters) and are dropped from
good_k for good, since the alive mask is carried.  On finite input it
changes no bit of the result.

``gen_step`` is the fused step with the batch generated in the kernels
(DESIGN.md §14): ``ops.fused_guard_gen`` and ``ops.gen_xi`` rebuild the
worker rows from the guard's ``GenSpec`` and the step's ``GenStepCtx``,
so no (m, d) gradient tensor exists; it also returns the Byzantine row
sum that the scenario adversary's feedback reads.  ALIE's honest column
moments are taken once a step: the sweep returns them as a (2, d)
tensor that the ξ pass reads.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.obs.spans import guard_scope

# storage dtype of the streamed guard statistics (g strips, the B
# martingale); every accumulation (Grams, A, ξ) stays f32
STATS_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def resolve_stats_dtype(name: str) -> torch.dtype:
    """``'f32' | 'bf16'`` → torch dtype; a typo raises KeyError."""
    try:
        return STATS_DTYPES[name]
    except KeyError:
        raise KeyError(
            f"unknown stats_dtype {name!r}; have {sorted(STATS_DTYPES)}"
        ) from None


class GuardConfig(NamedTuple):
    """Static parameters of the filter (see the JAX ``GuardConfig``)."""

    m: int
    T: int
    V: float
    D: float
    delta: float = 1e-3
    threshold_mode: str = "anytime"
    mean_over_alive: bool = False
    grad_radius_mult: float = 4.0
    median_radius_mult: float = 2.0

    @property
    def C(self) -> float:
        return math.log(16.0 * self.m * max(self.T, 1) / self.delta)

    def thresholds(self, k: int):
        """(𝔗_A, 𝔗_B) at iteration k (1-based), in f32 as in the JAX
        package: 𝔗_A = 4DV·√(t·C), 𝔗_B = 4V·√(t·C), t = max(k, 1) or T.
        A Python-float V gives numpy float32 scalars (4DV and 4V rounded
        once from double); a 0-d f32 tensor V gives 0-d tensors on its
        device, (f32(4D)·V)·root and (4·V)·root with each product in f32,
        as the JAX package rounds a traced V."""
        if self.threshold_mode == "fixed":
            t = np.float32(self.T)
        else:
            t = np.float32(max(k, 1))
        root = np.sqrt(t * np.float32(self.C))
        if isinstance(self.V, torch.Tensor):
            return ((self.V * float(np.float32(4.0 * self.D))) * float(root),
                    (self.V * 4.0) * float(root))
        return (np.float32(4.0 * self.D * self.V) * root,
                np.float32(4.0 * self.V) * root)


class GuardState(NamedTuple):
    """Per-worker filter state.  ``k`` (iterations done) is a host int."""

    A: torch.Tensor        # (m,) f32 scalar martingales
    B: torch.Tensor        # (m, d) gradient sums, in the stats dtype
    alive: torch.Tensor    # (m,) bool — good_{k-1}
    k: int
    gram_B: torch.Tensor   # (m, m) f32 ⟨B_i, B_j⟩


def pairwise_sq_dists_from_gram(gram: torch.Tensor) -> torch.Tensor:
    """‖v_i − v_j‖² from the Gram matrix G_ij = ⟨v_i, v_j⟩."""
    diag = torch.diagonal(gram)
    d2 = diag[:, None] + diag[None, :] - 2.0 * gram
    return torch.clamp(d2, min=0.0)  # clamp numerical negatives


def _sq_radius(radius):
    """radius² as the JAX package rounds it: an f32 radius (numpy scalar or
    0-d tensor) squares in f32, a Python float squares in double and
    rounds once to f32."""
    if isinstance(radius, torch.Tensor):
        return radius * radius
    if isinstance(radius, np.float32):
        return float(radius * radius)
    return float(np.float32(radius * radius))


def _bound(t):
    """A threshold as the right-hand side of a comparison: a 0-d tensor
    stays on its device, an f32 scalar becomes the Python float it is."""
    return t if isinstance(t, torch.Tensor) else float(t)


def counting_median_index(sq_dists: torch.Tensor, radius, report=None):
    """The paper's counting vector-median from pairwise squared distances.

    Returns ``(index, found)``: among points with more than m/2 points
    within ``radius``, the one with the least total distance (first index
    on ties); if there is none, the global medoid.  Both are 0-d tensors on
    the device.  ``report`` ((m,) bool) restricts all of it to reporting
    workers: counts over reporting columns, more than half of the
    reporters, only reporters elected, scores summed over reporters.
    A NaN distance (Grams overflowed by finite garbage) makes its score
    NaN, and ``torch.argmin`` then takes the first NaN, as ``jnp.argmin``."""
    m = sq_dists.shape[0]
    within = sq_dists <= _sq_radius(radius)
    dist = torch.sqrt(sq_dists)
    if report is None:
        score = torch.sum(dist, dim=1)  # total distance (medoid score)
        valid = torch.sum(within, dim=1) * 2 > m
        fallback = score
    else:
        counts = torch.sum(within & report[None, :], dim=1)
        valid = (counts * 2 > torch.sum(report)) & report
        score = torch.sum(torch.where(report[None, :], dist, 0.0), dim=1)
        fallback = torch.where(report, score, math.inf)
    masked_score = torch.where(valid, score, math.inf)
    found = torch.any(valid)
    idx = torch.where(found, torch.argmin(masked_score), torch.argmin(fallback))
    return idx, found


def scalar_median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values when the length is
    even (``torch.median`` would return the lower one), and NaN when any
    entry is NaN (a sort would put the NaNs last and take the median of
    the rest)."""
    s = torch.sort(x).values
    n = s.shape[0]
    med = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.any(torch.isnan(x)), math.nan, med)


def masked_quantile(x: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """The q-quantile of ``x[mask]`` without a host sync, by the JAX
    package's linear-interpolation formula (``masked_median`` and the dp
    guard's ``_masked_quantile``): masked entries sort to +inf, index =
    q·max(n − 1, 0) in f32, result low·(1 − w) + high·w.  On an all-true
    mask it equals ``jnp.quantile(x, q)`` run op by op bit for bit; under
    ``jit`` XLA on the CPU may fuse the last product and sum into an FMA,
    one rounding fewer."""
    n = torch.sum(mask)
    s = torch.sort(torch.where(mask, x, math.inf)).values
    index = q * torch.clamp(n - 1, min=0).to(torch.float32)
    low, high = torch.floor(index), torch.ceil(index)
    w = index - low
    low_val = torch.index_select(s, 0, low.to(torch.int64).reshape(1))[0]
    high_val = torch.index_select(s, 0, high.to(torch.int64).reshape(1))[0]
    return low_val * (1.0 - w) + high_val * w


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The median of ``x[mask]`` (:func:`masked_quantile` at 0.5).  On an
    all-true mask it equals :func:`scalar_median` bit for bit."""
    return masked_quantile(x, mask, 0.5)


def _row(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for a 0-d index tensor, without a host sync."""
    return torch.index_select(x, 0, idx.reshape(1))[0]


def filter_update(A, gram_B, gram_g, alive, k: int, cfg: GuardConfig, report=None):
    """One application of the Algorithm-1 filter; returns (good_k, diag).
    diag holds ``n_alive`` = |good_k| and the flight recorder's forensics,
    all of them values the filter computes anyway: ``a_med``, the two
    medians' indices and found flags, the per-worker ``dev_a``,
    ``dist_b``, ``dist_g`` and the three thresholds (host f32 scalars, or
    0-d tensors for a tensor V).  Medians are over all m workers, or over the
    reporters when ``report`` is given; only the intersection uses
    good_{k-1}, and a worker that did not report keeps its status.
    ``cfg.V`` may be a Python float or a 0-d f32 tensor (module docstring)."""
    t_a, t_b = cfg.thresholds(k)

    # line 7: scalar median of A (over reporters)
    a_med = scalar_median(A) if report is None else masked_median(A, report)
    dev_a = torch.abs(A - a_med)
    ok_a = dev_a <= _bound(t_a)

    # line 8: counting median of B at radius 𝔗_B
    d2_b = pairwise_sq_dists_from_gram(gram_B)
    idx_b, found_b = counting_median_index(d2_b, t_b, report)
    dist_b = torch.sqrt(_row(d2_b, idx_b))
    ok_b = dist_b <= _bound(t_b)

    # line 9: counting median of fresh gradients at radius 2V, filter at 4V
    # (a tensor V multiplies in f32, a Python one in double)
    d2_g = pairwise_sq_dists_from_gram(gram_g)
    idx_g, found_g = counting_median_index(d2_g, cfg.median_radius_mult * cfg.V, report)
    dist_g = torch.sqrt(_row(d2_g, idx_g))
    t_g = cfg.grad_radius_mult * cfg.V
    if not isinstance(t_g, torch.Tensor):
        t_g = np.float32(t_g)
    ok_g = dist_g <= _bound(t_g)

    # line 10: good_k = good_{k-1} ∩ {A ok} ∩ {B ok} ∩ {∇ ok}; workers that
    # did not report are not scored
    if report is None:
        good_k = alive & ok_a & ok_b & ok_g
    else:
        good_k = alive & (ok_a | ~report) & (ok_b | ~report) & (ok_g | ~report)
    diag = {"n_alive": torch.sum(good_k), "a_med": a_med, "b_med_index": idx_b,
            "b_med_found": found_b, "grad_med_index": idx_g, "grad_med_found": found_g,
            "threshold_A": t_a, "threshold_B": t_b, "threshold_grad": t_g,
            "dev_a": dev_a, "dist_b": dist_b, "dist_g": dist_g}
    return good_k, diag


class ByzantineGuard:
    """Single-host form of ByzantineSGD's filter and aggregation.

    ``use_fused=False`` is the dense oracle; ``use_fused=True`` runs the
    one-pass kernel and the filtered-mean kernel through
    :mod:`repro_torch.kernels.ops` (on a CUDA device: the hand-written
    kernels; on the CPU: their plain versions).  ``stats_dtype`` is the
    storage dtype of the streamed statistics: gradients are rounded to it
    once on entry and B is stored in it.  ``sanitize`` arms the quarantine
    stage (module docstring); its step adds ``n_nonfinite`` to the diag.
    ``probe`` (the flight recorder is armed) adds ``gram_drift``: 0 on the
    dense path; on the fused and generating paths ‖B Bᵀ − the incremental
    Gram‖_F at resync steps and NaN between them.  The JAX package leaves
    that norm to XLA to drop when nothing reads it; here it is computed
    only when ``probe`` is set.  Each phase runs inside
    :func:`repro_torch.obs.spans.guard_scope`.
    """

    def __init__(self, cfg: GuardConfig, use_fused: bool = False,
                 gram_resync_every: int = 64, stats_dtype: str = "f32",
                 device="cuda", sanitize: bool = False, gen_spec=None, probe: bool = False):
        self.cfg = cfg
        self.probe = bool(probe)
        self.gen_spec = gen_spec
        self.sanitize = bool(sanitize)
        self.use_fused = use_fused
        self.gram_resync_every = gram_resync_every
        self.stats_dtype = resolve_stats_dtype(stats_dtype)
        self.device = resolve_device(device)

    def init(self, d: int) -> GuardState:
        m = self.cfg.m
        dev = self.device
        return GuardState(
            A=torch.zeros((m,), dtype=torch.float32, device=dev),
            B=torch.zeros((m, d), dtype=self.stats_dtype, device=dev),
            alive=torch.ones((m,), dtype=torch.bool, device=dev),
            k=0,
            gram_B=torch.zeros((m, m), dtype=torch.float32, device=dev),
        )

    def step(self, state: GuardState, grads: torch.Tensor, x_k: torch.Tensor,
             x_1: torch.Tensor, report=None):
        """One guard step: returns ``(state', ξ, diag)``."""
        cfg = self.cfg
        # the single entry rounding of the stats axis (a no-op at f32); a
        # finite f32 entry beyond bf16's range becomes Inf here and is then
        # quarantined under bf16, as in the JAX package
        grads = grads.to(self.stats_dtype)
        if report is not None:
            # a zero row adds nothing to A, freezes B_i and keeps the
            # incremental-Gram identity exact
            grads = torch.where(report[:, None], grads, 0.0)
        k = state.k + 1
        delta = (x_k - x_1).to(self.stats_dtype)

        finite = None
        if self.sanitize and not self.use_fused:
            fin = torch.isfinite(grads)
            finite = torch.all(fin, dim=1)
            grads = torch.where(fin, grads, 0.0)

        if self.use_fused:
            with guard_scope("stats_sweep"):
                if self.sanitize:
                    gram_g, cross, a_inc, B, nf = ops.fused_guard(grads, state.B, delta,
                                                                  sanitize=True)
                    finite = nf == 0
                else:
                    gram_g, cross, a_inc, B = ops.fused_guard(grads, state.B, delta)
                A = state.A + a_inc
                gram_b = state.gram_B + cross + cross.T + gram_g
            # re-anchor the rank-updated Gram to the B in storage
            gram_b, drift = self._resync(k, B, gram_b)
        else:
            with guard_scope("stats_sweep"):
                g32 = grads.to(torch.float32)
                A = state.A + g32 @ delta.to(torch.float32)
                B = (state.B.to(torch.float32) + g32).to(self.stats_dtype)
                gram_b = _gram32(B)
                gram_g = g32 @ g32.T
            drift = 0.0  # re-derived every step: the drift oracle

        # a non-finite row is not scored (its zeroed statistics are not the
        # worker's report) and does not survive: it enters the filter as a
        # non-reporter, and the & below takes away the status a
        # non-reporter would keep
        report_eff = report
        if self.sanitize:
            report_eff = finite if report is None else report & finite
        with guard_scope("filter"):
            good_k, diag = filter_update(A, gram_b, gram_g, state.alive, k, cfg, report_eff)
            if self.sanitize:
                good_k = good_k & finite
                diag["n_alive"] = torch.sum(good_k)
                diag["n_nonfinite"] = torch.sum(~finite)
        if self.probe:
            diag["gram_drift"] = drift

        # ξ averages the rows that arrived: good ∩ reporting
        contrib = good_k if report is None else good_k & report
        if cfg.mean_over_alive:
            denom = torch.clamp(torch.sum(contrib), min=1).to(torch.float32)
        else:
            denom = float(cfg.m)
        with guard_scope("aggregate"):
            if self.use_fused:
                xi = ops.filtered_mean(grads, contrib.to(torch.float32) / denom, 1.0,
                                       sanitize=self.sanitize)
            else:
                xi = (contrib.to(torch.float32) @ grads.to(torch.float32)) / denom

        return GuardState(A=A, B=B, alive=good_k, k=k, gram_B=gram_b), xi, diag

    def _resync(self, k: int, B: torch.Tensor, gram_b: torch.Tensor):
        """Every ``gram_resync_every`` steps the incremental Gram is
        re-derived from the B in storage; returns ``(gram_B, drift)``, the
        drift (armed recorder only) ‖derived − incremental‖_F at a resync
        step, NaN between them."""
        if self.gram_resync_every > 0 and k % self.gram_resync_every == 0:
            with guard_scope("resync"):
                derived = _gram32(B)
                drift = torch.linalg.matrix_norm(derived - gram_b) if self.probe else None
            return derived, drift
        return gram_b, math.nan

    def gen_step(self, state: GuardState, genctx, x_k: torch.Tensor, x_1: torch.Tensor):
        """:meth:`step` of the fused form with the gradients generated in
        the kernels from ``self.gen_spec`` and ``genctx``
        (:class:`~repro_torch.kernels.gradgen.GenStepCtx`): returns
        ``(state', ξ, byz_sum, diag)``, ``byz_sum = Σᵢ w_byz[i]·rowᵢ`` over
        the raw f32 rows.  The rows round through the stats dtype before
        every statistic and ξ, as the materialising path stores its batch;
        the incremental Gram re-anchors every ``gram_resync_every`` steps."""
        if self.gen_spec is None:
            raise ValueError("gen_step needs a GenSpec (pass gen_spec=...)")
        cfg = self.cfg
        gen = self.gen_spec
        k = state.k + 1
        delta = (x_k - x_1).to(self.stats_dtype)
        operands = (x_k, gen.h, gen.x_star, gen.het_dir, genctx.worker_keys,
                    genctx.skewsign, genctx.slot, genctx.params)
        # ALIE's honest column moments, taken once: the sweep returns them
        # and the ξ pass reads them (functional, so a campaign's vmap
        # batches them)
        with guard_scope("stats_sweep"):
            gram_g, cross, a_inc, B, moments = ops.fused_guard_gen(state.B, delta, *operands,
                                                                   return_moments=True)
            A = state.A + a_inc
            gram_b = state.gram_B + cross + cross.T + gram_g
        gram_b, drift = self._resync(k, B, gram_b)

        with guard_scope("filter"):
            good_k, diag = filter_update(A, gram_b, gram_g, state.alive, k, cfg)
        if self.probe:
            diag["gram_drift"] = drift
        if cfg.mean_over_alive:
            denom = torch.clamp(torch.sum(good_k), min=1).to(torch.float32)
        else:
            denom = float(cfg.m)
        with guard_scope("aggregate"):
            xi, byz_sum = ops.gen_xi(good_k.to(torch.float32) / denom, genctx.w_byz,
                                     *operands, stats_dtype=self.stats_dtype, moments=moments)
        return GuardState(A=A, B=B, alive=good_k, k=k, gram_B=gram_b), xi, byz_sum, diag


def _gram32(x: torch.Tensor) -> torch.Tensor:
    """X Xᵀ with f32 accumulation from X's storage dtype (exact upcast); a
    plain product, as the JAX package leaves it to XLA.  Full f32 on a GPU
    needs ``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's
    default."""
    x32 = x.to(torch.float32)
    return x32 @ x32.T
