"""Analytic HBM-traffic / FLOP model for the guard step (DESIGN.md §5),
the counterpart of :mod:`repro.roofline.guard_cost`.

The guard is memory-bound on every realistic shape (arithmetic intensity
≈ m/2 flops per byte with m ≤ a few hundred, far under the H100's ridge
point), so the quantity that predicts wall-clock is bytes moved per step.
The byte and FLOP counts are the JAX package's (they do not depend on
the hardware); only O(m·d) terms are counted (the (m, m) Grams, (m,)
vectors, and (d,) iterate reads are noise at d ≫ m).

Every model below is parameterized on ``e = element bytes`` of the
streamed statistics — the ``stats_dtype`` axis (4 for f32, 2 for bf16,
:data:`STATS_DTYPE_BYTES`): the guard is bandwidth-bound, so halving
``e`` halves the modeled wall-clock of every O(m·d) pass.  The (m, m)
Grams and (m,) vectors stay f32 accumulators at either precision and are
O(m²)/O(m) — noise at d ≫ m, excluded as before.

Dense reference (:class:`repro_torch.core.byzantine_sgd.ByzantineGuard`,
``use_fused=False``), e = element bytes (4 for f32):

    A += g·Δ          read g                      1·m·d·e
    B += g            read B, read g, write B     3·m·d·e
    G_B = B Bᵀ        read B                      1·m·d·e
    G_g = g gᵀ        read g                      1·m·d·e
    ─────────────────────────── statistics total  6·m·d·e
    ξ  = mask·g/denom read g                      1·m·d·e
    ─────────────────────────── step total        7·m·d·e

Fused pipeline (``use_fused=True``): one sweep of
:mod:`repro_torch.kernels.fused_guard` reads each g and B strip once and writes
the new B strip (G_B is updated incrementally from the sweep's outputs —
nothing re-reads B):

    fused sweep       read g, read B, write B     3·m·d·e
    ─────────────────────────── statistics total  3·m·d·e   (2.0× less)
    ξ (filtered-mean kernel)                      1·m·d·e
    ─────────────────────────── step total        4·m·d·e   (1.75× less)

ξ cannot join the sweep: good_k depends on the Grams the sweep produces.

The distributed guard modes (DESIGN.md §3, swept as guard *backends* on the
flat harness — DESIGN.md §9) follow the same pass-count accounting:

    dp_exact (incremental Gram): A (read g) + B += g (read B, read g,
    write B) + g gᵀ (read g) + cross B gᵀ (read B, read g)   7·m·d·e
    dp_sketch: A (read g) + mean-center (read g ×2) + fused
    sketch/norms fold (read g); all B-side work is O(m·k ≪ m·d)   4·m·d·e

``BACKEND_COSTS`` maps every registered guard-backend name to its model,
and :func:`steady_state_us` converts bytes to the bandwidth-bound
steady-state wall-clock on the card (:data:`repro_torch.roofline.hw.H100`
by default).
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.roofline.hw import H100, HwSpec


class GuardStepCost(NamedTuple):
    """Per-step cost of one guard variant (bytes/flops, leading order)."""

    stats_bytes: int    # martingale + Gram production (what the kernel fuses)
    xi_bytes: int       # the filtered-mean aggregation pass
    flops: int          # dominated by the two (m, m, d) contractions

    @property
    def step_bytes(self) -> int:
        return self.stats_bytes + self.xi_bytes


def dense_guard_cost(m: int, d: int, elem_bytes: int = 4) -> GuardStepCost:
    """Three-pass dense reference: 6 m·d reads/writes for the statistics."""
    mde = m * d * elem_bytes
    return GuardStepCost(
        stats_bytes=6 * mde,
        xi_bytes=1 * mde,
        flops=2 * m * m * d * 2 + 2 * m * d,   # B Bᵀ + g gᵀ, A + ξ dots
    )


def fused_guard_cost(m: int, d: int, elem_bytes: int = 4) -> GuardStepCost:
    """One-pass fused pipeline: 3 m·d for the statistics sweep."""
    mde = m * d * elem_bytes
    return GuardStepCost(
        stats_bytes=3 * mde,
        xi_bytes=1 * mde,
        flops=2 * m * m * d * 2 + 2 * m * d,   # same math, fewer bytes
    )


def dp_exact_guard_cost(m: int, d: int, elem_bytes: int = 4) -> GuardStepCost:
    """Distributed exact guard with incremental Gram: the B Bᵀ re-contraction
    is gone, but the cross term B gᵀ re-reads both operands — 7 m·d passes.
    (Its win is *collective* volume, not local HBM traffic: B shards never
    travel; see byzantine_dp.)"""
    mde = m * d * elem_bytes
    return GuardStepCost(
        stats_bytes=7 * mde,
        xi_bytes=1 * mde,
        flops=2 * m * m * d * 2 + 2 * m * d,
    )


# FLOPs to regenerate one gradient element in-kernel: 20 threefry rounds
# (XOR + rotate + add ≈ 3 flops on 2 lanes) plus key-schedule injections,
# uniform conversion, and the attack-row selects — ~128 flop/elem, the JAX
# package's model constant.  Deliberately coarse: generation is *compute*
# traffic that replaces the g-strip's HBM reads.  On the H100 the
# generating kernels are bound by these integer operations, not by bytes
# (PERF.md §6), so :func:`steady_state_us`'s bytes term under-predicts
# the generating step.
GEN_FLOPS_PER_ELEM = 128


def gen_guard_cost(m: int, d: int, elem_bytes: int = 4) -> GuardStepCost:
    """Fused pipeline with in-kernel generation (DESIGN.md §14): the g strip
    is regenerated from the counter-based PRNG inside both the statistics
    sweep and the ξ pass, so *no* pass reads or writes gradients — the only
    O(m·d) HBM traffic left is the B-strip read + write in the sweep:

        fused-gen sweep   read B, write B              2·m·d·e
        ─────────────────────────── statistics total   2·m·d·e  (3.0× less)
        ξ (regenerates its own rows; O(d) out)         ~0
        ─────────────────────────── step total         2·m·d·e  (3.5× less)

    The generation itself costs FLOPs, not bytes — counted once per pass
    (sweep + ξ) at :data:`GEN_FLOPS_PER_ELEM` each."""
    mde = m * d * elem_bytes
    return GuardStepCost(
        stats_bytes=2 * mde,
        xi_bytes=0,
        flops=2 * m * m * d * 2 + 2 * m * d
        + 2 * GEN_FLOPS_PER_ELEM * m * d,  # regenerate rows in sweep + ξ
    )


def dp_sketch_guard_cost(m: int, d: int, elem_bytes: int = 4) -> GuardStepCost:
    """CountSketch guard: the only O(m·d) passes are the A dot, the two-pass
    mean-centering, and the fused sketch/norm fold; every Gram contraction
    runs in sketch space (O(m·k), dropped here as k ≪ d)."""
    mde = m * d * elem_bytes
    return GuardStepCost(
        stats_bytes=4 * mde,
        xi_bytes=1 * mde,
        flops=2 * m * d * 3,   # dots + fold; Grams are O(m²k) — negligible
    )


# guard-backend name (repro_torch.core.guard_backends) → per-step cost model.
# "gen" is the campaign's pseudo-backend spelling for fused + generate
# = 'kernel' (repro_torch.scenarios.campaign.expand_variants) — a cost
# point on this axis even though it is not a guard backend.
BACKEND_COSTS = {
    "dense": dense_guard_cost,
    "fused": fused_guard_cost,
    "gen": gen_guard_cost,
    "dp_exact": dp_exact_guard_cost,
    "dp_sketch": dp_sketch_guard_cost,
}

# SolverConfig.stats_dtype → bytes per streamed statistics element; the
# names mirror repro_torch.core.byzantine_sgd.STATS_DTYPES.
STATS_DTYPE_BYTES = {"f32": 4, "bf16": 2}


def stats_elem_bytes(stats_dtype: str) -> int:
    """``'f32' | 'bf16'`` → element bytes; typos fail loudly."""
    try:
        return STATS_DTYPE_BYTES[stats_dtype]
    except KeyError:
        raise KeyError(
            f"unknown stats_dtype {stats_dtype!r}; "
            f"have {sorted(STATS_DTYPE_BYTES)}"
        ) from None


def backend_cost(backend: str, m: int, d: int,
                 stats_dtype: str = "f32") -> GuardStepCost:
    """Per-step cost of ``(guard backend, stats dtype)`` — the two axes the
    campaigns sweep (``"fused@bf16"`` spellings are split by
    ``repro_torch.core.guard_backends.parse_backend_spec`` before reaching
    here)."""
    return BACKEND_COSTS[backend](m, d, elem_bytes=stats_elem_bytes(stats_dtype))


def steady_state_us(cost: GuardStepCost, hw: HwSpec = H100) -> float:
    """Bandwidth-bound steady-state wall-clock of one guard step (µs) on
    ``hw``: the guard's arithmetic intensity sits far under the ridge point
    on every realistic shape, so bytes / HBM bandwidth is the model."""
    return cost.step_bytes / hw.hbm_bw * 1e6
