"""Guard flight recorder — the counterpart of :mod:`repro.obs.telemetry`
(DESIGN.md §12).

Algorithm 1's value is *which* workers it filters and *when*: the
martingale deviations |A_i − A_med|, ‖B_i − B_med‖, ‖∇_i − ∇_med‖ crossing
their thresholds 𝔗_A, 𝔗_B, 4V.  This module records them step by step
without a host synchronisation:

* **frame** — one step's filter forensics as a dict with the fixed key set
  :data:`FRAME_SCHEMA` (per-worker deviations, the alive mask, the
  thresholds, ‖ξ‖, the Gram-resync drift, the auto-V estimate, the
  adaptive adversary's feedback scale).  Every guard backend and every
  baseline emits the same schema; a key its producer cannot know holds
  NaN.  A value is a device tensor or a host number (a Python float, a
  numpy scalar): the port's step count and its f32 thresholds are host
  numbers, and the recorder moves them to the device without waiting.
* **ring** — :class:`TelemetryRing`, a (ring_size, width) f32 device
  tensor of packed frames.  A push writes one lane at slot ``head %
  ring_size``, where ``head`` is the host's count of pushes: one
  ``torch.cat`` builds the lane and one ``slice_scatter`` writes it (out
  of place, so a ring mapped over a campaign's runs by ``torch.func.vmap``
  batches like any other tensor).  :func:`ring_read` copies the lanes to
  the host once, at the end.

Everything is gated on :class:`TelemetryConfig` on the host: with
``telemetry=None`` or ``enabled=False`` no frame is built and no ring is
carried, and a step dispatches the operations it dispatches without the
recorder.  The lane layout (worker blocks in :data:`PER_WORKER_KEYS`
order, then the scalars in :data:`SCALAR_KEYS` order) is the JAX
package's, so a ring of either decodes with either ``ring_read``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class TelemetryConfig(NamedTuple):
    """The recorder's switch and ring size: the ring keeps the last
    ``ring_size`` frames, O(ring · m) floats on the device."""

    enabled: bool = True
    ring_size: int = 128


def telemetry_on(telemetry: TelemetryConfig | None) -> bool:
    """The one gate every producer checks; anything but None or a
    :class:`TelemetryConfig` raises TypeError."""
    if telemetry is None:
        return False
    if not isinstance(telemetry, TelemetryConfig):
        raise TypeError(f"telemetry must be None or a TelemetryConfig, got {telemetry!r}")
    if telemetry.enabled and telemetry.ring_size < 1:
        raise ValueError(f"telemetry ring_size must be >= 1, got {telemetry.ring_size}")
    return bool(telemetry.enabled)


# The event schema: per-worker series and per-step scalars, in the JAX
# package's order (the packed lane layout is API).
PER_WORKER_KEYS = (
    "dev_a",    # |A_i − A_med| (against thr_a)
    "dist_b",   # ‖B_i − B_med‖ (against thr_b)
    "dist_g",   # ‖∇_i − ∇_med‖ (against thr_g)
    "alive",    # good_k membership (1.0 / 0.0)
)
SCALAR_KEYS = (
    "step",        # 1-based iteration the frame describes
    "thr_a",       # 𝔗_A = 4DV√(kC)
    "thr_b",       # 𝔗_B = 4V√(kC)
    "thr_g",       # the 4V fresh-gradient radius
    "n_alive",     # |good_k|
    "xi_norm",     # ‖ξ_k‖
    "v_est",       # online auto-V (dp backends; NaN elsewhere)
    "gram_drift",  # ‖G_inc − B Bᵀ‖_F at resync steps (fused; NaN between, 0 dense)
    "adapt_scale", # the adaptive adversary's feedback scale (NaN for static attacks)
    "n_reporting", # reporters this step under partial participation
    "staleness",   # mean gradient age in steps under the delay schedule
    "n_nonfinite", # rows that held NaN/Inf this step under sanitize
)
FRAME_SCHEMA = PER_WORKER_KEYS + SCALAR_KEYS


def empty_frame(m: int) -> dict:
    """A full-schema frame of NaN sentinels (host numbers until a producer
    fills a key)."""
    return {k: math.nan for k in FRAME_SCHEMA}


def baseline_frame(m: int, alive: torch.Tensor, n_alive) -> dict:
    """What a baseline can report: who survived."""
    frame = empty_frame(m)
    frame["alive"] = alive.to(torch.float32)
    frame["n_alive"] = n_alive
    return frame


def guard_frame(m: int, diag: dict, alive: torch.Tensor) -> dict:
    """A guard backend's frame from its ``filter_update`` diagnostics; the
    optional ``v_est``, ``gram_drift`` and ``n_nonfinite`` are filled when
    the producing backend computes them."""
    frame = baseline_frame(m, alive, diag["n_alive"])
    frame["dev_a"] = diag["dev_a"]
    frame["dist_b"] = diag["dist_b"]
    frame["dist_g"] = diag["dist_g"]
    frame["thr_a"] = diag["threshold_A"]
    frame["thr_b"] = diag["threshold_B"]
    frame["thr_g"] = diag["threshold_grad"]
    for opt in ("v_est", "gram_drift", "n_nonfinite"):
        if opt in diag:
            frame[opt] = diag[opt]
    return frame


# ---------------------------------------------------------------- the ring

class TelemetryRing(NamedTuple):
    """The packed frames: ``lanes`` (ring_size, |PER_WORKER_KEYS|·m +
    |SCALAR_KEYS|) f32 on the device, ``head`` the total count of pushes
    (a host int in a run; a (N,) int32 tensor in a campaign's stacked
    block).  Slot ``head % ring_size`` is the oldest once the ring has
    wrapped."""

    lanes: torch.Tensor
    head: int | torch.Tensor

    @property
    def m(self) -> int:
        return (self.lanes.shape[-1] - len(SCALAR_KEYS)) // len(PER_WORKER_KEYS)


def ring_init(m: int, ring_size: int, device="cpu") -> TelemetryRing:
    width = len(PER_WORKER_KEYS) * m + len(SCALAR_KEYS)
    return TelemetryRing(
        lanes=torch.full((ring_size, width), math.nan, dtype=torch.float32, device=device),
        head=0)


def _lane(frame: dict, m: int, device) -> torch.Tensor:
    """The frame packed into one (width,) f32 lane: device values as they
    are, host values gathered into one vector that goes to the device in
    one copy that does not wait for the device."""
    keys = [(k, m) for k in PER_WORKER_KEYS] + [(k, 1) for k in SCALAR_KEYS]
    host = [np.broadcast_to(np.float32(frame[k]), (n,)) for k, n in keys
            if not isinstance(frame[k], torch.Tensor)]
    hv = None
    if host:
        hv = torch.from_numpy(np.concatenate(host)).to(device, non_blocking=True)
    parts, at = [], 0
    for k, n in keys:
        v = frame[k]
        if isinstance(v, torch.Tensor):
            parts.append(v.to(torch.float32).reshape(n))
        else:
            parts.append(hv[at:at + n])
            at += n
    return torch.cat(parts)


def ring_push(ring: TelemetryRing, frame: dict) -> TelemetryRing:
    """Write ``frame`` at slot ``head % ring_size``: one packed lane, one
    ``slice_scatter``."""
    slot = ring.head % ring.lanes.shape[0]
    lane = _lane(frame, ring.m, ring.lanes.device)
    lanes = torch.slice_scatter(ring.lanes, lane[None], dim=0, start=slot, end=slot + 1)
    return TelemetryRing(lanes=lanes, head=ring.head + 1)


def ring_read(ring: TelemetryRing) -> list[dict]:
    """The valid frames in push order (oldest first) as full-schema dicts
    of numpy values, from one copy of the lanes to the host.  One run's
    ring only (index a campaign's run axis out first)."""
    lanes = ring.lanes
    lanes = lanes.detach().cpu().numpy() if isinstance(lanes, torch.Tensor) else np.asarray(lanes)
    size = lanes.shape[0]
    m = (lanes.shape[-1] - len(SCALAR_KEYS)) // len(PER_WORKER_KEYS)
    head = int(ring.head)
    n = min(head, size)
    start = head - n
    out = []
    for i in range(n):
        lane = lanes[(start + i) % size]
        frame = {k: lane[kk * m:(kk + 1) * m] for kk, k in enumerate(PER_WORKER_KEYS)}
        base = len(PER_WORKER_KEYS) * m
        frame.update({k: lane[base + kk] for kk, k in enumerate(SCALAR_KEYS)})
        out.append(frame)
    return out


class Telemetry(NamedTuple):
    """What an armed ``run_sgd`` returns beside its result: the ring (the
    last ``ring_size`` frames) and two full-horizon series."""

    ring: TelemetryRing
    first_filter_step: torch.Tensor   # (m,) int32: first k a worker left good_k; -1 never
    byz_alive: torch.Tensor           # (T,) int32: |{Byzantine ∩ good_k}| a step
