"""Observability, the counterpart of :mod:`repro.obs` (DESIGN.md §12).

In the step: :class:`TelemetryConfig` arms the guard flight recorder (per-
worker martingale deviations against their thresholds, the alive mask,
‖ξ‖, the resync drift, the adversary's feedback) written into a ring of
packed frames on the device; off, a step runs as without it.

On the host: :class:`EventLog` (JSONL and a Chrome trace), the
:func:`guard_scope` / :func:`trace_span` ranges (``torch.profiler`` and
NVTX), provenance, and the measured-against-roofline comparator.
"""
from repro_torch.obs.events import EventLog, write_chrome_trace
from repro_torch.obs.provenance import provenance_meta
from repro_torch.obs.roofline_compare import roofline_rows, spans_by_name
from repro_torch.obs.spans import guard_scope, trace_span
from repro_torch.obs.telemetry import (
    FRAME_SCHEMA,
    PER_WORKER_KEYS,
    SCALAR_KEYS,
    Telemetry,
    TelemetryConfig,
    TelemetryRing,
    baseline_frame,
    empty_frame,
    guard_frame,
    ring_init,
    ring_push,
    ring_read,
    telemetry_on,
)

__all__ = [
    "EventLog",
    "FRAME_SCHEMA",
    "PER_WORKER_KEYS",
    "SCALAR_KEYS",
    "Telemetry",
    "TelemetryConfig",
    "TelemetryRing",
    "baseline_frame",
    "empty_frame",
    "guard_frame",
    "guard_scope",
    "provenance_meta",
    "ring_init",
    "ring_push",
    "ring_read",
    "roofline_rows",
    "spans_by_name",
    "telemetry_on",
    "trace_span",
    "write_chrome_trace",
]
