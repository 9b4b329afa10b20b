"""Measured-vs-roofline comparator (DESIGN.md §12), the counterpart of
:mod:`repro.obs.roofline_compare`.

``roofline/guard_cost.py`` predicts every guard backend's steady-state
per-step wall-clock from bytes moved on the H100; the flight recorder
measures the realized per-step time (campaign wall-clock / steps, or
``guard/*`` span durations from an event log).  This module joins the two.

The ratio column is diagnostic, not pass/fail: on the CPU the port runs
the plain versions and ratios mean nothing (the ``backend`` field in the
surrounding meta says so); on the card a ratio far above 1 means the step
leaves bandwidth unused (or, for ``gen``, is bound by the generator's
integer operations, which the bytes model does not count), far below 1
that the model miscounts passes.
"""
from __future__ import annotations


def roofline_rows(measured_step_us: dict[str, float], m: int, d: int, hw=None) -> list[dict]:
    """Join measured per-step µs (keyed by backend spec, ``@dtype``
    suffixes honored) against the guard_cost prediction at (m, d) on
    ``hw`` (the H100 by default)."""
    # deferred: guard_backends itself imports repro_torch.obs (the
    # telemetry probe), so a module-level import here would be circular
    from repro_torch.core.guard_backends import parse_backend_spec
    from repro_torch.roofline.guard_cost import backend_cost, steady_state_us

    rows = []
    for spec, meas in sorted(measured_step_us.items()):
        name, sdt = parse_backend_spec(spec)
        cost = backend_cost(name, m, d, sdt or "f32")
        model = steady_state_us(cost) if hw is None else steady_state_us(cost, hw)
        rows.append({
            "backend": spec,
            "m": m,
            "d": d,
            "stats_dtype": sdt or "f32",
            "measured_step_us": float(meas),
            "modeled_step_us": model,
            "model_step_bytes": cost.step_bytes,
            "measured_over_model": float(meas) / max(model, 1e-12),
        })
    return rows


def spans_by_name(events: list[dict]) -> dict[str, dict]:
    """Aggregate ``span`` events → name → {count, total_s, mean_s} —
    the measured side when the input is an event log rather than a
    benchmark's own timing dict."""
    acc: dict[str, dict] = {}
    for ev in events:
        if ev.get("type") != "span":
            continue
        rec = acc.setdefault(ev["name"], {"count": 0, "total_s": 0.0})
        rec["count"] += 1
        rec["total_s"] += float(ev.get("dur_s", 0.0))
    for rec in acc.values():
        rec["mean_s"] = rec["total_s"] / max(rec["count"], 1)
    return acc
