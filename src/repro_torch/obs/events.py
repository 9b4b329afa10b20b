"""Structured event log — the host half of the flight recorder, the
counterpart of :mod:`repro.obs.events` (DESIGN.md §12).

One writer for every observability surface in the repo: telemetry frames
drained from the on-device ring (``type: "guard_step"``), campaign filter
timelines (``type: "timeline"``), host wall-clock spans (``type: "span"``,
see :mod:`repro_torch.obs.spans`), roofline comparator rows (``type:
"roofline"``).  The format is
line-delimited JSON: line 1 is the ``meta`` record (provenance +
caller-supplied fields such as the measured telemetry overhead), every
following line one event with a ``type`` discriminator — greppable,
appendable, diffable.

:meth:`EventLog.write_chrome_trace` re-projects the same events into the
Chrome trace-event format Perfetto / ``chrome://tracing`` load directly:
spans become complete (``ph: "X"``) slices on per-track threads, scalar
step series (``n_alive``, ``xi_norm``, ``adapt_scale``) become counter
(``ph: "C"``) tracks, so a campaign's filter history sits on a zoomable
timeline next to the host phases that produced it.
"""
from __future__ import annotations

import json
import math
from typing import Iterable

import numpy as np
import torch

from repro_torch.obs.provenance import provenance_meta

# chrome-trace counter tracks exported per guard_step event
_COUNTER_KEYS = ("n_alive", "xi_norm", "adapt_scale", "v_est")


def _jsonable(v):
    """numpy scalars and arrays and torch tensors → plain JSON values
    (floats rounded to 6 significant digits: telemetry is forensics, not
    reproduction)."""
    if isinstance(v, (str, bool, int, type(None))):
        return v
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, float):
        return None if math.isnan(v) else float(f"{v:.6g}")
    arr = np.asarray(v)
    if arr.ndim == 0:
        if arr.dtype.kind in "iub":
            return int(arr)
        return _jsonable(float(arr))
    return [_jsonable(x) for x in arr.tolist()]


class EventLog:
    """Append-only structured log with a provenance meta header."""

    def __init__(self, **meta):
        self.meta = provenance_meta()
        self.meta.update(meta)
        self.events: list[dict] = []

    def add_meta(self, **fields) -> None:
        """Merge fields into the meta header (e.g. the measured
        telemetry-enabled overhead fraction, recorded where the trace
        itself lives)."""
        self.meta.update({k: _jsonable(v) for k, v in fields.items()})

    def event(self, type_: str, **fields) -> dict:
        ev = {"type": type_}
        ev.update({k: _jsonable(v) for k, v in fields.items()})
        self.events.append(ev)
        return ev

    def guard_step(self, frame: dict, run: str, **fields) -> dict:
        """One drained telemetry frame (see ``repro_torch.obs.telemetry``
        FRAME_SCHEMA) as an event; ``run`` labels the producing cell —
        '<scenario>/a<alpha>/<variant>/s<seed>' for campaigns."""
        return self.event("guard_step", run=run, **frame, **fields)

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(json.dumps({"type": "meta", **self.meta}) + "\n")
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")

    # -- reading -----------------------------------------------------------

    @staticmethod
    def read_jsonl(path: str) -> tuple[dict, list[dict]]:
        """→ (meta, events); tolerates a missing meta line (first event
        wins the position) so hand-truncated traces still render."""
        meta: dict = {}
        events: list[dict] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if rec.get("type") == "meta":
                    meta = rec
                else:
                    events.append(rec)
        return meta, events

    # -- chrome trace / Perfetto export ------------------------------------

    def write_chrome_trace(self, path: str) -> None:
        write_chrome_trace(self.meta, self.events, path)


def write_chrome_trace(meta: dict, events: Iterable[dict], path: str) -> None:
    """Project (meta, events) onto the Chrome trace-event JSON format.

    * ``span`` events → complete slices (``ph: "X"``, µs timebase) on a
      thread per span ``track`` (default: the span name's first segment);
    * ``guard_step`` events → counter tracks (``ph: "C"``) per run for the
      scalar series in ``_COUNTER_KEYS``, placed at ``step`` µs on a
      synthetic timebase (steps, not wall-clock — the filter timeline is
      an iteration-domain object);
    * everything else → instant events carrying their payload as args.
    """
    pids = {"spans": 1, "steps": 2}
    tids: dict[str, int] = {}

    def tid(track: str) -> int:
        return tids.setdefault(track, len(tids) + 1)

    out: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": label}}
        for label, pid in pids.items()
    ]
    t0 = None
    for ev in events:
        kind = ev.get("type")
        if kind == "span":
            start = float(ev.get("t0", 0.0))
            t0 = start if t0 is None else min(t0, start)
    for ev in events:
        kind = ev.get("type")
        if kind == "span":
            track = ev.get("track") or str(ev.get("name", "span")).split("/")[0]
            out.append({
                "name": ev.get("name", "span"),
                "ph": "X",
                "pid": pids["spans"],
                "tid": tid(track),
                "ts": (float(ev.get("t0", 0.0)) - (t0 or 0.0)) * 1e6,
                "dur": float(ev.get("dur_s", 0.0)) * 1e6,
                "args": {k: v for k, v in ev.items()
                         if k not in ("type", "name", "t0", "dur_s")},
            })
        elif kind == "guard_step":
            run = ev.get("run", "run")
            step = ev.get("step")
            if step is None:
                continue
            for key in _COUNTER_KEYS:
                val = ev.get(key)
                if val is None:
                    continue
                out.append({
                    "name": f"{run}/{key}",
                    "ph": "C",
                    "pid": pids["steps"],
                    "tid": tid(run),
                    "ts": float(step),
                    "args": {key: float(val)},
                })
        else:
            out.append({
                "name": kind or "event",
                "ph": "i",
                "s": "g",
                "pid": pids["spans"],
                "tid": tid("events"),
                "ts": 0.0,
                "args": {k: v for k, v in ev.items() if k != "type"},
            })
    with open(path, "w") as f:
        json.dump({"traceEvents": out, "metadata": meta}, f)
