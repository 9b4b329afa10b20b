"""Profiler spans — phase attribution on the card (the counterpart of
:mod:`repro.obs.spans`).

Two instruments with one naming convention (``<layer>/<phase>``, e.g.
``guard/stats_sweep``):

* :func:`guard_scope` — wraps a phase of the guard step: a
  ``torch.profiler.record_function`` range, so a ``torch.profiler`` trace
  attributes the phase's kernels to it, and an NVTX range of the same
  name for tools that read NVTX.  Each is entered only when something can
  see it (a profiler session is active; the process has a CUDA device),
  so an unobserved step dispatches no extra operation and the numbers
  never change.
* :func:`trace_span` — a host span: a perf-counter measurement appended
  to an :class:`~repro_torch.obs.events.EventLog` as a ``span`` event (and
  the same two ranges).  Kernels run asynchronously, so a caller that
  times device work synchronises inside the span
  (``torch.cuda.synchronize()``) before it ends.
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch

# the guard step's phases, as the JAX package names them
GUARD_PHASES = ("stats_sweep", "filter", "aggregate", "resync")


@functools.cache
def _nvtx_on() -> bool:
    return torch.cuda.is_available()


@contextlib.contextmanager
def _ranges(name: str):
    with contextlib.ExitStack() as stack:
        if torch.autograd.profiler._is_profiler_enabled:
            stack.enter_context(torch.profiler.record_function(name))
        if _nvtx_on():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


def guard_scope(phase: str):
    """The ``guard/<phase>`` ranges around one phase of a guard step."""
    return _ranges(f"guard/{phase}")


@contextlib.contextmanager
def trace_span(name: str, log=None, **args):
    """Measure a host phase, mark it on any active profiler and NVTX, and
    (when ``log`` is given) append a ``span`` event with its start and
    seconds."""
    t0 = time.perf_counter()
    try:
        with _ranges(name):
            yield
    finally:
        dur = time.perf_counter() - t0
        if log is not None:
            log.event("span", name=name, t0=t0, dur_s=dur, **args)
