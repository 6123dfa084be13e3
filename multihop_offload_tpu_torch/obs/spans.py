"""Nested host spans with trace ids, bridged into device profiles.

Port of `multihop_offload_tpu/obs/spans.py`.  A span measures a named
stretch of host wall-clock, nests (thread-local stack) and carries a trace
id shared by the whole nest.  Every span is a
`torch.profiler.record_function` range, so a profiler trace shows it beside
the kernels it launched.  CUDA work is asynchronous: `block=True` waits for
the card (`torch.cuda.synchronize()`, when the process has used it) before
the span closes, so the window covers execution, not only the enqueue.

Durations aggregate into the shared registry histogram
`mho_phase_seconds{phase=...}`; `phase_stats` / `reset_phases` read and
clear it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Iterator, Optional

import torch

from multihop_offload_tpu_torch.obs.registry import registry as _registry

_ids = itertools.count(1)
_tls = threading.local()

PHASE_METRIC = "mho_phase_seconds"


def _stack():
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def current_trace_id() -> Optional[str]:
    s = _stack()
    return s[-1]["trace_id"] if s else None


@contextlib.contextmanager
def span(name: str, block: bool = False, emit: bool = False,
         **attrs) -> Iterator[dict]:
    """Measure `name` as a nested span.

    `block=True` waits for the card's queued work before closing.
    `emit=True` also writes a `span` event row to the active run log (off
    by default: per-tick spans aggregate in the registry).  Yields the span
    record (id, parent, trace id)."""
    stack = _stack()
    sid = next(_ids)
    rec = {
        "name": name,
        "span_id": f"{sid:x}",
        "parent_id": stack[-1]["span_id"] if stack else None,
        "trace_id": stack[-1]["trace_id"] if stack else f"{sid:08x}",
    }
    stack.append(rec)
    t0 = time.perf_counter()  # nondet-ok(span duration is wall time by definition)
    try:
        with torch.profiler.record_function(name):
            yield rec
    finally:
        if block and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0  # nondet-ok(span duration is wall time by definition)
        stack.pop()
        _registry().histogram(
            PHASE_METRIC, "host span / phase wall seconds"
        ).observe(dt, phase=name)
        if emit:
            from multihop_offload_tpu_torch.obs import events as _events

            log = _events.get_run_log()
            if log is not None:
                log.emit("span", duration_s=round(dt, 6), **rec, **attrs)


def phase_stats() -> dict:
    """Per-phase aggregates {name: {count, total_s, mean_s, min_s, max_s}}
    from the shared registry."""
    snap = _registry().snapshot().get(PHASE_METRIC)
    if not snap:
        return {}
    out = {}
    for labels, s in snap["series"].items():
        # labels renders as '{phase="<name>"}'
        name = labels.split('"')[1] if '"' in labels else labels
        out[name] = {
            "count": s["count"], "total_s": s["sum"],
            "mean_s": s["sum"] / max(s["count"], 1),
            "min_s": s["min"], "max_s": s["max"],
        }
    return out


def reset_phases() -> None:
    """Drop accumulated phase aggregates (only the phase histogram)."""
    reg = _registry()
    with reg._lock:
        reg._metrics.pop(PHASE_METRIC, None)
