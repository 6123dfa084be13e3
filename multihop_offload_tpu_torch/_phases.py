"""Named phases of the port's paths, for profiling.

`phase(name)` (a context manager, or a decorator over a whole function)
marks a stretch of a path as a `torch.profiler.record_function` range, so a
profiler trace shows it.  Phases nest; a nested phase is named by the path
of the phases around it (`gnn/apsp`).

Inside `timing()` every phase also takes its host-clock duration, with the
card synchronized at its start and end so that the device work it queued
falls inside it: `timing()` yields {name: ms}, summed over repeats.  That
is for profiling only: outside `timing()` a phase synchronizes nothing and
costs one record_function range.
"""

from __future__ import annotations

import contextlib
import time

import torch

_stack: list = []          # names of the open phases, outermost first
_times: dict | None = None  # name -> ms while `timing()` is open


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def phase(name: str):
    full = "/".join(_stack + [name])
    _stack.append(name)
    try:
        with torch.profiler.record_function(full):
            if _times is None:
                yield
                return
            _sync()
            t0 = time.perf_counter()  # nondet-ok(phase timing is a measurement)
            yield
            _sync()
            dt = time.perf_counter() - t0  # nondet-ok(same measurement)
            _times[full] = _times.get(full, 0.0) + dt * 1e3
    finally:
        _stack.pop()


@contextlib.contextmanager
def timing():
    """Collect the host milliseconds of every phase run inside."""
    global _times
    prev, _times = _times, {}
    try:
        yield _times
    finally:
        _times = prev
