"""Device-memory watermark tracking: per-phase snapshots + high-water events.

Port of `multihop_offload_tpu/obs/memwatch.py`.  `MemWatch.snapshot(phase)`
reads each local CUDA device's caching-allocator stats
(`torch.cuda.memory_stats`) into JAX's stat names, as

    mho_device_mem_bytes{device=,stat=,phase=}

gauges: `bytes_in_use` from `allocated_bytes.all.current` and
`peak_bytes_in_use` from `allocated_bytes.all.peak`.  A stat torch does
not report under JAX's name (`largest_alloc_size`) stays absent rather
than invented, and the CPU reports nothing, as JAX's best-effort read on
a backend without allocator stats.  Across snapshots it keeps a
per-device high-water mark: a new peak emits a ``watermark`` run-log event
(device, bytes, phase), so the run log records when the footprint grew.
The per-program scratch is the prof layer's `mho_program_temp_bytes`.

`stats_fn` is injectable (tests).  Standard library and torch only.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import torch

from multihop_offload_tpu_torch.obs import events as obs_events
from multihop_offload_tpu_torch.obs.registry import (
    MetricRegistry,
    registry as _default_registry,
)

# the allocator stats worth a gauge each (when the backend reports them)
_STATS = ("bytes_in_use", "peak_bytes_in_use", "largest_alloc_size")
# JAX's stat names read from torch's allocator keys
_TORCH_KEYS = {"bytes_in_use": "allocated_bytes.all.current",
               "peak_bytes_in_use": "allocated_bytes.all.peak"}


def _device_stats() -> Dict[str, dict]:
    """{"cuda:<i>": stats} over the local CUDA devices that have
    initialised an allocator, best-effort; empty on the CPU."""
    out = {}
    try:
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return out
        for i in range(torch.cuda.device_count()):
            raw = torch.cuda.memory_stats(i)
            stats = {name: raw[key] for name, key in _TORCH_KEYS.items() if key in raw}
            if stats:
                out[f"cuda:{i}"] = stats
    except Exception:  # a wedged driver must not kill the snapshot
        return out
    return out


class MemWatch:
    """Per-phase device-memory snapshots with high-water tracking."""

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 stats_fn: Callable[[], Dict[str, dict]] = _device_stats):
        self._registry = registry
        self._stats_fn = stats_fn
        self._lock = threading.Lock()
        self._high_water: Dict[str, float] = {}

    def _reg(self) -> MetricRegistry:
        return self._registry if self._registry is not None else _default_registry()

    def snapshot(self, phase: str = "") -> Dict[str, dict]:
        """Record one snapshot; returns {device: {stat: bytes}} actually
        read (empty where there are no allocator stats; never raises)."""
        try:
            per_device = self._stats_fn() or {}
        except Exception:  # watermarks are diagnostic, never fatal
            return {}
        gauge = self._reg().gauge(
            "mho_device_mem_bytes", "device allocator stats per phase snapshot")
        out: Dict[str, dict] = {}
        for device, stats in per_device.items():
            rec = {}
            for stat in _STATS:
                v = stats.get(stat)
                if v is None:
                    continue
                rec[stat] = int(v)
                gauge.set(float(v), device=device, stat=stat,
                          **({"phase": phase} if phase else {}))
            if not rec:
                continue
            out[device] = rec
            mark = float(rec.get("peak_bytes_in_use", rec.get("bytes_in_use", 0)))
            with self._lock:
                is_new_peak = mark > self._high_water.get(device, 0.0)
                if is_new_peak:
                    self._high_water[device] = mark
            if is_new_peak:
                obs_events.emit("watermark", device=device, bytes=int(mark), phase=phase)
        return out

    def watermarks(self) -> Dict[str, int]:
        """Per-device high-water bytes seen across all snapshots."""
        with self._lock:
            return {d: int(v) for d, v in self._high_water.items()}


_DEFAULT = MemWatch()


def memwatch() -> MemWatch:
    """The process-wide default watcher the entry points share."""
    return _DEFAULT


def snapshot(phase: str = "") -> Dict[str, dict]:
    """A snapshot through the default watcher."""
    return _DEFAULT.snapshot(phase)
