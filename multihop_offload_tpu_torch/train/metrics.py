"""Host-side latency summary.

Port of `multihop_offload_tpu/train/metrics.py:summarize_latencies`; the
rest of that module (the per-instance CSV metrics) is not ported yet.
"""

from __future__ import annotations

import numpy as np


def summarize_latencies(samples_s) -> dict:
    """Seconds in, milliseconds out: count, mean, p50, p99, max."""
    x = np.asarray(list(samples_s), dtype=np.float64)
    if x.size == 0:
        return {"count": 0, "mean_ms": None, "p50_ms": None, "p99_ms": None,
                "max_ms": None}
    return {
        "count": int(x.size),
        "mean_ms": float(x.mean() * 1e3),
        "p50_ms": float(np.percentile(x, 50) * 1e3),
        "p99_ms": float(np.percentile(x, 99) * 1e3),
        "max_ms": float(x.max() * 1e3),
    }
