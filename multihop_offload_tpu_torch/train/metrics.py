"""Per-instance metrics matching the reference's CSV semantics, and the
host-side latency summary.

Port of `multihop_offload_tpu/train/metrics.py`, batched over instances:
`tau` = masked mean of the per-job empirical delay, `congest_jobs` = count
of jobs with delay > T, `gap_2_bl` / `ratio_2_bl` = per-job mean
difference / ratio against the baseline method on the *same* workload
(`AdHoc_train.py:160-182`, `AdHoc_test.py:156-178`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class InstanceMetrics:
    tau: torch.Tensor           # (B,) mean per-job delay
    congest_jobs: torch.Tensor  # (B,) int
    gap_2_bl: torch.Tensor      # (B,) mean per-job (delay - baseline delay)
    ratio_2_bl: torch.Tensor    # (B,) mean per-job (delay / baseline delay)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    denom = mask.sum(dim=-1).clamp_min(1)
    return torch.where(mask, x, 0.0).sum(dim=-1) / denom


def instance_metrics(job_total: torch.Tensor, baseline_total: torch.Tensor,
                     mask: torch.Tensor, t_max: float) -> InstanceMetrics:
    """Metrics of (B, J) per-job delays against the baseline's (B, J)."""
    one = torch.ones((), dtype=baseline_total.dtype, device=baseline_total.device)
    return InstanceMetrics(
        tau=_masked_mean(job_total, mask),
        congest_jobs=((job_total > t_max) & mask).sum(dim=-1),
        gap_2_bl=_masked_mean(job_total - baseline_total, mask),
        ratio_2_bl=_masked_mean(job_total / torch.where(mask, baseline_total, one), mask),
    )


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
