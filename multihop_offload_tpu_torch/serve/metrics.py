"""Serving metrics surface.

Port of `multihop_offload_tpu/serve/metrics.py`: the counters and samples
an `OffloadService` accumulates, reduced by `summary()` to the operator's
numbers (requests/s, p50/p99 latency, per-bucket occupancy, padding waste,
dispatches per request, and under the sharded executor the per-shard
`shards` block).  Every mutation also mirrors into the process-wide
`obs.registry` under `mho_serve_*`.  `log_tb` writes a snapshot of them
as TensorBoard scalars (`train.tb_logging.ScalarLogger`, JAX `:234-252`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from multihop_offload_tpu_torch.obs.registry import LATENCY_BUCKETS
from multihop_offload_tpu_torch.obs.registry import registry as _registry
from multihop_offload_tpu_torch.train.metrics import summarize_latencies


@dataclasses.dataclass
class _BucketStats:
    dispatches: int = 0
    degraded_dispatches: int = 0
    served: int = 0
    offered: int = 0               # admission attempts routed to this bucket
    occupancy_sum: float = 0.0     # real requests / slots, summed per dispatch
    waste_jobs_sum: float = 0.0    # job-slot padding waste, summed per dispatch
    waste_nodes_sum: float = 0.0
    width_sum: int = 0             # width actually ticked (ladder rung)
    slots_saved: int = 0           # full-capacity slots the ladder did NOT tick


# occupancy histogram edges: the ladder's power-of-two rungs expressed as
# capacity fractions
OCCUPANCY_BUCKETS = (0.0625, 0.125, 0.25, 0.5, 0.75, 1.0)


@dataclasses.dataclass
class ServingStats:
    """Lifetime counters of one service; all host-side scalars."""

    submitted: int = 0
    admitted: int = 0
    rejected: int = 0        # bounded-queue backpressure refusals
    too_large: int = 0       # no bucket fits — permanent refusal
    invalid: int = 0         # admission-guard semantic refusals
    served: int = 0          # responses demuxed
    degraded: int = 0        # responses served by the analytic baseline
    decisions: int = 0       # real (unpadded) job decisions returned
    ticks: int = 0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    buckets: Dict[int, _BucketStats] = dataclasses.field(default_factory=dict)
    # per-shard (fleet index) served counts, sharded executor only
    shard_served: Dict[str, int] = dataclasses.field(default_factory=dict)

    def bucket(self, b: int) -> _BucketStats:
        return self.buckets.setdefault(b, _BucketStats())

    def record_submit(self, outcome: str, bucket: Optional[int] = None) -> None:
        """One admission decision: 'admitted', 'backpressure', 'too_large'
        or 'rejected_invalid'.  `bucket` feeds the per-bucket offered count."""
        self.submitted += 1
        if bucket is not None:
            self.bucket(bucket).offered += 1
        if outcome == "admitted":
            self.admitted += 1
        elif outcome == "backpressure":
            self.rejected += 1
        elif outcome == "too_large":
            self.too_large += 1
        elif outcome == "rejected_invalid":
            self.invalid += 1
        else:
            raise ValueError(f"unknown submit outcome '{outcome}'")
        _registry().counter(
            "mho_serve_submits_total", "admission decisions by outcome"
        ).inc(outcome=outcome)

    def record_dispatch(self, b: int, n_real: int, slots: int, waste: dict,
                        degraded: bool, width: Optional[int] = None) -> None:
        """One batched dispatch: `slots` is the bucket's full capacity,
        `width` the width actually ticked (defaults to full).  Occupancy is
        measured against capacity, padding waste against the width."""
        w = slots if width is None else int(width)
        s = self.bucket(b)
        s.dispatches += 1
        s.degraded_dispatches += int(degraded)
        s.served += n_real
        s.occupancy_sum += n_real / slots
        s.width_sum += w
        s.slots_saved += max(slots - w, 0)
        s.waste_jobs_sum += waste["jobs"]
        s.waste_nodes_sum += waste["nodes"]
        reg = _registry()
        reg.counter(
            "mho_serve_dispatches_total", "batched decision programs dispatched"
        ).inc(bucket=str(b), served_by="baseline" if degraded else "gnn")
        reg.counter(
            "mho_serve_pad_waste_jobs_total",
            "padded job slots computed and discarded",
        ).inc(waste["jobs"], bucket=str(b))
        reg.histogram(
            "mho_serve_bucket_occupancy",
            "real requests / slot capacity per dispatch",
            buckets=OCCUPANCY_BUCKETS,
        ).observe(n_real / slots, bucket=str(b))
        pad_slots = w - n_real
        if pad_slots > 0:
            reg.counter(
                "mho_serve_pad_waste_slots_total",
                "batch slots ticked with no real request in them",
            ).inc(pad_slots, bucket=str(b))

    def record_ladder_transition(self, b: int, old: int, new: int) -> None:
        """One occupancy-ladder rung change (telemetry only)."""
        _registry().counter(
            "mho_serve_ladder_transitions_total",
            "occupancy-ladder width changes",
        ).inc(bucket=str(b), direction="widen" if new > old else "narrow")

    def record_batch(self, n_real: int, decisions: int, degraded: bool,
                     latencies_s: List[float],
                     shards: Optional[List[str]] = None) -> None:
        """One served batch's responses: counts plus per-request queue+serve
        latencies (mirrored into `mho_serve_latency_seconds`).  `shards[i]`
        (sharded executor: the fleet index that computed slot i) labels each
        latency observation, so the per-shard SLO burn rates
        (`obs.slo.sharded_serving_slos`) see only their own device's tail."""
        self.served += n_real
        self.degraded += n_real if degraded else 0
        self.decisions += decisions
        self.latencies_s.extend(latencies_s)
        reg = _registry()
        reg.counter(
            "mho_serve_served_total", "requests answered"
        ).inc(n_real, served_by="baseline" if degraded else "gnn")
        if degraded:
            reg.counter(
                "mho_serve_degraded_total",
                "requests served by the analytic baseline under deadline "
                "pressure",
            ).inc(n_real)
        lat = reg.histogram(
            "mho_serve_latency_seconds", "request queue+serve latency",
            buckets=LATENCY_BUCKETS,
        )
        if shards:
            for x, s in zip(latencies_s, shards):
                lat.observe(x, shard=s)
                self.shard_served[s] = self.shard_served.get(s, 0) + 1
        else:
            for x in latencies_s:
                lat.observe(x)

    @property
    def dispatches(self) -> int:
        return sum(s.dispatches for s in self.buckets.values())

    def log_tb(self, tb, step: int, queue_depth: int = 0) -> None:
        """Scalar snapshot onto a TensorBoard event file (no-op when the
        logger is inactive), JAX's tags."""
        if not tb.active:
            return
        lat = summarize_latencies(self.latencies_s)
        tb.log_scalar("serve/queue_depth", queue_depth, step)
        tb.log_scalar("serve/served", self.served, step)
        tb.log_scalar("serve/degraded", self.degraded, step)
        tb.log_scalar("serve/dispatches", self.dispatches, step)
        if lat["count"]:
            tb.log_scalar("serve/latency_p50_ms", lat["p50_ms"], step)
            tb.log_scalar("serve/latency_p99_ms", lat["p99_ms"], step)
        for b, s in self.buckets.items():
            if s.dispatches:
                tb.log_scalar(f"serve/bucket{b}_occupancy",
                              s.occupancy_sum / s.dispatches, step)

    def summary(self, wall_s: float = 0.0) -> dict:
        """The serving record, with the JAX package's keys."""
        lat = summarize_latencies(self.latencies_s)
        per_bucket = {}
        for b, s in sorted(self.buckets.items()):
            d = max(s.dispatches, 1)
            per_bucket[str(b)] = {
                "dispatches": s.dispatches,
                "degraded_dispatches": s.degraded_dispatches,
                "served": s.served,
                "mean_occupancy": round(s.occupancy_sum / d, 4),
                "mean_pad_waste_jobs": round(s.waste_jobs_sum / d, 4),
                "mean_pad_waste_nodes": round(s.waste_nodes_sum / d, 4),
                "mean_width": round(s.width_sum / d, 2),
                "slots_saved": s.slots_saved,
            }
        served = max(self.served, 1)
        out = {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "rejected_backpressure": self.rejected,
            "rejected_too_large": self.too_large,
            "rejected_invalid": self.invalid,
            "served": self.served,
            "degraded": self.degraded,
            "decisions": self.decisions,
            "ticks": self.ticks,
            "dispatches": self.dispatches,
            "dispatches_per_request": round(self.dispatches / served, 4),
            "dispatches_per_1k_requests": round(1000.0 * self.dispatches / served, 2),
            "latency": lat,
            "per_bucket": per_bucket,
        }
        buckets_block = {}
        for b, s in sorted(self.buckets.items()):
            entry = {"offered": s.offered, "served": s.served}
            if wall_s > 0:
                entry["offered_per_sec"] = round(s.offered / wall_s, 2)
                entry["served_per_sec"] = round(s.served / wall_s, 2)
            buckets_block[str(b)] = entry
        if buckets_block:
            out["buckets"] = buckets_block
        if self.shard_served:
            shards_block = {}
            for dev, n in sorted(self.shard_served.items()):
                entry = {"served": n}
                if wall_s > 0:
                    entry["served_per_sec"] = round(n / wall_s, 2)
                shards_block[dev] = entry
            out["shards"] = shards_block
        if wall_s > 0:
            out["wall_s"] = round(wall_s, 3)
            out["requests_per_sec"] = round(self.served / wall_s, 2)
            out["decisions_per_sec"] = round(self.decisions / wall_s, 2)
        return out
