"""Drift-campaign harness: scenario shifts vs the flywheel's detectors.

Port of `multihop_offload_tpu/loop/drift.py`, over the port's
`obs.drift.DriftMonitor`.

The drift-gated loop (`cli/loop.py --loop_drift`) only opens a capture/refit
cycle when `obs.drift.DriftMonitor` trips on the captured-outcome stream.
This module measures that gate against a KNOWN distribution shift: a
`scenarios.shift.ShiftSchedule` renders a synthetic outcome stream with
the world switching at `at_tick`, and `shift_campaign` reports when (and
whether) the detectors notice — detection delay in ticks, and whether any
detector fired before the shift (a false positive against a stationary
from-world).

Scenario switches are the injectors, the detectors the system under test.
"""

from __future__ import annotations

from typing import List, Optional


def shift_campaign(schedule, ticks: int, seed: int = 0,
                   min_samples: int = 16) -> dict:
    """Feed `schedule.outcome_events(ticks, seed)` to a fresh
    `DriftMonitor`; returns the detection report.

    `min_samples` is the detectors' warmup length — the schedule's
    `at_tick` must exceed it or the post-shift world leaks into the
    warmup baseline and the measurement is void (reported as
    `warmup_ok: false` rather than raising, so a sweep over schedules
    degrades per-row)."""
    from multihop_offload_tpu_torch.obs.drift import DriftMonitor

    monitor = DriftMonitor(min_samples=min_samples)
    events = schedule.outcome_events(ticks, seed=seed)
    tripped_at: Optional[int] = None
    trips: List[dict] = []
    for tick, ev in enumerate(events):
        new = monitor.update(ev)
        if new and tripped_at is None:
            tripped_at = tick
        trips.extend(new)
    detected = tripped_at is not None and tripped_at >= schedule.at_tick
    return {
        "ticks": int(ticks),
        "at_tick": int(schedule.at_tick),
        "warmup_ok": schedule.at_tick > min_samples,
        "from": schedule.from_spec.name,
        "to": schedule.to_spec.name,
        "tripped_at": tripped_at,
        "detected": detected,
        "detection_delay": (tripped_at - schedule.at_tick) if detected
        else None,
        "false_positive": tripped_at is not None
        and tripped_at < schedule.at_tick,
        "trips": trips,
    }
