"""Per-tick serve watchdog: detect slow / stuck bucket dispatches.

Port of `multihop_offload_tpu/serve/watchdog.py` (single device).  A
dispatch slower than `threshold_s` is `slow` (counter + `watchdog` event);
one slower than `stuck_factor * threshold_s` is `stuck`: it also dumps the
flight recorder (`obs.flightrec`) and tells the service to degrade that
bucket to the analytic greedy baseline until `recovery_s` elapses.

Durations are measured on the service's injectable clock and clamped at
zero by the caller, so a clock stepping backward never trips the watchdog.
"""

from __future__ import annotations

from multihop_offload_tpu_torch.obs import events as obs_events
from multihop_offload_tpu_torch.obs.registry import registry as obs_registry


class TickWatchdog:
    """Observes one (bucket, dispatch duration) pair per served batch."""

    def __init__(self, threshold_s: float, recovery_s: float = 0.0,
                 stuck_factor: float = 10.0, recorder=None,
                 flight_dir: str = ""):
        if threshold_s <= 0:
            raise ValueError("watchdog threshold_s must be > 0")
        self.threshold_s = float(threshold_s)
        self.recovery_s = float(recovery_s)
        self.stuck_factor = float(stuck_factor)
        self.recorder = recorder
        self.flight_dir = flight_dir
        self.slow = 0
        self.stuck = 0

    def observe(self, bucket: int, duration_s: float) -> str:
        """Classify one dispatch: "ok" | "slow" | "stuck"."""
        if duration_s <= self.threshold_s:
            return "ok"
        verdict = ("stuck" if duration_s > self.threshold_s * self.stuck_factor
                   else "slow")
        if verdict == "slow":
            self.slow += 1
            obs_registry().counter(
                "mho_watchdog_slow_total", "bucket dispatches over threshold"
            ).inc(bucket=bucket)
        else:
            self.stuck += 1
            obs_registry().counter(
                "mho_watchdog_stuck_total",
                "bucket dispatches classified stuck (degraded to baseline)",
            ).inc(bucket=bucket)
        obs_events.emit("watchdog", verdict=verdict, bucket=bucket,
                        duration_s=round(float(duration_s), 6),
                        threshold_s=self.threshold_s)
        if verdict == "stuck" and self.recorder is not None and self.flight_dir:
            self.recorder.dump(
                self.flight_dir, reason=f"watchdog-stuck-bucket{bucket}",
                alerts=[{"kind": "watchdog", "bucket": bucket,
                         "duration_s": float(duration_s),
                         "threshold_s": self.threshold_s, "devices": []}],
            )
        return verdict
