"""Flight recorder: a bounded ring of recent tick diagnostics, dumped on
SLO breach.

Port of `multihop_offload_tpu/obs/flightrec.py` (standard library only).

The serving tick appends one small host-side record per tick (queue depth,
served count, degradation, worst latency); the ring holds only the most
recent `capacity` of them, so the recorder costs O(capacity) memory forever.
When the SLO engine (`obs.slo`) declares a breach it calls `dump`, which
freezes the ring plus the live metric registry into a debug bundle on disk:

    <out_dir>/flight-NNN-<reason>/
        bundle.json     dump metadata: reason, timestamps, alert state
        records.jsonl   the ring contents, oldest first, one JSON row each
        metrics.prom    the registry's Prometheus text exposition at dump time

That is the post-incident view the run log cannot give you: the run log is
sampled/rotated for the flywheel, the bundle is the exact last-`capacity`
ticks before things went wrong.  Dumps also land in the run log as a
``flight_record`` event (path + reason) so `mho-obs` can point at them.

`clock` is injectable — the health smoke drives manual time, and bundle
names must stay deterministic (a dump counter, not a wall-clock stamp).
"""

from __future__ import annotations

import json
import os
import re
import time
from collections import deque
from typing import Callable, List, Optional

from multihop_offload_tpu_torch.obs import events as obs_events
from multihop_offload_tpu_torch.obs.registry import registry as obs_registry


def _slug(text: str) -> str:
    return re.sub(r"[^A-Za-z0-9_]+", "-", str(text)).strip("-") or "breach"


class FlightRecorder:
    """Bounded ring buffer of tick diagnostics + breach-triggered dump."""

    def __init__(self, capacity: int = 256,
                 clock: Callable[[], float] = time.time):
        if capacity < 1:
            raise ValueError("flight recorder capacity must be >= 1")
        self.capacity = int(capacity)
        self.clock = clock
        self._buf: deque = deque(maxlen=self.capacity)
        self._dumps = 0

    def __len__(self) -> int:
        return len(self._buf)

    def record(self, kind: str, **diag) -> None:
        """Append one diagnostic row; the oldest row beyond `capacity` is
        evicted.  Rows must be JSON-native (the serve tick passes scalars)."""
        self._buf.append({"kind": kind, "ts": float(self.clock()), **diag})

    def records(self) -> List[dict]:
        return list(self._buf)

    def dump(self, out_dir: str, reason: str,
             alerts: Optional[dict] = None,
             extra: Optional[dict] = None) -> str:
        """Freeze the ring + registry into a bundle directory; returns its
        path.  Never raises into the serving tick: a failed dump is reported
        as a counter and an empty path."""
        self._dumps += 1
        bundle = os.path.join(
            out_dir, f"flight-{self._dumps:03d}-{_slug(reason)}"
        )
        try:
            os.makedirs(bundle, exist_ok=True)
            rows = self.records()
            with open(os.path.join(bundle, "records.jsonl"), "w") as f:
                for row in rows:
                    f.write(json.dumps(row, default=str) + "\n")
            with open(os.path.join(bundle, "metrics.prom"), "w") as f:
                f.write(obs_registry().prometheus_text())
            meta = {
                "reason": str(reason),
                "ts": float(self.clock()),
                "records": len(rows),
                "capacity": self.capacity,
                "dump_seq": self._dumps,
                "alerts": alerts or {},
            }
            if extra:
                meta.update(extra)
            with open(os.path.join(bundle, "bundle.json"), "w") as f:
                json.dump(meta, f, indent=1, default=str)
                f.write("\n")
        except OSError:
            obs_registry().counter(
                "mho_flight_dump_failures_total",
                "flight-record bundles that failed to write",
            ).inc()
            return ""
        obs_registry().counter(
            "mho_flight_dumps_total", "flight-record bundles written"
        ).inc()
        obs_events.emit("flight_record", path=bundle, reason=str(reason),
                        records=len(rows))
        return bundle
