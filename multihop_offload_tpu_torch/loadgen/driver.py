"""Open-loop injection on a virtual clock.

Port of `multihop_offload_tpu/loadgen/driver.py`.

The contract that makes collapse measurable:

  * arrivals happen at THEIR times, not when the service is ready — the
    driver advances a `VirtualClock` to each arrival timestamp and submits
    there, ticking the service at its tick interval along the way;
  * a refused submit (backpressure, too-large) is a DROP, final.  A
    closed-loop generator would retry and thereby throttle itself to the
    service's capacity; open loop keeps offering, so offered - served is
    an observable, not a tautological zero;
  * time-in-system comes straight off `OffloadResponse.latency_s`
    (admission -> response on the SAME virtual clock), so queueing delay
    under overload shows up in the p99 instead of hiding in generator
    back-off.

Driving virtual time instead of wall time makes the measurement about the
service's STRUCTURE (slots x buckets per tick interval), not the speed of
the host running the test — the CPU smoke measures real queueing with the
same numbers a card's host would see at its own tick rate."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence

from multihop_offload_tpu_torch.obs import events as obs_events


class VirtualClock:
    """A settable monotonic clock: `now()` is whatever the driver last
    sought to.  Inject as the service's `clock` so every internal
    timestamp (admission, deadline, watchdog) lives in virtual time."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def seek(self, t: float) -> None:
        if t < self._t:
            raise ValueError(f"virtual clock cannot rewind {self._t} -> {t}")
        self._t = float(t)

    def advance(self, dt: float) -> None:
        self.seek(self._t + float(dt))

    def __call__(self) -> float:  # drop-in for time.monotonic
        return self.now()


@dataclasses.dataclass
class OpenLoopReport:
    """Offered-vs-served accounting for one open-loop run."""

    offered: int
    admitted: int
    dropped: int
    served: int
    degraded: int
    duration_s: float
    offered_rate: float
    served_rate: float
    drop_fraction: float
    p50_s: Optional[float]
    p95_s: Optional[float]
    p99_s: Optional[float]
    max_s: Optional[float]
    drained: bool
    outcomes: Dict[str, int]

    def meets(self, p99_slo_s: float, max_drop_fraction: float) -> bool:
        """The sustained criterion: everything admitted came back, inside
        the p99 time-in-system bound, with at most the tolerated drops."""
        return (self.drained
                and self.drop_fraction <= max_drop_fraction
                and self.p99_s is not None
                and self.p99_s <= p99_slo_s)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _quantile(sorted_vals: Sequence[float], q: float) -> Optional[float]:
    """Exact empirical quantile (nearest-rank on the sorted sample)."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return float(sorted_vals[idx])


def run_open_loop(
    service,
    requests: Iterable,
    arrivals: Sequence[float],
    *,
    clock: VirtualClock,
    tick_interval_s: float,
    duration_s: Optional[float] = None,
    drain_budget_ticks: int = 5000,
) -> OpenLoopReport:
    """Inject `requests[i]` at virtual time `arrivals[i]`; never wait.

    `service` must be running on `clock` (pass the same object as its
    `clock=` at construction) so admission stamps and deadline math agree
    with the driver's timeline.  After the last arrival the service is
    ticked until every ADMITTED request has answered (conservation) or the
    drain budget runs out — an unreached drain is reported honestly
    (`drained=False`), not papered over."""
    if tick_interval_s <= 0:
        raise ValueError("tick_interval_s must be positive")
    reqs = iter(requests)
    t0 = clock.now()
    next_tick = t0 + tick_interval_s
    responses: List = []
    outcomes: Dict[str, int] = {}
    offered = admitted = 0
    last_arrival = t0
    for at in arrivals:
        try:
            req = next(reqs)
        except StopIteration:
            break
        t_at = t0 + float(at)
        while next_tick <= t_at:
            clock.seek(next_tick)
            responses.extend(service.tick(now=next_tick))
            next_tick += tick_interval_s
        clock.seek(t_at)
        last_arrival = t_at
        ok = service.submit(req, now=t_at)
        offered += 1
        admitted += int(bool(ok))
        outcome = getattr(service, "last_submit_outcome", None) or (
            "admitted" if ok else "dropped")
        outcomes[outcome] = outcomes.get(outcome, 0) + 1

    # drain: admitted requests always answer (degraded counts as an
    # answer), so served == admitted is the conservation target
    drained = len(responses) >= admitted
    for _ in range(int(drain_budget_ticks)):
        if len(responses) >= admitted:
            drained = True
            break
        clock.seek(next_tick)
        responses.extend(service.tick(now=next_tick))
        next_tick += tick_interval_s
        drained = len(responses) >= admitted

    span = float(duration_s) if duration_s is not None else max(
        last_arrival - t0, tick_interval_s)
    lat = sorted(float(r.latency_s) for r in responses)
    degraded = sum(1 for r in responses if r.served_by != "gnn")
    report = OpenLoopReport(
        offered=offered,
        admitted=admitted,
        dropped=offered - admitted,
        served=len(responses),
        degraded=degraded,
        duration_s=span,
        offered_rate=offered / span if span > 0 else 0.0,
        served_rate=len(responses) / span if span > 0 else 0.0,
        drop_fraction=(offered - admitted) / offered if offered else 0.0,
        p50_s=_quantile(lat, 0.50),
        p95_s=_quantile(lat, 0.95),
        p99_s=_quantile(lat, 0.99),
        max_s=lat[-1] if lat else None,
        drained=drained,
        outcomes=outcomes,
    )
    obs_events.emit("open_loop_run", **report.to_json())
    return report
