"""Greedy per-bucket device placement from observed arrival rates.

Port of `multihop_offload_tpu/serve/placement.py`, line for line: the same
plans for the same rates and fleet, ties included.  The sharded executor
(`serve.sharded.ShardedBucketExecutor`) runs each bucket's batch in equal
contiguous blocks over a subset of the fleet; this module decides those
subsets.  Hot buckets (high observed arrival rate) get more devices than
cold ones.

Two rules keep a plan servable:

- a bucket's device count divides the slot count (`slots % n == 0`), so
  every shard holds the same number of slots;
- a plan changes only between ticks (`OffloadService.tick` applies it
  before it drains any queue), never inside a dispatch.

The planner is deterministic (same rates -> same plan) and hysteretic: a
new plan replaces the current one only when its peak per-device load beats
the current plan's by the `hysteresis` margin, so arrival-rate jitter does
not move buckets back and forth.  Removing a device invalidates any plan
that uses it, which forces a re-plan whatever the hysteresis.

The service plans over fleet indices `0..k-1` (`fleet[i]` is a
`torch.device`; a fleet may name one device more than once), the tests
over plain ints; `describe` renders a device by its `.id` when it has one.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from multihop_offload_tpu_torch.obs import events as obs_events
from multihop_offload_tpu_torch.obs.registry import registry as obs_registry

# rates below this are treated as this: an all-cold ladder still spreads
# evenly instead of letting tie-breaks pile every spare device on bucket 0
_RATE_FLOOR = 1e-9


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """One immutable bucket -> device-tuple map (devices are whatever the
    caller passed: fleet indices in the service, plain ints in tests)."""

    assignments: Tuple[Tuple[object, ...], ...]

    def devices_for(self, bucket: int) -> Tuple[object, ...]:
        return self.assignments[bucket]

    def buckets_on(self, device) -> List[int]:
        return [b for b, devs in enumerate(self.assignments) if device in devs]

    def uses(self, device) -> bool:
        return any(device in devs for devs in self.assignments)

    def describe(self) -> dict:
        """JSON-friendly view keyed by bucket index; devices render by
        their `.id` when they have one, else as-is (fleet indices)."""
        def dev_id(d):
            return getattr(d, "id", d)

        return {str(b): [dev_id(d) for d in devs]
                for b, devs in enumerate(self.assignments)}


def allowed_counts(slots: int, max_devices: int) -> List[int]:
    """Device counts a bucket may be placed on: divisors of `slots`, capped
    at the fleet size (every shard gets the same static slice)."""
    return [c for c in range(1, max_devices + 1) if slots % c == 0]


def plan_assignments(
    rates: Sequence[float], devices: Sequence, slots: int
) -> Tuple[Tuple[object, ...], ...]:
    """The greedy plan: every bucket starts at one device; while spare
    devices remain, upgrade the bucket with the highest per-device load
    (rate / current count) to its next allowed count.  Deterministic —
    ties break toward the lower bucket index — so a fixed rate vector
    always yields the same plan.

    Fleets smaller than the ladder share: buckets round-robin over the
    devices (a tick dispatches buckets sequentially, so co-residency costs
    queueing, not correctness)."""
    devices = list(devices)
    n_buckets = len(rates)
    if not devices:
        raise ValueError("placement needs at least one device")
    if n_buckets == 0:
        return ()
    if len(devices) < n_buckets:
        return tuple((devices[b % len(devices)],) for b in range(n_buckets))
    load = [max(float(r), _RATE_FLOOR) for r in rates]
    counts = [1] * n_buckets
    steps = allowed_counts(slots, len(devices))
    remaining = len(devices) - n_buckets
    while remaining > 0:
        best: Optional[Tuple[float, int, int]] = None  # (-load, bucket, next)
        for b in range(n_buckets):
            nxt = next((c for c in steps if c > counts[b]), None)
            if nxt is None or nxt - counts[b] > remaining:
                continue
            key = (-load[b] / counts[b], b)
            if best is None or key < (best[0], best[1]):
                best = (key[0], key[1], nxt)
        if best is None:
            break  # no bucket can absorb the leftovers (divisor gaps)
        _, b, nxt = best
        remaining -= nxt - counts[b]
        counts[b] = nxt
    out, i = [], 0
    for b in range(n_buckets):
        out.append(tuple(devices[i:i + counts[b]]))
        i += counts[b]
    return tuple(out)


def peak_device_load(plan: Tuple[Tuple[object, ...], ...],
                     rates: Sequence[float]) -> float:
    """The plan's bottleneck: the hottest per-device arrival rate (what the
    greedy step minimizes and the hysteresis gate compares)."""
    return max(
        (max(float(r), _RATE_FLOOR) / len(devs)
         for r, devs in zip(rates, plan) if devs),
        default=0.0,
    )


class PlacementPlanner:
    """EWMA per-bucket arrival rates -> hysteretic greedy plan.

    `observe` feeds one window's admitted-arrival counts (the service calls
    it at its re-plan cadence); `replan` returns the plan to serve with —
    usually the CURRENT one, a new one only when it is enough better or the
    current one references a removed device."""

    def __init__(self, num_buckets: int, devices: Sequence, slots: int,
                 alpha: float = 0.5, hysteresis: float = 0.2):
        if num_buckets < 1:
            raise ValueError("planner needs at least one bucket")
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.devices: List = list(devices)
        self.slots = int(slots)
        self.alpha = float(alpha)
        self.hysteresis = float(hysteresis)
        self.rates = [0.0] * num_buckets
        self.replans = 0
        self.plan = PlacementPlan(
            plan_assignments(self.rates, self.devices, self.slots)
        )

    def observe(self, arrivals: Sequence[float]) -> None:
        """Fold one window's per-bucket admitted-arrival counts into the
        EWMA rates (windows are the service's re-plan cadence, so counts
        per window ARE the rate unit — no wall clock involved, manual-clock
        drills included)."""
        if len(arrivals) != len(self.rates):
            raise ValueError(
                f"got {len(arrivals)} arrival counts for {len(self.rates)} buckets"
            )
        a = self.alpha
        self.rates = [
            (1.0 - a) * r + a * float(n) for r, n in zip(self.rates, arrivals)
        ]

    def replan(self) -> PlacementPlan:
        """The plan to serve the next window with.  Switches only when the
        candidate's peak per-device load beats the current plan's by the
        hysteresis margin, or the current plan is invalid (device removed).
        Every switch increments `mho_serve_replans_total`."""
        current = self.plan.assignments
        invalid = any(
            d not in self.devices for devs in current for d in devs
        ) or sum(len(devs) for devs in current) > len(self.devices)
        candidate = plan_assignments(self.rates, self.devices, self.slots)
        if candidate == current:
            return self.plan
        if not invalid:
            cur_peak = peak_device_load(current, self.rates)
            new_peak = peak_device_load(candidate, self.rates)
            if new_peak * (1.0 + self.hysteresis) >= cur_peak:
                return self.plan  # not enough better: keep, don't thrash
        self.plan = PlacementPlan(candidate)
        self.replans += 1
        obs_registry().counter(
            "mho_serve_replans_total", "placement plan switches applied"
        ).inc()
        obs_events.emit(
            "placement", plan=self.plan.describe(),
            rates=[round(r, 4) for r in self.rates],
            devices=len(self.devices), forced=bool(invalid),
        )
        return self.plan

    def remove_device(self, device) -> PlacementPlan:
        """Device loss: drop `device` from the fleet and re-plan immediately
        (a plan referencing it is invalid, so hysteresis cannot hold it)."""
        if device in self.devices:
            self.devices.remove(device)
        if not self.devices:
            raise ValueError("placement fleet is empty after device removal")
        return self.replan()

    def add_device(self, device) -> PlacementPlan:
        """Device recovery: return `device` to the fleet; the next plan that
        clears hysteresis may use it (recovery is never forced mid-window)."""
        if device not in self.devices:
            self.devices.append(device)
        return self.replan()
