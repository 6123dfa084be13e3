"""Two-level placement: buckets -> hosts -> devices.

Port of `multihop_offload_tpu/multihost/plan.py`, pure host code: the same
plans for the same host table and rates.  The single-host
`serve.placement.PlacementPlanner` lays each bucket's batch over a subset
of one process's fleet.  Across hosts the network between them is far
slower than the links inside one, so a plan never lays a bucket's batch
across two hosts.  This module makes that a structural invariant:

  * level 1 (hosts): every bucket is assigned to exactly one host.  Each
    process holds the same weights, so moving a bucket between hosts moves
    only future traffic, never state;
  * level 2 (devices): within its host, the bucket's batch is laid over a
    device subset by the same divisor-ladder greedy the single-host planner
    uses (`serve.placement.plan_assignments`, called per host).

The planner keeps the single-host planner's contract: EWMA arrival-rate
observation, deterministic plans for fixed rates, a hysteresis gate against
rate jitter, and a forced re-plan when a host is removed.  Every process of
a fleet, given the same host table and rates, derives the same plan with no
traffic between them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from multihop_offload_tpu_torch.obs import events as obs_events
from multihop_offload_tpu_torch.obs.registry import registry as obs_registry
from multihop_offload_tpu_torch.serve.placement import (
    PlacementPlan,
    peak_device_load,
    plan_assignments,
)

_RATE_FLOOR = 1e-9


@dataclasses.dataclass(frozen=True)
class TwoLevelPlan:
    """One immutable bucket -> (host, device-tuple) map.

    `hosts[b]` names the host serving bucket `b`; `devices[b]` are the
    devices of that host carrying its batch (opaque ids: the hosts' device
    ids in `mho-mesh`, plain values in tests)."""

    hosts: Tuple[str, ...]
    devices: Tuple[Tuple[object, ...], ...]

    def host_of(self, bucket: int) -> str:
        return self.hosts[bucket]

    def devices_for(self, bucket: int) -> Tuple[object, ...]:
        return self.devices[bucket]

    def buckets_on_host(self, host: str) -> List[int]:
        return [b for b, h in enumerate(self.hosts) if h == host]

    def describe(self) -> dict:
        """JSON-friendly: bucket -> {host, devices}."""
        def dev_id(d):
            return getattr(d, "id", d)

        return {
            str(b): {"host": h, "devices": [dev_id(d) for d in devs]}
            for b, (h, devs) in enumerate(zip(self.hosts, self.devices))
        }


def validate_plan(plan: TwoLevelPlan, hosts: Dict[str, Sequence]) -> None:
    """The host-boundary invariant, checked structurally: every bucket's
    devices are a subset of its own host's devices.  A bucket spanning
    hosts is a planner bug and raises before anything serves on it.  (The
    messages keep JAX's wording, "DCN", the network between hosts.)"""
    for b, (h, devs) in enumerate(zip(plan.hosts, plan.devices)):
        if h not in hosts:
            raise ValueError(f"bucket {b} assigned to unknown host '{h}'")
        if not devs:
            raise ValueError(f"bucket {b} has no devices on host '{h}'")
        host_devs = list(hosts[h])
        missing = [d for d in devs if d not in host_devs]
        if missing:
            raise ValueError(
                f"bucket {b} spans the DCN boundary: devices {missing} "
                f"are not on its host '{h}'"
            )


def plan_two_level(
    rates: Sequence[float], hosts: Dict[str, Sequence], slots: int
) -> TwoLevelPlan:
    """The deterministic two-level greedy.

    Level 1: buckets in descending-rate order (ties -> lower bucket index)
    each go to the host with the lowest resulting per-device load (ties ->
    lexicographically first host id).  Level 2: each host's bucket set is
    laid over its devices by `serve.placement.plan_assignments` — the exact
    single-host ladder, so within-host behavior is unchanged.

    Same rates + same host table -> same plan, on every process."""
    if not hosts:
        raise ValueError("two-level placement needs at least one host")
    for h, devs in hosts.items():
        if not list(devs):
            raise ValueError(f"host '{h}' has no devices")
    n_buckets = len(rates)
    host_ids = sorted(hosts)
    load = [max(float(r), _RATE_FLOOR) for r in rates]
    # level 1: greedy balance of per-device host load
    host_load = {h: 0.0 for h in host_ids}
    assigned: Dict[str, List[int]] = {h: [] for h in host_ids}
    bucket_host: List[Optional[str]] = [None] * n_buckets
    order = sorted(range(n_buckets), key=lambda b: (-load[b], b))
    for b in order:
        best = min(
            host_ids,
            key=lambda h: ((host_load[h] + load[b]) / len(list(hosts[h])), h),
        )
        bucket_host[b] = best
        host_load[best] += load[b]
        assigned[best].append(b)
    # level 2: the single-host ladder per host, over that host's devices only
    bucket_devs: List[Tuple[object, ...]] = [()] * n_buckets
    for h in host_ids:
        bs = sorted(assigned[h])
        if not bs:
            continue
        sub = plan_assignments([load[b] for b in bs], list(hosts[h]), slots)
        for b, devs in zip(bs, sub):
            bucket_devs[b] = devs
    plan = TwoLevelPlan(hosts=tuple(bucket_host), devices=tuple(bucket_devs))
    validate_plan(plan, hosts)
    return plan


class TwoLevelPlanner:
    """EWMA per-bucket rates -> hysteretic two-level plan.

    The single-host planner's contract, host-aware: `observe` folds one
    window's admitted-arrival counts, `replan` returns the plan to serve
    with — the CURRENT one unless the candidate's peak per-device load beats
    it by the `hysteresis` margin or the current plan references a removed
    host.  `remove_host` force-replans (an invalid plan is never held);
    `add_host` restores capacity for the next clearing re-plan."""

    def __init__(self, num_buckets: int, hosts: Dict[str, Sequence],
                 slots: int, alpha: float = 0.5, hysteresis: float = 0.2):
        if num_buckets < 1:
            raise ValueError("planner needs at least one bucket")
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.hosts: Dict[str, List] = {h: list(d) for h, d in hosts.items()}
        self.slots = int(slots)
        self.alpha = float(alpha)
        self.hysteresis = float(hysteresis)
        self.rates = [0.0] * num_buckets
        self.replans = 0
        self.plan = plan_two_level(self.rates, self.hosts, self.slots)

    def observe(self, arrivals: Sequence[float]) -> None:
        """Same rate unit as the single-host planner: admitted arrivals per
        re-plan window, no wall clock involved."""
        if len(arrivals) != len(self.rates):
            raise ValueError(
                f"got {len(arrivals)} arrival counts for "
                f"{len(self.rates)} buckets"
            )
        a = self.alpha
        self.rates = [
            (1.0 - a) * r + a * float(n) for r, n in zip(self.rates, arrivals)
        ]

    def _invalid(self) -> bool:
        cur = self.plan
        for h, devs in zip(cur.hosts, cur.devices):
            if h not in self.hosts:
                return True
            host_devs = self.hosts[h]
            if any(d not in host_devs for d in devs):
                return True
        return False

    def replan(self) -> TwoLevelPlan:
        """Adopt the candidate only when it is enough better (hysteresis)
        or the current plan is invalid (host removed)."""
        invalid = self._invalid()
        candidate = plan_two_level(self.rates, self.hosts, self.slots)
        if (candidate.hosts == self.plan.hosts
                and candidate.devices == self.plan.devices):
            return self.plan
        if not invalid:
            cur_peak = peak_device_load(self.plan.devices, self.rates)
            new_peak = peak_device_load(candidate.devices, self.rates)
            if new_peak * (1.0 + self.hysteresis) >= cur_peak:
                return self.plan  # not enough better: keep, don't thrash
        self.plan = candidate
        self.replans += 1
        obs_registry().counter(
            "mho_mesh_replans_total", "two-level placement switches applied"
        ).inc()
        obs_events.emit(
            "mesh_placement", plan=self.plan.describe(),
            rates=[round(r, 4) for r in self.rates],
            hosts=sorted(self.hosts), forced=bool(invalid),
        )
        return self.plan

    def remove_host(self, host: str) -> TwoLevelPlan:
        """Host loss: drop it from the table and re-plan immediately —
        hysteresis cannot hold a plan that references a dead host."""
        self.hosts.pop(host, None)
        if not self.hosts:
            raise ValueError("two-level fleet is empty after host removal")
        obs_registry().counter(
            "mho_mesh_hosts_lost_total", "hosts dropped from the fleet"
        ).inc(host=str(host))
        return self.replan()

    def add_host(self, host: str, devices: Sequence) -> TwoLevelPlan:
        """Host recovery: restore its devices; adoption waits for a re-plan
        that clears hysteresis (recovery is never forced mid-window)."""
        if not list(devices):
            raise ValueError(f"host '{host}' has no devices")
        self.hosts[host] = list(devices)
        return self.replan()


def local_placement(
    plan: TwoLevelPlan,
    host: str,
    local_devices: Sequence,
    fallback_device=None,
) -> PlacementPlan:
    """Project the fleet plan onto ONE process: buckets owned by `host`
    keep their device assignment translated onto this process's local
    devices (position for position: the plan was built against this host's
    advertised device list, same length and order); buckets owned by other
    hosts get a single-device placeholder so the executor's plan stays
    total.  Placeholder buckets are never dispatched locally (host-level
    routing sends their traffic elsewhere) except during a kill-a-host
    takeover, where the placeholder is the failover placement, with the
    same decisions as any other placement."""
    locals_ = list(local_devices)
    if not locals_:
        raise ValueError("local_placement needs at least one local device")
    fb = fallback_device if fallback_device is not None else locals_[0]
    out = []
    for b, (h, devs) in enumerate(zip(plan.hosts, plan.devices)):
        if h != host:
            out.append((fb,))
            continue
        if len(devs) > len(locals_):
            raise ValueError(
                f"bucket {b} plans {len(devs)} chips but host '{host}' "
                f"has {len(locals_)} locally"
            )
        out.append(tuple(locals_[: len(devs)]))
    return PlacementPlan(tuple(out))
