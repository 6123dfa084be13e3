"""Scenario switches as shift injectors.

Port of `multihop_offload_tpu/scenarios/shift.py` (numpy only); the
synthetic streams equal JAX's value for value.

A `ShiftSchedule` is the declarative form of "the world changed at tick
T": two `ScenarioSpec`s and a switch tick.  `spec_at(tick)` is the whole
tick semantics — strictly before `at_tick` the from-world is live, at and
after it the to-world is — and `outcome_events` renders the schedule as a
stream of synthetic outcome dicts shaped exactly like the ``outcome``
event rows the flywheel captures (`loop.experience.outcome_record` keys
`tau` / `is_local` / `job_rate`), so `obs.drift.DriftMonitor.feed`
consumes them directly.  `loop.drift.shift_campaign` wraps that into the
detection-latency measurement the drift campaign keys on.

The synthetic features are derived, not arbitrary: per-tick arrival rate
follows the spec's `TrafficModel` intensity (`loadgen.rate_profile`) at
the spec's pinned utilization, tau follows the M/M/1-style load curve
``1/(1 - rho)`` of that utilization, and the offload fraction falls with
the spec's energy weights (a transport-energy price pushes work local).
A seeded jitter gives the detectors' warmup windows an honest nonzero
variance — without it any post-shift change trips instantly and the
measured detection delay is meaningless.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from multihop_offload_tpu_torch.loadgen.arrivals import rate_profile
from multihop_offload_tpu_torch.scenarios.spec import ScenarioSpec

_JITTER = 0.02       # relative sigma of the per-tick feature jitter
_RHO_CAP = 0.95      # keep the tau load curve finite under burst multipliers


@dataclasses.dataclass(frozen=True)
class ShiftSchedule:
    """One world switch: `from_spec` before `at_tick`, `to_spec` from it on."""

    from_spec: ScenarioSpec
    to_spec: ScenarioSpec
    at_tick: int

    def __post_init__(self):
        if self.at_tick < 1:
            raise ValueError("at_tick must be >= 1 (tick 0 is the from-world)")

    def spec_at(self, tick: int) -> ScenarioSpec:
        return self.from_spec if tick < self.at_tick else self.to_spec

    def outcome_events(
        self, ticks: int, seed: int = 0, horizon_s: float = 4.0
    ) -> List[dict]:
        """`ticks` synthetic outcome dicts (keys `tau`, `is_local`,
        `job_rate`, plus provenance), deterministic per (schedule, ticks,
        seed).  Each spec's traffic shape is sampled over its OWN model-time
        horizon, so a flash/burst in the to-world lands after the switch."""
        if ticks < 1:
            raise ValueError("ticks must be >= 1")
        rng = np.random.default_rng(int(seed))
        profiles = {}
        for which, spec in (("from", self.from_spec), ("to", self.to_spec)):
            profiles[which] = rate_profile(
                spec.traffic, horizon_s, ticks, seed=spec.seed,
                normalize=True,
            )
        events = []
        for tick in range(ticks):
            which = "from" if tick < self.at_tick else "to"
            spec = self.from_spec if which == "from" else self.to_spec
            mult = profiles[which][tick]
            rho = min(spec.util * mult, _RHO_CAP)
            jitter = 1.0 + _JITTER * rng.standard_normal()
            tau = (1.0 / (1.0 - rho)) * jitter
            per_job = spec.util * mult / spec.num_jobs
            job_rate = [
                float(per_job * (1.0 + _JITTER * rng.standard_normal()))
                for _ in range(spec.num_jobs)
            ]
            # a transport/compute price pushes decisions local
            price = min(spec.objective.transport_energy
                        + spec.objective.compute_energy, 1.0)
            frac_local = min(0.25 + 0.5 * price, 1.0)
            n_local = int(round(frac_local * spec.num_jobs))
            events.append({
                "tau": float(tau),
                "is_local": [i < n_local for i in range(spec.num_jobs)],
                "job_rate": job_rate,
                "tick": tick,
                "scenario": spec.name,
                "shift_side": which,
            })
        return events


def shift(from_spec: ScenarioSpec, to_spec: ScenarioSpec,
          at_tick: int) -> ShiftSchedule:
    """The injector constructor the drift campaign calls."""
    return ShiftSchedule(from_spec=from_spec, to_spec=to_spec,
                         at_tick=int(at_tick))
