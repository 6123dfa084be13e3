"""Declarative scenario matrix: stress the policy where the paper never looked.

Port of `multihop_offload_tpu/scenarios/` (JAX's exports, the same presets
and hashes); numpy and torch only.

The paper evaluates on BA graphs with Poisson-ish arrivals and homogeneous
servers.  This package makes "which world are we in" a first-class, frozen,
JSON-round-trippable object and runs every named world through BOTH
evaluators:

  * `spec`    — `ScenarioSpec` (+ `FailureEvent`, `MobilitySpec`): topology
    family, traffic shape, heterogeneous-mu spread, failure/mobility
    schedules, energy-weighted objective; exact JSON round-trip + content
    hash;
  * `presets` — the named registry (14 presets over 8 families, including
    the new grid / corridor / two-tier edge-cloud families);
  * `build`   — realize a spec into (Topology, Instance, JobSet) + failure
    schedules + mobility steps, deterministic per (spec, lane);
  * `matrix`  — the interleaved-legs runner behind `cli/scenarios.py
    --matrix` (one process, one shared pad, three fleet simulators, exact
    conservation);
  * `shift`   — scenario switches as shift injectors for the drift campaign
    (`loop.drift.shift_campaign`).
"""

from multihop_offload_tpu_torch.scenarios.presets import (  # noqa: F401
    NEW_FAMILIES,
    PRESETS,
    preset,
    preset_names,
)
from multihop_offload_tpu_torch.scenarios.shift import (  # noqa: F401
    ShiftSchedule,
    shift,
)
from multihop_offload_tpu_torch.scenarios.spec import (  # noqa: F401
    FailureEvent,
    MobilitySpec,
    ScenarioSpec,
    from_dict,
    from_json,
    spec_hash,
    to_dict,
    to_json,
)

__all__ = [
    "ScenarioSpec", "FailureEvent", "MobilitySpec",
    "to_dict", "from_dict", "to_json", "from_json", "spec_hash",
    "PRESETS", "NEW_FAMILIES", "preset", "preset_names",
    "ShiftSchedule", "shift",
]
