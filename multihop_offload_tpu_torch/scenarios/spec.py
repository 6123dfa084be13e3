"""`ScenarioSpec`: one frozen, JSON-round-trippable answer to "which world
are we in".

Port of `multihop_offload_tpu/scenarios/spec.py` (numpy and the standard
library only).  The canonical JSON, and so every `spec_hash`, equals the
JAX package's letter for letter: the nested dataclasses here carry the
same fields in the same order.

The paper (and the repo's other harnesses) evaluate on BA graphs with
Poisson-ish arrivals and homogeneous servers.  A `ScenarioSpec` names every
axis the scenario matrix stresses instead:

  * topology family + family params (`graphs.generators.GENERATORS`,
    incl. the planned `grid` / `corridor` / `two_tier` families);
  * traffic shape (`loadgen.arrivals.TrafficModel`: MMPP bursts, diurnal
    swing, flash crowds) — `base_rate` is RELATIVE (the matrix pins the
    absolute load via the analytic `util` target, then modulates it with
    `loadgen.rate_profile`);
  * per-node heterogeneous server rates from a seeded lognormal spread
    (`mu_spread` = sigma of log-rate);
  * a mobility schedule and a correlated-failure schedule extending
    `sim/`'s failure injection (`SimParams.fail_link_slot/fail_node_slot`);
  * energy/cost-weighted objective knobs (`env.offloading.ObjectiveWeights`).

Everything is a frozen dataclass; `to_json`/`from_json` round-trip exactly
and `spec_hash` is a stable content hash over the canonical JSON — the
identity the committed matrix record and the drift campaign key on.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional, Tuple

from multihop_offload_tpu_torch.env.offloading import ObjectiveWeights
from multihop_offload_tpu_torch.graphs.generators import GENERATORS
from multihop_offload_tpu_torch.loadgen.arrivals import TrafficModel

# families whose generators return real coordinates — the precondition for
# a mobility schedule (re-wiring is unit-disk over the moved positions)
GEOMETRIC_FAMILIES = ("poisson", "grid", "corridor", "two_tier")


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One scheduled failure, extending `sim/`'s injection surface.

    kind "links": kill `count` random real links at `at_frac` of the
    horizon (the existing `cli.sim` drill, made declarative).
    kind "node_blast": the CORRELATED failure the paper never models — an
    epicenter node plus every node within `hops` hops dies at the same
    slot (regional power loss / jamming), seeded per lane.  Servers and
    job sources are never chosen as the epicenter.
    """

    kind: str = "links"          # "links" | "node_blast"
    at_frac: float = 0.5         # fraction of the total slot horizon
    count: int = 1               # links to kill (kind="links")
    hops: int = 1                # blast radius in hops (kind="node_blast")

    def __post_init__(self):
        if self.kind not in ("links", "node_blast"):
            raise ValueError(f"unknown failure kind '{self.kind}'")
        if not 0.0 < self.at_frac < 1.0:
            raise ValueError("at_frac must be in (0, 1)")
        if self.count < 1 or self.hops < 0:
            raise ValueError("count >= 1 and hops >= 0 required")


@dataclasses.dataclass(frozen=True)
class MobilitySpec:
    """Random-walk mobility applied between sim segments (geometric
    families only): `n_moving` nodes jitter by N(0, step_std) per segment
    boundary and the topology re-wires unit-disk, with queue state carried
    across via `sim.state.migrate_sim_state` (stranded packets are counted
    drops — conservation stays exact)."""

    n_moving: int = 2
    step_std: float = 0.1
    radius: float = 1.2          # unit-disk re-wiring radius

    def __post_init__(self):
        if self.n_moving < 1 or self.step_std <= 0 or self.radius <= 0:
            raise ValueError("mobility needs n_moving >= 1, step_std > 0, "
                             "radius > 0")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """The frozen world description (see module docstring)."""

    name: str
    family: str = "ba"
    n_nodes: int = 16
    topo_params: Tuple[Tuple[str, float], ...] = ()
    seed: int = 0
    num_jobs: int = 4
    num_servers: int = 2
    util: float = 0.5            # analytic bottleneck-rho the load is pinned to
    traffic: TrafficModel = TrafficModel(base_rate=1.0)
    mu_spread: float = 0.0       # lognormal sigma of the per-node rate spread
    server_bw: float = 100.0     # nominal server service rate
    local_bw: float = 8.0        # nominal mobile-node service rate
    link_rate: float = 50.0      # nominal link rate (jittered per link)
    failures: Tuple[FailureEvent, ...] = ()
    mobility: Optional[MobilitySpec] = None
    objective: ObjectiveWeights = ObjectiveWeights()

    def __post_init__(self):
        if self.family not in GENERATORS:
            raise ValueError(
                f"unknown topology family '{self.family}' "
                f"(known: {', '.join(sorted(GENERATORS))})"
            )
        if self.n_nodes < 4:
            raise ValueError("n_nodes must be >= 4")
        if not 1 <= self.num_servers < self.n_nodes:
            raise ValueError("need 1 <= num_servers < n_nodes")
        if self.num_jobs < 1:
            raise ValueError("num_jobs must be >= 1")
        if not 0.0 < self.util < 1.0:
            raise ValueError("util must be in (0, 1)")
        if self.mu_spread < 0.0:
            raise ValueError("mu_spread must be >= 0")
        if min(self.server_bw, self.local_bw, self.link_rate) <= 0:
            raise ValueError("rates must be positive")
        if self.mobility is not None and self.family not in GEOMETRIC_FAMILIES:
            raise ValueError(
                f"mobility needs a geometric family {GEOMETRIC_FAMILIES}; "
                f"'{self.family}' has no coordinates"
            )
        for k, _ in self.topo_params:
            if not isinstance(k, str):
                raise ValueError("topo_params keys must be strings")

    @property
    def topo_kwargs(self) -> dict:
        return dict(self.topo_params)


# ---------------------------------------------------------------------------
# JSON round-trip + content hash
# ---------------------------------------------------------------------------

def to_dict(spec: ScenarioSpec) -> dict:
    """Plain nested dict (lists for tuples) — `json.dumps`-ready."""
    return dataclasses.asdict(spec)


def from_dict(d: dict) -> ScenarioSpec:
    """Inverse of `to_dict`; rebuilds the nested frozen dataclasses and
    restores tuple-ness so round-tripped specs compare equal."""
    d = dict(d)
    d["topo_params"] = tuple(
        (str(k), v) for k, v in (d.get("topo_params") or ())
    )
    t = d.get("traffic")
    if isinstance(t, dict):
        t = dict(t)
        t["flashes"] = tuple(tuple(f) for f in (t.get("flashes") or ()))
        d["traffic"] = TrafficModel(**t)
    d["failures"] = tuple(
        f if isinstance(f, FailureEvent) else FailureEvent(**f)
        for f in (d.get("failures") or ())
    )
    mob = d.get("mobility")
    if isinstance(mob, dict):
        d["mobility"] = MobilitySpec(**mob)
    obj = d.get("objective")
    if isinstance(obj, dict):
        d["objective"] = ObjectiveWeights(**obj)
    return ScenarioSpec(**d)


def to_json(spec: ScenarioSpec) -> str:
    """Canonical JSON: sorted keys, no whitespace drift — the hash input."""
    return json.dumps(to_dict(spec), sort_keys=True, separators=(",", ":"))


def from_json(s: str) -> ScenarioSpec:
    return from_dict(json.loads(s))


def spec_hash(spec: ScenarioSpec) -> str:
    """Stable 12-hex content id over the canonical JSON (name included —
    two presets differing only in name are different matrix rows)."""
    return hashlib.sha256(to_json(spec).encode()).hexdigest()[:12]
