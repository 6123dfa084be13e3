"""The named scenario registry the matrix runs.

Port of `multihop_offload_tpu/scenarios/presets.py`: the same fourteen
presets, field for field, over the port's `TrafficModel` and
`ObjectiveWeights` (their hashes equal JAX's).

Fourteen presets spanning the three NEW topology families (grid, corridor,
two_tier) crossed with the traffic / heterogeneity / failure / mobility /
objective axes, plus the reference families (BA/WS/GRP/ER/poisson) under
the shifts the paper never applied to them.  Sizes are deliberately modest
(n ~ 16): the matrix pads every scenario to ONE shared shape, so every
preset runs through the same three fleet simulators.

Traffic timescales are in MODEL-TIME units (the simulator's virtual
seconds).  A scenario horizon is a few model-time units (dt ~ 1/(margin *
max link rate), a few thousand slots), so diurnal periods / flash windows /
MMPP dwells here are O(0.1..5) — the same shapes `loadgen` uses for
serving, compressed onto the sim horizon.

Add a family by (1) registering a generator in `graphs.generators`
(`(adj, pos)` contract), (2) adding presets here, (3) re-running
`python -m multihop_offload_tpu_torch.cli.scenarios --matrix`.  Nothing
downstream keys on the family name.
"""

from __future__ import annotations

from typing import Dict, List

from multihop_offload_tpu_torch.env.offloading import ObjectiveWeights
from multihop_offload_tpu_torch.loadgen.arrivals import TrafficModel
from multihop_offload_tpu_torch.scenarios.spec import (
    FailureEvent,
    MobilitySpec,
    ScenarioSpec,
)

_FLAT = TrafficModel(base_rate=1.0)
_MMPP = TrafficModel(base_rate=1.0, mmpp_burst_factor=4.0,
                     mmpp_dwell_slow_s=0.6, mmpp_dwell_fast_s=0.2)
_DIURNAL = TrafficModel(base_rate=1.0, diurnal_amplitude=0.6,
                        diurnal_period_s=2.0)
# flash windows sized to land inside a ~2-4 model-time-unit horizon
_FLASH = TrafficModel(base_rate=1.0, flashes=((0.8, 0.5, 3.0),))

_SPECS = (
    # -- reference families under paper-adjacent and shifted conditions ----
    ScenarioSpec(name="ba_poisson", family="ba", n_nodes=16,
                 topo_params=(("m", 2),), traffic=_FLAT),
    ScenarioSpec(name="ba_mmpp", family="ba", n_nodes=16,
                 topo_params=(("m", 2),), traffic=_MMPP),
    ScenarioSpec(name="ba_blast", family="ba", n_nodes=16,
                 topo_params=(("m", 2),), traffic=_FLAT,
                 failures=(FailureEvent(kind="node_blast", at_frac=0.5,
                                        hops=1),)),
    ScenarioSpec(name="ws_diurnal", family="ws", n_nodes=16,
                 topo_params=(("k", 4),), traffic=_DIURNAL),
    ScenarioSpec(name="er_hetero", family="er", n_nodes=16,
                 topo_params=(("degree", 5),), traffic=_FLAT,
                 mu_spread=0.6),
    ScenarioSpec(name="grp_flash", family="grp", n_nodes=16,
                 traffic=_FLASH),
    ScenarioSpec(name="poisson_mobility", family="poisson", n_nodes=16,
                 topo_params=(("nb", 6),), traffic=_FLAT,
                 mobility=MobilitySpec(n_moving=2, step_std=0.08,
                                       radius=1.0)),
    # -- grid / corridor: planned lattice deployments ----------------------
    ScenarioSpec(name="grid_poisson", family="grid", n_nodes=16,
                 traffic=_FLAT),
    ScenarioSpec(name="grid_flash_hetero", family="grid", n_nodes=16,
                 traffic=_FLASH, mu_spread=0.5),
    ScenarioSpec(name="grid_energy", family="grid", n_nodes=16,
                 traffic=_FLAT,
                 objective=ObjectiveWeights(transport_energy=0.5,
                                            compute_energy=0.2)),
    ScenarioSpec(name="corridor_mmpp", family="corridor", n_nodes=16,
                 topo_params=(("width", 2),), traffic=_MMPP),
    ScenarioSpec(name="corridor_links_fail", family="corridor", n_nodes=16,
                 topo_params=(("width", 2),), traffic=_FLAT,
                 failures=(FailureEvent(kind="links", at_frac=0.5,
                                        count=2),)),
    # -- two-tier edge/cloud: clustered access + cloud core ----------------
    ScenarioSpec(name="two_tier_poisson", family="two_tier", n_nodes=17,
                 topo_params=(("clusters", 3), ("core", 2)),
                 traffic=_FLAT, num_servers=2),
    ScenarioSpec(name="two_tier_hetero_mmpp", family="two_tier", n_nodes=17,
                 topo_params=(("clusters", 3), ("core", 2)),
                 traffic=_MMPP, mu_spread=0.6, num_servers=2),
)

PRESETS: Dict[str, ScenarioSpec] = {s.name: s for s in _SPECS}

NEW_FAMILIES = ("grid", "corridor", "two_tier")


def preset(name: str) -> ScenarioSpec:
    if name not in PRESETS:
        raise KeyError(
            f"unknown scenario preset '{name}' "
            f"(known: {', '.join(sorted(PRESETS))})"
        )
    return PRESETS[name]


def preset_names() -> List[str]:
    return list(PRESETS)
