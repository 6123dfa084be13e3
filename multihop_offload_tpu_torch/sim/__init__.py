"""Discrete-time packet-level network simulator (closed-loop evaluation).

Port of `multihop_offload_tpu/sim/`.  The analytic evaluator
(`env.queueing`) scores a routing decision with steady-state M/M/1
formulas; this package replays the same system packet by packet (slotted
time, per-link and per-server FIFO ring buffers, MWIS link activation,
multi-hop forwarding, Bernoulli arrivals) over a batched fleet, with the
offloading policy re-run every round on the measured arrival rates.
`sim.fidelity` measures where the two models agree.
"""

from multihop_offload_tpu_torch.sim.policies import POLICY_KINDS, make_policy
from multihop_offload_tpu_torch.sim.runner import FleetSim, SimRun, simulate
from multihop_offload_tpu_torch.sim.state import (
    SimParams,
    SimRoutes,
    SimSpec,
    SimState,
    build_sim_params,
    conservation_gap,
    in_flight,
    init_state,
    liveness_masks,
    migrate_sim_state,
    spec_for,
)
from multihop_offload_tpu_torch.sim.step import sim_slot_step

__all__ = [
    "POLICY_KINDS",
    "FleetSim",
    "SimParams",
    "SimRoutes",
    "SimRun",
    "SimSpec",
    "SimState",
    "build_sim_params",
    "conservation_gap",
    "in_flight",
    "init_state",
    "liveness_masks",
    "make_policy",
    "migrate_sim_state",
    "sim_slot_step",
    "simulate",
    "spec_for",
]
