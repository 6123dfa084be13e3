"""Realize a `ScenarioSpec` into the objects both evaluators consume.

Port of `multihop_offload_tpu/scenarios/build.py`.  One spec + one lane
index -> (Topology, Instance, JobSet) plus the failure schedules, all
deterministic per (spec, lane).  Every draw is numpy, in the JAX
package's order, so a realization equals JAX's bit for bit.  The SAME
realization feeds the analytic evaluator (`env.policies`) and the packet
simulator (`sim.FleetSim`).

Heterogeneous mu: the per-node service rates are the nominal
server/local rates times a seeded lognormal factor ``exp(N(0, mu_spread))``.

Correlated failures: `failure_schedules` lowers the spec's declarative
`FailureEvent`s onto `sim/`'s injection surface (`SimParams.fail_link_slot`
/ `fail_node_slot`, absolute slots, -1 = never).  A `node_blast` kills an
epicenter and its <=`hops`-hop neighborhood at one slot.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from multihop_offload_tpu_torch.graphs import generators
from multihop_offload_tpu_torch.graphs.instance import (
    Instance,
    JobSet,
    PadSpec,
    build_instance,
    build_jobset,
)
from multihop_offload_tpu_torch.graphs.topology import (
    Topology,
    build_topology,
    sample_link_rates,
)
from multihop_offload_tpu_torch.layouts.policy import resolve_layout
from multihop_offload_tpu_torch.scenarios.spec import ScenarioSpec

# lane seeds are spread apart so per-lane draws never collide with the
# densify-retry seed offsets inside graphs.generators
_LANE_STRIDE = 104729


@dataclasses.dataclass(frozen=True)
class Realization:
    """One lane's world: topology + padded instance + workload."""

    topo: Topology
    pos: Optional[np.ndarray]
    inst: Instance
    jobs: JobSet
    servers: np.ndarray          # (num_servers,) node ids
    proc_bws: np.ndarray         # (n,) the heterogeneous service rates


def lane_seed(spec: ScenarioSpec, lane: int) -> int:
    return spec.seed + _LANE_STRIDE * lane


def draw_topology(
    spec: ScenarioSpec, lane: int = 0
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Seeded (adj, pos) for one lane; bounded seed-retry to connectivity
    for the families that do not guarantee it (raw `poisson` draws)."""
    seed = lane_seed(spec, lane)
    for attempt in range(8):
        adj, pos = generators.generate(
            spec.family, spec.n_nodes, seed=seed + 7 * attempt,
            **spec.topo_kwargs,
        )
        if build_topology(adj, pos=pos).connected:
            return adj, pos
    raise ValueError(
        f"scenario '{spec.name}': family '{spec.family}' stayed "
        f"disconnected across 8 seeds"
    )


def realize(
    spec: ScenarioSpec, pad: PadSpec, lane: int = 0, dtype=torch.float32,
    layout=None, device=None,
) -> Realization:
    """Build one lane's instance + jobs on `device` (default CUDA, as
    `build_instance`).

    Server placement is degree-ranked (`sim.fidelity.make_case`'s rule).
    Job rates start uniform in [0.5, 1); the matrix rescales them to the
    spec's `util` target via the analytic bottleneck (`scale_to_util`)."""
    lay = resolve_layout(layout)
    seed = lane_seed(spec, lane)
    adj, pos = draw_topology(spec, lane)
    topo = build_topology(adj, pos=pos)
    rng = np.random.default_rng(seed)

    deg = np.asarray(topo.adj).sum(axis=1)
    servers = np.argsort(-deg, kind="stable")[: spec.num_servers]
    roles = np.zeros(spec.n_nodes, np.int32)
    roles[servers] = 1
    base_bw = np.where(roles == 1, spec.server_bw, spec.local_bw)
    # heterogeneous mu: seeded lognormal spread around the nominal rates
    spread = np.exp(rng.normal(0.0, spec.mu_spread, spec.n_nodes)) \
        if spec.mu_spread > 0 else np.ones(spec.n_nodes)
    proc_bws = base_bw * spread

    rates = sample_link_rates(topo, spec.link_rate, rng=rng)
    inst = build_instance(topo, roles, proc_bws, rates, 1000.0, pad,
                          dtype=dtype, device=device, layout=lay)

    mobile = np.setdiff1d(np.arange(spec.n_nodes, dtype=np.int64), servers)
    srcs = rng.choice(mobile, size=min(spec.num_jobs, mobile.size),
                      replace=False)
    jrates = rng.uniform(0.5, 1.0, srcs.size)
    jobs = build_jobset(srcs, jrates, pad_jobs=pad.j, dtype=dtype, device=device,
                        index_dtype=lay.index_dtype)
    return Realization(topo=topo, pos=pos, inst=inst, jobs=jobs,
                       servers=servers, proc_bws=proc_bws)


def failure_schedules(
    spec: ScenarioSpec, real: Realization, pad: PadSpec, total_slots: int,
    lane: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lower the spec's `FailureEvent`s onto (fail_link_slot (L,),
    fail_node_slot (N,)) absolute-slot schedules (-1 = never)."""
    rng = np.random.default_rng(lane_seed(spec, lane) + 1)
    fail_link = np.full((pad.l,), -1, np.int32)
    fail_node = np.full((pad.n,), -1, np.int32)
    src = real.jobs.src.cpu().numpy()
    mask = real.jobs.mask.cpu().numpy()
    protected = set(int(s) for s in real.servers) | set(int(s) for s in src[mask])
    adj = np.asarray(real.topo.adj, bool)
    for ev in spec.failures:
        slot = int(ev.at_frac * total_slots)
        if ev.kind == "links":
            cand = np.arange(real.topo.num_links)
            kill = rng.choice(cand, size=min(ev.count, cand.size),
                              replace=False)
            fail_link[kill] = slot
        else:  # node_blast: epicenter + <=hops-hop neighborhood, one slot
            cand = np.array([i for i in range(spec.n_nodes)
                             if i not in protected], np.int64)
            if cand.size == 0:
                continue
            epicenter = int(rng.choice(cand))
            blast = np.zeros(spec.n_nodes, bool)
            blast[epicenter] = True
            frontier = blast.copy()
            for _ in range(ev.hops):
                frontier = (adj[frontier].any(axis=0)) & ~blast
                blast |= frontier
            blast[list(protected)] = False   # the blast never kills
            fail_node[np.flatnonzero(blast)] = slot   # servers/sources
    return fail_link, fail_node


def mobility_step(
    spec: ScenarioSpec, real: Realization, pad: PadSpec, dtype=None,
    layout=None, rng: Optional[np.random.Generator] = None,
):
    """One mobility re-wiring: random-walk the positions, rebuild the
    topology/instance at the SAME pad (on the instance's device, in its
    dtype unless `dtype` is given), and return (new Realization,
    link_map); `link_map` feeds `sim.state.migrate_sim_state`."""
    from multihop_offload_tpu_torch.graphs.mobility import (
        random_walk,
        topology_update,
    )

    if spec.mobility is None or real.pos is None:
        raise ValueError("mobility_step needs spec.mobility and geometry")
    lay = resolve_layout(layout)
    mob = spec.mobility
    rng = rng or np.random.default_rng(lane_seed(spec, 0) + 2)
    new_pos, new_adj = random_walk(
        real.pos, n_moving=mob.n_moving, step_std=mob.step_std,
        radius=mob.radius, rng=rng,
    )
    new_topo, link_map = topology_update(real.topo, new_adj, pos=new_pos)
    roles = np.zeros(spec.n_nodes, np.int32)
    roles[real.servers] = 1
    new_rates = sample_link_rates(new_topo, spec.link_rate, rng=rng)
    inst = build_instance(new_topo, roles, real.proc_bws, new_rates, 1000.0,
                          pad, dtype=dtype or real.inst.link_rates.dtype,
                          device=real.inst.link_rates.device, layout=lay)
    new_real = dataclasses.replace(real, topo=new_topo, pos=new_pos,
                                   inst=inst)
    return new_real, link_map
