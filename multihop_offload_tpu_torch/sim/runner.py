"""Closed-loop fleet simulation: rounds of policy decisions and slots.

Port of `multihop_offload_tpu/sim/runner.py`.  The JAX package compiles a
scan over rounds of a scan over slots, vmapped over the fleet; here the
same loop runs eagerly over the batched fleet:

    for each policy round                    # R rounds
        policy_fn(inst, jobs_est, ...)       # re-decide on measured rates
        for each slot                        # K slots of sim_slot_step

`jobs_est` replaces the true arrival rates with the previous round's
measured ``packets_generated / (K * dt * ul)``, so every policy decides on
what it could observe; round 0 takes the caller's `init_rates` (true rates
for fidelity studies, zeros for a cold start).

Draws: each round takes the policy's generator(s) and, for every slot,
the four uniform tensors of `sim_slot_step` from a draw source.
`LaneDraws`, the default, keeps one `torch.Generator` per lane on the
run's device, so a lane's result does not depend on which lanes share its
fleet; `InjectedDraws` replays given tensors (the tests build them from
the JAX key tree).

Mobility re-wiring is host work, so a run is segmented: `FleetSim.run`
again from the state `sim.state.migrate_sim_state` carried across the new
topology, with the same padded shapes.

Each `FleetSim` wraps its run as the prof-layer program `sim/scan` (JAX
`:179`): counted on the first segment, accounted once the span's sync
has completed each segment (JAX `:215`).  The count takes one policy call
and one slot step and adds their facts for the rest of the schedule
(`obs.prof.RepeatedUnits`), so a 25,000-slot sweep costs its count no
more than a short run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Sequence

import torch

from multihop_offload_tpu_torch._records import TensorRecord
from multihop_offload_tpu_torch.obs import prof as obs_prof
from multihop_offload_tpu_torch.obs import trace as obs_trace
from multihop_offload_tpu_torch.obs.registry import registry
from multihop_offload_tpu_torch.obs.spans import span
from multihop_offload_tpu_torch.sim.state import (
    SimRoutes,
    SimSpec,
    SimState,
    init_state,
    liveness_masks,
)
from multihop_offload_tpu_torch.sim.step import sim_devmetrics, sim_slot_step


@dataclasses.dataclass
class SimRun(TensorRecord):
    """Result of one simulated segment of a fleet (leading axis B)."""

    state: SimState                # final state, all counters cumulative
    routes: SimRoutes              # last policy decision in force
    est_rates: torch.Tensor        # (B, R, J) per-round rate estimates
    sched: Optional[torch.Tensor]  # (B, R, K, L) bool schedule trace, if collected
    dev: Any = None                # devmetrics accumulators of THIS segment


def _widths(spec: SimSpec) -> tuple:
    """Widths of a slot's four draws: tie (L), link (L), srv (N), arr (2J)."""
    return (spec.num_links, spec.num_links, spec.num_nodes, spec.num_streams)


class LaneDraws:
    """One `torch.Generator` per lane, seeded from `seeds`, on `device`.
    A round draws each lane's (K, L + L + N + 2J) uniforms in one call;
    the policy takes the same generators (one per lane)."""

    def __init__(self, seeds: Sequence[int], spec: SimSpec, dtype=torch.float32,  # fp32-island(draws at the sim's float32 accumulators)
                 device="cpu"):
        self.gens = [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]
        self.spec, self.dtype, self.device = spec, dtype, device

    def round(self, r: int, slots: int):
        """(policy generators, (tie, link, srv, arr) each (K, B, width))."""
        widths = _widths(self.spec)
        u = torch.stack([torch.rand((slots, sum(widths)), generator=g, dtype=self.dtype,
                                    device=self.device) for g in self.gens], dim=1)
        return self.gens, torch.split(u, widths, dim=2)


class InjectedDraws:
    """Given draws: `tie`, `link`, `srv`, `arr` of shape (B, R, K, width)
    (widths L, L, N, 2J); no policy generator (the policies decide
    greedily and read none)."""

    def __init__(self, tie, link, srv, arr):
        self.draws = (tie, link, srv, arr)

    def round(self, r: int, slots: int):
        out = tuple(x[:, r, :slots].transpose(0, 1) for x in self.draws)
        return None, out


def simulate(
    inst,
    jobs,
    spec: SimSpec,
    params,
    policy_fn: Callable,
    state: SimState,
    init_rates: torch.Tensor,
    draws,
    rounds: int,
    slots_per_round: int,
    dm,
    collect_schedule: bool = False,
) -> SimRun:
    """Run `rounds * slots_per_round` slots on a fleet from `state`, with
    `draws` a draw source (`LaneDraws`, `InjectedDraws`).  The per-slot
    accumulators of the `sim_devmetrics` declaration `dm` (one per lane)
    come back as `SimRun.dev`: one window per segment, from zero."""
    j = spec.num_jobs
    fleet = state.t.shape[0]
    fdt = state.delay_sum.dtype
    dev = dm.init((fleet,), device=state.t.device)
    ests, scheds = [], []
    st, routes, prev_gen = state, None, state.generated
    units = obs_prof.RepeatedUnits()   # a counted run counts one policy call, one slot
    with torch.no_grad():
        for r in range(rounds):
            gen, (tie, link, srv, arr) = draws.round(r, slots_per_round)
            node_up, link_up = liveness_masks(inst, params, st.t)
            if r == 0:
                est = init_rates.to(fdt)
            else:
                window = (st.generated - prev_gen)[:, :j].to(fdt)
                denom = ((slots_per_round * params.dt.to(fdt)).unsqueeze(1)
                         * torch.clamp_min(jobs.ul.to(fdt), 1e-9))
                est = window / denom
            ests.append(est)
            jobs_est = dataclasses.replace(jobs, rate=est.to(jobs.rate.dtype))
            with units.unit("policy"):
                routes = policy_fn(inst, jobs_est, node_up, link_up, gen)
            prev_gen = st.generated
            for k in range(slots_per_round):
                with units.unit("slot"):
                    st, sched, dev = sim_slot_step(inst, spec, params, routes, jobs, st,
                                                   (tie[k], link[k], srv[k], arr[k]),
                                                   dm=dm, dev=dev)
                if collect_schedule:
                    scheds.append(sched)
    sched = None
    if collect_schedule:
        sched = torch.stack(scheds, dim=1).view(fleet, rounds, slots_per_round, -1)
    return SimRun(state=st, routes=routes, est_rates=torch.stack(ests, dim=1),
                  sched=sched, dev=dev)


class FleetSim:
    """Driver of a fleet of same-shaped instances.

    The spec, policy, horizon and schedule collection are fixed at
    construction; `run` only feeds tensors.  Instrumented through `obs`:
    `sim/build` wraps construction, `sim/scan` each segment (it waits for
    the card), and the `mho_sim_*` metrics accumulate across segments."""

    def __init__(
        self,
        spec: SimSpec,
        policy_fn: Callable,
        rounds: int,
        slots_per_round: int,
        collect_schedule: bool = False,
        dtype=torch.float32,  # fp32-island(sim accumulators; precision only narrows the policy APSP)
    ):
        with span("sim/build", rounds=rounds, slots=slots_per_round):
            self.spec = spec
            self.policy_fn = policy_fn
            self.rounds = rounds
            self.slots_per_round = slots_per_round
            self.collect_schedule = collect_schedule
            self.dtype = dtype
            self.devmetrics = sim_devmetrics(spec)
            self.last_devmetrics: dict | None = None
            self._fn = obs_prof.wrap("sim/scan", simulate)

    def init_states(self, fleet: int, device="cpu") -> SimState:
        return init_state(self.spec, fleet, self.dtype, device)

    def run(
        self,
        insts,
        jobss,
        paramss,
        draws,
        states: SimState | None = None,
        init_rates: torch.Tensor | None = None,
        request_ids=None,
        tag: str = "",
    ) -> SimRun:
        """Simulate one segment of the whole (stacked) fleet.  `draws` is
        one seed per lane (`LaneDraws` on the instances' device) or a draw
        source.  `request_ids` (one per lane) stamps a per-lane
        ``sim_outcome`` trace hop."""
        fleet = insts.adj.shape[0]
        device = insts.adj.device
        if not hasattr(draws, "round"):
            draws = LaneDraws(draws, self.spec, self.dtype, device)
        if states is None:
            states = self.init_states(fleet, device)
        if init_rates is None:
            init_rates = torch.zeros((fleet, self.spec.num_jobs), dtype=self.dtype,
                                     device=device)
        prev = [int(states.generated.sum()), int(states.delivered.sum()),
                int(states.dropped.sum())]
        t0 = time.perf_counter()  # nondet-ok(device-time accounting is a measurement)
        with span("sim/scan", block=True, fleet=fleet):
            out = self._fn(insts, jobss, self.spec, paramss, self.policy_fn, states,
                           init_rates, draws, self.rounds, self.slots_per_round,
                           self.devmetrics, self.collect_schedule)
        self._fn.account(time.perf_counter() - t0)  # nondet-ok(same measurement)
        st = out.state
        reg = registry()
        reg.counter("mho_sim_slots_total", "simulated slots across the fleet").inc(
            fleet * self.rounds * self.slots_per_round)
        reg.counter("mho_sim_policy_rounds_total", "policy re-decisions executed").inc(
            fleet * self.rounds)
        reg.counter("mho_sim_packets_generated_total", "packets born").inc(
            int(st.generated.sum()) - prev[0])
        reg.counter("mho_sim_packets_delivered_total", "packets delivered end to end").inc(
            int(st.delivered.sum()) - prev[1])
        reg.counter("mho_sim_packets_dropped_total", "packets lost").inc(
            int(st.dropped.sum()) - prev[2])
        reg.gauge("mho_sim_in_flight", "packets queued at segment end").set(
            int(st.count[:, :-1].sum()))
        # one fetch at the sync the span above already paid for; the
        # fleet's lanes merge into one window
        self.last_devmetrics = self.devmetrics.flush(out.dev, reg=reg)
        if request_ids:
            obs_trace.hop(
                "sim_outcome", request_ids, tag=tag,
                delivered=st.delivered.sum(dim=1).tolist(),
                dropped=st.dropped.sum(dim=1).tolist(),
                generated=st.generated.sum(dim=1).tolist(),
            )
        return out
