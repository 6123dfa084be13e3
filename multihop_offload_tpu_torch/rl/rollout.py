"""Differentiable closed-loop rollout: the actor and the packet simulator.

Port of `multihop_offload_tpu/rl/rollout.py`, batched over a leading fleet
axis B (JAX runs one lane under `vmap`).  An episode is `rounds` policy
rounds; each re-decides the offloads from the empirical arrival rates of
the round before (the measured-traffic contract of `sim.runner.simulate`),
then advances the simulator `slots_per_round` slots
(`sim.step.sim_slot_step`), all on the run's device.

The simulator is discrete, so the policy gradient is score-function
(REINFORCE), not pathwise.  Each round the actor's unit delays price the
(J, S+1) offload cost table (`env.offloading.offload_decide`); the table
becomes a temperature-scaled categorical over destinations, a destination
is sampled (Gumbel-max: `jax.random.categorical` is the argmax of the
logits plus Gumbel noise), and the round's log-probability is kept.
Rewards come from the simulator's conservation counters (delivered ratio
minus a delay penalty, per round), and the surrogate loss of a lane is

    loss = - sum_r  logp_r * (reward_r - baseline) - ent_weight * sum_r ent_r

so gradients flow only through the log-probabilities: through the cost
table, the APSP (`apsp_minplus(early_stop=False)`: K2 and K2's backward on
the card), the interference fixed point (K1) and the GNN (K4 both ways
under the sparse layout).  The next-hop table and the sampled destination
are built on detached values, and the slots run without the tape.

Draws: a round takes the slot uniforms (tie, link, srv, arr) of a sim draw
source (`sim.runner.LaneDraws`, one generator per lane, or
`sim.runner.InjectedDraws`) and Gumbel noise (B, J, S+1), injected (the
tests rebuild JAX's from its key tree) or drawn from the lanes'
generators after the round's slot uniforms.

Both layouts: under the sparse layout W comes from the link list
(`weight_matrix_from_edges`) and is squared like the dense one (JAX
`:137-145`, not the COO-fed kernel), the node diagonal from the actor's
per-node delays, and next hops from the edge list.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from multihop_offload_tpu_torch._records import TensorRecord
from multihop_offload_tpu_torch.agent.actor import actor_delay_matrix, default_support
from multihop_offload_tpu_torch.env.apsp import (
    apsp_minplus,
    next_hop_table,
    weight_matrix_from_link_delays,
)
from multihop_offload_tpu_torch.env.offloading import _uniform, offload_decide
from multihop_offload_tpu_torch.layouts.compact import pack_next_hop
from multihop_offload_tpu_torch.layouts.policy import resolve_layout
from multihop_offload_tpu_torch.layouts.sparse import (
    next_hop_from_edges,
    weight_matrix_from_edges,
)
from multihop_offload_tpu_torch.sim.state import SimRoutes, SimState, liveness_masks
from multihop_offload_tpu_torch.sim.step import sim_slot_step


@dataclasses.dataclass
class RoundDeltas(TensorRecord):
    """Per-round counter deltas, (B, R) after the rounds: the integers the
    reward is computed from."""

    generated: torch.Tensor   # int32 packets born in the round
    delivered: torch.Tensor   # int32 packets delivered in the round
    dropped: torch.Tensor     # int32 packets lost in the round
    delay_sum: torch.Tensor   # float end-to-end slots summed in the round


@dataclasses.dataclass
class RolloutOut(TensorRecord):
    """Everything an episode batch returns besides the surrogate losses."""

    state: SimState          # terminal sim state, counters cumulative
    rewards: torch.Tensor    # (B, R) per-round rewards (no gradient)
    logps: torch.Tensor      # (B, R) per-round summed action log-probs
    ents: torch.Tensor       # (B, R) per-round summed policy entropies
    deltas: RoundDeltas      # (B, R) counter deltas behind `rewards`
    dsts: torch.Tensor       # (B, R, J) int32 sampled destinations
    routes: SimRoutes        # (B, R, ...) forwarding decisions in force
    dev: Any = None          # sim devmetrics accumulators of the episode


def reward_from_deltas(gen_d, del_d, delay_d, dt, delay_weight):
    """Delivered ratio minus `delay_weight` times the mean delivered-packet
    delay in model-time units, from one round's counter deltas;
    denominators clamp at one packet, so idle rounds score zero."""
    fdt = delay_d.dtype
    gen = gen_d.to(fdt)
    dlv = del_d.to(fdt)
    ratio = dlv / torch.clamp_min(gen, 1.0)
    mean_delay = delay_d * dt.to(fdt) / torch.clamp_min(dlv, 1.0)
    return ratio - delay_weight * mean_delay


def gumbel_noise(gens, shape, dtype, device) -> torch.Tensor:
    """Gumbel(0, 1) noise of `shape` (leading axis the lanes), from one
    generator per lane: -log(-log(u)), u uniform in [tiny, 1), as
    `jax.random.gumbel` makes it."""
    u = _uniform(shape, gens, dtype, device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))


def sample_offloads(model, params, inst, jobs_est, support, node_up, link_up, gumbel,
                    temperature: float, layout=None):
    """One differentiable policy decision for the batch: (routes, logp (B,),
    entropy (B,), choice (B, J) int32).  `params` (name -> (B, *shape)
    per-lane copies, or None for the model's own) go through the actor;
    `gumbel` is the noise (B, J, S+1) or the lanes' generators to draw it
    from.  The actor, the APSP and the cost table stay on the tape; the
    forwarding table and the destinations are built on detached values."""
    lay = resolve_layout(layout)
    actor = actor_delay_matrix(model, inst, jobs_est, support, params)
    inf = torch.full((), float("inf"), dtype=actor.link_delay.dtype,
                     device=actor.link_delay.device)
    if lay.sparse:
        unit_diag = torch.where(inst.comp_mask, actor.node_delay, inf)
    else:
        unit_diag = torch.diagonal(actor.delay_matrix, dim1=1, dim2=2)
    link_delay = torch.where(link_up, actor.link_delay, inf)
    unit_diag = torch.where(node_up, unit_diag, inf)
    if lay.sparse:
        w = weight_matrix_from_edges(inst.link_ends, inst.link_mask, link_delay,
                                     inst.num_pad_nodes)
    else:
        w = weight_matrix_from_link_delays(inst.adj, inst.link_index, link_delay)
    # the fixed schedule on the tape: the log-prob differentiates through
    # the path costs (the early stop is not reverse-differentiable)
    sp = apsp_minplus(w, early_stop=False)
    # the shared decision skeleton prices every (job, server | local)
    # option; its greedy choice is ignored
    dec = offload_decide(inst, jobs_est, sp, inst.hop, unit_diag)
    valid = torch.isfinite(dec.costs)
    neg_inf = torch.full((), float("-inf"), dtype=dec.costs.dtype, device=sp.device)
    logits = torch.where(valid, -dec.costs / temperature, neg_inf)
    noise = (gumbel if isinstance(gumbel, torch.Tensor)
             else gumbel_noise(gumbel, logits.shape, logits.dtype, logits.device))
    choice = torch.argmax(logits.detach() + noise.to(logits.dtype), dim=2)      # (B, J)
    logp_all = torch.log_softmax(logits, dim=2)
    logp_j = torch.gather(logp_all, 2, choice.unsqueeze(2)).squeeze(2)
    logp = torch.where(jobs_est.mask, logp_j, 0.0).sum(1)
    # policy entropy (invalid options carry p = 0 exactly); mask before the
    # product: p * logp at an invalid entry is 0 * -inf (NaN), and a forward
    # NaN, even a masked one, poisons the backward pass
    safe_logp = torch.where(valid, logp_all, 0.0)
    ent_j = -(torch.exp(safe_logp) * safe_logp * valid).sum(2)
    entropy = torch.where(jobs_est.mask, ent_j, 0.0).sum(1)

    with torch.no_grad():
        b, n, _ = sp.shape
        servers = inst.servers.long()
        num_srv = servers.shape[1]
        src = jobs_est.src.long()
        picked = torch.gather(servers, 1, choice.clamp(0, num_srv - 1))
        dst = torch.where(choice >= num_srv, src, picked)
        sp_s = sp.detach()
        # a destination unreachable from the source degrades to local
        # compute (sampling cannot pick it: its cost is +inf)
        reachable = (torch.isfinite(torch.gather(sp_s.reshape(b, n * n), 1, src * n + dst))
                     & torch.gather(node_up, 1, dst))
        dst = torch.where(reachable, dst, src)
        nh = (next_hop_from_edges(inst.link_ends, inst.link_mask, sp_s) if lay.sparse
              else next_hop_table(inst.adj, sp_s))
        routes = SimRoutes(dst=dst.to(torch.int32), next_hop=pack_next_hop(nh),
                           reach=torch.isfinite(sp_s))
    return routes, logp, entropy, choice.to(torch.int32)


def rollout(
    model,
    params,
    inst,
    jobs,
    spec,
    sim_params,
    state0: SimState,
    init_rates: torch.Tensor,
    draws,
    baseline,
    rounds: int,
    slots_per_round: int,
    temperature: float = 1.0,
    delay_weight: float = 0.05,
    ent_weight: float = 0.0,
    support=None,
    dm=None,
    layout=None,
    gumbel: torch.Tensor | None = None,
):
    """One episode per lane.  Returns (loss (B,), RolloutOut): `loss` is
    each lane's REINFORCE surrogate against `baseline` (a scalar, the
    replay buffer's running reward mean), differentiable with respect to
    `params`.  Round 0 decides on `init_rates`, later rounds on the rates
    measured over the round before.  `draws`: a sim draw source; `gumbel`
    (B, R, J, S+1) injects the decision noise, else it is drawn from the
    draw source's per-lane generators; `dm`: a `sim_devmetrics`
    declaration, its per-lane window returned in `RolloutOut.dev`."""
    lay = resolve_layout(layout)
    if support is None:
        support = default_support(model, inst, layout=lay)
    j = spec.num_jobs
    fdt = state0.delay_sum.dtype
    fleet = state0.t.shape[0]
    dev = dm.init((fleet,), device=state0.t.device) if dm is not None else None
    st, prev_gen = state0, state0.generated
    logps, ents, rewards, deltas, routes_r = [], [], [], [], []
    for r in range(rounds):
        gens, (tie, link, srv, arr) = draws.round(r, slots_per_round)
        node_up, link_up = liveness_masks(inst, sim_params, st.t)
        if r == 0:
            est = init_rates.to(fdt)
        else:
            window = (st.generated - prev_gen)[:, :j].to(fdt)
            denom = ((slots_per_round * sim_params.dt.to(fdt)).unsqueeze(1)
                     * torch.clamp_min(jobs.ul.to(fdt), 1e-9))
            est = window / denom
        jobs_est = dataclasses.replace(jobs, rate=est.to(jobs.rate.dtype))
        if gumbel is not None:
            noise = gumbel[:, r]
        elif gens is None:
            raise ValueError("injected slot draws carry no generator: inject the Gumbel "
                             "noise too")
        else:
            noise = gens
        routes, logp, ent, _ = sample_offloads(model, params, inst, jobs_est, support,
                                               node_up, link_up, noise, temperature,
                                               layout=lay)
        prev_gen = st.generated
        start = st
        with torch.no_grad():
            for k in range(slots_per_round):
                step_draws = (tie[k], link[k], srv[k], arr[k])
                if dm is None:
                    st, _ = sim_slot_step(inst, spec, sim_params, routes, jobs, st, step_draws)
                else:
                    st, _, dev = sim_slot_step(inst, spec, sim_params, routes, jobs, st,
                                               step_draws, dm=dm, dev=dev)
            i32 = torch.int32
            d = RoundDeltas(
                generated=(st.generated - start.generated).sum(1, dtype=i32),
                delivered=(st.delivered - start.delivered).sum(1, dtype=i32),
                dropped=(st.dropped - start.dropped).sum(1, dtype=i32),
                delay_sum=(st.delay_sum - start.delay_sum).sum(1),
            )
            rewards.append(reward_from_deltas(d.generated, d.delivered, d.delay_sum,
                                              sim_params.dt, delay_weight))
        logps.append(logp)
        ents.append(ent)
        deltas.append(d)
        routes_r.append(routes)
    logps, ents, rewards = (torch.stack(x, dim=1) for x in (logps, ents, rewards))
    adv = rewards - torch.as_tensor(baseline, dtype=rewards.dtype, device=rewards.device)
    loss = -(logps * adv).sum(1) - ent_weight * ents.sum(1)

    def per_round(items, field):
        return torch.stack([getattr(x, field) for x in items], dim=1)

    return loss, RolloutOut(
        state=st, rewards=rewards, logps=logps, ents=ents,
        deltas=RoundDeltas(**{f.name: per_round(deltas, f.name)
                              for f in dataclasses.fields(RoundDeltas)}),
        dsts=per_round(routes_r, "dst"),
        routes=SimRoutes(**{f.name: per_round(routes_r, f.name)
                            for f in dataclasses.fields(SimRoutes)}),
        dev=dev,
    )
