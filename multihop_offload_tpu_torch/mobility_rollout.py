"""Dynamic-topology rollout: offloading policies under node mobility,
scored by the packet-level simulator.

The port's counterpart of `scripts/mobility_rollout.py`: a Poisson-disk
network whose nodes random-walk each step; per step the conflict structure
is rebuilt on the host (`graphs.mobility`), link capacities and the
simulators' in-flight queues migrate across the old -> new link map
(`sim.migrate_sim_state`: packets stranded on vanished links are counted
as drops), and each policy (baseline, local, GNN) runs a closed-loop
`FleetSim` segment on the new topology.  A step's tau is the analytic
job-total formula with the segment's empirical per-channel delays in
place of 1/(mu - lambda) (`sim.fidelity.composed_job_tau`; channels served
fewer than `--min_served` times keep the analytic delay); the analytic
taus are reported beside it.  Pads are fixed up front (1.8x the first
topology's links), so every step runs the same shapes.

    python -m multihop_offload_tpu_torch.mobility_rollout [--device cpu] [--n 30]
        [--steps 10] [--moving 4] [--step_std 0.08] [--load 0.15] [--T 1000]
        [--k 1] [--seed 0] [--rounds 2] [--slots 800] [--margin 5] [--cap 128]
        [--min_served 30] [--out FILE]

It runs on CUDA unless `--device cpu` is given (the decisions: K1, K2; the
slots: plain batched torch), prints one JSON line per step (per policy
the simulated and analytic tau and the delivered ratio, the topology's
links and the step's new links) and a summary with the JAX script's keys,
unrounded; `unexpected_retraces_after_steady` is
`obs.NOT_APPLICABLE_RETRACES` (the port compiles no program).  `--out`
writes the record (description, config, per-step rows, summary); JAX's
`legacy` carry-over of an older record has no counterpart.

The numpy draws (topology, roles, capacities, link rates, jobs, the walk)
are the JAX script's, in its order.  The model's initial parameters at the
default `--k 1` are JAX's (`MOBILITY_K1_init` in `data/weights.npz`, its
`PRNGKey(1)` draw; another `--k` gets the port's glorot draw from seed 1).
Each segment's simulator draws come from one generator seeded by (2,
1000 + 8 step + policy), where JAX folds that number into `PRNGKey(2)`.
`rollout(opts, variables=, draws=, device=, dtype=)` is the function
entry: it takes the model's weights and a draw source per segment, as
the tests hold it against the JAX script.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from multihop_offload_tpu_torch._device import resolve_device
from multihop_offload_tpu_torch.agent.policy import forward_env
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.env.policies import baseline_policy, local_policy
from multihop_offload_tpu_torch.graphs import generators
from multihop_offload_tpu_torch.graphs import mobility
from multihop_offload_tpu_torch.graphs.instance import (
    PadSpec,
    build_instance,
    build_jobset,
    stack_instances,
)
from multihop_offload_tpu_torch.graphs.topology import build_topology, sample_link_rates
from multihop_offload_tpu_torch.models.chebconv import load_weights, make_model, params_from_jax
from multihop_offload_tpu_torch.obs import NOT_APPLICABLE_RETRACES
from multihop_offload_tpu_torch.scenarios.matrix import _lane
from multihop_offload_tpu_torch.sim import (
    FleetSim,
    build_sim_params,
    conservation_gap,
    make_policy,
    migrate_sim_state,
    spec_for,
)
from multihop_offload_tpu_torch.sim.fidelity import (
    analytic_link_delay,
    analytic_server_delay,
    composed_job_tau,
    empirical_queue_delays,
)
from multihop_offload_tpu_torch.sim.runner import LaneDraws

POLICIES = ("baseline", "local", "GNN")
MODEL = "MOBILITY_K1_init"  # JAX's `model.init(PRNGKey(1), ...)` at k = 1

DEFAULTS = dict(n=30, steps=10, moving=4, step_std=0.08, load=0.15, T=1000.0, k=1, seed=0,
                rounds=2, slots=800, margin=5.0, cap=128, min_served=30, out="")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    for name, default in DEFAULTS.items():
        p.add_argument(f"--{name}", type=type(default), default=default)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def initial_params(k: int) -> dict:
    """The model's initial weights (a `ChebNet` state_dict) at order k."""
    if k == 1:
        return params_from_jax(load_weights(MODEL))
    model = make_model(Config(cheb_k=k), generator=torch.Generator().manual_seed(1))
    return {n: p.detach() for n, p in model.state_dict().items()}


def seeded_draws(step: int, policy: int, sim: FleetSim, device):
    """A segment's simulator draws: one generator seeded by (2, 1000 + 8
    step + policy), the counterpart of JAX's `fold_in(PRNGKey(2), ...)`."""
    seed = int(np.random.SeedSequence((2, 1000 + 8 * step + policy)).generate_state(1)[0])
    return LaneDraws([seed], sim.spec, sim.dtype, device)


def rollout(opts, variables: dict | None = None, draws=None, device=None,
            dtype=torch.float32, verbose: bool = True) -> dict:
    """Run the rollout of `opts` (the CLI's options: an argparse namespace
    or a dict over `DEFAULTS`) on `device` (default CUDA) at `dtype`.
    `variables`: the model's state_dict (default `initial_params(k)`);
    `draws(step, policy_index, sim)`: a segment's draw source (default
    `seeded_draws`).  Returns {"per_step": rows, "summary": ...,
    "config": ...}, and for checks "dst" (each policy's decisions, a list
    a step) and "states" (each policy's last simulator state)."""
    a = argparse.Namespace(**{**DEFAULTS, **(vars(opts) if isinstance(opts, argparse.Namespace)
                                             else dict(opts))})
    dev = resolve_device(device)
    rng = np.random.default_rng(a.seed)
    adj, pos, _ = generators.connected_poisson_disk(a.n, seed=a.seed)
    topo = build_topology(adj, pos)

    roles = np.zeros(a.n, dtype=np.int32)
    servers = rng.choice(a.n, max(1, a.n // 8), replace=False)
    roles[servers] = 1
    proc_bws = np.where(roles == 1, rng.pareto(2.0, a.n) * 100.0 + 10.0,
                        rng.pareto(2.0, a.n) * 8.0 + 1.0)
    link_rates = sample_link_rates(topo, rng.uniform(30, 70, topo.num_links), rng=rng)

    # fixed pad: the link count changes step to step
    pad = PadSpec(
        n=PadSpec.round_up(a.n, 8),
        l=PadSpec.round_up(int(topo.num_links * 1.8), 8),
        s=PadSpec.round_up(int((roles == 1).sum()), 8),
        j=PadSpec.round_up(int((roles == 0).sum()), 8),
    )
    model = make_model(Config(cheb_k=a.k, T=int(a.T)), dtype=dtype)
    model.load_state_dict({n: v.to(dtype) for n, v in
                           (variables or initial_params(a.k)).items()})
    model = model.to(dev)

    mobile = np.flatnonzero(roles == 0)
    nj = max(1, int(0.5 * mobile.size))
    jobs = stack_instances([build_jobset(rng.permutation(mobile)[:nj],
                                         a.load * rng.uniform(0.1, 0.5, nj),
                                         pad_jobs=pad.j, dtype=dtype, device=dev)])
    jmask = jobs.mask.cpu().numpy()
    true_rates = jobs.rate

    def instance(topo, link_rates):
        return stack_instances([build_instance(topo, roles, proc_bws, link_rates, a.T, pad,
                                               dtype=dtype, device=dev)])

    spec = spec_for(instance(topo, link_rates), jobs, cap=a.cap)
    # one dt for the whole rollout, so delay units stay comparable
    dt0 = 1.0 / (a.margin * float(np.asarray(link_rates)[: topo.num_links].max()))
    sims = {name: FleetSim(spec, make_policy(kind, model=model), rounds=a.rounds,
                           slots_per_round=a.slots, dtype=dtype)
            for name, kind in zip(POLICIES, ("baseline", "local", "gnn"))}
    sim_states = {name: None for name in POLICIES}
    draws = draws or (lambda step, pi, sim: seeded_draws(step, pi, sim, dev))

    taus = {name: [] for name in POLICIES}
    taus_ana = {name: [] for name in POLICIES}
    dsts = {name: [] for name in POLICIES}
    per_step = []
    conservation_ok = True
    churn_total = 0
    t0 = time.perf_counter()  # nondet-ok(the summary's wall time is a measurement)
    for step in range(a.steps):
        inst = instance(topo, link_rates)
        with torch.no_grad():
            outcomes = (baseline_policy(inst, jobs), local_policy(inst, jobs),
                        forward_env(model, inst, jobs, device=dev)[0])
        params = stack_instances([build_sim_params(_lane(inst, 0), _lane(jobs, 0), dt=dt0)])

        row = {"step": step, "links": topo.num_links}
        for pi, (name, outcome) in enumerate(zip(POLICIES, outcomes)):
            st_in = sim_states[name]
            run = sims[name].run(inst, jobs, params, draws(step, pi, sims[name]),
                                 states=None if st_in is None else stack_instances([st_in]),
                                 init_rates=true_rates)
            st = run.state
            conservation_ok &= int(conservation_gap(st).sum()) == 0
            # this segment's empirical per-channel delays: the cumulative
            # statistics less those carried into the segment
            seg = st if st_in is None else dataclasses.replace(
                st, q_sojourn=st.q_sojourn - st_in.q_sojourn,
                q_served=st.q_served - st_in.q_served)
            emp_l, emp_s = empirical_queue_delays(seg, spec, dt0, min_served=a.min_served)
            ana_l = analytic_link_delay(inst, outcome)
            ana_s = analytic_server_delay(inst, outcome)
            emp_l = np.where(np.isfinite(emp_l), emp_l, ana_l)
            emp_s = np.where(np.isfinite(emp_s), emp_s, ana_s)
            tau_j = composed_job_tau(inst, jobs, outcome.routes, emp_l, emp_s)
            with np.errstate(invalid="ignore"):
                tau = float(np.nanmean(np.where(jmask, tau_j, np.nan)))
            tau_a = float(outcome.job_total.cpu().numpy()[jmask].mean())
            taus[name].append(tau)
            taus_ana[name].append(tau_a)
            dsts[name].append(outcome.decision.dst.cpu())
            row[name] = tau
            row[f"{name}_analytic"] = tau_a
            # a saturated policy shows a low measured tau (finite buffers cap
            # the sojourn): the delivered ratio is where the overload lands
            gen0 = 0 if st_in is None else int(st_in.generated.sum())
            del0 = 0 if st_in is None else int(st_in.delivered.sum())
            seg_gen = int(st.generated.sum()) - gen0
            seg_del = int(st.delivered.sum()) - del0
            row[f"{name}_delivered"] = seg_del / max(seg_gen, 1)
            sim_states[name] = _lane(st, 0)

        # mobility tick: jitter, rebuild, migrate the per-link capacities
        # and the in-flight queues across the old -> new link map
        new_pos, new_adj = mobility.random_walk(topo.pos, n_moving=a.moving,
                                                step_std=a.step_std, rng=rng)
        new_topo, link_map = mobility.topology_update(topo, new_adj, pos=new_pos)
        churn = int((link_map < 0).sum())
        churn_total += churn
        row["new_links"] = churn
        fresh = sample_link_rates(new_topo, rng.uniform(30, 70, new_topo.num_links), rng=rng)
        link_rates = np.where(link_map >= 0,
                              mobility.migrate_link_state(link_map, link_rates), fresh)
        for name in POLICIES:
            sim_states[name] = migrate_sim_state(sim_states[name].to("cpu"), link_map,
                                                 spec).to(dev)
        topo = new_topo
        per_step.append(row)
        if verbose:
            print(json.dumps(row))  # print-ok(one JSON line a step is the script's output)

    summary = {
        "metric": "mobility_rollout",
        "n": a.n, "steps": a.steps,
        "slots_per_step": a.rounds * a.slots,
        "mean_tau": {k: float(np.mean(v)) for k, v in taus.items()},
        "mean_tau_analytic": {k: float(np.mean(v)) for k, v in taus_ana.items()},
        "link_churn_per_step": churn_total / a.steps,
        "delivered_ratio": {k: float(np.mean([r[f"{k}_delivered"] for r in per_step]))
                            for k in POLICIES},
        "conservation_ok": bool(conservation_ok),
        "unexpected_retraces_after_steady": NOT_APPLICABLE_RETRACES,
        "wall_s": time.perf_counter() - t0,  # nondet-ok(same measurement)
    }
    config = {"n": a.n, "steps": a.steps, "moving": a.moving, "step_std": a.step_std,
              "load": a.load, "rounds": a.rounds, "slots": a.slots, "margin": a.margin,
              "cap": a.cap, "min_served": a.min_served, "seed": a.seed, "dt": dt0,
              "device": str(dev)}
    return {"per_step": per_step, "summary": summary, "config": config, "dst": dsts,
            "states": sim_states}


def main(argv=None) -> int:
    args = parse_args(argv)
    out = rollout(args, device=args.device)
    print(json.dumps(out["summary"]))  # print-ok(the summary line is the script's output)
    if args.out:
        record = {
            "description": (
                "dynamic-topology rollout record: nodes random-walk each step, the "
                "conflict structure is rebuilt on the host, link capacities and "
                "in-flight simulator queues migrate across the old->new link map, and "
                "3 policies re-run closed-loop per step on fixed pad shapes.  tau "
                "composes the analytic job-total formula with measured per-channel "
                "delays (sim.fidelity.composed_job_tau); *_analytic are the "
                "formula-only scores."),
            "config": out["config"], "per_step": out["per_step"], "summary": out["summary"],
        }
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
        print(f"record written to {args.out}")  # print-ok(operator feedback)
    return 0


if __name__ == "__main__":
    sys.exit(main())
