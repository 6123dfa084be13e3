"""Sim-vs-analytic fidelity sweep (`cli.sim --fidelity`).

Port of `multihop_offload_tpu/sim/fidelity.py`.  The analytic evaluator
prices every link as an interference-coupled M/M/1 queue; the simulator
realizes the same system packet by packet.  The sweep drives both on the
same instances, jobs and baseline decisions across arrival rates and
reports where they agree:

- per link: the measured mean channel sojourn (``q_sojourn / q_served *
  dt``, both direction queues pooled) against ``1/(mu - lambda)``,
  traffic-weighted relative error over links with enough served packets;
- per server: server-queue sojourn against ``1/(bw - load)``;
- end to end: per-stream mean packet delay against the analytic route sum.

Low utilization is where the M/M/1 idealization should hold, so the
record's acceptance gates on utilization <= 0.5 (max link relative error
<= 0.10); the high-utilization rows document where queueing leaves the
model.  `margin` sets ``dt`` so the busiest link's per-slot probability
stays small (default 5: <= 0.2).

The helpers take batched records (leading axis B) and return numpy arrays
with that axis; per-lane reductions run lane by lane, as the JAX helpers
run on one instance.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np
import torch

from multihop_offload_tpu_torch.env.policies import baseline_policy
from multihop_offload_tpu_torch.graphs import generators
from multihop_offload_tpu_torch._records import cat_records
from multihop_offload_tpu_torch.graphs.instance import (
    PadSpec,
    build_instance,
    build_jobset,
    stack_instances,
)
from multihop_offload_tpu_torch.graphs.topology import build_topology, sample_link_rates
from multihop_offload_tpu_torch.layouts.policy import resolve_layout
from multihop_offload_tpu_torch.obs.registry import MetricRegistry
from multihop_offload_tpu_torch.sim.policies import make_policy
from multihop_offload_tpu_torch.sim.runner import FleetSim
from multihop_offload_tpu_torch.sim.state import build_sim_params, spec_for
from multihop_offload_tpu_torch.sim.step import (
    DM_DROP_ARR,
    DM_DROP_CAP,
    DM_DROP_FWD,
    DM_QUEUE_DEPTH,
)

DEFAULT_UTILS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.7, 0.85)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


def make_case(seed: int, topo, pad: PadSpec, num_jobs: int, num_servers: int = 2,
              dtype=torch.float32, layout=None, device=None):  # fp32-island(storage default; callers pass the policy dtype)
    """One (unbatched) BA case with a mid-load workload on `device`: the
    `num_servers` highest-degree nodes serve (bandwidth 100, mobiles 8),
    link rates around 50, jobs on distinct mobiles at rates U(0.5, 1)
    (rescaled per utilization target afterwards)."""
    lay = resolve_layout(layout)
    rng = np.random.default_rng(seed)
    n_nodes = topo.n
    deg = np.asarray(topo.adj).sum(axis=1)
    servers = np.argsort(-deg, kind="stable")[:num_servers]
    roles = np.zeros(n_nodes, np.int32)
    roles[servers] = 1
    bws = np.where(roles == 1, 100.0, 8.0)
    rates = sample_link_rates(topo, 50.0, rng=rng)
    inst = build_instance(topo, roles, bws, rates, 1000.0, pad, dtype=dtype,
                          device=device, layout=lay)
    mobile = np.setdiff1d(np.arange(n_nodes, dtype=np.int64), servers)
    srcs = rng.choice(mobile, size=min(num_jobs, mobile.size), replace=False)
    jrates = rng.uniform(0.5, 1.0, srcs.size)
    jobs = build_jobset(srcs, jrates, pad_jobs=pad.j, dtype=dtype, device=device,
                        index_dtype=lay.index_dtype)
    return inst, jobs


def _busyness(link_mask, lam, mu, load, bw) -> float:
    """One lane's bottleneck rho over loaded links and servers."""
    lmask = link_mask & (lam > 0)
    rho_l = (lam[lmask] / mu[lmask]).max() if lmask.any() else 0.0
    smask = (load > 0) & (bw > 0)
    rho_s = (load[smask] / bw[smask]).max() if smask.any() else 0.0
    return float(max(rho_l, rho_s, 1e-9))


def max_busyness(inst, jobs, outcome) -> np.ndarray:
    """(B,) bottleneck rho over real links and loaded servers of a
    decision (`outcome`, an `env.policies.PolicyOutcome`)."""
    cols = (inst.link_mask.cpu().numpy(), _np(outcome.delays.link_lambda),
            _np(outcome.delays.link_mu), _np(outcome.delays.server_load),
            _np(inst.proc_bws))
    return np.array([_busyness(*(c[i] for c in cols)) for i in range(cols[0].shape[0])])


def scale_to_util(inst, jobs, gen, target: float, iters: int = 3,
                  policy_fn=baseline_policy):
    """Rescale each lane's job rates until its analytic bottleneck rho hits
    `target`.  The interference fixed point makes mu depend on lambda, so
    a few multiplicative corrections converge.  Returns (jobs, outcome of
    the last decision)."""
    for _ in range(iters):
        out = policy_fn(inst, jobs, gen)
        scale = torch.from_numpy(target / max_busyness(inst, jobs, out))
        jobs = dataclasses.replace(
            jobs, rate=jobs.rate * scale.to(jobs.rate.dtype).to(jobs.rate.device).unsqueeze(1))
    return jobs, policy_fn(inst, jobs, gen)


def analytic_link_delay(inst, outcome) -> np.ndarray:
    """(B, L) per-packet channel delay 1/(mu - lambda); NaN where
    untraversed or analytically congested."""
    lam = _np(outcome.delays.link_lambda)
    mu = _np(outcome.delays.link_mu)
    ok = inst.link_mask.cpu().numpy() & (lam > 0) & (mu > lam)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(ok, 1.0 / (mu - lam), np.nan)


def analytic_server_delay(inst, outcome) -> np.ndarray:
    """(B, N) per-packet server delay 1/(bw - load); NaN where unloaded."""
    load = _np(outcome.delays.server_load)
    bw = _np(inst.proc_bws)
    ok = (load > 0) & (bw > load)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(ok, 1.0 / (bw - load), np.nan)


def empirical_queue_delays(state, spec, dt, min_served: int = 50):
    """Pooled per-channel (B, L) and per-server (B, N) mean sojourn in
    model time, from the state's counters; `dt` per lane (B,) or one."""
    num_links, n = spec.num_links, spec.num_nodes
    soj = _np(state.q_sojourn)
    srv = _np(state.q_served)
    dt = np.asarray(dt, np.float64)
    dt = dt[..., None] if dt.ndim else dt
    ch_soj = soj[..., :num_links] + soj[..., num_links:2 * num_links]
    ch_srv = srv[..., :num_links] + srv[..., num_links:2 * num_links]
    s_soj = soj[..., 2 * num_links:2 * num_links + n]
    s_srv = srv[..., 2 * num_links:2 * num_links + n]
    with np.errstate(divide="ignore", invalid="ignore"):
        link_d = np.where(ch_srv >= min_served, ch_soj / ch_srv * dt, np.nan)
        srv_d = np.where(s_srv >= min_served, s_soj / s_srv * dt, np.nan)
    return link_d, srv_d


def _weighted_err(emp: np.ndarray, ana: np.ndarray, weight: np.ndarray):
    ok = np.isfinite(emp) & np.isfinite(ana) & (weight > 0)
    if not ok.any():
        return {"weighted_rel_err": None, "max_rel_err": None, "compared": 0}
    rel = np.abs(emp[ok] - ana[ok]) / ana[ok]
    w = weight[ok] / weight[ok].sum()
    return {
        "weighted_rel_err": float((rel * w).sum()),
        "max_rel_err": float(rel.max()),
        "compared": int(ok.sum()),
    }


def composed_job_tau(inst, jobs, routes, emp_link, emp_srv) -> np.ndarray:
    """(B, J) the analytic job-total formula with measured unit delays
    (B, L) / (B, N) in place of 1/(mu - lambda)."""
    num_links = inst.num_pad_links
    inc = _np(routes.inc_ext)[:, :num_links]                          # (B, L, J)
    nhop = _np(routes.nhop)[:, None, :]
    ul = _np(jobs.ul)
    dl = _np(jobs.dl)
    d_ul = np.maximum(ul[:, None, :] * emp_link[:, :, None], nhop)
    d_dl = np.maximum(dl[:, None, :] * emp_link[:, :, None], nhop)
    job_link = np.where(inc > 0, d_ul + d_dl, 0.0).sum(axis=1)
    srv = np.take_along_axis(emp_srv, routes.dst.long().cpu().numpy(), axis=1)
    job_server = np.maximum(ul * srv, 1.0)
    return np.where(jobs.mask.cpu().numpy(), job_link + job_server, 0.0)


def _in_flight(link_mask, lam, mu, load, bw) -> float:
    ok_l = link_mask & (lam > 0) & (mu > lam)
    l_links = float((lam[ok_l] / (mu[ok_l] - lam[ok_l])).sum()) if ok_l.any() else 0.0
    ok_s = (load > 0) & (bw > load)
    l_srv = float((load[ok_s] / (bw[ok_s] - load[ok_s])).sum()) if ok_s.any() else 0.0
    return l_links + l_srv


def analytic_mean_in_flight(inst, outcome) -> np.ndarray:
    """(B,) expected packets in system, the sum of rho/(1-rho) over loaded
    M/M/1 queues (links + servers): the Little's-law counterpart of the
    devmetrics queue-depth histogram's mean."""
    cols = (inst.link_mask.cpu().numpy(), _np(outcome.delays.link_lambda),
            _np(outcome.delays.link_mu), _np(outcome.delays.server_load),
            _np(inst.proc_bws))
    return np.array([_in_flight(*(c[i] for c in cols)) for i in range(cols[0].shape[0])])


def _devmetrics_row(flushed, inst, outcome, fleet: int, slots: int):
    """Per-utilization device-metrics block: the queue-depth histogram's
    mean against the analytic expected in-flight, and the drop reasons the
    terminal `SimState.dropped` cannot attribute."""
    if not flushed:
        return None
    h = flushed.get(DM_QUEUE_DEPTH)
    row = {
        "drops": {
            "no_route_forward": int(flushed.get(DM_DROP_FWD, 0)),
            "no_route_arrival": int(flushed.get(DM_DROP_ARR, 0)),
            "capacity": int(flushed.get(DM_DROP_CAP, 0)),
        },
    }
    if h and h["count"]:
        # every live queue is observed every slot: the sum over a segment
        # is the total in-flight integrated over slot-lanes
        emp = h["sum"] / (fleet * slots)
        ana = float(np.mean(analytic_mean_in_flight(inst, outcome)))
        row["queue_depth"] = {
            "mean_in_flight_emp": float(emp),
            "mean_in_flight_analytic": ana,
            "rel_err": float(abs(emp - ana) / ana) if ana > 0 else None,
            "max_depth": h["max"],
            "counts": h["counts"],
        }
    return row


def _end_to_end(inc, dst, ana_l, ana_s, delivered, dsum, j, dt):
    """One lane's delivered-weighted relative error of per-stream mean
    packet delay."""
    # a NaN analytic entry on a traversed link poisons the path sum, so the
    # stream drops out of the comparison instead of skewing it
    path_sum = np.where(inc > 0, ana_l[:, None], 0.0).sum(axis=0)
    ana = np.concatenate([path_sum + ana_s[dst], path_sum])
    with np.errstate(divide="ignore", invalid="ignore"):
        emp = np.where(delivered >= 50, dsum / delivered * dt, np.nan)
    return _weighted_err(emp, ana, delivered)


def _pool(errs):
    ok = [e for e in errs if e["weighted_rel_err"] is not None]
    if not ok:
        return {"weighted_rel_err": None, "max_rel_err": None, "compared": 0}
    return {
        "weighted_rel_err": float(np.mean([e["weighted_rel_err"] for e in ok])),
        "max_rel_err": float(max(e["max_rel_err"] for e in ok)),
        "compared": int(sum(e["compared"] for e in ok)),
    }


def _lanes(tree: dict, lanes: slice) -> dict:
    """The devmetrics accumulators `tree` cut to the lanes `lanes`."""
    return {k: _lanes(v, lanes) if isinstance(v, dict) else v[lanes]
            for k, v in tree.items()}


def fidelity_sweep(
    utils: Sequence[float] = DEFAULT_UTILS,
    fleet: int = 8,
    n_nodes: int = 10,
    num_jobs: int = 4,
    rounds: int = 5,
    slots_per_round: int = 1000,
    margin: float = 5.0,
    cap: int = 128,
    seed: int = 0,
    min_served: int = 50,
    device=None,
) -> dict:
    """Run the sweep on `device` (default CUDA); returns the JSON-ready
    record.  Lane i is BA graph `seed + 100 i`; its draws come from
    generator seed `seed + 100 i` at every utilization.  The utilizations
    run side by side, as one fleet."""
    topos = [build_topology(generators.barabasi_albert(n_nodes, seed=seed + 100 * i)[0])
             for i in range(fleet)]
    pad = PadSpec(n=-(-n_nodes // 8) * 8, l=-(-max(t.num_links for t in topos) // 8) * 8,
                  s=8, j=max(num_jobs, 8))
    cases = [make_case(seed + 100 * i, topos[i], pad, num_jobs, device=device)
             for i in range(fleet)]
    insts = stack_instances([c[0] for c in cases])
    jobs0 = stack_instances([c[1] for c in cases])
    spec = spec_for(insts, jobs0, cap=cap)
    num_links = spec.num_links
    # every utilization's fleet runs in one batch of len(utils) x fleet
    # lanes: a lane's draws come from its own generator and nothing in a
    # slot mixes lanes, so each lane ends as a run of its utilization
    # alone would, and the slot loop's launches are paid once
    scaled = [scale_to_util(insts, jobs0, None, u) for u in utils]
    paramss = cat_records([stack_instances([build_sim_params(c[0], dataclasses.replace(
        c[1], rate=jobss.rate[i]), margin=margin) for i, c in enumerate(cases)])
        for jobss, _ in scaled])
    sim = FleetSim(spec, make_policy("baseline"), rounds=rounds,
                   slots_per_round=slots_per_round)
    seeds = [seed + 100 * i for i in range(fleet)] * len(utils)
    run = sim.run(cat_records([insts] * len(utils)), cat_records([j for j, _ in scaled]),
                  paramss, seeds, init_rates=torch.cat([j.rate for j, _ in scaled]))
    st = run.state
    dts = _np(paramss.dt)
    emp_l, emp_s = empirical_queue_delays(st, spec, dts, min_served)
    delivered = _np(st.delivered)
    dsum = _np(st.delay_sum)

    sweep = []
    for ui, (u, (_, outcome)) in enumerate(zip(utils, scaled)):
        lanes = slice(ui * fleet, (ui + 1) * fleet)
        ana_l = analytic_link_delay(insts, outcome)
        ana_s = analytic_server_delay(insts, outcome)
        lam = _np(outcome.delays.link_lambda)
        load = _np(outcome.delays.server_load)
        inc = _np(outcome.routes.inc_ext)[:, :num_links]
        dst = outcome.routes.dst.long().cpu().numpy()
        link_errs, srv_errs, e2e_errs = [], [], []
        for i in range(fleet):
            k = ui * fleet + i
            link_errs.append(_weighted_err(
                emp_l[k], ana_l[i], np.where(np.isfinite(emp_l[k]), lam[i], 0.0)))
            srv_errs.append(_weighted_err(
                emp_s[k], ana_s[i], np.where(np.isfinite(emp_s[k]), load[i], 0.0)))
            e2e_errs.append(_end_to_end(inc[i], dst[i], ana_l[i], ana_s[i], delivered[k],
                                        dsum[k], spec.num_jobs, dts[k]))
        # this utilization's lanes of the run's window, flushed on their own
        # (the run already merged the whole window into the registry)
        flushed = sim.devmetrics.flush(_lanes(run.dev, lanes), reg=MetricRegistry())
        sweep.append({
            "util": float(u),
            "link": _pool(link_errs),
            "server": _pool(srv_errs),
            "end_to_end": _pool(e2e_errs),
            "devmetrics": _devmetrics_row(flushed, insts, outcome, fleet,
                                          rounds * slots_per_round),
            "generated": int(st.generated[lanes].sum()),
            "delivered": int(st.delivered[lanes].sum()),
            "dropped": int(st.dropped[lanes].sum()),
            "in_flight": int(st.count[lanes, :-1].sum()),
        })

    gate = [r["link"]["weighted_rel_err"] for r in sweep
            if r["util"] <= 0.5 and r["link"]["weighted_rel_err"] is not None]
    return {
        "config": {
            "utils": [float(u) for u in utils],
            "fleet": fleet, "n_nodes": n_nodes, "num_jobs": num_jobs,
            "rounds": rounds, "slots_per_round": slots_per_round,
            "slots": rounds * slots_per_round,
            "margin": margin, "cap": cap, "seed": seed,
            "min_served": min_served, "policy": "baseline",
        },
        "sweep": sweep,
        "acceptance": {
            "max_link_rel_err_util_le_0.5": float(max(gate)) if gate else None,
            "threshold": 0.10,
            "pass": bool(gate) and max(gate) <= 0.10,
        },
    }


def write_record(record: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
