"""Simulation entry point: closed-loop packet-level evaluation.

Port of `multihop_offload_tpu/cli/sim.py`:

    python -m multihop_offload_tpu_torch.cli.sim [--device cpu] --smoke
    python -m multihop_offload_tpu_torch.cli.sim --fidelity --sim_out=fid.json
    python -m multihop_offload_tpu_torch.cli.sim --sim_policy=gnn \\
        --sim_nodes=110 --sim_fleet=16 --sim_jobs=100 --sim_util=0.7

The default mode simulates `sim_fleet` random BA scenarios (graph `seed +
100 i`) with the configured policy in the loop, re-decided every
`sim_slots` slots on the measured arrival rates, `sim_rounds` times,
optionally failing links and nodes at mid-horizon, and prints a JSON
summary: delivery, drops and delay, the conservation check and the
device-metric block.  `--smoke` is a tiny self-check of the baseline and
local policies; `--fidelity` runs `sim.fidelity.fidelity_sweep` and writes
its record where `--sim_out` points (required: the JAX default path is
the JAX package's own record).  It runs on CUDA unless `--device cpu` is
given, and raises when CUDA is absent.  `--precision bf16` (or `auto` on
the card) runs the policies under the bf16 policy: the gnn actor at its
compute dtypes and every round's APSP squared in bf16 (the cases and the
slot loop stay at `--dtype`, as in the JAX simulator).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from multihop_offload_tpu_torch.config import Config, build_parser


def load_gnn(cfg: Config, device=None):
    """(model, source) of the gnn policy on `device`: the port's latest
    checkpoint in ``cfg.model_dir()/torch`` when there is one, else the
    committed model `cfg.sim_model`, else (`sim_model` empty) a fresh init
    seeded by `cfg.seed`; built under `cfg.precision`'s policy on that
    device."""
    from multihop_offload_tpu_torch.models.chebconv import load_model, make_model
    from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib

    policy = cfg.precision_policy(device)
    dtype = policy.param_dtype
    directory = os.path.join(cfg.model_dir(), "torch")
    step = ckpt_lib.latest_step(directory)
    if step is not None:
        model = make_model(cfg, layout=cfg.layout, policy=policy)
        params = ckpt_lib.restore_checkpoint_raw(directory, step)["params"]
        model.load_state_dict({k: v.to(dtype) for k, v in params.items()})
        source = f"checkpoint step {step} of {directory}"
    elif cfg.sim_model:
        model = load_model(cfg.sim_model, device="cpu", layout=cfg.layout, policy=policy)
        source = f"committed model {cfg.sim_model}"
    else:
        model = make_model(cfg, layout=cfg.layout, policy=policy,
                           generator=torch.Generator().manual_seed(cfg.seed))
        source = f"fresh-init weights (seed {cfg.seed})"
    print(f"sim gnn policy: {source}")
    return model.to(device), source


def build_scenarios(cfg: Config, device=None) -> dict:
    """The default mode's fleet on `device` (default CUDA), ready to run:
    cases rescaled to `sim_util`, failure schedules, the policy and the
    `FleetSim`.  `run_scenarios` runs and summarizes it."""
    from multihop_offload_tpu_torch._device import resolve_device
    from multihop_offload_tpu_torch.env.policies import baseline_policy
    from multihop_offload_tpu_torch.graphs import generators
    from multihop_offload_tpu_torch.graphs.instance import PadSpec, stack_instances
    from multihop_offload_tpu_torch.graphs.topology import build_topology
    from multihop_offload_tpu_torch.layouts.policy import resolve_layout
    from multihop_offload_tpu_torch.layouts.sparse import cf_nnz_count, ext_nnz_count
    from multihop_offload_tpu_torch.sim.fidelity import make_case, scale_to_util
    from multihop_offload_tpu_torch.sim.policies import make_policy
    from multihop_offload_tpu_torch.sim.runner import FleetSim
    from multihop_offload_tpu_torch.sim.state import build_sim_params, spec_for

    dev = resolve_device(device)
    fleet, n_nodes = cfg.sim_fleet, cfg.sim_nodes
    topos = [build_topology(generators.barabasi_albert(n_nodes, seed=cfg.seed + 100 * i)[0])
             for i in range(fleet)]
    r = cfg.round_to
    pad = PadSpec(n=-(-n_nodes // r) * r, l=-(-max(t.num_links for t in topos) // r) * r,
                  s=r, j=max(cfg.sim_jobs, r))
    lay = cfg.layout
    if resolve_layout(lay).sparse:
        # nnz pads from the data (every node of a `make_case` network can
        # compute), as `graphs.cases.pad_for` sizes them: the heuristic
        # 16 L is below some BA(110) conflict graphs' 3,470-3,594 entries
        pad = dataclasses.replace(
            pad, enn=PadSpec.round_up(max(ext_nnz_count(t, np.ones(t.n, bool))
                                          for t in topos), 128),
            cnn=PadSpec.round_up(max(cf_nnz_count(t) for t in topos), 128))
    dtype = cfg.torch_dtype
    cases = [make_case(cfg.seed + 100 * i, topos[i], pad, cfg.sim_jobs, dtype=dtype,
                       layout=lay, device=dev) for i in range(fleet)]
    insts = stack_instances([c[0] for c in cases])
    jobss, _ = scale_to_util(insts, stack_instances([c[1] for c in cases]), None,
                             cfg.sim_util,
                             policy_fn=lambda i, j, g: baseline_policy(i, j, g, layout=lay))
    total_slots = cfg.sim_rounds * cfg.sim_slots
    fail_slot = total_slots // 2
    rng = np.random.default_rng(cfg.seed)
    params_list = []
    for i, (inst, jobs) in enumerate(cases):
        fail_link = np.full((pad.l,), -1, np.int32)
        fail_node = np.full((pad.n,), -1, np.int32)
        if cfg.sim_fail_links > 0:
            real = np.arange(topos[i].num_links)
            kill = rng.choice(real, size=min(cfg.sim_fail_links, real.size), replace=False)
            fail_link[kill] = fail_slot
        if cfg.sim_fail_nodes > 0:
            servers = inst.servers[inst.server_mask].cpu().numpy()
            cand = np.setdiff1d(np.arange(n_nodes), np.concatenate(
                [servers, jobs.src[jobs.mask].cpu().numpy()]))
            if cand.size:
                kill = rng.choice(cand, size=min(cfg.sim_fail_nodes, cand.size),
                                  replace=False)
                fail_node[kill] = fail_slot
        params_list.append(build_sim_params(
            inst, dataclasses.replace(jobs, rate=jobss.rate[i]), margin=cfg.sim_margin,
            fail_link_slot=fail_link, fail_node_slot=fail_node))

    source = None
    precision = cfg.precision_policy(dev)
    if cfg.sim_policy == "gnn":
        model, source = load_gnn(cfg, dev)
        policy = make_policy("gnn", model=model, precision=precision, layout=lay)
    else:
        policy = make_policy(cfg.sim_policy, precision=precision, layout=lay)
    spec = spec_for(insts, jobss, cap=cfg.sim_cap)
    return {
        "sim": FleetSim(spec, policy, rounds=cfg.sim_rounds, slots_per_round=cfg.sim_slots,
                        dtype=dtype),
        "insts": insts, "jobss": jobss, "paramss": stack_instances(params_list),
        "seeds": [cfg.seed + 100 * i for i in range(fleet)],
        "fail_slot": fail_slot, "model_source": source, "device": dev,
    }


def summarize(cfg: Config, scen: dict, run) -> dict:
    """The JSON summary of one run of `build_scenarios`' fleet."""
    from multihop_offload_tpu_torch.sim.step import (
        DM_DELIVERED,
        DM_DROP_ARR,
        DM_DROP_CAP,
        DM_DROP_FWD,
        DM_GENERATED,
        DM_QUEUE_DEPTH,
    )

    sim = scen["sim"]
    st = run.state
    j = sim.spec.num_jobs
    generated = st.generated.sum(dim=1).cpu().numpy()
    delivered = st.delivered.sum(dim=1).cpu().numpy()
    dropped = st.dropped.sum(dim=1).cpu().numpy()
    in_flight = st.count[:, :-1].sum(dim=1).cpu().numpy()
    gap = generated - delivered - dropped - in_flight
    dt = scen["paramss"].dt.cpu().numpy().astype(np.float64)
    dlv = st.delivered.cpu().numpy()
    dsum = st.delay_sum.cpu().numpy().astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean_delay = np.where(dlv > 0, dsum / np.maximum(dlv, 1), np.nan) * dt[:, None]
    failing = cfg.sim_fail_links or cfg.sim_fail_nodes
    summary = {
        "policy": cfg.sim_policy,
        "device": str(scen["device"]),
        "fleet": cfg.sim_fleet,
        "slots": cfg.sim_rounds * cfg.sim_slots,
        "rounds": cfg.sim_rounds,
        "util_target": cfg.sim_util,
        "fail_links": cfg.sim_fail_links,
        "fail_nodes": cfg.sim_fail_nodes,
        "fail_slot": scen["fail_slot"] if failing else None,
        "generated": int(generated.sum()),
        "delivered": int(delivered.sum()),
        "dropped": int(dropped.sum()),
        "in_flight": int(in_flight.sum()),
        "conservation_ok": bool((gap == 0).all()),
        "delivery_ratio": float(delivered.sum() / max(generated.sum(), 1)),
        "mean_packet_delay_ul": float(np.nanmean(mean_delay[:, :j]))
        if np.isfinite(mean_delay[:, :j]).any() else None,
        "mean_packet_delay_dl": float(np.nanmean(mean_delay[:, j:]))
        if np.isfinite(mean_delay[:, j:]).any() else None,
    }
    f = sim.last_devmetrics
    if f is not None:
        dev_gen = int(f[DM_GENERATED])
        dev_del = int(f[DM_DELIVERED])
        dev_drop = int(f[DM_DROP_FWD] + f[DM_DROP_ARR] + f[DM_DROP_CAP])
        h = f[DM_QUEUE_DEPTH]
        summary["devmetrics"] = {
            "generated": dev_gen,
            "delivered": dev_del,
            "dropped": dev_drop,
            "dropped_by_reason": {
                "no_route_forward": int(f[DM_DROP_FWD]),
                "no_route_arrival": int(f[DM_DROP_ARR]),
                "capacity": int(f[DM_DROP_CAP]),
            },
            "queue_depth": {
                "count": h["count"],
                "mean": (h["sum"] / h["count"]) if h["count"] else None,
                "max": h["max"], "counts": h["counts"],
            },
            # the device-side counters against the terminal SimState
            # counters: the same masks in the same slots, so equal
            "matches_state": bool(dev_gen == int(generated.sum())
                                  and dev_del == int(delivered.sum())
                                  and dev_drop == int(dropped.sum())),
        }
    return summary


def run_scenarios(cfg: Config, device=None) -> dict:
    """Default mode: the fleet simulation under the configured policy."""
    scen = build_scenarios(cfg, device)
    run = scen["sim"].run(scen["insts"], scen["jobss"], scen["paramss"], scen["seeds"])
    return summarize(cfg, scen, run)


# the SimState fields a run on the card is held to against the CPU under
# the same draws: every counter and the two integer-valued float sums
STATE_FIELDS = ("generated", "delivered", "dropped", "count", "head", "q_served",
                "q_arrived", "q_busy", "sched_slots", "delay_sum", "q_sojourn")
_QUEUE_FIELDS = ("count", "head", "q_served", "q_arrived", "q_busy", "q_sojourn")


def fields_that_differ(a, b) -> list:
    """The `STATE_FIELDS` in which SimStates `a` and `b` (on one device)
    differ; queues are compared without the scratch row Q, whose content
    is unspecified and never read."""
    def live(st, f):
        x = getattr(st, f)
        return x[:, :-1] if f in _QUEUE_FIELDS else x

    return [f for f in STATE_FIELDS if not torch.equal(live(a, f), live(b, f))]


def offload_share(dst: torch.Tensor, jobs) -> float:
    """The share of real jobs whose destination is not their source."""
    src, mask = jobs.src.to(dst.device), jobs.mask.to(dst.device)
    return float((dst != src)[mask].double().mean())


def uniform_draws(spec, fleet: int, rounds: int, slots: int, seed: int) -> list:
    """A run's slot draws (tie, link, srv, arr), each (fleet, rounds,
    slots, width), made on the CPU by one generator seeded `seed`."""
    g = torch.Generator().manual_seed(seed)
    return [torch.rand((fleet, rounds, slots, w), generator=g)
            for w in (spec.num_links, spec.num_links, spec.num_nodes, spec.num_streams)]


def record_rounds(sim) -> list:
    """Make `sim`'s policy append each round's (dst on the host, host ms
    of the decision) to the list returned; the clock waits for the device
    on both sides."""
    from multihop_offload_tpu_torch._device import synchronize

    rounds, inner = [], sim.policy_fn

    def call(inst, *args):
        synchronize(inst.adj.device)
        t0 = time.perf_counter()
        routes = inner(inst, *args)
        dst = routes.dst.cpu()
        rounds.append((dst, (time.perf_counter() - t0) * 1e3))
        return routes

    sim.policy_fn = call
    return rounds


def run_on(cfg: Config, scen: dict, device, draws: list):
    """`build_scenarios`' fleet (built anywhere) run on `device` under the
    slot draws `draws` (`uniform_draws`): the fleet, the draws and the
    policy's model moved there, a `FleetSim` of the same spec.  Returns
    (the FleetSim, its run, `record_rounds`' list)."""
    from multihop_offload_tpu_torch.sim.policies import make_policy
    from multihop_offload_tpu_torch.sim.runner import FleetSim, InjectedDraws

    kw = {"model": load_gnn(cfg, device)[0]} if cfg.sim_policy == "gnn" else {}
    precision = cfg.precision_policy(device)
    sim = FleetSim(scen["sim"].spec, make_policy(cfg.sim_policy, layout=cfg.layout,
                                                 precision=precision, **kw),
                   rounds=cfg.sim_rounds, slots_per_round=cfg.sim_slots, dtype=cfg.torch_dtype)
    rounds = record_rounds(sim)
    insts, jobss, paramss = (scen[k].to(device) for k in ("insts", "jobss", "paramss"))
    run = sim.run(insts, jobss, paramss, InjectedDraws(*[d.to(device) for d in draws]))
    return sim, run, rounds


def run_smoke(cfg: Config, device=None) -> dict:
    """A quick self-check: a tiny fleet under the baseline and local
    policies, each conserving packets with device counters equal to the
    state's (seconds on the CPU)."""
    smoke_cfg = dataclasses.replace(
        cfg, sim_fleet=2, sim_nodes=8, sim_jobs=3, sim_rounds=2, sim_slots=150,
        sim_util=0.4, sim_cap=64, sim_fail_links=1, sim_fail_nodes=0)
    results = {}
    for pol in ("baseline", "local"):
        s = run_scenarios(dataclasses.replace(smoke_cfg, sim_policy=pol), device)
        if not s["conservation_ok"]:
            raise AssertionError(f"conservation violated under {pol}")
        if not s["devmetrics"]["matches_state"]:
            raise AssertionError(f"devmetrics counters diverge from SimState under {pol}: "
                                 f"{s['devmetrics']}")
        if not s["devmetrics"]["queue_depth"]["count"] > 0:
            raise AssertionError(f"empty queue-depth histogram under {pol}")
        results[pol] = s
    results["ok"] = True
    return results


def main(argv=None) -> int:
    from multihop_offload_tpu_torch import obs

    p = build_parser(description=__doc__)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--smoke", action="store_true", help="tiny self-check run")
    p.add_argument("--fidelity", action="store_true",
                   help="sim-vs-analytic fidelity sweep; writes its record to --sim_out")
    ns = vars(p.parse_args(argv))
    device, mode_smoke, mode_fid = ns.pop("device"), ns.pop("smoke"), ns.pop("fidelity")
    cfg = Config(**ns)
    if mode_fid and not cfg.sim_out:
        p.error("--fidelity writes its record where --sim_out points; give --sim_out")

    runlog = obs.start_run(cfg, role="sim")
    try:
        if mode_smoke:
            out = run_smoke(cfg, device)
        elif mode_fid:
            from multihop_offload_tpu_torch.sim.fidelity import fidelity_sweep, write_record

            out = fidelity_sweep(
                fleet=cfg.sim_fleet, n_nodes=cfg.sim_nodes, num_jobs=cfg.sim_jobs,
                rounds=cfg.sim_rounds, slots_per_round=cfg.sim_slots,
                margin=cfg.sim_margin, cap=cfg.sim_cap, seed=cfg.seed, device=device)
            write_record(out, cfg.sim_out)
            print(f"fidelity record written to {cfg.sim_out}")
        else:
            out = run_scenarios(cfg, device)
            if cfg.sim_out:
                with open(cfg.sim_out, "w") as f:
                    json.dump(out, f, indent=1)
                    f.write("\n")
    finally:
        obs.finish_run(runlog)
    print(json.dumps(out if not mode_fid else out["acceptance"], indent=2, default=str))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
