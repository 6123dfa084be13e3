"""The scenario matrix: every preset through BOTH evaluators, one process.

Port of `multihop_offload_tpu/scenarios/matrix.py`.  One shared `PadSpec`
over every scenario and lane, so every preset runs through the same three
fleet simulators (gnn / baseline / local) and the same analytic
evaluations; a spec with a non-null energy objective gets a policy set of
its own, built once per objective key.  JAX's compile cache and its
retrace counter (`jaxhooks`) have no counterpart in eager torch: the
record reports the zero-unexpected-retrace check as not applicable.

Per scenario leg (the lanes batched on the run's device):

  1. realize `scenario_fleet` seeded lanes (`scenarios.build.realize`);
  2. pin the workload to the spec's utilization via the analytic
     bottleneck (`sim.fidelity.scale_to_util`, the null-objective
     baseline);
  3. analytic evaluation per policy (tau = mean per-job delay); the
     `gnn` and `baseline` APSPs square with K2 and `run_empirical`'s
     interference fixed point is K1 on the card;
  4. segmented packet simulation per policy: `scenario_segments`
     sequential `FleetSim.run` calls, per-segment arrival scaling from
     `loadgen.rate_profile`, absolute-slot failure schedules, mobility
     re-wiring + `sim.state.migrate_sim_state` at segment boundaries;
     packet conservation is exact (asserted per lane by the smoke);
  5. GNN-vs-local-vs-greedy deltas on delivered ratio (sim) and tau
     (analytic).

Draws: each policy's segments take one seed per lane from a numpy
generator seeded ``spec.seed + 7919 * (policy index + 1)`` (JAX seeds its
key tree so), or what a `draws` callable returns for
``(spec, policy, segment, sim, fleet)`` (a draw source of `FleetSim.run`:
the tests inject JAX's own uniforms, the card check the same uniforms on
the card and the CPU).

The record also carries two `loop.drift.shift_campaign` rows: scenario
switches rendered as shift injectors and pushed through the flywheel's
drift detectors.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.obs import NOT_APPLICABLE_RETRACES

# the smoke drill's scenario subset: every NEW family, a reference family,
# a failure schedule, and a mobility schedule (JAX's subset)
_SMOKE_SCENARIOS = ("ba_poisson", "grid_poisson", "corridor_links_fail",
                    "two_tier_poisson", "poisson_mobility")
_SMOKE_SHAPES = dict(scenario_fleet=2, scenario_segments=2,
                     scenario_rounds=1, scenario_slots=120)

POLICY_KINDS = ("gnn", "baseline", "local")


def _traffic_axes(t) -> dict:
    return {
        "mmpp": t.mmpp_burst_factor > 1.0,
        "diurnal": t.diurnal_amplitude > 0.0,
        "flash": bool(t.flashes),
    }


def _obj_key(objective) -> tuple:
    return (float(objective.transport_energy), float(objective.compute_energy))


def _lane(record, i: int):
    """Lane `i` of a batched record, without the fleet axis."""
    return dataclasses.replace(record, **{
        f.name: getattr(record, f.name)[i] for f in dataclasses.fields(record)
        if isinstance(getattr(record, f.name), torch.Tensor)})


class _Programs:
    """The policy sets the legs share, keyed by objective weights: the
    three analytic evaluations and the three `FleetSim`s, each built once
    per objective key."""

    def __init__(self, cfg: Config, spec_sim, model, device, dtype=torch.float32):
        self.cfg = cfg
        self.spec_sim = spec_sim
        self.model = model
        self.device = torch.device(device)
        self.dtype = dtype
        self.lay = cfg.layout
        self._sims: Dict[tuple, dict] = {}
        self._evals: Dict[tuple, dict] = {}

    def _build_analytic(self, objective) -> dict:
        from multihop_offload_tpu_torch.agent.actor import (
            actor_delay_matrix,
            default_support,
        )
        from multihop_offload_tpu_torch.env.policies import (
            baseline_policy,
            evaluate_spmatrix_policy,
            local_policy,
        )
        from multihop_offload_tpu_torch.layouts.policy import resolve_layout

        lay, model = self.lay, self.model
        obj = None if objective is None or objective.is_null else objective

        def gnn_eval(inst, jobs, gen=None):
            # mirrors sim.policies' gnn_fn: same actor matrix, same layout
            actor = actor_delay_matrix(model, inst, jobs,
                                       default_support(model, inst, layout=lay),
                                       layout=lay)
            if resolve_layout(lay).sparse:
                inf = torch.full((), float("inf"), dtype=actor.node_delay.dtype,
                                 device=actor.node_delay.device)
                unit_diag = torch.where(inst.comp_mask, actor.node_delay, inf)
            else:
                unit_diag = torch.diagonal(actor.delay_matrix, dim1=1, dim2=2)
            return evaluate_spmatrix_policy(inst, jobs, actor.link_delay, unit_diag,
                                            gen, layout=lay, objective=obj)

        return {
            "gnn": gnn_eval,
            "baseline": lambda i, j, g=None: baseline_policy(i, j, g, layout=lay,
                                                             objective=obj),
            "local": lambda i, j, g=None: local_policy(i, j, layout=lay),
        }

    def _build_sims(self, objective) -> dict:
        from multihop_offload_tpu_torch.sim.policies import make_policy
        from multihop_offload_tpu_torch.sim.runner import FleetSim

        cfg, lay = self.cfg, self.lay
        obj = None if objective is None or objective.is_null else objective
        precision = cfg.precision_policy(self.device)
        sims = {}
        for kind in POLICY_KINDS:
            kw = {"model": self.model} if kind == "gnn" else {}
            pol = make_policy(kind, precision=precision, layout=lay, objective=obj, **kw)
            sims[kind] = FleetSim(self.spec_sim, pol, rounds=cfg.scenario_rounds,
                                  slots_per_round=cfg.scenario_slots, dtype=self.dtype)
        return sims

    def get(self, objective):
        """(sims dict, analytic-eval dict) for these objective weights."""
        k = _obj_key(objective)
        if k not in self._sims:
            self._sims[k] = self._build_sims(objective)
            self._evals[k] = self._build_analytic(objective)
        return self._sims[k], self._evals[k]


def _taus(outcome, jobs) -> List[float]:
    """Each lane's mean per-job delay over its real jobs."""
    jt = outcome.job_total.detach().cpu().numpy().astype(np.float64)
    mask = jobs.mask.cpu().numpy()
    return [float(jt[i][mask[i]].mean()) if mask[i].any() else 0.0
            for i in range(jt.shape[0])]


def _seeded_draws(spec, p_idx: int, segments: int, fleet: int):
    """Each segment's lane seeds of policy `p_idx`: JAX's key seed
    ``spec.seed + 7919 * (p_idx + 1)`` seeds a numpy generator."""
    rng = np.random.default_rng(spec.seed + 7919 * (p_idx + 1))
    seeds = rng.integers(0, 2 ** 62, size=(segments, fleet))
    return lambda seg: [int(s) for s in seeds[seg]]


def uniform_draws(seed: int, device) -> Callable:
    """A `draws` callable (see `_run_leg`) of uniforms made on the CPU, one
    generator per (spec seed, policy, segment) seeded from `seed`, and
    moved to `device`: the same draws on the card and on the CPU."""
    from multihop_offload_tpu_torch.cli.sim import uniform_draws as make
    from multihop_offload_tpu_torch.sim.runner import InjectedDraws

    def draws(spec, kind, seg, sim, fleet):
        s = np.random.SeedSequence([seed, spec.seed, POLICY_KINDS.index(kind), seg])
        u = make(sim.spec, fleet, sim.rounds, sim.slots_per_round,
                 seed=int(s.generate_state(1)[0]))
        return InjectedDraws(*[x.to(device=device, dtype=sim.dtype) for x in u])

    return draws


def _run_leg(spec, cfg: Config, pad, spec_sim, programs: _Programs, bp_pin,
             draws: Optional[Callable] = None) -> dict:
    """One scenario through both evaluators; returns the record row.
    `draws(spec, policy, segment, sim, fleet)` replaces the seeded draws
    (see the module docstring)."""
    from multihop_offload_tpu_torch._device import synchronize
    from multihop_offload_tpu_torch.graphs.instance import stack_instances
    from multihop_offload_tpu_torch.loadgen.arrivals import rate_profile
    from multihop_offload_tpu_torch.scenarios.build import (
        failure_schedules,
        lane_seed,
        mobility_step,
        realize,
    )
    from multihop_offload_tpu_torch.scenarios.spec import spec_hash
    from multihop_offload_tpu_torch.sim.fidelity import scale_to_util
    from multihop_offload_tpu_torch.sim.state import build_sim_params, migrate_sim_state

    t_leg = time.perf_counter()  # nondet-ok(leg wall time is a measurement)
    lay = cfg.layout
    dev = programs.device
    fleet = cfg.scenario_fleet
    segments = cfg.scenario_segments
    seg_slots = cfg.scenario_rounds * cfg.scenario_slots
    total_slots = segments * seg_slots

    sims, evals = programs.get(spec.objective)

    reals = [realize(spec, pad, lane=i, dtype=programs.dtype, layout=lay, device=dev)
             for i in range(fleet)]
    insts = stack_instances([r.inst for r in reals])

    # pin the mean load to the spec's utilization (analytic bottleneck);
    # the null-objective baseline prices the PHYSICAL load -- objective
    # weights bias decisions, never the load the pin is defined on
    jobs_u, _ = scale_to_util(insts, stack_instances([r.jobs for r in reals]), None,
                              spec.util, policy_fn=bp_pin)
    reals = [dataclasses.replace(r, jobs=_lane(jobs_u, i)) for i, r in enumerate(reals)]

    analytic = {}
    for kind in POLICY_KINDS:
        taus = _taus(evals[kind](insts, jobs_u), jobs_u)
        analytic[kind] = {"tau": float(np.mean(taus)),
                          "tau_per_lane": [round(t, 6) for t in taus]}

    # dynamics schedules, shared by all three policies (identical worlds)
    fails = [failure_schedules(spec, r, pad, total_slots, lane=i)
             for i, r in enumerate(reals)]
    params0 = [
        build_sim_params(r.inst, r.jobs, margin=cfg.scenario_margin,
                         fail_link_slot=fl, fail_node_slot=fn)
        for r, (fl, fn) in zip(reals, fails)
    ]
    mults = [
        rate_profile(spec.traffic, total_slots * float(p.dt), segments,
                     seed=lane_seed(spec, i))
        for i, p in enumerate(params0)
    ]

    sim_rows = {}
    for p_idx, kind in enumerate(POLICY_KINDS):
        sim = sims[kind]
        cur = list(reals)
        cur_params = list(params0)
        mob_rngs = [np.random.default_rng(lane_seed(spec, i) + 2)
                    for i in range(fleet)]
        seeded = _seeded_draws(spec, p_idx, segments, fleet)
        states = None
        init_rates = jobs_u.rate
        migrated_drops = 0
        dsts = []
        synchronize(dev)
        t_sim = time.perf_counter()  # nondet-ok(sim wall time is a measurement)
        for seg in range(segments):
            paramss = stack_instances([
                dataclasses.replace(p, arr_p=torch.clamp(p.arr_p * mults[i][seg], 0.0, 1.0))
                for i, p in enumerate(cur_params)
            ])
            run = sim.run(
                stack_instances([r.inst for r in cur]),
                stack_instances([r.jobs for r in cur]),
                paramss,
                seeded(seg) if draws is None else draws(spec, kind, seg, sim, fleet),
                states=states, init_rates=init_rates,
            )
            states = run.state
            dsts.append(run.routes.dst.cpu().tolist())
            # freshest empirical rate estimate seeds the next segment's
            # first policy round (closed-loop continuation across segments)
            init_rates = run.est_rates[:, -1, :]
            if spec.mobility is not None and seg < segments - 1:
                new_states = []
                for i in range(fleet):
                    st_i = _lane(states, i)
                    before = int(st_i.dropped.sum())
                    new_r, link_map = mobility_step(spec, cur[i], pad, layout=lay,
                                                    rng=mob_rngs[i])
                    cur[i] = new_r
                    cur_params[i] = build_sim_params(
                        new_r.inst, new_r.jobs, margin=cfg.scenario_margin,
                        fail_link_slot=fails[i][0], fail_node_slot=fails[i][1],
                    )
                    st_m = migrate_sim_state(st_i, link_map, spec_sim)
                    migrated_drops += int(st_m.dropped.sum()) - before
                    new_states.append(st_m)
                states = stack_instances(new_states)
        sim_wall_s = time.perf_counter() - t_sim  # nondet-ok(same measurement)

        st = {f.name: getattr(states, f.name).cpu().numpy()
              for f in dataclasses.fields(states)}
        generated = st["generated"].sum(axis=1)
        delivered = st["delivered"].sum(axis=1)
        dropped = st["dropped"].sum(axis=1)
        in_flight = st["count"][:, :-1].sum(axis=1)
        gap = generated - delivered - dropped - in_flight
        j = spec_sim.num_jobs
        dt = np.asarray([float(p.dt) for p in cur_params])
        with np.errstate(divide="ignore", invalid="ignore"):
            mean_delay = np.where(
                st["delivered"] > 0,
                st["delay_sum"] / np.maximum(st["delivered"], 1), np.nan
            ) * dt[:, None]
        sim_rows[kind] = {
            "generated": int(generated.sum()),
            "delivered": int(delivered.sum()),
            "dropped": int(dropped.sum()),
            "in_flight": int(in_flight.sum()),
            "conservation_gap": int(np.abs(gap).sum()),
            "conservation_ok": bool((gap == 0).all()),
            "delivered_ratio": float(delivered.sum()
                                     / max(int(generated.sum()), 1)),
            "mean_packet_delay": float(np.nanmean(mean_delay[:, :j]))
            if np.isfinite(mean_delay[:, :j]).any() else None,
            "migration_drops": migrated_drops,
            "sim_wall_s": sim_wall_s,
            "per_lane": {"generated": generated.tolist(),
                         "delivered": delivered.tolist(),
                         "dropped": dropped.tolist(),
                         "conservation_gap": gap.tolist(),
                         "dst_per_segment": dsts},
        }

    dr = {k: sim_rows[k]["delivered_ratio"] for k in POLICY_KINDS}
    tau = {k: analytic[k]["tau"] for k in POLICY_KINDS}
    deltas = {
        "delivered_ratio_gnn_minus_greedy": round(dr["gnn"] - dr["baseline"], 6),
        "delivered_ratio_gnn_minus_local": round(dr["gnn"] - dr["local"], 6),
        "tau_ratio_gnn_over_greedy": round(tau["gnn"] / tau["baseline"], 6)
        if tau["baseline"] > 0 else None,
        "tau_ratio_gnn_over_local": round(tau["gnn"] / tau["local"], 6)
        if tau["local"] > 0 else None,
    }
    return {
        "name": spec.name,
        "hash": spec_hash(spec),
        "family": spec.family,
        "n_nodes": spec.n_nodes,
        "axes": {
            "traffic": _traffic_axes(spec.traffic),
            "mu_spread": spec.mu_spread,
            "failures": [dataclasses.asdict(f) for f in spec.failures],
            "mobility": spec.mobility is not None,
            "objective": dataclasses.asdict(spec.objective),
        },
        "util": spec.util,
        "lanes": fleet,
        "slots": total_slots,
        "segments": segments,
        "analytic": analytic,
        "sim": sim_rows,
        "deltas": deltas,
        "conservation_ok": all(sim_rows[k]["conservation_ok"]
                               for k in POLICY_KINDS),
        "wall_s": time.perf_counter() - t_leg,  # nondet-ok(same measurement)
    }


def _shift_drift_rows(specs: Dict[str, object], ticks: int = 96,
                      at_tick: int = 32) -> List[dict]:
    """Two scenario switches through the drift detectors: a traffic-shape
    shift (flash crowd arrives) and an objective shift (energy price moves
    the offload fraction)."""
    from multihop_offload_tpu_torch.loop.drift import shift_campaign
    from multihop_offload_tpu_torch.scenarios.shift import shift

    pairs = [("ba_poisson", "grp_flash"), ("grid_poisson", "grid_energy")]
    rows = []
    for a, b in pairs:
        if a in specs and b in specs:
            rows.append(shift_campaign(shift(specs[a], specs[b], at_tick),
                                       ticks))
    return rows


def shared_pad(specs, fleet: int, round_to: int):
    """ONE pad over every scenario and lane: the shared shape every leg
    runs at."""
    from multihop_offload_tpu_torch.graphs.instance import PadSpec
    from multihop_offload_tpu_torch.graphs.topology import build_topology
    from multihop_offload_tpu_torch.scenarios.build import draw_topology

    max_n, max_l, max_j = 0, 0, 0
    for s in specs:
        for i in range(fleet):
            adj, pos = draw_topology(s, lane=i)
            max_l = max(max_l, build_topology(adj, pos=pos).num_links)
        max_n = max(max_n, s.n_nodes)
        max_j = max(max_j, s.num_jobs)
    rt = round_to
    return PadSpec(n=-(-max_n // rt) * rt, l=-(-max_l // rt) * rt, s=rt,
                   j=max(max_j, rt))


def run_matrix(cfg: Config, smoke: bool, device=None, names=None, shapes=None,
               draws: Optional[Callable] = None) -> dict:
    """The campaign on `device` (default CUDA, no fallback); returns the
    JSON-ready record (asserts under smoke).  `names` (the presets) and
    `shapes` (`scenario_*` settings) replace the smoke's subset and
    shapes, or the full run's `scenario_names`; `draws` replaces the
    seeded draws (`_run_leg`)."""
    from multihop_offload_tpu_torch._device import resolve_device
    from multihop_offload_tpu_torch.cli.sim import load_gnn
    from multihop_offload_tpu_torch.env.policies import baseline_policy
    from multihop_offload_tpu_torch.obs.spans import span
    from multihop_offload_tpu_torch.scenarios import presets as presets_mod
    from multihop_offload_tpu_torch.scenarios.build import realize
    from multihop_offload_tpu_torch.sim.state import spec_for

    dev = resolve_device(device)
    if smoke:
        cfg = dataclasses.replace(cfg, **(_SMOKE_SHAPES if shapes is None else shapes))
        names = list(_SMOKE_SCENARIOS if names is None else names)
    else:
        if shapes:
            cfg = dataclasses.replace(cfg, **shapes)
        if names is None and cfg.scenario_names:
            names = [n.strip() for n in cfg.scenario_names.split(",") if n.strip()]
        names = list(presets_mod.preset_names() if names is None else names)
    specs = [presets_mod.preset(n) for n in names]

    lay = cfg.layout
    fleet = cfg.scenario_fleet
    pad = shared_pad(specs, fleet, cfg.round_to)
    model, _ = load_gnn(cfg, dev)

    # the util pin's analytic baseline (null objective, shared everywhere)
    def bp_pin(i, j, g=None):
        return baseline_policy(i, j, g, layout=lay)

    # a probe realization defines the shared SimSpec (pad-derived, so any
    # lane of any scenario produces the identical spec)
    probe = realize(specs[0], pad, lane=0, layout=lay, device=dev)
    spec_sim = spec_for(probe.inst, probe.jobs, cap=cfg.scenario_cap)
    programs = _Programs(cfg, spec_sim, model, dev)
    programs.get(presets_mod.preset("ba_poisson").objective)  # null build

    rows = []
    for s in specs:
        print(f"[scenario-matrix] leg {s.name} ...", file=sys.stderr)  # print-ok(operator progress line on stderr)
        # one host span (and profiler range) a leg: `scenarios/<name>`
        with span(f"scenarios/{s.name}"):
            rows.append(_run_leg(s, cfg, pad, spec_sim, programs, bp_pin, draws=draws))

    all_specs = {n: presets_mod.preset(n) for n in presets_mod.preset_names()}
    shift_rows = _shift_drift_rows(all_specs)

    families = sorted({r["family"] for r in rows})
    record = {
        "description": "scenario matrix: every scenario preset through the "
                       "analytic evaluator AND the packet-level FleetSim in one "
                       "process: one shared pad, three fleet simulators reused "
                       "across all legs, per-scenario GNN-vs-local-vs-greedy "
                       "deltas, exact packet conservation, scenario-shift drift rows",
        "generated_by": "python -m multihop_offload_tpu_torch.cli.scenarios "
                        "--matrix" + (" --smoke" if smoke else ""),
        "platform": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "smoke": smoke,
        "config": {
            "fleet_lanes": fleet,
            "segments": cfg.scenario_segments,
            "rounds_per_segment": cfg.scenario_rounds,
            "slots_per_round": cfg.scenario_slots,
            "cap": cfg.scenario_cap,
            "margin": cfg.scenario_margin,
            "pad": {"n": pad.n, "l": pad.l, "s": pad.s, "j": pad.j},
            "policies": list(POLICY_KINDS),
        },
        "scenarios": rows,
        "families": families,
        "new_families_covered": [f for f in presets_mod.NEW_FAMILIES
                                 if f in families],
        "shift_drift": shift_rows,
        "conservation_ok_all": all(r["conservation_ok"] for r in rows),
        "unexpected_retraces": None,
    }

    if smoke:
        checks = {
            "all_legs_ran": len(rows) == len(names),
            "both_paths_per_scenario": all(
                set(r["analytic"]) == set(POLICY_KINDS)
                and set(r["sim"]) == set(POLICY_KINDS) for r in rows),
            "conservation_exact": record["conservation_ok_all"],
            "new_families_covered": set(record["new_families_covered"])
            == set(presets_mod.NEW_FAMILIES),
            "packets_flowed": all(
                r["sim"][k]["generated"] > 0 and r["sim"][k]["delivered"] > 0
                for r in rows for k in POLICY_KINDS),
            "shift_drift_detected": all(
                s["detected"] and not s["false_positive"]
                for s in shift_rows),
            "no_unexpected_retraces": {"ok": None,
                                       "not_applicable": NOT_APPLICABLE_RETRACES},
        }
        record["checks"] = checks
        record["ok"] = all(v for v in checks.values() if isinstance(v, bool))
        assert record["ok"], f"scenario matrix smoke failed: {checks}"
    return record
