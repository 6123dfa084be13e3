"""Closed-loop RL entry point: the actor trained in the packet simulator.

Port of `multihop_offload_tpu/cli/rl.py`:

    python -m multihop_offload_tpu_torch.cli.rl [--device cpu] --smoke
    python -m multihop_offload_tpu_torch.cli.rl            # the rl_* knobs
    python -m multihop_offload_tpu_torch.cli.rl --rl_mesh 4

Builds a fleet of random BA scenarios rescaled to the `rl_util`
bottleneck utilization, then drives `rl.RLTrainer`: every step rolls out
the GNN actor against the packet simulator and applies the REINFORCE /
Adam update.  `--smoke` (8 nodes, 3 jobs, cap 64, fleet 4, 2 rounds x 100
slots, 20 steps, as JAX's) asserts the subsystem's gates: the devmetrics
packet counters equal the host's conservation totals exactly, no update
is skipped, and every step after the first launches the same kernels the
same number of times (the port's counterpart of JAX's zero unexpected
retraces, which is null in the record; on the CPU no kernel launches).
JAX's fourth gate, the learned policy beating its own random init on the
sampling policy's delivered ratio (4 fixed-draw evaluations each), is
evaluated and recorded (`improved`) and reported when it fails, which it
does at seed 0: the update collapses the relu output unit within the 20
steps, as it does in JAX's own run at that seed, and the comparison then
measures the evaluation draws (ROADMAP.md Queue 3).  A train run saves its
parameters and Adam state with ``source="rl"`` lineage into
``<model_dir>/torch_rl`` (JAX: ``orbax_rl``).  It runs on CUDA unless
`--device cpu` is given.  The record is printed, and written where
`--rl_out` points.

The scenario fleet is JAX's (`cli/sim.py`'s generator and `sim_*` shape
knobs, graph `seed + 100 i`, no failures); the weights are a fresh init of
the port's own generator at `seed` (`make_rl_model`), and the draws the
port's (one `torch.Generator` per lane and step, `train_seeds`,
`eval_seeds`), so a run is not JAX's run draw for draw.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import torch

from multihop_offload_tpu_torch.config import Config, build_parser

# JAX's smoke configuration (`cli/rl.py:255-258`)
SMOKE = dict(sim_nodes=8, sim_jobs=3, sim_cap=64, rl_fleet=4, rl_rounds=2, rl_slots=100,
             rl_steps=20)
RL_SUBDIR = "torch_rl"
# the fleet, the simulator's state and the initial rates at any `cfg.dtype`
# (JAX: `make_case`'s default, `RLTrainer(sim_dtype=jnp.float32)`, `rates0`)
FLEET_DTYPE = torch.float32


def build_fleet(cfg: Config, device=None):
    """Random BA scenario fleet at the `rl_util` utilization target on
    `device` (default CUDA): `(insts, jobss, paramss, spec, pad)` with the
    fleet axis leading.  The scenario generator of `cli.sim.
    build_scenarios` (`sim_nodes`, `sim_jobs`, `sim_cap`, `sim_margin`,
    sparse nnz pads sized from the data), without failure injection.  The
    fleet is float32 whatever `cfg.dtype` is, as JAX's (`make_case`'s
    default dtype): the simulator and the actor's inputs run on it, and
    only the model takes `cfg.dtype` and the precision policy."""
    import numpy as np

    from multihop_offload_tpu_torch._device import resolve_device
    from multihop_offload_tpu_torch.env.policies import baseline_policy
    from multihop_offload_tpu_torch.graphs import generators
    from multihop_offload_tpu_torch.graphs.instance import PadSpec, stack_instances
    from multihop_offload_tpu_torch.graphs.topology import build_topology
    from multihop_offload_tpu_torch.layouts.policy import resolve_layout
    from multihop_offload_tpu_torch.layouts.sparse import cf_nnz_count, ext_nnz_count
    from multihop_offload_tpu_torch.sim.fidelity import make_case, scale_to_util
    from multihop_offload_tpu_torch.sim.state import build_sim_params, spec_for

    dev = resolve_device(device)
    fleet, n_nodes = cfg.rl_fleet, cfg.sim_nodes
    topos = [build_topology(generators.barabasi_albert(n_nodes, seed=cfg.seed + 100 * i)[0])
             for i in range(fleet)]
    r = cfg.round_to
    pad = PadSpec(n=-(-n_nodes // r) * r, l=-(-max(t.num_links for t in topos) // r) * r,
                  s=r, j=max(cfg.sim_jobs, r))
    lay = cfg.layout
    if resolve_layout(lay).sparse:
        pad = dataclasses.replace(
            pad, enn=PadSpec.round_up(max(ext_nnz_count(t, np.ones(t.n, bool))
                                          for t in topos), 128),
            cnn=PadSpec.round_up(max(cf_nnz_count(t) for t in topos), 128))
    cases = [make_case(cfg.seed + 100 * i, topos[i], pad, cfg.sim_jobs, dtype=FLEET_DTYPE,
                       layout=lay, device=dev) for i in range(fleet)]
    insts = stack_instances([c[0] for c in cases])
    jobss, _ = scale_to_util(insts, stack_instances([c[1] for c in cases]), None, cfg.rl_util,
                             policy_fn=lambda i, j, g: baseline_policy(i, j, g, layout=lay))
    paramss = stack_instances([
        build_sim_params(inst, dataclasses.replace(jobs, rate=jobss.rate[i]),
                         margin=cfg.sim_margin)
        for i, (inst, jobs) in enumerate(cases)])
    return insts, jobss, paramss, spec_for(insts, jobss, cap=cfg.sim_cap), pad


def train_seeds(cfg: Config, step: int) -> list:
    """The per-lane draw seeds of train step `step`."""
    base = 1_000_000 * (cfg.seed + 1) + cfg.rl_fleet * step
    return [base + i for i in range(cfg.rl_fleet)]


def eval_seeds(cfg: Config, batch: int) -> list:
    """The per-lane draw seeds of evaluation batch `batch` (the same for
    both contenders of the A/B)."""
    return [1_000_000 * (cfg.seed + 777 + batch) + i for i in range(cfg.rl_fleet)]


def make_rl_model(cfg: Config, insts, jobss):
    """A fresh `ChebNet` for `cfg` (layout, K, width) under its precision
    policy on the fleet's device (`cfg.precision_policy`, as JAX's
    `make_model(cfg)`: parameters at the policy's `param_dtype`, under the
    mixed policy bf16 operands with float32 accumulation): glorot weights
    from a generator seeded `cfg.seed`, the
    output layer's sign flipped where the draw is dead at birth on the
    fleet (`ensure_alive_output_multi`, one probe a lane, as the Trainer
    guards its fresh init: a dead relu output has exactly zero gradients).
    JAX's `cli/rl.py` keeps its draw as it is; the port's draw at the same
    seed is another (ROADMAP.md Queue 3)."""
    from multihop_offload_tpu_torch._records import slice_records
    from multihop_offload_tpu_torch.agent.actor import build_ext_features, default_support
    from multihop_offload_tpu_torch.models.chebconv import ensure_alive_output_multi, make_model

    dev = insts.adj.device
    model = make_model(cfg, layout=cfg.layout, policy=cfg.precision_policy(dev),
                       generator=torch.Generator().manual_seed(cfg.seed)).to(dev)
    probes = []
    for i in range(insts.adj.shape[0]):
        inst, jobs = slice_records(insts, i, i + 1), slice_records(jobss, i, i + 1)
        probes.append((build_ext_features(inst, jobs), default_support(model, inst, cfg.layout),
                       inst.ext_mask))
    return ensure_alive_output_multi(model, probes)


def run_train(cfg: Config, smoke: bool = False, device=None) -> dict:
    """Train the actor in the closed loop on `device` (default CUDA);
    returns the JSON record.  In smoke mode the gates are asserted."""
    from multihop_offload_tpu_torch._device import resolve_device, synchronize
    from multihop_offload_tpu_torch.large_scale import kernel_counts
    from multihop_offload_tpu_torch.parallel.mesh import make_mesh
    from multihop_offload_tpu_torch.rl import RLTrainer, delivered_ratio, make_eval
    from multihop_offload_tpu_torch.sim.step import (
        DM_DELIVERED,
        DM_DROP_ARR,
        DM_DROP_CAP,
        DM_DROP_FWD,
        DM_GENERATED,
    )

    dev = resolve_device(device)
    fleet = cfg.rl_fleet
    insts, jobss, paramss, spec, _ = build_fleet(cfg, dev)
    mesh = None
    if cfg.rl_mesh > 1:
        if fleet % cfg.rl_mesh:
            raise ValueError(f"rl_fleet={fleet} must divide over rl_mesh={cfg.rl_mesh}")
        mesh = make_mesh(cfg.rl_mesh, 1, None if dev.type == "cuda" else [dev] * cfg.rl_mesh)

    model = make_rl_model(cfg, insts, jobss)
    init_params = {k: p.detach().clone() for k, p in model.named_parameters()}
    trainer = RLTrainer(cfg, model, spec, mesh=mesh, sim_dtype=FLEET_DTYPE)
    ev = make_eval(cfg, model, spec)
    states0 = trainer.init_states(fleet, dev)
    rates0 = torch.zeros((fleet, spec.num_jobs), dtype=FLEET_DTYPE, device=dev)

    def eval_ratio(params, batches: int = 4) -> float:
        """Mean delivered ratio of the sampling policy over `batches`
        fixed-draw fleet evaluations: the averaging smooths the step
        function of any single sampled run."""
        return sum(delivered_ratio(ev(params, insts, jobss, paramss, states0, rates0,
                                      eval_seeds(cfg, e)))
                   for e in range(batches)) / batches

    ratio_init = eval_ratio(init_params)
    host = {"generated": 0, "delivered": 0, "dropped": 0}
    losses, skipped, launches, grad_norm_last = [], 0, [], float("nan")
    synchronize(dev)
    t0 = time.perf_counter()
    for step in range(cfg.rl_steps):
        before = kernel_counts()
        out = trainer.train_step(insts, jobss, paramss, train_seeds(cfg, step))
        after = kernel_counts()
        # launches, not K2's squarings that ran (its early stop follows the data)
        launches.append({k: after[k] - before[k] for k in after
                         if after[k] != before[k] and not k.startswith("squarings")})
        st = out.state
        # fresh empty states each step: the terminal counters are the step's
        # packet totals, and summed over steps they equal the flushed
        # device-side accumulators exactly
        host["generated"] += int(st.generated.sum())
        host["delivered"] += int(st.delivered.sum())
        host["dropped"] += int(st.dropped.sum())
        losses.append(float(out.loss))
        skipped += int(out.skipped)
        grad_norm_last = float(out.grad_norms.max())
        if step == 0:
            t0 = time.perf_counter()  # throughput excludes the first step
    elapsed = time.perf_counter() - t0
    timed_episodes = fleet * max(cfg.rl_steps - 1, 0)
    ratio_trained = eval_ratio(trainer.params)
    tot = trainer.sim_totals
    devc = {
        "generated": int(round(tot.get(DM_GENERATED, 0))),
        "delivered": int(round(tot.get(DM_DELIVERED, 0))),
        "dropped": int(round(tot.get(DM_DROP_FWD, 0) + tot.get(DM_DROP_ARR, 0)
                             + tot.get(DM_DROP_CAP, 0))),
    }
    steady = all(c == launches[1] for c in launches[1:]) if len(launches) > 1 else True
    record = {
        "mode": "smoke" if smoke else "train",
        "platform": dev.type,
        "devices": len(trainer.devices),
        "fleet": fleet,
        "mesh": cfg.rl_mesh,
        "nodes": cfg.sim_nodes,
        "jobs": cfg.sim_jobs,
        "rounds": cfg.rl_rounds,
        "slots_per_round": cfg.rl_slots,
        "steps": cfg.rl_steps,
        "rho_target": cfg.rl_util,
        "temperature": cfg.rl_temp,
        "lr": cfg.rl_lr,
        "ent_weight": cfg.rl_ent,
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "skipped_updates": skipped,
        # a JAX measure with no counterpart here: the port's gate is
        # `steady_launches`, the same kernel launches in every step after
        # the first
        "unexpected_retraces": None,
        "launches_per_step": launches[-1] if launches else {},
        "steady_launches": steady,
        "conservation": {"host": host, "device": devc, "exact": devc == host},
        "delivered_ratio_init": ratio_init,
        "delivered_ratio_trained": ratio_trained,
        "improved": ratio_trained > ratio_init,
        # 0 when the relu output unit has collapsed (every lane's gradient
        # exactly zero): the trained policy then ignores its input
        "grad_norm_last": grad_norm_last,
        "episodes_per_s": timed_episodes / max(elapsed, 1e-9),
        "timed_episodes": timed_episodes,
        "timed_wall_s": elapsed,
    }
    if smoke:
        if not steady:
            raise AssertionError(f"the steps' kernel launches differ: {launches}")
        if not record["conservation"]["exact"]:
            raise AssertionError(f"devmetrics diverge from host conservation: dev={devc} "
                                 f"host={host}")
        if skipped:
            raise AssertionError(f"{skipped} updates skipped in the smoke")
        if not record["improved"]:
            # a finding, not a fault of the port (ROADMAP.md Queue 3): the
            # update collapses the relu output unit within the 20 steps, in
            # JAX's run at this seed too, so the trained policy is constant
            # and the comparison measures the evaluation draws
            print(f"rl smoke: the trained policy did not beat its init "
                  f"(init={ratio_init:.4f} trained={ratio_trained:.4f}; last step's largest "
                  f"gradient norm {record['grad_norm_last']:.3e}): ROADMAP.md Queue 3")
    else:
        directory = os.path.join(cfg.model_dir(), RL_SUBDIR)
        step_id = trainer.save(directory, extra={"delivered_ratio": ratio_trained})
        record["checkpoint"] = {"dir": directory, "step": step_id}
    return record


def main(argv=None) -> int:
    from multihop_offload_tpu_torch import obs

    p = build_parser(description=__doc__)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--smoke", action="store_true",
                   help="small closed-loop proof with its gates asserted")
    ns = vars(p.parse_args(argv))
    device, smoke = ns.pop("device"), ns.pop("smoke")
    cfg = Config(**ns)
    if smoke:
        cfg = dataclasses.replace(cfg, **SMOKE)
    runlog = obs.start_run(cfg, role="rl")
    try:
        out = run_train(cfg, smoke=smoke, device=device)
        if cfg.rl_out:
            os.makedirs(os.path.dirname(cfg.rl_out) or ".", exist_ok=True)
            with open(cfg.rl_out, "w") as f:
                json.dump(out, f, indent=1)
                f.write("\n")
            print(f"rl record written to {cfg.rl_out}")
    finally:
        obs.finish_run(runlog)
    print(json.dumps(out, indent=2, default=str))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
