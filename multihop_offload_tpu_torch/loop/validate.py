"""Sim-gated A/B validation: champion vs candidate on held-out workload.

Port of `multihop_offload_tpu/loop/validate.py`, over the port's `sim/`.
The held-out slice of the captured experience (`experience.split_holdout`)
is replayed through the packet-level simulator (`sim.runner.FleetSim`) --
NOT through the analytic evaluator the candidate was just fit on -- once
under the champion's weights and once under the candidate's.  Same
instances, same arrival randomness (the same lane seeds), same horizon;
the only difference is the policy deciding offloads each round (the `gnn`
policy: K1 and K2 on the card), so the score deltas are attributable to
the weights alone.

The port's `gnn` policy reads its weights from the model it is given, so
each arm runs on its own copy of `model` carrying that arm's parameters.

`apply_gates` is the pure decision rule -- configurable absolute
delivered-ratio drop and relative tau (mean packet delay) ratio -- kept
free of sim state so tests can drive it on synthetic score pairs.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import numpy as np
import torch

from multihop_offload_tpu_torch._device import resolve_device
from multihop_offload_tpu_torch.graphs.instance import (
    build_instance,
    build_jobset,
    stack_instances,
)
from multihop_offload_tpu_torch.layouts.policy import resolve_layout
from multihop_offload_tpu_torch.loop.experience import Outcome, pad_for_outcomes
from multihop_offload_tpu_torch.obs.spans import span
from multihop_offload_tpu_torch.sim.policies import make_policy
from multihop_offload_tpu_torch.sim.runner import FleetSim
from multihop_offload_tpu_torch.sim.state import build_sim_params, spec_for


def build_validation_fleet(
    outcomes: Sequence[Outcome],
    pad=None,
    margin: float = 5.0,
    round_to: int = 8,
    dtype=torch.float32,
    layout=None,
    device="cpu",
):
    """Stack the held-out requests into one sim fleet on `device`.

    Returns (insts, jobss, paramss, init_rates, dts, spec_args) -- all lanes
    share one pad shape so champion and candidate each run the whole slice
    as one fleet."""
    pad = pad_for_outcomes(outcomes, round_to=round_to, layout=layout) \
        if pad is None else pad
    lay = resolve_layout(layout)
    index_dtype = lay.index_dtype if lay.sparse else np.int32
    insts, jobss, params_list = [], [], []
    for o in outcomes:
        r = o.request
        inst = build_instance(r.topo, r.roles, r.proc_bws, r.link_rates, r.t_max, pad,
                              dtype=dtype, device="cpu", layout=layout)
        jobs = build_jobset(r.job_src, r.job_rate, pad_jobs=pad.j, ul=r.ul, dl=r.dl,
                            dtype=dtype, device="cpu", index_dtype=index_dtype)
        insts.append(inst)
        jobss.append(jobs)
        params_list.append(build_sim_params(inst, jobs, margin=margin))
    init_rates = torch.stack([j.rate for j in jobss])
    dts = np.asarray([float(p.dt) for p in params_list])
    return (
        stack_instances(insts).to(device),
        stack_instances(jobss).to(device),
        stack_instances(params_list).to(device),
        init_rates.to(device),
        dts,
        (insts[0], jobss[0]),
    )


def score_run(state, dts: np.ndarray) -> dict:
    """Summarize one fleet run: delivered ratio + delivered-weighted mean
    packet delay in model time (per-lane dt restores the time unit)."""
    generated_l = state.generated.cpu().numpy()
    delivered_l = state.delivered.cpu().numpy()
    generated = int(generated_l.sum())
    delivered = int(delivered_l.sum())
    dropped = int(state.dropped.cpu().numpy().sum())
    # delay_sum is in slots; convert per lane, then pool over the fleet
    lane_delay = state.delay_sum.cpu().numpy().astype(np.float64).sum(axis=1) * dts
    total_delivered = delivered_l.sum(axis=1).sum()
    mean_delay = (
        float(lane_delay.sum() / total_delivered) if total_delivered else None
    )
    return {
        "generated": generated,
        "delivered": delivered,
        "dropped": dropped,
        "delivered_ratio": delivered / max(generated, 1),
        "mean_packet_delay": mean_delay,
    }


def lane_seeds(seed: int, fleet: int) -> List[int]:
    """One draw seed per lane, shared by both arms."""
    return [int(seed) * 1_000_003 + i for i in range(fleet)]


def model_with(model, params: dict, device):
    """A copy of `model` on `device` carrying `params` (a state dict)."""
    m = copy.deepcopy(model).to(device)
    m.load_state_dict({k: v.to(device) for k, v in params.items()})
    return m


def ab_compare(
    model,
    champion_variables,
    candidate_variables,
    outcomes: Sequence[Outcome],
    rounds: int = 2,
    slots_per_round: int = 200,
    cap: int = 64,
    margin: float = 5.0,
    seed: int = 0,
    round_to: int = 8,
    precision=None,
    dtype=torch.float32,
    layout=None,
    device=None,
) -> dict:
    """Replay the held-out workload under both policies on `device`
    (default CUDA); returns {"champion": score, "candidate": score, ...}."""
    if not outcomes:
        raise ValueError("validation needs at least one held-out outcome")
    dev = resolve_device(device)
    insts, jobss, paramss, init_rates, dts, (inst0, jobs0) = build_validation_fleet(
        outcomes, margin=margin, round_to=round_to, dtype=dtype, layout=layout,
        device=dev)
    spec = spec_for(inst0, jobs0, cap=cap)
    fleet = len(outcomes)
    scores = {}
    for name, variables in (("champion", champion_variables),
                            ("candidate", candidate_variables)):
        policy = make_policy("gnn", model=model_with(model, variables["params"], dev),
                             precision=precision, layout=layout)
        sim = FleetSim(spec, policy, rounds=rounds, slots_per_round=slots_per_round,
                       dtype=dtype)
        with span("loop/validate", arm=name, fleet=fleet):
            run = sim.run(insts, jobss, paramss, lane_seeds(seed, fleet),
                          init_rates=init_rates,
                          request_ids=[o.request.request_id for o in outcomes],
                          tag=name)
        scores[name] = score_run(run.state, dts)
    scores["fleet"] = fleet
    scores["slots"] = rounds * slots_per_round
    return scores


def apply_gates(
    champion: dict,
    candidate: dict,
    max_delivered_drop: float,
    max_tau_ratio: float,
) -> tuple:
    """(ok, reasons): the promotion decision rule on two score dicts.

    - delivered ratio may drop at most `max_delivered_drop` (absolute);
    - mean packet delay (tau proxy) may grow at most `max_tau_ratio`
      (relative).  A candidate with no delivered packets fails outright;
      a champion with none passes the tau gate vacuously (nothing to
      regress against).
    """
    reasons: List[str] = []
    dr_c = champion.get("delivered_ratio", 0.0)
    dr_n = candidate.get("delivered_ratio", 0.0)
    if dr_n < dr_c - max_delivered_drop:
        reasons.append(
            f"delivered_ratio {dr_n:.4f} < champion {dr_c:.4f} "
            f"- {max_delivered_drop}"
        )
    tau_c: Optional[float] = champion.get("mean_packet_delay")
    tau_n: Optional[float] = candidate.get("mean_packet_delay")
    if tau_n is None and candidate.get("generated", 0) > 0:
        reasons.append("candidate delivered no packets")
    elif tau_c is not None and tau_n is not None and tau_n > tau_c * max_tau_ratio:
        reasons.append(
            f"mean_packet_delay {tau_n:.4f} > champion {tau_c:.4f} "
            f"* {max_tau_ratio}"
        )
    return (not reasons), reasons
