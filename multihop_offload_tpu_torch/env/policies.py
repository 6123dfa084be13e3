"""End-to-end policy evaluations: decision -> routing -> empirical delays.

Port of `multihop_offload_tpu/env/policies.py` (dense layout): the shared
skeleton of the baseline method and the GNN policy (weight matrix, APSP,
greedy decision, next-hop table, route tracing, empirical scoring), plus the
`baseline` and `local` methods.  All functions take a batch (leading B).
"""

from __future__ import annotations

import dataclasses

import torch

from multihop_offload_tpu_torch.env.apsp import (
    apsp_minplus,
    next_hop_table,
    weight_matrix_from_link_delays,
)
from multihop_offload_tpu_torch.env.baseline import baseline_unit_delays
from multihop_offload_tpu_torch.env.offloading import OffloadDecision, offload_decide
from multihop_offload_tpu_torch.env.queueing import EmpiricalDelays, run_empirical
from multihop_offload_tpu_torch.env.routing import RouteSet, trace_routes


@dataclasses.dataclass
class PolicyOutcome:
    decision: OffloadDecision
    routes: RouteSet
    delays: EmpiricalDelays

    @property
    def job_total(self):
        return self.delays.job_total


def evaluate_spmatrix_policy(
    inst, jobs, link_delays: torch.Tensor, unit_diag: torch.Tensor,
    gen: torch.Generator | None = None, explore: float = 0.0, prob: bool = False,
) -> PolicyOutcome:
    """Offload + route + run given per-link unit delays (B, L) and a node
    diagonal (B, N)."""
    w = weight_matrix_from_link_delays(inst.adj, inst.link_index, link_delays)
    sp = apsp_minplus(w)
    # hop counts are topology-only and precomputed at Instance build time
    dec = offload_decide(inst, jobs, sp, inst.hop, unit_diag, gen, explore, prob)
    routes = trace_routes(inst, next_hop_table(inst.adj, sp), jobs, dec.dst)
    return PolicyOutcome(decision=dec, routes=routes,
                         delays=run_empirical(inst, jobs, routes))


def baseline_policy(inst, jobs, gen: torch.Generator | None = None,
                    explore: float = 0.0, prob: bool = False) -> PolicyOutcome:
    """Congestion-agnostic greedy offloading."""
    link_d, node_d = baseline_unit_delays(inst)
    return evaluate_spmatrix_policy(inst, jobs, link_d, node_d, gen, explore, prob)


def local_policy(inst, jobs) -> PolicyOutcome:
    """Everything computes at its source."""
    _, node_d = baseline_unit_delays(inst)
    b, num_jobs = jobs.src.shape
    n = inst.num_pad_nodes
    num_links = inst.num_pad_links
    dev = node_d.device
    srcl = jobs.src.long()
    dec = OffloadDecision(
        dst=jobs.src.to(torch.int32),
        is_local=torch.ones((b, num_jobs), dtype=torch.bool, device=dev),
        delay_est=torch.clamp(torch.gather(node_d, 1, srcl) * jobs.ul, min=1.0),
        costs=torch.zeros((b, num_jobs, inst.servers.shape[1] + 1),
                          dtype=node_d.dtype, device=dev),
    )
    # no links traversed: an identity "route" of zero hops
    cols = torch.arange(num_jobs, device=dev)
    inc = torch.zeros((b, (num_links + n) * num_jobs), dtype=node_d.dtype,
                      device=dev)
    inc.scatter_add_(1, (num_links + srcl) * num_jobs + cols,
                     jobs.mask.to(node_d.dtype))
    routes = RouteSet(
        dst=dec.dst,
        nhop=torch.zeros((b, num_jobs), dtype=node_d.dtype, device=dev),
        seq_slot=torch.zeros((b, n, num_jobs), dtype=torch.int32, device=dev),
        seq_active=torch.zeros((b, n, num_jobs), dtype=torch.bool, device=dev),
        inc_ext=inc.view(b, num_links + n, num_jobs),
    )
    return PolicyOutcome(decision=dec, routes=routes,
                         delays=run_empirical(inst, jobs, routes))
