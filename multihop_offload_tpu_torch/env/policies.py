"""End-to-end policy evaluations: decision -> routing -> empirical delays.

Port of `multihop_offload_tpu/env/policies.py`: the shared skeleton of the
baseline method and the GNN policy (weight matrix, APSP, greedy decision,
next-hop table, route tracing, empirical scoring), plus the `baseline` and
`local` methods.  All functions take a batch (leading B).

The APSP takes the route of `apsp_impl` (`ops.minplus.resolve_apsp`, as
JAX threads `apsp_fn`): `'xla'`, the default, squares at every N (JAX
with `apsp_fn=None`); `'pallas'` and `'auto'` take the blocked FW above
a padded N of 256.  Under `layout="sparse"` (`:77-104`) the APSP is fed
from the link list (K6, `ops.minplus.resolve_coo_apsp`, the JAX
`apsp_edges_fn` regime) and the next-hop table comes from two
segment-mins over the directed links; both equal the dense chain of the
same route bit for bit, so decisions never depend on the layout.  A
`precision` policy (`precision.py`) narrows the APSP to its compute
dtype: bf16 W and shortest paths (K2, K3 or K6 in bf16 on the card),
re-accumulated wide by the islands downstream.
"""

from __future__ import annotations

import dataclasses

import torch

from multihop_offload_tpu_torch._phases import phase
from multihop_offload_tpu_torch.env.apsp import (
    next_hop_table,
    weight_matrix_from_link_delays,
)
from multihop_offload_tpu_torch.env.baseline import baseline_unit_delays
from multihop_offload_tpu_torch.env.offloading import OffloadDecision, offload_decide
from multihop_offload_tpu_torch.env.queueing import EmpiricalDelays, run_empirical
from multihop_offload_tpu_torch.env.routing import RouteSet, trace_routes
from multihop_offload_tpu_torch.layouts.policy import resolve_layout
from multihop_offload_tpu_torch.layouts.sparse import (
    next_hop_from_edges,
    weight_matrix_from_edges,
)
from multihop_offload_tpu_torch.ops.minplus import resolve_apsp, resolve_coo_apsp
from multihop_offload_tpu_torch.precision import resolve_precision


@dataclasses.dataclass
class PolicyOutcome:
    decision: OffloadDecision
    routes: RouteSet
    delays: EmpiricalDelays

    @property
    def job_total(self):
        return self.delays.job_total


def shortest_paths(inst, link_delays: torch.Tensor, layout=None,
                   precision=None, apsp_impl: str = "xla", apsp_fn=None) -> torch.Tensor:
    """(B, N, N) shortest-path delays over per-link delays (B, L) on the
    route of `apsp_impl`: K2 (or K3) on the dense weight matrix, or K6 on
    the link list under the sparse layout.  Under a mixed `precision`
    policy the APSP runs in its compute dtype (`PrecisionPolicy.wrap_apsp`):
    the dense W is narrowed before K2, and K6 takes the narrowed delays,
    which builds the same bf16 W (each entry is one delay, and rounding
    commutes with the min).  `apsp_fn`, a callable of the (B, N, N) weight
    matrix (the ring APSP of `parallel.data_parallel` when the mesh's
    `graph` axis is larger than 1), replaces the route in either layout:
    the weight matrix is built from the link list under the sparse layout,
    as JAX's `forward_backward` builds it when `apsp_edges_fn` is None."""
    pol = resolve_precision(precision)
    n = inst.num_pad_nodes
    sparse = resolve_layout(layout).sparse
    if apsp_fn is not None:
        if sparse:
            w = weight_matrix_from_edges(inst.link_ends, inst.link_mask, link_delays, n)
        else:
            w = weight_matrix_from_link_delays(inst.adj, inst.link_index, link_delays)
        return pol.wrap_apsp(apsp_fn)(w)
    if sparse:
        edges_fn, _ = resolve_coo_apsp(apsp_impl, n)
        return edges_fn(inst.link_ends, inst.link_mask, pol.cast_compute(link_delays), n)
    apsp, _ = resolve_apsp(apsp_impl, n)
    return pol.wrap_apsp(apsp)(
        weight_matrix_from_link_delays(inst.adj, inst.link_index, link_delays))


def next_hops(inst, sp: torch.Tensor, layout=None) -> torch.Tensor:
    """The greedy next-hop table of either layout (equal bit for bit)."""
    if resolve_layout(layout).sparse:
        return next_hop_from_edges(inst.link_ends, inst.link_mask, sp)
    return next_hop_table(inst.adj, sp)


def evaluate_spmatrix_policy(
    inst, jobs, link_delays: torch.Tensor, unit_diag: torch.Tensor,
    gen: torch.Generator | None = None, explore: float = 0.0, prob: bool = False,
    layout=None, precision=None, apsp_impl: str = "xla", apsp_fn=None,
    objective=None,
) -> PolicyOutcome:
    """Offload + route + run given per-link unit delays (B, L) and a node
    diagonal (B, N), the APSP on the route of `apsp_impl` (or `apsp_fn`,
    see `shortest_paths`) under the `precision` policy (None: fp32).
    `objective` (`env.offloading.ObjectiveWeights` | None) biases the
    decision only; the scoring stays physical."""
    with phase("apsp"):
        sp = shortest_paths(inst, link_delays, layout, precision, apsp_impl, apsp_fn)
    with phase("offload_decide"):
        # hop counts are topology-only and precomputed at Instance build time
        dec = offload_decide(inst, jobs, sp, inst.hop, unit_diag, gen, explore, prob,
                             objective=objective)
    with phase("next_hops"):
        nh = next_hops(inst, sp, layout)
    with phase("trace_routes"):
        routes = trace_routes(inst, nh, jobs, dec.dst)
    with phase("run_empirical"):
        delays = run_empirical(inst, jobs, routes, layout)
    return PolicyOutcome(decision=dec, routes=routes, delays=delays)


def baseline_policy(inst, jobs, gen: torch.Generator | None = None,
                    explore: float = 0.0, prob: bool = False,
                    layout=None, precision=None, apsp_impl: str = "xla",
                    objective=None) -> PolicyOutcome:
    """Congestion-agnostic greedy offloading (under `objective`'s weights)."""
    link_d, node_d = baseline_unit_delays(inst)
    return evaluate_spmatrix_policy(inst, jobs, link_d, node_d, gen, explore, prob,
                                    layout, precision, apsp_impl, objective=objective)


def local_policy(inst, jobs, layout=None) -> PolicyOutcome:
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
                         delays=run_empirical(inst, jobs, routes, layout))
