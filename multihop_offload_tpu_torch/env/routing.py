"""Route tracing over the next-hop table (port of
`multihop_offload_tpu/env/routing.py`).

Every job of every instance descends the next-hop table in lock-step for N
steps (a simple route visits < N nodes), recording the extended-line-graph
slot it crosses at each step; one scatter-add then builds the (E, J) route
incidence.  The N steps are a Python loop of small tensor ops (the JAX
`lax.scan`); on the card each step is a handful of kernel launches.
`with_inc=False` skips the incidence (`inc_ext` is None): the sparse
layout's training step works from the step sequence alone.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RouteSet:
    """Realized routes for all jobs of a batch of instances."""

    dst: torch.Tensor         # (B, J) int32 compute destination (== src if local)
    nhop: torch.Tensor        # (B, J) float hop count of the uplink route
    seq_slot: torch.Tensor    # (B, H, J) int32 ext slot visited at each step
    seq_active: torch.Tensor  # (B, H, J) bool step is a real traversal
    inc_ext: torch.Tensor | None  # (B, E, J) 0/1 incidence incl. the final
    #                           pseudo-link; slots [0, L) are real links;
    #                           None when traced with `with_inc=False`


def trace_routes(inst, next_hop: torch.Tensor, jobs, dst: torch.Tensor,
                 with_inc: bool = True) -> RouteSet:
    """Walk every job's greedy route src -> dst simultaneously.

    `next_hop`: (B, N, N) from `env.apsp.next_hop_table`.  Local jobs
    (dst == src) traverse no links; padded jobs contribute nothing."""
    b, n, _ = next_hop.shape
    num_links = inst.num_pad_links
    num_jobs = jobs.src.shape[1]
    fdt = inst.link_rates.dtype
    nh_flat = next_hop.reshape(b, n * n).long()
    li_flat = inst.link_index.reshape(b, n * n).long()
    dstl = dst.long()
    node = jobs.src.long()
    hops = torch.zeros((b, num_jobs), dtype=fdt, device=next_hop.device)
    links, actives = [], []
    for _ in range(n):
        active = node != dstl
        nxt = torch.gather(nh_flat, 1, node * n + dstl)
        links.append(torch.gather(li_flat, 1, node * n + nxt))  # valid while active
        actives.append(active)
        node = torch.where(active, nxt, node)
        hops = hops + active.to(fdt)
    seq_active = torch.stack(actives, dim=1) & jobs.mask.unsqueeze(1)
    seq_slot = torch.where(seq_active, torch.stack(links, dim=1), 0)

    # incidence over extended slots: real links from the step sequence, then
    # the compute pseudo-link at the destination of every real job.  The
    # added values are 0/1, so the sums are exact in any order.
    inc = None
    if with_inc:
        e = num_links + n
        cols = torch.arange(num_jobs, device=next_hop.device, dtype=torch.long)
        inc = torch.zeros((b, e * num_jobs), dtype=fdt, device=next_hop.device)
        inc.scatter_add_(1, (seq_slot * num_jobs + cols).reshape(b, -1),
                         seq_active.reshape(b, -1).to(fdt))
        inc.scatter_add_(1, (num_links + dstl) * num_jobs + cols,
                         jobs.mask.to(fdt))
        inc = inc.view(b, e, num_jobs)
    return RouteSet(
        dst=dst,
        nhop=torch.where(jobs.mask, hops, torch.zeros((), dtype=fdt,
                                                      device=hops.device)),
        seq_slot=seq_slot.to(torch.int32),
        seq_active=seq_active,
        inc_ext=inc,
    )


def link_incidence(routes: RouteSet, num_links: int) -> torch.Tensor:
    """(..., L, J) real-link incidence slice of the extended incidence."""
    return routes.inc_ext[..., :num_links, :]
