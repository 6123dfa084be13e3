"""All-pairs shortest paths as dense min-plus linear algebra, batched.

Port of `multihop_offload_tpu/env/apsp.py`.  `apsp_minplus` squares at
every N, as the JAX function does (the `apsp_impl='xla'` route, JAX's
default: K2 on the card, the plain squaring on the CPU); the
`apsp_impl='pallas'` route is `ops.minplus.apsp_minplus_pallas`, which
takes the blocked Floyd-Warshall (K3 on the card) above a 128-rounded N
of 256 (`ops.minplus.resolve_apsp` picks between them).  The greedy
next-hop table breaks ties at the lowest neighbour index, exactly as the
reference's forwarding rule and the JAX table do.  `apsp_minplus` and
`apsp_minplus_blocked` (`env/apsp.py:98-132`, the plain k-blocked squaring
the sparse layout's chain ends in; on the card that chain is K6,
`ops.minplus.apsp_coo_squaring`) are defined in `ops.minplus`.
"""

from __future__ import annotations

import torch

from multihop_offload_tpu_torch.ops.minplus import apsp_minplus, apsp_minplus_blocked  # noqa: F401

# elements of one (b, u, N, N) next-hop cost temp: batches, and at large N
# source rows, are chunked to stay under this (128 MB in float32); a bf16
# temp takes twice as many in the same bytes
_NEXT_HOP_CHUNK_ELEMS = 1 << 25


def hop_matrix(adj: torch.Tensor) -> torch.Tensor:
    """Unweighted shortest-path hop counts (B, N, N)."""
    inf = torch.full((), float("inf"), dtype=adj.dtype, device=adj.device)
    return apsp_minplus(torch.where(adj > 0, torch.ones_like(adj), inf))


def weight_matrix_from_link_delays(
    adj: torch.Tensor, link_index: torch.Tensor, link_delays: torch.Tensor
) -> torch.Tensor:
    """Scatter per-link delays (B, L) into (B, N, N) one-hop weights;
    non-edges get +inf."""
    b, n, _ = adj.shape
    gathered = torch.gather(link_delays, 1,
                            link_index.reshape(b, n * n).long()).view(b, n, n)
    inf = torch.full((), float("inf"), dtype=gathered.dtype, device=adj.device)
    return torch.where(adj > 0, gathered, inf)


def next_hop_table(adj: torch.Tensor, sp: torch.Tensor) -> torch.Tensor:
    """next_hop[b, u, d]: neighbour v of u minimizing sp[b, v, d], lowest v
    on ties (and 0 where every candidate is +inf), as int32 (B, N, N).

    The masked (N, N, N) argmin of the JAX table, chunked over the batch
    and, where one (N, N, N) temp alone is too large, over source rows u,
    so that the cost temp stays bounded; each chunk computes the same
    values.  A bf16 `sp` (the precision policy's bf16 leg) keeps its dtype:
    the chunks hold twice the elements, and ties, far more common in bf16,
    go to the lowest v as in float32."""
    b, n, _ = adj.shape
    out = torch.empty((b, n, n), dtype=torch.int32, device=adj.device)
    elems = _NEXT_HOP_CHUNK_ELEMS * (2 if sp.dtype == torch.bfloat16 else 1)
    step = max(1, elems // max(n ** 3, 1))
    rows = min(n, max(1, elems // max(step * n * n, 1)))
    inf = torch.full((), float("inf"), dtype=sp.dtype, device=sp.device)
    for lo in range(0, b, step):
        a, s = adj[lo:lo + step], sp[lo:lo + step]
        for u0 in range(0, n, rows):
            # cost[b, u, v, d] = sp[b, v, d] if (u, v) is an edge else +inf
            cost = torch.where((a[:, u0:u0 + rows] > 0).unsqueeze(-1), s.unsqueeze(1), inf)
            out[lo:lo + step, u0:u0 + rows] = torch.argmin(cost, dim=2).to(torch.int32)
    return out
