"""Synthetic request workloads for the service: demo, smoke, tests.

Port of `multihop_offload_tpu/serve/workload.py`: a pool of Barabási–Albert
networks with degree-concentrated servers, each request re-realizing link
capacities and drawing a fresh task stream.  The same numpy draws in the
same order as the JAX workload, so the same seeds give the same requests.
Topologies are reused across requests, as repeat clients reuse them.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence

import numpy as np

from multihop_offload_tpu_torch.graphs.generators import barabasi_albert
from multihop_offload_tpu_torch.graphs.topology import (
    Topology,
    build_topology,
    sample_link_rates,
)
from multihop_offload_tpu_torch.serve.bucketing import ShapeBuckets
from multihop_offload_tpu_torch.serve.request import OffloadRequest


@dataclasses.dataclass(frozen=True)
class ServeCase:
    """One reusable network of the traffic pool."""

    topo: Topology
    roles: np.ndarray
    proc_bws: np.ndarray
    mobile_nodes: np.ndarray
    base_rate: float
    key: str                 # hop-cache key

    @property
    def sizes(self) -> tuple:
        """(n, l, s, j_max): worst-case request sizes off this network."""
        return (
            self.topo.n, self.topo.num_links,
            int((self.roles == 1).sum()), int(self.mobile_nodes.size),
        )


def synthetic_case(
    n: int,
    seed: int,
    m: int = 2,
    server_frac: float = 0.25,
    base_rate: float = 10.0,
) -> ServeCase:
    """BA(n, m) with servers on the highest-degree nodes (Pareto(2)x100
    capacities, sorted so the best server has the highest degree), one relay
    on the lowest-degree node, and Pareto(2)x8 mobile compute."""
    rng = np.random.default_rng(seed)
    adj, _ = barabasi_albert(n, m=m, seed=seed)
    topo = build_topology(adj)
    deg = adj.sum(axis=0)
    order = np.argsort(-deg, kind="stable")
    num_servers = max(1, int(round(server_frac * n)))
    servers = order[:num_servers]
    relay = order[-1]

    roles = np.zeros((n,), dtype=np.int32)
    roles[servers] = 1
    roles[relay] = 2
    proc_bws = np.zeros((n,), dtype=np.float64)
    proc_bws[servers] = np.flip(np.sort((rng.pareto(2.0, num_servers) + 1) * 100))
    mobile = np.flatnonzero(roles == 0)
    proc_bws[mobile] = (rng.pareto(2.0, mobile.size) + 1) * 8
    return ServeCase(
        topo=topo, roles=roles, proc_bws=proc_bws, mobile_nodes=mobile,
        base_rate=base_rate, key=f"ba_n{n}_m{m}_s{seed}",
    )


def case_pool(
    sizes: Sequence[int], per_size: int = 2, seed: int = 0
) -> List[ServeCase]:
    return [
        synthetic_case(n, seed=seed + 101 * i + 7 * k)
        for i, n in enumerate(sizes)
        for k in range(per_size)
    ]


def buckets_for_pool(
    pool: Sequence[ServeCase], num_buckets: int = 2, round_to: int = 8
) -> ShapeBuckets:
    """The bucket ladder an operator derives from the expected traffic."""
    return ShapeBuckets.for_sizes(
        [c.sizes for c in pool], num_buckets=num_buckets, round_to=round_to
    )


def request_stream(
    pool: Sequence[ServeCase],
    count: int,
    seed: int = 0,
    arrival_scale: float = 0.15,
    ul: float = 100.0,
    dl: float = 1.0,
    t_max: float = 1000.0,
    id_offset: int = 0,
) -> Iterator[OffloadRequest]:
    """`count` requests drawn round-robin over the pool, each with fresh
    link-capacity noise and a fresh task stream (30-100% of mobile nodes,
    rates U(0.1, 0.5) * arrival_scale)."""
    rng = np.random.default_rng(seed)
    for i in range(count):
        case = pool[i % len(pool)]
        rates = sample_link_rates(case.topo, case.base_rate, rng=rng)
        mobile = rng.permutation(case.mobile_nodes)
        lo = max(int(0.3 * mobile.size), 1)
        nj = int(rng.integers(lo, mobile.size)) if mobile.size > lo else mobile.size
        yield OffloadRequest(
            request_id=id_offset + i,
            topo=case.topo,
            roles=case.roles,
            proc_bws=case.proc_bws,
            link_rates=rates,
            job_src=mobile[:nj].astype(np.int32),
            job_rate=arrival_scale * rng.uniform(0.1, 0.5, nj),
            ul=ul, dl=dl, t_max=t_max,
            topo_key=case.key,
        )
