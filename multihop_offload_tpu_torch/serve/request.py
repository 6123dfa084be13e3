"""Service request/response records.

Port of `multihop_offload_tpu/serve/request.py`, over the port's
`Topology`.  A request is one network snapshot plus the task stream to
place on it, at true size; padding is the batcher's job
(`serve.bucketing`).
"""

from __future__ import annotations

import dataclasses
from typing import Hashable, Optional

import numpy as np

from multihop_offload_tpu_torch.graphs.topology import Topology


@dataclasses.dataclass(frozen=True)
class OffloadRequest:
    """One offloading-decision query: a network + its jobs, true sizes."""

    request_id: int
    topo: Topology
    roles: np.ndarray        # (n,) int 0 mobile / 1 server / 2 relay
    proc_bws: np.ndarray     # (n,) float processing bandwidths
    link_rates: np.ndarray   # (L,) float realized link capacities
    job_src: np.ndarray      # (j,) int32 task source nodes
    job_rate: np.ndarray     # (j,) float task arrival rates
    ul: float = 100.0        # uplink data size (Job defaults)
    dl: float = 1.0
    t_max: float = 1000.0
    # hop-matrix cache key: requests that reuse a topology share the host BFS
    topo_key: Optional[Hashable] = None

    @property
    def num_jobs(self) -> int:
        return int(np.asarray(self.job_src).shape[0])

    @property
    def sizes(self) -> tuple:
        """(n, l, s, j) true sizes — the bucket-assignment key."""
        return (
            self.topo.n,
            self.topo.num_links,
            int((np.asarray(self.roles) == 1).sum()),
            self.num_jobs,
        )


@dataclasses.dataclass
class OffloadResponse:
    """Per-request decision, demuxed from the batched program and sliced to
    the request's true job count.  Node ids refer to the request's own
    numbering (padding never renumbers real nodes)."""

    request_id: int
    dst: np.ndarray          # (j,) int32 chosen compute node per job
    is_local: np.ndarray     # (j,) bool computed at the source
    delay_est: np.ndarray    # (j,) policy-predicted delay of the choice
    job_total: np.ndarray    # (j,) empirical-model delay of the realized plan
    served_by: str           # "gnn" | "baseline" (degraded path)
    bucket: int              # bucket index that served the request
    latency_s: float         # admission -> response wall seconds
