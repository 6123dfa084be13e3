"""Shape-bucket batching: pack irregular requests into static slot layouts.

Port of `multihop_offload_tpu/serve/bucketing.py`.  Each bucket is a
`PadSpec`, and every request is padded up to the SMALLEST bucket that fits
it, so a batch of one bucket has one shape whatever its requests.
`pack_bucket` builds each request with the port's `build_instance` /
`build_jobset` on the CPU, stacks them, and moves the stacked batch to the
service's device in one transfer per tensor.  A partially filled batch
repeats its last real request, as the JAX packer does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multihop_offload_tpu_torch.graphs.instance import (
    PadSpec,
    build_instance,
    build_jobset,
    compute_hop_matrix,
    stack_instances,
)
from multihop_offload_tpu_torch.layouts.policy import resolve_layout
from multihop_offload_tpu_torch.serve.request import OffloadRequest


class ShapeBuckets:
    """Ascending ladder of pad shapes; assignment takes the smallest fit."""

    def __init__(self, pads: Sequence[PadSpec]):
        if not pads:
            raise ValueError("at least one bucket PadSpec is required")
        # ascending by padded volume proxy so "first fit" == "smallest fit"
        self.pads: List[PadSpec] = sorted(pads, key=lambda p: (p.n, p.l, p.j, p.s))

    @classmethod
    def for_sizes(
        cls, sizes: Sequence[tuple], num_buckets: int = 2, round_to: int = 8
    ) -> "ShapeBuckets":
        """Quantile-bucket expected case sizes (n, l, s, j) by node count."""
        sizes = list(sizes)
        n_buckets = max(1, min(num_buckets, len(sizes)))
        order = np.argsort([s[0] for s in sizes], kind="stable")
        groups = [g for g in np.array_split(order, n_buckets) if g.size]
        return cls([
            PadSpec.for_cases([sizes[i] for i in g], round_to=round_to)
            for g in groups
        ])

    def __len__(self) -> int:
        return len(self.pads)

    def __getitem__(self, b: int) -> PadSpec:
        return self.pads[b]

    def bucket_for(self, n: int, l: int, s: int, j: int) -> Optional[int]:
        """Smallest bucket that fits (n, l, s, j); None when none does."""
        for b, p in enumerate(self.pads):
            if n <= p.n and l <= p.l and s <= p.s and j <= p.j:
                return b
        return None


class OccupancyLadder:
    """EWMA-occupancy width policy: cold buckets tick at narrower widths.

    A per-bucket EWMA of live counts picks a width from a power-of-two rung
    ladder ending at `slots`: widen immediately to the smallest rung that
    fits this tick's pending work (real requests are never clipped below
    what full slots would take); narrow one rung at a time, and only when
    the EWMA inflated by `hysteresis` clears the narrower rung.  The JAX
    package compiles one program per width; here a width is the batch size
    packed, and the same rung sequence results."""

    def __init__(self, n_buckets: int, slots: int, alpha: float = 0.5,
                 hysteresis: float = 0.25):
        if slots < 1 or n_buckets < 1:
            raise ValueError("n_buckets and slots must be >= 1")
        if not (0.0 < alpha <= 1.0):
            raise ValueError("alpha must be in (0, 1]")
        if hysteresis < 0.0:
            raise ValueError("hysteresis must be >= 0")
        self.slots = int(slots)
        rungs = []
        w = 1
        while w < self.slots:
            rungs.append(w)
            w *= 2
        rungs.append(self.slots)
        #: ascending power-of-two widths, always ending at full `slots`
        self.rungs: List[int] = rungs
        self.alpha = float(alpha)
        self.hysteresis = float(hysteresis)
        # start at full width: a fresh service has no occupancy evidence
        self._ewma = [float(self.slots)] * n_buckets
        self._width = [self.slots] * n_buckets
        #: rung transitions as (bucket, old, new)
        self.transitions: List[Tuple[int, int, int]] = []

    def rung_for(self, need: int) -> int:
        """Smallest rung >= need (clamped to full width)."""
        for w in self.rungs:
            if w >= need:
                return w
        return self.slots

    def observe(self, bucket: int, live: int) -> None:
        """Fold one tick's live count into the bucket's EWMA."""
        self._ewma[bucket] += self.alpha * (float(live) - self._ewma[bucket])

    def select(self, bucket: int, pending: int) -> int:
        """Width for this tick given `pending` queued requests: a rung
        >= min(pending, slots)."""
        need = min(max(int(pending), 1), self.slots)
        cur = self._width[bucket]
        target = self.rung_for(need)
        if target > cur:
            # a burst outruns the EWMA: widen in one step, no hysteresis
            self._width[bucket] = target
            self.transitions.append((bucket, cur, target))
            return target
        idx = self.rungs.index(cur)
        if idx > 0:
            down = self.rungs[idx - 1]
            if need <= down and self._ewma[bucket] * (1.0 + self.hysteresis) <= down:
                self._width[bucket] = down
                self.transitions.append((bucket, cur, down))
                return down
        return cur


def pack_bucket(
    reqs: Sequence[OffloadRequest],
    pad: PadSpec,
    slots: int,
    dtype=torch.float32,  # fp32-island(storage default; the service passes its policy's storage dtype)
    hop_cache: Optional[Dict] = None,
    layout=None,
    device="cpu",
) -> Tuple:
    """Pad + stack up to `slots` requests into one batched (Instance, JobSet)
    on `device`, leading axis exactly `slots` (filler slots repeat the last
    real request and are never demuxed).  Under the sparse layout the jobs'
    sources are stored at the layout's `index_dtype` and each Instance
    carries its edge lists with their CSR index (`inst.sparse.ext_csr`)."""
    if not reqs or len(reqs) > slots:
        raise ValueError(f"need 1..{slots} requests, got {len(reqs)}")
    lay = resolve_layout(layout)
    index_dtype = np.int32 if not lay.sparse else lay.index_dtype
    insts, jobsets = [], []
    for r in reqs:
        hop = None
        if hop_cache is not None and r.topo_key is not None:
            hop = hop_cache.get((r.topo_key, pad.n))
        if hop is None:
            hop = compute_hop_matrix(r.topo, pad.n)
            if hop_cache is not None and r.topo_key is not None:
                hop_cache[(r.topo_key, pad.n)] = hop
        insts.append(build_instance(
            r.topo, r.roles, r.proc_bws, r.link_rates, r.t_max, pad,
            dtype=dtype, hop=hop, device="cpu", layout=lay,
        ))
        jobsets.append(build_jobset(
            r.job_src, r.job_rate, pad_jobs=pad.j, ul=r.ul, dl=r.dl,
            dtype=dtype, device="cpu", index_dtype=index_dtype,
        ))
    while len(insts) < slots:
        insts.append(insts[-1])
        jobsets.append(jobsets[-1])
    return (stack_instances(insts).to(device), stack_instances(jobsets).to(device))


def padding_waste(reqs: Sequence[OffloadRequest], pad: PadSpec, slots: int) -> dict:
    """Fraction of padded capacity carrying no real work this batch, per
    resource axis."""
    real_jobs = sum(r.num_jobs for r in reqs)
    real_nodes = sum(r.topo.n for r in reqs)
    return {
        "slot": 1.0 - len(reqs) / slots,
        "jobs": 1.0 - real_jobs / (slots * pad.j),
        "nodes": 1.0 - real_nodes / (slots * pad.n),
    }
