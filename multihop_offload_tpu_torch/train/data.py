"""Dataset cache and workload sampling.

Port of `multihop_offload_tpu/train/data.py`.  Each `.mat` case is parsed
once; per visit only the noisy link capacities are re-drawn (`links_init`
semantics) and the instance rebuilt, with the topology-only hop matrix
cached.  Workloads mirror `AdHoc_train.py:112-121`, seeded.  The numpy
draws are the JAX package's, in the same order, so the same generator
gives the same instances and job sets in both packages.

Instances and job sets are built on the CPU: the drivers move them to the
card in the step, so that building the next file never waits on the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.graphs.instance import (
    Instance,
    PadSpec,
    build_instance,
    build_jobset,
    compute_hop_matrix,
    stack_instances,
)
from multihop_offload_tpu_torch.graphs.matio import CaseRecord, list_dataset, load_case_mat
from multihop_offload_tpu_torch.graphs.topology import sample_link_rates
from multihop_offload_tpu_torch.layouts.policy import resolve_layout
from multihop_offload_tpu_torch.layouts.sparse import cf_nnz_count, ext_nnz_count


def _pad_for(records: List[CaseRecord], cfg: Config) -> PadSpec:
    """The pads of a bucket: counts rounded up to `cfg.round_to` (or the
    configured pads), and under the sparse layout the exact nnz bounds of
    the data rounded up to 128."""
    base = PadSpec.for_cases([r.sizes for r in records], round_to=cfg.round_to)
    enn = cnn = 0
    if resolve_layout(cfg.layout).sparse:
        enn = PadSpec.round_up(max(ext_nnz_count(r.topo, np.asarray(r.roles) < 2)
                                   for r in records), 128)
        cnn = PadSpec.round_up(max(cf_nnz_count(r.topo) for r in records), 128)
    return PadSpec(n=cfg.pad_nodes or base.n, l=cfg.pad_links or base.l,
                   s=cfg.pad_servers or base.s, j=cfg.pad_jobs or base.j,
                   enn=enn, cnn=cnn)


@dataclasses.dataclass
class DatasetCache:
    """Parsed dataset with size-bucketed pad shapes: `cfg.pad_buckets`
    quantile buckets by node count, each with its own PadSpec."""

    cfg: Config
    records: List[CaseRecord]
    pad: PadSpec              # elementwise max over buckets
    pads: List[PadSpec]       # per bucket, ascending node pad
    bucket_of: List[int]      # record index -> bucket index
    _hop_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    # float fields' dtype (the precision policy's storage dtype); None:
    # cfg.dtype
    storage_dtype: Optional[torch.dtype] = None

    @classmethod
    def load(cls, cfg: Config, datapath: Optional[str] = None,
             storage_dtype: Optional[torch.dtype] = None) -> "DatasetCache":
        datapath = datapath or cfg.datapath
        names = list_dataset(datapath)
        if not names:
            raise FileNotFoundError(f"no .mat cases under {datapath}")
        records = [load_case_mat(os.path.join(datapath, n)) for n in names]
        n_buckets = max(1, min(cfg.pad_buckets, len(records)))
        order = np.argsort([r.topo.n for r in records], kind="stable")
        groups = [g for g in np.array_split(order, n_buckets) if g.size]
        pads, bucket_of = [], [0] * len(records)
        for b, g in enumerate(groups):
            pads.append(_pad_for([records[i] for i in g], cfg))
            for i in g:
                bucket_of[int(i)] = b
        global_pad = PadSpec(
            n=max(p.n for p in pads), l=max(p.l for p in pads),
            s=max(p.s for p in pads), j=max(p.j for p in pads),
            enn=max(p.enn for p in pads), cnn=max(p.cnn for p in pads),
        )
        return cls(cfg=cfg, records=records, pad=global_pad, pads=pads,
                   bucket_of=bucket_of, storage_dtype=storage_dtype)

    def __len__(self) -> int:
        return len(self.records)

    def pad_of(self, idx: int) -> PadSpec:
        return self.pads[self.bucket_of[idx]]

    def instance(self, idx: int, rng: np.random.Generator) -> Instance:
        """Case `idx` with freshly drawn link capacities, on the CPU, at
        `storage_dtype` (default `cfg.dtype`) and `cfg.layout`; the hop
        matrix is cached."""
        rec = self.records[idx]
        pad = self.pad_of(idx)
        hop = self._hop_cache.get(idx)
        if hop is None:
            hop = self._hop_cache[idx] = compute_hop_matrix(rec.topo, pad.n)
        rates = sample_link_rates(rec.topo, rec.link_rates, rng=rng)
        return build_instance(rec.topo, rec.roles, rec.proc_bws, rates,
                              float(self.cfg.T), pad,
                              dtype=self.storage_dtype or self.cfg.torch_dtype,
                              hop=hop, device="cpu", layout=self.cfg.layout)


def sample_jobsets(rec: CaseRecord, pad: PadSpec, num_instances: int,
                   rng: np.random.Generator, arrival_scale: float,
                   ul: float = 100.0, dl: float = 1.0, dtype=np.float32,
                   index_dtype=np.int32) -> tuple:
    """`num_instances` independent workloads on one network, stacked on the
    CPU, and their job counts.  Per instance (`AdHoc_train.py:113-121`):
    jobs on a random 30-100% subset of the mobile nodes, arrival rates
    U(0.1, 0.5) * arrival_scale."""
    sets, counts = [], []
    for _ in range(num_instances):
        mobile = rng.permutation(rec.mobile_nodes)
        lo = int(0.3 * mobile.size)
        nj = int(rng.integers(lo, mobile.size)) if mobile.size > lo else mobile.size
        rates = arrival_scale * rng.uniform(0.1, 0.5, nj)
        sets.append(build_jobset(mobile[:nj], rates, pad_jobs=pad.j, ul=ul, dl=dl,
                                 dtype=dtype, device="cpu", index_dtype=index_dtype))
        counts.append(nj)
    return stack_instances(sets), np.asarray(counts)
