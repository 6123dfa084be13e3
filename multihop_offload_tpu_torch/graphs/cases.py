"""The committed workload: BA network cases and request batches built on them.

`data/cases.npz` holds the cases that `cli/datagen.generate_dataset` of the
JAX package writes (`scripts/export_torch_port_data.py` made the file), so no
step of the port needs a download; the port's own `cli/datagen` and
`large_scale.build_case` draw every group again bit for bit, without
networkx:

* group ``paper``: ``size=2, seed0=500`` over n = 20, 30, ..., 110 (20 cases);
* group ``rung256``: ``graph_sizes=[250], size=4, seed0=500`` (4 cases).

Per case it stores the adjacency (uint8), the mean link rates in canonical
link order, `nodes_info` (role, proc_bw) and the generator seed, in the
sorted file-name order the drivers use.

Group ``large`` (`load_large_case`) is the one 1,024-node Erdős–Rényi
network of `scripts/large_scale_demo.py --n 1024 --gtype er --seed 42`
with its one job set: the link list, the realized link rates, roles,
proc_bws, job sources and rates; `large_request` builds it with the
demo's pads.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from multihop_offload_tpu_torch._device import resolve_device
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.graphs.instance import (
    PadSpec,
    build_instance,
    build_jobset,
    stack_instances,
)
from multihop_offload_tpu_torch.graphs.topology import (
    Topology,
    build_topology,
    sample_link_rates,
)
from multihop_offload_tpu_torch.layouts.policy import resolve_layout
from multihop_offload_tpu_torch.layouts.sparse import cf_nnz_count, ext_nnz_count

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
CASES_PATH = os.path.join(DATA_DIR, "cases.npz")


@dataclasses.dataclass
class CaseRecord:
    """One dataset case: topology + roles/resources, before padding."""

    topo: Topology
    roles: np.ndarray       # (n,) int32
    proc_bws: np.ndarray    # (n,) float64
    link_rates: np.ndarray  # (L,) float64 mean rates, canonical link order
    seed: int
    name: str

    @property
    def mobile_nodes(self) -> np.ndarray:
        return np.flatnonzero(self.roles == 0)

    @property
    def sizes(self):
        """(n, l, s, j_max) for PadSpec; j_max = mobile count."""
        return (self.topo.n, self.topo.num_links,
                int((self.roles == 1).sum()), self.mobile_nodes.size)


def load_cases(group: str = "paper", path: str = CASES_PATH) -> list:
    """The committed cases of `group` ('paper' or 'rung256'), in order."""
    with np.load(path) as z:
        names = [str(x) for x in z[f"{group}/names"]]
        recs = []
        for i, name in enumerate(names):
            info = z[f"{group}/{i}/nodes_info"]
            recs.append(CaseRecord(
                topo=build_topology(z[f"{group}/{i}/adj"]),
                roles=info[:, 0].astype(np.int32),
                proc_bws=info[:, 1].astype(np.float64),
                link_rates=z[f"{group}/{i}/link_rates"].astype(np.float64),
                seed=int(z[f"{group}/{i}/seed"]),
                name=name,
            ))
    return recs


@dataclasses.dataclass
class LargeCase:
    """One network with one job set drawn on it, as the large-scale demo
    draws them (`scripts/large_scale_demo.py:97-109`); `rec.link_rates`
    holds the realized rates, not their means."""

    rec: CaseRecord
    job_src: np.ndarray   # (J,) int64 source nodes
    job_rate: np.ndarray  # (J,) float64 arrival rates
    T: float              # congestion-penalty scale
    gtype: str = "er"     # the generator family


def load_large_case(path: str = CASES_PATH) -> LargeCase:
    """The committed group ``large``, its topology rebuilt from the link
    list (cf_radius 0: the conflict graph is the line graph)."""
    with np.load(path) as z:
        n = int(z["large/n"])
        ends = z["large/link_ends"]
        adj = np.zeros((n, n), dtype=np.uint8)
        adj[ends[:, 0], ends[:, 1]] = adj[ends[:, 1], ends[:, 0]] = 1
        seed = int(z["large/seed"])
        rec = CaseRecord(topo=build_topology(adj), roles=z["large/roles"].astype(np.int32),
                         proc_bws=z["large/proc_bws"].astype(np.float64),
                         link_rates=z["large/link_rates"].astype(np.float64), seed=seed,
                         name=f"large_{z['large/gtype']}_n{n}_seed{seed}")
        return LargeCase(rec=rec, job_src=z["large/job_src"].astype(np.int64),
                         job_rate=z["large/job_rate"].astype(np.float64),
                         T=float(z["large/T"]), gtype=str(z["large/gtype"]))


def large_request(case: LargeCase | None = None, dtype=torch.float32, device=None,
                  layout=None):
    """The large case as a batch of one request, with the demo's pads
    (every count rounded up to 8, `:100-104`), under `layout` (default
    dense; sparse: nnz pads as `pad_for`), on `device` (default CUDA).
    Returns ``(inst, jobs, pad)``."""
    case = case or load_large_case()
    rec = case.rec
    pad = pad_for([rec], layout)
    inst = build_instance(rec.topo, rec.roles, rec.proc_bws, rec.link_rates, case.T,
                          pad, dtype, device="cpu", layout=layout)
    jobs = build_jobset(case.job_src, case.job_rate, pad_jobs=pad.j, dtype=dtype,
                        device="cpu")
    dev = resolve_device(device)
    return stack_instances([inst]).to(dev), stack_instances([jobs]).to(dev), pad


def pad_for(cases, layout=None) -> PadSpec:
    """The pads of a batch of cases, rounded up to 8; under the sparse
    layout the nnz pads are the data's largest counts rounded up to 128, as
    the JAX `train/data.py:_pad_for` sizes them."""
    pad = PadSpec.for_cases([r.sizes for r in cases], round_to=8)
    if not resolve_layout(layout).sparse:
        return pad
    enn = max(ext_nnz_count(r.topo, r.roles < 2) for r in cases)
    cnn = max(cf_nnz_count(r.topo) for r in cases)
    return dataclasses.replace(pad, enn=PadSpec.round_up(enn, 128),
                               cnn=PadSpec.round_up(cnn, 128))


def request_batch(
    cases,
    per_network: int = 4,
    seed: int = 0,
    cfg: Config | None = None,
    dtype=torch.float32,
    device=None,
    layout=None,
):
    """A batch of offloading requests: `per_network` job sets on each case.

    Mirrors the JAX bench workload (`bench.py:159-173`): one realization of
    the link rates per network, then per request a random 30-100% subset of
    the mobile nodes as sources with rates ``cfg.arrival_scale *
    U(0.1, 0.5)`` and data sizes ``cfg.ul_data`` / ``cfg.dl_data``, all drawn
    from ``np.random.default_rng(seed)``; congestion scale ``cfg.T``.
    Returns ``(inst, jobs, pad)`` with inst/jobs stacked to batch
    ``len(cases) * per_network`` on `device` (default CUDA), built for
    `layout` (default dense; `pad_for` sizes the sparse nnz pads)."""
    cfg = cfg or Config()
    lay = resolve_layout(layout)
    rng = np.random.default_rng(seed)
    pad = pad_for(cases, lay)
    insts, jobsets = [], []
    for rec in cases:
        rates = sample_link_rates(rec.topo, rec.link_rates, rng=rng)
        inst = build_instance(rec.topo, rec.roles, rec.proc_bws, rates,
                              float(cfg.T), pad, dtype, device="cpu", layout=lay)
        for _ in range(per_network):
            mobile = rng.permutation(rec.mobile_nodes)
            nj = int(rng.integers(max(int(0.3 * mobile.size), 1), mobile.size))
            jobsets.append(build_jobset(
                mobile[:nj], cfg.arrival_scale * rng.uniform(0.1, 0.5, nj),
                pad_jobs=pad.j, ul=cfg.ul_data, dl=cfg.dl_data, dtype=dtype,
                device="cpu", index_dtype=lay.index_dtype,
            ))
            insts.append(inst)
    dev = resolve_device(device)
    return (stack_instances(insts).to(dev), stack_instances(jobsets).to(dev),
            pad)
