"""Padded, fixed-shape tensor representation of a network instance.

Port of `multihop_offload_tpu/graphs/instance.py`.  Every field equals the
JAX builder's output exactly.  `Instance` and `JobSet` are dataclasses of
tensors; `stack_instances` gives them the leading batch axis B that every
function of the port takes.  Under the sparse layout the Instance also
carries the edge lists of its extended and conflict adjacencies
(`inst.sparse`, `layouts.sparse.SparseInstance`) and packs `link_index`
and the jobs' `src` at int16; the dense fields stay, as in the JAX package.
Float fields are stored at the `dtype` given to `build_instance` and
`build_jobset`: float32, float64, or the bf16 precision policy's
`storage_dtype`, torch.bfloat16 (computed in float32 on the host and
narrowed once).

Extended-line-graph layout: slot ``e in [0, L)`` is real link ``e``; slot
``L + i`` is node ``i``'s pseudo-link ("compute here").
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from multihop_offload_tpu_torch._device import resolve_device
from multihop_offload_tpu_torch._records import TensorRecord, stack_records
from multihop_offload_tpu_torch.graphs.topology import Topology
from multihop_offload_tpu_torch.layouts.policy import resolve_layout
from multihop_offload_tpu_torch.layouts.sparse import (
    SparseInstance,
    build_sparse_instance,
)

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype `build_instance` and `build_jobset` compute in for a
    torch or numpy float dtype: float32 / float64 as they are, and float32
    for torch.bfloat16 (numpy has no bf16: the float32 tensors are
    narrowed once, `storage_dtype`)."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return np.dtype(np.float32)
        for np_dt, t_dt in _TORCH_DTYPE.items():
            if t_dt == dtype:
                return np_dt
        raise ValueError(f"unsupported dtype {dtype}")
    dt = np.dtype(dtype)
    if dt not in _TORCH_DTYPE:
        raise ValueError(f"unsupported dtype {dt}; use float32 or float64")
    return dt


def storage_dtype(dtype) -> torch.dtype:
    """The torch dtype float fields are stored at: float32, float64 or
    bfloat16 (the precision policy's `storage_dtype`), narrowed from the
    float32 host arrays by `.to`, which rounds to nearest even as
    `ml_dtypes` does."""
    if isinstance(dtype, torch.dtype) and dtype == torch.bfloat16:
        return dtype
    return _TORCH_DTYPE[numpy_dtype(dtype)]


@dataclasses.dataclass(frozen=True)
class PadSpec:
    """Static pad sizes. E (extended slots) is always L + N.

    `enn` / `cnn` bound the sparse layout's edge-list pads (nonzeros of the
    extended / conflict adjacency); 0 means the heuristic 16 E / 16 L,
    rounded up to 128.  `graphs.cases.request_batch` sizes them from the
    data instead, as the JAX `train/data.py:_pad_for` does: the heuristic
    is too small for the committed 256-node rung.  Builders raise when a
    graph exceeds the bound."""

    n: int        # nodes
    l: int        # links
    s: int        # servers
    j: int        # jobs
    enn: int = 0  # extended-adjacency nnz pad (0 = heuristic)
    cnn: int = 0  # conflict-adjacency nnz pad (0 = heuristic)

    @property
    def e(self) -> int:
        return self.l + self.n

    @property
    def ext_nnz(self) -> int:
        return self.enn if self.enn > 0 else self.round_up(16 * self.e, 128)

    @property
    def cf_nnz(self) -> int:
        return self.cnn if self.cnn > 0 else self.round_up(16 * self.l, 128)

    @staticmethod
    def round_up(x: int, to: int) -> int:
        return int(-(-x // to) * to)

    @classmethod
    def for_cases(cls, sizes: Sequence[tuple], round_to: int = 8) -> "PadSpec":
        """sizes: iterable of (n, l, s, j) actual sizes."""
        arr = np.asarray(list(sizes), dtype=np.int64)
        n, l, s, j = (int(arr[:, k].max()) for k in range(4))
        r = lambda v: cls.round_up(max(v, 1), round_to)
        return cls(n=r(n), l=r(l), s=r(s), j=r(j))


@dataclasses.dataclass
class Instance(TensorRecord):
    """One padded network, or a batch of them (leading axis B)."""

    # nodes
    adj: torch.Tensor            # (N, N) float 0/1 connectivity
    node_mask: torch.Tensor      # (N,) bool
    roles: torch.Tensor          # (N,) int32: 0 mobile / 1 server / 2 relay
    proc_bws: torch.Tensor       # (N,) float (relay/pad = 0)
    comp_mask: torch.Tensor      # (N,) bool: node can compute
    # links (pad links have rate 1 and zero conflict rows)
    link_ends: torch.Tensor      # (L, 2) int32
    link_rates: torch.Tensor     # (L,) float
    link_mask: torch.Tensor      # (L,) bool
    link_index: torch.Tensor     # (N, N) int32 edge -> link id (0 elsewhere)
    adj_conflict: torch.Tensor   # (L, L) float conflict adjacency
    cf_degs: torch.Tensor        # (L,) float conflict degrees
    # extended line graph (E = L + N slots)
    adj_ext: torch.Tensor        # (E, E) float
    ext_rate: torch.Tensor       # (E,) float: link rate / node proc_bw
    ext_self_loop: torch.Tensor  # (E,) float 1.0 on active pseudo-links
    ext_as_server: torch.Tensor  # (E,) float 1.0 on server pseudo-links
    ext_mask: torch.Tensor       # (E,) bool
    # servers, ascending node index
    servers: torch.Tensor        # (S,) int32 (pad = 0)
    server_mask: torch.Tensor    # (S,) bool
    hop: torch.Tensor            # (N, N) float hop counts (inf unreachable)
    T: torch.Tensor              # () float congestion-penalty scale
    # edge-list twin (layouts.sparse.SparseInstance); None under dense
    sparse: Optional[SparseInstance] = None

    @property
    def num_pad_nodes(self) -> int:
        return self.adj.shape[-1]

    @property
    def num_pad_links(self) -> int:
        return self.link_rates.shape[-1]


@dataclasses.dataclass
class JobSet(TensorRecord):
    """Padded workload: one compute task stream per slot."""

    src: torch.Tensor   # (J,) int32 (int16 under sparse) source node (pad = 0)
    rate: torch.Tensor  # (J,) float arrival rate (pad = 0)
    ul: torch.Tensor    # (J,) float uplink data size
    dl: torch.Tensor    # (J,) float downlink data size
    mask: torch.Tensor  # (J,) bool


def _narrow(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype) if t.is_floating_point() else t


def _tensors(cls, arrays: dict, device, dtype: torch.dtype):
    """`cls` of the host arrays on `device`, float fields at `dtype`."""
    dev = resolve_device(device)
    return cls(**{k: _narrow(torch.from_numpy(np.array(v)), dtype).to(dev)
                  for k, v in arrays.items()})


def build_instance(
    topo: Topology,
    roles: np.ndarray,
    proc_bws: np.ndarray,
    link_rates: np.ndarray,
    t_max: float,
    pad: PadSpec,
    dtype=torch.float32,
    hop: Optional[np.ndarray] = None,
    device=None,
    layout=None,
) -> Instance:
    """Freeze a topology + resource assignment into a padded Instance on
    `device` (default CUDA).  Under `layout="sparse"` it also carries
    `inst.sparse`, padded to `pad.ext_nnz` / `pad.cf_nnz`, and packs
    `link_index` at int16."""
    lay = resolve_layout(layout)
    store = storage_dtype(dtype)
    dtype = numpy_dtype(dtype)
    n, l = topo.n, topo.num_links
    N, L, S = pad.n, pad.l, pad.s
    if n > N or l > L:
        raise ValueError(f"case ({n} nodes, {l} links) exceeds pad ({N}, {L})")

    roles = np.asarray(roles, dtype=np.int32)
    proc_bws = np.asarray(proc_bws, dtype=dtype)
    link_rates = np.asarray(link_rates, dtype=dtype)

    adj = np.zeros((N, N), dtype=dtype)
    adj[:n, :n] = topo.adj
    node_mask = np.zeros((N,), dtype=bool)
    node_mask[:n] = True
    roles_p = np.full((N,), 2, dtype=np.int32)
    roles_p[:n] = roles
    bws_p = np.zeros((N,), dtype=dtype)
    bws_p[:n] = proc_bws
    comp_mask = (roles_p < 2) & node_mask

    ends_p = np.zeros((L, 2), dtype=np.int32)
    ends_p[:l] = topo.link_ends
    rates_p = np.ones((L,), dtype=dtype)  # pad rate 1 avoids 0/0 in the FP
    rates_p[:l] = link_rates
    link_mask = np.zeros((L,), dtype=bool)
    link_mask[:l] = True
    if L - 1 > np.iinfo(lay.index_dtype).max:
        raise ValueError(f"link pad {L} overflows {np.dtype(lay.index_dtype).name}")
    link_index = np.zeros((N, N), dtype=lay.index_dtype)
    link_index[:n, :n] = np.maximum(topo.link_index, 0)
    adj_cf = np.zeros((L, L), dtype=dtype)
    adj_cf[:l, :l] = topo.adj_conflict
    cf_degs = np.zeros((L,), dtype=dtype)
    cf_degs[:l] = topo.cf_degs

    E = pad.e
    ext_mask = np.concatenate([link_mask, comp_mask])
    ext_rate = np.concatenate([rates_p, bws_p]).astype(dtype)
    ext_self_loop = np.concatenate(
        [np.zeros((L,)), comp_mask.astype(np.float64)]
    ).astype(dtype)
    ext_as_server = np.zeros((E,), dtype=dtype)
    ext_as_server[L:][roles_p == 1] = 1.0
    adj_ext = np.zeros((E, E), dtype=dtype)
    adj_ext[:L, :L][:l, :l] = topo.adj_lg  # pure line graph (not conflict-aug.)
    inc = np.zeros((L, N), dtype=dtype)    # link-node incidence, masked
    inc[np.arange(l), topo.link_ends[:, 0]] = 1.0
    inc[np.arange(l), topo.link_ends[:, 1]] = 1.0
    inc *= comp_mask[None, :].astype(dtype)
    adj_ext[:L, L:] = inc
    adj_ext[L:, :L] = inc.T

    if hop is None:
        hop = compute_hop_matrix(topo, N)
    hop = np.asarray(hop, dtype=dtype)

    server_ids = np.flatnonzero(roles_p == 1)
    if server_ids.size > S:
        raise ValueError(f"{server_ids.size} servers exceed pad {S}")
    servers = np.zeros((S,), dtype=np.int32)
    servers[: server_ids.size] = np.sort(server_ids)
    server_mask = np.zeros((S,), dtype=bool)
    server_mask[: server_ids.size] = True

    inst = _tensors(Instance, dict(
        adj=adj, node_mask=node_mask, roles=roles_p, proc_bws=bws_p,
        comp_mask=comp_mask, link_ends=ends_p, link_rates=rates_p,
        link_mask=link_mask, link_index=link_index, adj_conflict=adj_cf,
        cf_degs=cf_degs, adj_ext=adj_ext, ext_rate=ext_rate,
        ext_self_loop=ext_self_loop, ext_as_server=ext_as_server,
        ext_mask=ext_mask, servers=servers, server_mask=server_mask,
        hop=hop, T=np.asarray(t_max, dtype=dtype),
    ), device, store)
    if lay.sparse:
        sparse = build_sparse_instance(adj_ext, adj_cf, pad.ext_nnz,
                                       pad.cf_nnz, dtype=dtype)
        if store != sparse.ext.vals.dtype:
            sparse = dataclasses.replace(
                sparse, ext=dataclasses.replace(sparse.ext, vals=sparse.ext.vals.to(store)),
                cf=dataclasses.replace(sparse.cf, vals=sparse.cf.vals.to(store)))
        inst = dataclasses.replace(inst, sparse=sparse.to(inst.adj.device))
    return inst


def compute_hop_matrix(topo: Topology, pad_n: int) -> np.ndarray:
    """Unweighted hop counts on host (scipy BFS), padded to (pad_n, pad_n):
    pad nodes are unreachable (inf) with a zero diagonal."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    hop = np.full((pad_n, pad_n), np.inf)
    np.fill_diagonal(hop, 0.0)
    hop[: topo.n, : topo.n] = shortest_path(
        csr_matrix(topo.adj > 0), unweighted=True
    )
    return hop


def build_jobset(
    src: np.ndarray,
    rate: np.ndarray,
    pad_jobs: int,
    ul: float = 100.0,
    dl: float = 1.0,
    dtype=torch.float32,
    device=None,
    index_dtype=np.int32,
) -> JobSet:
    """Pad a concrete workload onto `device` (default CUDA).  `index_dtype`
    is the storage dtype of `src` (`LayoutPolicy.index_dtype`: int16 under
    the sparse layout), checked against the node ids."""
    store = storage_dtype(dtype)
    dtype = numpy_dtype(dtype)
    src = np.asarray(src, dtype=np.int64)
    rate = np.asarray(rate, dtype=dtype)
    j = src.shape[0]
    J = pad_jobs
    if j > J:
        raise ValueError(f"{j} jobs exceed pad {J}")
    if j and int(src.max()) > np.iinfo(index_dtype).max:
        raise ValueError(f"job source ids overflow {np.dtype(index_dtype).name}")
    src_p = np.zeros((J,), dtype=index_dtype)
    src_p[:j] = src
    rate_p = np.zeros((J,), dtype=dtype)
    rate_p[:j] = rate
    mask = np.zeros((J,), dtype=bool)
    mask[:j] = True
    return _tensors(JobSet, dict(
        src=src_p, rate=rate_p,
        ul=np.full((J,), ul, dtype=dtype), dl=np.full((J,), dl, dtype=dtype),
        mask=mask,
    ), device, store)


def stack_instances(items: Sequence):
    """Stack same-shape Instances (or JobSets) along a new leading batch
    axis, on the device of the first item."""
    return stack_records(items)
