"""Padded edge-list instance representation and its segment reductions.

Port of `multihop_offload_tpu/layouts/sparse.py`, batched over the leading
axis B.  The sparse layout stores each instance's extended and conflict
adjacencies as COO lists padded to a static nnz (`PadSpec.ext_nnz` /
`cf_nnz`); padding entries are (row=0, col=0, val=0).

- `sparse_chebyshev_support` + `propagate_edges`: the ChebConv recurrence
  as gather + segment-sum.  `propagate_edges` is the plain version of K4
  (`ops/chebconv.py`), which the card runs instead; it is the math of the
  JAX `make_sparse_propagate`.  K4 reads the extended list through its
  `CsrIndex`, made on the host with the list (`csr_index`).
- `weight_matrix_from_edges` / `next_hop_from_edges`: the APSP input
  scatter-built from the link list (exact min) and the greedy next-hop
  table from two segment-mins (lowest index on ties, empty rows -> 0).
  Both equal the dense layout's `env/apsp.py` functions bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multihop_offload_tpu_torch._records import TensorRecord
from multihop_offload_tpu_torch.ops.sparse import COO
from multihop_offload_tpu_torch.precision import island_dtype


@dataclasses.dataclass
class CsrIndex(TensorRecord):
    """Row and column access to the real entries of a COO list that holds
    them first, sorted by row (`np.nonzero` order), with the pads after
    them: row r's entries are [row_ptr[r], row_ptr[r + 1]) of the list,
    column c's are col_order[col_ptr[c] : col_ptr[c + 1]], in list order.
    No range reaches a pad."""

    row_ptr: torch.Tensor    # (..., E + 1) int32
    col_ptr: torch.Tensor    # (..., E + 1) int32
    col_order: torch.Tensor  # (..., nnz_pad) int32 (pads: 0, never read)


@dataclasses.dataclass
class SparseInstance(TensorRecord):
    """Edge-list twin of an Instance's dense structural matrices
    (`inst.sparse`; None under the dense layout)."""

    ext: COO           # (E, E) extended-line-graph adjacency (ChebConv support input)
    cf: COO            # (L, L) conflict adjacency
    ext_csr: CsrIndex  # row and column access to `ext`'s real entries (K4)


@dataclasses.dataclass
class SparseSupport(TensorRecord):
    """Chebyshev support in edge-list form: off-diagonal COO + diagonal,
    and the list's `CsrIndex` where K4 is to read it."""

    edges: COO
    diag: torch.Tensor  # (..., E)
    csr: CsrIndex | None = None


# ---- host-side builders ----------------------------------------------------


def _coo_from_dense_np(mat: np.ndarray, nnz_pad: int, val_dtype) -> COO:
    """COO of `mat` padded to `nnz_pad` entries (CPU tensors).  Real entries
    come in `np.nonzero` order (sorted by row), the pads trail them.
    Raises when `mat` has more nonzeros than the pad."""
    mat = np.asarray(mat)
    rows, cols = np.nonzero(mat)
    nnz = int(rows.size)
    if nnz > nnz_pad:
        raise ValueError(
            f"matrix has {nnz} nonzeros > nnz pad {nnz_pad}; raise the "
            "PadSpec nnz bound (enn/cnn) for this bucket"
        )
    r = np.zeros((nnz_pad,), np.int32)
    c = np.zeros((nnz_pad,), np.int32)
    v = np.zeros((nnz_pad,), val_dtype)
    r[:nnz] = rows
    c[:nnz] = cols
    v[:nnz] = mat[rows, cols]
    return COO(rows=torch.from_numpy(r), cols=torch.from_numpy(c),
               vals=torch.from_numpy(v), shape=tuple(mat.shape))


def csr_index(coo: COO) -> CsrIndex:
    """The `CsrIndex` of one (unbatched) CPU list whose real entries, the
    nonzero-valued ones, come first, sorted by row.  Raises otherwise."""
    rows, cols, vals = (np.asarray(t) for t in (coo.rows, coo.cols, coo.vals))
    nnz = int(np.count_nonzero(vals))
    if np.count_nonzero(vals[:nnz]) != nnz or np.any(np.diff(rows[:nnz]) < 0):
        raise ValueError("csr_index needs the real entries first, sorted by row")
    n = coo.shape[0]

    def ptr(index):
        out = np.zeros((n + 1,), np.int32)
        out[1:] = np.cumsum(np.bincount(index, minlength=n))
        return out

    order = np.zeros(rows.shape, np.int32)
    order[:nnz] = np.argsort(cols[:nnz], kind="stable")
    return CsrIndex(row_ptr=torch.from_numpy(ptr(rows[:nnz])),
                    col_ptr=torch.from_numpy(ptr(cols[:nnz])),
                    col_order=torch.from_numpy(order))


def build_sparse_instance(adj_ext, adj_conflict, ext_nnz: int, cf_nnz: int,
                          dtype=np.float32) -> SparseInstance:
    """The edge lists of the padded dense matrices, on the CPU."""
    ext = _coo_from_dense_np(adj_ext, ext_nnz, dtype)
    return SparseInstance(ext=ext, cf=_coo_from_dense_np(adj_conflict, cf_nnz, dtype),
                          ext_csr=csr_index(ext))


def ext_nnz_count(topo, comp_mask: np.ndarray) -> int:
    """Nonzeros of the extended adjacency a topology builds: line-graph
    entries plus both incidence blocks (one entry each way per link end
    that can compute)."""
    lg = int(np.count_nonzero(np.asarray(topo.adj_lg)))
    comp = np.asarray(comp_mask, bool)
    inc = int(np.count_nonzero(comp[np.asarray(topo.link_ends)]))
    return lg + 2 * inc


def cf_nnz_count(topo) -> int:
    return int(np.count_nonzero(np.asarray(topo.adj_conflict)))


# ---- batched segment reductions ---------------------------------------------


def segment_sum(data: torch.Tensor, index: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[b, s, ...] = sum of data[b, k, ...] over k with index[b, k] == s,
    for (B, K, ...) data and (B, K) index.  On the CPU the entries add in
    index order (`index_add` is sequential there)."""
    b, k = index.shape
    offsets = torch.arange(b, device=index.device, dtype=torch.long).unsqueeze(1) * num_segments
    flat = (index.long() + offsets).reshape(-1)
    rest = tuple(data.shape[2:])
    out = torch.zeros((b * num_segments,) + rest, dtype=data.dtype, device=data.device)
    out = out.index_add(0, flat, data.reshape((b * k,) + rest))
    return out.view((b, num_segments) + rest)


def gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x[b, index[b, k]] for (B, N, ...) x and (B, K) index -> (B, K, ...)."""
    idx = index.long().view(index.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(index.shape + tuple(x.shape[2:])))


# ---- ChebConv: gather + segment-sum ----------------------------------------


def sparse_chebyshev_support(edges: COO, mask=None, lmax: float = 2.0,
                             dtype=None, csr: CsrIndex | None = None) -> SparseSupport:
    """Edge-list twin of `models.chebconv.chebyshev_support`: off-diagonal
    entries ``-(2/lmax) a[u,v] / sqrt(deg_u deg_v)``, diagonal
    ``(2/lmax - 1)`` on valid slots, computed at >= float32.  The entries
    keep their order, so the list's `csr` index carries over."""
    if lmax is None:
        raise ValueError("the sparse layout needs a static lmax; use lmax=2.0")
    wide = island_dtype(edges.vals.dtype)  # the laplacian island
    vals = edges.vals.to(wide)
    n = edges.shape[0]
    deg = segment_sum(vals, edges.rows, n)
    valid = deg > 0
    if mask is not None:
        valid = valid & mask
    inv_sqrt = torch.where(deg > 0, 1.0 / torch.sqrt(torch.where(deg > 0, deg, 1.0)), 0.0)
    scale = 2.0 / lmax
    evals = -scale * vals * gather_rows(inv_sqrt, edges.rows) \
        * gather_rows(inv_sqrt, edges.cols)
    diag = (scale - 1.0) * valid.to(wide)
    out = dtype or edges.vals.dtype
    return SparseSupport(
        edges=COO(rows=edges.rows, cols=edges.cols, vals=evals.to(out),
                  shape=edges.shape),
        diag=diag.to(out),
        csr=csr,
    )


def propagate_edges(rows, cols, vals, diag, x, accum_dtype=None) -> torch.Tensor:
    """``diag * x + segment_sum(vals * x[cols], rows)`` for (B, nnz) lists,
    (B, E) diag and (B, E, F) x, accumulated at >= float32 and returned in
    x's dtype: the math of the JAX `layouts/sparse.py:make_sparse_propagate`
    and `ops/chebconv.py:_xla_propagate`."""
    acc = accum_dtype or island_dtype(x.dtype)
    contrib = (vals.unsqueeze(-1) * gather_rows(x, cols)).to(acc)
    agg = segment_sum(contrib, rows, x.shape[1])
    agg = agg + diag.to(acc).unsqueeze(-1) * x.to(acc)
    return agg.to(x.dtype)



# ---- decision path: weight matrix + next-hop from the link list ------------


def weight_matrix_from_edges(link_ends, link_mask, link_delays,
                             num_nodes: int) -> torch.Tensor:
    """Per-link delays (B, L) scattered into (B, N, N) one-hop weights with
    an exact min: +inf off the links, and padded links write +inf to
    (0, 0), which the min keeps inert.  Equal bit for bit to the dense
    layout's `weight_matrix_from_link_delays`."""
    b = link_delays.shape[0]
    n = num_nodes
    u, v = link_ends[..., 0].long(), link_ends[..., 1].long()
    inf = torch.full((), float("inf"), dtype=link_delays.dtype, device=link_delays.device)
    vals = torch.where(link_mask, link_delays, inf)
    w = torch.full((b, n * n), float("inf"), dtype=link_delays.dtype,
                   device=link_delays.device)
    w = w.scatter_reduce(1, u * n + v, vals, "amin")
    w = w.scatter_reduce(1, v * n + u, vals, "amin")
    return w.view(b, n, n)


def next_hop_from_edges(link_ends, link_mask, sp: torch.Tensor) -> torch.Tensor:
    """Greedy next-hop table (B, N, N) int32 from the directed link list:
    a segment-min over edge sources finds each row's best cost, a second
    segment-min over the cost-tied candidates takes the lowest neighbour
    index, and rows with no finite option resolve to 0 (as the dense
    `next_hop_table`'s argmin does)."""
    b, n, _ = sp.shape
    u, v = link_ends[..., 0].long(), link_ends[..., 1].long()
    src = torch.cat([u, v], dim=1)                               # (B, 2L)
    dst = torch.cat([v, u], dim=1)
    m = torch.cat([link_mask, link_mask], dim=1)
    inf = torch.full((), float("inf"), dtype=sp.dtype, device=sp.device)
    cost = torch.where(m.unsqueeze(-1), gather_rows(sp, dst), inf)  # (B, 2L, N)
    seg = src.unsqueeze(-1).expand(-1, -1, n)
    best = torch.full((b, n, n), float("inf"), dtype=sp.dtype, device=sp.device)
    best = best.scatter_reduce(1, seg, cost, "amin")             # (B, N, N)
    cand = torch.where(cost <= torch.gather(best, 1, seg),
                       dst.unsqueeze(-1).expand(-1, -1, n), n)
    nh = torch.full((b, n, n), n, dtype=torch.long, device=sp.device)
    nh = nh.scatter_reduce(1, seg, cand, "amin")
    return torch.where(torch.isfinite(best) & (nh < n), nh, 0).to(torch.int32)
