"""Padded COO matrices and their products.

Port of `multihop_offload_tpu/ops/sparse.py`: `COO`, an (n, n) matrix as
padded (row, col, val) lists of a static length nnz_pad, and the three
functions of `:35-60`: `dense_to_coo` (host conversion with padding),
`coo_matmul` (a gather, then a segment-sum) and `coo_propagate` (the
`ChebConv` propagate hook over a COO support).  Padding entries are (row=0,
col=0, val=0), inert under every segment reduction of the sparse layout.
With the batch axis B the lists are (B, nnz_pad).

The segment-sum gives the same bits on every call on the card as on the
CPU: the real entries of a list made by `dense_to_coo` (or the sparse
layout's `_coo_from_dense_np`) come first, sorted by row (`np.nonzero`
order), so each row is one run of the list, and `torch.segment_reduce`
adds a run's entries one after another in list order (no atomics; the
pads form a last run that is dropped).  Its backward does the same over
the list grouped by column, so the gradient is as reproducible.  The same
product is the sparse layout's conflict fixed point
(`env.queueing.interference_fixed_point`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multihop_offload_tpu_torch._records import TensorRecord


@dataclasses.dataclass
class COO(TensorRecord):
    rows: torch.Tensor  # (..., nnz_pad) int32
    cols: torch.Tensor  # (..., nnz_pad) int32
    vals: torch.Tensor  # (..., nnz_pad) float
    shape: tuple        # static logical (n, n)


def dense_to_coo(mat, nnz_pad: int | None = None, round_to: int = 128) -> COO:
    """Host-side conversion with padding to a static nonzero count (JAX
    `:35-50`): (n, n) gives (nnz_pad,) lists, (B, n, n) gives (B, nnz_pad)
    lists with one pad, the largest count rounded up to `round_to`.  Real
    entries in `np.nonzero` order, pads after them; CPU tensors."""
    if isinstance(mat, torch.Tensor):
        mat = mat.detach().cpu().numpy()
    mat = np.asarray(mat)
    batched = mat.ndim == 3
    mats = mat if batched else mat[None]
    found = [np.nonzero(m) for m in mats]
    nnz = max(r.size for r, _ in found)
    if nnz_pad is None:
        nnz_pad = max(round_to, int(-(-nnz // round_to) * round_to))
    if nnz > nnz_pad:
        raise ValueError(f"{nnz} nonzeros exceed pad {nnz_pad}")
    b = len(mats)
    rows = np.zeros((b, nnz_pad), np.int32)
    cols = np.zeros((b, nnz_pad), np.int32)
    vals = np.zeros((b, nnz_pad), mat.dtype)
    for i, (r, c) in enumerate(found):
        rows[i, :r.size], cols[i, :r.size], vals[i, :r.size] = r, c, mats[i][r, c]
    if not batched:
        rows, cols, vals = rows[0], cols[0], vals[0]
    return COO(rows=torch.from_numpy(rows), cols=torch.from_numpy(cols),
               vals=torch.from_numpy(vals), shape=tuple(mat.shape[-2:]))


def _gather(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x[b, index[b, k]] for (B, N, F) x and (B, K) index -> (B, K, F)."""
    return torch.gather(x, 1, index.unsqueeze(-1).expand(-1, -1, x.shape[-1]))


class RowRuns:
    """How a batched COO list splits into row runs: `lengths` (B, n + 1),
    row r's entries per batch, the pads counted in run n.  The column runs
    of the backward (`by_col`: the list's stable order by column and its
    lengths) are made on first use.  The real entries are the first
    count_nonzero(vals) of each list, as `layouts.sparse.csr_index` reads
    them; each list must hold them sorted by row."""

    def __init__(self, coo: COO):
        rows, cols, vals = (t if t.dim() == 2 else t.unsqueeze(0)
                            for t in (coo.rows, coo.cols, coo.vals))
        self.n = coo.shape[0]
        pos = torch.arange(rows.shape[1], device=rows.device)
        self.real = pos < (vals != 0).sum(dim=1, keepdim=True)
        self.rows = torch.where(self.real, rows.long(), self.n)
        self.cols = cols.long()
        self.lengths = self._count(self.rows)
        self._by_col = None

    def _count(self, keys: torch.Tensor) -> torch.Tensor:
        # integer counts: order-free, so the same on every call
        return torch.zeros((keys.shape[0], self.n + 1), dtype=torch.long,
                           device=keys.device).scatter_add_(1, keys, torch.ones_like(keys))

    def by_col(self):
        if self._by_col is None:
            keys = torch.where(self.real, self.cols, self.n)
            keys, order = torch.sort(keys, dim=1, stable=True)
            self._by_col = (order, torch.gather(self.rows.clamp_max(self.n - 1), 1, order),
                            self._count(keys))
        return self._by_col

    def reduce(self, contrib: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Each run's entries of (B, nnz, F) summed in list order -> (B, n, F)."""
        out = torch.segment_reduce(contrib, "sum", lengths=lengths, axis=1, unsafe=True)
        return out[:, :self.n]


class _CooMatmul(torch.autograd.Function):
    """y = A @ x over the row runs; the backward gives A^T @ g over the
    column runs (and d vals where it is asked for), with no atomics."""

    @staticmethod
    def forward(ctx, runs: RowRuns, vals, x):
        ctx.runs = runs
        ctx.save_for_backward(vals, x)
        cols = runs.cols.clamp_max(runs.n - 1)
        return runs.reduce(vals.unsqueeze(-1) * _gather(x, cols), runs.lengths)

    @staticmethod
    def backward(ctx, g):
        runs = ctx.runs
        vals, x = ctx.saved_tensors
        g_vals = g_x = None
        if ctx.needs_input_grad[2]:
            order, rows_t, lengths_t = runs.by_col()
            v_t = torch.gather(vals, 1, order)
            g_x = runs.reduce(v_t.unsqueeze(-1) * _gather(g, rows_t), lengths_t)
        if ctx.needs_input_grad[1]:
            rows = runs.rows.clamp_max(runs.n - 1)
            cols = runs.cols.clamp_max(runs.n - 1)
            g_vals = torch.where(runs.real, (_gather(g, rows) * _gather(x, cols)).sum(-1), 0.0)
        return None, g_vals, g_x


def coo_matmul(coo: COO, x: torch.Tensor, runs: RowRuns | None = None) -> torch.Tensor:
    """(n, n) sparse @ (n, F) dense -> (n, F): one gather and one
    segment-sum (JAX `:53-56`); batched: (B, nnz) lists and (B, n, F) x.
    `runs` (the list's `RowRuns`) may be made once for repeated products
    with one list.  Differentiable in x and in the values."""
    batched = coo.rows.dim() == 2
    runs = runs or RowRuns(coo)
    vals = coo.vals if batched else coo.vals.unsqueeze(0)
    xb = x if batched else x.unsqueeze(0)
    out = _CooMatmul.apply(runs, vals.to(x.dtype), xb)
    return out if batched else out[0]


def coo_propagate(support: COO, x: torch.Tensor) -> torch.Tensor:
    """`ChebConv.propagate`-compatible: `support` is a COO (JAX `:59-60`)."""
    return coo_matmul(support, x)
