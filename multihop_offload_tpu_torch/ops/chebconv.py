"""K4 and K5: the sparse-layout ChebConv propagate, batched.

Replaces `multihop_offload_tpu/ops/chebconv.py:chebconv_propagate_pallas`
(the Pallas kernel `_chebconv_kernel`): ``diag * x + segment_sum(vals *
x[cols], rows)`` over a padded COO support.  The CUDA kernel is
`csrc/chebconv.cu`; its source note says what bounds it on an H100 (bytes)
and how it reads the list.

`chebconv_propagate(support, x)` is differentiable in x through a
`torch.autograd.Function`.  The support is constant (it is built from the
instance, not from parameters), so the backward needs only d x, which is
the same propagate over the transposed list (rows and columns swapped):
the JAX `custom_vjp` pulls back through `_xla_propagate`
(`ops/chebconv.py:184-189`), whose gradient is that function.  Forward and
backward both dispatch on the device of x: the plain version
(`layouts.sparse.propagate_edges`) for CPU tensors, the CUDA kernel for
CUDA tensors, an error for anything else.  There is no fall back and no
knob.

On the card the kernel reads the support's `CsrIndex` (`support.csr`),
which the sparse Instance builder makes on the host with the list, once
per instance: the forward walks each row's range of the row-sorted list,
the backward each column's range through `col_order`.  Neither reaches the
padding entries.

K5, `chebconv_propagate_ragged`, replaces
`multihop_offload_tpu/ops/chebconv.py:chebconv_propagate_ragged`
(`_chebconv_ragged_kernel`): the same function over the entries before a
per-slot live count `nnz_live` ((B,) int32), which stays on the device: the
CUDA kernel (`csrc/chebconv_ragged.cu`) reads it there, so one launch
serves every occupancy.  Its live entries may come in any row order, so it
scans the list instead of reading K4's CSR index.  Its gradient mirrors the
JAX `_cheb_ragged_bwd` (`:363-371`): d x is K5 over the swapped list (rows
and columns exchanged, the same live count); d vals and d diag are the VJP
terms of `_xla_propagate` over the full capacity, pads included.  No path
of the JAX package calls it, and none of the port does.
"""

from __future__ import annotations

import torch

from multihop_offload_tpu_torch.layouts.sparse import (
    SparseSupport,
    gather_rows,
    propagate_edges,
)
from multihop_offload_tpu_torch.ops import _build

chebconv_propagate_plain = propagate_edges


def chebconv_propagate_cuda(ptr: torch.Tensor, order: torch.Tensor | None,
                            index: torch.Tensor, vals: torch.Tensor,
                            diag: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/chebconv.cu` once for the whole batch:
    ``out[b, r] = diag[b, r] x[b, r] + sum_p vals[b, e] x[b, index[b, e]]``
    over p in [ptr[b, r], ptr[b, r + 1]), with e = order[b, p] (e = p when
    `order` is None).

    ptr (B, E + 1) and order, index (B, nnz) int32; vals (B, nnz), diag
    (B, E) and x (B, E, F) float32; all contiguous on one CUDA device.
    Returns (B, E, F)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, E, F), got {tuple(x.shape)}")
    b, e, f = x.shape
    nnz = index.shape[-1]
    shapes = {"ptr": (ptr, (b, e + 1), torch.int32), "index": (index, (b, nnz), torch.int32),
              "vals": (vals, (b, nnz), torch.float32), "diag": (diag, (b, e), torch.float32),
              "x": (x, (b, e, f), torch.float32)}
    if order is not None:
        shapes["order"] = (order, (b, nnz), torch.int32)
    for name, (t, shape, dtype) in shapes.items():
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError("chebconv_propagate_cuda: operands must share one CUDA device")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("chebconv_propagate_cuda takes contiguous tensors")
        if t.dtype != dtype:
            raise TypeError(f"chebconv_propagate_cuda: {name} is {t.dtype}, not {dtype}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = _build.kernel("chebconv")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ptr.data_ptr(), None if order is None else order.data_ptr(),
                 index.data_ptr(), vals.data_ptr(), diag.data_ptr(), x.data_ptr(),
                 out.data_ptr(), b, e, f, nnz, stream)
    chebconv_propagate_cuda.launches += 1
    _build.check_launch("chebconv", err)
    return out


chebconv_propagate_cuda.launches = 0


def _run(support: SparseSupport, x: torch.Tensor, transpose: bool) -> torch.Tensor:
    e = support.edges
    if x.device.type == "cpu":
        rows, cols = (e.cols, e.rows) if transpose else (e.rows, e.cols)
        return chebconv_propagate_plain(rows, cols, e.vals, support.diag, x)
    if x.device.type == "cuda":
        csr = support.csr
        if csr is None:
            raise ValueError("chebconv_propagate on CUDA reads the support's CSR "
                             "index: build the instance with layout='sparse'")
        if transpose:
            return chebconv_propagate_cuda(csr.col_ptr, csr.col_order, e.rows, e.vals,
                                           support.diag, x.contiguous())
        return chebconv_propagate_cuda(csr.row_ptr, None, e.cols, e.vals,
                                       support.diag, x.contiguous())
    raise ValueError(f"chebconv_propagate: unsupported device {x.device}")


class _Propagate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, support, x):
        ctx.support = support
        return _run(support, x, transpose=False)

    @staticmethod
    def backward(ctx, grad_out):
        return None, _run(ctx.support, grad_out, transpose=True)


def chebconv_propagate(support: SparseSupport, x: torch.Tensor) -> torch.Tensor:
    """``support @ x`` for a (B, E) edge-list support and (B, E, F) x:
    plain version on the CPU, K4 on CUDA; differentiable in x."""
    return _Propagate.apply(support, x)


# ---- K5: the ragged propagate ------------------------------------------------


def chebconv_propagate_ragged_plain(rows, cols, vals, diag, x, nnz_live):
    """K5's plain version: `propagate_edges` over the first nnz_live[b]
    entries of each slot's list (the entries past them are masked to
    (row 0, col 0, val 0), which adds +-0)."""
    live = (torch.arange(rows.shape[-1], device=rows.device)
            < nnz_live.to(rows.device).unsqueeze(-1))
    return propagate_edges(torch.where(live, rows, 0), torch.where(live, cols, 0),
                           torch.where(live, vals, 0), diag, x)


def chebconv_propagate_ragged_cuda(rows, cols, vals, diag, x, nnz_live) -> torch.Tensor:
    """Launch `csrc/chebconv_ragged.cu` once for the whole batch.  rows,
    cols (B, cap) int32; vals (B, cap), diag (B, E), x (B, E, F) float32;
    nnz_live (B,) int32; all contiguous on one CUDA device.  Returns
    (B, E, F)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, E, F), got {tuple(x.shape)}")
    b, e, f = x.shape
    cap = rows.shape[-1]
    shapes = {"rows": (rows, (b, cap), torch.int32), "cols": (cols, (b, cap), torch.int32),
              "vals": (vals, (b, cap), torch.float32), "diag": (diag, (b, e), torch.float32),
              "x": (x, (b, e, f), torch.float32),
              "nnz_live": (nnz_live, (b,), torch.int32)}
    for name, (t, shape, dtype) in shapes.items():
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError("chebconv_propagate_ragged_cuda: operands must share one "
                             "CUDA device")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("chebconv_propagate_ragged_cuda takes contiguous tensors")
        if t.dtype != dtype:
            raise TypeError(f"chebconv_propagate_ragged_cuda: {name} is {t.dtype}, "
                            f"not {dtype}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    fn = _build.kernel("chebconv_ragged")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), diag.data_ptr(),
                 x.data_ptr(), nnz_live.data_ptr(), out.data_ptr(), b, e, f, cap, stream)
    chebconv_propagate_ragged_cuda.launches += 1
    _build.check_launch("chebconv_ragged", err)
    return out


chebconv_propagate_ragged_cuda.launches = 0


def _run_ragged(rows, cols, vals, diag, x, nnz_live) -> torch.Tensor:
    if x.device.type == "cpu":
        return chebconv_propagate_ragged_plain(rows, cols, vals, diag, x, nnz_live)
    if x.device.type == "cuda":
        return chebconv_propagate_ragged_cuda(rows, cols, vals, diag, x.contiguous(),
                                              nnz_live)
    raise ValueError(f"chebconv_propagate_ragged: unsupported device {x.device}")


class _RaggedPropagate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, cols, vals, diag, x, nnz_live):
        ctx.save_for_backward(rows, cols, vals, diag, x, nnz_live)
        return _run_ragged(rows, cols, vals, diag, x, nnz_live)

    @staticmethod
    def backward(ctx, g):
        rows, cols, vals, diag, x, nnz_live = ctx.saved_tensors
        need_vals, need_diag, need_x = ctx.needs_input_grad[2:5]
        # d x: the propagate over the swapped list, with the same live count
        dx = _run_ragged(cols, rows, vals, diag, g.contiguous(), nnz_live) if need_x else None
        # d vals, d diag: the VJP of `_xla_propagate` over the full capacity
        dvals = (gather_rows(g, rows) * gather_rows(x, cols)).sum(-1) if need_vals else None
        ddiag = (g * x).sum(-1) if need_diag else None
        return None, None, dvals, ddiag, dx, None


def chebconv_propagate_ragged(rows, cols, vals, diag, x, nnz_live) -> torch.Tensor:
    """``diag * x + segment_sum(vals * x[cols], rows)`` over the entries
    e < nnz_live[b] of each slot's (B, cap) list, in any row order: plain
    version on the CPU, K5 on CUDA; differentiable in vals, diag and x."""
    return _RaggedPropagate.apply(rows, cols, vals, diag, x, nnz_live)


def make_fused_propagate_ragged():
    """`propagate(support, x, nnz_live)`: K5 over a `SparseSupport`, the
    counterpart of the JAX `make_fused_propagate_ragged`."""

    def propagate(support: SparseSupport, x: torch.Tensor, nnz_live: torch.Tensor):
        e = support.edges
        return chebconv_propagate_ragged(e.rows, e.cols, e.vals, support.diag, x, nnz_live)

    return propagate
