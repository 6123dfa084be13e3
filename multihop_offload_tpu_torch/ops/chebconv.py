"""K4 and K5: the sparse-layout ChebConv propagate, batched.

Replaces `multihop_offload_tpu/ops/chebconv.py:chebconv_propagate_pallas`
(the Pallas kernel `_chebconv_kernel`): ``diag * x + segment_sum(vals *
x[cols], rows)`` over a padded COO support.  The CUDA kernel is the row
walk of `csrc/chebconv.cu`; its source note says what bounds it on an
H100 and how it reads the list.

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

On the card the walk reads the support's `CsrIndex` (`support.csr`),
which the sparse Instance builder makes on the host with the list, once
per instance: the forward walks each row's range of the row-sorted list,
the backward each column's range through `col_order`.  Neither reaches the
padding entries.

K5, `chebconv_propagate_ragged`, replaces
`multihop_offload_tpu/ops/chebconv.py:chebconv_propagate_ragged`
(`_chebconv_ragged_kernel`): the same function over the entries before a
per-slot live count `nnz_live` ((B,) int32), which stays on the device.
Its live entries may come in any row order, so on the card K5 is two
launches: `ragged_index_cuda` (`csrc/chebconv_ragged.cu`), a stable
counting sort of each slot's live prefix by row and by column that reads
the live counts itself, then the same row walk as K4 over the row index.
Its gradient mirrors the JAX `_cheb_ragged_bwd` (`:363-371`): d x is the
walk over the column index the forward sorted (no second sort); d vals
and d diag are the VJP terms of `_xla_propagate` over the full capacity,
pads included.  No path of the JAX package calls it, and none of the
port does.

Under the bf16 precision policy x and the support are bfloat16 and the
forward's sum is fp32 (`ops/chebconv.py:203`): the plain version is
`propagate_edges` (bf16 products, an fp32 segment sum, rounded once), and
on the card `chebconv_propagate_cuda` launches K4's bf16 forward
(`csrc/chebconv_bf16.cu`) on bfloat16 x, counted in
`chebconv_propagate_cuda.launches_bf16`.  The backward in bf16 does not
sum in fp32: JAX's VJP of `_xla_propagate` (`:56-63`) scatter-adds the
bf16 products into their columns in bf16, one rounding an add, and adds
the diagonal term, itself rounded to bf16, last.  Its plain version is
`chebconv_transpose_bf16_plain`, and on the card the transposed walk of
the same file runs it (`order` given on bfloat16 x), counted in
`chebconv_propagate_cuda.launches_bf16_t`; both equal JAX bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from multihop_offload_tpu_torch._records import TensorRecord
from multihop_offload_tpu_torch.layouts.sparse import (
    SparseSupport,
    gather_rows,
    propagate_edges,
)
from multihop_offload_tpu_torch.obs import prof as obs_prof
from multihop_offload_tpu_torch.ops import _build

chebconv_propagate_plain = propagate_edges


def chebconv_transpose_bf16_plain(rows, cols, vals, diag, g) -> torch.Tensor:
    """The transposed propagate in bf16, as JAX's VJP of `_xla_propagate`
    with bf16 x and fp32 accumulation computes d x: for (B, nnz) lists,
    (B, E) diag and (B, E, F) g, all bf16 but the indices,

        out[b, c] = bf16(h[b, c] + acc[b, c]),  h = bf16(fp32(diag) * fp32(g)),

    acc the running sum, from +0, of the products bf16(vals[e] g[rows[e]])
    over the entries e with cols[e] == c in entry order, each add rounded
    to bf16.  Vectorised over columns, one step a position up to the
    longest column (no bf16 `index_add_`, whose order is not promised).
    Entries of value 0 (the pads) are left out: their products are +-0,
    and adding +-0 leaves a sum that starts at +0 as it is."""
    b, nnz = cols.shape
    e = g.shape[1]
    key = torch.where(vals != 0, cols.long(), e)  # pads sort last, past every column
    key, order = torch.sort(key, dim=1, stable=True)
    prod = torch.gather(vals, 1, order).unsqueeze(-1) * gather_rows(
        g, torch.gather(rows, 1, order))          # bf16 products, column-sorted
    col = torch.arange(e, device=g.device).expand(b, e).contiguous()
    start = torch.searchsorted(key, col)
    length = torch.searchsorted(key, col, right=True) - start
    acc = torch.zeros_like(g)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for k in range(int(length.max()) if e and nnz else 0):
        term = gather_rows(prod, (start + k).clamp(max=nnz - 1))
        acc = acc + torch.where((k < length).unsqueeze(-1), term, zero)
    h = (diag.float().unsqueeze(-1) * g.float()).to(g.dtype)
    return h + acc


def chebconv_propagate_cuda(ptr: torch.Tensor, order: torch.Tensor | None,
                            index: torch.Tensor, vals: torch.Tensor,
                            diag: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch the row walk of `csrc/chebconv.cu` once for the whole batch:
    ``out[b, r] = diag[b, r] x[b, r] + sum_p vals[b, e] x[b, index[b, e]]``
    over p in [ptr[b, r], ptr[b, r + 1]), with e = order[b, p] (e = p when
    `order` is None).

    ptr (B, E + 1) and order, index (B, nnz) int32; vals (B, nnz), diag
    (B, E) and x (B, E, F) float32; all contiguous on one CUDA device.
    Returns (B, E, F).

    On bfloat16 vals, diag and x it launches `csrc/chebconv_bf16.cu`: with
    `order` None the forward (each product rounded to bf16, the sum taken
    in fp32 in list order and rounded to bf16 once), with `order` the
    transposed walk of the backward (each add rounded to bf16 in list
    order, then diag * x rounded to bf16 added last:
    `chebconv_transpose_bf16_plain`)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, E, F), got {tuple(x.shape)}")
    bf16 = x.dtype == torch.bfloat16
    fdt = torch.bfloat16 if bf16 else torch.float32
    b, e, f = x.shape
    nnz = index.shape[-1]
    shapes = {"ptr": (ptr, (b, e + 1), torch.int32), "index": (index, (b, nnz), torch.int32),
              "vals": (vals, (b, nnz), fdt), "diag": (diag, (b, e), fdt),
              "x": (x, (b, e, f), fdt)}
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
    name = "chebconv_bf16" if bf16 else "chebconv"
    if bf16 and order is not None:
        fn = _build.symbol(name, "mho_chebconv_transpose_bf16",
                           [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        head = (ptr.data_ptr(), order.data_ptr())
    elif bf16:  # the forward launcher takes no `order`
        fn, head = _build.kernel(name), (ptr.data_ptr(),)
    else:
        fn = _build.kernel(name)
        head = (ptr.data_ptr(), None if order is None else order.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*head, index.data_ptr(), vals.data_ptr(), diag.data_ptr(), x.data_ptr(),
                 out.data_ptr(), b, e, f, nnz, stream)
    if bf16 and order is not None:
        chebconv_propagate_cuda.launches_bf16_t += 1
    elif bf16:
        chebconv_propagate_cuda.launches_bf16 += 1
    else:
        chebconv_propagate_cuda.launches += 1
    _build.check_launch(name, err)
    return out


chebconv_propagate_cuda.launches = 0
chebconv_propagate_cuda.launches_bf16 = 0
chebconv_propagate_cuda.launches_bf16_t = 0


def chebconv_walk_plain(ptr, order, index, vals, diag, x) -> torch.Tensor:
    """The walk's plain version, `chebconv_propagate_cuda`'s arguments:
    each row's entries p in [ptr[b, r], ptr[b, r + 1]) summed in p order
    (the sequential `index_add` of `propagate_edges`), then diag * x.
    Positions outside every row add +-0 to row 0 after its entries."""
    b, nnz = index.shape
    pos = torch.arange(nnz, device=index.device).expand(b, nnz)
    ptr = ptr.long()
    row = torch.searchsorted(ptr[:, 1:].contiguous(), pos.contiguous(), right=True)
    inside = (pos >= ptr[:, :1]) & (pos < ptr[:, -1:])
    ent = pos if order is None else order.long()
    return propagate_edges(torch.where(inside, row, 0),
                           torch.where(inside, torch.gather(index, 1, ent), 0),
                           torch.where(inside, torch.gather(vals, 1, ent), 0), diag, x)


# ---- cost facts (JAX `ops/chebconv.py:88-113`, `:257-292`, copied) ---------

_LANE = 128        # the TPU kernel's lane tile
_EDGE_BLOCK = 512  # edges the TPU kernel walks a grid step


def _pad_to(v: int, m: int) -> int:
    return max(m, math.ceil(v / m) * m)


def chebconv_cost_facts(n: int, nnz: int, feat: int,
                        dtype_bytes: int = 4) -> dict:
    """JAX's analytic cost facts of one instance's propagate: two (N, nnz)
    x (nnz, F)-class matmuls and the diagonal seed; the list, the diagonal,
    x in and the output once."""
    flops = 4.0 * n * nnz * feat + 2.0 * n * feat   # 2 matmuls + diag seed
    bytes_accessed = (
        2 * nnz * 4                   # rows + cols (int32)
        + nnz * dtype_bytes           # vals
        + n * dtype_bytes             # diag
        + 2 * n * feat * dtype_bytes  # x in + one out write per node tile
    )
    return {"flops": flops, "bytes_accessed": float(bytes_accessed),
            "argument_bytes": float(bytes_accessed - n * feat * dtype_bytes)}


def chebconv_ragged_cost_facts(n: int, nnz_live: int, nnz_cap: int,
                               feat: int, dtype_bytes: int = 4,
                               edge_block: int = _EDGE_BLOCK) -> dict:
    """JAX's executed cost of one ragged call: `ceil(live / Eb)` edge
    blocks of the TPU kernel run, so the facts scale with occupancy."""
    eb = min(edge_block, _pad_to(max(nnz_cap, 1), _LANE))
    blocks = math.ceil(max(int(nnz_live), 1) / eb)
    nnz_run = blocks * eb
    flops = 4.0 * n * nnz_run * feat + 2.0 * n * feat
    bytes_accessed = (
        2 * nnz_run * 4
        + nnz_run * dtype_bytes
        + n * dtype_bytes
        + 2 * n * feat * dtype_bytes
    )
    return {"flops": flops, "bytes_accessed": float(bytes_accessed),
            "argument_bytes": float(bytes_accessed - n * feat * dtype_bytes)}


def _walk_facts(support: SparseSupport, x: torch.Tensor, transpose: bool) -> tuple:
    """(flops, bytes) of one K4 walk in a counted program: B times
    `chebconv_cost_facts` (the transposed walk does the same work).  The
    forward registers the `ops/chebconv` record of its shape."""
    b, n, feat = x.shape
    nnz = support.edges.rows.shape[-1]
    facts = chebconv_cost_facts(n, nnz, feat, x.element_size())
    if not transpose:
        obs_prof.register_kernel_once("ops/chebconv", f"n{n}_nnz{nnz}_f{feat}", facts,
                                      x.device.type)
    return b * facts["flops"], b * facts["bytes_accessed"]


def _run(support: SparseSupport, x: torch.Tensor, transpose: bool) -> torch.Tensor:
    """K4 forward or transposed walk on the device of x; in a counted
    program it adds `_walk_facts`."""
    with obs_prof.kernel_scope("chebconv_t" if transpose else "chebconv",
                               lambda: _walk_facts(support, x, transpose)):
        e = support.edges
        if x.device.type == "cpu":
            if transpose and x.dtype == torch.bfloat16:
                return chebconv_transpose_bf16_plain(e.rows, e.cols, e.vals, support.diag, x)
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


@dataclasses.dataclass
class RaggedIndex(TensorRecord):
    """Row and column access to the live prefix of each slot's list, in
    list order within a row (a stable sort): row r's entries are
    row_order[b, row_ptr[b, r] : row_ptr[b, r + 1]], column c's likewise.
    The entries past the live count, and live entries whose key is out of
    [0, E), sort last in list order, past ptr[b, E]."""

    row_ptr: torch.Tensor    # (B, E + 1) int32
    row_order: torch.Tensor  # (B, cap) int32
    col_ptr: torch.Tensor    # (B, E + 1) int32
    col_order: torch.Tensor  # (B, cap) int32


# the sort's caps: both staged lists and the per-warp histograms fit in one
# block's shared memory (`csrc/chebconv_ragged.cu`)
RAGGED_MAX_ROWS = 2048
RAGGED_MAX_CAP = 16384


def _stable_index(keys: torch.Tensor, live: torch.Tensor, num_rows: int):
    k = torch.where(live & (keys >= 0) & (keys < num_rows), keys.long(), num_rows)
    order = torch.sort(k, dim=-1, stable=True).indices.to(torch.int32)
    b = k.shape[0]
    off = torch.arange(b, device=k.device).unsqueeze(1) * (num_rows + 1)
    counts = torch.bincount((k + off).reshape(-1), minlength=b * (num_rows + 1))
    ptr = torch.zeros((b, num_rows + 1), dtype=torch.int64, device=k.device)
    ptr[:, 1:] = counts.view(b, num_rows + 1)[:, :num_rows].cumsum(1)
    return ptr.to(torch.int32), order


def ragged_index_plain(rows, cols, nnz_live, num_rows: int) -> RaggedIndex:
    """The sort's plain version: a stable `torch.sort` of each slot's row
    (and column) keys, every entry at or past nnz_live[b] (or with a key
    out of [0, num_rows)) keyed num_rows; ptr from `bincount`/`cumsum`."""
    live = (torch.arange(rows.shape[-1], device=rows.device)
            < nnz_live.to(rows.device).unsqueeze(-1))
    row_ptr, row_order = _stable_index(rows, live, num_rows)
    col_ptr, col_order = _stable_index(cols, live, num_rows)
    return RaggedIndex(row_ptr=row_ptr, row_order=row_order, col_ptr=col_ptr,
                       col_order=col_order)


def ragged_index_cuda(rows, cols, nnz_live, num_rows: int) -> RaggedIndex:
    """Launch `csrc/chebconv_ragged.cu` once for the whole batch: the
    `RaggedIndex` of each slot's first nnz_live[b] entries, which the
    kernel reads from device memory.  rows, cols (B, cap) int32, nnz_live
    (B,) int32, contiguous on one CUDA device; raises above the caps
    (num_rows <= RAGGED_MAX_ROWS, cap <= RAGGED_MAX_CAP)."""
    if rows.dim() != 2:
        raise ValueError(f"rows must be (B, cap), got {tuple(rows.shape)}")
    b, cap = rows.shape
    if not (1 <= num_rows <= RAGGED_MAX_ROWS and 1 <= cap <= RAGGED_MAX_CAP):
        raise ValueError(f"ragged_index_cuda: E={num_rows}, cap={cap} above the sort's "
                         f"caps (E <= {RAGGED_MAX_ROWS}, cap <= {RAGGED_MAX_CAP})")
    shapes = {"rows": (rows, (b, cap)), "cols": (cols, (b, cap)),
              "nnz_live": (nnz_live, (b,))}
    for name, (t, shape) in shapes.items():
        if t.device != rows.device or t.device.type != "cuda":
            raise ValueError("ragged_index_cuda: operands must share one CUDA device")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("ragged_index_cuda takes contiguous tensors")
        if t.dtype != torch.int32:
            raise TypeError(f"ragged_index_cuda: {name} is {t.dtype}, not torch.int32")
    # one allocation, carved into the four contiguous outputs
    sizes = [b * (num_rows + 1), b * cap, b * (num_rows + 1), b * cap]
    buf = torch.empty((sum(sizes),), dtype=torch.int32, device=rows.device)
    row_ptr, row_order, col_ptr, col_order = (
        part.view(b, -1) for part in torch.split(buf, sizes))
    fn = _build.kernel("chebconv_ragged")
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rows.data_ptr(), cols.data_ptr(), nnz_live.data_ptr(), row_ptr.data_ptr(),
                 row_order.data_ptr(), col_ptr.data_ptr(), col_order.data_ptr(), b,
                 num_rows, cap, stream)
    ragged_index_cuda.launches += 1
    _build.check_launch("chebconv_ragged", err)
    return RaggedIndex(row_ptr=row_ptr, row_order=row_order, col_ptr=col_ptr,
                       col_order=col_order)


ragged_index_cuda.launches = 0


def chebconv_propagate_ragged_plain(rows, cols, vals, diag, x, nnz_live):
    """K5's plain version: `propagate_edges` over the first nnz_live[b]
    entries of each slot's list (the entries past them are masked to
    (row 0, col 0, val 0), which adds +-0)."""
    live = (torch.arange(rows.shape[-1], device=rows.device)
            < nnz_live.to(rows.device).unsqueeze(-1))
    return propagate_edges(torch.where(live, rows, 0), torch.where(live, cols, 0),
                           torch.where(live, vals, 0), diag, x)


def chebconv_propagate_ragged_cuda(rows, cols, vals, diag, x, nnz_live) -> torch.Tensor:
    """K5 on the card: `ragged_index_cuda`, then the row walk over its row
    index (2 launches).  rows, cols (B, cap) int32; vals (B, cap), diag
    (B, E), x (B, E, F) float32; nnz_live (B,) int32; all contiguous on
    one CUDA device.  Returns (B, E, F)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, E, F), got {tuple(x.shape)}")
    idx = ragged_index_cuda(rows, cols, nnz_live, x.shape[1])
    return chebconv_propagate_cuda(idx.row_ptr, idx.row_order, cols, vals, diag, x)


class _RaggedPropagate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, cols, vals, diag, x, nnz_live):
        cap = rows.shape[-1]
        ctx.save_for_backward(rows, cols, vals, diag, x, nnz_live)
        ctx.index = None
        with obs_prof.kernel_scope("chebconv_ragged",
                                   lambda: _ragged_facts(x, cap, nnz_live, register=True)):
            if x.device.type == "cpu":
                return chebconv_propagate_ragged_plain(rows, cols, vals, diag, x, nnz_live)
            if x.device.type == "cuda":
                # one sort serves the forward's row walk and the backward's column walk
                ctx.index = ragged_index_cuda(rows, cols, nnz_live, x.shape[1])
                return chebconv_propagate_cuda(ctx.index.row_ptr, ctx.index.row_order, cols,
                                               vals, diag, x.contiguous())
        raise ValueError(f"chebconv_propagate_ragged: unsupported device {x.device}")

    @staticmethod
    def backward(ctx, g):
        rows, cols, vals, diag, x, nnz_live = ctx.saved_tensors
        need_vals, need_diag, need_x = ctx.needs_input_grad[2:5]
        with obs_prof.kernel_scope("chebconv_ragged_t",
                                   lambda: _ragged_facts(x, rows.shape[-1], nnz_live)):
            # d x: the propagate over the swapped list, with the same live count
            dx = None
            if need_x and ctx.index is not None:
                dx = chebconv_propagate_cuda(ctx.index.col_ptr, ctx.index.col_order, rows,
                                             vals, diag, g.contiguous())
            elif need_x:
                dx = chebconv_propagate_ragged_plain(cols, rows, vals, diag, g, nnz_live)
            # d vals, d diag: the VJP of `_xla_propagate` over the full capacity
            dvals = (gather_rows(g, rows) * gather_rows(x, cols)).sum(-1) if need_vals else None
            ddiag = (g * x).sum(-1) if need_diag else None
        return None, None, dvals, ddiag, dx, None


def _ragged_facts(x, cap: int, nnz_live, register: bool = False) -> tuple:
    """(flops, bytes) of one K5 call in a counted program:
    `chebconv_ragged_cost_facts` at each slot's live count (read from the
    device).  The forward (`register`) registers the `ops/chebconv_ragged`
    record of its shape at capacity."""
    b, n, feat = x.shape
    if register:
        obs_prof.register_kernel_once(
            "ops/chebconv_ragged", f"n{n}_cap{cap}_f{feat}",
            chebconv_cost_facts(n, cap, feat, x.element_size()), x.device.type)
    facts = [chebconv_ragged_cost_facts(n, int(live), cap, feat, x.element_size())
             for live in nnz_live.reshape(-1).tolist()]
    return sum(f["flops"] for f in facts), sum(f["bytes_accessed"] for f in facts)


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
