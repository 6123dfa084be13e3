"""K2: whole-matrix min-plus squaring (APSP), and K6: APSP fed from the
link list, batched.

Replaces `multihop_offload_tpu/ops/minplus.py:minplus_power_kernel_call`
(the Pallas kernel `_apsp_kernel` -> `_chunked_squaring`).  The CUDA kernel
is `csrc/minplus.cu`; its source note says what bounds it on an H100
(operations: 2 * N^3 CUDA-core instructions per squaring per matrix, no
tensor-core path for (min, +)) and how the tiling works.

Early stop: the wrapper launches the full schedule of `iters` squarings and
never syncs with the host; a device-side flag per (squaring, matrix) lets
every squaring after a matrix's fixed point exit at once (see the source
note).  The result is identical to the full schedule, as the JAX
`apsp_minplus` early stop is.  `minplus_closure_cuda.launches` counts
kernel launches (one per squaring of the schedule);
`minplus_closure_cuda.executed` is a device counter of the matrix
squarings that actually ran.

`minplus_closure` dispatches on the device: plain PyTorch for CPU tensors,
the CUDA kernel for CUDA tensors, an error for anything else.

K6 replaces `multihop_offload_tpu/ops/minplus.py:apsp_minplus_coo` (the
Pallas kernel `_coo_apsp_kernel`): the weight matrix is built on the card
from the (B, L, 2) link list, its mask and the per-link delays (exact min,
diagonal 0, +inf elsewhere), then squared up to ceil(log2(N - 1)) times
with early stop, N the padded node count (`inst.num_pad_nodes`, as
`ops/minplus.py:524-526` takes it, not a 128-rounded size).  Its plain
version is the sparse layout's chain `weight_matrix_from_edges` ->
`apsp_minplus_blocked`, and the kernel is bit-identical to it.  The CUDA
source is `csrc/coo_apsp.cu`: one launch builds W in device memory, and K2
squares it, at every N, as the TPU kernel squares with `_chunked_squaring`,
the code it shares with K2.  `apsp_minplus_coo` dispatches on the device
of the delays as `minplus_closure` does.
"""

from __future__ import annotations

import math

import torch

from multihop_offload_tpu_torch.layouts.sparse import weight_matrix_from_edges
from multihop_offload_tpu_torch.ops import _build


def minplus_square_plain(d: torch.Tensor) -> torch.Tensor:
    """One squaring, d[..., i, j] <- min(d, min_k d[..., i, k] + d[..., k, j]),
    as the broadcast of `env/apsp.py:_minplus_square` ((..., N, N, N) temp)."""
    return torch.minimum(d, (d.unsqueeze(-1) + d.unsqueeze(-3)).amin(dim=-2))


def minplus_closure_plain(d: torch.Tensor, iters: int) -> torch.Tensor:
    """Up to `iters` squarings of (B, N, N) `d`, stopping once a squaring
    changes nothing in the batch — the early stop of `env/apsp.py`
    (identical to the full schedule: squaring is idempotent there)."""
    for _ in range(iters):
        nxt = minplus_square_plain(d)
        if torch.equal(nxt, d):
            return nxt
        d = nxt
    return d


def minplus_square_blocked(d: torch.Tensor, block: int = 8) -> torch.Tensor:
    """`minplus_square_plain` with the contraction axis taken in k-blocks,
    as `env/apsp.py:_minplus_square_blocked` does: the same candidate sums
    and an exact min, so the same result bit for bit, with a (..., N,
    block, N) temp instead of (..., N, N, N)."""
    n = d.shape[-1]
    out = d
    for k0 in range(0, n, block):
        a = d[..., :, k0:k0 + block]
        b = d[..., k0:k0 + block, :]
        out = torch.minimum(out, (a.unsqueeze(-1) + b.unsqueeze(-3)).amin(dim=-2))
    return out


def minplus_closure_blocked(d: torch.Tensor, iters: int, block: int = 8) -> torch.Tensor:
    """`minplus_closure_plain` over `minplus_square_blocked`."""
    for _ in range(iters):
        nxt = minplus_square_blocked(d, block)
        if torch.equal(nxt, d):
            return nxt
        d = nxt
    return d


def minplus_closure_cuda(d: torch.Tensor, iters: int) -> torch.Tensor:
    """`iters` squarings of (B, N, N) float32 contiguous CUDA `d` (zero
    diagonal, +inf for non-edges), one kernel launch per squaring."""
    if d.dim() != 3 or d.shape[1] != d.shape[2]:
        raise ValueError(f"d must be (B, N, N), got {tuple(d.shape)}")
    if d.device.type != "cuda":
        raise ValueError("minplus_closure_cuda takes a CUDA tensor")
    if d.dtype != torch.float32:
        raise TypeError(f"minplus_closure_cuda takes float32, got {d.dtype}")
    if not d.is_contiguous():
        raise ValueError("minplus_closure_cuda takes a contiguous tensor")
    b, n, _ = d.shape
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel grid's z limit 65535")
    if b == 0 or n == 0 or iters <= 0:
        return d.clone()
    fn = _build.kernel("minplus")
    counter = minplus_closure_cuda.executed
    if counter is None or counter.device != d.device:
        counter = torch.zeros((), dtype=torch.int64, device=d.device)
        minplus_closure_cuda.executed = counter
    flags = torch.zeros((iters, b), dtype=torch.int32, device=d.device)
    # ping-pong pair; the input is copied in so that it is never written
    bufs = (d.clone(), torch.empty_like(d))
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        for step in range(iters):
            src, dst = bufs[step % 2], bufs[(step + 1) % 2]
            err = fn(src.data_ptr(), dst.data_ptr(), flags.data_ptr(),
                     counter.data_ptr(), b, n, step, stream)
            minplus_closure_cuda.launches += 1
            _build.check_launch("minplus", err)
    return bufs[iters % 2]


minplus_closure_cuda.launches = 0
minplus_closure_cuda.executed = None  # int64 device tensor, made at first use


def minplus_closure(d: torch.Tensor, iters: int) -> torch.Tensor:
    """APSP by squaring: plain version on the CPU, K2 on CUDA.  `d` is
    (B, N, N) with zero diagonal and +inf for non-edges."""
    if d.device.type == "cpu":
        return minplus_closure_plain(d, iters)
    if d.device.type == "cuda":
        return minplus_closure_cuda(d, iters)
    raise ValueError(f"minplus_closure: unsupported device {d.device}")


def squaring_count(num_nodes: int) -> int:
    """ceil(log2(N - 1)) squarings reach every simple path of N nodes."""
    return max(1, math.ceil(math.log2(max(num_nodes - 1, 2))))


def apsp_minplus_blocked(weights: torch.Tensor, block: int = 8,
                         num_iters: int | None = None) -> torch.Tensor:
    """Shortest-path distances (B, N, N) from one-hop weights (inf where no
    edge, the diagonal forced to 0) by k-blocked squarings with early stop
    (`env/apsp.py:98-132`): the same distances as `env.apsp.apsp_minplus`
    bit for bit, with a (B, N, block, N) temp instead of (B, N, N, N).
    Plain PyTorch on any device."""
    n = weights.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=weights.device)
    d = torch.where(eye, torch.zeros((), dtype=weights.dtype, device=weights.device),
                    weights)
    return minplus_closure_blocked(d, num_iters or squaring_count(n), block)


def apsp_coo_plain(link_ends, link_mask, link_delays, num_nodes: int) -> torch.Tensor:
    """The plain version of K6: `weight_matrix_from_edges`, then
    `apsp_minplus_blocked`."""
    return apsp_minplus_blocked(
        weight_matrix_from_edges(link_ends, link_mask, link_delays, num_nodes))


def apsp_coo_cuda(link_ends, link_mask, link_delays, num_nodes: int) -> torch.Tensor:
    """Launch `csrc/coo_apsp.cu` for the whole batch, then square its W
    with K2: link_ends (B, L, 2) int32, link_mask (B, L) bool, link_delays
    (B, L) float32, contiguous, on one CUDA device.  Returns (B, N, N)
    distances."""
    if link_ends.dim() != 3 or link_ends.shape[2] != 2:
        raise ValueError(f"link_ends must be (B, L, 2), got {tuple(link_ends.shape)}")
    b, l, _ = link_ends.shape
    n = num_nodes
    for t, dtype, shape in ((link_ends, torch.int32, (b, l, 2)),
                            (link_mask, torch.bool, (b, l)),
                            (link_delays, torch.float32, (b, l))):
        if t.device != link_delays.device or t.device.type != "cuda":
            raise ValueError("apsp_coo_cuda: operands must share one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"apsp_coo_cuda takes {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"apsp_coo_cuda: want a contiguous {shape}, got "
                             f"{tuple(t.shape)}")
    w = torch.empty((b, n, n), dtype=torch.float32, device=link_delays.device)
    if b == 0 or n == 0:
        return w
    with torch.cuda.device(link_delays.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("coo_apsp")(link_ends.data_ptr(), link_mask.data_ptr(),
                                        link_delays.data_ptr(), w.data_ptr(), b, l, n,
                                        stream)
    apsp_coo_cuda.launches += 1
    _build.check_launch("coo_apsp", err)
    return minplus_closure_cuda(w, squaring_count(n))


apsp_coo_cuda.launches = 0


def apsp_minplus_coo(link_ends, link_mask, link_delays, num_nodes: int) -> torch.Tensor:
    """(B, N, N) shortest-path distances from the padded link list: plain
    chain on the CPU, K6 on CUDA."""
    if link_delays.device.type == "cpu":
        return apsp_coo_plain(link_ends, link_mask, link_delays, num_nodes)
    if link_delays.device.type == "cuda":
        return apsp_coo_cuda(link_ends, link_mask, link_delays, num_nodes)
    raise ValueError(f"apsp_minplus_coo: unsupported device {link_delays.device}")
