"""K2: whole-matrix min-plus squaring (APSP), batched.

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
"""

from __future__ import annotations

import torch

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
