"""Ring-sharded min-plus APSP -- distance-matrix parallelism over a mesh axis.

Port of `multihop_offload_tpu/parallel/ring.py`.  For beyond-paper-scale
networks (~1000+ nodes) the distance matrix is split into row blocks over
the devices of one mesh axis, and each squaring streams the blocks around
the ring: the ring-matmul schedule in the (min, +) semiring.  At step `s`
shard `i` multiplies its columns of the block owned by `(i + s) mod n`
with the block it holds, while the copy that brings it the next block
(`collectives.ppermute`, issued before the product) is in flight.

The block product is plain torch in JAX too (`jnp.min(a[:, :, None] +
b[None], 1)`, no Pallas kernel).  It is chunked over rows so that its
(rows, k, m) intermediate stays under `BLOCK_ELEMS`, as
`ops.minplus.minplus_square_blocked` chunks.  Each candidate is one
rounded sum and a min does not depend on the order it takes them in, so
the ring equals JAX's bit for bit, infinities included.

Every function takes a leading batch axis or none: a row block is
(..., n_local, N).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from multihop_offload_tpu_torch.parallel.collectives import copy_to, gather, ppermute

# elements of one chunk of the block product's (..., rows, k, m) sums:
# 2^26 float32 elements are 256 MiB
BLOCK_ELEMS = 1 << 26


def block_minplus(a: torch.Tensor, b: torch.Tensor,
                  cap: int = BLOCK_ELEMS) -> torch.Tensor:
    """(..., n, k) x (..., k, m) min-plus product, in chunks of rows whose
    (..., rows, k, m) sums hold at most `cap` elements."""
    *batch, n, k = a.shape
    per_row = max(1, math.prod(batch) * k * b.shape[-1])
    rows = max(1, cap // per_row)
    return torch.cat([torch.amin(a[..., r:r + rows, :, None] + b[..., None, :, :], dim=-2)
                      for r in range(0, n, rows)], dim=-2)


def ring_minplus_square(d_rows: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One squaring D <- D (x) D with D row-sharded: `d_rows[i]` is shard
    i's (..., n_local, N) block on its device.  n_dev ring steps; at step s
    shard i works on the row block first owned by (i + s) mod n_dev while
    the next block is in flight."""
    n_dev = len(d_rows)
    n_local = d_rows[0].shape[-2]
    perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    out = [torch.full_like(d, math.inf) for d in d_rows]
    blocks = list(d_rows)
    for s in range(n_dev):
        nxt = ppermute(blocks, perm) if s + 1 < n_dev else None
        for i in range(n_dev):
            owner = (i + s) % n_dev
            cols = d_rows[i][..., owner * n_local:(owner + 1) * n_local]
            out[i] = torch.minimum(out[i], block_minplus(cols, blocks[i]))
        blocks = nxt
    return out


def squarings(n_total: int) -> int:
    """The squarings that close an N-node graph: ceil(log2(N - 1))."""
    return max(1, math.ceil(math.log2(max(n_total - 1, 2))))


def ring_apsp_rows(w_rows: Sequence[torch.Tensor], n_total: int,
                   num_iters: int | None = None) -> List[torch.Tensor]:
    """APSP on a row-sharded one-hop weight matrix; returns sharded rows.

    The diagonal of the full matrix is zeroed (only each shard's own
    diagonal entries fall inside its block)."""
    n_local = w_rows[0].shape[-2]
    d = []
    for i, w in enumerate(w_rows):
        rows = torch.arange(n_local, device=w.device)
        col = torch.zeros((n_local, n_total), dtype=torch.bool, device=w.device)
        col[rows, i * n_local + rows] = True
        d.append(torch.where(col, torch.zeros((), dtype=w.dtype, device=w.device), w))
    for _ in range(num_iters or squarings(n_total)):
        d = ring_minplus_square(d)
    return d


def sharded_apsp(w: torch.Tensor, devices: Sequence[torch.device]) -> torch.Tensor:
    """Drop-in `apsp_fn`: full (..., N, N) in, full (..., N, N) out on
    `w`'s device, with the compute row-sharded over `devices` (one mesh
    axis, e.g. a data shard's `graph` row) and regathered.  N must be
    divisible by the number of devices."""
    n = w.shape[-1]
    n_dev = len(devices)
    if n % n_dev:
        raise ValueError(f"APSP size {n} not divisible by the {n_dev} devices of the "
                         "ring; pad the node count to a multiple")
    n_local = n // n_dev
    rows = [copy_to(w[..., i * n_local:(i + 1) * n_local, :], dev)
            for i, dev in enumerate(devices)]
    return gather(ring_apsp_rows(rows, n), w.device, axis=-2, tiled=True)
