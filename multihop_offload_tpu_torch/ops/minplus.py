"""K2: whole-matrix min-plus squaring (APSP), and K6: APSP fed from the
link list, batched.

Replaces `multihop_offload_tpu/ops/minplus.py:minplus_power_kernel_call`
(the Pallas kernel `_apsp_kernel` -> `_chunked_squaring`).  The CUDA kernel
is `csrc/minplus.cu` (float32) and `csrc/minplus_bf16.cu` (bf16), one body
templated on the element type (`csrc/minplus.cuh`); its source note says
what bounds it on an H100 (issue slots: 2 * N^3 adds and mins per squaring
per matrix, CUDA-core instructions in float32 and packed bf16x2 pairs in
bf16, with no tensor-core or DPX path for (min, +)) and how its tiles follow
N: the launcher picks a tile plan from (B, N) (`tile_plan` names it), and
the k loop runs to exactly N.

Early stop: the wrapper launches the full schedule of `iters` squarings and
never syncs with the host; a device-side flag per (squaring, matrix) lets
every squaring after a matrix's fixed point exit at once (see the source
note).  The result is identical to the full schedule, as the JAX
`apsp_minplus` early stop is.  `minplus_closure_cuda.launches` counts
kernel launches (one per squaring of the schedule);
`minplus_closure_cuda.executed` holds a device counter of the matrix
squarings that actually ran on each card (keyed by its `torch.device`), and
`squarings_executed` sums them; `squarings_run_plain` counts the same
squarings with plain PyTorch.

K2's backward (`csrc/minplus_bwd.cu`) puts the squarings on the autograd
tape, where JAX differentiates them (`apsp_minplus(early_stop=False)`, the
RL rollout's APSP): `minplus_closure_diff` runs K2 forward keeping each
squaring's input, then the VJP of every squaring of the schedule in
reverse, with JAX's tie split; its plain version is autograd through
`minplus_square_plain` (`minplus_closure_diff_plain`).
`minplus_closure_bwd_cuda.launches` counts its launches, two a squaring.

`minplus_closure` dispatches on the device: plain PyTorch for CPU tensors,
the CUDA kernel for CUDA tensors, an error for anything else.  On CUDA it
copies its input unless the caller hands it over (`owned=True`, as
`env/apsp.py:apsp_minplus` does with its fresh `torch.where` result).

K3 replaces `multihop_offload_tpu/ops/minplus.py:blocked_fw_call` (the
Pallas kernels `_pivot_kernel`, `_panel_kernel`, `_outer_kernel`): exact
three-phase blocked Floyd-Warshall on 128 x 128 pivot blocks.  Its plain
version `blocked_fw_plain` follows the same schedule, so the two are
bit-identical to each other and to the interpret-mode TPU kernel; the CUDA
sources are `csrc/blocked_fw.cu` and `csrc/blocked_fw_bf16.cu`, one body
templated on the element type (`csrc/blocked_fw.cuh`).

The APSP routes follow the JAX knob `apsp_impl` (`resolve_apsp`,
`resolve_coo_apsp`).  `'xla'`, JAX's default, squares at every N:
`apsp_minplus` (JAX `env/apsp.py:apsp_minplus`) and, from the link list,
`apsp_coo_squaring` (JAX's default sparse chain, `weight_matrix_from_edges`
-> `apsp_minplus_blocked`), K2 on the card.  `'pallas'` and `'auto'` take
`apsp_path(n)`, the port's counterpart of `pallas_apsp_path`: K2's squaring
up to a 128-rounded N of 256, K3 above it up to 2,048, the squaring again
beyond (what the JAX XLA delegation computes there): `apsp_minplus_pallas`
and `apsp_minplus_coo`.  On the `blocked-fw` path the matrix is padded with
+inf to a multiple of 128 and sliced back, as `apsp_minplus_pallas` pads
it.  The squarings and the blocked FW agree up to a few ulps, so the routes
may differ at near-ties of a decision.

K6 replaces `multihop_offload_tpu/ops/minplus.py:apsp_minplus_coo` (the
Pallas kernel `_coo_apsp_kernel`): the weight matrix is built on the card
from the (B, L, 2) link list, its mask and the per-link delays (exact min,
diagonal 0, +inf elsewhere), then squared up to ceil(log2(N - 1)) times
with early stop, N the padded node count (`inst.num_pad_nodes`, as
`ops/minplus.py:524-526` takes it, not a 128-rounded size).  Its plain
version is the sparse layout's chain `weight_matrix_from_edges` ->
`apsp_minplus_blocked`, and the kernel is bit-identical to it.  The CUDA
source is `csrc/coo_apsp.cu`: one launch builds W in device memory, and K2
squares it, as the TPU kernel squares with `_chunked_squaring`, the code
it shares with K2.  On the `blocked-fw` path K3 takes the place of K2
after the build, as `ops/minplus.py:507-515` hands the scatter-built W to
the blocked FW.  `apsp_minplus_coo` dispatches on the device of the delays
as `minplus_closure` does.

The bf16 leg of the precision policy (`precision.py`): `minplus_closure_cuda`
launches `csrc/minplus_bf16.cu` on bfloat16 input (the float32 kernel's
body and plans on packed bf16x2 adds and mins) and `apsp_coo_cuda`
`csrc/coo_apsp_bf16.cu` on bfloat16 delays (then the bf16 squarings); both
equal their plain versions in bf16 bit for bit.  Each bf16 kernel has its
own counters beside the float32 ones: `minplus_closure_cuda.launches_bf16`
and `.executed_bf16`, `apsp_coo_cuda.launches_bf16`.  K3 in bf16 is
`csrc/blocked_fw_bf16.cu`, launched by `blocked_fw_cuda` on bfloat16 input
and counted in `blocked_fw_cuda.launches_bf16`: the bf16 decision paths of
the `'pallas'` route above a padded N of 256 (the dense route through
`apsp_blocked_fw`, the sparse one through K6's bf16 build at the
128-rounded N), bit-identical to `blocked_fw_plain` in bf16, which equals
the TPU kernel's interpret mode on bf16.
"""

from __future__ import annotations

import ctypes
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


def squarings_run_plain(d: torch.Tensor, iters: int) -> int:
    """The (squaring, matrix) pairs that K2's device early stop runs on
    (B, N, N) `d` over `iters` squarings: squaring 0 of every matrix, then
    squaring s of matrix b while squaring s - 1 changed b.  Plain PyTorch
    (`minplus_square_blocked`), for the tests and the chip smoke."""
    live = torch.ones(d.shape[0], dtype=torch.bool, device=d.device)
    count = 0
    for _ in range(iters):
        count += int(live.sum())
        nxt = minplus_square_blocked(d)
        live &= (nxt != d).flatten(1).any(dim=1)
        if not live.any():
            break
        d = nxt
    return count


# each dtype K2 takes: the suffix of its kernel (`csrc/minplus<sfx>.cu`,
# `csrc/coo_apsp<sfx>.cu`) and of its counters on the wrappers
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}


def minplus_closure_cuda(d: torch.Tensor, iters: int, owned: bool = False) -> torch.Tensor:
    """`iters` squarings of (B, N, N) float32 or bfloat16 contiguous CUDA
    `d` (zero diagonal, +inf for non-edges), one kernel launch per
    squaring.  In bf16 every candidate sum is rounded to bf16, so the
    result equals `minplus_closure_plain` in bf16 bit for bit.  The input
    is copied, so it is never written, unless `owned`: then `d` is a
    temporary the caller gives up, and K2 takes it as its first buffer."""
    if d.dim() != 3 or d.shape[1] != d.shape[2]:
        raise ValueError(f"d must be (B, N, N), got {tuple(d.shape)}")
    if d.device.type != "cuda":
        raise ValueError("minplus_closure_cuda takes a CUDA tensor")
    if d.dtype not in _SUFFIX:
        raise TypeError(f"minplus_closure_cuda takes float32 or bfloat16, got {d.dtype}")
    if not d.is_contiguous():
        raise ValueError("minplus_closure_cuda takes a contiguous tensor")
    b, n, _ = d.shape
    if b == 0 or n == 0 or iters <= 0:
        return d if owned else d.clone()
    return _minplus_pingpong(d if owned else d.clone(), iters)


def _minplus_closure_owned(bufs, iters: int) -> torch.Tensor:
    """K2's `iters` (> 0) launches over `bufs`, (B, N, N) float32 or
    bfloat16 contiguous CUDA buffers of one shape that it may overwrite: squaring s reads `bufs[s % len(bufs)]` and writes the next
    one (two ping-pong buffers, or the `iters + 1` slices of a stack that
    keeps every squaring's input).  Returns K2's flags, (iters, B) int32:
    nonzero where squaring s changed matrix b (a squaring after one that
    changed nothing is skipped and writes nothing)."""
    first = bufs[0]
    b, n, _ = first.shape
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel grid's z limit 65535")
    sfx = _SUFFIX[first.dtype]
    fn = _build.kernel("minplus" + sfx)
    counters = getattr(minplus_closure_cuda, "executed" + sfx)
    counter = counters.get(first.device)
    if counter is None:
        counter = counters[first.device] = torch.zeros((), dtype=torch.int64,
                                                       device=first.device)
    flags = torch.zeros((iters, b), dtype=torch.int32, device=first.device)
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream().cuda_stream
        for step in range(iters):
            src, dst = bufs[step % len(bufs)], bufs[(step + 1) % len(bufs)]
            err = fn(src.data_ptr(), dst.data_ptr(), flags.data_ptr(),
                     counter.data_ptr(), b, n, step, stream)
            if sfx:
                minplus_closure_cuda.launches_bf16 += 1
            else:
                minplus_closure_cuda.launches += 1
            _build.check_launch("minplus" + sfx, err)
    return flags


def _minplus_pingpong(first: torch.Tensor, iters: int) -> torch.Tensor:
    """K2's launches with `first` (which it may overwrite) as the first of
    two ping-pong buffers.  Returns the buffer that holds the result."""
    bufs = (first, torch.empty_like(first))
    _minplus_closure_owned(bufs, iters)
    return bufs[iters % 2]


minplus_closure_cuda.launches = 0
# one int64 counter per card K2 ran on, keyed by its `torch.device`, made
# at the card's first launch
minplus_closure_cuda.executed = {}
minplus_closure_cuda.launches_bf16 = 0
minplus_closure_cuda.executed_bf16 = {}


def squarings_executed(dtype: torch.dtype = torch.float32) -> int:
    """K2's squarings that actually ran in `dtype` (float32 or bfloat16),
    summed over every card's counter (reading them waits for each card)."""
    counters = getattr(minplus_closure_cuda, "executed" + _SUFFIX[dtype])
    return sum(int(c) for c in counters.values())


def reset_squarings() -> None:
    """Set every card's squaring counters to 0."""
    for counters in (minplus_closure_cuda.executed, minplus_closure_cuda.executed_bf16):
        for c in counters.values():
            c.zero_()

PLAN_FIELDS = ("tile_rows", "tile_cols", "threads", "k_groups", "slice", "stages",
               "smem_bytes", "blocks", "copy_bytes", "tensor_copies")


def tile_plan(b: int, n: int, dtype: torch.dtype = torch.float32) -> dict:
    """The tile plan K2's launcher picks for (B, N) in `dtype` (float32 or
    bfloat16; `mho_minplus_plan` of `csrc/minplus.cu` or
    `csrc/minplus_bf16.cu`): a tile's rows and columns, threads a block,
    k-groups a block, k-slice depth, stages, dynamic shared bytes a block,
    blocks a squaring, bytes a copy of the slices (for buffers PyTorch
    allocates) and 1 where they come by tensor copies.  Builds the kernel at
    first use (needs nvcc and a card)."""
    if dtype not in _SUFFIX:
        raise TypeError(f"tile_plan takes float32 or bfloat16, got {dtype}")
    fn = _build.symbol("minplus" + _SUFFIX[dtype], "mho_minplus_plan",
                       [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    info = (ctypes.c_int * len(PLAN_FIELDS))()
    _build.check_launch("minplus plan", fn(b, n, ctypes.addressof(info)))
    return dict(zip(PLAN_FIELDS, info))


# elements of the (B, N, N, N) temp of `minplus_closure_plain` above which
# the CPU path squares k-blocked instead (the same bits; 1 GB in float64)
_BROADCAST_ELEMS = 1 << 27


def minplus_closure(d: torch.Tensor, iters: int, owned: bool = False) -> torch.Tensor:
    """APSP by squaring: plain version on the CPU (k-blocked where the
    broadcast temp would pass `_BROADCAST_ELEMS`), K2 on CUDA.  `d` is
    (B, N, N) with zero diagonal and +inf for non-edges; `owned`: the caller
    gives `d` up, so K2 need not copy it (the CPU path never writes it)."""
    if d.device.type == "cpu":
        b, n, _ = d.shape
        if b * n ** 3 > _BROADCAST_ELEMS:
            return minplus_closure_blocked(d, iters)
        return minplus_closure_plain(d, iters)
    if d.device.type == "cuda":
        return minplus_closure_cuda(d, iters, owned)
    raise ValueError(f"minplus_closure: unsupported device {d.device}")


def squaring_count(num_nodes: int) -> int:
    """ceil(log2(N - 1)) squarings reach every simple path of N nodes."""
    return max(1, math.ceil(math.log2(max(num_nodes - 1, 2))))


# ---- K2 on the autograd tape, with its backward ------------------------------


def minplus_closure_diff_plain(d: torch.Tensor, iters: int) -> torch.Tensor:
    """`iters` squarings of (B, N, N) `d` on the autograd tape: the full
    schedule, no early stop.  The plain version of K2's backward: torch's
    `minimum` gives half of a tie's cotangent to each side and `amin`
    splits its share evenly among the tied k, as the VJPs of `lax.minimum`
    and `jnp.min` do, so the gradient is `jax.grad`'s through
    `env/apsp.py:apsp_minplus(early_stop=False)`, schedule and ties
    included."""
    for _ in range(iters):
        d = minplus_square_plain(d)
    return d


def _slice_elems(b: int, n: int) -> int:
    """Elements between two slices of K2's saved stack: B N^2 rounded up to
    64 (256 bytes), so that every slice is as aligned as an allocation."""
    return -(-b * n * n // 64) * 64


def _minplus_closure_saved(d: torch.Tensor, iters: int) -> tuple:
    """K2's `iters` launches on (B, N, N) float32 contiguous CUDA `d`, with
    the input of every squaring kept for the backward: squaring s reads
    slice s of one stack and writes slice s + 1, and skips, as K2's device
    early stop does, a matrix that squaring s - 1 left unchanged (it then
    writes no slice).  Returns (result, stack, slice elements, lead): lead
    (B,) int32 counts the leading squarings that changed each matrix, so
    slice min(s, lead[b]) holds squaring s's input and slice lead[b] the
    result."""
    b, n, _ = d.shape
    step_elems = _slice_elems(b, n)
    stack = torch.empty((iters + 1) * step_elems, dtype=torch.float32, device=d.device)
    mats = stack.view(iters + 1, step_elems)[:, :b * n * n].unflatten(1, (b, n, n))
    mats[0].copy_(d)
    flags = _minplus_closure_owned(mats, iters)
    lead = flags.ne(0).to(torch.int32).cumprod(0).sum(0, dtype=torch.int32)
    out = mats[lead.long(), torch.arange(b, device=d.device)]
    return out, stack, step_elems, lead


def minplus_closure_bwd_cuda(stack: torch.Tensor, step_elems: int, lead: torch.Tensor,
                             g: torch.Tensor, iters: int) -> torch.Tensor:
    """K2's backward (`csrc/minplus_bwd.cu`): the cotangent of the input of
    `_minplus_closure_saved`'s schedule from `g`, the cotangent of its
    result, (B, N, N) float32 on the stack's card.  Every squaring's VJP in
    reverse, skipped squarings included (their input is the fixed point),
    two launches each (the tie count and split, then the gather).  The
    same bits on every call."""
    g = g.to(torch.float32).contiguous()
    if g.dim() != 3 or g.shape[1] != g.shape[2] or g.device != stack.device:
        raise ValueError(f"g must be (B, N, N) on the stack's card, got {tuple(g.shape)} on "
                         f"{g.device}")
    b, n, _ = g.shape
    if (tuple(lead.shape) != (b,) or lead.dtype != torch.int32 or step_elems < b * n * n
            or stack.numel() < (iters + 1) * step_elems):
        raise ValueError("minplus_closure_bwd_cuda: the stack and lead do not match g")
    if iters <= 0 or g.numel() == 0:
        return g.clone()
    fn = _build.kernel("minplus_bwd")
    m, w = torch.empty_like(g), torch.empty_like(g)
    bufs = (torch.empty_like(g), torch.empty_like(g))
    cur = g
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i, s in enumerate(reversed(range(iters))):
            out = bufs[i % 2]
            err = fn(stack.data_ptr(), step_elems, lead.data_ptr(), s, cur.data_ptr(),
                     out.data_ptr(), m.data_ptr(), w.data_ptr(), b, n, stream)
            minplus_closure_bwd_cuda.launches += 2
            _build.check_launch("minplus_bwd", err)
            cur = out
    return cur


minplus_closure_bwd_cuda.launches = 0


class _MinplusClosure(torch.autograd.Function):
    """K2's squarings with K2's backward, on float32 CUDA tensors."""

    @staticmethod
    def forward(ctx, d, iters):
        out, stack, step_elems, lead = _minplus_closure_saved(d.contiguous(), iters)
        ctx.saved = (stack, step_elems, lead, iters)
        return out

    @staticmethod
    def backward(ctx, g):
        stack, step_elems, lead, iters = ctx.saved
        return minplus_closure_bwd_cuda(stack, step_elems, lead, g, iters), None


def minplus_closure_diff(d: torch.Tensor, iters: int) -> torch.Tensor:
    """`iters` squarings of (B, N, N) `d` (zero diagonal, +inf for
    non-edges) that reverse mode differentiates: the plain version on the
    tape on the CPU; on CUDA, float32 only, K2 forward (with its device
    early stop, the same result as the full schedule) and K2's backward
    (`minplus_closure_bwd_cuda`), which takes every squaring's VJP."""
    if d.device.type == "cpu":
        return minplus_closure_diff_plain(d, iters)
    if d.device.type == "cuda":
        if d.dtype != torch.float32:
            raise TypeError(f"K2's backward takes float32, got {d.dtype}")
        if iters <= 0 or d.numel() == 0:
            return d.clone()
        return _MinplusClosure.apply(d, iters)
    raise ValueError(f"minplus_closure_diff: unsupported device {d.device}")


class _NoReverse(torch.autograd.Function):
    """An early-stopped closure on the tape: reverse mode raises, as JAX's
    `lax.while_loop` cannot be reverse-differentiated."""

    @staticmethod
    def forward(ctx, weights, sp):
        return sp.view_as(sp)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("apsp_minplus(early_stop=True) cannot be reverse-differentiated "
                           "(JAX's while_loop early exit); pass early_stop=False")


# ---- K3: blocked Floyd-Warshall ---------------------------------------------

FW_TILE = 128           # the TPU kernel's pivot block (`_LANE`)
_MAX_SQUARING_N = 256   # `ops/minplus.py:_MAX_SQUARING_N`
_MAX_BLOCKED_N = 2048   # `ops/minplus.py:_MAX_BLOCKED_N`
# elements of one (b, m, tile, N) candidate temp of `blocked_fw_plain`:
# rows are chunked to stay under this (128 MB in float32)
_FW_CHUNK_ELEMS = 1 << 25


def padded_n(n: int) -> int:
    """N rounded up to the 128-wide pivot block, as `apsp_minplus_pallas`
    pads it."""
    return max(FW_TILE, math.ceil(n / FW_TILE) * FW_TILE)


def apsp_path(n: int) -> str:
    """The APSP the port runs for N nodes: 'squaring' (K2) or 'blocked-fw'
    (K3), keyed on the 128-rounded N as `pallas_apsp_path` is."""
    n_pad = padded_n(n)
    if _MAX_SQUARING_N < n_pad <= _MAX_BLOCKED_N:
        return "blocked-fw"
    return "squaring"


def _minplus_into(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """min(c, a (x) b) for c (B, M, N), a (B, M, K), b (B, K, N), with the
    rows of a taken in chunks so that the (B, m, K, N) temp stays bounded.
    Each candidate is one add and min is exact, so the chunking and the
    order of k leave the result as it is."""
    bsz, m, k = a.shape
    n = b.shape[-1]
    step = max(1, _FW_CHUNK_ELEMS // max(bsz * k * n, 1))
    out = torch.empty_like(c)
    for lo in range(0, m, step):
        cand = (a[:, lo:lo + step].unsqueeze(-1) + b.unsqueeze(1)).amin(dim=2)
        out[:, lo:lo + step] = torch.minimum(c[:, lo:lo + step], cand)
    return out


def blocked_fw_plain(d: torch.Tensor, tile: int = FW_TILE) -> torch.Tensor:
    """Exact APSP of (B, N, N) `d` (zero diagonal, +inf for non-edges, N a
    multiple of `tile`) on the schedule of `blocked_fw_call`: for each pivot
    block, (1) close it by sequential FW over its `tile` steps
    (`_fw_close`); (2) update its row panel to min(blk, P (x) blk) and its
    column panel to min(blk, blk (x) P) from the old blocks, the pivot
    passed through (`_panel_kernel`); (3) update every block off the pivot
    row and column to min(c, A (x) B) from the finished panels
    (`_outer_kernel`).  Any dtype and device; returns a new tensor."""
    b, n, _ = d.shape
    if n % tile:
        raise ValueError(f"N={n} is not a multiple of the tile {tile}")
    d = d.clone()
    for k0 in range(0, n, tile):
        ks = slice(k0, k0 + tile)
        p = d[:, ks, ks]
        for k in range(tile):
            p = torch.minimum(p, p[:, :, k:k + 1] + p[:, k:k + 1, :])
        row = _minplus_into(d[:, ks, :], p, d[:, ks, :])
        col = _minplus_into(d[:, :, ks], d[:, :, ks], p)
        d[:, ks, :] = row
        d[:, :, ks] = col
        d[:, ks, ks] = p
        outer = _minplus_into(d, d[:, :, ks], d[:, ks, :])
        outer[:, ks, :] = d[:, ks, :]
        outer[:, :, ks] = d[:, :, ks]
        d = outer
    return d


def blocked_fw_cuda(d: torch.Tensor) -> torch.Tensor:
    """K3 on (B, N, N) float32 or bfloat16 contiguous CUDA `d` (zero
    diagonal, +inf for non-edges, N a multiple of 128): 3 launches per
    pivot block (pivot, the row and column panels, outer), 3 N / 128 per
    call, no host sync.  The input is copied; the copy is updated in place
    and returned.  In bf16 (`csrc/blocked_fw_bf16.cu`) every candidate is a
    packed bf16x2 add, rounded to bf16 as the plain version rounds it, so
    the result equals `blocked_fw_plain` in bf16 bit for bit."""
    if d.dim() != 3 or d.shape[1] != d.shape[2]:
        raise ValueError(f"d must be (B, N, N), got {tuple(d.shape)}")
    if d.device.type != "cuda":
        raise ValueError("blocked_fw_cuda takes a CUDA tensor")
    if d.dtype not in _SUFFIX:
        raise TypeError(f"blocked_fw_cuda takes float32 or bfloat16, got {d.dtype}")
    if not d.is_contiguous():
        raise ValueError("blocked_fw_cuda takes a contiguous tensor")
    b, n, _ = d.shape
    if n % FW_TILE:
        raise ValueError(f"N={n} is not a multiple of {FW_TILE}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel grid's y limit 65535")
    out = d.clone()
    if b == 0 or n == 0:
        return out
    name = "blocked_fw" + _SUFFIX[d.dtype]
    fn = _build.kernel(name)
    nb = n // FW_TILE
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(out.data_ptr(), b, n, stream)
    # the panel and outer phases have no blocks when N is one pivot block
    launches = nb * (3 if nb > 1 else 1)
    if d.dtype == torch.bfloat16:
        blocked_fw_cuda.launches_bf16 += launches
    else:
        blocked_fw_cuda.launches += launches
    _build.check_launch(name, err)
    return out


blocked_fw_cuda.launches = 0
blocked_fw_cuda.launches_bf16 = 0


def blocked_fw(d: torch.Tensor) -> torch.Tensor:
    """Blocked FW of (B, N, N) `d`, N a multiple of 128: plain version on
    the CPU, K3 on CUDA (float32 or bfloat16)."""
    if d.device.type == "cpu":
        return blocked_fw_plain(d)
    if d.device.type == "cuda":
        return blocked_fw_cuda(d)
    raise ValueError(f"blocked_fw: unsupported device {d.device}")


def apsp_blocked_fw(d: torch.Tensor) -> torch.Tensor:
    """APSP of (B, n, n) `d` (zero diagonal) on the `blocked-fw` path: pad
    with +inf to the 128-rounded N, `blocked_fw`, slice back
    (`apsp_minplus_pallas`, `:387-399`).  Padded nodes are isolated, so
    they add no path."""
    n = d.shape[-1]
    n_pad = padded_n(n)
    if n_pad != n:
        d = torch.nn.functional.pad(d, (0, n_pad - n, 0, n_pad - n), value=float("inf"))
    out = blocked_fw(d.contiguous())
    return out if n_pad == n else out[:, :n, :n].contiguous()


def _zero_diagonal(weights: torch.Tensor) -> torch.Tensor:
    n = weights.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=weights.device)
    return torch.where(eye, torch.zeros((), dtype=weights.dtype, device=weights.device),
                       weights)


def apsp_minplus(weights: torch.Tensor, num_iters: int | None = None,
                 early_stop: bool = True) -> torch.Tensor:
    """Shortest-path distances (B, N, N) from one-hop weights (inf where no
    edge; the diagonal is forced to 0) by `num_iters` squarings (None:
    ceil(log2(N-1)), every simple path), as the JAX `env/apsp.py:
    apsp_minplus`: the `'xla'` route.  `early_stop` (default) stops once a
    squaring changes nothing, identical to the full schedule; the zeroed
    matrix is a fresh temporary, so on the card K2 takes it as its first
    buffer with no copy, and reverse mode through it raises, as through
    JAX's `while_loop`.  `early_stop=False` puts the squarings on the
    autograd tape (`minplus_closure_diff`: K2 and K2's backward on the
    card), with the gradient of JAX's fixed schedule."""
    d = _zero_diagonal(weights)
    iters = squaring_count(weights.shape[-1]) if num_iters is None else num_iters
    if not early_stop:
        return minplus_closure_diff(d.contiguous(), iters)
    if torch.is_grad_enabled() and weights.requires_grad:
        with torch.no_grad():
            sp = minplus_closure(d.detach().contiguous(), iters, owned=True)
        return _NoReverse.apply(weights, sp)
    return minplus_closure(d.contiguous(), iters, owned=True)


def apsp_minplus_pallas(weights: torch.Tensor) -> torch.Tensor:
    """`apsp_minplus` on the path `apsp_path(N)` names (JAX
    `apsp_minplus_pallas`, the `'pallas'` route): the squarings, or the
    blocked FW above a 128-rounded N of 256."""
    n = weights.shape[-1]
    if apsp_path(n) == "blocked-fw":
        return apsp_blocked_fw(_zero_diagonal(weights))
    return apsp_minplus(weights)


APSP_IMPLS = ("xla", "pallas", "auto")


def check_apsp_impl(impl: str) -> None:
    """Raise, as the JAX `resolve_apsp` does, for an `apsp_impl` other than
    xla, pallas or auto."""
    if impl not in APSP_IMPLS:
        raise ValueError(f"apsp_impl must be xla|pallas|auto, got '{impl}'")


def resolve_apsp(impl: str, n: int):
    """The dense APSP of the knob `apsp_impl` for N nodes, as the JAX
    `resolve_apsp`: (apsp_fn, path).  `'xla'`: `apsp_minplus`, the
    squarings at every N; `'pallas'` and `'auto'`: `apsp_minplus_pallas`
    (JAX's `'auto'` takes its squarings below a padded 256 and the
    kernels from there, as `apsp_path` does).  `path` names what runs at
    this N: 'squaring' (K2 on the card) or 'blocked-fw' (K3)."""
    check_apsp_impl(impl)
    if impl == "xla":
        return apsp_minplus, "squaring"
    return apsp_minplus_pallas, apsp_path(n)


def resolve_coo_apsp(impl: str, n: int):
    """The link-list APSP of the knob `apsp_impl` (JAX `resolve_coo_apsp`):
    (edges_fn, path), `edges_fn(link_ends, link_mask, link_delays,
    num_nodes)`.  `'xla'`: `apsp_coo_squaring`; `'pallas'` and `'auto'`:
    `apsp_minplus_coo`; `path` as `resolve_apsp` names it."""
    check_apsp_impl(impl)
    if impl == "xla":
        return apsp_coo_squaring, "squaring"
    return apsp_minplus_coo, apsp_path(n)


def apsp_minplus_blocked(weights: torch.Tensor, block: int = 8,
                         num_iters: int | None = None) -> torch.Tensor:
    """Shortest-path distances (B, N, N) from one-hop weights (inf where no
    edge, the diagonal forced to 0) by k-blocked squarings with early stop
    (`env/apsp.py:98-132`): the same distances as `env.apsp.apsp_minplus`
    bit for bit, with a (B, N, block, N) temp instead of (B, N, N, N).
    Plain PyTorch on any device."""
    n = weights.shape[-1]
    return minplus_closure_blocked(_zero_diagonal(weights), num_iters or squaring_count(n),
                                   block)


def apsp_coo_plain(link_ends, link_mask, link_delays, num_nodes: int,
                   path: str | None = None) -> torch.Tensor:
    """The plain version of K6: `weight_matrix_from_edges`, then
    `apsp_minplus_blocked`, or on the `blocked-fw` path `apsp_blocked_fw`
    of W with its diagonal zeroed.  `path`: 'squaring' or 'blocked-fw'
    (None: `apsp_path(num_nodes)`)."""
    w = weight_matrix_from_edges(link_ends, link_mask, link_delays, num_nodes)
    if (path or apsp_path(num_nodes)) == "blocked-fw":
        return apsp_blocked_fw(_zero_diagonal(w))
    return apsp_minplus_blocked(w)


def apsp_coo_cuda(link_ends, link_mask, link_delays, num_nodes: int,
                  path: str | None = None) -> torch.Tensor:
    """Launch `csrc/coo_apsp.cu` (float32 delays) or `csrc/coo_apsp_bf16.cu`
    (bfloat16) for the whole batch, then close its W with K2 (squaring) or
    K3 (blocked FW, W built at the 128-rounded N; the extra nodes are
    isolated), each in the delays' dtype: link_ends (B, L, 2) int32, link_mask (B, L)
    bool, link_delays (B, L), contiguous, on one CUDA device; `path` as for
    `apsp_coo_plain`.  Returns (B, N, N) distances in the delays' dtype."""
    if link_ends.dim() != 3 or link_ends.shape[2] != 2:
        raise ValueError(f"link_ends must be (B, L, 2), got {tuple(link_ends.shape)}")
    b, l, _ = link_ends.shape
    n = num_nodes
    ddt = link_delays.dtype if link_delays.dtype in _SUFFIX else torch.float32
    for t, dtype, shape in ((link_ends, torch.int32, (b, l, 2)),
                            (link_mask, torch.bool, (b, l)),
                            (link_delays, ddt, (b, l))):
        if t.device != link_delays.device or t.device.type != "cuda":
            raise ValueError("apsp_coo_cuda: operands must share one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"apsp_coo_cuda takes {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"apsp_coo_cuda: want a contiguous {shape}, got "
                             f"{tuple(t.shape)}")
    sfx = _SUFFIX[ddt]
    blocked = (path or apsp_path(n)) == "blocked-fw"
    n_w = padded_n(n) if blocked else n
    w = torch.empty((b, n_w, n_w), dtype=ddt, device=link_delays.device)
    if b == 0 or n == 0:
        return w[:, :n, :n]
    with torch.cuda.device(link_delays.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.kernel("coo_apsp" + sfx)(link_ends.data_ptr(), link_mask.data_ptr(),
                                              link_delays.data_ptr(), w.data_ptr(), b, l,
                                              n_w, stream)
    if sfx:
        apsp_coo_cuda.launches_bf16 += 1
    else:
        apsp_coo_cuda.launches += 1
    _build.check_launch("coo_apsp" + sfx, err)
    if blocked:
        out = blocked_fw_cuda(w)
        return out if n_w == n else out[:, :n, :n].contiguous()
    # W is a fresh temporary: K2 takes it as its first buffer, with no copy
    return _minplus_pingpong(w, squaring_count(n))


apsp_coo_cuda.launches = 0
apsp_coo_cuda.launches_bf16 = 0


def apsp_minplus_coo(link_ends, link_mask, link_delays, num_nodes: int,
                     path: str | None = None) -> torch.Tensor:
    """(B, N, N) shortest-path distances from the padded link list on
    `path` (None: `apsp_path(num_nodes)`, the `'pallas'` route, as the JAX
    `apsp_minplus_coo` dispatches): plain chain on the CPU, K6 on CUDA."""
    if link_delays.device.type == "cpu":
        return apsp_coo_plain(link_ends, link_mask, link_delays, num_nodes, path)
    if link_delays.device.type == "cuda":
        return apsp_coo_cuda(link_ends, link_mask, link_delays, num_nodes, path)
    raise ValueError(f"apsp_minplus_coo: unsupported device {link_delays.device}")


def apsp_coo_squaring(link_ends, link_mask, link_delays, num_nodes: int) -> torch.Tensor:
    """The `'xla'` route from the link list: K6's build, then K2's
    squarings at every N (the JAX default sparse chain,
    `weight_matrix_from_edges` -> `apsp_minplus_blocked`, bit for bit)."""
    return apsp_minplus_coo(link_ends, link_mask, link_delays, num_nodes, "squaring")
