"""K1: the conflict-interference fixed point, batched.

Replaces `multihop_offload_tpu/ops/fixed_point.py:fixed_point_pallas` (the
Pallas kernel `_fp_kernel`).  The CUDA kernel is `csrc/fixed_point.cu`; its
source note says what bounds it on an H100 (bytes: one read of A) and how
the design reads A once into shared memory, as a bitmask and each row's
list of conflicts, for all ten rounds.

`fixed_point` dispatches on the device of its operands: the plain PyTorch
version for CPU tensors, the CUDA kernel for CUDA tensors, an error for
anything else.  There is no fall back and no knob.  It is differentiable:
a `torch.autograd.Function` whose backward recomputes through the plain
scan under `torch.enable_grad()` and pulls the cotangent back through it,
as the JAX `custom_vjp` (`_fp_bwd`, `ops/fixed_point.py:182-198`)
recomputes through `_xla_reference`.  The kernel has no backward of its
own; the TPU kernel has none either.

Large L: K1 keeps A in one block's shared memory, which caps L at 928.
`fixed_point_path(l)`, the port's counterpart of `auto_fp_path`, names the
path from the shape before anything launches: 'k1' where K1's shared
memory fits, 'scan' above that.  The scan is the plain update itself,
`torch.matmul(A, busy)` per iteration (cuBLAS on the card), the
counterpart of the XLA scan `env/queueing.py:interference_fixed_point_raw`
that the JAX package runs above padded L=256 outside any Pallas kernel;
native autograd differentiates it.  `fixed_point_scan.runs` counts its
calls.  `fixed_point_cuda` itself keeps raising above its cap.

`fp_impl` (JAX `:100-131`): `resolve_fixed_point(impl, l)` gives the
drop-in core the callers take as `fp_fn` and the path word JAX reports.
`'pallas'` is `fixed_point` (K1; above L=928 the scan, reported
`'xla-fallback'` as JAX reports its kernel's fallback); `'xla'` is None,
with which the callers run the sparse layout's segment-sum fixed point
(`env.queueing.interference_fixed_point`) and, on the dense layout,
`fixed_point` all the same; `'auto'` is K1 where it fits and None above.
"""

from __future__ import annotations

import torch

from multihop_offload_tpu_torch.obs import prof as obs_prof
from multihop_offload_tpu_torch.ops import _build

# shared memory a block may use on the card (227 KB)
_SMEM_BYTES = 232448


def _smem_bytes(l: int) -> int:
    """The shared memory one block of `csrc/fixed_point.cu` is sure of:
    the bitmask (L rows of an odd number of 32-bit words), a list area as
    large, busy twice.  It caps L at 928, the kernel's `kMaxL`; the launcher
    (`mho_fixed_point_f32`) gives the lists whatever else a block may use."""
    words = (l + 31) // 32
    return 2 * l * (words | 1) * 4 + 2 * l * 4


def fixed_point_plain(adj, rates, cf, lam, num_iters: int = 10):
    """The update of `env/queueing.py:interference_fixed_point_raw`:
    mu0 = rate/(cf+1), then `num_iters` x busy = clip(lam/mu, 0, 1),
    mu = rate/(1 + A @ busy).  Any leading batch axes."""
    mu = rates / (cf + 1.0)
    for _ in range(num_iters):
        busy = torch.clamp(lam / mu, 0.0, 1.0)
        neighbor = torch.matmul(adj, busy.unsqueeze(-1)).squeeze(-1)
        mu = rates / (1.0 + neighbor)
    return mu


def fixed_point_cuda(adj, rates, cf, lam, num_iters: int = 10):
    """Launch `csrc/fixed_point.cu` once for the whole batch.

    adj (B, L, L) with 0/1 entries; rates, cf, lam (B, L); float32,
    contiguous, on one CUDA device.  Returns mu (B, L)."""
    tensors = (adj, rates, cf, lam)
    if adj.dim() != 3 or adj.shape[1] != adj.shape[2]:
        raise ValueError(f"adj must be (B, L, L), got {tuple(adj.shape)}")
    b, l, _ = adj.shape
    for t in tensors:
        if t.device != adj.device or t.device.type != "cuda":
            raise ValueError("fixed_point_cuda: operands must share one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"fixed_point_cuda takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("fixed_point_cuda takes contiguous tensors")
    for t in tensors[1:]:
        if tuple(t.shape) != (b, l):
            raise ValueError(f"vector operands must be (B, L) = {(b, l)}, "
                             f"got {tuple(t.shape)}")
    if _smem_bytes(l) > _SMEM_BYTES:
        raise ValueError(f"L={l} exceeds the kernel's shared-memory limit")
    mu = torch.empty_like(rates)
    if b == 0 or l == 0:
        return mu
    fn = _build.kernel("fixed_point")
    with torch.cuda.device(adj.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(adj.data_ptr(), rates.data_ptr(), cf.data_ptr(),
                 lam.data_ptr(), mu.data_ptr(), b, l, num_iters, stream)
    fixed_point_cuda.launches += 1
    _build.check_launch("fixed_point", err)
    return mu


fixed_point_cuda.launches = 0


def fixed_point_cost_facts(b: int, l: int, num_iters: int = 10,
                           backward: bool = False) -> tuple:
    """(flops, bytes) of one K1 call on (B, L): the prof layer's fixed-point
    term, `num_iters` passes of 2·B·L² (`obs.prof.fixed_point_flops`), A
    read once and the (B, L) vectors in and out.  The backward (the plain
    scan recomputed, and its transposed passes) counts twice the passes
    and two more vectors."""
    flops = obs_prof.fixed_point_flops(b, l, num_iters)
    vectors = 6 if backward else 4
    return (2 * flops if backward else flops), 4.0 * (b * l * l + vectors * b * l)


def _facts(adj, rates, cf, lam, num_iters=10):
    return fixed_point_cost_facts(adj.shape[0], adj.shape[-1], num_iters)


@obs_prof.counted("fixed_point", _facts)
def _forward(adj, rates, cf, lam, num_iters):
    if adj.device.type == "cpu":
        return fixed_point_plain(adj, rates, cf, lam, num_iters)
    if adj.device.type == "cuda":
        return fixed_point_cuda(adj, rates, cf, lam, num_iters)
    raise ValueError(f"fixed_point: unsupported device {adj.device}")


class _FixedPoint(torch.autograd.Function):
    """Forward: plain version or K1.  Backward: recompute through the plain
    scan and pull the cotangent back through it."""

    @staticmethod
    def forward(ctx, adj, rates, cf, lam, num_iters):
        ctx.save_for_backward(adj, rates, cf, lam)
        ctx.num_iters = num_iters
        return _forward(adj, rates, cf, lam, num_iters)

    @staticmethod
    def backward(ctx, grad_mu):
        return (*_backward(*ctx.saved_tensors, grad_mu, ctx.num_iters,
                           ctx.needs_input_grad[:4]), None)


@obs_prof.counted("fixed_point_bwd", lambda adj, *a: fixed_point_cost_facts(
    adj.shape[0], adj.shape[-1], a[-2], backward=True))
def _backward(adj, rates, cf, lam, grad_mu, num_iters, need):
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip((adj, rates, cf, lam), need)]
        mu = fixed_point_plain(*ins, num_iters)
        wrt = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(mu, wrt, grad_mu))
    return tuple(next(got) if n else None for n in need)


def fixed_point_path(l: int) -> str:
    """The fixed point the port runs for L links: 'k1' where K1's shared
    memory holds A, 'scan' above that (L > 928)."""
    return "k1" if _smem_bytes(l) <= _SMEM_BYTES else "scan"


def fixed_point_scan(adj, rates, cf, lam, num_iters: int = 10):
    """The 'scan' path: `fixed_point_plain` on a CPU or CUDA device, under
    native autograd; counts its calls in `fixed_point_scan.runs`."""
    if adj.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fixed_point: unsupported device {adj.device}")
    fixed_point_scan.runs += 1
    return fixed_point_plain(adj, rates, cf, lam, num_iters)


fixed_point_scan.runs = 0


def fixed_point(adj, rates, cf, lam, num_iters: int = 10):
    """Converged mu (B, L) on `fixed_point_path(L)`: K1 (plain version on
    the CPU) or the scan; differentiable in every operand."""
    if fixed_point_path(adj.shape[-1]) == "scan":
        return fixed_point_scan(adj, rates, cf, lam, num_iters)
    return _FixedPoint.apply(adj, rates, cf, lam, num_iters)


def auto_fp_path(l: int) -> str:
    """The path `fp_impl='auto'` takes for L links: 'pallas' (K1) where
    K1's shared memory holds A, 'xla' above.  JAX's `auto_fp_path` stops at
    a padded L of 256, its kernel's measured win on the TPU, and takes
    'xla' everywhere off the TPU; the port's K1 runs up to 928."""
    return "pallas" if fixed_point_path(l) == "k1" else "xla"


def resolve_fixed_point(impl: str, l: int):
    """`Config.fp_impl` resolved for L links: (fp_fn, path), JAX's values
    and path words (`ops/fixed_point.py:108-131`).  `fp_fn` is None for
    'xla' (and 'auto' above K1's cap), else `fixed_point`; `path` is
    'xla' | 'pallas' | 'xla-fallback' (the scan under 'pallas' above
    L=928)."""
    if impl not in ("xla", "pallas", "auto"):
        raise ValueError(f"fp_impl must be xla|pallas|auto, got '{impl}'")
    if impl == "xla":
        return None, "xla"
    if impl == "auto":
        path = auto_fp_path(l)
        return (fixed_point if path == "pallas" else None), path
    return fixed_point, ("pallas" if fixed_point_path(l) == "k1" else "xla-fallback")
