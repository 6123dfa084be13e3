"""Mixed-precision compute policy: bf16 for the bulk, fp32 islands.

Port of `multihop_offload_tpu/precision.py`.  One `PrecisionPolicy` names
the four dtypes every consumer draws from:

- ``param_dtype``   model parameters; never narrowed below fp32.
- ``compute_dtype`` the bulk math: the ChebConv operands and the Chebyshev
  recursion, the (N, N) APSP input and its squarings (K2, K6), the
  next-hop cost volume.
- ``accum_dtype``   the feature matmuls' and the sparse propagate's
  accumulation (K4), and the dtype every fp32 island promotes to.
- ``storage_dtype`` Instance / JobSet float fields as they are built on the
  host and cross to the card (`torch.bfloat16` under bf16: numpy has no
  bf16, so host storage is torch CPU tensors, narrowed by `.to`, which
  rounds to nearest even as `ml_dtypes` does).

The fp32 ISLANDS (`FP32_ISLANDS`) are the steps whose conditioning cannot
survive an 8-bit mantissa: the interference fixed point (K1 always takes
fp32), the delay reductions, the offload cost table read back from the
bf16 shortest paths, and the Chebyshev support's Laplacian constants.
Each island site upcasts its operands to `island_dtype(...)`; torch
promotes ``bf16 x f32 -> f32`` as JAX does, so everything downstream of an
island stays wide.

Resolution (`cfg.precision` x `cfg.dtype`, `base` = `cfg.torch_dtype`):

==========  ===========  ============  ===========  ============
precision   param        compute       accum        storage
==========  ===========  ============  ===========  ============
fp32        base         base          base         base
bf16        >=fp32 base  bfloat16      >=fp32 base  bfloat16
auto        bf16 when the policy's device is CUDA, fp32 on the CPU
==========  ===========  ============  ===========  ============

The card plays the TPU's part in the JAX rule ("bf16 on a TPU backend,
fp32 elsewhere").  The shipped default stays fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

PRECISION_CHOICES = ("fp32", "bf16", "auto")

FP32_ISLANDS = (
    "fixed_point",      # interference fixed point: 1 - lambda/mu denominators
    "delay_reduction",  # tau / per-job delay totals and their reductions
    "decision_costs",   # offload cost table read back from the bf16 SP matrix
    "laplacian",        # chebyshev_support degree/rescale constants
)


def island_dtype(*dtypes) -> torch.dtype:
    """The smallest dtype >= float32 covering every operand dtype: fp32 for
    bf16/fp32 operands, fp64 where one is fp64 (the parity paths)."""
    dt = torch.float32
    for d in dtypes:
        dt = torch.promote_types(dt, d)
    return dt


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Resolved dtype assignment for one run (frozen, resolved once at build
    time and closed over, never a tensor argument)."""

    name: str            # resolved leg: "fp32" (identity) | "bf16" (mixed)
    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    accum_dtype: torch.dtype
    storage_dtype: torch.dtype

    @property
    def mixed(self) -> bool:
        """True when compute is narrower than accumulation (the bf16 leg)."""
        return self.compute_dtype != self.accum_dtype

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        """Narrow a tensor to the compute dtype (identity under fp32)."""
        return x.to(self.compute_dtype) if self.mixed else x

    def wrap_apsp(self, apsp_fn: Optional[Callable] = None) -> Optional[Callable]:
        """Wrap an APSP callable of the weight matrix so that it squares in
        the compute dtype: under the mixed policy W is narrowed before the
        squarings (K2 in bf16 on the card) and the shortest paths come back
        bf16, re-accumulated wide at the `decision_costs` island.  Under the
        identity policy `apsp_fn` is returned as it is (None stays None).
        `apsp_fn` is a route of `ops.minplus.resolve_apsp`; None is
        `apsp_minplus`, the squarings at every N, as JAX's None."""
        if not self.mixed:
            return apsp_fn
        compute = self.compute_dtype

        def narrow_apsp(w, _base=apsp_fn):
            if _base is None:
                from multihop_offload_tpu_torch.env.apsp import apsp_minplus

                _base = apsp_minplus
            return _base(w.to(compute))

        return narrow_apsp


def _default_is_cuda(device) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def resolve_precision(precision="fp32", base_dtype=None, device=None) -> PrecisionPolicy:
    """Resolve (`cfg.precision`, `cfg.torch_dtype`) into a policy.

    `precision` may be a resolved `PrecisionPolicy` (returned as it is) or
    None (fp32).  `auto` takes bf16 when `device` is CUDA (None: the
    default device, CUDA where the process sees a card) and fp32 otherwise."""
    if isinstance(precision, PrecisionPolicy):
        return precision
    precision = precision or "fp32"
    if precision not in PRECISION_CHOICES:
        raise ValueError(f"unsupported precision '{precision}'; "
                         f"choose one of {sorted(PRECISION_CHOICES)}")
    if precision == "auto":
        precision = "bf16" if _default_is_cuda(device) else "fp32"
    base = torch.float32 if base_dtype is None else base_dtype
    if precision == "fp32":
        return PrecisionPolicy(name="fp32", param_dtype=base, compute_dtype=base,
                               accum_dtype=base, storage_dtype=base)
    wide = torch.promote_types(base, torch.float32)
    return PrecisionPolicy(name="bf16", param_dtype=wide, compute_dtype=torch.bfloat16,
                           accum_dtype=wide, storage_dtype=torch.bfloat16)
