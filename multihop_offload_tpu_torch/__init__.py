"""PyTorch/CUDA port of `multihop_offload_tpu`.

The offloading decision path (instance building, the ChebNet actor, the
interference fixed point, min-plus APSP, the greedy offload decision, route
tracing and the empirical M/M/1 evaluator) written for an NVIDIA H100.  Every
function takes the leading batch axis B that `stack_instances` gives, so one
kernel launch covers the batch.  The two Pallas kernels of the path are
hand-written CUDA C++ under `csrc/` (see `ops/`).

This package imports torch, numpy and scipy only: never jax, flax,
networkx, orbax or `multihop_offload_tpu`.
"""

from multihop_offload_tpu_torch._device import resolve_device  # noqa: F401
