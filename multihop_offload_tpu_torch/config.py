"""The configuration fields the decision path reads.

A copy of the matching fields of `multihop_offload_tpu.config.Config`, with
the same names and defaults; the port keeps its own so that it never imports
the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    T: int = 1000                  # congestion-penalty scale t_max
    num_layer: int = 5             # ChebConv layers in the actor
    hidden: int = 32               # hidden width of the actor
    cheb_k: int = 1                # Chebyshev order (1 = shipped checkpoints)
    leaky_relu_alpha: float = 0.2  # negative slope of the hidden activations
    ul_data: float = 100.0         # per-task uplink data size
    dl_data: float = 1.0           # per-task downlink data size
    arrival_scale: float = 0.1     # job arrival-rate scale
