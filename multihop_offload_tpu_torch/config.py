"""The configuration fields the decision path and the training step read.

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
    layout: str = "dense"          # instance layout: dense | sparse | auto
    learning_rate: float = 1e-4
    learning_decay: float = 1.0    # exponential LR decay rate (1.0 = constant)
    clipnorm: float = 1.0          # per-leaf gradient norm clip (Keras clipnorm)
    max_norm: float = 1.0          # max-norm constraint after every update
    batch: int = 100               # replay minibatch (number of stored grads)
    memory_size: int = 5000        # gradient-replay capacity
    mse_weight: float = 0.001      # MSE pull toward the empirical delays
    critic_weight: float = 1.0     # scale of the analytic-critic term
    explore: float = 0.1           # epsilon-greedy exploration of the decision
    prob: bool = False             # softmax-sample the offloading decision
