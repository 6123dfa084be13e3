"""The configuration fields the port's paths read.

A copy of the matching fields of `multihop_offload_tpu.config.Config`, with
the same names and defaults; the port keeps its own so that it never imports
the JAX package.  `serve_model` is the port's own: the JAX service loads
its latest orbax checkpoint, the port a committed model by name.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional


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
    dtype: str = "float32"         # computation dtype ("float64" for parity)
    precision: str = "fp32"        # precision policy (only fp32 is ported)
    round_to: int = 8              # pad sizes up to a multiple of this
    seed: int = 0                  # workload RNG and fresh-init weights
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
    # ---- serving (serve/, cli/serve.py) ------------------------------------
    serve_slots: int = 8           # requests batched per bucket per tick
    serve_queue_cap: int = 64      # bounded admission queue (backpressure)
    serve_deadline_s: float = 0.5  # a tick whose oldest pending request is
    #                                older serves that batch with the baseline
    serve_buckets: int = 2         # shape buckets in the serving ladder
    serve_sizes: str = "16,24"     # node sizes of the demo traffic pool
    serve_requests: int = 64       # demo request count
    serve_mesh: int = 0            # sharded serving over N devices (not ported)
    serve_devices: str = ""        # explicit serving fleet (not ported)
    serve_ragged: bool = False     # occupancy ladder: cold buckets tick narrower
    serve_overlap: bool = False    # settle each tick's dispatches on the next
    serve_ladder_alpha: float = 0.5       # EWMA weight of the occupancy ladder
    serve_ladder_hysteresis: float = 0.25  # narrow only when EWMA*(1+h) fits
    serve_model: str = ""          # committed model to serve by name
    #                                ("" = seeded fresh init)
    model_root: str = "model"      # where a stuck-tick flight record is dumped
    obs_trace: bool = True         # request-scoped trace hops in the run log
    obs_flight_capacity: int = 256  # flight-recorder ring size (ticks)
    health_watchdog_s: float = 0.0  # a bucket dispatch slower than this is
    #                                 slow, 10x slower stuck (0 = off)
    health_watchdog_recovery_s: float = 0.0  # how long a stuck bucket stays
    #                                          on the baseline

    @property
    def torch_dtype(self):
        import torch

        table = {"float32": torch.float32, "float64": torch.float64}
        if self.dtype not in table:
            raise ValueError(f"unsupported dtype '{self.dtype}'; choose one of "
                             f"{sorted(table)} (bfloat16 waits for precision.py)")
        return table[self.dtype]


def build_parser(defaults: Optional[Config] = None,
                 description: str = "") -> argparse.ArgumentParser:
    """`--<field>` for every Config field, as the JAX package's parser."""
    cfg = defaults or Config()
    p = argparse.ArgumentParser(description=description)
    for f in dataclasses.fields(Config):
        d = getattr(cfg, f.name)
        if isinstance(d, bool):
            p.add_argument(f"--{f.name}", default=d,
                           type=lambda s: s.lower() in ("1", "true", "yes"))
        else:
            p.add_argument(f"--{f.name}", type=type(d), default=d)
    return p
