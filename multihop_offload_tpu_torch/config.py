"""The configuration fields the port's paths read.

A copy of the matching fields of `multihop_offload_tpu.config.Config`, with
the same names and defaults; the port keeps its own so that it never imports
the JAX package.  `serve_model` is the port's own: the JAX service loads
its latest orbax checkpoint, the port a committed model by name.

`apsp_impl`, `fp_impl` and `csv_write_all_hosts` keep the JAX names, and
a Config takes only the value the port runs: `auto` for both routes (the
device picks: the kernel for CUDA tensors, its plain version for CPU
tensors, as `ops/minplus.py:apsp_path` and
`ops/fixed_point.py:fixed_point_path` say) and False for the per-process
CSVs (the port is one process).  Any other value raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class Config:
    # ---- the drivers (train/driver.py, cli/train.py, cli/test.py) ----------
    datapath: str = "data/aco_data_ba_100"
    out: str = "out"               # CSV directory
    training_set: str = "BAm2"     # checkpoint directory tag
    epochs: int = 201
    num_instances: int = 10        # job-placement instances per network
    files_limit: Optional[int] = None  # cap network files visited per epoch
    best_window: int = 20          # rolling window (file visits) of GNN-test
    #                                tau for best-checkpoint tracking; 0 = off
    explore_decay: float = 0.99
    dropout: float = 0.0           # refused above 0 (not ported)
    prefetch: bool = True          # build file fid+1 on the host while the
    #                                card runs fid
    file_batch: int = 1            # files per Evaluator call (stacked)
    pad_buckets: int = 1           # size buckets per dataset
    pad_nodes: Optional[int] = None    # None = derive from data
    pad_links: Optional[int] = None
    pad_servers: Optional[int] = None
    pad_jobs: Optional[int] = None
    mesh_data: int = 0             # data-parallel axis (refused above 1)
    csv_write_all_hosts: bool = False  # every process writes its shard CSV
    #                                (multi-process runs; only False)
    compat_diagonal_bug: bool = False  # reproduce the reference's cycled
    #                                decision-path diagonal (A/B validation)
    apsp_impl: str = "auto"        # APSP route; only auto: the device picks
    fp_impl: str = "auto"          # fixed-point route; only auto, as apsp_impl
    tb_logdir: str = ""            # refused when set (no TensorBoard)
    obs_log: str = ""              # JSONL run log of the drivers ("" = off)
    # ---- model, workload, training ------------------------------------------
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
    model_root: str = "model"      # parent of checkpoint directories; where a
    #                                stuck-tick flight record is dumped
    obs_trace: bool = True         # request-scoped trace hops in the run log
    obs_flight_capacity: int = 256  # flight-recorder ring size (ticks)
    health_watchdog_s: float = 0.0  # a bucket dispatch slower than this is
    #                                 slow, 10x slower stuck (0 = off)
    health_watchdog_recovery_s: float = 0.0  # how long a stuck bucket stays
    #                                          on the baseline

    def __post_init__(self):
        for name in ("apsp_impl", "fp_impl"):
            if getattr(self, name) != "auto":
                raise NotImplementedError(
                    f"{name}='{getattr(self, name)}': the port picks the route by "
                    "device (the CUDA kernel on the card, its plain version on the "
                    "CPU); only 'auto' is accepted")
        if self.csv_write_all_hosts:
            raise NotImplementedError(
                "csv_write_all_hosts: per-process shard CSVs wait on `parallel/` "
                "(ROADMAP.md Queue 1 item 7); the port is one process")

    @property
    def torch_dtype(self):
        import torch

        table = {"float32": torch.float32, "float64": torch.float64}
        if self.dtype not in table:
            raise ValueError(f"unsupported dtype '{self.dtype}'; choose one of "
                             f"{sorted(table)} (bfloat16 waits for precision.py)")
        return table[self.dtype]

    def model_dir(self, root: Optional[str] = None) -> str:
        """Checkpoint directory; naming mirrors `AdHoc_train.py:59`."""
        return os.path.join(
            root if root is not None else self.model_root,
            f"model_ChebConv_{self.training_set}_a{self.num_layer}_c{self.num_layer}_ACO_agent",
        )


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
        elif d is None:
            p.add_argument(f"--{f.name}", type=int, default=None)
        else:
            p.add_argument(f"--{f.name}", type=type(d), default=d)
    return p


def from_cli(argv=None, description: str = "") -> tuple:
    """(Config, device) from an entry point's command line: every Config
    field plus `--device` (cuda, the default, or cpu)."""
    p = build_parser(description=description)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    ns = vars(p.parse_args(argv))
    device = ns.pop("device")
    return Config(**ns), device
