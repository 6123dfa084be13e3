"""The configuration fields the port's paths read.

A copy of the matching fields of `multihop_offload_tpu.config.Config`, with
the same names and defaults; the port keeps its own so that it never imports
the JAX package.  `serve_model` and `sim_model` are the port's own: the
JAX service and simulator load their latest orbax checkpoint (or a fresh
init), the port a committed model by name where it has no checkpoint.

`apsp_impl`, `fp_impl`, `mesh_data`, `mesh_graph` and `csv_write_all_hosts`
keep the JAX names and defaults.  `apsp_impl` takes JAX's values
(`ops/minplus.py:resolve_apsp`): `xla`, the default, squares at every N;
`pallas` and `auto` take the blocked Floyd-Warshall above a padded N of
256; anything else raises the JAX message.  Whichever route, the device
picks the code: the kernel for CUDA tensors, its plain version for CPU
tensors.  `fp_impl` takes JAX's values, xla | pallas | auto
(`ops/fixed_point.py:resolve_fixed_point`; anything else raises JAX's
message): `pallas` is K1, `xla` the layout's own fixed point (the
segment-sum on the sparse layout), `auto` K1 up to L = 928.  `mesh_data` shards the
drivers' episodes (Trainer) or files (Evaluator) over that many of their
devices (`train/driver.py`, `parallel/`), and `mesh_graph > 1` is refused
by the drivers, as in JAX.  The `loop_*` settings of the
continual-learning loop (`cli/loop.py`, `loop/`) keep JAX's names,
defaults and help; `loop_capture_sample` also sets the service's capture
(`cli/serve.py`).  The `rl_*` settings of the closed-loop RL trainer
(`cli/rl.py`, `rl/`) keep JAX's names and defaults, except that `rl_out`
"" writes no record in any mode (JAX's smoke default is a file of the JAX
package's benchmark folder).  The `scenario_*` settings (`cli/scenarios.py`,
`scenarios/`) and `health_short_s` / `health_long_s` keep JAX's names and
defaults; `scenario_out`, `health_out`, `chaos_out` and `prof_out` (for
`--smoke`) "" write no record (JAX's defaults are files of its benchmark
folder).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional

from multihop_offload_tpu_torch.precision import (
    PRECISION_CHOICES,
    PrecisionPolicy,
    resolve_precision,
)


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
    dropout: float = 0.0           # the Trainer's dropout rate before every layer
    prefetch: bool = True          # build file fid+1 on the host while the
    #                                card runs fid
    file_batch: int = 1            # files per Evaluator call (stacked)
    pad_buckets: int = 1           # size buckets per dataset
    pad_nodes: Optional[int] = None    # None = derive from data
    pad_links: Optional[int] = None
    pad_servers: Optional[int] = None
    pad_jobs: Optional[int] = None
    mesh_data: int = 0             # data-parallel mesh axis size: 0 = every
    #                                device of the drivers (all local CUDA
    #                                devices; the one CPU device on the CPU),
    #                                1 = one device, N = explicit axis size
    mesh_graph: int = 1            # graph-partition (ring APSP) axis size
    #                                (the drivers refuse > 1, as in JAX)
    csv_write_all_hosts: bool = False  # multi-process runs: every process
    #                                writes its own (shard) CSV instead of
    #                                gating on process index 0
    compat_diagonal_bug: bool = False  # reproduce the reference's cycled
    #                                decision-path diagonal (A/B validation)
    apsp_impl: str = "xla"         # APSP route: xla (the squarings at every N)
    #                                | pallas | auto (the blocked FW above a
    #                                padded 256); ops.minplus.resolve_apsp
    fp_impl: str = "auto"          # fixed-point core: xla | pallas | auto
    tb_logdir: str = ""            # TensorBoard scalars' directory ("" none)
    obs_log: str = ""              # JSONL run log of the drivers and the
    #                                service ("" = off)
    obs_prom: str = ""             # write the final metric-registry snapshot
    #                                as Prometheus text exposition to this
    #                                path at loop exit ("" = disabled)
    obs_log_max_bytes: int = 0     # size-cap per JSONL segment: when the
    #                                active run log would grow past this, it
    #                                is rotated to `<path>.NNNN` and a fresh
    #                                segment opened (0 = never rotate);
    #                                `obs.events.read_events` spans segments
    io_retries: int = 3            # bounded-retry attempts around fallible
    #                                I/O (checkpoint save/restore, event-log
    #                                writes, journal writes)
    io_backoff_s: float = 0.05     # initial retry backoff (doubles per
    #                                attempt)
    chaos_out: str = ""            # write the chaos-smoke record here
    #                                ("" = none)
    # ---- performance observability (obs/prof, mho-prof) ---------------------
    prof_seconds: float = 1.0      # mho-prof capture: seconds of bench-step
    #                                work to run under the profiler trace
    prof_out: str = ""             # mho-prof: capture trace dir (default
    #                                prof_trace/) or smoke record path
    #                                ("" = no record)
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
    precision: str = "fp32"        # precision policy: fp32 | bf16 | auto
    #                                (precision.py; auto = bf16 on the card)
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
    serve_mesh: int = 0            # sharded serving: lay each bucket's batch
    #                                over N devices (cli/serve.py)
    serve_devices: str = ""        # explicit CUDA ids "0,2,5" for the
    #                                serving fleet (overrides serve_mesh)
    serve_replan_ticks: int = 16   # placement re-plan cadence (ticks)
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
    health_short_s: float = 60.0   # SLO burn-rate short window (seconds)
    health_long_s: float = 300.0   # SLO burn-rate long window (seconds)
    health_out: str = ""           # write the health-smoke record here
    #                                ("" = none)
    health_watchdog_s: float = 0.0  # a bucket dispatch slower than this is
    #                                 slow, 10x slower stuck (0 = off)
    health_watchdog_recovery_s: float = 0.0  # how long a stuck bucket stays
    #                                          on the baseline
    # ---- simulation (sim/, cli/sim.py) --------------------------------------
    sim_policy: str = "baseline"   # offloading policy in the loop: baseline |
    #                                local | gnn
    sim_model: str = "SCRATCH800_decay0.99"  # the gnn policy's committed model
    #                                when the model directory holds no torch/
    #                                checkpoint ("" = seeded fresh init)
    sim_fleet: int = 8             # instances simulated as one batch
    sim_nodes: int = 10            # nodes per random BA scenario graph
    sim_jobs: int = 4              # jobs per instance
    sim_rounds: int = 5            # policy re-decisions per run
    sim_slots: int = 1000          # slots per policy round
    sim_util: float = 0.5          # analytic bottleneck-utilization target the
    #                                workload is rescaled to before simulating
    sim_margin: float = 5.0        # slot sizing: dt = 1/(margin * max link rate)
    sim_cap: int = 128             # ring-buffer capacity per queue (overflow
    #                                packets are dropped and counted)
    sim_fail_links: int = 0        # random links to fail at mid-horizon
    sim_fail_nodes: int = 0        # random non-server nodes to fail likewise
    sim_out: str = ""              # write the run / fidelity JSON record here
    # ---- scenario matrix (scenarios/, cli/scenarios.py) ---------------------
    scenario_fleet: int = 4        # lanes (seeded draws) per scenario preset
    scenario_segments: int = 4     # sim segments per scenario: the traffic
    #                                profile, failure and mobility schedules
    #                                act at segment boundaries
    scenario_rounds: int = 2       # policy re-decisions per segment
    scenario_slots: int = 300      # slots per policy round
    scenario_cap: int = 64         # per-queue ring-buffer capacity
    scenario_margin: float = 5.0   # slot sizing, as sim_margin
    scenario_names: str = ""       # comma list restricting the matrix to
    #                                these presets ("" = all)
    scenario_out: str = ""         # write the matrix record here ("" = none)
    # ---- closed-loop RL (rl/ subsystem; cli.rl) -----------------------------
    rl_steps: int = 30             # train steps per `cli.rl` run
    rl_fleet: int = 4              # episodes (instances) per train step -- the
    #                                batched (or sharded) lane axis
    rl_rounds: int = 3             # policy re-decisions per episode (scenario
    #                                shape comes from the sim_* knobs)
    rl_slots: int = 120            # sim slots per policy round
    rl_temp: float = 0.5           # categorical temperature over the offload
    #                                cost table (higher = more exploration)
    rl_delay_weight: float = 0.05  # reward = delivered_ratio - weight *
    #                                mean delivered delay (model-time units)
    rl_ent: float = 0.05           # entropy-bonus weight in the surrogate
    #                                loss (guards against premature
    #                                deterministic collapse of REINFORCE)
    rl_buffer: int = 64            # on-device reward ring capacity backing
    #                                the REINFORCE running-mean baseline
    rl_util: float = 0.7           # analytic bottleneck-utilization target
    #                                (rho) the RL scenarios are rescaled to
    rl_lr: float = 2e-3            # Adam learning rate of the RL update (the
    #                                offline `learning_rate` is tuned for file
    #                                visits, not episodes)
    rl_mesh: int = 1               # fleet mesh axis size: 1 = one device, N =
    #                                the fleet sharded over N devices (the
    #                                gradient is the mean of the shard means)
    rl_out: str = ""               # write the smoke/train JSON record here
    #                                ("" = print only, in every mode)
    # ---- continual learning (loop/ subsystem; cli.loop) --------------------
    loop_capture_sample: float = 0.0   # fraction of served requests emitted
    #                                as `outcome` experience events through
    #                                the active run log (0 = capture off);
    #                                sampling is deterministic by request id
    loop_capture_requests: int = 48    # requests per capture window (cli.loop
    #                                drives its own synthetic traffic)
    loop_refit_steps: int = 20     # fine-tuning steps per background re-fit
    loop_refit_slots: int = 4      # experience outcomes batched per refit step
    loop_holdout_frac: float = 0.25    # outcome fraction held out of the
    #                                refit and replayed in sim for the A/B
    loop_gate_delivered_drop: float = 0.02  # promotion gate: candidate sim
    #                                delivered ratio may trail the champion
    #                                by at most this (absolute)
    loop_gate_tau_ratio: float = 1.10  # promotion gate: candidate mean sim
    #                                packet delay at most champion * this
    loop_monitor_regression: float = 1.5   # post-promotion watchdog: measured
    #                                tau beyond pre-promotion * this triggers
    #                                automatic rollback
    loop_cycles: int = 1           # flywheel cycles for `mho-loop run`
    loop_sim_rounds: int = 2       # A/B validation sim: policy rounds
    loop_sim_slots: int = 200      # A/B validation sim: slots per round
    loop_out: str = ""             # write the cycle/smoke JSON record here
    loop_drift: bool = False       # gate flywheel capture on obs.drift: a
    #                                cycle only enters `capturing` when a
    #                                detector trips on the outcome stream
    #                                (`drift_triggered` transitions)
    loop_candidate_keep: int = 2   # bounded retention in torch_candidate/:
    #                                after a reject/rollback keep only the
    #                                newest K candidate checkpoints, delete
    #                                older ones with a typed `gc` event
    loop_cooldown_s: float = 0.0   # post-rollback cool-down: no new flywheel
    #                                cycle starts until this many seconds
    #                                after the rollback (journaled, so it
    #                                survives a process restart; 0 = off)

    def __post_init__(self):
        from multihop_offload_tpu_torch.ops.fixed_point import resolve_fixed_point
        from multihop_offload_tpu_torch.ops.minplus import check_apsp_impl

        check_apsp_impl(self.apsp_impl)
        resolve_fixed_point(self.fp_impl, 1)  # raises JAX's message for another value
        if self.sim_policy not in ("gnn", "baseline", "local"):
            raise ValueError(f"sim_policy must be one of gnn, baseline, local; "
                             f"got '{self.sim_policy}'")
        if self.precision not in PRECISION_CHOICES:
            raise ValueError(f"precision must be one of {PRECISION_CHOICES}; "
                             f"got '{self.precision}'")

    @property
    def torch_dtype(self):
        import torch

        table = {"float32": torch.float32, "float64": torch.float64,
                 "bfloat16": torch.bfloat16}
        if self.dtype not in table:
            raise ValueError(f"unsupported dtype '{self.dtype}'; choose one of "
                             f"{sorted(table)}")
        return table[self.dtype]

    def precision_policy(self, device) -> PrecisionPolicy:
        """The resolved `PrecisionPolicy` of (precision, dtype) for an entry
        point running on `device` (`auto`: bf16 on CUDA, fp32 on the CPU).
        Every entry point that takes a Config resolves its policy here."""
        return resolve_precision(self.precision, self.torch_dtype, device)

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
