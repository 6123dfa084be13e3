"""The closed-loop RL trainer: rollout and update in one step.

Port of `multihop_offload_tpu/rl/trainer.py`.  One `RLTrainer` step:

    [the fleet split over the mesh's data devices]
      per-lane parameter copies -> rollout of every lane   # rl/rollout.py
        rounds: sample offloads (actor, APSP, cost table on the tape)
                slots of the simulator (sim/step.py)
      one backward of the lanes' summed losses -> per-lane gradients
      mean over the shard's lanes -> mean of the shard means
    non-finite skip-and-count -> Adam + max-norm -> buffer push

JAX compiles the step into one program; here it runs eagerly, with the
kernels of its path on the card (K1, K2 and K2's backward, K4 forward and
transposed under the sparse layout).  Per-lane gradients come from
per-episode parameter copies (leaves (B, *shape)), as `agent.train_step`
takes them, so one backward gives each lane its own gradient, as
`jax.vmap(jax.value_and_grad(...))` does.  The optimizer is the one of
record (`agent.replay.make_optimizer` at `rl_lr`: Keras clipnorm per
leaf, Adam, then the max-norm constraint).  A step whose mean gradient is
not finite leaves the parameters and the Adam moments untouched and is
counted (`mho_refit_skipped_updates_total{phase=rl}`); the finiteness is
read on the host, the step's one sync besides the flushes.

Telemetry: the simulator's devmetrics window of the step is flushed with
`phase="rl"`, and an RL window (episodes, reward moments, the per-episode
gradient-norm decade histogram, the non-finite sentinel, skipped updates)
likewise, with the `mho_rl_*` registry counters.  JAX registers the step
with `obs.prof` (`rl/train_step`); `obs/prof` is not ported yet (ROADMAP.md
Queue 1 item 9), and the step is a `rl/train_step` span instead.

`mesh` (a `parallel.make_mesh` mesh) splits the fleet in equal blocks over
its data devices, with a replica of the model on each; the gradient is the
mean of the shard means, gathered on the first device, where the update
runs (JAX: `shard_map` and `pmean`).  Each lane keeps its own draws
wherever it runs (`LaneDraws` seeded per lane), so a sharded step rolls
out the lanes of the unsharded one.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional

import torch

from multihop_offload_tpu_torch._records import cat_records, slice_records
from multihop_offload_tpu_torch.agent.replay import apply_max_norm_constraint, make_optimizer
from multihop_offload_tpu_torch.agent.train_step import episode_grad_norms
from multihop_offload_tpu_torch.obs.devmetrics import DevMetrics
from multihop_offload_tpu_torch.obs.registry import registry
from multihop_offload_tpu_torch.obs.spans import span
from multihop_offload_tpu_torch.parallel.collectives import copy_to, device_key, mean_to
from multihop_offload_tpu_torch.rl.buffer import buffer_baseline, buffer_init, buffer_push
from multihop_offload_tpu_torch.rl.rollout import RoundDeltas, rollout
from multihop_offload_tpu_torch.sim.runner import InjectedDraws, LaneDraws
from multihop_offload_tpu_torch.sim.state import SimRoutes, SimSpec, SimState, init_state
from multihop_offload_tpu_torch.sim.step import sim_devmetrics

# ---- device metrics of the RL step ------------------------------------------
# One window per train step.  The skipped-updates counter reuses the refit
# series name with a phase label, so one dashboard tracks non-finite
# containment across the offline, refit and rl trainers.

DM_RL_EPISODES = "mho_dev_rl_episodes_total"
DM_RL_ROUNDS = "mho_dev_rl_rounds_total"
DM_RL_REWARD_SUM = "mho_dev_rl_reward_sum"
DM_RL_REWARD_SQ = "mho_dev_rl_reward_sq_sum"
DM_RL_GRAD_NORM = "mho_dev_rl_grad_norm"
DM_RL_NONFINITE = "mho_dev_rl_nonfinite_total"
DM_RL_SKIPPED = "mho_refit_skipped_updates_total{phase=rl}"


def rl_devmetrics() -> DevMetrics:
    """Declare the RL train step's device metrics (frozen)."""
    dm = DevMetrics()
    dm.counter(DM_RL_EPISODES, "rollout episodes accumulated on device")
    dm.counter(DM_RL_ROUNDS, "policy rounds executed inside rollouts")
    # reward moments accumulate wide by design
    dm.counter(DM_RL_REWARD_SUM, "reward first moment accumulator", dtype=torch.float32)
    dm.counter(DM_RL_REWARD_SQ, "reward second moment accumulator", dtype=torch.float32)
    dm.histogram(DM_RL_GRAD_NORM, tuple(10.0 ** e for e in range(-6, 4)),
                 "per-episode global gradient norm (decade buckets)")
    dm.counter(DM_RL_NONFINITE,
               "train steps with non-finite mean gradients, counted in-program")
    dm.counter("mho_refit_skipped_updates_total",
               "optimizer updates skipped on non-finite grads", phase="rl")
    return dm.freeze()


@dataclasses.dataclass
class RLStepOut:
    """The result of one train step (tensors on the trainer's device)."""

    loss: torch.Tensor        # () mean surrogate loss over the fleet
    rewards: torch.Tensor     # (F, R) per-lane per-round rewards
    logps: torch.Tensor       # (F, R) per-lane per-round action log-probs
    deltas: RoundDeltas       # (F, R) counter deltas
    dsts: torch.Tensor        # (F, R, J) sampled destinations
    routes: SimRoutes         # (F, R, ...) routes in force
    state: SimState           # (F, ...) terminal sim states
    grad_norms: torch.Tensor  # (F,) per-episode global gradient norms
    skipped: int              # 1 when the update was skipped
    dev_sim: Any = None       # sim devmetrics window of the step (per lane)
    dev_rl: Any = None        # RL devmetrics window of the step
    losses: Any = None        # (F,) per-lane surrogate losses (the port's)
    grads: Any = None         # name -> (F, *shape) per-lane gradients (the port's)


def _cat_tree(trees: list, device):
    """Concatenate nested dicts of per-lane tensors along their lane axis
    on `device`."""
    if isinstance(trees[0], dict):
        return {k: _cat_tree([t[k] for t in trees], device) for k in trees[0]}
    return torch.cat([copy_to(t, device) for t in trees])


def shard_draws(draws, lo: int, hi: int, spec: SimSpec, dtype, device):
    """Lanes [lo, hi) of a step's draws on `device`: `LaneDraws` of their
    seeds for a sequence of per-lane seeds, the slice of an
    `InjectedDraws`, or a draw source as it is for the whole fleet."""
    if isinstance(draws, InjectedDraws):
        return InjectedDraws(*[copy_to(x[lo:hi], device) for x in draws.draws])
    if hasattr(draws, "round"):
        return draws
    return LaneDraws(list(draws)[lo:hi], spec, dtype, device)


class RLTrainer:
    """Driver of the closed-loop train step.

    The spec, horizon, temperature and mesh are fixed at construction;
    `train_step` only feeds tensors.  `model` (a `ChebNet` built for
    `cfg.layout`) gives the structure and the initial parameters, which
    the trainer keeps in `params` (name -> tensor) with the Adam state
    `opt_state`; the model itself is not written."""

    def __init__(self, cfg, model, spec: SimSpec, mesh=None, devmetrics: bool = True,
                 sim_dtype=torch.float32):
        self.device = next(model.parameters()).device
        cfg.check_rl(self.device)
        self.cfg = cfg
        self.model = model
        self.spec = spec
        self.mesh = mesh
        self.rounds = int(cfg.rl_rounds)
        self.slots_per_round = int(cfg.rl_slots)
        self.sim_dtype = sim_dtype
        self.params = {k: p.detach().clone() for k, p in model.named_parameters()}
        self.optimizer = make_optimizer(dataclasses.replace(cfg, learning_rate=cfg.rl_lr))
        self.opt_state = self.optimizer.init(self.params)
        self.buf = buffer_init(int(cfg.rl_buffer), device=self.device)
        self.dm_sim = sim_devmetrics(spec) if devmetrics else None
        self.dm_rl = rl_devmetrics() if devmetrics else None
        self.sim_totals: dict = {}
        self.last_rl_metrics: Optional[dict] = None
        self.steps = 0
        self.devices = mesh.data_devices() if mesh is not None else [self.device]
        # a model replica per distinct device (the home device keeps `model`)
        self._replicas = {device_key(self.device): model}
        for d in self.devices:
            if device_key(d) not in self._replicas:
                self._replicas[device_key(d)] = copy.deepcopy(model).to(d)

    # ---- host-side driving ------------------------------------------------

    def init_states(self, fleet: int, device=None) -> SimState:
        return init_state(self.spec, fleet, self.sim_dtype,
                          self.device if device is None else device)

    def _lanes(self, device, lo, hi, baseline, insts, jobss, paramss, states, init_rates,
               draws, gumbel):
        """Rollouts of lanes [lo, hi) on `device` and their per-lane
        gradients: (grads name -> (b, *shape), losses (b,), RolloutOut)."""
        cfg = self.cfg
        model = self._replicas[device_key(device)]
        b = hi - lo
        params = {k: copy_to(v, device).unsqueeze(0).expand((b,) + v.shape).clone()
                  .requires_grad_() for k, v in self.params.items()}

        def part(x):
            return slice_records(x, lo, hi).to(device)

        with torch.enable_grad():
            losses, out = rollout(
                model, params, part(insts), part(jobss), self.spec, part(paramss),
                part(states), copy_to(init_rates[lo:hi], device),
                shard_draws(draws, lo, hi, self.spec, self.sim_dtype, device),
                copy_to(baseline, device), self.rounds, self.slots_per_round,
                float(cfg.rl_temp), float(cfg.rl_delay_weight), float(cfg.rl_ent),
                dm=self.dm_sim, layout=cfg.layout,
                gumbel=None if gumbel is None else copy_to(gumbel[lo:hi], device))
            grads = torch.autograd.grad(losses.sum(), list(params.values()))
        return dict(zip(params, grads)), losses.detach(), out

    def train_step(self, insts, jobss, paramss, draws, states: Optional[SimState] = None,
                   init_rates: Optional[torch.Tensor] = None,
                   gumbel: Optional[torch.Tensor] = None) -> RLStepOut:
        """One rollout-and-update step of the whole (stacked) fleet, on the
        trainer's device.  `draws`: one seed per lane (`LaneDraws` on each
        shard's device, the decision noise from the same generators) or an
        `InjectedDraws` with `gumbel` (F, R, J, S+1) beside it.  `states`
        (default: empty queues) and `init_rates` (default: zeros) start
        every lane."""
        home = self.device
        fleet = insts.adj.shape[0]
        if states is None:
            states = self.init_states(fleet, insts.adj.device)
        if init_rates is None:
            init_rates = torch.zeros((fleet, self.spec.num_jobs), dtype=self.sim_dtype,
                                     device=insts.adj.device)
        shards = len(self.devices)
        if fleet % shards:
            raise ValueError(f"fleet {fleet} does not split over {shards} devices")
        per = fleet // shards
        with span("rl/train_step", block=True, fleet=fleet):
            baseline = buffer_baseline(self.buf)
            results = [self._lanes(d, i * per, (i + 1) * per, baseline, insts, jobss,
                                   paramss, states, init_rates, draws, gumbel)
                       for i, d in enumerate(self.devices)]
            norms = torch.cat([copy_to(episode_grad_norms(g), home) for g, _, _ in results])
            lane_grads = {k: torch.cat([copy_to(r[0][k], home) for r in results])
                          for k in self.params}
            g = {k: mean_to([r[0][k].mean(0) for r in results], home) for k in self.params}
            losses = torch.cat([copy_to(r[1], home) for r in results])
            outs = [r[2].to(home) for r in results]
            out = outs[0] if shards == 1 else dataclasses.replace(
                cat_records(outs), dev=None if self.dm_sim is None
                else _cat_tree([o.dev for o in outs], home))
            # non-finite containment (`agent.replay.replay_apply`'s contract):
            # a poisoned rollout must not corrupt the Adam state
            finite = torch.stack([torch.isfinite(v).all() for v in g.values()]).all()
            ok = bool(finite)
            if ok:
                safe = {k: torch.where(torch.isfinite(v), v, 0.0) for k, v in g.items()}
                params, self.opt_state = self.optimizer.update(safe, self.opt_state,
                                                               self.params)
                self.params = apply_max_norm_constraint(params, float(self.cfg.max_norm))
            skipped = 0 if ok else 1
            # reward statistics in float32
            self.buf = buffer_push(self.buf, out.rewards.to(torch.float32).mean(0))
            dev_rl = None
            if self.dm_rl is not None:
                dm = self.dm_rl
                d = dm.init(device=home)
                d = dm.inc(d, DM_RL_EPISODES, fleet)
                d = dm.inc(d, DM_RL_ROUNDS, fleet * self.rounds)
                d = dm.inc(d, DM_RL_REWARD_SUM, out.rewards)
                d = dm.inc(d, DM_RL_REWARD_SQ, out.rewards * out.rewards)
                d = dm.observe(d, DM_RL_GRAD_NORM, norms)
                d = dm.inc(d, DM_RL_NONFINITE, not ok)
                d = dm.inc(d, DM_RL_SKIPPED, skipped)
                dev_rl = d
            step = RLStepOut(loss=losses.mean(), rewards=out.rewards, logps=out.logps,
                             deltas=out.deltas, dsts=out.dsts, routes=out.routes,
                             state=out.state, grad_norms=norms, skipped=skipped,
                             dev_sim=out.dev, dev_rl=dev_rl, losses=losses, grads=lane_grads)
        self.steps += 1
        reg = registry()
        reg.counter("mho_rl_steps_total", "RL train steps executed").inc()
        reg.counter("mho_rl_episodes_total", "rollout episodes trained on").inc(fleet)
        if self.dm_sim is not None:
            # rides the sync the span above already paid for
            flushed = self.dm_sim.flush(step.dev_sim, reg=reg, phase="rl")
            for k, v in flushed.items():
                if not isinstance(v, dict):
                    self.sim_totals[k] = self.sim_totals.get(k, 0.0) + v
        if self.dm_rl is not None:
            self.last_rl_metrics = self.dm_rl.flush(dev_rl, reg=reg)
        return step

    # ---- checkpoint interop ----------------------------------------------

    def save(self, directory: str, step: Optional[int] = None,
             extra: Optional[dict] = None) -> int:
        """Persist the parameters (a `ChebNet` state dict) and the Adam
        state through `train.checkpoints` with ``source="rl"`` lineage, so
        that the service's hot reload (`serve.executor.hot_reload`) and the
        loop's refit take the RL candidate through their verified-restore
        paths."""
        from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib

        step = self.steps if step is None else int(step)
        opt = self.opt_state
        state = {"params": dict(self.params),
                 "opt_state": {"count": opt.count, "mu": dict(opt.mu), "nu": dict(opt.nu)}}
        lineage = ckpt_lib.make_lineage(
            "rl", cfg=self.cfg,
            extra={"rl_step": step, "rounds": self.rounds,
                   "slots_per_round": self.slots_per_round, **(extra or {})})
        ckpt_lib.save_checkpoint(directory, step, state, lineage=lineage)
        return step


def make_eval(cfg, model, spec: SimSpec):
    """The sampling-policy evaluator: `ev(params, insts, jobss, paramss,
    states, init_rates, draws, gumbel=None)` (`draws` as `RLTrainer.
    train_step` takes them) runs the same stochastic policy
    the trainer optimizes (temperature included) over a fleet and returns
    the terminal `SimState`s: both contenders of an A/B run the same
    instances, draws and horizon, only the parameters differ."""
    rounds, slots = int(cfg.rl_rounds), int(cfg.rl_slots)

    def ev(params, insts, jobss, paramss, states, init_rates, draws, gumbel=None):
        fleet = insts.adj.shape[0]
        draws = shard_draws(draws, 0, fleet, spec, states.delay_sum.dtype, insts.adj.device)
        with torch.no_grad():
            _, out = rollout(model, params, insts, jobss, spec, paramss, states, init_rates,
                             draws, 0.0, rounds, slots, float(cfg.rl_temp),
                             float(cfg.rl_delay_weight), layout=cfg.layout, gumbel=gumbel)
        return out.state

    return ev


def delivered_ratio(states: SimState) -> float:
    """Fleet-wide delivered / generated of stacked terminal states."""
    gen = float(states.generated.sum())
    return float(states.delivered.sum()) / max(gen, 1.0)
