"""Drivers: the (baseline, local, GNN) evaluation triple and the training step.

Port of the `eval_methods`, `gnn_train_step` and `_replay` closures of
`multihop_offload_tpu/train/driver.py` (`_Harness._build_steps`,
`:243-279`, `:312-315`).  The Trainer's file loop, checkpoints and CSVs
are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from multihop_offload_tpu_torch._device import resolve_device
from multihop_offload_tpu_torch._phases import phase
from multihop_offload_tpu_torch.agent.policy import forward_env
from multihop_offload_tpu_torch.agent.replay import (
    AdamState,
    GradReplay,
    adam_init,
    replay_apply,
    replay_init,
    replay_remember,
)
from multihop_offload_tpu_torch.agent.train_step import forward_backward
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.env.policies import baseline_policy, local_policy


@torch.no_grad()
def eval_methods(model, inst, jobs, gen: torch.Generator | None = None,
                 device=None, layout=None):
    """Per-job delays (B, J) of the baseline, local and GNN methods, all
    greedy (explore=0, prob=False), on a batch of requests, on `device`
    (default CUDA), under `layout` (default dense)."""
    dev = resolve_device(device)
    inst, jobs = inst.to(dev), jobs.to(dev)
    with phase("baseline"):
        bl = baseline_policy(inst, jobs, gen, layout=layout).job_total
    with phase("local"):
        loc = local_policy(inst, jobs, layout=layout).job_total
    with phase("gnn"):
        gnn = forward_env(model, inst, jobs, gen, device=dev, layout=layout)[0].job_total
    return bl, loc, gnn


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step besides the model."""

    opt: AdamState
    mem: GradReplay


@dataclasses.dataclass
class TrainReport:
    job_total: torch.Tensor    # (B, J) empirical delays of the episodes' decisions
    loss_critic: torch.Tensor  # (B,)
    loss_mse: torch.Tensor     # (B,)
    replayed: bool             # whether the replay update ran
    replay_loss: torch.Tensor  # () mean sampled critic loss (NaN if not replayed)
    skipped: int               # non-finite samples skipped by the replay


def train_init(model, cfg: Config, device=None) -> TrainState:
    """Adam state and an empty gradient replay for `model`, on `device`."""
    dev = resolve_device(device)
    params = {k: p.detach().to(dev) for k, p in model.named_parameters()}
    return TrainState(opt=adam_init(params), mem=replay_init(params, cfg.memory_size))


def train_step(model, state: TrainState, inst, jobs, cfg: Config,
               gen: torch.Generator | None = None, explore: float | None = None,
               device=None) -> TrainReport:
    """One training step on a batch of B episodes, on `device` (default
    CUDA): batched `forward_backward` under `cfg.layout`, every episode's
    gradient remembered, then, once `cfg.batch` gradients are stored, one
    replay of `cfg.batch` of them through Adam, written into `model`'s
    parameters.  `explore` defaults to `cfg.explore`; `gen` feeds the
    exploration draws and the replay's sampling."""
    dev = resolve_device(device)
    model = model.to(dev)
    outs = forward_backward(
        model, inst, jobs, gen, explore=cfg.explore if explore is None else explore,
        prob=cfg.prob, mse_weight=cfg.mse_weight, critic_weight=cfg.critic_weight,
        layout=cfg.layout, device=dev)
    replay_remember(state.mem, outs.grads, outs.loss_critic, outs.loss_mse)
    replay_loss = torch.full((), float("nan"), device=dev)
    skipped = 0
    replayed = state.mem.count >= cfg.batch
    if replayed:
        params = {k: p.detach() for k, p in model.named_parameters()}
        params, state.opt, replay_loss, skipped = replay_apply(
            state.mem, params, state.opt, cfg.batch, lr=cfg.learning_rate,
            decay=cfg.learning_decay, clipnorm=cfg.clipnorm, max_norm=cfg.max_norm,
            gen=gen)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(params[k])
    return TrainReport(job_total=outs.delays.job_total, loss_critic=outs.loss_critic,
                       loss_mse=outs.loss_mse, replayed=replayed, replay_loss=replay_loss,
                       skipped=skipped)
