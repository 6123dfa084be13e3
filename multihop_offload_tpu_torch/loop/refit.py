"""Background re-fit: fine-tune the serving policy on captured experience.

Port of `multihop_offload_tpu/loop/refit.py`.  One step:
`agent.train_step.forward_backward` batched over a packed experience
batch (the service's own pad layout via `experience.replay_batches`; on
the card K1 forward and backward and K2, under the sparse layout K4 both
ways and K6 as well), mean gradients across the batch, one update of the
port's Keras-parity Adam (`agent.replay.make_optimizer`) and the
post-update max-norm constraint.  A step whose mean losses or gradients
are not finite skips the update and is counted: parameters and optimizer
state pass through unchanged (JAX `:98-110`).  Starting point is the
CURRENT champion's parameters -- a refit is a continuation, not a retrain
-- but the optimizer state is fresh: the offline run's moments describe a
different data distribution and are not checkpointed into serving trees.

Parameters travel as `{"params": state_dict}` (the JAX `variables`
shape), the state dict of the serving `ChebNet`.  The candidate is written
to its own checkpoint directory (`<model_dir>/torch_candidate`) with
`source="refit"` lineage; it never touches the serving ``torch/`` tree --
only `loop.promote` moves weights there, after the sim gate passes.  The
step is the prof-layer program `loop/refit_step` (JAX `:114`), accounted
at the host read of its losses (JAX `:132`), which also closes each
step's host-clock time in `info["step_ms"]`.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Optional, Sequence

import torch

from multihop_offload_tpu_torch._device import resolve_device
from multihop_offload_tpu_torch.obs import prof as obs_prof
from multihop_offload_tpu_torch.agent.replay import (
    apply_max_norm_constraint,
    make_optimizer,
)
from multihop_offload_tpu_torch.agent.train_step import forward_backward
from multihop_offload_tpu_torch.chaos import faults
from multihop_offload_tpu_torch.loop.experience import (
    Outcome,
    pad_for_outcomes,
    replay_batches,
)
from multihop_offload_tpu_torch.obs import trace as obs_trace
from multihop_offload_tpu_torch.obs.registry import registry as obs_registry
from multihop_offload_tpu_torch.obs.spans import span
from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib

CANDIDATE_SUBDIR = "torch_candidate"
SERVING_SUBDIR = "torch"


def candidate_dir(model_dir: str) -> str:
    return os.path.join(model_dir, CANDIDATE_SUBDIR)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The draws of refit step `step` (read only under exploration or a
    sampled decision): a generator on `device` seeded from (seed, step)
    alone, as JAX folds the step into its key."""
    return torch.Generator(device=device).manual_seed(int(seed) * 1_000_003 + int(step))


def _all_finite(xs) -> torch.Tensor:
    ok = None
    for x in xs:
        f = torch.isfinite(x).all()
        ok = f if ok is None else ok & f
    return ok


def refit(
    model,
    variables,
    outcomes: Sequence[Outcome],
    cfg,
    steps: Optional[int] = None,
    slots: Optional[int] = None,
    seed: int = 0,
    pad=None,
    device=None,
) -> tuple:
    """Fine-tune `variables["params"]` (a state dict of `model`'s
    architecture) on `outcomes` on `device` (default CUDA); returns
    (candidate_variables, info dict).  The packing follows `cfg.layout`,
    `cfg.dtype` and `cfg.round_to`; `model` is the template and is not
    modified.  Pure training -- saving/lineage is `refit_and_save`."""
    if not outcomes:
        raise ValueError("refit needs at least one captured outcome")
    dev = resolve_device(device)
    steps = cfg.loop_refit_steps if steps is None else steps
    slots = cfg.loop_refit_slots if slots is None else slots
    layout = cfg.layout
    pad = pad_for_outcomes(outcomes, round_to=cfg.round_to, layout=layout) \
        if pad is None else pad

    hop_cache: dict = {}
    with span("loop/refit_pack", outcomes=len(outcomes)):
        batches = list(replay_batches(outcomes, pad, slots, dtype=cfg.torch_dtype,
                                      hop_cache=hop_cache, layout=layout, device=dev))
        # trace continuity: each captured request's journey records which
        # refit batch its experience trained (obs.trace hop chain)
        for bi in range(0, len(outcomes), slots):
            obs_trace.hop(
                "refit_batch",
                [o.request.request_id for o in outcomes[bi:bi + slots]],
                batch=bi // slots, slots=slots,
            )
    work = copy.deepcopy(model).to(dev)
    names = [k for k, _ in work.named_parameters()]
    params = {k: variables["params"][k].detach().to(dev).clone() for k in names}
    optimizer = make_optimizer(cfg)
    opt_state = optimizer.init(params)

    def step_fn(params, opt_state, binst, bjobs, gen):
        with torch.no_grad():
            for k, p in work.named_parameters():
                p.copy_(params[k])
        out = forward_backward(work, binst, bjobs, gen, prob=cfg.prob, layout=layout,
                               device=dev, apsp_impl=cfg.apsp_impl)
        g = {k: out.grads[k].mean(0) for k in names}
        lc, lm = out.loss_critic.mean(), out.loss_mse.mean()
        ok = _all_finite([lc, lm, *g.values()])
        p_new, opt_new = optimizer.update(g, opt_state, params)
        p_new = apply_max_norm_constraint(p_new, 1.0)
        return p_new, opt_new, torch.stack([lc.double(), lm.double(), ok.double()])

    step_fn = obs_prof.wrap("loop/refit_step", step_fn)
    losses, step_ms = [], []
    skipped = 0
    with span("loop/refit", steps=steps, batches=len(batches)):
        for s in range(steps):
            faults.crashpoint("refit:mid")
            binst, bjobs = batches[s % len(batches)]
            t0 = time.perf_counter()  # nondet-ok(refit step wall time is a measurement)
            p_new, opt_new, read = step_fn(params, opt_state, binst, bjobs,
                                           step_generator(seed, s, dev))
            # the step's one host read: both losses and the skip flag
            lc_f, lm_f, good = read.tolist()
            if good:
                params, opt_state = p_new, opt_new
            else:
                skipped += 1  # params and optimizer state pass through
            step_ms.append((time.perf_counter() - t0) * 1e3)  # nondet-ok(same measurement)
            step_fn.account(step_ms[-1] / 1e3)
            losses.append((lc_f, lm_f))
    obs_registry().counter(
        "mho_loop_refit_steps_total", "experience fine-tuning steps run"
    ).inc(steps)
    if skipped:
        obs_registry().counter(
            "mho_refit_skipped_updates_total",
            "optimizer updates skipped on non-finite grads",
        ).inc(skipped, phase="refit")
    info = {
        "steps": steps,
        "batches": len(batches),
        "outcomes": len(outcomes),
        "skipped_updates": skipped,
        "loss_critic_first": losses[0][0],
        "loss_critic_last": losses[-1][0],
        "loss_mse_last": losses[-1][1],
        "step_ms": step_ms,
    }
    return {"params": params}, info


def refit_and_save(
    model,
    variables,
    outcomes: Sequence[Outcome],
    cfg,
    parent_step: Optional[int] = None,
    seed: int = 0,
    pad=None,
    step: Optional[int] = None,
    device=None,
) -> tuple:
    """Run `refit` and persist the candidate with `source="refit"` lineage.
    Returns (candidate_variables, candidate_step, info).

    `step` pins the candidate step (crash-resume: the journal recorded the
    intended step before the first attempt, so the redo lands at the same
    id instead of latest+1)."""
    cand_vars, info = refit(model, variables, outcomes, cfg, seed=seed, pad=pad,
                            device=device)
    directory = candidate_dir(cfg.model_dir())
    step = int(step) if step is not None else (
        (ckpt_lib.latest_step(directory) or 0) + 1)
    host = {"params": {k: v.detach().cpu() for k, v in cand_vars["params"].items()}}
    faults.crashpoint("refit:pre_save")
    ckpt_lib.save_checkpoint(
        directory, step, host,
        lineage=ckpt_lib.make_lineage(
            "refit", parent_step=parent_step,
            parent_dir=os.path.join(cfg.model_dir(), SERVING_SUBDIR), cfg=cfg,
            extra={"outcomes": len(outcomes),
                   "refit_steps": info["steps"]},
        ),
    )
    faults.crashpoint("refit:post_save")
    obs_registry().counter(
        "mho_loop_refits_total", "candidate checkpoints produced"
    ).inc()
    return cand_vars, step, info
