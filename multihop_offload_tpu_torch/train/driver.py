"""Evaluation driver: the (baseline, local, GNN) method triple.

Port of the `eval_methods` closure of `multihop_offload_tpu/train/driver.py`
(`_Harness._build_steps`).  The Trainer and the Evaluator's file loop are
not ported yet.
"""

from __future__ import annotations

import torch

from multihop_offload_tpu_torch._device import resolve_device
from multihop_offload_tpu_torch.agent.policy import forward_env
from multihop_offload_tpu_torch.env.policies import baseline_policy, local_policy


@torch.no_grad()
def eval_methods(model, inst, jobs, gen: torch.Generator | None = None,
                 device=None):
    """Per-job delays (B, J) of the baseline, local and GNN methods, all
    greedy (explore=0, prob=False), on a batch of requests, on `device`
    (default CUDA)."""
    dev = resolve_device(device)
    inst, jobs = inst.to(dev), jobs.to(dev)
    bl = baseline_policy(inst, jobs, gen).job_total
    loc = local_policy(inst, jobs).job_total
    gnn = forward_env(model, inst, jobs, gen, device=dev)[0].job_total
    return bl, loc, gnn
