"""GNN policy evaluation — the deployable inference path.

Port of `multihop_offload_tpu/agent/policy.py:forward_env`: actor forward ->
shortest paths over the predicted delays -> greedy offloading -> empirical
evaluation, for a batch of requests in one pass.
"""

from __future__ import annotations

import torch

from multihop_offload_tpu_torch._device import resolve_device
from multihop_offload_tpu_torch.agent.actor import (
    ActorOutput,
    actor_delay_matrix,
    compat_cycled_diagonal,
    default_support,
)
from multihop_offload_tpu_torch.env.policies import (
    PolicyOutcome,
    evaluate_spmatrix_policy,
)


@torch.no_grad()
def forward_env(
    model,
    inst,
    jobs,
    gen: torch.Generator | None = None,
    explore: float = 0.0,
    prob: bool = False,
    compat_diagonal_bug: bool = False,
    device=None,
) -> tuple[PolicyOutcome, ActorOutput]:
    """Run the GNN policy on a batch on `device` (default CUDA; the model,
    instance and jobs are moved there).  `compat_diagonal_bug=True` feeds
    the decision path the reference's cycled node-delay diagonal."""
    dev = resolve_device(device)
    model = model.to(dev)
    inst, jobs = inst.to(dev), jobs.to(dev)
    actor = actor_delay_matrix(model, inst, jobs, default_support(model, inst))
    if compat_diagonal_bug:
        unit_diag = compat_cycled_diagonal(inst, actor.node_delay)
    else:
        unit_diag = torch.diagonal(actor.delay_matrix, dim1=1, dim2=2)
    outcome = evaluate_spmatrix_policy(inst, jobs, actor.link_delay, unit_diag,
                                       gen, explore=explore, prob=prob)
    return outcome, actor
