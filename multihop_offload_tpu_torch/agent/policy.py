"""GNN policy evaluation — the deployable inference path.

Port of `multihop_offload_tpu/agent/policy.py:forward_env`: actor forward ->
shortest paths over the predicted delays -> greedy offloading -> empirical
evaluation, for a batch of requests in one pass.  Under `layout="sparse"`
the model must carry the sparse `propagate` (`make_model(cfg, layout)`,
`load_model(..., layout=)`), and the decision path reads the node diagonal
straight from the node delays (`policy.py:50-53`), bit-identical to the
dense diagonal read.
"""

from __future__ import annotations

import torch

from multihop_offload_tpu_torch._device import resolve_device
from multihop_offload_tpu_torch._phases import phase
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
from multihop_offload_tpu_torch.layouts.policy import resolve_layout


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
    layout=None,
    precision=None,
    apsp_impl: str = "xla",
    apsp_fn=None,
    fp_fn=None,
    support=None,
) -> tuple[PolicyOutcome, ActorOutput]:
    """Run the GNN policy on a batch on `device` (default CUDA; the model,
    instance and jobs are moved there).  `compat_diagonal_bug=True` feeds
    the decision path the reference's cycled node-delay diagonal.  The
    model carries its own compute dtypes (`make_model(policy=)`); the
    `precision` policy (None: fp32) narrows the APSP, which takes the route
    of `apsp_impl` (`ops.minplus.resolve_apsp`; `'xla'`: the squarings at
    every N, as JAX's `apsp_fn=None`).  `apsp_fn`, a callable of the
    (B, N, N) weight matrix, replaces that route when given (JAX
    `policy.py:33`; `env.policies.shortest_paths`).  `fp_fn` is the
    fixed-point core (`ops.fixed_point.resolve_fixed_point`; None: the
    layout's own) and `support` replaces the model's default support (JAX
    `:28-58`; the large path's `--sparse` COO support)."""
    dev = resolve_device(device)
    lay = resolve_layout(layout)
    model = model.to(dev)
    inst, jobs = inst.to(dev), jobs.to(dev)
    with phase("actor"):
        sup = default_support(model, inst, lay) if support is None else support
        actor = actor_delay_matrix(model, inst, jobs, sup, fp_fn=fp_fn, layout=lay)
    if compat_diagonal_bug:
        unit_diag = compat_cycled_diagonal(inst, actor.node_delay)
    elif lay.sparse:
        inf = torch.full((), float("inf"), dtype=actor.node_delay.dtype, device=dev)
        unit_diag = torch.where(inst.comp_mask, actor.node_delay, inf)
    else:
        unit_diag = torch.diagonal(actor.delay_matrix, dim1=1, dim2=2)
    outcome = evaluate_spmatrix_policy(inst, jobs, actor.link_delay, unit_diag,
                                       gen, explore=explore, prob=prob, layout=lay,
                                       precision=precision, apsp_impl=apsp_impl,
                                       apsp_fn=apsp_fn, fp_fn=fp_fn)
    return outcome, actor
