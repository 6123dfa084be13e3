"""Graph-partition parallelism with halo exchange over a mesh axis.

Port of `multihop_offload_tpu/parallel/partition.py`.  For a single network
too large for one device, the graph's vertex sets (links of the conflict
graph, slots of the extended line graph) are row-sharded over the devices
of one mesh axis.  Each propagation step -- a conflict-coupling matvec in
the queueing fixed point, or a Chebyshev-recursion matmul in the GNN --
computes the resident row block against the full activation vector,
reassembled each step by an all-gather: the halo exchange.  The O(L^2)
adjacency never moves.

Shards are lists, one tensor per device of the axis in order (see
`parallel/collectives.py`); row counts must divide by the device count.
`sharded_chebnet_apply` runs the port's model once per shard with its
`propagate` hook swapped for `halo_matmul`, as JAX's `model.clone(
propagate=...)`: the shards run in lockstep threads (`Lockstep`), since
each hook call meets the other shards'.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Sequence

import torch

from multihop_offload_tpu_torch.parallel.collectives import (
    Lockstep,
    all_gather,
    copy_to,
    device_key,
    gather,
)


def halo_matmul(step: Lockstep) -> Callable:
    """(rows, L) x (L_local, ...) propagation op for the shards of `step`:
    gather the sharded activations into the full vector, multiply the
    resident block."""

    def prop(support_rows: torch.Tensor, x_rows: torch.Tensor) -> torch.Tensor:
        x_full = step.all_gather(x_rows, axis=-2, tiled=True)
        return support_rows @ x_full

    return prop


def sharded_interference_fixed_point(
    adj_conflict_rows: Sequence[torch.Tensor],  # (..., L_local, L) conflict blocks
    link_rates_rows: Sequence[torch.Tensor],    # (..., L_local)
    cf_degs_rows: Sequence[torch.Tensor],       # (..., L_local)
    link_lambda_rows: Sequence[torch.Tensor],   # (..., L_local)
    num_iters: int = 10,
) -> List[torch.Tensor]:
    """Row-sharded `env.queueing.interference_fixed_point`
    (`offloading_v3.py:500-506`): mu_0 = rate / (cf_deg + 1); iterate
    busy = clip(lambda / mu, 0, 1); mu = rate / (1 + A_conflict @ busy).
    Per iteration, one tiled all-gather of the (L,) busy vector -- the halo
    -- and one local (L_local, L) matvec per shard.  Returns each shard's mu
    rows."""
    mu = [r / (c + 1.0) for r, c in zip(link_rates_rows, cf_degs_rows)]
    for _ in range(num_iters):
        busy = [torch.clamp(lam / m, 0.0, 1.0) for lam, m in zip(link_lambda_rows, mu)]
        full = all_gather(busy, axis=-1, tiled=True)
        mu = [r / (1.0 + torch.matmul(a, f.unsqueeze(-1)).squeeze(-1))
              for r, a, f in zip(link_rates_rows, adj_conflict_rows, full)]
    return mu


def _with_propagate(model, prop, device):
    """A copy of `model` on `device` whose every layer propagates with
    `prop`: the same parameters, the same math."""
    clone = copy.deepcopy(model).to(device)
    clone.propagate = prop
    for layer in clone.layers:
        layer.propagate = prop
    return clone


def sharded_chebnet_apply(
    model,
    x_rows: Sequence[torch.Tensor],        # (E_local, F) feature blocks
    support_rows: Sequence[torch.Tensor],  # (E_local, E) support blocks
) -> List[torch.Tensor]:
    """Apply a `models.ChebNet` with the graph row-sharded: identical
    parameters, identical math, but every Chebyshev propagation is a halo
    matmul.  Pointwise pieces (kernel contraction, bias, activations) stay
    local to the rows.  Returns each shard's output rows.  The shards run
    copies of `model` (one a device), so a gradient of the output reaches
    the copies' parameters, not `model`'s."""
    step = Lockstep(len(x_rows))
    prop = halo_matmul(step)
    replicas = {}
    for x in x_rows:
        if device_key(x.device) not in replicas:
            replicas[device_key(x.device)] = _with_propagate(model, prop, x.device)
    return step.run(lambda i: replicas[device_key(x_rows[i].device)](x_rows[i],
                                                                      support_rows[i]))


def sharded_spectral_forward(
    model,
    feats: torch.Tensor,      # (E, F)
    support: torch.Tensor,    # (E, E)
    devices: Sequence[torch.device],
) -> torch.Tensor:
    """Full-in/full-out convenience wrapper: slice each device's rows, run
    the sharded forward, regather the output on `feats`' device."""
    e = feats.shape[-2]
    n_dev = len(devices)
    if e % n_dev:
        raise ValueError(
            f"graph size {e} not divisible by axis 'graph' ({n_dev} "
            f"devices); pad the extended graph (PadSpec round_to) to a multiple"
        )
    rows = e // n_dev
    x_rows = [copy_to(feats[..., i * rows:(i + 1) * rows, :], d) for i, d in enumerate(devices)]
    s_rows = [copy_to(support[..., i * rows:(i + 1) * rows, :], d)
              for i, d in enumerate(devices)]
    out_rows = sharded_chebnet_apply(model, x_rows, s_rows)
    return gather(out_rows, feats.device, axis=-2, tiled=True)
