"""Policy adapters: offloading decision + forwarding tables for the sim.

Port of `multihop_offload_tpu/sim/policies.py`.  `make_policy` returns a
function

    policy_fn(inst, jobs_est, node_up, link_up, gen) -> SimRoutes

for the trained GNN (the actor: K1, and K4 under the sparse layout), the
congestion-agnostic greedy baseline and local-only compute.  `jobs_est`
carries the simulator's measured arrival rates, not the ground truth the
arrivals are drawn from.  Down links and nodes are priced at +inf before
the shortest paths (K2 on the card under both layouts: the sparse layout
builds W from the link list, then squares it), so a policy round re-routes
around a failure.  Every policy decides greedily (`offload_decide` at
``explore=0, prob=False``, as `cli/sim.py` runs it), so `gen`, the round's
policy draws, is not read.  `objective` (`env.offloading.ObjectiveWeights`)
folds the energy weights into the `gnn` and `baseline` decisions; None or
the null weights decide as the unweighted objective, bit for bit.
"""

from __future__ import annotations

import torch

from multihop_offload_tpu_torch.env.apsp import (
    apsp_minplus,
    next_hop_table,
    weight_matrix_from_link_delays,
)
from multihop_offload_tpu_torch.env.baseline import baseline_unit_delays
from multihop_offload_tpu_torch.env.offloading import offload_decide
from multihop_offload_tpu_torch.layouts.compact import NEXT_HOP_DTYPE, pack_next_hop
from multihop_offload_tpu_torch.layouts.policy import resolve_layout
from multihop_offload_tpu_torch.layouts.sparse import (
    next_hop_from_edges,
    weight_matrix_from_edges,
)
from multihop_offload_tpu_torch.precision import resolve_precision
from multihop_offload_tpu_torch.sim.state import SimRoutes

POLICY_KINDS = ("gnn", "baseline", "local")


def decide_routes(
    inst,
    jobs_est,
    link_delays: torch.Tensor,
    unit_diag: torch.Tensor,
    node_up: torch.Tensor,
    link_up: torch.Tensor,
    layout=None,
    apsp_fn=None,
    objective=None,
) -> SimRoutes:
    """The decision skeleton on per-link delays (B, L) and a node diagonal
    (B, N), returning the forwarding table (int16 under every layout).
    `apsp_fn` (a `PrecisionPolicy.wrap_apsp` result; None: `apsp_minplus`)
    squares the weight matrix at every N, as the JAX simulator does
    (`sim/policies.py:76`), whatever a Config's `apsp_impl`."""
    lay = resolve_layout(layout)
    inf = torch.full((), float("inf"), dtype=link_delays.dtype, device=link_delays.device)
    link_delays = torch.where(link_up, link_delays, inf)
    unit_diag = torch.where(node_up, unit_diag, inf.to(unit_diag.dtype))
    if lay.sparse:
        w = weight_matrix_from_edges(inst.link_ends, inst.link_mask, link_delays,
                                     inst.num_pad_nodes)
    else:
        w = weight_matrix_from_link_delays(inst.adj, inst.link_index, link_delays)
    sp = (apsp_fn or apsp_minplus)(w)
    dec = offload_decide(inst, jobs_est, sp, inst.hop, unit_diag, objective=objective)
    # a destination cut off by a failure degrades to local compute: packets
    # must never chase an infinite-cost route
    b, n, _ = sp.shape
    src = jobs_est.src.long()
    dst = dec.dst.long()
    reachable = (torch.isfinite(torch.gather(sp.reshape(b, n * n), 1, src * n + dst))
                 & torch.gather(node_up, 1, dst))
    dst = torch.where(reachable, dst, src)
    nh = (next_hop_from_edges(inst.link_ends, inst.link_mask, sp) if lay.sparse
          else next_hop_table(inst.adj, sp))
    return SimRoutes(dst=dst.to(torch.int32), next_hop=pack_next_hop(nh),
                     reach=torch.isfinite(sp))


def make_policy(
    kind: str,
    model=None,
    precision=None,
    layout=None,
    objective=None,
):
    """The per-round policy function of `sim.runner.simulate`.

    `model` (a `ChebNet` carrying its weights, built for `layout` and the
    policy's dtypes) is the GNN's actor, on its default support.
    `precision` (str | `PrecisionPolicy` | None) narrows the APSP to its
    compute dtype (JAX `:105-125`: W is squared in bf16, K2 on the card);
    the decision read-back stays an fp32 island.  The instances fed to the
    returned function must be built with `layout`.  `objective` weights
    the `gnn` and `baseline` decisions (`decide_routes`)."""
    if kind not in POLICY_KINDS:
        raise ValueError(f"unknown sim policy '{kind}'; one of {POLICY_KINDS}")
    apsp_fn = resolve_precision(precision).wrap_apsp(None)
    lay = resolve_layout(layout)

    if kind == "local":

        def local_fn(inst, jobs_est, node_up, link_up, gen=None):
            b, n = inst.proc_bws.shape
            dev = inst.proc_bws.device
            # never consulted: every job computes at its source
            return SimRoutes(
                dst=jobs_est.src.to(torch.int32),
                next_hop=torch.zeros((b, n, n), dtype=NEXT_HOP_DTYPE, device=dev),
                reach=torch.zeros((b, n, n), dtype=torch.bool, device=dev),
            )

        return local_fn

    if kind == "baseline":

        def baseline_fn(inst, jobs_est, node_up, link_up, gen=None):
            link_d, node_d = baseline_unit_delays(inst)
            return decide_routes(inst, jobs_est, link_d, node_d, node_up, link_up,
                                 layout=lay, apsp_fn=apsp_fn, objective=objective)

        return baseline_fn

    if model is None:
        raise ValueError("kind='gnn' needs a model")

    def gnn_fn(inst, jobs_est, node_up, link_up, gen=None):
        from multihop_offload_tpu_torch.agent.actor import (
            actor_delay_matrix,
            default_support,
        )

        actor = actor_delay_matrix(model, inst, jobs_est,
                                   default_support(model, inst, layout=lay))
        if lay.sparse:
            inf = torch.full((), float("inf"), dtype=actor.node_delay.dtype,
                             device=actor.node_delay.device)
            unit_diag = torch.where(inst.comp_mask, actor.node_delay, inf)
        else:
            unit_diag = torch.diagonal(actor.delay_matrix, dim1=1, dim2=2)
        return decide_routes(inst, jobs_est, actor.link_delay, unit_diag,
                             node_up, link_up, layout=lay, apsp_fn=apsp_fn,
                             objective=objective)

    return gnn_fn
