"""Actor forward pass: GNN arrival-rate prediction -> unit-delay matrix.

Port of `multihop_offload_tpu/agent/actor.py`: extended-line-graph
features, the ChebNet's per-slot arrival rates, the interference fixed
point (K1), unit delays with the congestion substitution, and the (N, N)
delay matrix (link delays off the diagonal, compute delays on it, +inf for
relays).  Batched over the leading axis B, and differentiable: the training
step pulls its cotangent back through it (`agent.train_step`).  Under the
sparse layout the support is the edge-list `SparseSupport` (`:57-75`).
"""

from __future__ import annotations

import dataclasses

import torch

from multihop_offload_tpu_torch.env.queueing import interference_fixed_point
from multihop_offload_tpu_torch.layouts.policy import resolve_layout
from multihop_offload_tpu_torch.layouts.sparse import (
    SparseSupport,
    sparse_chebyshev_support,
)
from multihop_offload_tpu_torch.models.chebconv import chebyshev_support
from multihop_offload_tpu_torch.precision import island_dtype


@dataclasses.dataclass
class ActorOutput:
    delay_matrix: torch.Tensor  # (B, N, N)
    link_delay: torch.Tensor    # (B, L) per-link unit delays
    node_delay: torch.Tensor    # (B, N) per-node unit delays (0 off comp nodes)
    lam: torch.Tensor           # (B, E) masked GNN output


def default_support(model, inst, layout=None):
    """k=1: the raw extended adjacency (unused by a K=1 layer); k>=2: the
    masked rescaled Laplacian.  Under the sparse layout (with a sparse-built
    Instance) both in edge-list form, a `SparseSupport` carrying the
    list's CSR index for K4."""
    if resolve_layout(layout).sparse and inst.sparse is not None:
        ext, csr = inst.sparse.ext, inst.sparse.ext_csr
        if model.k >= 2:
            return sparse_chebyshev_support(ext, mask=inst.ext_mask, csr=csr)
        return SparseSupport(edges=ext, diag=torch.zeros(
            inst.ext_mask.shape, dtype=ext.vals.dtype, device=ext.vals.device), csr=csr)
    if model.k >= 2:
        return chebyshev_support(inst.adj_ext, inst.ext_mask)
    return inst.adj_ext


def build_ext_features(inst, jobs) -> torch.Tensor:
    """(B, E, 4) features: [self_loop, rate, exogenous arrivals, is_server]."""
    b, n = inst.proc_bws.shape
    dt = inst.ext_rate.dtype
    zero = torch.zeros((), dtype=dt, device=inst.ext_rate.device)
    # the per-node sums accumulate at >= fp32 and are rounded once to the
    # storage dtype (no bf16 scatter-add: lossy, and unordered on the card)
    acc = island_dtype(dt)
    arr = torch.zeros((b, n), dtype=acc, device=zero.device).scatter_add_(
        1, jobs.src.long(), torch.where(jobs.mask, jobs.rate * jobs.ul, zero).to(acc)
    ).to(dt)
    jobs_arrivals = torch.cat(
        [torch.zeros((b, inst.num_pad_links), dtype=dt, device=zero.device),
         arr * inst.comp_mask], dim=1)
    return torch.stack([inst.ext_self_loop, inst.ext_rate, jobs_arrivals,
                        inst.ext_as_server], dim=-1)


def lambdas_to_delay_matrix(inst, lam: torch.Tensor, fp_fn=None, layout=None) -> ActorOutput:
    """lambda (B, E) -> delay matrix and per-link / per-node unit delays;
    the fixed point takes `fp_fn` and `layout` (JAX `:100-116`)."""
    num_links = inst.num_pad_links
    b, n = inst.proc_bws.shape
    dev = lam.device
    zero = torch.zeros((), dtype=lam.dtype, device=dev)
    one = torch.ones((), dtype=lam.dtype, device=dev)
    lam = lam * inst.ext_mask  # padded slots predict nothing
    link_lambda = lam[:, :num_links]
    node_lambda = torch.where(inst.comp_mask, lam[:, num_links:], zero)

    link_mu = interference_fixed_point(inst, link_lambda, fp_fn=fp_fn, layout=layout)
    # congested (lambda - mu > 0, strict) replaced by T*lambda/(101*mu)
    T = inst.T.unsqueeze(1)
    l_slack = link_mu - link_lambda
    l_cong = (link_lambda - link_mu) > 0
    link_delay = torch.where(l_cong, T * link_lambda / (101.0 * link_mu),
                             1.0 / torch.where(l_cong, one, l_slack))
    node_mu = torch.where(inst.comp_mask, inst.proc_bws, one)
    n_slack = node_mu - node_lambda
    n_cong = ((node_lambda - node_mu) > 0) & inst.comp_mask
    node_delay = torch.where(n_cong, T * node_lambda / (100.0 * node_mu),
                             1.0 / torch.where(n_cong, one, n_slack))
    node_delay = torch.where(inst.comp_mask, node_delay, zero)

    u = inst.link_ends[..., 0].long()
    v = inst.link_ends[..., 1].long()
    masked = torch.where(inst.link_mask, link_delay, zero)
    # padded links all write 0 to (0, 0), which the diagonal write replaces
    # (out-of-place scatters: autograd pulls back through each)
    inf = torch.full((), float("inf"), dtype=lam.dtype, device=dev)
    diag = (torch.arange(n, device=dev, dtype=torch.long) * (n + 1)).expand(b, n)
    dmtx = torch.zeros((b, n * n), dtype=lam.dtype, device=dev) \
        .scatter(1, u * n + v, masked) \
        .scatter(1, v * n + u, masked) \
        .scatter(1, diag, torch.where(inst.comp_mask, node_delay, inf))
    return ActorOutput(delay_matrix=dmtx.view(b, n, n), link_delay=link_delay,
                       node_delay=node_delay, lam=lam)


def compat_cycled_diagonal(inst, node_delay: torch.Tensor) -> torch.Tensor:
    """The reference's diagonal-cycling bug (`np.fill_diagonal` with the
    shorter compute-node vector), reproduced for A/B validation: node i
    receives compute-node (i mod n_comp)'s delay."""
    b, n = node_delay.shape
    comp_idx = torch.argsort((~inst.comp_mask).to(torch.int8), dim=1, stable=True)
    ncomp = inst.comp_mask.sum(dim=1, keepdim=True).clamp_min(1)
    cyc = torch.gather(comp_idx, 1,
                       torch.arange(n, device=node_delay.device, dtype=torch.long) % ncomp)
    return torch.gather(node_delay, 1, cyc)


def actor_delay_matrix(model, inst, jobs, support, params: dict | None = None,
                       fp_fn=None, layout=None, masks=None) -> ActorOutput:
    """The actor on a batch; `params` (name -> tensor, as
    `model.named_parameters()` names them) replace the module's own, e.g.
    per-episode copies with a leading batch axis.  `masks`, the model's
    dropout keep masks (`ChebNet.dropout_masks`), train it with dropout
    (JAX `deterministic=False`, `:176-192`); `fp_fn` and `layout` go to
    the fixed point."""
    feats = build_ext_features(inst, jobs)
    if params is None:
        lam = model(feats, support, masks)[..., 0]
    else:
        lam = torch.func.functional_call(model, params, (feats, support, masks))[..., 0]
    return lambdas_to_delay_matrix(inst, lam, fp_fn=fp_fn, layout=layout)
