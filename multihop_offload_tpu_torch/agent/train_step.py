"""The training-math core: actor -> env -> analytic critic -> parameter grads.

Port of `multihop_offload_tpu/agent/train_step.py:forward_backward`
(`:308-434`), both layouts, batched over B episodes:

1. the actor runs with grad on per-episode parameter copies (leaves
   (B, *shape)), so the one backward of step 5 gives every episode its own
   gradient, as `jax.vmap(forward_backward)` does;
2. the decision path (APSP, greedy offloading, routing, empirical scoring)
   runs on detached values;
3. critic: with the routes fixed, the analytic congestion model's total
   delay is differentiated with respect to the route incidence (dense,
   `_critic_loss`) or the route-step occupancies (sparse,
   `_critic_loss_steps`), through the fixed point (K1's autograd Function);
4. the suffix-bias gradient turns that into per-slot unit-delay gradients
   (prefix sums of -dL/dR along each route);
5. scattered onto the (N, N) distance cotangent, plus the MSE pull toward
   the empirical unit delays on written entries, and pulled back through
   the actor with `torch.autograd.grad(dmtx, params, grad_dist)`.
"""

from __future__ import annotations

import dataclasses

import torch

from multihop_offload_tpu_torch._device import resolve_device
from multihop_offload_tpu_torch._phases import phase
from multihop_offload_tpu_torch.agent.actor import (
    ActorOutput,
    actor_delay_matrix,
    compat_cycled_diagonal,
    default_support,
)
from multihop_offload_tpu_torch.env.offloading import offload_decide
from multihop_offload_tpu_torch.env.policies import next_hops, shortest_paths
from multihop_offload_tpu_torch.env.queueing import (
    EmpiricalDelays,
    interference_fixed_point,
    run_empirical,
)
from multihop_offload_tpu_torch.env.routing import RouteSet, trace_routes
from multihop_offload_tpu_torch.layouts.policy import resolve_layout


@dataclasses.dataclass
class TrainStepOutput:
    grads: dict                # name -> (B, *shape) per-episode d loss / d theta
    loss_critic: torch.Tensor  # (B,) analytic critic total delay
    loss_mse: torch.Tensor     # (B,) masked mean((D - D_emp)^2)
    delays: EmpiricalDelays
    routes: RouteSet
    actor: ActorOutput
    dst: torch.Tensor          # (B, J)


def episode_grad_norms(grads: dict) -> torch.Tensor:
    """(B,) global gradient norm per episode of per-episode gradients
    (leaves (B, *shape)), accumulated in float32 whatever the parameters'
    dtype, as JAX `agent/train_step.py:108` takes it."""
    sq = None
    for g in grads.values():
        g = g.to(torch.float32)
        s = (g * g).flatten(1).sum(dim=1)
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def _wide(*dtypes) -> torch.dtype:
    """The smallest dtype >= float32 covering `dtypes` (the fp32 island)."""
    dt = torch.float32
    for d in dtypes:
        dt = torch.promote_types(dt, d)
    return dt


def _unit_delays(inst, link_lambda, link_mu, node_lambda):
    """Per-link and per-node unit delays with the congestion substitution,
    as the actor's head computes them."""
    one = torch.ones((), dtype=link_lambda.dtype, device=link_lambda.device)
    T = inst.T.unsqueeze(1)
    l_cong = (link_lambda - link_mu) > 0
    link_delay = torch.where(l_cong, T * link_lambda / (101.0 * link_mu),
                             1.0 / torch.where(l_cong, one, link_mu - link_lambda))
    node_mu = torch.where(inst.comp_mask, inst.proc_bws, one)
    n_cong = ((node_lambda - node_mu) > 0) & inst.comp_mask
    node_delay = torch.where(n_cong, T * node_lambda / (100.0 * node_mu),
                             1.0 / torch.where(n_cong, one, node_mu - node_lambda))
    node_delay = torch.where(inst.comp_mask, node_delay, 0.0)
    return link_delay, node_delay


def _critic_loss(inst, jobs, routes_inc: torch.Tensor):
    """Analytic congestion-model delay (B,) of fixed routes given as the
    (B, E, J) incidence."""
    num_links = inst.num_pad_links
    dt = _wide(routes_inc.dtype, jobs.rate.dtype)
    routes_inc = routes_inc.to(dt)
    w = torch.where(jobs.mask, jobs.rate.to(dt) * jobs.ul.to(dt), 0.0)
    load = torch.matmul(routes_inc, w.unsqueeze(-1)).squeeze(-1)      # (B, E)
    link_lambda = load[:, :num_links]
    node_lambda = torch.where(inst.comp_mask, load[:, num_links:], 0.0)
    link_mu = interference_fixed_point(inst, link_lambda)
    link_delay, node_delay = _unit_delays(inst, link_lambda, link_mu, node_lambda)
    unit_edge = torch.cat([link_delay, node_delay], dim=1)            # (B, E)
    # delay per (slot, job): max(data * unit * r, r), zero where r == 0
    data = jobs.ul.to(dt) + jobs.dl.to(dt)                            # (B, J)
    prod = torch.where(routes_inc > 0, unit_edge.unsqueeze(2) * routes_inc, 0.0)
    delay_job_edge = torch.maximum(data.unsqueeze(1) * prod, routes_inc)
    return delay_job_edge.sum(dim=(1, 2))


def _critic_loss_steps(inst, jobs, r_steps: torch.Tensor, seq_slot: torch.Tensor,
                       dst: torch.Tensor):
    """Step-indexed twin of `_critic_loss` for the sparse layout, as a
    function of `r_steps` (B, H + 1, J): rows [0, H) the route-step
    occupancies, row H the destination pseudo-link occupancy.  The (E, J)
    incidence is a linear scatter of the steps onto disjoint entries (greedy
    routes are simple), so d loss / d r_steps is the dense incidence
    gradient gathered along the routes; the incidence never exists."""
    num_links = inst.num_pad_links
    b, n = inst.proc_bws.shape
    dt = _wide(r_steps.dtype, jobs.rate.dtype)
    r_steps = r_steps.to(dt)
    steps, occ_d = r_steps[:, :-1], r_steps[:, -1]                   # (B,H,J), (B,J)
    w = torch.where(jobs.mask, jobs.rate.to(dt) * jobs.ul.to(dt), 0.0)
    seq = seq_slot.long().reshape(b, -1)
    dstl = dst.long()
    link_lambda = torch.zeros((b, num_links), dtype=dt, device=w.device).scatter_add(
        1, seq, (steps * w.unsqueeze(1)).reshape(b, -1))
    node_lambda = torch.where(
        inst.comp_mask,
        torch.zeros((b, n), dtype=dt, device=w.device).scatter_add(1, dstl, occ_d * w),
        0.0)
    link_mu = interference_fixed_point(inst, link_lambda)
    link_delay, node_delay = _unit_delays(inst, link_lambda, link_mu, node_lambda)
    # per-(step, job) delay terms; inactive steps (occupancy 0) give max(0, 0)
    data = jobs.ul.to(dt) + jobs.dl.to(dt)                            # (B, J)
    unit_h = torch.gather(link_delay, 1, seq).view(steps.shape)
    prod = torch.where(steps > 0, unit_h * steps, 0.0)
    term = torch.maximum(data.unsqueeze(1) * prod, steps)
    unit_d = torch.gather(node_delay, 1, dstl)
    prod_d = torch.where(occ_d > 0, unit_d * occ_d, 0.0)
    term_d = torch.maximum(data * prod_d, occ_d)
    return term.sum(dim=(1, 2)) + term_d.sum(dim=1)


def _suffix_bias_grad(inst, jobs, routes: RouteSet, grad_routes: torch.Tensor) -> torch.Tensor:
    """Per-ext-slot gradient (B, E) of the reference's suffix-bias trick:
    job j adds to grad_edge[e_i] the prefix sum of -grad_routes along its
    route up to step i, the destination pseudo-link last.  Gather ->
    cumsum over steps -> one scatter-add; inactive steps gather slot 0 and
    are masked to 0 before both."""
    b, num_slots, num_jobs = grad_routes.shape
    flat = grad_routes.reshape(b, num_slots * num_jobs)
    cols = torch.arange(num_jobs, device=flat.device)
    a = routes.seq_active.to(flat.dtype)                              # (B, H, J)
    idx = (routes.seq_slot.long() * num_jobs + cols).reshape(b, -1)
    picked = torch.gather(flat, 1, idx).view(a.shape) * a
    cum = -torch.cumsum(picked, dim=1)
    grad_edge = torch.zeros_like(flat).scatter_add(1, idx, (cum * a).reshape(b, -1))
    # the final pseudo-link step at the destination
    pidx = (inst.num_pad_links + routes.dst.long()) * num_jobs + cols
    am = jobs.mask.to(flat.dtype)
    cum_end = cum[:, -1] - torch.gather(flat, 1, pidx) * am
    grad_edge = grad_edge.scatter_add(1, pidx, cum_end * am)
    return grad_edge.view(b, num_slots, num_jobs).sum(dim=2)


def _suffix_bias_grad_steps(inst, jobs, routes: RouteSet, grad_steps: torch.Tensor) -> torch.Tensor:
    """`_suffix_bias_grad` from the step-form cotangent (B, H + 1, J), which
    is already the incidence gradient along each route; the scatter lands
    straight in the (B, E) per-slot totals."""
    b = grad_steps.shape[0]
    num_slots = inst.num_pad_links + inst.num_pad_nodes
    dtg = grad_steps.dtype
    a = routes.seq_active.to(dtg)
    picked = grad_steps[:, :-1] * a
    cum = -torch.cumsum(picked, dim=1)
    am = jobs.mask.to(dtg)
    cum_end = cum[:, -1] - grad_steps[:, -1] * am
    pseudo = inst.num_pad_links + routes.dst.long()
    ge = torch.zeros((b, num_slots), dtype=dtg, device=grad_steps.device).scatter_add(
        1, routes.seq_slot.long().reshape(b, -1), (cum * a).reshape(b, -1))
    return ge.scatter_add(1, pseudo, cum_end * am)


def _grad_edge_to_distance(inst, grad_edge: torch.Tensor) -> torch.Tensor:
    """Per-slot gradients (B, E) onto the (B, N, N) distance cotangent: real
    links symmetric off the diagonal, pseudo-links on it."""
    b, n = inst.proc_bws.shape
    num_links = inst.num_pad_links
    u = inst.link_ends[..., 0].long()
    v = inst.link_ends[..., 1].long()
    g_link = torch.where(inst.link_mask, grad_edge[:, :num_links], 0.0)
    diag = torch.where(inst.comp_mask, grad_edge[:, num_links:], 0.0)
    iota = (torch.arange(n, device=grad_edge.device) * (n + 1)).expand(b, n)
    g = torch.zeros((b, n * n), dtype=grad_edge.dtype, device=grad_edge.device)
    g = g.scatter(1, u * n + v, g_link).scatter(1, v * n + u, g_link).scatter(1, iota, diag)
    return g.view(b, n, n)


@phase("forward_backward")
def forward_backward(
    model,
    inst,
    jobs,
    gen: torch.Generator | None = None,
    explore: float = 0.0,
    prob: bool = False,
    mse_weight: float = 0.001,
    critic_weight: float = 1.0,
    layout=None,
    device=None,
    compat_diagonal_bug: bool = False,
) -> TrainStepOutput:
    """One training step's gradients for a batch of B episodes on `device`
    (default CUDA).  Under `layout="sparse"` the instance must be built
    sparse and the model carry the sparse `propagate`.
    `compat_diagonal_bug=True` feeds the decision path the reference's
    cycled node-delay diagonal, as `forward_env` does; the gradients are
    unaffected (JAX `:346-352`)."""
    dev = resolve_device(device)
    lay = resolve_layout(layout)
    model = model.to(dev)
    inst, jobs = inst.to(dev), jobs.to(dev)
    support = default_support(model, inst, lay)
    b = jobs.src.shape[0]

    # --- 1. actor forward with per-episode parameter copies --------------
    params = {name: p.detach().unsqueeze(0).expand((b,) + p.shape).clone().requires_grad_()
              for name, p in model.named_parameters()}
    with torch.enable_grad(), phase("actor_forward"):
        actor = actor_delay_matrix(model, inst, jobs, support, params)
    dmtx = actor.delay_matrix

    # --- 2. decision path on detached values -----------------------------
    with torch.no_grad():
        if compat_diagonal_bug:
            unit_diag = compat_cycled_diagonal(inst, actor.node_delay.detach())
        else:
            unit_diag = torch.diagonal(dmtx.detach(), dim1=1, dim2=2)
        with phase("apsp"):
            sp = shortest_paths(inst, actor.link_delay.detach(), lay)
        with phase("offload_decide"):
            dec = offload_decide(inst, jobs, sp, inst.hop, unit_diag, gen, explore, prob)
        with phase("next_hops"):
            nh = next_hops(inst, sp, lay)
        with phase("trace_routes"):
            routes = trace_routes(inst, nh, jobs, dec.dst, with_inc=not lay.sparse)
        with phase("run_empirical"):
            delays = run_empirical(inst, jobs, routes, lay)

    # --- 3. critic gradient w.r.t. the routes, 4. suffix bias ------------
    with torch.enable_grad(), phase("critic"):
        if lay.sparse:
            wdt = _wide(inst.link_rates.dtype)
            r = torch.cat([routes.seq_active.to(wdt), jobs.mask.to(wdt).unsqueeze(1)],
                          dim=1).requires_grad_()
            loss_critic = _critic_loss_steps(inst, jobs, r, routes.seq_slot, dec.dst)
        else:
            r = routes.inc_ext.to(_wide(routes.inc_ext.dtype)).requires_grad_()
            loss_critic = _critic_loss(inst, jobs, r)
        (grad_r,) = torch.autograd.grad(loss_critic.sum(), r)
    with phase("suffix_bias_mse"):
        if lay.sparse:
            grad_edge = _suffix_bias_grad_steps(inst, jobs, routes, grad_r)
        else:
            grad_edge = _suffix_bias_grad(inst, jobs, routes, grad_r)
        grad_dist = critic_weight * _grad_edge_to_distance(inst, grad_edge)

        # --- 5. MSE supervision on written entries ------------------------
        emp = delays.unit_matrix
        mse_mask = delays.unit_mask & torch.isfinite(emp)
        diff = torch.where(mse_mask, dmtx.detach() - emp, 0.0)
        denom = mse_mask.sum(dim=(1, 2)).clamp_min(1)
        loss_mse = torch.where(mse_mask, diff * diff, 0.0).sum(dim=(1, 2)) / denom
        grad_dist = grad_dist + mse_weight * diff

    # --- pull back through the actor --------------------------------------
    with phase("actor_backward"):
        grads = torch.autograd.grad(dmtx, list(params.values()), grad_outputs=grad_dist)
    return TrainStepOutput(
        grads=dict(zip(params, grads)),
        loss_critic=loss_critic.detach(),
        loss_mse=loss_mse,
        delays=delays,
        routes=routes,
        actor=ActorOutput(delay_matrix=dmtx.detach(), link_delay=actor.link_delay.detach(),
                          node_delay=actor.node_delay.detach(), lam=actor.lam.detach()),
        dst=dec.dst,
    )
