"""Contention-coupled M/M/1 queueing model — the empirical evaluator.

Port of `multihop_offload_tpu/env/queueing.py`: per-link arrival rates from the realized routes, the
10-iteration interference fixed point (K1, `ops.fixed_point`), per-(link,
job) delays with the congestion fallback, per-job server delays, and the
(N, N) empirical unit-delay matrix with last-write-wins job order.

Under `layout="sparse"` the (L, J) incidence is never read: link arrival
rates scatter-add over the route steps (`seq_slot`/`seq_active`), the
per-job link delays gather the per-link quantities at each step
(`:150-161`, `:178-191`), and the last writer of each link is a segment-max
of job ids over the steps (`:223-243`).

The fixed point (`:76-125`) takes JAX's `fp_fn` (the `fp_impl` knob,
`ops.fixed_point.resolve_fixed_point`).  Under the sparse layout with no
`fp_fn` it runs as JAX's does there: ten rounds of a segment-sum over the
conflict list `inst.sparse.cf` (`ops.sparse.coo_matmul`: each row's run
of the list summed in list order, the same bits on every call on the
card), never reading `adj_conflict`.  Otherwise it is `fp_fn` or, given
none on the dense layout, `ops.fixed_point.fixed_point` (K1, or the
scan above L=928), which computes the function of JAX's XLA scan.

Last write wins: the JAX dense path scans the jobs in order; here the
winner of each link (node) is the highest job index among its writers, and
its value is read from the same per-(link, job) table the scan reads —
the same values from the same floating-point operations, with no loop over
jobs.

Sums of floats over jobs (`server_load`) scatter-add; on the card that is
atomic and unordered, so card and CPU agree to rounding only.
"""

from __future__ import annotations

import dataclasses

import torch

from multihop_offload_tpu_torch.layouts.policy import resolve_layout
from multihop_offload_tpu_torch.ops.fixed_point import fixed_point
from multihop_offload_tpu_torch.ops.sparse import COO, RowRuns, coo_matmul
from multihop_offload_tpu_torch.precision import island_dtype


@dataclasses.dataclass
class EmpiricalDelays:
    job_total: torch.Tensor    # (B, J) link + server delay per job (0 if padded)
    job_link: torch.Tensor     # (B, J) transport component
    job_server: torch.Tensor   # (B, J) compute component
    congested: torch.Tensor    # (B, J) bool: total > T (real jobs only)
    link_lambda: torch.Tensor  # (B, L) aggregate link arrival rates
    link_mu: torch.Tensor      # (B, L) converged service rates
    server_load: torch.Tensor  # (B, N) aggregate server arrival rates
    unit_matrix: torch.Tensor  # (B, N, N) empirical unit delays (0 unwritten)
    unit_mask: torch.Tensor    # (B, N, N) bool: entry written by some flow


def interference_fixed_point(inst, link_lambda: torch.Tensor, num_iters: int = 10,
                             fp_fn=None, layout=None) -> torch.Tensor:
    """Converged per-link service rates mu (B, L) under conflict coupling:
    mu_0 = rate/(cf+1); 10x busy = clip(lambda/mu, 0, 1),
    mu = rate/(1 + A_conflict @ busy).  `fp_fn` replaces the dense core
    (`resolve_fixed_point`); under the sparse layout with none, A @ busy
    is the segment-sum over `inst.sparse.cf`."""
    # the fixed_point island: every operand >= fp32
    dt = island_dtype(link_lambda.dtype, inst.link_rates.dtype)
    if fp_fn is None and resolve_layout(layout).sparse and inst.sparse is not None:
        cf = inst.sparse.cf
        runs = RowRuns(cf)
        rates = inst.link_rates.to(dt)
        lam = link_lambda.to(dt)
        cf_dt = COO(rows=cf.rows, cols=cf.cols, vals=cf.vals.to(dt), shape=cf.shape)
        mu = rates / (inst.cf_degs.to(dt) + 1.0)
        for _ in range(num_iters):
            busy = torch.clamp(lam / mu, 0.0, 1.0)
            neighbor = coo_matmul(cf_dt, busy.unsqueeze(-1), runs).squeeze(-1)
            mu = rates / (1.0 + neighbor)
        return mu
    return (fp_fn or fixed_point)(
        inst.adj_conflict.to(dt).contiguous(), inst.link_rates.to(dt).contiguous(),
        inst.cf_degs.to(dt).contiguous(), link_lambda.to(dt).contiguous(), num_iters)


def _highest_writer(written: torch.Tensor) -> torch.Tensor:
    """Index of the last True along the last axis, -1 where none."""
    idx = torch.arange(written.shape[-1], device=written.device, dtype=torch.long)
    return torch.where(written, idx, -1).amax(dim=-1)


def run_empirical(inst, jobs, routes, layout=None, fp_fn=None) -> EmpiricalDelays:
    sparse = resolve_layout(layout).sparse
    num_links = inst.num_pad_links
    b, n, _ = inst.adj.shape
    dev = inst.adj.device
    inc_dt = routes.inc_ext.dtype if routes.inc_ext is not None else inst.link_rates.dtype
    # the delay_reduction island: bf16 routes and rates in, >= fp32 delays out
    dt = island_dtype(inc_dt, jobs.rate.dtype, inst.link_rates.dtype)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    jmask = jobs.mask
    num_jobs = jmask.shape[1]
    ul = jobs.ul.to(dt)
    dl = jobs.dl.to(dt)
    nhop = routes.nhop.to(dt)
    ul_rate = ul * jobs.rate.to(dt)
    dl_rate = dl * jobs.rate.to(dt)
    T = inst.T.to(dt)
    dst = routes.dst.long()

    if sparse:
        # route-step form: (B, H, J) link ids and activity, no (L, J) incidence
        seq = routes.seq_slot.long().reshape(b, -1)                 # (B, H*J)
        act = routes.seq_active
        step_rate = torch.where(act, (ul_rate + dl_rate).unsqueeze(1), zero)
        link_lambda = torch.zeros((b, num_links), dtype=dt, device=dev).scatter_add_(
            1, seq, step_rate.reshape(b, -1))
    else:
        inc = routes.inc_ext[:, :num_links].to(dt)                   # (B, L, J)
        link_lambda = torch.matmul(inc, (ul_rate + dl_rate).unsqueeze(-1)).squeeze(-1)
    server_load = torch.zeros((b, n), dtype=dt, device=dev).scatter_add_(
        1, dst, torch.where(jmask, ul_rate, zero))

    link_mu = interference_fixed_point(inst, link_lambda, fp_fn=fp_fn, layout=layout)

    # per-(link, job) unit delay with per-job congestion fallback
    slack = link_mu - link_lambda
    congested_l = slack <= 0.0
    unit_ok = 1.0 / torch.where(congested_l, one, slack)
    if sparse:
        shape = act.shape                                           # (B, H, J)
        lam_h = torch.gather(link_lambda, 1, seq).view(shape)
        mu_h = torch.gather(link_mu, 1, seq).view(shape)
        unit_h = torch.where(
            torch.gather(congested_l, 1, seq).view(shape),
            T[:, None, None] * lam_h / ((ul + dl).unsqueeze(1) * mu_h),
            torch.gather(unit_ok, 1, seq).view(shape))
        d_ul = torch.maximum(ul.unsqueeze(1) * unit_h, nhop.unsqueeze(1))
        d_dl = torch.maximum(dl.unsqueeze(1) * unit_h, nhop.unsqueeze(1))
        job_link = torch.where(act, d_ul + d_dl, zero).sum(dim=1)
    else:
        unit_cong = T[:, None, None] * link_lambda.unsqueeze(2) / (
            (ul + dl).unsqueeze(1) * link_mu.unsqueeze(2))
        unit_lj = torch.where(congested_l.unsqueeze(2), unit_cong,
                              unit_ok.unsqueeze(2))                  # (B, L, J)
        d_ul = torch.maximum(ul.unsqueeze(1) * unit_lj, nhop.unsqueeze(1))
        d_dl = torch.maximum(dl.unsqueeze(1) * unit_lj, nhop.unsqueeze(1))
        # untraversed (link, job) pairs may hold inf/NaN: mask, don't multiply
        job_link = torch.where(inc > 0, d_ul + d_dl, zero).sum(dim=1)

    # server component
    bw = torch.gather(inst.proc_bws, 1, dst).to(dt)
    sload = torch.gather(server_load, 1, dst)
    s_slack = bw - sload
    s_cong = s_slack <= 0.0
    unit_s = torch.where(
        s_cong,
        T[:, None] * sload / (ul * torch.where(bw > 0, bw, one)),
        1.0 / torch.where(s_cong, one, s_slack),
    )
    job_server = torch.clamp(ul * unit_s, min=1.0)

    job_link = torch.where(jmask, job_link, zero)
    job_server = torch.where(jmask, job_server, zero)
    total = job_link + job_server

    # ---- empirical unit-delay matrix, last-write-wins over job order -------
    jidx = torch.arange(num_jobs, device=dev, dtype=torch.long).expand(b, num_jobs)
    if sparse:
        # the winner's unit delay recomputed from the per-link scalars
        # (identical to the dense table's entry at that column)
        writers = torch.where(act, jidx.unsqueeze(1), -1).reshape(b, -1)
        jwin = torch.full((b, num_links), -1, dtype=torch.long, device=dev).scatter_reduce_(
            1, seq, writers, reduce="amax")
        jw = jwin.clamp_min(0)
        u_link = torch.where(
            congested_l,
            T[:, None] * link_lambda / (torch.gather(ul + dl, 1, jw) * link_mu),
            unit_ok)
    else:
        jwin = _highest_writer(inc > 0)                              # (B, L)
        u_link = torch.gather(unit_lj, 2, jwin.clamp_min(0).unsqueeze(2)).squeeze(2)
    link_written = jwin >= 0
    nwin = torch.full((b, n), -1, dtype=torch.long, device=dev).scatter_reduce_(
        1, dst, torch.where(jmask, jidx, -1), reduce="amax")
    node_written = nwin >= 0
    u_node = torch.gather(unit_s, 1, nwin.clamp_min(0))

    u = inst.link_ends[..., 0].long()
    v = inst.link_ends[..., 1].long()
    vals = torch.where(link_written, u_link, zero)
    # real links have u < v, so the (u, v) and (v, u) writes never overlap;
    # padded links all land on (0, 0) with value 0, which the diagonal
    # write below replaces
    unit_matrix = torch.zeros((b, n * n), dtype=dt, device=dev)
    unit_matrix.scatter_(1, u * n + v, vals)
    unit_matrix.scatter_(1, v * n + u, torch.maximum(zero, vals))
    diag = torch.arange(n, device=dev, dtype=torch.long) * (n + 1)
    unit_matrix[:, diag] = torch.where(node_written, u_node, zero)
    unit_mask = torch.zeros((b, n * n), dtype=torch.bool, device=dev)
    unit_mask.scatter_(1, u * n + v, link_written)
    unit_mask.scatter_(1, v * n + u, link_written)
    unit_mask[:, diag] = node_written

    return EmpiricalDelays(
        job_total=total,
        job_link=job_link,
        job_server=job_server,
        congested=(total > T[:, None]) & jmask,
        link_lambda=link_lambda,
        link_mu=link_mu,
        server_load=server_load,
        unit_matrix=unit_matrix.view(b, n, n),
        unit_mask=unit_mask.view(b, n, n),
    )
