"""The distributed greedy offloading decision as masked tensor math.

Port of `multihop_offload_tpu/env/offloading.py`: each job compares local
compute against every server (uplink and downlink shortest-path delay x data
+ server processing delay, each lower-bounded by hop count / 1) and takes
the argmin.  `torch.argmin` returns the first minimum, as `jnp.argmin`
does, and the padded server list is ascending, so ties break as in the
reference.  Exploration draws come from a `torch.Generator`: the port
cannot reproduce threefry bits, so it agrees with the JAX package bit for
bit at ``explore=0, prob=False`` only.
"""

from __future__ import annotations

import dataclasses

import torch

from multihop_offload_tpu_torch.precision import island_dtype


@dataclasses.dataclass(frozen=True)
class ObjectiveWeights:
    """Energy/cost weights folded into the offloading cost table.

    They bias only the decision; delay scoring downstream stays physical:

      transport_energy  cost per hop per unit of data shipped, charged to
                        the server options as ``w * (hop_ul * ul + hop_dl * dl)``
      compute_energy    remote-compute premium per unit of uplink data,
                        charged flat to every server

    Local compute is the zero-cost reference point.  The default (all-zero)
    is bit-identical to the unweighted objective."""

    transport_energy: float = 0.0
    compute_energy: float = 0.0

    @property
    def is_null(self) -> bool:
        return self.transport_energy == 0.0 and self.compute_energy == 0.0


@dataclasses.dataclass
class OffloadDecision:
    dst: torch.Tensor        # (B, J) int32 chosen compute node (src when local)
    is_local: torch.Tensor   # (B, J) bool
    delay_est: torch.Tensor  # (B, J) predicted delay of the chosen option
    costs: torch.Tensor      # (B, J, S+1) cost table (inf on padded servers)


def _pairs(mat: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    """mat[b, rows[b, j], cols[b, s]] as (B, J, S) for (B, N, N) `mat`."""
    b, n, _ = mat.shape
    idx = rows.long().unsqueeze(2) * n + cols.long().unsqueeze(1)
    return torch.gather(mat.reshape(b, n * n), 1,
                        idx.reshape(b, -1)).view(idx.shape)


def _uniform(shape, gen, dtype, device) -> torch.Tensor:
    """U[0, 1) draws of `shape` from `gen`: one generator, or a list of
    them, each drawing for an equal share of the leading (batch) axis in
    order, so a batch stacked from several callers' rows draws what each
    caller's generator would draw alone."""
    if not isinstance(gen, (list, tuple)):
        return torch.rand(shape, generator=gen, dtype=dtype, device=device)
    rows = shape[0] // len(gen)
    return torch.cat([torch.rand((rows,) + tuple(shape[1:]), generator=g, dtype=dtype,
                                 device=device) for g in gen])


def offload_decide(
    inst,
    jobs,
    sp: torch.Tensor,
    hop: torch.Tensor,
    unit_diag: torch.Tensor,
    gen: torch.Generator | None = None,
    explore: float = 0.0,
    prob: bool = False,
    objective: ObjectiveWeights | None = None,
) -> OffloadDecision:
    """Choose a compute destination per job.

    `sp`/`hop`: (B, N, N) delay / hop matrices with zero diagonal;
    `unit_diag`: (B, N) per-node unit processing delays.  `gen` (a generator, or a
    list of them over equal shares of the batch, `_uniform`) feeds the
    exploration and sampling draws; it is not read at ``explore=0,
    prob=False``."""
    servers = inst.servers                          # (B, S) ascending
    smask = inst.server_mask
    src = jobs.src
    # the decision_costs island: the (J, S) gathers of a bf16 SP matrix are
    # widened and the cost table summed at >= fp32 before the argmin
    dt = island_dtype(sp.dtype, unit_diag.dtype, jobs.ul.dtype)
    ul_d = jobs.ul.to(dt)
    dl_d = jobs.dl.to(dt)
    srcl, srvl = src.long(), servers.long()
    local_delay = torch.gather(unit_diag, 1, srcl).to(dt) * ul_d          # (B, J)
    ul = _pairs(sp, src, servers).to(dt) * ul_d.unsqueeze(2)            # (B, J, S)
    dl = _pairs(sp.transpose(1, 2), src, servers).to(dt) * dl_d.unsqueeze(2)
    proc = torch.gather(unit_diag, 1, srvl).to(dt).unsqueeze(1) * ul_d.unsqueeze(2)
    # lower bounds: hop counts for transport, 1 for processing
    ul = torch.maximum(ul, _pairs(hop, src, servers).to(dt))
    dl = torch.maximum(dl, _pairs(hop.transpose(1, 2), src, servers).to(dt))
    proc = torch.clamp(proc, min=1.0)
    server_delays = ul + dl + proc
    if objective is not None and not objective.is_null:
        # penalize the server options by shipped data x hop distance and a
        # flat remote-compute premium; local stays unpenalized
        hop_ul = _pairs(hop, src, servers).to(dt)
        hop_dl = _pairs(hop.transpose(1, 2), src, servers).to(dt)
        server_delays = server_delays + (
            objective.transport_energy
            * (hop_ul * ul_d.unsqueeze(2) + hop_dl * dl_d.unsqueeze(2))
            + objective.compute_energy * ul_d.unsqueeze(2))

    inf = torch.full((), float("inf"), dtype=dt, device=sp.device)
    server_delays = torch.where(smask.unsqueeze(1), server_delays, inf)
    costs = torch.cat([server_delays, local_delay.unsqueeze(2)], dim=2)

    greedy = torch.argmin(costs, dim=2)
    jidx = greedy
    if prob or explore > 0:
        b, j, k = costs.shape
        valid = torch.cat([smask, torch.ones_like(smask[:, :1])], dim=1)
        valid = valid.unsqueeze(1).expand(b, j, k)

        def gumbel_argmax(logits):
            u = _uniform(logits.shape, gen, dt, logits.device)
            g = -torch.log(-torch.log(u.clamp_min(torch.finfo(dt).tiny)))
            return torch.argmax(logits + g, dim=2)

        # softmax over raw costs (higher cost => higher probability, the
        # reference's verbatim rule), as a Gumbel-max draw
        base = gumbel_argmax(torch.where(valid, costs, -inf)) if prob else greedy
        # epsilon-greedy: uniform over the valid options incl. local
        zero = torch.zeros((), dtype=dt, device=costs.device)
        uniform = gumbel_argmax(torch.where(valid, zero, -inf))
        do_explore = _uniform((b, j), gen, dt, costs.device) < explore
        jidx = torch.where(do_explore, uniform, base)

    num_slots = servers.shape[1]
    is_local = jidx >= num_slots
    picked = torch.gather(srvl, 1, jidx.clamp(0, num_slots - 1))
    dst = torch.where(is_local, srcl, picked)
    delay_est = torch.gather(costs, 2, jidx.unsqueeze(2)).squeeze(2)
    return OffloadDecision(dst=dst.to(torch.int32), is_local=is_local,
                           delay_est=delay_est, costs=costs)
