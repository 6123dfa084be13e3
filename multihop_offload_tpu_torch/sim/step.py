"""One slot of the packet simulator, as fixed-shape masked tensor math.

Port of `multihop_offload_tpu/sim/step.py`, batched over a leading fleet
axis B (JAX runs one lane under `vmap`; here every gather and scatter
carries the lane).  Per slot, in order, all on the slot-start state:

1. link scheduling: up links with backlog contend; greedy MWIS on the
   conflict graph (`env.scheduling.local_greedy_mwis`) with backlog plus
   uniform jitter as weights picks a conflict-free set, and a scheduled
   link completes its head-of-line packet with probability ``rate * dt``
   (the older head of its two direction queues first);
2. server drain: node ``i`` completes ``floor(bw*dt) +
   Bernoulli(frac(bw*dt))`` packets, capped by its queue; uplink packets
   completing service are delivered;
3. forwarding: a completed link packet exits at the link's far end and is
   delivered (downlink at its destination), joins the destination's
   server queue (uplink), or takes the policy's next hop; an invalid next
   hop (failed link, unreachable destination) drops it;
4. arrivals: one Bernoulli packet per stream and slot;
5. enqueue: forwarded packets and arrivals are appended FIFO, racing
   packets ordered (links by id, then streams by id) by a one-hot rank
   cumsum; appends beyond `cap` are dropped.  Masked writes land in the
   scratch row Q, which nothing reads.

The slot's four uniform draws come in as tensors, in the order of JAX's
`jax.random.split(key, 4)`: `tie` (B, L), `link` (B, L), `srv` (B, N),
`arr` (B, 2J).

Index semantics: JAX counts a negative gather index from the end and
clamps one out of range; torch raises.  Every index read from the routes
or the tables (a destination, the next hop, the link it names, the
target queue) is compared as it is and gathers through `_jax_index`,
JAX's rule, so the step computes what the JAX step computes for any
table.  Scatter targets are built in range (the scratch row Q included).
"""

from __future__ import annotations

import torch

from multihop_offload_tpu_torch.env.scheduling import local_greedy_mwis
from multihop_offload_tpu_torch.obs.devmetrics import DevMetrics, pow2_buckets
from multihop_offload_tpu_torch.sim.state import (
    SimParams,
    SimRoutes,
    SimSpec,
    SimState,
    liveness_masks,
)

# Devmetric keys (the declaration's labels are part of the key).  The three
# drop reasons partition `SimState.dropped`: per packet, `drop_l`,
# `drop_a` and `put & ~space_ok` are mutually exclusive.
DM_GENERATED = "mho_dev_sim_packets_generated_total"
DM_DELIVERED = "mho_dev_sim_packets_delivered_total"
DM_DROP_FWD = "mho_dev_sim_dropped_total{reason=no_route_forward}"
DM_DROP_ARR = "mho_dev_sim_dropped_total{reason=no_route_arrival}"
DM_DROP_CAP = "mho_dev_sim_dropped_total{reason=capacity}"
DM_FWD_LINK = "mho_dev_sim_forwarded_total{target=link}"
DM_FWD_SERVER = "mho_dev_sim_forwarded_total{target=server}"
DM_QUEUE_DEPTH = "mho_dev_sim_queue_depth"
DM_NONFINITE = "mho_dev_sim_nonfinite_total"


def sim_devmetrics(spec: SimSpec) -> DevMetrics:
    """Declare the slot loop's device metrics (frozen)."""
    dm = DevMetrics()
    dm.counter(DM_GENERATED, "packets born, counted in-program per slot")
    dm.counter(DM_DELIVERED, "packets delivered (server drain + downlink at destination)")
    for reason in ("no_route_forward", "no_route_arrival", "capacity"):
        dm.counter("mho_dev_sim_dropped_total", "packets dropped, by reason", reason=reason)
    for target in ("link", "server"):
        dm.counter("mho_dev_sim_forwarded_total",
                   "completed link packets re-enqueued, by next-hop target",
                   target=target)
    dm.histogram(DM_QUEUE_DEPTH, pow2_buckets(spec.cap),
                 "per-slot occupancy of every live queue (links + servers)")
    dm.counter(DM_NONFINITE,
               "per-stream non-finite sim accumulators/probabilities, "
               "counted in-program per slot")
    return dm.freeze()


def _jax_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """JAX's gather index: a negative index counts from the end, and an
    index still out of [0, size) is clamped into it."""
    return torch.where(idx < 0, idx + size, idx).clamp(0, size - 1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, ...]] for (B, S) x and in-range int64 idx (B, ...)."""
    return torch.gather(x, 1, idx.reshape(idx.shape[0], -1)).view(idx.shape)


def _take2(x: torch.Tensor, i: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """x[b, i[b, k], j[b, k]] for (B, R, S) x and in-range int64 i, j."""
    b, _, s = x.shape
    return torch.gather(x.reshape(b, -1), 1, i * s + j)


def sim_slot_step(
    inst,
    spec: SimSpec,
    params: SimParams,
    routes: SimRoutes,
    jobs,
    state: SimState,
    draws,
    dm: DevMetrics | None = None,
    dev: dict | None = None,
):
    """Advance the fleet one slot with `draws` = (tie, link, srv, arr);
    returns (state', scheduled (B, L) bool), and with `dm`/`dev` (a
    `sim_devmetrics` declaration and its accumulators) a third element,
    the updated accumulators (tensor operations only)."""
    num_links, n, j = spec.num_links, spec.num_nodes, spec.num_jobs
    c, q = spec.cap, spec.num_queues
    i32 = torch.int32
    fdt = state.delay_sum.dtype
    u_tie, u_link, u_srv, u_arr = draws
    b = state.t.shape[0]
    device = state.t.device
    t = state.t.unsqueeze(1)                                  # (B, 1)

    node_up, link_up = liveness_masks(inst, params, state.t)
    u_end = inst.link_ends[..., 0].long()
    v_end = inst.link_ends[..., 1].long()
    lidx = torch.arange(num_links, device=device, dtype=torch.long)

    q_busy = state.q_busy + (state.count > 0).to(i32)

    # ---- 1. undirected link schedule + geometric completion ----------------
    cnt_f, cnt_b = state.count[:, :num_links], state.count[:, num_links:2 * num_links]
    backlog = cnt_f + cnt_b
    contend = (backlog > 0) & link_up
    zero = torch.zeros((), dtype=fdt, device=device)
    wts = torch.where(contend, backlog.to(fdt) + u_tie, zero)
    sched, _ = local_greedy_mwis(inst.adj_conflict, wts, mask=contend)
    complete = sched & (u_link < params.link_srv_p)
    head_f = state.head[:, :num_links].long()
    head_b = state.head[:, num_links:2 * num_links].long()
    enq_f = _take2(state.buf_enq, lidx.expand(b, -1), head_f)
    enq_b = _take2(state.buf_enq, (lidx + num_links).expand(b, -1), head_b)
    both = (cnt_f > 0) & (cnt_b > 0)
    use_f = torch.where(both, enq_f <= enq_b, cnt_f > 0)
    src_q = torch.where(use_f, lidx, lidx + num_links)         # (B, L)
    exit_node = torch.where(use_f, v_end, u_end)

    hq = _take(state.head, src_q).long()
    s_l = _take2(state.buf_stream, src_q, hq)
    birth_l = _take2(state.buf_birth, src_q, hq)
    enq_l = _take2(state.buf_enq, src_q, hq)

    sq_w = torch.where(complete, src_q, q)                      # scratch-masked
    ones_l = torch.ones_like(sq_w, dtype=i32)
    head = state.head.scatter_add(1, sq_w, ones_l) % c
    count = state.count.scatter_add(1, sq_w, -ones_l)
    q_sojourn = state.q_sojourn.scatter_add(1, sq_w, (t - enq_l).to(fdt))
    q_served = state.q_served.scatter_add(1, sq_w, ones_l)
    sched_slots = state.sched_slots + sched.to(i32)

    # ---- 2. server drain ---------------------------------------------------
    s0, s1 = 2 * num_links, 2 * num_links + n
    scnt = state.count[:, s0:s1]
    base = torch.floor(params.srv_rate).to(i32)
    frac = params.srv_rate - base.to(params.srv_rate.dtype)
    ndraw = base + (u_srv < frac).to(i32)
    nserve = torch.where(node_up, torch.minimum(scnt, ndraw), 0)
    arange_c = torch.arange(c, device=device, dtype=torch.long)
    posm = (state.head[:, s0:s1].long().unsqueeze(2) + arange_c) % c        # (B, N, C)
    smask = arange_c < nserve.unsqueeze(2)
    s_srv = state.buf_stream[:, s0:s1].gather(2, posm)
    birth_srv = state.buf_birth[:, s0:s1].gather(2, posm)
    enq_srv = state.buf_enq[:, s0:s1].gather(2, posm)
    # masked scatter-adds: garbage stream ids are in range, their value 0
    sf = s_srv.reshape(b, -1).long()
    mf = smask.reshape(b, -1)
    delivered = state.delivered.scatter_add(1, sf, mf.to(i32))
    delay_sum = state.delay_sum.scatter_add(
        1, sf, (t.unsqueeze(2) - birth_srv).to(fdt).reshape(b, -1) * mf.to(fdt))
    srv_soj = ((t.unsqueeze(2) - enq_srv).to(fdt) * smask.to(fdt)).sum(dim=2)
    pad = torch.zeros((b, 2 * num_links), dtype=i32, device=device)
    scratch = torch.zeros((b, 1), dtype=i32, device=device)
    served_rows = torch.cat([pad, nserve, scratch], dim=1)      # (B, Q + 1)
    q_sojourn = q_sojourn + torch.cat([pad.to(fdt), srv_soj, scratch.to(fdt)], dim=1)
    q_served = q_served + served_rows
    head = (head + served_rows) % c
    count = count - served_rows

    # ---- 3. forward completed link packets ---------------------------------
    # raw values for comparisons, JAX-rule indices (`_jax_index`) for gathers
    dests = torch.cat([routes.dst.long(), jobs.src.long()], dim=1)            # (B, 2J)
    s_ll = s_l.long()
    d_l = _take(dests, s_ll)
    d_li = _jax_index(d_l, n)
    at_dest = exit_node == d_l
    is_ul = s_ll < j
    deliver_now = complete & at_dest & ~is_ul
    delivered = delivered.scatter_add(1, s_ll, deliver_now.to(i32))
    delay_sum = delay_sum.scatter_add(1, s_ll, (t - birth_l).to(fdt) * deliver_now.to(fdt))
    fw = complete & ~deliver_now
    nxt = _jax_index(_take2(routes.next_hop, exit_node, d_li).long(), n)
    tgt_link = _take2(inst.link_index, exit_node, nxt).long()
    tl_i = _jax_index(tgt_link, num_links)
    edge_ok = _take2(inst.adj, exit_node, nxt) > 0
    dirq = tgt_link + num_links * (exit_node != _take(u_end, tl_i)).long()
    to_server = at_dest & is_ul
    tgt_q = torch.where(to_server, 2 * num_links + exit_node, dirq)
    ok_l = torch.where(
        to_server,
        _take(node_up, exit_node),
        edge_ok & _take(link_up, tl_i) & _take2(routes.reach, exit_node, d_li),
    )
    put_l = fw & ok_l
    drop_l = fw & ~ok_l

    # ---- 4. arrivals -------------------------------------------------------
    src = jobs.src.long()
    origin = torch.cat([src, routes.dst.long()], dim=1)                      # (B, 2J)
    origin_i, dests_i = _jax_index(origin, n), _jax_index(dests, n)
    offloaded = routes.dst.long() != src
    gen_p = (
        params.arr_p
        * _take(node_up, origin_i).to(fdt)
        * _take(node_up, dests_i).to(fdt)
        # downlink streams exist only for offloaded jobs
        * torch.cat([torch.ones((b, j), dtype=fdt, device=device), offloaded.to(fdt)], dim=1)
    )
    gen = u_arr < gen_p
    generated = state.generated + gen.to(i32)
    local_entry = origin == dests                             # ul of local jobs
    nxt_a = _jax_index(_take2(routes.next_hop, origin_i, dests_i).long(), n)
    tl_a = _take2(inst.link_index, origin_i, nxt_a).long()
    tl_ai = _jax_index(tl_a, num_links)
    edge_ok_a = _take2(inst.adj, origin_i, nxt_a) > 0
    dirq_a = tl_a + num_links * (origin != _take(u_end, tl_ai)).long()
    tgt_a = torch.where(local_entry, 2 * num_links + origin, dirq_a)
    ok_a = torch.where(
        local_entry,
        _take(node_up, origin_i),
        edge_ok_a & _take(link_up, tl_ai) & _take2(routes.reach, origin_i, dests_i),
    )
    put_a = gen & ok_a
    drop_a = gen & ~ok_a

    # ---- 5. ordered batched enqueue with capacity drops --------------------
    m = num_links + 2 * j
    tgt = torch.cat([tgt_q, tgt_a], dim=1)                                   # (B, M)
    tgt_i = _jax_index(tgt, q)
    put = torch.cat([put_l, put_a], dim=1)
    strm = torch.cat([s_l, torch.arange(2 * j, dtype=state.buf_stream.dtype,
                                        device=device).expand(b, -1)], dim=1)
    births = torch.cat([birth_l, t.expand(b, 2 * j)], dim=1)
    onehot = put.unsqueeze(2) & (tgt.unsqueeze(2) == torch.arange(q, device=device, dtype=torch.long))
    rank = torch.cumsum(onehot.to(i32), dim=1).gather(2, tgt_i.unsqueeze(2)).squeeze(2) - 1
    count_t = _take(count, tgt_i)
    space_ok = count_t + rank < c
    final_put = put & space_ok
    cap_drop = put & ~space_ok
    dropped = state.dropped.scatter_add(
        1, strm.long(), (torch.cat([drop_l, drop_a], dim=1) | cap_drop).to(i32))
    pos = (_take(head, tgt_i) + count_t + rank).long() % c
    row = torch.where(final_put, tgt, q)                        # scratch-masked
    flat = row * c + pos
    buf_stream = state.buf_stream.reshape(b, -1).scatter(1, flat, strm).view_as(state.buf_stream)
    buf_birth = state.buf_birth.reshape(b, -1).scatter(1, flat, births).view_as(state.buf_birth)
    buf_enq = state.buf_enq.reshape(b, -1).scatter(1, flat, t.expand(b, m)).view_as(
        state.buf_enq)
    ones_m = torch.ones_like(row, dtype=i32)
    count = count.scatter_add(1, row, ones_m)
    q_arrived = state.q_arrived.scatter_add(1, row, ones_m)

    new_state = SimState(
        buf_stream=buf_stream, buf_birth=buf_birth, buf_enq=buf_enq,
        head=head, count=count,
        generated=generated, delivered=delivered, dropped=dropped,
        delay_sum=delay_sum,
        q_sojourn=q_sojourn, q_served=q_served, q_busy=q_busy,
        q_arrived=q_arrived, sched_slots=sched_slots,
        t=state.t + 1,
    )
    if dm is None:
        return new_state, sched
    # slot-start depths of every live queue (scratch row excluded)
    dev = dm.observe(dev, DM_QUEUE_DEPTH, state.count[:, :q])
    dev = dm.inc(dev, DM_GENERATED, gen)
    dev = dm.inc(dev, DM_DELIVERED, nserve)
    dev = dm.inc(dev, DM_DELIVERED, deliver_now)
    dev = dm.inc(dev, DM_DROP_FWD, drop_l)
    dev = dm.inc(dev, DM_DROP_ARR, drop_a)
    dev = dm.inc(dev, DM_DROP_CAP, cap_drop)
    dev = dm.inc(dev, DM_FWD_LINK, put_l & ~to_server)
    dev = dm.inc(dev, DM_FWD_SERVER, put_l & to_server)
    # numeric sentinel: a poisoned rate that slipped past admission shows
    # up as a non-finite arrival probability or delay accumulator
    dev = dm.inc(dev, DM_NONFINITE, ~torch.isfinite(gen_p) | ~torch.isfinite(delay_sum))
    return new_state, sched, dev
