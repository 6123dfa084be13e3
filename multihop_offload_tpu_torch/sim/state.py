"""Simulator state: fixed-capacity ring-buffer queues and counters.

Port of `multihop_offload_tpu/sim/state.py`; every record carries a
leading fleet axis B where the JAX package runs one lane under `vmap`.
One network carries ``Q = 2L + N`` FIFO queues: queue ``l in [0, L)`` is
link ``l`` in its canonical u -> v direction, ``L + l`` the reverse
direction (the channel is shared, but forwarding needs the exit
endpoint), and ``2L + i`` node ``i``'s server queue.  Each queue is a ring
buffer of `cap` packet records (stream id, stream-birth slot,
queue-entry slot); one extra scratch row Q takes the masked-out writes,
and nothing ever reads it.

Streams: job ``j`` has an uplink stream (id ``j``, src -> dst -> server)
and a downlink stream (id ``J + j``, dst -> src), the flow decomposition
of the analytic M/M/1 model (`env.queueing.run_empirical`).  One slot is
``dt`` model time units; `build_sim_params` sizes it so that every
per-slot probability is a valid Bernoulli parameter.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multihop_offload_tpu_torch._records import TensorRecord
from multihop_offload_tpu_torch.graphs.instance import numpy_dtype
from multihop_offload_tpu_torch.layouts.compact import compact_index_dtype

_INDEX_DTYPE = {np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64}


@dataclasses.dataclass(frozen=True)
class SimSpec:
    """Static sizes of a simulated fleet."""

    num_links: int      # L (padded)
    num_nodes: int      # N (padded)
    num_jobs: int       # J (padded)
    cap: int = 64       # ring-buffer capacity per queue

    @property
    def num_queues(self) -> int:
        return 2 * self.num_links + self.num_nodes

    @property
    def num_streams(self) -> int:
        return 2 * self.num_jobs


@dataclasses.dataclass
class SimParams(TensorRecord):
    """Per-instance dynamics (tensors).  A failure slot of -1 means the
    link or node never fails."""

    dt: torch.Tensor              # () slot duration in model time units
    link_srv_p: torch.Tensor      # (L,) per-slot completion prob of a held link
    srv_rate: torch.Tensor        # (N,) expected server completions per slot
    arr_p: torch.Tensor           # (2J,) per-slot packet-arrival prob per stream
    fail_link_slot: torch.Tensor  # (L,) int32 slot the link dies (-1 = never)
    fail_node_slot: torch.Tensor  # (N,) int32 slot the node dies (-1 = never)


@dataclasses.dataclass
class SimRoutes(TensorRecord):
    """The policy's routing decision, fixed between policy rounds."""

    dst: torch.Tensor       # (B, J) int32 compute destination per job
    next_hop: torch.Tensor  # (B, N, N) int16 greedy forwarding table
    reach: torch.Tensor     # (B, N, N) bool: destination reachable from node


@dataclasses.dataclass
class SimState(TensorRecord):
    """All mutable simulator state of a fleet (leading axis B)."""

    # ring buffers, (B, Q + 1, cap): row Q is the masked-write scratch row
    buf_stream: torch.Tensor  # int16 stream id of each stored packet
    buf_birth: torch.Tensor   # int32 slot the packet entered the network
    buf_enq: torch.Tensor     # int32 slot the packet entered THIS queue
    head: torch.Tensor        # (B, Q + 1) int32 ring head index
    count: torch.Tensor       # (B, Q + 1) int32 packets stored
    # conservation counters per stream (B, 2J)
    generated: torch.Tensor   # int32 packets born (incl. dropped at entry)
    delivered: torch.Tensor   # int32 packets that completed their journey
    dropped: torch.Tensor     # int32 packets lost (full queue / no route)
    delay_sum: torch.Tensor   # float end-to-end slots summed over delivered
    # per-queue service statistics (B, Q + 1)
    q_sojourn: torch.Tensor   # float sum of (dequeue - enqueue) slots
    q_served: torch.Tensor    # int32 packets dequeued
    q_busy: torch.Tensor      # int32 slots with a nonempty queue
    q_arrived: torch.Tensor   # int32 packets enqueued
    sched_slots: torch.Tensor  # (B, L) int32 slots each link won the schedule
    t: torch.Tensor           # (B,) int32 current slot


def init_state(spec: SimSpec, fleet: int = 1, dtype=torch.float32,  # fp32-island(delay accumulators: bf16 drops +1 past 256)
               device="cpu") -> SimState:
    """Empty queues and zero counters for `fleet` lanes.  Stream ids are
    stored in the narrowest index dtype for [0, 2J) (int16 in practice);
    the delay accumulators in `dtype`."""
    q1 = spec.num_queues + 1
    c = spec.cap
    s = spec.num_streams
    i32 = torch.int32
    sdt = _INDEX_DTYPE[np.dtype(compact_index_dtype(max(s - 1, 0)))]

    def z(*shape, dt=i32):
        return torch.zeros((fleet,) + shape, dtype=dt, device=device)

    return SimState(
        buf_stream=z(q1, c, dt=sdt), buf_birth=z(q1, c), buf_enq=z(q1, c),
        head=z(q1), count=z(q1),
        generated=z(s), delivered=z(s), dropped=z(s), delay_sum=z(s, dt=dtype),
        q_sojourn=z(q1, dt=dtype), q_served=z(q1), q_busy=z(q1), q_arrived=z(q1),
        sched_slots=z(spec.num_links), t=z(),
    )


def spec_for(inst, jobs, cap: int = 64) -> SimSpec:
    return SimSpec(num_links=inst.num_pad_links, num_nodes=inst.num_pad_nodes,
                   num_jobs=int(jobs.src.shape[-1]), cap=cap)


def build_sim_params(
    inst,
    jobs,
    dt: float | None = None,
    margin: float = 1.25,
    fail_link_slot: np.ndarray | None = None,
    fail_node_slot: np.ndarray | None = None,
) -> SimParams:
    """Slot-level probabilities of one (unbatched) instance from its
    model-time rates, on the instance's device, in its float dtype.

    `dt` defaults to ``1 / (margin * max real link rate)``, so that the
    busiest link completes a packet per slot with probability
    ``1/margin < 1``: the geometric approximation of an exponential server
    holds only below 1 (servers may complete several packets a slot)."""
    rates = inst.link_rates.cpu().numpy().astype(np.float64)
    mask = inst.link_mask.cpu().numpy()
    real_max = float(rates[mask].max()) if mask.any() else 1.0
    if dt is None:
        dt = 1.0 / (margin * max(real_max, 1e-9))
    dt = float(dt)
    link_srv_p = np.where(mask, np.clip(rates * dt, 0.0, 1.0), 0.0)
    srv_rate = inst.proc_bws.cpu().numpy().astype(np.float64) * dt

    rate = jobs.rate.cpu().numpy().astype(np.float64)
    ul = jobs.ul.cpu().numpy().astype(np.float64)
    dl = jobs.dl.cpu().numpy().astype(np.float64)
    jmask = jobs.mask.cpu().numpy()
    arr_ul = np.where(jmask, rate * ul * dt, 0.0)
    arr_dl = np.where(jmask, rate * dl * dt, 0.0)
    arr_p = np.clip(np.concatenate([arr_ul, arr_dl]), 0.0, 1.0)

    num_links = rates.shape[0]
    n = srv_rate.shape[0]
    fls = (np.full((num_links,), -1, np.int32) if fail_link_slot is None
           else np.asarray(fail_link_slot, np.int32))
    fns = (np.full((n,), -1, np.int32) if fail_node_slot is None
           else np.asarray(fail_node_slot, np.int32))

    f = numpy_dtype(inst.link_rates.dtype)
    dev = inst.link_rates.device
    return SimParams(
        dt=torch.tensor(dt, dtype=inst.link_rates.dtype, device=dev),
        link_srv_p=torch.from_numpy(link_srv_p.astype(f)).to(dev),
        srv_rate=torch.from_numpy(srv_rate.astype(f)).to(dev),
        arr_p=torch.from_numpy(arr_p.astype(f)).to(dev),
        fail_link_slot=torch.from_numpy(fls).to(dev),
        fail_node_slot=torch.from_numpy(fns).to(dev),
    )


def liveness_masks(inst, params: SimParams, t: torch.Tensor):
    """(node_up (B, N), link_up (B, L)) at slot `t` (B,): a link is up
    while its own schedule and both endpoints are alive; padding is always
    down."""
    t = t.unsqueeze(1)
    node_up = (params.fail_node_slot < 0) | (t < params.fail_node_slot)
    node_up = node_up & inst.node_mask
    u, v = inst.link_ends[..., 0].long(), inst.link_ends[..., 1].long()
    link_up = (params.fail_link_slot < 0) | (t < params.fail_link_slot)
    link_up = (link_up & torch.gather(node_up, 1, u) & torch.gather(node_up, 1, v)
               & inst.link_mask)
    return node_up, link_up


def migrate_sim_state(state: SimState, link_map: np.ndarray, spec: SimSpec) -> SimState:
    """Carry one lane's queue state (no fleet axis) across a mobility
    topology update, on the host.

    `link_map[i]` is the old canonical id of new link `i` (-1: a new
    link).  Both direction queues of a surviving link follow it with their
    packets and statistics; server queues and the per-stream counters carry
    over.  Packets stranded in queues of vanished links are counted into
    `dropped` per stream, so `conservation_gap` stays zero across the
    boundary.  Padded shapes must match `spec`."""
    num_links, n, c = spec.num_links, spec.num_nodes, spec.cap
    q1 = spec.num_queues + 1
    link_map = np.asarray(link_map, np.int64)

    # perm[new_row] = old_row, or -1 for rows that start out empty
    perm = np.full((q1,), -1, np.int64)
    for i in range(min(link_map.shape[0], num_links)):
        j = int(link_map[i])
        if j >= 0:
            perm[i] = j
            perm[num_links + i] = num_links + j
    perm[2 * num_links:2 * num_links + n] = np.arange(2 * num_links, 2 * num_links + n, dtype=np.int64)
    keep = perm >= 0
    src = np.where(keep, perm, 0)
    host = {f.name: getattr(state, f.name).cpu().numpy() for f in dataclasses.fields(state)}
    dev = state.count.device

    def rows(name):
        a = host[name]
        sel = keep.reshape((-1,) + (1,) * (a.ndim - 1))
        return torch.from_numpy(np.where(sel, a[src], 0).astype(a.dtype)).to(dev)

    # packets stranded in unclaimed rows are dropped at the boundary
    claimed = np.zeros((q1,), bool)
    claimed[perm[keep]] = True
    claimed[q1 - 1] = True  # the scratch row holds no packet
    dropped = host["dropped"].astype(np.int64).copy()
    for q in np.flatnonzero(~claimed[: q1 - 1] & (host["count"][: q1 - 1] > 0)):
        idx = (host["head"][q] + np.arange(host["count"][q], dtype=np.int64)) % c
        np.add.at(dropped, host["buf_stream"][q, idx].astype(np.int64), 1)
    sched = host["sched_slots"]
    new_sched = np.where(keep[:num_links], sched[src[:num_links]], 0).astype(sched.dtype)

    return dataclasses.replace(
        state,
        buf_stream=rows("buf_stream"), buf_birth=rows("buf_birth"),
        buf_enq=rows("buf_enq"), head=rows("head"), count=rows("count"),
        dropped=torch.from_numpy(dropped.astype(host["dropped"].dtype)).to(dev),
        q_sojourn=rows("q_sojourn"), q_served=rows("q_served"),
        q_busy=rows("q_busy"), q_arrived=rows("q_arrived"),
        sched_slots=torch.from_numpy(new_sched).to(dev),
    )


def in_flight(state: SimState) -> torch.Tensor:
    """Packets stored across all real queues, per lane."""
    return state.count[..., :-1].sum(-1)


def conservation_gap(state: SimState) -> torch.Tensor:
    """generated - delivered - dropped - in_flight per lane; zero when no
    packet was created or destroyed outside the accounted transitions."""
    return (state.generated.sum(-1) - state.delivered.sum(-1) - state.dropped.sum(-1)
            - in_flight(state))
