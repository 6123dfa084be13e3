"""The offloading-decision service: admission -> batch -> dispatch -> demux.

Port of `multihop_offload_tpu/serve/service.py` (single device).  Requests
land in per-bucket FIFO queues under one global bound (`submit` refuses
instead of growing without limit); every `tick` takes up to `slots`
requests per non-empty bucket, packs them into the bucket's static layout,
runs ONE batched decision pass per bucket and demultiplexes per-request
responses.  When a tick finds a bucket's oldest pending request older than
the deadline, that batch degrades to the analytic greedy baseline
(`baseline_policy`); degradation is per batch, never per slot.

`ragged=True` turns on the occupancy ladder (`bucketing.OccupancyLadder`):
a cold bucket ticks at a narrower width.  `overlap=True` settles each
tick's dispatches on the NEXT tick, after that tick's packs: the host packs
tick t+1 while the card may still run tick t.  `drain` settles the last
in-flight batches, so every admitted request is answered exactly once.

Greedy decisions (`prob=False`) read no random draw, so batching never
changes an answer.  Under `prob=True` each request samples its decision
from its own generator on the service's device, seeded from `(seed,
request_id)` (`request_generator`; a pad slot repeats the last real
request's), one per batch row: a request's answer does not depend on its
slot, its bucket's occupancy or the tick it rides, the property JAX's
`fold_in(PRNGKey(seed), request_id)` keys give (the bits differ: torch
generators are not threefry).  `hot_reload` (JAX `:642-663`) swaps in the
newest verified checkpoint of the port's ``torch/`` directory between
ticks (`executor.hot_reload`), retrying transient I/O with backoff.

`mesh_devices` selects the sharded tick (JAX `:119-150`, `:288-345`): each
bucket's batch is laid over a subset of that fleet
(`serve.sharded.ShardedBucketExecutor`), chosen by the placement planner
(`serve.placement`) from the per-bucket admitted arrivals and re-planned
every `replan_every` ticks, between ticks only (`_between_ticks`).  The
planner works on fleet indices; `lose_device(i)` and `restore_device(i)`
take one, and a stuck device (the watchdog's per-device verdict) degrades
only the buckets placed on it.  The occupancy ladder is for the
one-device executor only, as in JAX.  `attach_health` wires an SLO engine
(`obs.slo`, observed once per tick on the service clock) and a flight
recorder (one row per tick).  `capture_sample` logs a deterministic
sample of the answered requests as "outcome" events through the active
run log (JAX `:602-626`, `loop.experience`), the flywheel's input.  The bf16 precision
policy runs (`precision`, JAX `:107-155`):
requests are packed at its storage dtype, so the batch crosses to the card
as bf16 bytes, and each dispatch squares in bf16 (K2 or K6 in bf16); the
model must carry the policy's dtypes (`cli/serve.py:build_service` builds
it so).  Each dispatch's APSP takes the route of `apsp_impl` (JAX `:90`,
`ops.minplus.resolve_apsp`): `'xla'`, the default, squares at every N;
`'pallas'` and `'auto'` take K3 above a padded N of 256.  Its fixed point
takes the core of `fp_impl` (JAX `:91`, default `'xla'`:
`ops.fixed_point.resolve_fixed_point`), so a directly built sparse
service runs the segment-sum fixed point and `mho-serve`, at the
config's `'auto'`, K1.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np
import torch

from multihop_offload_tpu_torch._device import resolve_device
from multihop_offload_tpu_torch.layouts.policy import resolve_layout
from multihop_offload_tpu_torch.layouts.sparse import cf_nnz_count, ext_nnz_count
from multihop_offload_tpu_torch.obs import events as obs_events
from multihop_offload_tpu_torch.obs import trace as obs_trace
from multihop_offload_tpu_torch.obs.registry import registry as obs_registry
from multihop_offload_tpu_torch.obs.spans import span
from multihop_offload_tpu_torch.precision import resolve_precision
from multihop_offload_tpu_torch.serve.bucketing import (
    OccupancyLadder,
    ShapeBuckets,
    pack_bucket,
    padding_waste,
)
from multihop_offload_tpu_torch.serve.executor import (
    DM_SERVE_NONFINITE,
    BucketExecutor,
    DispatchHandle,
)
from multihop_offload_tpu_torch.serve.guards import validate_request
from multihop_offload_tpu_torch.serve.metrics import ServingStats
from multihop_offload_tpu_torch.serve.request import OffloadRequest, OffloadResponse
from multihop_offload_tpu_torch.utils.durable import with_backoff


_MASK64 = (1 << 64) - 1


@dataclasses.dataclass
class _TickBatch:
    """One bucket's dispatched-but-not-yet-settled batch (phase A builds
    it, phase B settles it)."""

    bucket: int
    taken: List[Tuple[OffloadRequest, float]]
    reqs: List[OffloadRequest]
    ids: Optional[List[int]]
    degraded: bool
    pad: object
    width: int
    t_start: float
    placed: tuple                           # fleet indices (sharded only)
    handle: Optional[DispatchHandle] = None  # the one-device executor's
    out: Optional[tuple] = None             # host arrays (sharded path)


class OffloadService:
    """Serving loop over a `BucketExecutor`, or over a
    `ShardedBucketExecutor` when `mesh_devices` names a fleet.

    `clock` is injectable (tests drive deterministic time); `device` is
    where the decision passes run (default CUDA; with `mesh_devices`, the
    fleet's first member)."""

    def __init__(
        self,
        model,
        buckets: ShapeBuckets,
        slots: int = 8,
        queue_cap: int = 64,
        deadline_s: float = 0.5,
        seed: int = 0,
        prob: bool = False,
        dtype=None,
        precision: Optional[str] = "fp32",
        layout=None,
        apsp_impl: str = "xla",
        fp_impl: str = "xla",
        clock: Callable[[], float] = time.monotonic,
        capture_sample: float = 0.0,
        trace: bool = True,
        mesh_devices: Optional[List] = None,
        replan_every: int = 16,
        placement_hysteresis: float = 0.2,
        ragged: bool = False,
        overlap: bool = False,
        ladder_alpha: float = 0.5,
        ladder_hysteresis: float = 0.25,
        device=None,
    ):
        if slots < 1 or queue_cap < 1:
            raise ValueError("slots and queue_cap must be >= 1")
        self.layout = resolve_layout(layout)
        self.device = resolve_device(mesh_devices[0] if mesh_devices else device)
        # `dtype` is the base dtype, `precision` the policy over it
        self.precision = resolve_precision(precision, dtype, self.device)
        # `mesh_devices` selects the sharded tick: each bucket's batch is laid
        # over a subset of the fleet, chosen by the placement planner from
        # the per-bucket admitted arrivals, re-planned every `replan_every`
        # ticks, between ticks only
        self.planner = None
        if mesh_devices:
            from multihop_offload_tpu_torch.serve.placement import PlacementPlanner
            from multihop_offload_tpu_torch.serve.sharded import ShardedBucketExecutor

            self.executor = ShardedBucketExecutor(
                model, buckets, devices=mesh_devices, slots=slots, layout=self.layout,
                precision=self.precision, apsp_impl=apsp_impl, prob=prob, fp_impl=fp_impl)
            self.planner = PlacementPlanner(
                len(buckets.pads), range(len(self.executor.fleet)), slots,
                hysteresis=placement_hysteresis)
            self.executor.set_placement(self.planner.plan)
        else:
            self.executor = BucketExecutor(model, layout=self.layout, device=self.device,
                                           precision=self.precision, apsp_impl=apsp_impl,
                                           prob=prob, slots=slots, fp_impl=fp_impl)
        self.replan_every = max(1, int(replan_every))
        # per-bucket admitted arrivals in the current planning window (the
        # planner's rate signal) and per-device stuck-until deadlines
        self._arrivals: List[int] = [0] * len(buckets.pads)
        self._stuck_devices: dict = {}
        self.seed = int(seed)
        # experience capture: fraction of answered requests logged as
        # "outcome" events through the active run log (the continual-
        # learning flywheel's input, `loop/`); 0 = off
        self.capture_sample = float(capture_sample)
        self.buckets = buckets
        self.slots = slots
        self.queue_cap = queue_cap
        self.deadline_s = deadline_s
        self.dtype = self.precision.storage_dtype
        self.clock = clock
        # request-scoped tracing (obs.trace): batched hop events through the
        # active run log; with no log installed it costs one check
        self.trace = bool(trace)
        # health hook (attach_health): an SLO engine observed once per tick
        # and a flight recorder fed one row per tick
        self.slo = None
        self.recorder = None
        # tick watchdog (attach_watchdog): a "stuck" verdict forces the bucket
        # onto the greedy baseline until `_degraded_until` passes
        self.watchdog = None
        self._degraded_until: dict = {}
        self.stats = ServingStats()
        self._queues: List[Deque[Tuple[OffloadRequest, float]]] = [
            deque() for _ in buckets.pads
        ]
        self._hop_cache: dict = {}
        self.overlap = bool(overlap)
        self.ladder: Optional[OccupancyLadder] = None
        # the ladder is the one-device executor's (a placement spreads the
        # sharded executor's batch already)
        if ragged and self.planner is None:
            self.ladder = OccupancyLadder(
                len(buckets.pads), slots,
                alpha=ladder_alpha, hysteresis=ladder_hysteresis,
            )
        self._ladder_seen = 0         # transitions already mirrored to stats
        self._pending: List[_TickBatch] = []
        # the last submit()'s verdict: "admitted" | "backpressure" |
        # "too_large" | "rejected_invalid"; only backpressure is retryable
        self.last_submit_outcome: Optional[str] = None
        # first-detection latch for the non-finite sentinel
        self._nonfinite_seen = False

    # ---- admission ---------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return sum(len(q) for q in self._queues)

    def submit(self, req: OffloadRequest, now: Optional[float] = None) -> bool:
        """Admit a request, or refuse it (False) when semantically invalid
        (`serve.guards`), under backpressure, or when no bucket fits.
        `last_submit_outcome` says which."""
        rej = validate_request(req)
        if rej is not None:
            self.stats.record_submit("rejected_invalid")
            self.last_submit_outcome = "rejected_invalid"
            obs_registry().counter(
                "mho_serve_rejected_total",
                "requests refused by the admission guards, by reason",
            ).inc(reason=rej.reason)
            obs_events.emit(
                "request_rejected", request_id=req.request_id,
                reason=rej.reason, detail=rej.detail,
            )
            if self._tracing():
                obs_trace.hop("reject", [req.request_id], reason=rej.reason)
            return False
        b = self.buckets.bucket_for(*req.sizes)
        if b is not None and self.layout.sparse:
            b = self._sparse_fit(req, b)
        if b is None:
            self.stats.record_submit("too_large")
            self.last_submit_outcome = "too_large"
            return False
        if self.queue_depth >= self.queue_cap:
            self.stats.record_submit("backpressure", bucket=b)
            self.last_submit_outcome = "backpressure"
            return False
        self._queues[b].append((req, self.clock() if now is None else now))
        self.stats.record_submit("admitted", bucket=b)
        self.last_submit_outcome = "admitted"
        self._arrivals[b] += 1
        obs_registry().gauge(
            "mho_serve_queue_depth", "pending admitted requests"
        ).set(self.queue_depth)
        if self._tracing():
            obs_trace.hop("submit", [req.request_id], bucket=b,
                          queue_depth=self.queue_depth)
        return True

    def request_generator(self, request_id: int, device=None) -> torch.Generator:
        """The draws of one request's sampled decision: a generator on
        `device` (default the service's) seeded from (seed, request_id)
        alone, through a splitmix64 mix (the CPU generator keeps only a
        seed's low 32 bits)."""
        z = (self.seed * 0x9E3779B97F4A7C15 + int(request_id) + 1) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        g = torch.Generator(device=self.device if device is None else device)
        g.manual_seed((z ^ (z >> 31)) >> 1)
        return g

    def _tracing(self) -> bool:
        return self.trace and obs_events.get_run_log() is not None

    def attach_health(self, slo=None, recorder=None) -> None:
        """Wire the health subsystem into the tick: `slo` (an
        `obs.slo.SLOEngine`) is observed once per tick on the service
        clock; `recorder` (an `obs.flightrec.FlightRecorder`) receives one
        row per tick.  Either may be None."""
        self.slo = slo
        self.recorder = recorder

    def attach_watchdog(self, watchdog) -> None:
        """Wire a `serve.watchdog.TickWatchdog`: each bucket dispatch is
        timed on the service clock; a stuck verdict degrades that bucket
        (sharded: the buckets on its devices) to the baseline until the
        watchdog's recovery window passes."""
        self.watchdog = watchdog

    # ---- sharded placement / per-device health -----------------------------

    def _between_ticks(self, now: Optional[float]) -> None:
        """Sharded housekeeping, run before any dispatch of the tick: expire
        per-device stuck windows, and every `replan_every` ticks feed the
        arrival window to the planner and adopt its plan.  Placement
        therefore only changes between dispatches."""
        t_now = self.clock() if now is None else now
        for d, until in list(self._stuck_devices.items()):
            if t_now >= until:
                del self._stuck_devices[d]
                obs_registry().counter(
                    "mho_watchdog_device_recoveries_total",
                    "devices restored after a stuck window",
                ).inc(device=str(d))
                obs_events.emit("watchdog_device_recovered", device=str(d))
        if self.stats.ticks % self.replan_every == 0:
            self.planner.observe(self._arrivals)
            self._arrivals = [0] * len(self._queues)
            plan = self.planner.replan()
            if plan.assignments != self.executor.plan.assignments:
                self.executor.set_placement(plan)

    def _devices_stuck(self, devices, t_now: float) -> bool:
        return any(self._stuck_devices.get(d, -float("inf")) > t_now
                   for d in devices)

    def lose_device(self, device: int) -> None:
        """Drop fleet member `device` (an index) from the serving fleet
        (chaos drill or operator action).  Forces an immediate re-plan onto
        the survivors; the next tick's dispatches leave it out."""
        if self.planner is None:
            raise RuntimeError("lose_device requires a sharded service "
                               "(mesh_devices)")
        self.planner.remove_device(device)
        self.executor.set_placement(self.planner.plan)
        self._stuck_devices.pop(device, None)
        obs_registry().counter(
            "mho_serve_devices_lost_total", "devices dropped from the fleet"
        ).inc(device=str(device))
        obs_events.emit("device_lost", device=str(device),
                        fleet=len(self.planner.devices))

    def restore_device(self, device: int) -> None:
        """Return a lost fleet member to the fleet; the planner may adopt it
        at the next forced or rate-driven re-plan."""
        if self.planner is None:
            raise RuntimeError("restore_device requires a sharded service "
                               "(mesh_devices)")
        self.planner.add_device(device)
        self.executor.set_placement(self.planner.plan)
        obs_events.emit("device_restored", device=str(device),
                        fleet=len(self.planner.devices))

    def _sparse_fit(self, req: OffloadRequest, b: int) -> Optional[int]:
        """The first bucket from `b` up whose static nnz pads also hold this
        request's edge lists (an oversized edge count would raise inside
        `build_instance` mid-tick)."""
        comp_mask = np.asarray(req.roles) < 2
        enn = ext_nnz_count(req.topo, comp_mask)
        cnn = cf_nnz_count(req.topo)
        n, l, s, j = req.sizes
        for bb in range(b, len(self.buckets)):
            pad = self.buckets[bb]
            if (enn <= pad.ext_nnz and cnn <= pad.cf_nnz and n <= pad.n
                    and l <= pad.l and s <= pad.s and j <= pad.j):
                return bb
        return None

    # ---- the serving tick --------------------------------------------------

    def _dispatch_bucket(self, b: int, q, now: Optional[float],
                         overlapping: bool) -> _TickBatch:
        """Phase A for one non-empty bucket: degraded verdict, ladder width,
        pack, and the dispatch (which does not wait for the card)."""
        t_now = self.clock() if now is None else now
        held = self._degraded_until.get(b)
        if held is not None and t_now >= held:
            # watchdog recovery window over: retry the GNN
            del self._degraded_until[b]
            held = None
            obs_registry().counter(
                "mho_watchdog_recoveries_total",
                "buckets restored to the GNN program",
            ).inc(bucket=b)
            obs_events.emit("watchdog_recovered", bucket=b)
        placed = self.executor.devices_for(b) if self.planner is not None else ()
        # a stuck device degrades only the buckets placed on it
        dev_stuck = bool(placed) and self._devices_stuck(placed, t_now)
        degraded = ((t_now - q[0][1]) > self.deadline_s
                    or held is not None or dev_stuck)
        width = self.slots
        if self.ladder is not None:
            width = self.ladder.select(b, len(q))
            for bb, old, new in self.ladder.transitions[self._ladder_seen:]:
                self.stats.record_ladder_transition(bb, old, new)
                obs_events.emit("ladder_transition", bucket=bb,
                                old_width=old, new_width=new)
            self._ladder_seen = len(self.ladder.transitions)
        # the ladder never selects below min(pending, slots)
        taken = [q.popleft() for _ in range(min(width, len(q)))]
        reqs = [r for r, _ in taken]
        pad = self.buckets[b]
        tracing = self._tracing()
        ids = [r.request_id for r in reqs] if tracing else None
        # an overlapped pack runs while the card computes the previous tick
        with span("serve/pack/overlapped" if overlapping else "serve/pack"):
            binst, bjobs = pack_bucket(
                reqs, pad, width, dtype=self.dtype, hop_cache=self._hop_cache,
                layout=self.layout, device=self.device,
            )
        if tracing:
            obs_trace.hop("pack", ids, bucket=b, degraded=bool(degraded),
                          width=width)
        if self.ladder is not None:
            self.ladder.observe(b, len(reqs))
        gens = None
        if self.executor.prob and not degraded:
            rids = [r.request_id for r in reqs]
            rids += [rids[-1]] * (width - len(rids))
            # each slot's generator lives on the device its shard runs on
            gens = [self.request_generator(
                        rid, None if self.planner is None
                        else self.executor.fleet[self.executor.shard_of_slot(b, i)])
                    for i, rid in enumerate(rids)]
        if self.planner is not None:
            # the sharded executor gathers its shards' outputs itself:
            # phase B only demuxes
            out = self.executor.run(b, binst, bjobs, degraded=degraded,
                                    request_ids=ids, gens=gens)
            return _TickBatch(b, taken, reqs, ids, degraded, pad, width, t_now,
                              placed, out=out)
        handle = self.executor.dispatch(
            b, binst, bjobs, degraded=degraded, request_ids=ids, width=width, gens=gens,
        )
        return _TickBatch(b, taken, reqs, ids, degraded, pad, width, t_now, placed,
                          handle=handle)

    def _settle_batch(self, batch: _TickBatch,
                      now: Optional[float]) -> List[OffloadResponse]:
        """Phase B for one dispatched batch: the device-to-host fetch,
        watchdog verdict, demux, and accounting."""
        b = batch.bucket
        out = batch.out if batch.handle is None else self.executor.fetch(batch.handle)
        t_done = self.clock() if now is None else now
        if self.watchdog is not None:
            # clamp at zero: backward clock skew must not trip it
            verdict = self.watchdog.observe(b, max(t_done - batch.t_start, 0.0),
                                            now=t_done, devices=batch.placed or None)
            if verdict == "stuck" and self.watchdog.recovery_s > 0:
                until = t_done + self.watchdog.recovery_s
                if batch.placed:
                    # per shard: the stuck window pins the devices this
                    # bucket ran on; buckets on other devices keep the GNN
                    for d in batch.placed:
                        self._stuck_devices[d] = until
                else:
                    self._degraded_until[b] = until
        shards = None
        if batch.placed:
            shards = [str(self.executor.shard_of_slot(b, i))
                      for i in range(len(batch.taken))]
        batch_responses = demux_responses(
            batch.taken, out, "baseline" if batch.degraded else "gnn", b, t_done,
            shards=shards,
        )
        if batch.ids is not None:
            obs_trace.hop(
                "decision", batch.ids, bucket=b,
                served_by="baseline" if batch.degraded else "gnn",
                latency_s=[round(r.latency_s, 6) for r in batch_responses],
            )
        self._capture_outcomes(batch.reqs, batch_responses)
        waste = padding_waste(batch.reqs, batch.pad, batch.width)
        self.stats.record_dispatch(
            b, len(batch.reqs), self.slots, waste, batch.degraded,
            width=batch.width,
        )
        self.stats.record_batch(
            len(batch.reqs), sum(r.num_jobs for r in batch.reqs),
            batch.degraded,
            [max(t_done - t_enq, 0.0) for _, t_enq in batch.taken],
            shards=shards,
        )
        self._check_nonfinite(b, batch.ids or [r.request_id for r in batch.reqs])
        return batch_responses

    def tick(self, now: Optional[float] = None) -> List[OffloadResponse]:
        """Serve one batch per non-empty bucket; returns demuxed responses.

        Phase A dispatches every non-empty bucket before phase B waits for
        any.  With `overlap=True` this tick settles the PREVIOUS tick's
        dispatches after issuing its own, and returns their responses."""
        self.stats.ticks += 1
        if self.planner is not None:
            self._between_ticks(now)
        responses: List[OffloadResponse] = []
        degraded_batches = 0
        with span("serve/tick"):
            inflight, self._pending = self._pending, []
            batches: List[_TickBatch] = []
            for b, q in enumerate(self._queues):
                if not q:
                    continue
                batch = self._dispatch_bucket(b, q, now, overlapping=bool(inflight))
                degraded_batches += int(batch.degraded)
                batches.append(batch)
            if self.overlap:
                self._pending = batches
                settle = inflight
            else:
                settle = inflight + batches
            for batch in settle:
                responses.extend(self._settle_batch(batch, now))
        depth = self.queue_depth
        obs_registry().gauge(
            "mho_serve_queue_depth", "pending admitted requests"
        ).set(depth)
        if responses:
            obs_events.emit(
                "tick", n=self.stats.ticks, served=len(responses),
                degraded_batches=degraded_batches, queue_depth=depth,
            )
        if self.recorder is not None:
            lat = [r.latency_s for r in responses]
            self.recorder.record(
                "tick", tick=self.stats.ticks, served=len(responses),
                degraded_batches=degraded_batches, queue_depth=depth,
                latency_max_s=round(max(lat), 6) if lat else 0.0,
            )
        if self.slo is not None:
            self.slo.observe(self.clock() if now is None else now)
        return responses

    def _check_nonfinite(self, bucket: int, request_ids: List[int]) -> None:
        """On the first dispatch whose live outputs held a NaN/Inf (the
        sentinel counted on the device), emit a typed event; once per
        service life."""
        if self._nonfinite_seen:
            return
        dm = self.executor.last_devmetrics or {}
        hits = sum(v for k, v in dm.items() if k.startswith(DM_SERVE_NONFINITE))
        if not hits:
            return
        self._nonfinite_seen = True
        obs_events.emit(
            "nonfinite_detected", surface="serve", bucket=bucket,
            count=int(hits), request_ids=request_ids,
        )
        if self.recorder is not None:
            self.recorder.record(
                "nonfinite", surface="serve", bucket=bucket,
                count=int(hits), request_ids=request_ids,
                tick=self.stats.ticks,
            )

    def _capture_outcomes(self, reqs, batch_responses) -> None:
        """Emit sampled per-request "outcome" events (experience capture for
        the loop/ flywheel).  No-op without an active run log or with the
        sampling knob at 0 -- the hot path pays one float compare."""
        if self.capture_sample <= 0.0 or obs_events.get_run_log() is None:
            return
        from multihop_offload_tpu_torch.loop import experience

        captured_ids = []
        for req, resp in zip(reqs, batch_responses):
            if experience.sampled(req.request_id, self.capture_sample):
                obs_events.emit("outcome", **experience.outcome_record(req, resp))
                captured_ids.append(req.request_id)
        if captured_ids and self.trace:
            obs_trace.hop("capture", captured_ids, sample=self.capture_sample)
        if captured_ids:
            obs_registry().counter(
                "mho_serve_outcomes_captured_total",
                "answered requests logged as experience",
            ).inc(len(captured_ids))

    def drain(self, max_ticks: int = 1000) -> List[OffloadResponse]:
        """Tick until every admitted request is answered (bounded), the
        last in-flight batches of overlap mode included."""
        responses: List[OffloadResponse] = []
        for _ in range(max_ticks):
            if self.queue_depth == 0 and not self._pending:
                break
            responses.extend(self.tick())
        return responses

    # ---- weight management -------------------------------------------------

    def hot_reload(self, model_dir: str, which: str = "torch") -> Optional[int]:
        """Poll the checkpoint directory and swap in a newer policy without
        restarting.  Transient I/O failures retry with bounded exponential
        backoff; corruption is handled below this (quarantine and last-good
        fallback in `executor.hot_reload`).  Returns the step swapped in,
        or None."""
        step = with_backoff(lambda: self.executor.hot_reload(model_dir, which=which),
                            site="hot_reload")
        if step is not None:
            obs_registry().counter(
                "mho_serve_hot_reloads_total", "policy swaps without restart",
            ).inc()
            lin = self.executor.loaded_lineage or {}
            obs_events.emit(
                "hot_reload", step=step, source=lin.get("source"),
                git_sha=lin.get("git_sha"), parent_step=lin.get("parent_step"),
            )
        return step


def demux_responses(
    taken: List[Tuple[OffloadRequest, float]],
    out: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
    served_by: str,
    bucket: int,
    t_done: float,
    shards: Optional[List[str]] = None,
) -> List[OffloadResponse]:
    """Slice each real slot's padded decision arrays down to the request's
    true job count; pad slots and pad jobs never reach a client.  Under the
    sharded executor `shards[i]` names the fleet index that computed slot
    i's decision."""
    dst, is_local, delay_est, job_total = out
    responses = []
    for i, (req, t_enq) in enumerate(taken):
        nj = req.num_jobs
        responses.append(OffloadResponse(
            request_id=req.request_id,
            dst=dst[i, :nj].copy(),
            is_local=is_local[i, :nj].copy(),
            delay_est=delay_est[i, :nj].copy(),
            job_total=job_total[i, :nj].copy(),
            served_by=served_by,
            bucket=bucket,
            latency_s=max(t_done - t_enq, 0.0),
            shard=shards[i] if shards else "",
        ))
    return responses
