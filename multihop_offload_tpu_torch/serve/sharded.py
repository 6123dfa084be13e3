"""Sharded bucket executor: one bucket's batch over several devices.

Port of `multihop_offload_tpu/serve/sharded.py`.  JAX compiles, per
(bucket, placement), one program whose batch (slot) axis is laid over a
`jax.sharding.Mesh`.  Here one process drives the fleet: a bucket's slots
split into `len(devs)` contiguous equal blocks (the layout of JAX's
`PartitionSpec("data")`), and each block runs the one-device executor's
gnn or baseline step on its device with that device's model replica.  On
the card each shard launches the path's kernels (K1 and K2 under the dense
layout, K1, K4 and K6 under the sparse one).  The host gathers the outputs
in slot order.  Each slot's work does not depend on the batch around it,
so a sharded dispatch decides what the one-device executor decides.

Fleet identity.  The placement planner (`serve.placement`) and the plan
work on fleet indices `0..k-1`; index `i` names `fleet[i]`, a
`torch.device`.  A fleet may name one device more than once (`[cpu] * 4`
in the tests, `[cuda:0] * 4` on one card, as `parallel/mesh.py` allows):
it still has k members, each shard's work queued on its device.  On a
fleet of distinct cards `cuda:0..k-1` an index is the card's ordinal, so
the `shard=` and `devices=` labels read as JAX's device ids.

Replicas.  One model per distinct device (`torch.device` equality): the
executor's model on its own device, a copy elsewhere, refreshed whenever
the model's weights were written since the copy was made (each tensor's
version counter moves on an in-place write, `load_params` and so
`hot_reload` included).

Fleet metrics.  The one cross-shard reduction (JAX `:139-150`): each shard's
decision counters (`observe_decisions`), job-total sum and delay-estimate
max go through `parallel.collectives.gather` to the first device of the
placement and are reduced there; decisions never cross devices.

Host time is kept per (bucket, fleet indices) in `placement_host_s`.  Not
ported: JAX's per-placement compile cache and `expected_rebuild` (the port
runs eagerly, nothing compiles) and the `obs_prof.wrap` program labels
(`obs/prof.py` is not ported yet).
"""

from __future__ import annotations

import copy
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multihop_offload_tpu_torch._device import resolve_device
from multihop_offload_tpu_torch._records import slice_records
from multihop_offload_tpu_torch.obs import trace as obs_trace
from multihop_offload_tpu_torch.parallel.collectives import gather
from multihop_offload_tpu_torch.parallel.mesh import canonical_device
from multihop_offload_tpu_torch.serve.executor import (
    BucketExecutor,
    observe_decisions,
    pack_outputs,
    unpack_outputs,
)
from multihop_offload_tpu_torch.serve.placement import PlacementPlan


def _devices_label(devs: Sequence) -> str:
    return ",".join(str(getattr(d, "id", d)) for d in devs)


def _weights_version(model) -> tuple:
    """The version counters of the model's tensors: any in-place write to a
    weight moves its counter."""
    return tuple(t._version for t in model.state_dict().values())


class ShardedBucketExecutor(BucketExecutor):
    """`BucketExecutor` whose dispatches run over per-bucket device subsets.

    The service's contract is the base class's (`hot_reload`,
    `load_params`, `dispatch_count`); `run` replaces `dispatch` + `fetch`
    and returns the host arrays.  The additions are `set_placement`,
    `devices_for`, `shard_of_slot`, and the `last_devices_used` and
    `last_metrics` the smoke reads."""

    def __init__(self, model, buckets, *, devices: Sequence, slots: int,
                 layout=None, precision=None, apsp_impl: str = "xla",
                 prob: bool = False):
        fleet = [canonical_device(resolve_device(d)) for d in devices]
        if not fleet:
            raise ValueError("sharded executor needs at least one device")
        super().__init__(model, layout=layout, device=fleet[0], precision=precision,
                         apsp_impl=apsp_impl, prob=prob)
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.buckets = buckets
        self.slots = int(slots)
        self.fleet: List[torch.device] = fleet
        # until the first plan arrives everything runs on fleet member 0
        self.plan = PlacementPlan(tuple((0,) for _ in buckets.pads))
        # devices the last dispatch spanned, counted off the shards that
        # actually returned outputs (catches a silent one-device fall back)
        self.last_devices_used = 0
        # the fleet-metric reduction of the last dispatch
        self.last_metrics: Optional[dict] = None
        # host seconds per (bucket, fleet indices)
        self.placement_host_s: Dict[Tuple[int, Tuple[int, ...]], float] = {}
        self._replicas: Dict[torch.device, tuple] = {}

    # ---- placement ---------------------------------------------------------

    def set_placement(self, plan: PlacementPlan) -> None:
        """Adopt a planner output (fleet indices).  The service applies it
        between ticks only; device counts that do not divide the slot count
        are a planner bug and fail here."""
        if len(plan.assignments) != len(self.buckets.pads):
            raise ValueError(
                f"plan covers {len(plan.assignments)} buckets, "
                f"executor has {len(self.buckets.pads)}"
            )
        for b, devs in enumerate(plan.assignments):
            if not devs or self.slots % len(devs) != 0:
                raise ValueError(
                    f"bucket {b}: {len(devs)} devices do not divide "
                    f"{self.slots} slots"
                )
            bad = [i for i in devs if not 0 <= i < len(self.fleet)]
            if bad:
                raise ValueError(f"bucket {b}: fleet indices {bad} outside "
                                 f"0..{len(self.fleet) - 1}")
        self.plan = plan

    def devices_for(self, bucket: int) -> Tuple[int, ...]:
        return self.plan.assignments[bucket]

    def shard_of_slot(self, bucket: int, slot: int) -> int:
        """The fleet index computing `slot` of `bucket` under the current
        plan (contiguous equal blocks in placement order)."""
        devs = self.plan.assignments[bucket]
        return devs[slot * len(devs) // self.slots]

    # ---- replicas ----------------------------------------------------------

    def replica(self, device: torch.device):
        """The model on `device`: the executor's own on its device, else a
        copy, refreshed when the model's weights moved since it was made."""
        if device == self.device:
            return self.model
        version = _weights_version(self.model)
        held = self._replicas.get(device)
        if held is None:
            held = (copy.deepcopy(self.model).to(device), None)
        model, seen = held
        if seen != version:
            src = self.model.state_dict()
            with torch.no_grad():
                for name, t in model.state_dict().items():
                    t.copy_(src[name])
        self._replicas[device] = (model, version)
        return model

    # ---- dispatch ----------------------------------------------------------

    @torch.no_grad()
    def run(self, bucket: int, binst, bjobs, degraded: bool = False,
            request_ids=None, gens: Optional[List[torch.Generator]] = None):
        """One sharded decision pass over the packed batch (`slots` rows);
        returns host numpy (dst, is_local, delay_est, job_total), each
        (slots, pad.j), in slot order.  `gens`: one generator per slot, on
        the device of the slot's shard."""
        t0 = time.perf_counter()
        devs = self.plan.assignments[bucket]
        width = int(bjobs.mask.shape[0])
        if width % len(devs):
            raise ValueError(f"{width} slots do not split over {len(devs)} devices")
        per = width // len(devs)
        bufs, metrics, out_dtype = [], [], None
        for i, idx in enumerate(devs):
            dev = self.fleet[idx]
            lo, hi = i * per, (i + 1) * per
            sinst = slice_records(binst, lo, hi).to(dev)
            sjobs = slice_records(bjobs, lo, hi).to(dev)
            out = (self.baseline_step(sinst, sjobs) if degraded
                   else self.gnn_step(sinst, sjobs, None if gens is None else gens[lo:hi],
                                      model=self.replica(dev), device=dev))
            out_dtype = out[2].dtype
            _, _, delay_est, job_total = out
            metrics.append(torch.cat([
                observe_decisions(out, sjobs.mask).double(),
                job_total.double().sum().reshape(1),
                delay_est.double().max().reshape(1)]))
            bufs.append(pack_outputs(out))
        # the one cross-shard reduction, on the placement's first device
        fleet_m = gather(metrics, self.fleet[devs[0]])
        reduced = torch.cat([fleet_m[:, :4].sum(0), fleet_m[:, 4:].max(0).values])
        hosts = [buf.cpu().numpy() for buf in bufs]
        reduced = reduced.cpu().tolist()
        self.dispatch_count += 1
        self.last_devices_used = len(set(devs[:len(hosts)]))
        label = _devices_label(devs)
        if request_ids:
            obs_trace.hop(
                "dispatch", request_ids, bucket=bucket,
                dispatch=self.dispatch_count,
                program="baseline" if degraded else "gnn",
                step=self.loaded_step, shard=len(devs), devices=label,
            )
        parts = [unpack_outputs(h, per, out_dtype) for h in hosts]
        out = tuple(np.concatenate([p[k] for p in parts]) for k in range(4))
        self.last_metrics = {"job_total_sum": reduced[3], "delay_est_max": reduced[4]}
        # shard-labelled flush: which placement produced this window
        self.record_decisions(reduced[:3], bucket=str(bucket), shard=str(len(devs)),
                              devices=label)
        key = (bucket, tuple(devs))
        self.placement_host_s[key] = (self.placement_host_s.get(key, 0.0)
                                      + time.perf_counter() - t0)
        return out
