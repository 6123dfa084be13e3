"""Device-resident bucket executor: one batched decision pass per bucket.

Port of `multihop_offload_tpu/serve/executor.py` (single device).  A
bucket's batch of requests, packed to its pad shape and `width` slots, goes
through the same batched `agent.policy.forward_env` (or, degraded,
`env.policies.baseline_policy`) that the evaluation path runs: on the card
that is K1 and K2 under the dense layout, K1, K4 and K6 under the sparse
one.

The JAX executor jits one program per (bucket, width), donates the tick's
input buffers and compiles on the first dispatch.  Eager torch has none of
that: a width is the batch size packed.  The (bucket, width) bookkeeping
stays (`dispatches_by_width`), so ladder widths read as in JAX.

`dispatch` enqueues the pass and returns without waiting for the card: it
packs the four decision outputs and the decision counters into one buffer
and starts its copy to pinned host memory behind a CUDA event.  `fetch` is
the one device-to-host copy: it waits for that event.  The decision
counters and the non-finite sentinel of `observe_decisions` are torch
reductions on the card that ride the same copy.

Weights: `load_params` swaps a state dict in memory after the structural
signature check (`param_signature`) and refuses non-finite leaves.
`hot_reload` (JAX `executor.py:323-389`) reads the port's own checkpoints,
the ``torch/`` directory the Trainer writes under the model directory: the
newest step that passes `train.checkpoints.restore_verified` (a corrupt
step is quarantined and the lineage walked down), swapped in through
`load_params`.  Every swap first passes the non-finite gate and then, when
one is attached as `executor.canary` (`loop.canary.CheckpointCanary`, as
`cli.loop` attaches it), the semantic canary's probe decisions; a refused
step is remembered and not retried.

`prob=True` samples each request's decision from its own generator
(`dispatch(gens=)`: one per batch row, `env.offloading._uniform`), so a
request's answer does not depend on the rows beside it.

Programs (JAX `executor.py:205-213`): each (bucket, width) has a gnn and a
baseline program in the prof layer, `serve/bucket{b}/gnn` and
`serve/bucket{b}/baseline`, with `/w{width}` where a ladder width runs
below `slots`.  A program counts its work on its first dispatch
(`obs.prof.wrap`) and is accounted in `fetch`, the sync boundary: the wall
time from its dispatch to the copy's completion.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from multihop_offload_tpu_torch._device import resolve_device
from multihop_offload_tpu_torch.agent.policy import forward_env
from multihop_offload_tpu_torch.env.policies import baseline_policy
from multihop_offload_tpu_torch.layouts.policy import resolve_layout
from multihop_offload_tpu_torch.obs import events as obs_events
from multihop_offload_tpu_torch.obs import prof as obs_prof
from multihop_offload_tpu_torch.obs import trace as obs_trace
from multihop_offload_tpu_torch.obs.registry import registry as obs_registry
from multihop_offload_tpu_torch.ops.fixed_point import resolve_fixed_point
from multihop_offload_tpu_torch.ops.minplus import check_apsp_impl
from multihop_offload_tpu_torch.precision import resolve_precision
from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib

DM_SERVE_LOCAL = "mho_dev_serve_decisions_total{decision=local}"
DM_SERVE_OFFLOAD = "mho_dev_serve_decisions_total{decision=offload}"
DM_SERVE_NONFINITE = "mho_dev_serve_nonfinite_total"
_DM_KEYS = (DM_SERVE_LOCAL, DM_SERVE_OFFLOAD, DM_SERVE_NONFINITE)


def observe_decisions(out, mask: torch.Tensor) -> torch.Tensor:
    """One dispatch's decision counters as a (3,) tensor on the outputs'
    device: local and offloaded live jobs, and live jobs whose delay
    estimate or empirical score is NaN/Inf (the non-finite sentinel; pad
    slots never count)."""
    _, is_local, delay_est, job_total = out
    nonfinite = ~torch.isfinite(delay_est) | ~torch.isfinite(job_total)
    return torch.stack([(is_local & mask).sum(), (~is_local & mask).sum(),
                        (nonfinite & mask).sum()])


def pack_outputs(out) -> torch.Tensor:
    """The four decision outputs (dst, is_local, delay_est, job_total), each
    (width, J), flattened into one float64 buffer on their device."""
    return torch.cat([t.reshape(-1).double() for t in out])


def unpack_outputs(flat: np.ndarray, width: int, out_dtype: torch.dtype) -> tuple:
    """`pack_outputs`' buffer back on the host: numpy (dst int32, is_local
    bool, delay_est, job_total), each (width, J); the floats at float32 when
    the pass ran in float32, else float64."""
    j = flat.shape[0] // (4 * width)
    parts = flat.reshape(4, width, j)
    ftype = np.float32 if out_dtype == torch.float32 else np.float64  # fp32-island(host decoding: float32 passes stay float32)
    return (parts[0].astype(np.int32), parts[1].astype(bool),
            parts[2].astype(ftype), parts[3].astype(ftype))


def param_signature(state: dict) -> list:
    """Structural signature of a state dict: (name, shape, dtype) per leaf.
    Two state dicts with equal signatures can be swapped in place."""
    return [(name, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for name, t in state.items()]


@dataclasses.dataclass
class DispatchHandle:
    """One in-flight dispatch: outputs packed into `host` (float64), whose
    copy from the card completes when `event` does (None on the CPU)."""

    bucket: int
    width: int
    host: torch.Tensor
    event: Optional[torch.cuda.Event]
    device_buf: torch.Tensor  # kept alive until the copy completes
    out_dtype: torch.dtype
    program: Optional[obs_prof.ProfiledProgram] = None
    t0: float = 0.0


class BucketExecutor:
    """Batched decision passes of one model, plus its weight state."""

    def __init__(self, model, layout=None, device=None, precision=None,
                 apsp_impl: str = "xla", prob: bool = False,
                 slots: Optional[int] = None, fp_impl: str = "xla"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.layout = resolve_layout(layout)
        # the APSP of every dispatch runs in the policy's compute dtype, on
        # the route of `apsp_impl` (JAX `executor.py:236-239`: a wrapped
        # APSP per bucket program, resolved at its pad)
        self.precision = resolve_precision(precision)
        check_apsp_impl(apsp_impl)
        self.apsp_impl = apsp_impl
        # the fixed-point core of `fp_impl` (JAX `executor.py:240`), resolved
        # at each batch's link pad: with 'xla' (JAX's default) the sparse
        # layout takes its segment-sum fixed point
        resolve_fixed_point(fp_impl, 1)
        self.fp_impl = fp_impl
        self.prob = bool(prob)
        self.dispatch_count = 0
        self.dispatches_by_width: Dict[Tuple[int, int], int] = {}
        self.loaded_step: Optional[int] = None
        self.loaded_lineage: Optional[dict] = None
        # semantic pre-swap gate (loop.canary.CheckpointCanary), attached by
        # cli.loop; None: only the non-finite gate refuses weights
        self.canary = None
        self._canary_rejected: set = set()
        self.last_devmetrics: Optional[dict] = None
        # host seconds spent inside dispatch (enqueue) and fetch (wait)
        self.host_s = {"dispatch": 0.0, "fetch": 0.0}
        # the full width (None: unknown, every width is the full one), and
        # the prof-layer programs by (bucket, width, degraded)
        self.slots = None if slots is None else int(slots)
        self._programs: Dict[tuple, obs_prof.ProfiledProgram] = {}

    def program(self, bucket: int, width: Optional[int], degraded: bool):
        """The prof-layer program of one (bucket, width) pass, JAX's name."""
        full = width is None or self.slots is None or int(width) == self.slots
        key = (bucket, None if full else int(width), bool(degraded))
        prog = self._programs.get(key)
        if prog is None:
            kind = "baseline" if degraded else "gnn"
            suffix = "" if full else f"/w{int(width)}"
            fn = ((lambda binst, bjobs, gens: self.baseline_step(binst, bjobs)) if degraded
                  else (lambda binst, bjobs, gens: self.gnn_step(binst, bjobs, gens)))
            prog = self._programs[key] = obs_prof.wrap(f"serve/bucket{bucket}/{kind}{suffix}",
                                                       fn)
        return prog

    def gnn_step(self, binst, bjobs, gens=None, model=None, device=None):
        """The GNN decision pass; `model` and `device` default to the
        executor's (the sharded executor passes a shard's replica)."""
        outcome, _ = forward_env(self.model if model is None else model, binst, bjobs,
                                 gens, prob=self.prob,
                                 device=self.device if device is None else device,
                                 layout=self.layout, precision=self.precision,
                                 apsp_impl=self.apsp_impl, fp_fn=self._fp_fn(binst))
        d = outcome.decision
        return d.dst, d.is_local, d.delay_est, outcome.job_total

    def _fp_fn(self, binst):
        return resolve_fixed_point(self.fp_impl, binst.num_pad_links)[0]

    def baseline_step(self, binst, bjobs):
        o = baseline_policy(binst, bjobs, layout=self.layout, precision=self.precision,
                            apsp_impl=self.apsp_impl, fp_fn=self._fp_fn(binst))
        d = o.decision
        return d.dst, d.is_local, d.delay_est, o.job_total

    @torch.no_grad()
    def dispatch(self, bucket: int, binst, bjobs, degraded: bool = False,
                 request_ids=None, width: Optional[int] = None,
                 gens: Optional[List[torch.Generator]] = None) -> DispatchHandle:
        """Enqueue one batched decision pass (the packed batch already on
        the executor's device) and return without waiting for the card.
        `gens`: one generator per batch row, read by the GNN's sampled
        decision (`prob=True`)."""
        t0 = time.perf_counter()  # nondet-ok(host-time accounting is a measurement)
        w = int(bjobs.mask.shape[0]) if width is None else int(width)
        prog = self.program(bucket, w, degraded)
        out = prog(binst, bjobs, gens)
        counts = observe_decisions(out, bjobs.mask)
        buf = torch.cat([pack_outputs(out), counts.double()])
        if buf.device.type == "cuda":
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = buf, None
        self.dispatch_count += 1
        key = (bucket, w)
        self.dispatches_by_width[key] = self.dispatches_by_width.get(key, 0) + 1
        if request_ids:
            obs_trace.hop(
                "dispatch", request_ids, bucket=bucket,
                dispatch=self.dispatch_count,
                program="baseline" if degraded else "gnn",
                step=self.loaded_step,
            )
        self.host_s["dispatch"] += time.perf_counter() - t0  # nondet-ok(same measurement)
        return DispatchHandle(bucket=bucket, width=w, host=host, event=event,
                              device_buf=buf, out_dtype=out[2].dtype, program=prog, t0=t0)

    def fetch(self, handle: DispatchHandle):
        """Resolve one dispatch: host numpy (dst, is_local, delay_est,
        job_total), each (width, pad.j)."""
        t0 = time.perf_counter()  # nondet-ok(host-time accounting is a measurement)
        if handle.event is not None:
            handle.event.synchronize()
        flat = handle.host.numpy()
        out = unpack_outputs(flat[:-len(_DM_KEYS)], handle.width, handle.out_dtype)
        self.record_decisions(flat[-len(_DM_KEYS):], bucket=str(handle.bucket))
        if handle.program is not None:
            handle.program.account(time.perf_counter() - handle.t0)  # nondet-ok(same measurement)
        self.host_s["fetch"] += time.perf_counter() - t0  # nondet-ok(same measurement)
        return out

    def record_decisions(self, counts, **labels) -> None:
        """One dispatch's device-counted decisions (`observe_decisions`'s
        three counts) into `last_devmetrics` and the registry, with
        `labels` (the bucket; the sharded executor adds its placement)."""
        counts = [int(c) for c in counts]
        self.last_devmetrics = dict(zip(_DM_KEYS, counts))
        reg = obs_registry()
        for decision, c in (("local", counts[0]), ("offload", counts[1])):
            reg.counter("mho_dev_serve_decisions_total",
                        "offloading decisions, counted on the device per dispatch"
                        ).inc(c, decision=decision, **labels)
        reg.counter(DM_SERVE_NONFINITE,
                    "live decision outputs that were NaN/Inf, counted on the device"
                    ).inc(counts[2], **labels)

    @torch.no_grad()
    def load_params(self, state: dict, step: Optional[int] = None,
                    stage: str = "load_params") -> Optional[int]:
        """Swap in the weights of `state` (a state dict of the serving
        model's architecture) without rebuilding anything.  Raises when the
        signature differs; refuses (returns None, counted and logged) a
        state with a non-finite leaf or one the attached canary refuses,
        and the current weights keep serving.  Returns `step` when the swap
        happened."""
        live = self.model.state_dict()
        if param_signature(state) != param_signature(live):
            raise ValueError("params do not match the serving model architecture "
                             "(name/shape/dtype signature)")
        why = None
        if not all(bool(torch.isfinite(t).all()) for t in state.values()):
            why = "nonfinite_weights"
        elif self.canary is not None:
            why = self.canary.check({"params": state})
        if why is not None:
            obs_registry().counter(
                "mho_canary_rejections_total",
                "candidate weight sets refused by the semantic canary",
            ).inc(stage=stage, reason=why.split(":")[0])
            obs_events.emit("canary_reject", step=step, stage=stage, reason=why)
            return None
        for name, t in live.items():
            t.copy_(state[name])
        self.loaded_step = step
        return step

    def hot_reload(self, model_dir: str, which: str = "torch") -> Optional[int]:
        """Swap in the newest verified checkpoint under `model_dir/which`
        (the port's ``torch/``) when it is newer than what is loaded.
        Returns the step loaded, or None when already current, when there
        is no checkpoint, or when the weights were refused (a refused step
        is not retried).  A truncated or bit-flipped newest step is
        quarantined and the load falls back down the lineage
        (`restore_verified`), usually to what already serves, so the swap
        is a no-op.  A checkpoint of another architecture raises
        ValueError."""
        directory = os.path.join(model_dir, which)
        step = ckpt_lib.latest_step(directory)
        if (step is None or step == self.loaded_step
                or step in self._canary_rejected):
            return None
        restored, step = ckpt_lib.restore_verified(directory)
        if (restored is None or step == self.loaded_step
                or step in self._canary_rejected):
            return None  # nothing verified newer: keep serving last-good
        params = restored.get("params") if isinstance(restored, dict) else None
        if not isinstance(params, dict):
            raise ValueError(f"checkpoint {directory} step {step} holds no params")
        if self.load_params(params, step, stage="hot_reload") is None:
            self._canary_rejected.add(step)
            return None
        self.loaded_lineage = ckpt_lib.load_lineage(directory, step)
        return step
