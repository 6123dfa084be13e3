"""Serving entry point — run the offloading-decision service.

Port of `multihop_offload_tpu/cli/serve.py`:

    python -m multihop_offload_tpu_torch.cli.serve [--device cpu] \\
        --serve_sizes=20,50,80,110 --serve_slots=16 --serve_requests=256 \\
        --serve_model=SCRATCH800_decay0.99 [--obs_log run.jsonl] [--obs_prom m.prom]

Builds the bucket ladder from the configured traffic profile, loads the
committed model `--serve_model` (a seeded fresh init when it is empty),
then the newest verified checkpoint of the port's ``torch/`` directory
under the model directory (`--model_root`, `--training_set`: where
`cli.train` writes) when there is one, drives the closed-loop demo over a
synthetic request stream and prints the serving summary as JSON.  It runs
on CUDA unless `--device cpu` is given, and raises when CUDA is absent.

The process wiring is JAX's (`cli/serve.py:132-188`): `--obs_log` opens
the JSONL run log (`--obs_log_max_bytes` rotates it, `--obs_prom` writes
the metric registry as Prometheus text at exit); between ticks the
service hot-reloads a newer checkpoint (a corrupt one is quarantined and
the last good step keeps serving); SIGTERM or SIGINT stops the feed, the
service answers every request it admitted, a `shutdown` event records
the signal and the requests never submitted, and the run log is sealed
terminally.  A second signal kills the process.  `--io_retries` and
`--io_backoff_s` set the bounded retry around checkpoint reads.  The JAX
demo stops ticking once the queue is empty, which under `--serve_overlap`
leaves the last dispatched batch unanswered; here `drain()` settles it.
`--precision bf16` (or `auto` on the card) serves under the bf16 policy;
`--prob true` samples each request's decision from its own generator,
seeded from (`--seed`, request id).  `--tb_logdir` is refused (no
TensorBoard on the card's machine).

Sharded serving (`resolve_serve_devices`): `--serve_devices 0,2` serves on
those CUDA devices, `--serve_mesh N` on the first N (it raises when fewer
are present; `build_service(devices=[cuda:0] * N)` lays N shards over one
card).  With `--device cpu`, `--serve_mesh N` serves on `[cpu] * N`, the
counterpart of JAX's virtual CPU devices.  `--serve_replan_ticks` sets the
placement planner's cadence.
"""

from __future__ import annotations

import json
import time

import torch

from multihop_offload_tpu_torch.config import Config, from_cli


def resolve_serve_devices(cfg: Config, device=None):
    """The serving fleet from config (JAX `cli/serve.py:23-58`):
    `serve_devices` (CUDA ids, e.g. "0,2,5") wins; else `serve_mesh` = N
    takes the first N local CUDA devices, or `[cpu] * N` when the caller
    asked for the CPU (`device`).  Returns None for the one-device
    executor.  Raises when the devices asked for are not present: a fleet
    never falls back to the CPU on its own."""
    spec = str(cfg.serve_devices or "").strip()
    cpu = device is not None and torch.device(device).type == "cpu"
    if spec:
        try:
            ids = [int(s) for s in spec.split(",") if s.strip()]
        except ValueError as e:
            raise ValueError(f"serve_devices must be int ids: {spec!r}") from e
        have = list(range(torch.cuda.device_count()))
        missing = [i for i in ids if i not in have]
        if missing:
            raise ValueError(
                f"serve_devices {missing} not present (have {have}); on the CPU "
                "set serve_mesh=N with device='cpu'")
        if cpu:
            raise ValueError("serve_devices names CUDA devices, but the CPU was asked "
                             "for; set serve_mesh=N to serve on [cpu] * N")
        return [torch.device("cuda", i) for i in ids]
    mesh = int(cfg.serve_mesh or 0)
    if mesh <= 1:
        return None
    if cpu:
        return [torch.device("cpu")] * mesh
    have = torch.cuda.device_count()
    if mesh > have:
        raise ValueError(
            f"serve_mesh={mesh} but only {have} CUDA devices present; pass "
            f"devices=[torch.device('cuda', 0)] * {mesh} to build_service for "
            f"{mesh} shards on one card")
    return [torch.device("cuda", i) for i in range(mesh)]


def build_service(cfg: Config, pool=None, clock=None, model=None, device=None,
                  devices=None, load_checkpoint: bool = True):
    """Construct (service, pool) from config.  `pool` overrides the traffic
    pool of `cfg.serve_sizes`; `clock` the service's time source; `model`
    the model to serve (default: the committed `cfg.serve_model`, or a fresh
    init seeded by `cfg.seed` on a CPU generator, built under
    `cfg.precision`'s policy; a given model must carry it); `device` where
    it runs (default CUDA).  `devices` is the serving fleet outright (JAX
    `:106`; repeats honoured), else `resolve_serve_devices`; a fleet shards
    every bucket's batch over it.  The newest verified step of
    ``cfg.model_dir()/torch`` then replaces those weights when there is one
    and `load_checkpoint` (JAX `cli/serve.py:125`)."""
    from multihop_offload_tpu_torch.models.chebconv import load_model, make_model
    from multihop_offload_tpu_torch.serve.service import OffloadService
    from multihop_offload_tpu_torch.serve.workload import buckets_for_pool, case_pool
    from multihop_offload_tpu_torch.utils import durable

    fleet = list(devices) if devices is not None else resolve_serve_devices(cfg, device)
    if fleet:
        device = fleet[0]
    durable.configure(retries=cfg.io_retries, backoff_s=cfg.io_backoff_s)
    if pool is None:
        sizes = [int(s) for s in str(cfg.serve_sizes).split(",") if s.strip()]
        pool = case_pool(sizes, per_size=2, seed=cfg.seed)
    buckets = buckets_for_pool(
        pool, num_buckets=max(1, cfg.serve_buckets), round_to=cfg.round_to
    )
    dtype = cfg.torch_dtype
    policy = cfg.precision_policy("cuda" if device is None else device)
    source = "the given model"
    if model is None and cfg.serve_model:
        model = load_model(cfg.serve_model, device="cpu", layout=cfg.layout,
                           policy=policy)
        source = f"committed model {cfg.serve_model}"
    elif model is None:
        model = make_model(cfg, layout=cfg.layout, policy=policy,
                           generator=torch.Generator().manual_seed(cfg.seed))
        source = f"fresh-init weights (seed {cfg.seed})"
    service = OffloadService(
        model, buckets,
        slots=cfg.serve_slots, queue_cap=cfg.serve_queue_cap,
        deadline_s=cfg.serve_deadline_s, seed=cfg.seed, prob=cfg.prob,
        dtype=dtype, precision=policy, layout=cfg.layout, apsp_impl=cfg.apsp_impl,
        trace=cfg.obs_trace,
        ragged=cfg.serve_ragged, overlap=cfg.serve_overlap,
        ladder_alpha=cfg.serve_ladder_alpha,
        ladder_hysteresis=cfg.serve_ladder_hysteresis,
        device=device, mesh_devices=fleet or None,
        replan_every=max(1, int(cfg.serve_replan_ticks)),
        **({"clock": clock} if clock is not None else {}),
    )
    if cfg.health_watchdog_s > 0:
        from multihop_offload_tpu_torch.obs.flightrec import FlightRecorder
        from multihop_offload_tpu_torch.serve.watchdog import TickWatchdog

        service.attach_watchdog(TickWatchdog(
            cfg.health_watchdog_s,
            recovery_s=cfg.health_watchdog_recovery_s,
            recorder=FlightRecorder(cfg.obs_flight_capacity),
            flight_dir=cfg.model_root,
        ))
    loaded = service.hot_reload(cfg.model_dir()) if load_checkpoint else None
    if loaded is not None:
        source = f"checkpoint step {loaded} from {cfg.model_dir()}"
    where = ([str(d) for d in service.executor.fleet] if service.planner is not None
             else service.device)
    print(f"serving with {source} on {where}")
    return service, pool


def main(argv=None):
    from multihop_offload_tpu_torch import obs
    from multihop_offload_tpu_torch.obs import events as obs_events
    from multihop_offload_tpu_torch.serve.workload import request_stream
    from multihop_offload_tpu_torch.utils.signals import GracefulDrain

    cfg, device = from_cli(argv, __doc__)
    if cfg.tb_logdir:
        raise NotImplementedError(
            "tb_logdir: TensorBoard scalars are not ported (ROADMAP.md Queue 1 item 3); "
            "use obs_log for the JSONL run log")
    runlog = obs.start_run(cfg, role="serve")
    service, pool = build_service(cfg, device=device)
    drain = GracefulDrain().install()

    t0 = time.monotonic()
    stream = request_stream(
        pool, cfg.serve_requests, seed=cfg.seed + 1,
        arrival_scale=cfg.arrival_scale, ul=cfg.ul_data, dl=cfg.dl_data,
        t_max=float(cfg.T),
    )
    # closed loop: keep the queue full, tick, refill; a refused submit is
    # retried after the next tick when it was backpressure, dropped
    # otherwise.  SIGTERM/SIGINT stops the feed, finishes what was
    # admitted, and closes the log terminally.
    pending = list(stream)
    pending.reverse()
    while pending or service.queue_depth:
        if drain.requested:
            break
        while pending:
            req = pending.pop()
            if not service.submit(req):
                if service.last_submit_outcome == "backpressure":
                    pending.append(req)   # retryable: after the next tick
                break
        service.tick()
        # newly trained weights are picked up between ticks, not mid-batch
        service.hot_reload(cfg.model_dir())
    # everything already admitted is answered, the in-flight overlap
    # batches included
    service.drain()
    if drain.requested:
        obs_events.emit("shutdown", reason="signal", signum=drain.signum,
                        unserved=len(pending))
    drain.uninstall()
    summary = service.stats.summary(wall_s=time.monotonic() - t0)
    obs.finish_run(runlog, terminal=drain.requested)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
