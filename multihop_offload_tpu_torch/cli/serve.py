"""Serving entry point — run the offloading-decision service.

Port of `multihop_offload_tpu/cli/serve.py` (single device):

    python -m multihop_offload_tpu_torch.cli.serve [--device cpu] \\
        --serve_sizes=20,50,80,110 --serve_slots=16 --serve_requests=256 \\
        --serve_model=SCRATCH800_decay0.99

Builds the bucket ladder from the configured traffic profile, loads the
committed model `--serve_model` (a seeded fresh init when it is empty),
drives the closed-loop demo over a synthetic request stream and prints the
serving summary as JSON.  It runs on CUDA unless `--device cpu` is given,
and raises when CUDA is absent.  The JAX demo stops ticking once the queue
is empty, which under `--serve_overlap` leaves the last dispatched batch
unanswered; here `drain()` settles it, so every admitted request is
answered.
"""

from __future__ import annotations

import json
import time

import torch

from multihop_offload_tpu_torch.config import Config, from_cli


def build_service(cfg: Config, pool=None, clock=None, model=None, device=None):
    """Construct (service, pool) from config.  `pool` overrides the traffic
    pool of `cfg.serve_sizes`; `clock` the service's time source; `model`
    the model to serve (default: the committed `cfg.serve_model`, or a fresh
    init seeded by `cfg.seed`); `device` where it runs (default CUDA)."""
    from multihop_offload_tpu_torch.models.chebconv import load_model, make_model
    from multihop_offload_tpu_torch.serve.service import OffloadService
    from multihop_offload_tpu_torch.serve.workload import buckets_for_pool, case_pool

    if cfg.serve_mesh > 1 or cfg.serve_devices.strip():
        raise NotImplementedError(
            "sharded serving (serve_mesh / serve_devices) is not ported yet; "
            "the port serves on one device")
    if pool is None:
        sizes = [int(s) for s in str(cfg.serve_sizes).split(",") if s.strip()]
        pool = case_pool(sizes, per_size=2, seed=cfg.seed)
    buckets = buckets_for_pool(
        pool, num_buckets=max(1, cfg.serve_buckets), round_to=cfg.round_to
    )
    dtype = cfg.torch_dtype
    source = "the given model"
    if model is None and cfg.serve_model:
        model = load_model(cfg.serve_model, dtype=dtype, device="cpu",
                           layout=cfg.layout)
        source = f"committed model {cfg.serve_model}"
    elif model is None:
        model = make_model(cfg, dtype=dtype, layout=cfg.layout,
                           generator=torch.Generator().manual_seed(cfg.seed))
        source = f"fresh-init weights (seed {cfg.seed})"
    service = OffloadService(
        model, buckets,
        slots=cfg.serve_slots, queue_cap=cfg.serve_queue_cap,
        deadline_s=cfg.serve_deadline_s, prob=cfg.prob,
        dtype=dtype, precision=cfg.precision, layout=cfg.layout,
        trace=cfg.obs_trace,
        ragged=cfg.serve_ragged, overlap=cfg.serve_overlap,
        ladder_alpha=cfg.serve_ladder_alpha,
        ladder_hysteresis=cfg.serve_ladder_hysteresis,
        device=device,
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
    print(f"serving with {source} on {service.device}")
    return service, pool


def main(argv=None):
    from multihop_offload_tpu_torch.serve.workload import request_stream

    cfg, device = from_cli(argv, __doc__)
    service, pool = build_service(cfg, device=device)

    t0 = time.monotonic()
    stream = request_stream(
        pool, cfg.serve_requests, seed=cfg.seed + 1,
        arrival_scale=cfg.arrival_scale, ul=cfg.ul_data, dl=cfg.dl_data,
        t_max=float(cfg.T),
    )
    # closed loop: keep the queue full, tick, refill; a refused submit is
    # retried after the next tick when it was backpressure, dropped otherwise
    pending = list(stream)
    pending.reverse()
    while pending or service.queue_depth:
        while pending:
            req = pending.pop()
            if not service.submit(req):
                if service.last_submit_outcome == "backpressure":
                    pending.append(req)   # retryable: after the next tick
                break
        service.tick()
    service.drain()
    summary = service.stats.summary(wall_s=time.monotonic() - t0)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
