"""Health entry point: SLOs, drift, flight recorder.

Port of `multihop_offload_tpu/cli/health.py` (`mho-health`):

    python -m multihop_offload_tpu_torch.cli.health      # the serving SLO set
    python -m multihop_offload_tpu_torch.cli.health --smoke [--device cpu]
        # the closed-loop breach drill

The smoke run is the proof the health subsystem closes its loop: a serve
phase on a MANUAL clock (calm traffic, then an injected latency/overload
burst, then recovery) must make the SLO engine fire and resolve an alert,
the breach must dump a flight-recorder bundle, the drift detectors must
trip on the shifted outcome stream, the trip must move the flywheel into
`capturing` via `drift_triggered`, and a mini refit must promote, giving
one request a complete submit -> ... -> promotion trace.  JAX's
steady-state retrace check (`jaxhooks`) has no counterpart in eager torch:
the record reports it as not applicable.  The record is written only
where `--health_out` names a file.  It runs on CUDA unless `--device cpu`
is given, and raises when CUDA is absent.
"""

from __future__ import annotations

import dataclasses
import json
import os

from multihop_offload_tpu_torch.config import Config, build_parser
from multihop_offload_tpu_torch.obs import NOT_APPLICABLE_RETRACES


def smoke_config(cfg: Config, tmp: str) -> Config:
    """Tiny single-bucket service with a small bounded queue (so the burst
    produces backpressure refusals), rotation-sized log segments, full
    capture, and second-scale burn-rate windows for the manual clock."""
    return dataclasses.replace(
        cfg,
        serve_sizes="10", serve_buckets=1, serve_slots=4,
        serve_queue_cap=16, serve_deadline_s=60.0,
        model_root=os.path.join(tmp, "model"),
        obs_log=os.path.join(tmp, "health_run.jsonl"),
        obs_log_max_bytes=4096,
        loop_capture_sample=1.0,
        loop_refit_steps=2, loop_refit_slots=2,
        learning_rate=1e-6, learning_decay=1.0,
        health_short_s=2.0, health_long_s=8.0,
    )


def _drive(service, reqs, t, chunk: int, dwell: float,
           ticks_after: int = 0):
    """Closed-loop submit/tick on the manual clock `t`: up to `chunk`
    submits per tick, `dwell` seconds of simulated time per tick (that IS
    the injected latency), refused submits shed (the burst is the point).
    Returns (responses, refused)."""
    pending = list(reqs)
    pending.reverse()
    refused = 0
    responses = []
    while pending or service.queue_depth:
        for _ in range(chunk):
            if not pending:
                break
            if not service.submit(pending.pop()):
                refused += 1
        t["now"] += dwell
        responses.extend(service.tick())
    for _ in range(ticks_after):
        t["now"] += dwell
        responses.extend(service.tick())
    return responses, refused


def run_smoke(cfg: Config, device=None, tmp=None) -> dict:
    """calm -> burst (alert fires, bundle dumps) -> recovery (alert
    resolves) -> drift trips -> drift-triggered capture -> refit ->
    promote, asserting every link of that chain.  The service runs on
    `device` (default CUDA); `tmp` keeps the run's files (default: a
    temporary directory removed afterwards)."""
    import tempfile

    from multihop_offload_tpu_torch import obs
    from multihop_offload_tpu_torch.cli.loop import _bootstrap_champion, _state
    from multihop_offload_tpu_torch.cli.serve import build_service
    from multihop_offload_tpu_torch.loop.experience import read_outcomes
    from multihop_offload_tpu_torch.loop.promote import PromotionController
    from multihop_offload_tpu_torch.loop.refit import refit_and_save
    from multihop_offload_tpu_torch.obs import events as obs_events
    from multihop_offload_tpu_torch.obs.drift import DriftMonitor
    from multihop_offload_tpu_torch.obs.flightrec import FlightRecorder
    from multihop_offload_tpu_torch.obs.slo import SLOEngine, default_serving_slos
    from multihop_offload_tpu_torch.obs.trace import reconstruct
    from multihop_offload_tpu_torch.serve.workload import request_stream

    with tempfile.TemporaryDirectory(prefix="mho_health_smoke_") as scratch:
        scfg = smoke_config(cfg, tmp or scratch)
        runlog = obs.start_run(scfg, role="health")
        try:
            t = {"now": 0.0}

            def clock():
                return t["now"]

            service, pool = build_service(scfg, clock=clock, device=device)
            controller = PromotionController(scfg.model_dir())
            _bootstrap_champion(scfg, service)

            recorder = FlightRecorder(
                capacity=scfg.obs_flight_capacity, clock=clock
            )
            engine = SLOEngine(
                default_serving_slos(latency_le=0.25, queue_bound=12.0),
                short_s=scfg.health_short_s, long_s=scfg.health_long_s,
            )
            flight_dir = os.path.join(tmp or scratch, "flight")
            bundles = []
            engine.on_breach(lambda spec, info: bundles.append(
                recorder.dump(flight_dir, spec.name,
                              alerts=engine.state(), extra={"alert": info})
            ))
            service.attach_health(slo=engine, recorder=recorder)

            record: dict = {"phases": {}}

            # ---- phase A: calm (warms the drift detectors) ---------------
            calm = request_stream(
                pool, 48, seed=scfg.seed + 1,
                arrival_scale=scfg.arrival_scale,
                ul=scfg.ul_data, dl=scfg.dl_data, t_max=float(scfg.T),
            )
            resp_a, ref_a = _drive(service, calm, t, chunk=4, dwell=0.05)
            record["phases"]["calm"] = {"served": len(resp_a),
                                        "refused": ref_a}

            # ---- phase B: injected burst ---------------------------------
            # 1 s of stall per tick (latency >> 0.25 s bound), 12x arrival
            # rates (the drift signal), submits faster than the drain rate
            # (queue past its bound + backpressure refusals)
            burst = request_stream(
                pool, 32, seed=scfg.seed + 2,
                arrival_scale=scfg.arrival_scale * 12.0,
                ul=scfg.ul_data, dl=scfg.dl_data, t_max=float(scfg.T),
                id_offset=1000,
            )
            resp_b, ref_b = _drive(service, burst, t, chunk=8, dwell=1.0)
            record["phases"]["burst"] = {"served": len(resp_b),
                                         "refused": ref_b}

            # ---- phase C: recovery (short window drains -> resolve) ------
            calm2 = request_stream(
                pool, 20, seed=scfg.seed + 3,
                arrival_scale=scfg.arrival_scale,
                ul=scfg.ul_data, dl=scfg.dl_data, t_max=float(scfg.T),
                id_offset=2000,
            )
            resp_c, ref_c = _drive(service, calm2, t, chunk=2, dwell=0.1,
                                   ticks_after=25)
            record["phases"]["recovery"] = {"served": len(resp_c),
                                            "refused": ref_c}

            # ---- drift -> capture -> refit -> promote --------------------
            outcomes = read_outcomes(scfg.obs_log)
            monitor = DriftMonitor()
            trips = monitor.feed(outcomes)
            record["drift_trips"] = trips
            step = None
            refit_info = None
            if trips:
                controller.drift_triggered(trips[0])
                controller.transition("refitting", train=len(outcomes))
                cand_vars, cand_step, refit_info = refit_and_save(
                    service.executor.model, {"params": _state(service)}, outcomes,
                    scfg, parent_step=service.executor.loaded_step,
                    seed=scfg.seed, device=device,
                )
                # the sim A/B gate is the loop's concern; the health smoke
                # proves the trace chain reaches promotion lineage
                controller.transition(
                    "validating", skipped="health smoke: sim gate in the loop"
                )
                step = controller.promote(
                    service, cand_vars, candidate_step=cand_step,
                    experience_ids=[o.request.request_id for o in outcomes],
                )
            record["refit"] = refit_info
            record["promoted_step"] = step

            # ---- evidence ------------------------------------------------
            alert_events = [
                {"name": ev.get("name"), "state": ev.get("state"),
                 "at": ev.get("at")}
                for ev in obs_events.read_events(scfg.obs_log)
                if ev.get("event") == "alert"
            ]
            rid = (outcomes[0].request.request_id if outcomes
                   else (resp_a[0].request_id if resp_a else 0))
            hops = reconstruct(scfg.obs_log, rid)
            segments = len(obs_events.segment_paths(scfg.obs_log))
            written = [b for b in bundles if b]
            record.update(
                alerts=alert_events,
                slo_state=engine.state(),
                flight_bundles=[
                    {"name": os.path.basename(b),
                     "records": sum(1 for _ in open(
                         os.path.join(b, "records.jsonl")))}
                    for b in written
                ],
                trace={"request_id": int(rid),
                       "hops": [h["hop"] for h in hops]},
                log_segments=segments,
                unexpected_retraces=None,
            )
            capturing_via_drift = any(
                h.get("state") == "capturing"
                and h.get("trigger") == "drift_triggered"
                for h in controller.history
            )
            checks = {
                "alert_fired": any(a["state"] == "firing"
                                   for a in alert_events),
                "alert_resolved": any(a["state"] == "resolved"
                                      for a in alert_events),
                "p99_alert": any(a["name"] == "serve_p99"
                                 for a in alert_events),
                "flight_bundle_written": bool(written) and all(
                    os.path.exists(os.path.join(b, f)) for b in written
                    for f in ("bundle.json", "records.jsonl", "metrics.prom")
                ),
                "flight_ring_nonempty": len(recorder) > 0,
                "drift_tripped": len(trips) >= 1,
                "capturing_via_drift": capturing_via_drift,
                "promoted": step is not None,
                "trace_hops": len(hops) >= 4,
                "log_rotated": segments >= 2,
                "steady_serving_no_retrace": {"ok": None,
                                              "not_applicable": NOT_APPLICABLE_RETRACES},
                "burst_refused_some": ref_b > 0,
            }
            record["checks"] = checks
            record["ok"] = all(v for v in checks.values() if isinstance(v, bool))
        finally:
            obs.finish_run(runlog)
    assert record["ok"], f"health smoke failed: {record['checks']}"
    return record


def render_specs() -> str:
    """The default serving SLO set, as the CLI prints it."""
    from multihop_offload_tpu_torch.obs.slo import default_serving_slos

    lines = ["serving SLOs (obs.slo.default_serving_slos)"]
    for s in default_serving_slos():
        lines.append(
            f"  {s.name:<26} {s.kind:<13} objective={s.objective:<7g}"
            f" {s.description}"
        )
    lines.append("  burn-rate rule: fire iff burn(short) > 1 AND "
                 "burn(long) > 1 (see docs/OPERATIONS.md)")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    from multihop_offload_tpu_torch._device import resolve_device
    from multihop_offload_tpu_torch.cli.loop import write_record

    p = build_parser(description=__doc__)
    p.add_argument("--smoke", action="store_true",
                   help="closed-loop health drill: injected burst -> alert -> "
                        "flight dump -> drift -> drift-triggered capture -> "
                        "promote; writes its record where --health_out names")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    ns = vars(p.parse_args(argv))
    smoke, device = ns.pop("smoke"), ns.pop("device")
    cfg = Config(**ns)

    if not smoke:
        print(render_specs(), end="")
        return 0

    dev = resolve_device(device)  # no CPU fallback: raises when CUDA is absent
    out = run_smoke(cfg, device=dev)
    if cfg.health_out:
        write_record(out, cfg.health_out)
        print(f"health smoke record written to {cfg.health_out}")
    print(json.dumps(out["checks"], indent=2))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
