"""Continual-learning flywheel entry point (`mho-loop`).

Port of `multihop_offload_tpu/cli/loop.py`:

    python -m multihop_offload_tpu_torch.cli.loop --smoke [--device cpu] \\
        [--loop_out loop_smoke.json]
    python -m multihop_offload_tpu_torch.cli.loop --obs_log=runs/loop.jsonl \\
        --loop_capture_sample=0.1 --loop_cycles=4 --serve_sizes=16,24

One cycle closes serve -> train -> serve: drive traffic through the
service with experience capture on, re-fit the policy on the captured
outcomes (`loop.refit`: K1 forward and backward and K2 on the card),
A/B the candidate against the serving champion in the packet simulator on
a held-out slice (`loop.validate`: the `gnn` policy's K1 and K2), probe it
with the semantic canary (`loop.canary`) and promote it through the
service's hot reload -- with automatic rollback if the sim gates fail or
the post-promotion measured tau regresses (`loop.promote`).  Every phase
is journaled, so a process killed at any crash site resumes the cycle
where it stopped (`PromotionController.resume`).

The smoke run forces a rotation-sized run log, a winning candidate (tiny
LR: the machinery is under test, not the learning), and an injected
post-promotion regression, so both the promotion and the rollback paths
execute in one run; its record is written only where `--loop_out` names.
It runs on CUDA unless `--device cpu` is given.  JAX's retrace listeners
(`obs.jaxhooks`) have no counterpart in eager torch, so the record carries
no retrace count.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from multihop_offload_tpu_torch._device import resolve_device
from multihop_offload_tpu_torch.config import Config, build_parser


def _state(service) -> dict:
    """The serving model's parameters, copied (the live tensors change in
    place on every swap)."""
    return {k: v.detach().clone() for k, v in service.executor.model.state_dict().items()}


def _bootstrap_champion(cfg: Config, service) -> int:
    """Ensure a serving checkpoint exists: a flywheel needs a champion to
    measure against, so a virgin model dir gets the service's own (fresh
    init, committed or restored) weights saved as step 1,
    `source="offline"`."""
    from multihop_offload_tpu_torch.loop.refit import SERVING_SUBDIR
    from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib

    directory = os.path.join(cfg.model_dir(), SERVING_SUBDIR)
    step = ckpt_lib.latest_step(directory)
    if step is None:
        host = {k: v.cpu() for k, v in _state(service).items()}
        ckpt_lib.save_checkpoint(
            directory, 1, {"params": host},
            lineage=ckpt_lib.make_lineage(
                "offline", cfg=cfg, extra={"bootstrap": True}
            ),
        )
        step = 1
    service.hot_reload(cfg.model_dir())
    return step


def _capture_window(cfg: Config, service, pool, count: int, id_offset: int,
                    site: str = "capture:mid"):
    """Drive `count` synthetic requests through submit/tick (closed loop,
    `cli.serve` semantics) with capture on; returns (responses, next_id).
    `site` names the chaos crashpoint inside the loop: a window is
    replayable (ids are deterministic from `id_offset`), so a kill here
    resumes by re-serving the same window."""
    from multihop_offload_tpu_torch.chaos import faults
    from multihop_offload_tpu_torch.serve.workload import request_stream

    pending = list(request_stream(
        pool, count, seed=cfg.seed + 1 + id_offset,
        arrival_scale=cfg.arrival_scale, ul=cfg.ul_data, dl=cfg.dl_data,
        t_max=float(cfg.T), id_offset=id_offset,
    ))
    pending.reverse()
    responses = []
    while pending or service.queue_depth:
        faults.crashpoint(site)
        while pending:
            req = pending.pop()
            if not service.submit(req):
                if service.last_submit_outcome == "backpressure":
                    pending.append(req)   # retryable after the next tick
                break
        responses.extend(service.tick())
    # under `serve_overlap` the last dispatched batch settles here (JAX's
    # loop leaves it unanswered)
    responses.extend(service.drain())
    return responses, id_offset + count


def _window_tau(responses):
    """Measured mean tau of a window's GNN-served responses (None when the
    window had none -- e.g. fully degraded)."""
    taus = [
        float(np.asarray(r.job_total).mean())
        for r in responses if r.served_by == "gnn" and r.job_total.size
    ]
    return float(np.mean(taus)) if taus else None


# resumable-phase order: a journaled state maps to the first phase the
# resumed cycle still has to run (terminal states are not in here -- a
# resume on them starts the next cycle fresh)
_PHASE_ORDER = {
    "capturing": 0, "refitting": 1, "validating": 2, "canarying": 3,
    "promoting": 3, "promoted": 4, "monitoring": 5, "rolling_back": 6,
}


def run_cycle(
    cfg: Config,
    model,
    service,
    pool,
    controller,
    id_offset: int,
    cycle: int = 0,
    inject_regression: bool = False,
    drift_monitor=None,
    resume_state=None,
    canary=None,
):
    """One full flywheel cycle; returns (record, next_id_offset).

    `resume_state` (a journaled mid-cycle state from
    `PromotionController.resume`) skips the phases a killed predecessor
    already completed: outcomes are re-read from the durable event log,
    the pinned candidate/champion/target steps come from the journal ctx,
    and verified on-disk artifacts are reused instead of redone -- so the
    resumed cycle lands on the same terminal state and lineage as an
    uninterrupted run.  Refit and validation run on the service's device."""
    from multihop_offload_tpu_torch.loop.experience import read_outcomes, split_holdout
    from multihop_offload_tpu_torch.loop.promote import monitor_ok
    from multihop_offload_tpu_torch.loop.refit import candidate_dir, refit_and_save
    from multihop_offload_tpu_torch.loop.validate import ab_compare, apply_gates
    from multihop_offload_tpu_torch.obs.registry import registry as obs_registry
    from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib

    t_cycle = time.perf_counter()
    start = _PHASE_ORDER[resume_state] if resume_state else 0
    if resume_state:
        cycle = int(controller.ctx.get("cycle", cycle))
        id_offset = int(controller.ctx.get("id_offset", id_offset))
    record: dict = {"cycle": cycle}
    if resume_state:
        record["resumed_from"] = resume_state
    pre_tau = controller.ctx.get("pre_tau") if resume_state else None
    cand_step = controller.ctx.get("candidate_step") if resume_state else None
    cand_vars = None
    champion_vars = None
    cdir = candidate_dir(cfg.model_dir())
    device = service.device

    def _champion():
        """The pre-promotion champion params: the live tree on a fresh
        run, the journaled champion step on a resume past promotion (the
        serving tree may already hold the bad candidate)."""
        nonlocal champion_vars
        if champion_vars is None:
            cs = controller.ctx.get("champion_step")
            restored, _got = ckpt_lib.restore_verified(controller.directory, step=cs)
            if restored is None:
                raise RuntimeError(
                    f"cannot resume: no verified champion at step {cs} "
                    f"in {controller.directory}"
                )
            champion_vars = {"params": restored["params"]}
        return champion_vars

    def _candidate():
        nonlocal cand_vars
        if cand_vars is None:
            restored = ckpt_lib.restore_checkpoint_raw(cdir, cand_step)
            cand_vars = {"params": restored["params"]}
        return cand_vars

    # ---- capture -----------------------------------------------------------
    if start <= 0:
        if drift_monitor is None:
            controller.transition("capturing", cycle=cycle, id_offset=id_offset)
            responses, id_offset = _capture_window(
                cfg, service, pool, cfg.loop_capture_requests, id_offset
            )
        else:
            # drift-gated entry (--loop_drift): serve a window FIRST, feed
            # the new outcomes to the detectors, and only open a capture
            # cycle when one trips -- otherwise the flywheel stays idle on
            # this traffic
            responses, id_offset = _capture_window(
                cfg, service, pool, cfg.loop_capture_requests, id_offset
            )
            fresh = read_outcomes(cfg.obs_log)[drift_monitor.samples:]
            trips = drift_monitor.feed(fresh)
            record["drift"] = {"samples": drift_monitor.samples, "trips": trips}
            if not trips:
                controller.transition("idle", cycle=cycle, reason="no drift")
                record["skipped"] = "no drift detected"
                record["pre_tau"] = _window_tau(responses)
                return record, id_offset
            controller.drift_triggered(trips[0], cycle=cycle)
        pre_tau = _window_tau(responses)
        record.update(served=len(responses), pre_tau=pre_tau)

    outcomes = read_outcomes(cfg.obs_log)
    record["outcomes"] = len(outcomes)
    train, hold = split_holdout(outcomes, cfg.loop_holdout_frac)
    if not train or not hold:
        controller.transition("idle", reason="insufficient experience")
        record["skipped"] = "insufficient experience"
        return record, id_offset

    # ---- refit -------------------------------------------------------------
    if start <= 1:
        champion_vars = {"params": _state(service)}
        if cand_step is None:
            cand_step = (ckpt_lib.latest_step(cdir) or 0) + 1
        controller.transition(
            "refitting", train=len(train), holdout=len(hold),
            pre_tau=pre_tau, candidate_step=cand_step,
            champion_step=service.executor.loaded_step,
        )
        if resume_state == "refitting" and ckpt_lib.has_verified(cdir, cand_step):
            # the killed run already finished its save: reuse the artifact
            record["refit"] = {"reused": True}
        else:
            cand_vars, cand_step, refit_info = refit_and_save(
                model, champion_vars, train, cfg,
                parent_step=service.executor.loaded_step,
                seed=cfg.seed + cycle, step=cand_step, device=device,
            )
            record["refit"] = refit_info
    record["candidate_step"] = cand_step

    # ---- validate ----------------------------------------------------------
    if start <= 2:
        controller.transition("validating")
        scores = ab_compare(
            model, _champion() if resume_state == "validating" else champion_vars,
            _candidate(), hold,
            rounds=cfg.loop_sim_rounds, slots_per_round=cfg.loop_sim_slots,
            cap=cfg.sim_cap, margin=cfg.sim_margin, seed=cfg.seed,
            round_to=cfg.round_to, precision=cfg.precision_policy(device),
            dtype=cfg.torch_dtype, layout=cfg.layout, device=device,
        )
        ok, reasons = apply_gates(
            scores["champion"], scores["candidate"],
            cfg.loop_gate_delivered_drop, cfg.loop_gate_tau_ratio,
        )
        record["ab"] = scores
        record["gates"] = {
            "ok": ok, "reasons": reasons,
            "max_delivered_drop": cfg.loop_gate_delivered_drop,
            "max_tau_ratio": cfg.loop_gate_tau_ratio,
        }
        if not ok:
            controller.reject("; ".join(reasons), candidate_step=cand_step)
            record["wall_s"] = time.perf_counter() - t_cycle
            return record, id_offset

    # ---- promote -----------------------------------------------------------
    if start <= 3:
        step = controller.promote(
            service, _candidate(),
            lineage=ckpt_lib.make_lineage(
                "refit",
                parent_step=controller.ctx.get(
                    "champion_step", service.executor.loaded_step),
                parent_dir=controller.directory, cfg=cfg,
                extra={"candidate_step": cand_step},
            ),
            candidate_step=cand_step,
            experience_ids=[o.request.request_id for o in train],
            step=(controller.ctx.get("step")
                  if resume_state == "promoting" else None),
            canary=canary,
        )
        record["promoted_step"] = step
        if step is None:
            record["wall_s"] = time.perf_counter() - t_cycle
            return record, id_offset
    else:
        # past the promote phase: the promoted step is `step` in the ctx,
        # except mid-rollback where ctx["step"] is the rollback target and
        # the promoted (failed) step is `failed_step`
        step = int(controller.ctx.get(
            "failed_step" if resume_state == "rolling_back" else "step"))
        record["promoted_step"] = step

    # ---- monitor -----------------------------------------------------------
    do_rollback = False
    rb_reason = ""
    rb_step = None
    if resume_state == "rolling_back":
        do_rollback = True
        rb_reason = str(controller.ctx.get("reason", "resumed rollback"))
        rb_step = controller.ctx.get("step")
        step = controller.ctx.get("failed_step")
    else:
        controller.transition("monitoring", step=step)
        monitor_n = max(cfg.loop_capture_requests // 2, 4)
        responses_b, id_offset = _capture_window(
            cfg, service, pool, monitor_n, id_offset, site="monitor:mid"
        )
        post_tau = _window_tau(responses_b)
        record["post_tau_measured"] = post_tau
        if inject_regression:
            # forced regression: exercise the rollback path
            # deterministically (the measured tau of a 2-step refit won't
            # reliably regress)
            post_tau = (pre_tau or 1.0) * cfg.loop_monitor_regression * 10.0
            record["post_tau_injected"] = post_tau
        if monitor_ok(pre_tau, post_tau, cfg.loop_monitor_regression):
            controller.transition("idle", step=step)
        else:
            do_rollback = True
            rb_reason = ("injected regression" if inject_regression
                         else f"measured tau {post_tau} vs pre {pre_tau}")
    if do_rollback:
        rb = controller.rollback(
            service, _champion(), reason=rb_reason, failed_step=step,
            step=rb_step,
        )
        record["rollback_step"] = rb
        # the rolled-back service must keep serving
        responses_c, id_offset = _capture_window(
            cfg, service, pool,
            max(max(cfg.loop_capture_requests // 2, 4) // 2, 4), id_offset,
            site="monitor:mid",
        )
        record["post_rollback_served"] = len(responses_c)
        record["post_rollback_tau"] = _window_tau(responses_c)
    reg = obs_registry()
    record["counters"] = {
        "promotions": int(reg.counter("mho_loop_promotions_total").total()),
        "rollbacks": int(reg.counter("mho_loop_rollbacks_total").total()),
        "rejections": int(reg.counter("mho_loop_rejections_total").total()),
    }
    record["wall_s"] = time.perf_counter() - t_cycle
    return record, id_offset


def run_loop(cfg: Config, inject_regression: bool = False, service=None,
             pool=None, controller=None, drain=None, device=None) -> dict:
    """Build the service + controller and run `cfg.loop_cycles` cycles.

    The controller comes back through `PromotionController.resume`: when
    the journal sidecar says a previous process died mid-cycle, the first
    cycle here continues from that journaled phase instead of restarting,
    and a journaled cool-down (post-rollback) blocks new cycles until it
    expires.  `service`/`pool`/`controller` are injectable so a drill can
    restart "the process" against one service.  `drain` (a
    `utils.signals.GracefulDrain`) stops BETWEEN cycles on SIGTERM/SIGINT --
    every transition is already journaled, so the next process resumes
    cleanly.  `device`: where a service built here runs (default CUDA)."""
    from multihop_offload_tpu_torch.cli.serve import build_service
    from multihop_offload_tpu_torch.loop.canary import CheckpointCanary
    from multihop_offload_tpu_torch.loop.promote import PromotionController
    from multihop_offload_tpu_torch.obs import events as obs_events
    from multihop_offload_tpu_torch.obs.events import segment_paths

    if service is None:
        service, pool = build_service(cfg, pool=pool, device=device)
    # the template of refit and validation (each works on its own copy)
    model = service.executor.model
    if controller is None:
        controller = PromotionController.resume(
            cfg.model_dir(),
            candidate_keep=cfg.loop_candidate_keep,
            cooldown_s=cfg.loop_cooldown_s,
        )
    champion_step = _bootstrap_champion(cfg, service)
    # the semantic canary: golden probes recorded against the champion the
    # cycle starts from; gates both promotion (controller.promote) and any
    # later hot-reload the service performs (executor.canary)
    canary = CheckpointCanary(service, pool, count=8, seed=cfg.seed + 1234)
    canary.record_champion()
    service.executor.canary = canary
    drift_monitor = None
    if cfg.loop_drift:
        from multihop_offload_tpu_torch.obs.drift import DriftMonitor

        drift_monitor = DriftMonitor()

    resume_state = (controller.state
                    if controller.resumed and controller.state in _PHASE_ORDER
                    else None)
    cycles = []
    id_offset = int(controller.ctx.get("id_offset", 0)) if resume_state else 0
    for c in range(max(cfg.loop_cycles, 1)):
        if drain is not None and drain.requested:
            # orderly SIGTERM/SIGINT: the loop state is already journaled
            # per transition -- just stop opening new cycles
            obs_events.emit("loop_drain", cycle=c, signum=drain.signum)
            break
        wait = controller.cooldown_remaining()
        if wait > 0 and not resume_state:
            obs_events.emit("loop_cooldown_skip", cycle=c, remaining_s=round(wait, 3))
            cycles.append({"cycle": c, "skipped": f"cooldown ({wait:.3f}s remaining)"})
            continue
        rec, id_offset = run_cycle(
            cfg, model, service, pool, controller, id_offset, cycle=c,
            inject_regression=inject_regression,
            drift_monitor=drift_monitor,
            resume_state=resume_state,
            canary=canary,
        )
        resume_state = None
        cycles.append(rec)
        # golden probes track the LIVE champion: after a cycle that moved
        # weights (promotion or rollback), re-record so the next cycle's
        # agreement gate measures against what is actually serving
        canary.record_champion()
    return {
        "champion_bootstrap_step": champion_step,
        "cycles": cycles,
        "states": [h["state"] for h in controller.history],
        "final_state": controller.state,
        "final_loaded_step": service.executor.loaded_step,
        "final_lineage": service.executor.loaded_lineage,
        "log_segments": len(segment_paths(cfg.obs_log)) if cfg.obs_log else 0,
        "device": str(service.device),
    }


def smoke_config(cfg: Config, tmp: str) -> Config:
    """The tiny end-to-end configuration: one bucket, rotation-sized log
    segments, full capture, 2 refit steps, near-zero LR (so the candidate
    ties the champion and the promotion gates pass deterministically)."""
    return dataclasses.replace(
        cfg,
        serve_sizes="10", serve_buckets=1, serve_slots=4,
        serve_queue_cap=64, serve_deadline_s=60.0,
        model_root=os.path.join(tmp, "model"),
        obs_log=os.path.join(tmp, "loop_run.jsonl"),
        obs_log_max_bytes=8192,
        loop_capture_sample=1.0, loop_capture_requests=24,
        loop_refit_steps=2, loop_refit_slots=2, loop_holdout_frac=0.25,
        loop_sim_rounds=2, loop_sim_slots=120, loop_cycles=1,
        sim_cap=64, sim_margin=5.0,
        learning_rate=1e-6, learning_decay=1.0,
    )


def smoke_checks(out: dict) -> dict:
    """The flywheel invariants a smoke run must show."""
    cyc = out["cycles"][0]
    return {
        "log_rotated": out["log_segments"] >= 2,
        "gates_passed": bool(cyc.get("gates", {}).get("ok")),
        "promoted": cyc.get("promoted_step") is not None,
        "rolled_back": cyc.get("rollback_step") is not None,
        "serving_after_rollback": cyc.get("post_rollback_served", 0) > 0,
        "rollback_lineage": (out.get("final_lineage") or {}).get("source") == "rollback",
        "counters_promotions": cyc.get("counters", {}).get("promotions", 0) >= 1,
        "counters_rollbacks": cyc.get("counters", {}).get("rollbacks", 0) >= 1,
    }


def run_smoke(cfg: Config, device=None, tmp=None) -> dict:
    """capture (>= 2 rotated segments) -> refit 2 steps -> validate ->
    promote -> forced regression -> rollback, asserting the flywheel
    invariants along the way.  `tmp` keeps the run's files (default: a
    temporary directory removed afterwards)."""
    import tempfile

    from multihop_offload_tpu_torch import obs

    with tempfile.TemporaryDirectory(prefix="mho_loop_smoke_") as scratch:
        scfg = smoke_config(cfg, tmp or scratch)
        runlog = obs.start_run(scfg, role="loop")
        try:
            out = run_loop(scfg, inject_regression=True, device=device)
        finally:
            obs.finish_run(runlog)
    out["checks"] = smoke_checks(out)
    out["ok"] = all(out["checks"].values())
    assert out["ok"], f"loop smoke failed: {out['checks']}"
    return out


def write_record(record: dict, path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)
        f.write("\n")


def main(argv=None):
    from multihop_offload_tpu_torch import obs
    from multihop_offload_tpu_torch.utils.signals import GracefulDrain

    p = build_parser(description=__doc__)
    p.add_argument("--smoke", action="store_true",
                   help="tiny end-to-end flywheel self-check; writes its record "
                        "where --loop_out names")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    ns = vars(p.parse_args(argv))
    smoke, device = ns.pop("smoke"), ns.pop("device")
    cfg = Config(**ns)
    resolve_device(device)  # no CPU fallback: raises when CUDA is asked for and absent

    if smoke:
        out = run_smoke(cfg, device=device)
        if cfg.loop_out:
            write_record(out, cfg.loop_out)
            print(f"loop smoke record written to {cfg.loop_out}")
        print(json.dumps(out["checks"], indent=2))
        return 0

    # run mode: the flywheel needs a log to capture into and a nonzero
    # sampling rate to have any experience to learn from
    if not cfg.obs_log:
        cfg = dataclasses.replace(cfg, obs_log="runs/loop_run.jsonl")
        print(f"--obs_log unset; capturing to {cfg.obs_log}")
    if cfg.loop_capture_sample <= 0.0:
        cfg = dataclasses.replace(cfg, loop_capture_sample=1.0)
        print("--loop_capture_sample unset; capturing every request")
    drain = GracefulDrain().install()
    runlog = obs.start_run(cfg, role="loop")
    try:
        out = run_loop(cfg, drain=drain, device=device)
    finally:
        # orderly drain seals the segment chain (terminal close): the next
        # process starts a fresh segment, no crash rotate-aside
        obs.finish_run(runlog, terminal=drain.requested)
        drain.uninstall()
    if cfg.loop_out:
        write_record(out, cfg.loop_out)
    print(json.dumps(out, indent=2, default=str))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
