"""The chaos drill matrix: inject every fault class, observe every recovery.

Port of `multihop_offload_tpu/chaos/drills.py`.  One `ChaosSmoke` run
builds a single tiny service (a manual clock, one bucket) and drives every
drill against it: kill-and-restart of the flywheel at mid-refit /
mid-promotion / mid-rollback sites, checkpoint truncation and bit flip,
checksum-valid weight poisoning (refused by the semantic canary, not by
byte verification) at hot reload and at promotion, event-log torn final
record and missing segment, slow and stuck ticks through the watchdog,
backward clock skew, transient I/O errors through the retry machinery, a
cool-down across a restart, bounded candidate retention, and the loss of a
device and of a whole pseudo-host under sharded serving.

Every drill returns a record `{name, injected, recovered, checks{...},
ok}`; on top of them the smoke holds two global invariants:

- decisions never wrong: after every crash-recovery the service answers a
  golden request set bit-identically to the champion (requests are keyed
  by id, rollback re-pins the champion's weights) -- faults may DEGRADE
  service to the baseline, never silently change GNN decisions;
- conservation: every admitted request is answered exactly once per
  window (admitted == served, queue drained).

JAX's third, zero unexpected retraces after recovery, is a compile
property (`obs/jaxhooks.py`): the port runs eagerly and compiles nothing,
so each record reports that check as not applicable
(`obs.NOT_APPLICABLE_RETRACES`), never as passed, and `ok` is taken over
the checks that apply.  On the card each service runs its kernels (K1 and
K2, the dense layout of JAX's `smoke_config`).  The device- and host-loss
drills serve over a fleet of four: `[device] * 4` (JAX's virtual CPU
devices' counterpart, one card or the CPU repeated), or four distinct
cards where there are.

Process death is `faults.crashpoint` raising `SimulatedCrash` (a
BaseException) out of `cli.loop.run_loop`; the "restarted process"
re-enters `run_loop` against the same on-disk state with the executor's
loaded-step cache cleared, as a supervisor restart does.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from multihop_offload_tpu_torch.chaos import faults
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.obs import NOT_APPLICABLE_RETRACES

# the crash sites the kill drills cover (JAX `:44-56`); one per promote.py
# transition plus the long-running phases between them
KILL_SITES = (
    "capture:mid",
    "refit:mid",
    "refit:pre_save",
    "refit:post_save",
    "promote:pre_save",
    "promote:post_save",
    "promote:post_reload",
    "monitor:mid",
    "rollback:pre_save",
    "rollback:post_save",
)
FLEET = 4   # the sharded drills' fleet (JAX: min(4, devices), 2 hosts x 2)


def _not_applicable() -> dict:
    return {"ok": None, "not_applicable": NOT_APPLICABLE_RETRACES}


def smoke_config(cfg: Config, tmp: str) -> Config:
    """Tiny single-bucket flywheel config shared by every drill (JAX's):
    near-zero LR so promotion gates pass deterministically, full capture,
    zero retry backoff (drills inject transient failures on purpose)."""
    return dataclasses.replace(
        cfg,
        serve_sizes="10", serve_buckets=1, serve_slots=4,
        serve_queue_cap=64, serve_deadline_s=60.0,
        model_root=os.path.join(tmp, "model"),
        obs_log=os.path.join(tmp, "chaos_run.jsonl"),
        obs_log_max_bytes=4096,
        loop_capture_sample=1.0, loop_capture_requests=12,
        loop_refit_steps=2, loop_refit_slots=2, loop_holdout_frac=0.25,
        loop_sim_rounds=1, loop_sim_slots=60, loop_cycles=1,
        loop_candidate_keep=1, loop_cooldown_s=0.0,
        sim_cap=64, sim_margin=5.0,
        learning_rate=1e-6, learning_decay=1.0,
        io_retries=3, io_backoff_s=0.0,
    )


def fleet_devices(device: torch.device) -> list:
    """The sharded drills' fleet: four distinct cards where there are,
    else `device` repeated four times."""
    if device.type == "cuda" and torch.cuda.device_count() >= FLEET:
        return [torch.device("cuda", i) for i in range(FLEET)]
    return [device] * FLEET


class ChaosSmoke:
    """State shared across the drill matrix: ONE service.  `device`
    (default CUDA) is where it serves; `model` (default: the fresh init of
    `cfg.seed`) its weights."""

    def __init__(self, cfg: Config, tmp: str, device=None, model=None):
        from multihop_offload_tpu_torch._device import resolve_device
        from multihop_offload_tpu_torch.cli.serve import build_service

        self.tmp = tmp
        self.device = resolve_device(device)
        self.base = smoke_config(cfg, tmp)
        self.t = {"now": 0.0}
        self.clock: Callable[[], float] = lambda: self.t["now"]
        self.service, self.pool = build_service(self.base, clock=self.clock,
                                                device=self.device, model=model)
        # pristine weights: every drill starts from this champion
        self.init_state = {k: v.detach().clone()
                           for k, v in self.service.executor.model.state_dict().items()}
        self.golden: dict = {}
        self.drills: list = []

    # ---- shared plumbing ---------------------------------------------------

    def _reset_service(self) -> None:
        from multihop_offload_tpu_torch.serve.metrics import ServingStats

        ex = self.service.executor
        ex.model.load_state_dict(self.init_state)
        ex.loaded_step = None
        ex.loaded_lineage = None
        ex.canary = None
        ex._canary_rejected.clear()
        self.service.stats = ServingStats()
        self.service.watchdog = None
        self.service._degraded_until.clear()
        for q in self.service._queues:
            q.clear()

    def _fresh_model(self):
        """A copy of the serving model at the pristine weights (the sharded
        drills' services)."""
        model = copy.deepcopy(self.service.executor.model)
        model.load_state_dict(self.init_state)
        return model

    def _drill_cfg(self, name: str) -> Config:
        d = os.path.join(self.tmp, name.replace(":", "_"))
        return dataclasses.replace(self.base, model_root=os.path.join(d, "model"),
                                   obs_log=os.path.join(d, "run.jsonl"))

    def _window(self, svc, pool, cfg: Config, id_offset: int, count: int = 6) -> dict:
        """Serve a deterministic window closed-loop; {request_id: response}."""
        from multihop_offload_tpu_torch.serve.workload import request_stream

        pending = list(request_stream(
            pool, count, seed=cfg.seed + 1 + id_offset,
            arrival_scale=cfg.arrival_scale, ul=cfg.ul_data, dl=cfg.dl_data,
            t_max=float(cfg.T), id_offset=id_offset,
        ))
        pending.reverse()
        out = {}
        while pending or svc.queue_depth:
            while pending:
                req = pending.pop()
                if not svc.submit(req):
                    pending.append(req)
                    break
            for r in svc.tick():
                out[r.request_id] = r
        return out

    def _serve_ids(self, cfg: Config, id_offset: int, count: int = 6) -> dict:
        return self._window(self.service, self.pool, cfg, id_offset, count)

    @staticmethod
    def _same(r, ref) -> bool:
        return bool(np.array_equal(r.dst, ref.dst) and np.array_equal(r.is_local, ref.is_local))

    def _decisions_match(self, got: dict) -> bool:
        """Golden check: every request either matches the champion's GNN
        decision bit for bit or was EXPLICITLY degraded to the baseline."""
        for rid, ref in self.golden.items():
            r = got.get(rid)
            if r is None:
                return False
            if r.served_by != "baseline" and not self._same(r, ref):
                return False
        return True

    def _run_flywheel(self, cfg: Config, plan: Optional[faults.FaultPlan],
                      inject_regression: bool = True) -> tuple:
        """One run_loop attempt under `plan`: (out, crash site); `out` is
        None when the injected crash killed the "process"."""
        from multihop_offload_tpu_torch import obs
        from multihop_offload_tpu_torch.cli.loop import run_loop

        faults.install(plan)
        runlog = obs.start_run(cfg, role="chaos")
        try:
            out = run_loop(cfg, inject_regression=inject_regression,
                           service=self.service, pool=self.pool)
            return out, None
        except faults.SimulatedCrash as c:
            return None, c.site
        finally:
            faults.clear()
            obs.finish_run(runlog)

    @staticmethod
    def _terminal(out) -> dict:
        lin = (out or {}).get("final_lineage") or {}
        return {"final_state": out["final_state"] if out else None,
                "final_loaded_step": out["final_loaded_step"] if out else None,
                "lineage_source": lin.get("source"),
                "lineage_parent_step": lin.get("parent_step")}

    def _conserved(self, svc=None) -> bool:
        svc = svc or self.service
        return svc.stats.admitted == svc.stats.served and svc.queue_depth == 0

    # ---- kill-and-restart drills -------------------------------------------

    def run_baseline(self) -> dict:
        """The uninterrupted reference cycle every kill drill must match:
        promote at step 2, injected regression, rollback at step 3."""
        self._reset_service()
        cfg = self._drill_cfg("baseline")
        out, site = self._run_flywheel(cfg, plan=None)
        assert site is None and out is not None
        self.baseline_terminal = self._terminal(out)
        rec = {
            "name": "baseline", "injected": None, "recovered": True,
            "terminal": self.baseline_terminal,
            "checks": {
                "rolled_back": out["final_state"] == "rolled_back",
                "rollback_lineage": self.baseline_terminal["lineage_source"] == "rollback",
            },
        }
        # golden decisions on the champion weights the rollback re-pinned
        self.golden = self._serve_ids(cfg, id_offset=50_000)
        rec["checks"]["golden_captured"] = len(self.golden) > 0
        return self._finish(rec)

    def run_kill(self, site: str) -> dict:
        """A kill at `site`, then restart-and-resume: the journaled state
        machine must reach the baseline's terminal state and lineage, and
        the recovered service must answer the golden set unchanged."""
        self._reset_service()
        cfg = self._drill_cfg(f"kill_{site}")
        out, crashed_at = self._run_flywheel(cfg, faults.FaultPlan(crash_at={site: 1}))
        killed = out is None and crashed_at == site
        # "restart": a fresh process has no loaded-step cache and no queue
        self.service.executor.loaded_step = None
        self.service.executor.loaded_lineage = None
        for q in self.service._queues:
            q.clear()
        out2, site2 = self._run_flywheel(cfg, plan=None)
        recovered = site2 is None and out2 is not None
        terminal = self._terminal(out2) if recovered else self._terminal(None)
        resumed_from = (out2["cycles"][0].get("resumed_from")
                        if recovered and out2["cycles"] else None)
        got = self._serve_ids(cfg, id_offset=50_000) if recovered else {}
        rec = {
            "name": f"kill:{site}", "injected": f"SimulatedCrash at {site}",
            "recovered": recovered, "terminal": terminal, "resumed_from": resumed_from,
            "checks": {
                "crash_fired": killed,
                "resumed": recovered,
                "resumed_through_journal": resumed_from is not None,
                "same_terminal": terminal == self.baseline_terminal,
                "decisions_never_wrong": recovered and self._decisions_match(got),
                "conservation": self._conserved(),
            },
        }
        return self._finish(rec)

    # ---- checkpoint corruption drills --------------------------------------

    def _bootstrap_dir(self, cfg: Config) -> str:
        from multihop_offload_tpu_torch.cli.loop import _bootstrap_champion
        from multihop_offload_tpu_torch.loop.refit import SERVING_SUBDIR

        self._reset_service()
        _bootstrap_champion(cfg, self.service)
        return os.path.join(cfg.model_dir(), SERVING_SUBDIR)

    def _host_params(self) -> dict:
        return {k: v.detach().cpu().clone()
                for k, v in self.service.executor.model.state_dict().items()}

    def _corrupt_and_reload(self, name: str, corrupt) -> dict:
        """Truncation / bit flip: save a GOOD step 2, corrupt it, hot
        reload -- it must be quarantined with a typed event and the service
        must keep serving step 1 (last-good), never crash, never load the
        corrupt bytes."""
        from multihop_offload_tpu_torch import obs
        from multihop_offload_tpu_torch.obs import events as obs_events
        from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib

        cfg = self._drill_cfg(name)
        runlog = obs.start_run(cfg, role="chaos")
        try:
            directory = self._bootstrap_dir(cfg)
            ckpt_lib.save_checkpoint(directory, 2, {"params": self._host_params()},
                                     lineage=ckpt_lib.make_lineage("refit", parent_step=1))
            n_corrupt = corrupt(directory)
            step = self.service.hot_reload(cfg.model_dir())
            served = self._serve_ids(cfg, id_offset=60_000)
            quarantined = [e for e in obs_events.read_events(cfg.obs_log)
                           if e.get("event") == "ckpt_quarantine"]
            qdir = os.path.join(directory, "quarantine")
            rec = {
                "name": name,
                "injected": f"{n_corrupt} bytes/files corrupted at step 2",
                "recovered": True,
                "checks": {
                    "quarantine_event": len(quarantined) >= 1,
                    "quarantine_dir_populated": os.path.isdir(qdir) and bool(os.listdir(qdir)),
                    "stayed_on_last_good": (self.service.executor.loaded_step == 1
                                            and step in (None, 1)),
                    "kept_serving": len(served) > 0,
                    "still_gnn_on_last_good": all(r.served_by == "gnn"
                                                  for r in served.values()),
                },
            }
        finally:
            obs.finish_run(runlog)
        return self._finish(rec)

    def run_ckpt_truncation(self) -> dict:
        def corrupt(directory: str) -> int:
            n = 0
            for root, _, files in os.walk(os.path.join(directory, "2")):
                for f in files:
                    p = os.path.join(root, f)
                    if os.path.getsize(p) > 0:
                        faults.truncate_file(p, keep_fraction=0.3)
                        n += 1
            return n

        return self._corrupt_and_reload("ckpt_truncation", corrupt)

    def run_ckpt_bitflip(self) -> dict:
        def corrupt(directory: str) -> int:
            # flip bits in the LARGEST file of the step (the array data),
            # the silent-load hole the content checksum exists to close
            biggest, size = None, -1
            for root, _, files in os.walk(os.path.join(directory, "2")):
                for f in files:
                    p = os.path.join(root, f)
                    if os.path.getsize(p) > size:
                        biggest, size = p, os.path.getsize(p)
            faults.bit_flip_file(biggest, seed=self.base.seed, flips=16)
            return 16

        return self._corrupt_and_reload("ckpt_bitflip", corrupt)

    # ---- semantic weight-poison drills -------------------------------------

    def run_weight_poison_hot_reload(self) -> dict:
        """A checksum-VALID NaN-poisoned step 2 must be refused by the
        serve-side semantic gate at hot reload: loaded step stays 1, typed
        `canary_reject` event, NO quarantine, the champion keeps serving."""
        from multihop_offload_tpu_torch import obs
        from multihop_offload_tpu_torch.loop.canary import CheckpointCanary
        from multihop_offload_tpu_torch.obs import events as obs_events
        from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib

        cfg = self._drill_cfg("poison_hot_reload")
        runlog = obs.start_run(cfg, role="chaos")
        ex = self.service.executor
        try:
            directory = self._bootstrap_dir(cfg)
            canary = CheckpointCanary(self.service, self.pool, count=6,
                                      seed=self.base.seed + 77)
            canary.record_champion()
            ex.canary = canary
            poisoned = faults.poison_checkpoint(directory, mode="nan", seed=self.base.seed)
            checksum_valid = ckpt_lib.has_verified(directory, poisoned)
            step = self.service.hot_reload(cfg.model_dir())
            # a second poll must hit the cached rejection, not re-restore
            step2 = self.service.hot_reload(cfg.model_dir())
            served = self._serve_ids(cfg, id_offset=110_000)
            events = list(obs_events.read_events(cfg.obs_log))
            rejects = [e for e in events if e.get("event") == "canary_reject"]
            rec = {
                "name": "weight_poison_hot_reload",
                "injected": f"checksum-valid NaN poison at step {poisoned}",
                "recovered": True,
                "checks": {
                    "poison_passes_checksum": checksum_valid,
                    "reload_refused": step is None and step2 is None,
                    "stayed_on_champion": ex.loaded_step == 1,
                    "canary_reject_event": (len(rejects) >= 1
                                            and rejects[0].get("stage") == "hot_reload"),
                    "no_quarantine": not any(e.get("event") == "ckpt_quarantine"
                                             for e in events),
                    "still_gnn_on_champion": len(served) > 0 and all(
                        r.served_by == "gnn" for r in served.values()),
                },
            }
        finally:
            ex.canary = None
            ex._canary_rejected.clear()
            obs.finish_run(runlog)
        return self._finish(rec)

    def run_weight_poison_promotion(self) -> dict:
        """The same fault class through the flywheel's front door: a
        NaN-poisoned candidate offered to `PromotionController.promote`
        with the canary is refused BEFORE the write-ahead `promoting`
        intent: journaled `canarying` then `rejected`, no step pinned."""
        from multihop_offload_tpu_torch import obs
        from multihop_offload_tpu_torch.loop.canary import CheckpointCanary
        from multihop_offload_tpu_torch.loop.promote import PromotionController
        from multihop_offload_tpu_torch.obs import events as obs_events

        cfg = self._drill_cfg("poison_promotion")
        runlog = obs.start_run(cfg, role="chaos")
        try:
            self._bootstrap_dir(cfg)
            canary = CheckpointCanary(self.service, self.pool, count=6,
                                      seed=self.base.seed + 78)
            canary.record_champion()
            rng = np.random.default_rng(self.base.seed)

            def nan_poison(t: torch.Tensor) -> torch.Tensor:
                a = t.numpy().copy()
                if np.issubdtype(a.dtype, np.floating):
                    flat = a.reshape(-1)
                    idx = rng.choice(flat.size, size=max(flat.size // 4, 1), replace=False)
                    flat[idx] = np.nan
                return torch.from_numpy(a)

            host = self._host_params()
            candidate = {"params": {k: nan_poison(v) for k, v in host.items()}}
            ctl = PromotionController(cfg.model_dir())
            before = self.service.executor.loaded_step
            got = ctl.promote(self.service, candidate, candidate_step=2, canary=canary)
            served = self._serve_ids(cfg, id_offset=120_000)
            rejects = [e for e in obs_events.read_events(cfg.obs_log)
                       if e.get("event") == "canary_reject"]
            states = [h["state"] for h in ctl.history]
            rec = {
                "name": "weight_poison_promotion",
                "injected": "NaN-poisoned candidate offered for promotion",
                "recovered": True,
                "checks": {
                    "promotion_refused": got is None and ctl.state == "rejected",
                    "canarying_journaled": states[:2] == ["canarying", "rejected"],
                    "no_serving_step_pinned": self.service.executor.loaded_step == before,
                    "canary_reject_event": (len(rejects) >= 1
                                            and rejects[0].get("stage") == "promote"),
                    "typed_reason": (len(rejects) >= 1 and rejects[0].get("reason")
                                     == "nonfinite_probe_outputs"),
                    "champion_still_serving": len(served) > 0 and all(
                        r.served_by == "gnn" for r in served.values()),
                },
            }
        finally:
            obs.finish_run(runlog)
        return self._finish(rec)

    # ---- event-log drills --------------------------------------------------

    def _seeded_runlog(self, name: str):
        """A rotated 3+ segment chain with a known final marker event."""
        from multihop_offload_tpu_torch.obs.events import RunLog, segment_paths

        path = os.path.join(self.tmp, name, "log.jsonl")
        log = RunLog(path, manifest={"event": "manifest", "drill": name}, max_bytes=512)
        for i in range(40):
            log.emit("tick", n=i, payload="x" * 48)
        log.emit("summary", marker="end-of-chain")
        log.close()
        return path, segment_paths(path)

    def run_log_torn_record(self) -> dict:
        """A byte-level torn write (invalid UTF-8, no newline) at the END of
        a MID-CHAIN segment: the reader must go on to the later segments."""
        from multihop_offload_tpu_torch.obs.events import read_events

        path, segs = self._seeded_runlog("log_torn")
        faults.torn_tail(segs[1])
        events = list(read_events(path))
        rec = {
            "name": "log_torn_record",
            "injected": f"torn invalid-UTF-8 tail on {os.path.basename(segs[1])}",
            "recovered": True,
            "checks": {
                "reader_reaches_final_segment": any(e.get("marker") == "end-of-chain"
                                                    for e in events),
                "events_from_all_other_segments":
                    sum(1 for e in events if e.get("event") == "tick") >= 30,
            },
        }
        return self._finish(rec)

    def run_log_missing_segment(self) -> dict:
        """A mid-chain segment deleted outright: the reader spans the hole."""
        from multihop_offload_tpu_torch.obs.events import read_events

        path, segs = self._seeded_runlog("log_missing")
        os.remove(segs[1])
        events = list(read_events(path))
        rec = {
            "name": "log_missing_segment",
            "injected": f"deleted {os.path.basename(segs[1])}",
            "recovered": True,
            "checks": {
                "reader_reaches_final_segment": any(e.get("marker") == "end-of-chain"
                                                    for e in events),
                "manifest_still_first": bool(events) and events[0].get("event") == "manifest",
            },
        }
        return self._finish(rec)

    # ---- watchdog / clock drills -------------------------------------------

    def run_stuck_tick(self) -> dict:
        """Slow then stuck dispatches on the manual clock: the watchdog
        classifies both, dumps a flight bundle on stuck, degrades the bucket
        to the baseline for the recovery window, then restores the GNN."""
        from multihop_offload_tpu_torch import obs
        from multihop_offload_tpu_torch.obs import events as obs_events
        from multihop_offload_tpu_torch.obs.flightrec import FlightRecorder
        from multihop_offload_tpu_torch.serve.watchdog import TickWatchdog

        cfg = self._drill_cfg("stuck_tick")
        runlog = obs.start_run(cfg, role="chaos")
        try:
            self._bootstrap_dir(cfg)
            flight_dir = os.path.join(self.tmp, "stuck_tick", "flight")
            recorder = FlightRecorder(capacity=64, clock=self.clock)
            wd = TickWatchdog(threshold_s=0.5, recovery_s=30.0, stuck_factor=10.0,
                              recorder=recorder, flight_dir=flight_dir)
            self.service.attach_watchdog(wd)
            self.service.attach_health(recorder=recorder)
            ex = self.service.executor
            orig_dispatch = ex.dispatch
            stall = {"s": 0.0}

            def stalling_dispatch(*a, **kw):
                self.t["now"] += stall["s"]
                return orig_dispatch(*a, **kw)

            ex.dispatch = stalling_dispatch
            try:
                stall["s"] = 1.0      # slow: 1.0 > 0.5, under 10x
                slow_resp = self._serve_ids(cfg, id_offset=70_000, count=4)
                stall["s"] = 6.0      # stuck: 6.0 > 0.5 * 10
                stuck_resp = self._serve_ids(cfg, id_offset=70_100, count=4)
                stall["s"] = 0.0      # wedge cleared, window still open
                held_resp = self._serve_ids(cfg, id_offset=70_200, count=4)
                self.t["now"] += 31.0  # recovery window expires
                back_resp = self._serve_ids(cfg, id_offset=70_300, count=4)
            finally:
                del ex.dispatch
                self.service.attach_watchdog(None)
                self.service.attach_health()
            wd_events = [e for e in obs_events.read_events(cfg.obs_log)
                         if e.get("event") in ("watchdog", "watchdog_recovered")]
            rec = {
                "name": "stuck_tick",
                "injected": "1 s then 6 s dispatch stalls (0.5 s threshold)",
                "recovered": True,
                "checks": {
                    "slow_detected": wd.slow >= 1,
                    "stuck_detected": wd.stuck >= 1,
                    "flight_bundle_dumped": os.path.isdir(flight_dir)
                    and bool(os.listdir(flight_dir)),
                    "degraded_not_wrong": all(r.served_by == "baseline"
                                              for r in held_resp.values()),
                    "gnn_restored_after_recovery": all(r.served_by == "gnn"
                                                       for r in back_resp.values()),
                    "recovered_event": any(e.get("event") == "watchdog_recovered"
                                           for e in wd_events),
                    "all_served": all(len(r) == 4 for r in (slow_resp, stuck_resp,
                                                            held_resp, back_resp)),
                },
            }
        finally:
            obs.finish_run(runlog)
        return self._finish(rec)

    def run_clock_skew(self) -> dict:
        """The clock steps BACKWARD mid-serving (an NTP correction): no
        watchdog trip, no negative latency, the GNN keeps serving."""
        from multihop_offload_tpu_torch.obs.flightrec import FlightRecorder
        from multihop_offload_tpu_torch.serve.watchdog import TickWatchdog

        cfg = self._drill_cfg("clock_skew")
        self._bootstrap_dir(cfg)
        wd = TickWatchdog(threshold_s=0.5, recovery_s=30.0,
                          recorder=FlightRecorder(capacity=8, clock=self.clock))
        self.service.attach_watchdog(wd)
        try:
            self.t["now"] += 1000.0
            a = self._serve_ids(cfg, id_offset=80_000, count=4)
            self.t["now"] -= 900.0   # backward skew between windows
            b = self._serve_ids(cfg, id_offset=80_100, count=4)
        finally:
            self.service.attach_watchdog(None)
        rec = {
            "name": "clock_skew",
            "injected": "clock stepped back 900 s mid-serving",
            "recovered": True,
            "checks": {
                "no_watchdog_trip": wd.slow == 0 and wd.stuck == 0,
                "no_negative_latency": all(r.latency_s >= 0.0
                                           for r in list(a.values()) + list(b.values())),
                "still_gnn": all(r.served_by == "gnn" for r in b.values()),
            },
        }
        return self._finish(rec)

    # ---- transient I/O + durability drills ---------------------------------

    def run_transient_io(self) -> dict:
        """Transient OSErrors at the three durable write sites (checkpoint
        save, the loop journal, the event log) absorbed by bounded retry,
        observable in `mho_io_retries_total`."""
        from multihop_offload_tpu_torch.loop.promote import PromotionController
        from multihop_offload_tpu_torch.loop.refit import SERVING_SUBDIR
        from multihop_offload_tpu_torch.obs.events import RunLog
        from multihop_offload_tpu_torch.obs.registry import registry as obs_registry
        from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib

        cfg = self._drill_cfg("transient_io")
        directory = os.path.join(cfg.model_dir(), SERVING_SUBDIR)
        before = obs_registry().counter("mho_io_retries_total").total()
        plan = faults.FaultPlan(io_fail={"ckpt:save": 2, "journal:write": 2,
                                         "events:write": 2})
        faults.install(plan)
        try:
            ckpt_lib.save_checkpoint(directory, 1, {"params": self._host_params()},
                                     lineage=ckpt_lib.make_lineage("offline"))
            ctl = PromotionController(cfg.model_dir())
            ctl.transition("capturing", cycle=0)
            log = RunLog(os.path.join(self.tmp, "transient_io", "log.jsonl"))
            log.emit("tick", n=1)
            log.close()
        finally:
            faults.clear()
        after = obs_registry().counter("mho_io_retries_total").total()
        resumed = PromotionController.resume(cfg.model_dir())
        rec = {
            "name": "transient_io",
            "injected": "2 consecutive OSErrors at ckpt:save, journal:write, events:write",
            "recovered": True,
            "checks": {
                "all_injected_faults_consumed": sum(plan.io_hits.values()) == 6,
                "retries_counted": (after - before) >= 4,
                "save_survived": ckpt_lib.latest_step(directory) == 1,
                "journal_survived": resumed.state == "capturing",
            },
        }
        return self._finish(rec)

    def run_cooldown_restart(self) -> dict:
        """A post-rollback cool-down survives a process restart: the
        deadline is journaled, so the restarted flywheel keeps refusing new
        cycles until it passes."""
        from multihop_offload_tpu_torch.loop.promote import PromotionController

        cfg = self._drill_cfg("cooldown")
        ctl = PromotionController(cfg.model_dir(), clock=self.clock, cooldown_s=120.0)
        ctl.transition("rolled_back", step=3, reason="drill")
        ctl.start_cooldown()
        ctl2 = PromotionController.resume(cfg.model_dir(), clock=self.clock,
                                          cooldown_s=120.0)
        held = ctl2.cooldown_remaining()
        self.t["now"] += 121.0
        rec = {
            "name": "cooldown_restart",
            "injected": "restart 0 s into a 120 s post-rollback cool-down",
            "recovered": True,
            "checks": {
                "cooldown_survived_restart": 0.0 < held <= 120.0,
                "cooldown_expires": ctl2.cooldown_remaining() == 0.0,
                "state_survived": ctl2.state == "rolled_back",
            },
        }
        return self._finish(rec)

    def run_candidate_gc(self) -> dict:
        """Bounded candidate retention: three rejected candidates, keep=1:
        the two older ones deleted with typed `gc` events."""
        from multihop_offload_tpu_torch import obs
        from multihop_offload_tpu_torch.loop.promote import PromotionController
        from multihop_offload_tpu_torch.obs import events as obs_events
        from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib

        cfg = self._drill_cfg("candidate_gc")
        runlog = obs.start_run(cfg, role="chaos")
        try:
            ctl = PromotionController(cfg.model_dir(), candidate_keep=1)
            host = self._host_params()
            for s in (1, 2, 3):
                ckpt_lib.save_checkpoint(ctl.candidate_dir, s, {"params": host},
                                         lineage=ckpt_lib.make_lineage("refit"))
            removed = ctl.gc_candidates(reason="drill")
            gc_events = [e for e in obs_events.read_events(cfg.obs_log)
                         if e.get("event") == "gc"]
            rec = {
                "name": "candidate_gc",
                "injected": "3 stale candidates, retention keep=1",
                "recovered": True,
                "checks": {
                    "older_deleted": removed == [1, 2],
                    "newest_kept": ckpt_lib.all_steps(ctl.candidate_dir) == [3],
                    "typed_gc_events": len(gc_events) == 2,
                },
            }
        finally:
            obs.finish_run(runlog)
        return self._finish(rec)

    # ---- sharded fleet drills ----------------------------------------------

    def run_device_loss(self) -> dict:
        """Kill one device: a sharded service over a fleet of four loses a
        member between windows; the planner must re-place every bucket onto
        the survivors (forced), conservation and the decisions of the same
        request ids must hold across the loss, and restoring the member
        returns it to the fleet."""
        from multihop_offload_tpu_torch.cli.serve import build_service

        fleet = fleet_devices(self.device)
        cfg = dataclasses.replace(self._drill_cfg("device_loss"), serve_replan_ticks=2)
        svc, pool = build_service(cfg, pool=self.pool, clock=self.clock,
                                  model=self._fresh_model(), devices=fleet)
        golden = self._window(svc, pool, cfg, id_offset=100_000)
        multi_before = svc.executor.last_devices_used
        victim = svc.executor.devices_for(0)[-1]
        fleet_before = len(svc.planner.devices)
        svc.lose_device(victim)
        plan_after_loss = svc.planner.plan
        # the SAME request ids on the shrunken fleet: decisions are keyed by
        # request id, so they must survive the move
        after = self._window(svc, pool, cfg, id_offset=100_000)
        survived = {rid: self._same(r, golden[rid]) or r.served_by == "baseline"
                    for rid, r in after.items()}
        svc.restore_device(victim)
        recovered_win = self._window(svc, pool, cfg, id_offset=100_200)
        rec = {
            "name": "device_loss",
            "injected": f"fleet member {victim} ({fleet[victim]}) dropped from a "
                        f"{fleet_before}-member fleet mid-serving",
            "recovered": True,
            "checks": {
                "multi_device_before_loss": multi_before > 1,
                "plan_excludes_lost_device": not plan_after_loss.uses(victim),
                "replaced_onto_survivors": all(len(d) >= 1
                                               for d in plan_after_loss.assignments),
                "decisions_never_wrong": bool(survived) and all(survived.values()),
                "conservation": self._conserved(svc),
                "fleet_restored": len(svc.planner.devices) == fleet_before,
                "served_after_restore": len(recovered_win) == 6,
            },
        }
        return self._finish(rec)

    def run_host_loss(self) -> dict:
        """Kill a whole host: the fleet of four split into two pseudo-hosts
        and two buckets laid over them by the two-level planner
        (`multihost.plan`); losing a host forces a re-plan that moves its
        buckets onto the survivor's members without crossing the host
        split, decisions stay bit-identical (or honestly baseline) and
        conservation holds.  JAX's zero-unexpected-retrace check is a
        compile property: not applicable here."""
        from multihop_offload_tpu_torch.cli.serve import build_service
        from multihop_offload_tpu_torch.multihost.plan import TwoLevelPlanner, validate_plan
        from multihop_offload_tpu_torch.serve.placement import PlacementPlan

        fleet = fleet_devices(self.device)
        cfg = dataclasses.replace(
            self._drill_cfg("host_loss"),
            # two buckets so level 1 has something to spread across hosts
            serve_sizes="10,14", serve_buckets=2,
            serve_replan_ticks=10**9,  # placement injected
        )
        svc, pool = build_service(cfg, clock=self.clock, model=self._fresh_model(),
                                  devices=fleet)
        hosts = {"hostA": [0, 1], "hostB": [2, 3]}   # fleet indices
        n_buckets = len(svc.buckets.pads)
        planner = TwoLevelPlanner(n_buckets, hosts, slots=svc.executor.slots)
        planner.observe([3.0, 2.0][:n_buckets] or [3.0])
        plan = planner.replan()
        validate_plan(plan, hosts)   # the DCN invariant before anything runs
        svc.executor.set_placement(PlacementPlan(plan.devices))
        golden = self._window(svc, pool, cfg, id_offset=110_000)
        spans_hosts = len(set(plan.hosts)) > 1
        plan2 = planner.remove_host("hostB")   # forced: the plan is invalid
        lost = set(hosts["hostB"])
        svc.executor.set_placement(PlacementPlan(plan2.devices))
        after = self._window(svc, pool, cfg, id_offset=110_000)  # same ids, survivor only
        survived = {rid: self._same(r, golden[rid]) or r.served_by == "baseline"
                    for rid, r in after.items()}
        plan3 = planner.add_host("hostB", hosts["hostB"])
        rec = {
            "name": "host_loss",
            "injected": "pseudo-host hostB (2 members) dropped from a 2-host fleet "
                        "mid-serving",
            "recovered": True,
            "checks": {
                "plan_spans_hosts_before_loss": spans_hosts,
                "forced_replan_excludes_victim": (
                    all(h == "hostA" for h in plan2.hosts)
                    and not any(d in lost for ds in plan2.devices for d in ds)),
                "decisions_never_wrong": bool(survived) and all(survived.values()),
                "conservation": self._conserved(svc),
                "zero_unexpected_retraces": _not_applicable(),
                "host_restored": ("hostB" in planner.hosts
                                  and validate_plan(plan3, planner.hosts) is None),
            },
        }
        return self._finish(rec)

    # ---- retrace discipline ------------------------------------------------

    def run_no_retrace_after_recovery(self) -> dict:
        """After the whole matrix, one more window is served.  JAX's check
        that it traces nothing new is a compile property: not applicable
        here (the port compiles nothing; recovery swaps weights only)."""
        cfg = self._drill_cfg("no_retrace")
        self._bootstrap_dir(cfg)
        served = self._serve_ids(cfg, id_offset=90_000, count=6)
        rec = {
            "name": "no_retrace_after_recovery",
            "injected": None,
            "recovered": True,
            "checks": {
                "served": len(served) == 6,
                "zero_unexpected_retraces": _not_applicable(),
            },
        }
        return self._finish(rec)

    # ---- the matrix --------------------------------------------------------

    def _finish(self, rec: dict) -> dict:
        rec["ok"] = all(v for v in rec["checks"].values() if isinstance(v, bool))
        rec["not_applicable"] = sorted(k for k, v in rec["checks"].items()
                                       if not isinstance(v, bool))
        self.drills.append(rec)
        return rec

    def run_all(self, kill_sites=("refit:mid", "promote:post_save",
                                  "rollback:pre_save")) -> dict:
        """The whole matrix in JAX's order; kill-and-restart at a
        representative site a phase (`KILL_SITES` for all ten)."""
        from multihop_offload_tpu_torch.obs.registry import registry as obs_registry

        self.run_baseline()
        for site in kill_sites:
            self.run_kill(site)
        self.run_ckpt_truncation()
        self.run_ckpt_bitflip()
        self.run_weight_poison_hot_reload()
        self.run_weight_poison_promotion()
        self.run_log_torn_record()
        self.run_log_missing_segment()
        self.run_stuck_tick()
        self.run_clock_skew()
        self.run_transient_io()
        self.run_cooldown_restart()
        self.run_candidate_gc()
        self.run_device_loss()
        self.run_host_loss()
        self.run_no_retrace_after_recovery()
        reg = obs_registry()

        def total(name):
            return int(reg.counter(name).total())

        record = {
            "device": str(self.device),
            "drills": self.drills,
            "counters": {
                "quarantined": total("mho_ckpt_quarantined_total"),
                "canary_rejections": total("mho_canary_rejections_total"),
                "io_retries": total("mho_io_retries_total"),
                "watchdog_slow": total("mho_watchdog_slow_total"),
                "watchdog_stuck": total("mho_watchdog_stuck_total"),
                "loop_resumes": total("mho_loop_resumes_total"),
                "ckpt_gc": total("mho_ckpt_gc_total"),
            },
            "checks": {
                "all_drills_ok": all(d["ok"] for d in self.drills),
                "drill_count": len(self.drills),
                "fault_classes_covered": len(self.drills) - 2 >= 8,
            },
        }
        record["ok"] = bool(record["checks"]["all_drills_ok"]
                            and record["checks"]["fault_classes_covered"])
        return record


def run_smoke(cfg: Config, device=None, tmp=None) -> dict:
    """The full drill matrix in one temporary tree (`tmp` keeps it);
    asserts every drill's recovery observed."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="mho_chaos_smoke_") as own:
        harness = ChaosSmoke(cfg, tmp or own, device=device)
        record = harness.run_all()
    failed = [d["name"] for d in record["drills"] if not d["ok"]]
    assert record["ok"], f"chaos smoke failed: {failed or record['checks']}"
    return record
