"""Promotion controller: the flywheel's state machine, with rollback.

Port of `multihop_offload_tpu/loop/promote.py`, over the port's
checkpoints (`train/checkpoints.py`): the serving tree is ``torch/`` under
the model directory (JAX's ``orbax/``), candidates live in
``torch_candidate/``, and a promotion or rollback reaches the service
through `executor.hot_reload`, which reads those checkpoints.  Weights
travel as `{"params": state_dict}`.

States: idle -> capturing -> refitting -> validating -> {promoting ->
promoted | rejected} -> monitoring -> {ok -> idle | rolling_back ->
rolled_back}.  Transitions are host-side bookkeeping; the two
state-changing actions are:

- `promote`: pre-validate the candidate's param signature against the
  LIVE serving tree (`serve.executor.param_signature` -- a mismatched tree
  must reject the promotion here, never fail mid-tick), save it into the
  serving torch tree at a fresh monotone step with its lineage, and swap
  it in through the service's hot-reload path (`service.hot_reload`).
- `rollback`: re-pin the pre-promotion champion.  A step id is written
  once (`save_checkpoint` refuses an existing one), so rollback never "goes back" to an old step -- it
  re-saves the champion snapshot at `latest + 1` (`source="rollback"`
  lineage pointing at the failed candidate) and hot-reloads.  The step
  counter stays monotone, the weights return.

Durability: every transition is journaled to an atomically-written
(`tmp`+`fsync`+`rename`) sidecar, `<model_dir>/loop_state.json`, BEFORE
its side effects -- `promoting` / `rolling_back` are write-ahead intents
carrying the pinned target step, so a process killed mid-save resumes
idempotently (`PromotionController.resume` + `cli.loop` phase dispatch)
instead of restarting the cycle or double-saving.  Cool-down timers
survive restarts the same way.  `ctx` is the journaled scratchpad: the
fields of every transition merge into it, and `note()` adds
cycle-progress facts (pre-promotion tau, champion step) between
transitions.

Every transition lands in the run log (`loop_state` events; `promotion` /
`rollback` / `rejection` for the decisions) and the `mho_loop_*` counters,
so `mho-obs` can render a flywheel run and Prometheus can alert on
rollback rate.
"""

from __future__ import annotations

import os
import time
from typing import Any, List, Optional

from multihop_offload_tpu_torch.chaos import faults
from multihop_offload_tpu_torch.obs import events as obs_events
from multihop_offload_tpu_torch.obs import trace as obs_trace
from multihop_offload_tpu_torch.obs.registry import registry as obs_registry
from multihop_offload_tpu_torch.serve.executor import param_signature
from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib
from multihop_offload_tpu_torch.utils.durable import (
    atomic_write_json,
    load_json,
    with_backoff,
)

JOURNAL_SCHEMA = 1

STATES = (
    "idle", "capturing", "refitting", "validating", "canarying",
    "promoting", "promoted", "rejected", "monitoring",
    "rolling_back", "rolled_back",
)


def _host(params: dict) -> dict:
    """A state dict's tensors on the host."""
    return {k: v.detach().cpu() for k, v in params.items()}


class PromotionController:
    """Drives candidate weights into (and back out of) the serving tree."""

    def __init__(self, model_dir: str, which: str = "torch",
                 clock=time.time, candidate_keep: int = 0,
                 cooldown_s: float = 0.0):
        self.model_dir = model_dir
        self.which = which
        self.directory = os.path.join(model_dir, which)
        self.candidate_dir = os.path.join(model_dir, f"{which}_candidate")
        self.journal_path = os.path.join(model_dir, "loop_state.json")
        self.clock = clock
        self.candidate_keep = int(candidate_keep)
        self.cooldown_s = float(cooldown_s)
        self.state = "idle"
        self.seq = 0
        self.cooldown_until = 0.0
        self.ctx: dict = {}
        self.resumed = False
        self.history: List[dict] = []

    # ---- durable journal ---------------------------------------------------

    @classmethod
    def resume(cls, model_dir: str, which: str = "torch", clock=time.time,
               candidate_keep: int = 0,
               cooldown_s: float = 0.0) -> "PromotionController":
        """Rebuild the controller from the journal sidecar: state, seq,
        cool-down deadline and ctx come back exactly as last journaled, so
        a killed `mho-loop` continues the interrupted cycle from its last
        durable transition.  A missing/unreadable journal (first boot, or
        pre-durability trees) yields a fresh idle controller."""
        ctl = cls(model_dir, which=which, clock=clock,
                  candidate_keep=candidate_keep, cooldown_s=cooldown_s)
        j = load_json(ctl.journal_path)
        if j and j.get("schema") == JOURNAL_SCHEMA and j.get("state") in STATES:
            ctl.state = j["state"]
            ctl.seq = int(j.get("seq", 0))
            ctl.cooldown_until = float(j.get("cooldown_until", 0.0))
            ctl.ctx = dict(j.get("ctx") or {})
            ctl.resumed = ctl.state != "idle"
            if ctl.resumed:
                obs_registry().counter(
                    "mho_loop_resumes_total",
                    "flywheel cycles resumed from the journal",
                ).inc(state=ctl.state)
                obs_events.emit("loop_resume", state=ctl.state, seq=ctl.seq,
                                ctx=dict(ctl.ctx))
        return ctl

    def _journal(self) -> None:
        payload = {
            "schema": JOURNAL_SCHEMA,
            "state": self.state,
            "seq": self.seq,
            "cooldown_until": self.cooldown_until,
            "ctx": self.ctx,
            "history_tail": self.history[-8:],
        }

        def _write() -> None:
            faults.io_gate("journal:write")
            atomic_write_json(self.journal_path, payload,
                              site="journal:write")

        with_backoff(_write, site="journal:write")

    # ---- state bookkeeping -------------------------------------------------

    def transition(self, state: str, **fields) -> None:
        if state not in STATES:
            raise ValueError(f"unknown loop state '{state}'; one of {STATES}")
        self.state = state
        self.seq += 1
        rec = {"state": state, **fields}
        self.history.append(rec)
        self.ctx.update(fields)
        # durable first: the journal is the source of truth a restarted
        # process resumes from, the event stream is an observer
        self._journal()
        obs_events.emit("loop_state", **rec)
        obs_registry().counter(
            "mho_loop_transitions_total", "flywheel state transitions"
        ).inc(state=state)

    def note(self, **fields) -> None:
        """Journal cycle-progress facts without a state change (the pinned
        candidate step, the pre-promotion tau, the champion step) so a
        resume after SIGKILL has them."""
        self.ctx.update(fields)
        self._journal()

    def start_cooldown(self, seconds: Optional[float] = None) -> None:
        s = self.cooldown_s if seconds is None else float(seconds)
        if s <= 0:
            return
        self.cooldown_until = float(self.clock()) + s
        self._journal()
        obs_events.emit("loop_cooldown", until=self.cooldown_until,
                        seconds=s)

    def cooldown_remaining(self) -> float:
        return max(self.cooldown_until - float(self.clock()), 0.0)

    def _next_step(self) -> int:
        return (ckpt_lib.latest_step(self.directory) or 0) + 1

    def drift_triggered(self, trip: dict, cycle: Optional[int] = None) -> None:
        """Enter capture because a drift detector fired (obs.drift): the
        flywheel's third entry path besides schedule and operator.  The
        trip's signal/detector/stat land in the `loop_state` event so a
        capture window is attributable to the shift that opened it."""
        obs_registry().counter(
            "mho_loop_drift_captures_total",
            "capture windows opened by drift detectors",
        ).inc(signal=str(trip.get("signal", "?")))
        fields = {k: trip[k] for k in ("signal", "detector", "stat", "value")
                  if k in trip}
        if cycle is not None:
            fields["cycle"] = cycle
        self.transition("capturing", trigger="drift_triggered", **fields)

    # ---- bounded candidate retention ---------------------------------------

    def gc_candidates(self, reason: str) -> List[int]:
        """Bounded retention in `torch_candidate/`: rejected/rolled-back
        candidates used to pile up forever; keep the newest K."""
        if self.candidate_keep <= 0:
            return []
        return ckpt_lib.gc_checkpoints(self.candidate_dir,
                                       keep=self.candidate_keep,
                                       reason=reason)

    # ---- the two weight-moving actions -------------------------------------

    def promote(
        self,
        service,
        candidate_variables: Any,
        lineage: Optional[dict] = None,
        candidate_step: Optional[int] = None,
        experience_ids: Optional[List[int]] = None,
        step: Optional[int] = None,
        canary=None,
    ) -> Optional[int]:
        """Validated candidate -> serving tree -> hot-reload.

        Journals a `promoting` intent with the pinned target step before
        touching disk, and skips the save when that step already holds a
        verified checkpoint -- so a crash anywhere in here resumes by
        calling `promote` again with `step=ctx["step"]` and lands in the
        same place.  Returns the serving step, or None when the candidate
        was structurally rejected (wrong tree/shape/dtype signature) or
        semantically rejected (`canary`, a `loop.canary.CheckpointCanary`
        -- journaled "canarying" state) -- either way the service keeps
        serving the champion untouched."""
        live = service.executor.model.state_dict()
        cand = candidate_variables["params"]
        if param_signature(cand) != param_signature(live):
            self.reject("param signature mismatch against live tree",
                        candidate_step=candidate_step)
            return None
        if canary is not None:
            # semantic gate BEFORE the write-ahead promoting intent: a
            # refused candidate never pins a serving step
            self.transition("canarying", candidate_step=candidate_step)
            why = canary.check(candidate_variables)
            if why is not None:
                obs_registry().counter(
                    "mho_canary_rejections_total",
                    "candidate weight sets refused by the semantic canary",
                ).inc(stage="promote", reason=why.split(":")[0])
                obs_events.emit("canary_reject", stage="promote", reason=why,
                                candidate_step=candidate_step)
                self.reject(f"canary: {why}", candidate_step=candidate_step)
                return None
        step = int(step) if step is not None else self._next_step()
        self.transition("promoting", step=step, candidate_step=candidate_step)
        faults.crashpoint("promote:pre_save")
        if not ckpt_lib.has_verified(self.directory, step):
            ckpt_lib.save_checkpoint(
                self.directory, step, {"params": _host(candidate_variables["params"])},
                lineage=lineage if lineage is not None
                else ckpt_lib.make_lineage("refit", parent_step=candidate_step),
            )
        faults.crashpoint("promote:post_save")
        loaded = service.hot_reload(self.model_dir, which=self.which)
        faults.crashpoint("promote:post_reload")
        obs_registry().counter(
            "mho_loop_promotions_total", "candidates promoted to serving"
        ).inc()
        obs_events.emit("promotion", step=step, loaded=loaded,
                        candidate_step=candidate_step)
        if experience_ids:
            # close the trace loop: every captured request that trained this
            # candidate gets a terminal "promotion" hop with its lineage
            obs_trace.hop("promotion", experience_ids, step=step,
                          candidate_step=candidate_step)
        self.transition("promoted", step=step)
        return step

    def reject(self, reason: str, candidate_step: Optional[int] = None) -> None:
        """Candidate refused before touching the serving tree."""
        obs_registry().counter(
            "mho_loop_rejections_total", "candidates refused promotion"
        ).inc()
        obs_events.emit("rejection", reason=reason,
                        candidate_step=candidate_step)
        self.transition("rejected", reason=reason)
        self.gc_candidates(reason="rejected candidate")

    def rollback(self, service, champion_variables: Any, reason: str,
                 failed_step: Optional[int] = None,
                 step: Optional[int] = None) -> int:
        """Re-pin the champion snapshot at a fresh monotone step.  Same
        write-ahead-intent contract as `promote`: the `rolling_back`
        journal entry pins the step, the save is skipped when already
        verified, so a crashed rollback re-runs to the same lineage."""
        step = int(step) if step is not None else self._next_step()
        self.transition("rolling_back", step=step, reason=reason,
                        failed_step=failed_step)
        faults.crashpoint("rollback:pre_save")
        if not ckpt_lib.has_verified(self.directory, step):
            ckpt_lib.save_checkpoint(
                self.directory, step, {"params": _host(champion_variables["params"])},
                lineage=ckpt_lib.make_lineage(
                    "rollback", parent_step=failed_step,
                    parent_dir=self.directory,
                    extra={"reason": reason},
                ),
            )
        faults.crashpoint("rollback:post_save")
        loaded = service.hot_reload(self.model_dir, which=self.which)
        obs_registry().counter(
            "mho_loop_rollbacks_total", "promotions rolled back"
        ).inc()
        obs_events.emit("rollback", step=step, loaded=loaded,
                        reason=reason, failed_step=failed_step)
        self.transition("rolled_back", step=step, reason=reason)
        self.start_cooldown()
        self.gc_candidates(reason="rolled-back candidate")
        return step


def monitor_ok(
    pre_tau: Optional[float],
    post_tau: Optional[float],
    max_ratio: float,
) -> bool:
    """Post-promotion regression check on measured serve tau: the promoted
    policy's measured mean tau may exceed the pre-promotion baseline by at
    most `max_ratio`.  Missing measurements (no traffic in a window) pass --
    absence of evidence must not trigger a rollback."""
    if pre_tau is None or post_tau is None or pre_tau <= 0:
        return True
    return post_tau <= pre_tau * max_ratio
