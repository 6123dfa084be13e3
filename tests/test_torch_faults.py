"""PyTorch port, `chaos/faults.py`, the durable-write machinery, checkpoint
integrity and the flywheel's journal, on the CPU: the counterparts of JAX
`tests/test_chaos.py:29-259`, and the kill-point matrix over the port's
flywheel.

* the fault primitives behave as JAX's (`crashpoint` fires once at the Nth
  hit, `SimulatedCrash` escapes `except Exception`, `io_gate` counts down);
* `truncate_file`, `bit_flip_file` and `torn_tail` leave the same bytes as
  JAX's on the same file and seed, and `fuzz_request` the same request;
* the hooks sit where JAX has them: `ckpt:save`, `ckpt:restore` and
  `events:write` absorb injected transient failures through their retries;
* checkpoints: content-keyed checksums, quarantine and last-good fallback,
  checksum-valid poison, bounded retention; the journal and cool-down
  survive a restart;
* a SIGKILL-equivalent at every crash site of the capture -> refit ->
  validate -> promote -> monitor -> rollback cycle, then a restart, lands
  on the uninterrupted run's terminal state and lineage, answers a golden
  request set as the uninterrupted run's champion does, and conserves
  every admitted request.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from multihop_offload_tpu.chaos import faults as jfaults
from multihop_offload_tpu.serve import workload as jwork
from multihop_offload_tpu_torch import obs
from multihop_offload_tpu_torch.chaos import faults
from multihop_offload_tpu_torch.cli.loop import run_loop, smoke_config
from multihop_offload_tpu_torch.cli.serve import build_service
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.obs import events as obs_events
from multihop_offload_tpu_torch.obs.registry import registry as obs_registry
from multihop_offload_tpu_torch.serve import guards as tguards
from multihop_offload_tpu_torch.serve import workload as twork
from multihop_offload_tpu_torch.serve.metrics import ServingStats
from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib
from multihop_offload_tpu_torch.utils import durable

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


# ---- fault primitives -------------------------------------------------------


def test_crashpoint_unarmed_is_noop():
    faults.clear()
    faults.crashpoint("anywhere")  # no plan installed: must not raise
    faults.io_gate("anywhere")
    assert faults.active_plan() is None


def test_crashpoint_fires_once_at_nth_hit():
    plan = faults.FaultPlan(crash_at={"site": 3})
    faults.install(plan)
    try:
        faults.crashpoint("site")
        faults.crashpoint("site")
        with pytest.raises(faults.SimulatedCrash) as e:
            faults.crashpoint("site")
        assert e.value.site == "site"
        # fired once; the "restarted process" sails through the same site
        faults.crashpoint("site")
        assert plan.fired == {"site": 3} and plan.hits == {"site": 4}
    finally:
        faults.clear()


def test_simulated_crash_escapes_except_exception():
    faults.install(faults.FaultPlan(crash_at={"s": 1}))
    try:
        with pytest.raises(faults.SimulatedCrash):
            try:
                faults.crashpoint("s")
            except Exception:
                pytest.fail("SimulatedCrash was swallowed")
    finally:
        faults.clear()
    assert issubclass(faults.SimulatedCrash, BaseException)
    assert not issubclass(faults.SimulatedCrash, Exception)


def test_io_gate_counts_down_then_clears():
    plan = faults.FaultPlan(io_fail={"w": 2})
    faults.install(plan)
    try:
        for _ in range(2):
            with pytest.raises(faults.TransientIOError):
                faults.io_gate("w")
        faults.io_gate("w")  # budget consumed: passes
        assert plan.io_hits == {"w": 2}
        assert isinstance(faults.TransientIOError("x"), OSError)
    finally:
        faults.clear()


def _blob(path):
    with open(path, "wb") as f:
        f.write(bytes(range(256)) * 4 + b"tail" * 37)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("seed,flips", [(11, 4), (3, 32), (2024, 1)])
def test_corruption_helpers_match_jax_bytes(tmp_path, seed, flips):
    """The same file and seed give JAX's bytes, offset for offset."""
    a, b = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    _blob(a)
    _blob(b)
    assert faults.truncate_file(a, keep_fraction=0.6) == \
        jfaults.truncate_file(b, keep_fraction=0.6)
    assert _read(a) == _read(b)
    assert faults.bit_flip_file(a, seed=seed, flips=flips) == \
        jfaults.bit_flip_file(b, seed=seed, flips=flips)
    assert _read(a) == _read(b)
    faults.torn_tail(a)
    jfaults.torn_tail(b)
    assert _read(a) == _read(b) and not _read(a).endswith(b"\n")


def test_corruption_helpers_are_deterministic(tmp_path):
    p = str(tmp_path / "blob.bin")
    with open(p, "wb") as f:
        f.write(bytes(range(256)) * 4)
    assert faults.truncate_file(p, keep_fraction=0.25) == 256
    a = faults.bit_flip_file(p, seed=11, flips=4)
    # same seed on identical bytes flips the same offsets back
    assert faults.bit_flip_file(p, seed=11, flips=4) == a
    assert _read(p) == bytes(range(256))  # double-flip restores
    faults.torn_tail(p)
    assert not _read(p).endswith(b"\n")  # torn: no record terminator
    empty = str(tmp_path / "empty.bin")
    open(empty, "wb").close()
    assert faults.bit_flip_file(empty, seed=1) == []


@pytest.mark.parametrize("mutation,reason", faults.REQUEST_MUTATIONS)
def test_fuzz_request_matches_jax_and_trips_the_guard(mutation, reason):
    jreq = next(jwork.request_stream(jwork.case_pool([10], per_size=1, seed=3), 1, seed=5))
    treq = next(twork.request_stream(twork.case_pool([10], per_size=1, seed=3), 1, seed=5))
    jbad = jfaults.fuzz_request(jreq, mutation, seed=9)
    tbad = faults.fuzz_request(treq, mutation, seed=9)
    for f in ("roles", "proc_bws", "link_rates", "job_src", "job_rate"):
        np.testing.assert_array_equal(getattr(tbad, f), getattr(jbad, f), err_msg=f)
    assert tguards.validate_request(treq) is None
    assert tguards.validate_request(tbad).reason == reason
    with pytest.raises(ValueError, match="unknown request mutation"):
        faults.fuzz_request(treq, "nope")


# ---- durable-write machinery ------------------------------------------------


def test_with_backoff_absorbs_transient_oserror():
    obs_registry().reset()
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise OSError("hiccup")
        return "ok"

    slept = []
    out = durable.with_backoff(flaky, site="t", retries=3, backoff_s=0.01,
                               sleep=slept.append)
    assert out == "ok" and calls["n"] == 3
    assert slept == [0.01, 0.02]  # exponential
    assert obs_registry().counter("mho_io_retries_total").total(site="t") == 2


def test_with_backoff_exhausted_budget_raises():
    def always():
        raise OSError("down")

    with pytest.raises(OSError):
        durable.with_backoff(always, site="t", retries=2, backoff_s=0.0,
                             sleep=lambda s: None)


def test_with_backoff_non_oserror_propagates_immediately():
    """Corruption signals must NOT be retried: they go to quarantine."""
    calls = {"n": 0}

    def corrupt():
        calls["n"] += 1
        raise ValueError("not transient")

    with pytest.raises(ValueError):
        durable.with_backoff(corrupt, retries=5, sleep=lambda s: None)
    assert calls["n"] == 1


def test_atomic_write_json_leaves_no_tmp_and_round_trips(tmp_path):
    p = str(tmp_path / "deep" / "state.json")
    durable.atomic_write_json(p, {"b": 2, "a": 1})
    assert durable.load_json(p) == {"a": 1, "b": 2}
    assert os.listdir(os.path.dirname(p)) == ["state.json"]  # no tmp debris
    assert durable.load_json(str(tmp_path / "missing.json")) is None
    (tmp_path / "garbage.json").write_text("{not json")
    assert durable.load_json(str(tmp_path / "garbage.json")) is None


def test_hooks_sit_where_jax_has_them(tmp_path):
    """`ckpt:save`, `ckpt:restore` and `events:write` each absorb injected
    transient failures through their retries, counted per site."""
    obs_registry().reset()
    durable.configure(retries=3, backoff_s=0.0)
    d = str(tmp_path / "torch")
    plan = faults.FaultPlan(io_fail={"ckpt:save": 2, "ckpt:restore": 2,
                                     "events:write": 2})
    log = obs_events.RunLog(str(tmp_path / "run.jsonl"))
    faults.install(plan)
    try:
        ckpt_lib.save_checkpoint(d, 1, {"params": {"w": torch.ones(3)}})
        state, step = ckpt_lib.restore_verified(d)
        log.emit("tick", i=1)
    finally:
        faults.clear()
        log.close()
    assert step == 1 and torch.equal(state["params"]["w"], torch.ones(3))
    assert plan.io_hits == {"ckpt:save": 2, "ckpt:restore": 2, "events:write": 2}
    assert [e["i"] for e in obs_events.read_events(str(tmp_path / "run.jsonl"))
            if e["event"] == "tick"] == [1]
    reg = obs_registry().counter("mho_io_retries_total")
    assert reg.total(site="ckpt:save") == 2 and reg.total(site="events:write") == 2
    assert reg.total(site="ckpt:restore") == 2


# ---- checkpoint integrity ---------------------------------------------------


def test_tree_checksum_is_content_keyed():
    t1 = {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}}
    t2 = {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}}
    assert ckpt_lib.tree_checksum(t1) == ckpt_lib.tree_checksum(t2)
    t2["params"]["w"][0, 0] += 1e-3
    assert ckpt_lib.tree_checksum(t1) != ckpt_lib.tree_checksum(t2)
    t3 = {"params": {"w": t1["params"]["w"].double()}}
    assert ckpt_lib.tree_checksum(t1) != ckpt_lib.tree_checksum(t3)


def test_corrupt_checkpoint_quarantined_and_last_good_wins(tmp_path):
    obs_registry().reset()
    d = str(tmp_path / "torch")
    good = {"params": {"w": torch.ones(4)}}
    newer = {"params": {"w": torch.full((4,), 2.0)}}
    ckpt_lib.save_checkpoint(d, 1, good, lineage=ckpt_lib.make_lineage("offline"))
    ckpt_lib.save_checkpoint(d, 2, newer, lineage=ckpt_lib.make_lineage("refit"))
    assert ckpt_lib.has_verified(d, 2)
    # rot every byte of step 2's data
    for root, _, files in os.walk(os.path.join(d, "2")):
        for f in files:
            p = os.path.join(root, f)
            if os.path.getsize(p):
                faults.bit_flip_file(p, seed=3, flips=32)
    assert not ckpt_lib.has_verified(d, 2)
    state, step = ckpt_lib.restore_verified(d)
    assert step == 1  # fell through to last-good
    assert torch.equal(state["params"]["w"], good["params"]["w"])
    assert os.path.isdir(os.path.join(d, "quarantine"))
    assert ckpt_lib.all_steps(d) == [1]  # the corrupt step is gone
    assert obs_registry().counter("mho_ckpt_quarantined_total").total() >= 1


def test_poison_checkpoint_is_checksum_valid_and_seeded(tmp_path):
    """A weight-poisoned checkpoint goes through the NORMAL save path, so
    integrity verification passes: byte checks can never catch it."""
    d = str(tmp_path / "torch")
    w = torch.linspace(0.1, 1.6, 16).reshape(4, 4)
    ckpt_lib.save_checkpoint(d, 1, {"params": {"w": w, "b": torch.ones(4)}},
                             lineage=ckpt_lib.make_lineage("offline"))
    step = faults.poison_checkpoint(d, mode="nan", seed=3, fraction=0.25)
    assert step == 2
    assert ckpt_lib.has_verified(d, 2)  # checksum-VALID poison
    restored, got = ckpt_lib.restore_verified(d)
    assert got == 2
    bad = restored["params"]["w"]
    assert int(torch.isnan(bad).sum()) == 4  # fraction of the 16 entries
    assert int(torch.isnan(restored["params"]["b"]).sum()) == 1
    assert torch.equal(w[~torch.isnan(bad)], bad[~torch.isnan(bad)])
    assert ckpt_lib.load_lineage(d, step=2)["source"] == "poison"
    # determinism: the same seed poisons the same entries
    d2 = str(tmp_path / "again")
    ckpt_lib.save_checkpoint(d2, 1, {"params": {"w": w, "b": torch.ones(4)}})
    faults.poison_checkpoint(d2, mode="nan", seed=3, fraction=0.25)
    again, _ = ckpt_lib.restore_verified(d2)
    assert torch.equal(torch.isnan(bad), torch.isnan(again["params"]["w"]))
    scaled = faults.poison_checkpoint(d2, mode="scale", seed=3)  # on top of step 2's NaNs
    d3 = str(tmp_path / "scale")
    ckpt_lib.save_checkpoint(d3, 1, {"params": {"w": w, "b": torch.ones(4)}})
    assert faults.poison_checkpoint(d3, mode="scale", seed=3) == 2 and scaled == 3
    big, _ = ckpt_lib.restore_verified(d3)
    assert bool(torch.isfinite(big["params"]["b"]).all())
    assert float(big["params"]["b"].max()) == 1e6
    with pytest.raises(ValueError, match="unknown poison mode"):
        faults.poison_checkpoint(d, mode="zero")
    with pytest.raises(ValueError, match="no verified checkpoint"):
        faults.poison_checkpoint(str(tmp_path / "virgin"))


def test_gc_checkpoints_bounded_retention(tmp_path):
    obs_registry().reset()
    d = str(tmp_path / "cand")
    t = {"params": {"w": torch.zeros(2)}}
    for s in (1, 2, 3):
        ckpt_lib.save_checkpoint(d, s, t, lineage=ckpt_lib.make_lineage("refit"))
    assert ckpt_lib.gc_checkpoints(d, keep=1, reason="test") == [1, 2]
    assert ckpt_lib.all_steps(d) == [3]
    assert not os.path.exists(os.path.join(d, "lineage", "1.json"))
    assert not os.path.exists(os.path.join(d, "integrity", "2.json"))
    assert obs_registry().counter("mho_ckpt_gc_total").total() == 2
    assert ckpt_lib.gc_checkpoints(d, keep=2) == []


# ---- journal durability -----------------------------------------------------


def test_journal_round_trip_and_cooldown_survive_restart(tmp_path):
    from multihop_offload_tpu_torch.loop.promote import PromotionController

    t = {"now": 100.0}
    ctl = PromotionController(str(tmp_path), clock=lambda: t["now"], cooldown_s=60.0)
    ctl.transition("refitting", candidate_step=5, champion_step=1)
    ctl.note(pre_tau=0.42)
    ctl.start_cooldown()
    # "restart": a fresh controller over the same dir
    ctl2 = PromotionController.resume(str(tmp_path), clock=lambda: t["now"],
                                      cooldown_s=60.0)
    assert ctl2.resumed and ctl2.state == "refitting"
    assert ctl2.ctx["candidate_step"] == 5
    assert ctl2.ctx["pre_tau"] == 0.42
    assert ctl2.cooldown_remaining() == 60.0
    t["now"] += 61.0
    assert ctl2.cooldown_remaining() == 0.0


def test_fresh_dir_resumes_idle_and_journal_write_retries(tmp_path):
    from multihop_offload_tpu_torch.loop.promote import PromotionController

    ctl = PromotionController.resume(str(tmp_path / "virgin"))
    assert ctl.state == "idle" and not ctl.resumed
    obs_registry().reset()
    durable.configure(retries=3, backoff_s=0.0)
    plan = faults.FaultPlan(io_fail={"journal:write": 2})
    faults.install(plan)
    try:
        ctl.transition("capturing", cycle=0)
    finally:
        faults.clear()
    assert plan.io_hits == {"journal:write": 2}
    assert PromotionController.resume(str(tmp_path / "virgin")).state == "capturing"


# ---- the kill-point matrix --------------------------------------------------


class _Drills:
    """One CPU service shared by every drill (each drill a fresh model dir
    and run log), the uninterrupted baseline every kill must reach."""

    def __init__(self, tmp: str):
        self.tmp = tmp
        self.base = dataclasses.replace(
            smoke_config(Config(seed=0, dtype="float32"), tmp),
            obs_log_max_bytes=4096, loop_capture_requests=12,
            loop_sim_rounds=1, loop_sim_slots=60, loop_candidate_keep=1,
            io_retries=3, io_backoff_s=0.0)
        self.t = {"now": 0.0}
        self.service, self.pool = build_service(self.base, clock=lambda: self.t["now"],
                                                device="cpu")
        self.init_state = {k: v.clone()
                           for k, v in self.service.executor.model.state_dict().items()}

    def reset(self) -> None:
        ex = self.service.executor
        ex.model.load_state_dict(self.init_state)
        ex.loaded_step = None
        ex.loaded_lineage = None
        ex.canary = None
        ex._canary_rejected.clear()
        self.service.stats = ServingStats()
        for q in self.service._queues:
            q.clear()

    def cfg(self, name: str) -> Config:
        d = os.path.join(self.tmp, name.replace(":", "_"))
        shutil.rmtree(d, ignore_errors=True)
        return dataclasses.replace(self.base, model_root=os.path.join(d, "model"),
                                   obs_log=os.path.join(d, "run.jsonl"))

    def flywheel(self, cfg, plan):
        """One run_loop attempt under `plan`: (out, crash site)."""
        faults.install(plan)
        runlog = obs.start_run(cfg, role="chaos")
        try:
            return run_loop(cfg, inject_regression=True, service=self.service,
                            pool=self.pool), None
        except faults.SimulatedCrash as c:
            return None, c.site
        finally:
            faults.clear()
            obs.finish_run(runlog)

    def serve_ids(self, cfg, id_offset: int, count: int = 6) -> dict:
        reqs = list(twork.request_stream(self.pool, count, seed=cfg.seed + 1 + id_offset,
                                         arrival_scale=cfg.arrival_scale,
                                         id_offset=id_offset))
        for r in reqs:
            assert self.service.submit(r)
        return {r.request_id: r for r in self.service.drain()}

    @staticmethod
    def terminal(out) -> dict:
        lin = out["final_lineage"] or {}
        return {"final_state": out["final_state"],
                "final_loaded_step": out["final_loaded_step"],
                "lineage_source": lin.get("source"),
                "lineage_parent_step": lin.get("parent_step")}


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    obs_registry().reset()
    d = _Drills(str(tmp_path_factory.mktemp("drills")))
    d.reset()
    cfg = d.cfg("baseline")
    out, site = d.flywheel(cfg, None)
    assert site is None and out["final_state"] == "rolled_back"
    d.baseline = d.terminal(out)
    assert d.baseline == {"final_state": "rolled_back", "final_loaded_step": 3,
                          "lineage_source": "rollback", "lineage_parent_step": 2}
    # golden decisions on the champion the rollback re-pinned
    d.golden = d.serve_ids(cfg, id_offset=50_000)
    assert d.golden
    return d


@pytest.mark.parametrize("site", KILL_SITES)
def test_kill_and_resume_reaches_baseline_terminal(drills, site):
    drills.reset()
    cfg = drills.cfg(f"kill_{site}")
    out, crashed = drills.flywheel(cfg, faults.FaultPlan(crash_at={site: 1}))
    assert out is None and crashed == site, f"{site}: fault never injected"
    # "restart": a fresh process has no loaded-step cache and no queue
    drills.service.executor.loaded_step = None
    drills.service.executor.loaded_lineage = None
    for q in drills.service._queues:
        q.clear()
    out2, again = drills.flywheel(cfg, None)
    assert again is None and out2 is not None, f"{site}: restart did not complete"
    assert out2["cycles"][0].get("resumed_from") is not None, f"{site}: journal unread"
    assert drills.terminal(out2) == drills.baseline, site
    got = drills.serve_ids(cfg, id_offset=50_000)
    assert set(got) == set(drills.golden)
    for rid, ref in drills.golden.items():
        np.testing.assert_array_equal(got[rid].dst, ref.dst)
        np.testing.assert_array_equal(got[rid].is_local, ref.is_local)
    assert drills.service.queue_depth == 0
    assert drills.service.stats.admitted == drills.service.stats.served
