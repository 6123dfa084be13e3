"""PyTorch port, `loop/` and `obs/drift.py`: the continual-learning
flywheel against the JAX package's, in float64 on the CPU.

The counterparts of the tests of `tests/test_loop.py` (the red
`test_canary_decision_collapse_is_deterministic` excepted: the port's
canary is held to its own determinism), and parity checks.  Both
services are built from the same pool (`SIZES = [10, 16]`) with the same
weights (`tests/test_torch_serve.py:_services`), capture every request
into their own run logs, and serve the same stream on the same clock:

* `sampled` agrees with JAX for ids 0..100,000 at three rates, and
  `split_holdout` gives JAX's partition;
* `outcome_record` gives JAX's JSON for the same request and response, and
  the two logs' outcome rows agree (floats within 1e-12); `read_outcomes`
  rebuilds the requests exactly;
* `replay_batches` of the port's log equals JAX's batches of the same log,
  field for field, bit for bit;
* `refit` from the same parameters gives JAX's candidate within 1e-10
  (scaled): greedy decisions, no exploration, so no draw is read;
* `apply_gates` and `monitor_ok` give JAX's verdicts and reasons, and
  `DriftMonitor` trips at JAX's ticks with JAX's statistics;
* the canary's probe decisions equal JAX's canary's;
* the promotion state machine promotes, rejects and rolls back through
  the port's own checkpoints; `mho-loop --smoke --device cpu` promotes and
  rolls back in one run.
"""

import json
import os

import numpy as np
import pytest
import torch

from multihop_offload_tpu.loop import canary as jcanary_mod
from multihop_offload_tpu.loop import experience as jexp
from multihop_offload_tpu.loop import promote as jpromote
from multihop_offload_tpu.loop import refit as jrefit
from multihop_offload_tpu.loop import validate as jvalidate
from multihop_offload_tpu.obs import drift as jdrift
from multihop_offload_tpu.obs import events as jevents
from multihop_offload_tpu_torch.cli import loop as tloop
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.loop import experience
from multihop_offload_tpu_torch.loop.canary import CheckpointCanary
from multihop_offload_tpu_torch.loop.promote import PromotionController, monitor_ok
from multihop_offload_tpu_torch.loop.refit import refit
from multihop_offload_tpu_torch.loop.validate import ab_compare, apply_gates
from multihop_offload_tpu_torch.obs import drift as tdrift
from multihop_offload_tpu_torch.obs import events as obs_events
from multihop_offload_tpu_torch.obs.registry import registry as obs_registry
from multihop_offload_tpu_torch.serve.bucketing import pack_bucket
from multihop_offload_tpu_torch.serve.request import OffloadResponse
from multihop_offload_tpu_torch.train import checkpoints as ckpt_lib
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401
from tests.test_torch_serve import _cfgs, _clock, _compare, _services, _streams

SVC = dict(serve_slots=2, serve_queue_cap=16, serve_deadline_s=60.0,
           loop_capture_sample=1.0, learning_rate=1e-2)
COUNT = 6


def _state(svc) -> dict:
    return {k: v.detach().clone() for k, v in svc.executor.model.state_dict().items()}


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    """Both services with 100% capture drain the same 6 requests, each into
    its own run log."""
    d = tmp_path_factory.mktemp("loop")
    t, clock = _clock()
    jsvc, tsvc, jpool, tpool = _services(clock, **SVC)
    jreqs, treqs = _streams(jpool, tpool, COUNT, seed=11)
    paths = (str(d / "jax.jsonl"), str(d / "port.jsonl"))
    jlog = jevents.RunLog(paths[0], manifest={"event": "manifest", "ts": 0.0})
    tlog = obs_events.RunLog(paths[1], manifest={"event": "manifest", "ts": 0.0})
    jevents.set_run_log(jlog)
    obs_events.set_run_log(tlog)
    try:
        for jr, tr in zip(jreqs, treqs):
            assert jsvc.submit(jr) and tsvc.submit(tr)
        t[0] += 0.5
        jres, tres = jsvc.drain(), tsvc.drain()
    finally:
        jevents.set_run_log(None)
        obs_events.set_run_log(None)
        jlog.close()
        tlog.close()
    _compare(jres, tres)
    return dict(jsvc=jsvc, tsvc=tsvc, jpool=jpool, tpool=tpool, jreqs=jreqs,
                treqs=treqs, jres=jres, tres=tres, jpath=paths[0], path=paths[1])


# ---- log-segment rotation --------------------------------------------------


def test_log_rotation_and_spanning_reader(tmp_path):
    path = str(tmp_path / "run.jsonl")
    log = obs_events.RunLog(path, manifest={"event": "manifest", "ts": 0.0},
                            max_bytes=400)
    for i in range(40):
        log.emit("tick", i=i, pad="x" * 40)
    log.close()
    segs = obs_events.segment_paths(path)
    assert len(segs) >= 2, "log never rotated"
    assert segs[-1] == path  # active segment is last (newest)
    evs = list(obs_events.read_events(path))
    ticks = [e for e in evs if e["event"] == "tick"]
    assert [e["i"] for e in ticks] == list(range(40))  # nothing lost, in order
    headers = [e for e in evs if e["event"] == "segment"]
    assert len(headers) == len(segs) - 1
    assert [h["seq"] for h in headers] == sorted(h["seq"] for h in headers)
    # a crash can truncate ANY segment mid-line; the reader must survive
    with open(path, "a") as f:
        f.write('{"event": "tick", "i": 99, "trunc')
    ticks2 = [e for e in obs_events.read_events(path) if e["event"] == "tick"]
    assert [e["i"] for e in ticks2] == list(range(40))


# ---- sampling and the holdout split ------------------------------------------


def test_capture_sampling_is_deterministic_per_id():
    assert all(experience.sampled(i, 1.0) for i in range(50))
    assert not any(experience.sampled(i, 0.0) for i in range(50))
    picked = {i for i in range(2000) if experience.sampled(i, 0.5)}
    assert picked == {i for i in range(2000) if experience.sampled(i, 0.5)}
    assert 0.4 < len(picked) / 2000 < 0.6


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_sampled_agrees_with_jax(rate):
    ids = range(100_001)
    assert [experience.sampled(i, rate) for i in ids] == [jexp.sampled(i, rate) for i in ids]


def test_holdout_split_is_a_stable_partition(captured):
    outcomes = experience.read_outcomes(captured["path"])
    train, hold = experience.split_holdout(outcomes, 0.5)
    assert len(train) + len(hold) == len(outcomes)
    train2, hold2 = experience.split_holdout(list(reversed(outcomes)), 0.5)
    assert {o.request.request_id for o in hold} == {o.request.request_id for o in hold2}
    assert experience.split_holdout(outcomes, 0.0)[1] == []
    assert experience.split_holdout(outcomes, 1.0)[0] == []
    # JAX's partition of the same log, and of a wide id range
    jouts = jexp.read_outcomes(captured["path"])
    for frac in (0.25, 0.5, 0.75):
        got = [[o.request.request_id for o in part]
               for part in experience.split_holdout(outcomes, frac)]
        want = [[o.request.request_id for o in part]
                for part in jexp.split_holdout(jouts, frac)]
        assert got == want
        ids = range(20_000)
        assert [experience._hash01(i, salt=2) < frac for i in ids] == \
            [jexp._hash01(i, salt=2) < frac for i in ids]


# ---- experience round-trip -------------------------------------------------


def test_outcome_events_round_trip(captured):
    outcomes = experience.read_outcomes(captured["path"])
    assert len(outcomes) == COUNT  # sample=1.0, nothing degraded
    by_id = {o.request.request_id: o for o in outcomes}
    resp_by_id = {r.request_id: r for r in captured["tres"]}
    for req in captured["treqs"]:
        o = by_id[req.request_id]
        r = resp_by_id[req.request_id]
        for f in ("adj", "link_ends", "link_index", "adj_conflict", "cf_degs"):
            np.testing.assert_array_equal(getattr(o.request.topo, f),
                                          getattr(req.topo, f), err_msg=f)
        for f in ("roles", "proc_bws", "link_rates", "job_src", "job_rate"):
            np.testing.assert_array_equal(getattr(o.request, f), getattr(req, f),
                                          err_msg=f)
        assert (o.request.ul, o.request.dl, o.request.t_max) == (req.ul, req.dl, req.t_max)
        assert o.request.topo_key == str(req.topo_key)
        np.testing.assert_array_equal(o.dst, r.dst)
        np.testing.assert_array_equal(o.is_local, r.is_local)
        np.testing.assert_array_equal(o.job_total, r.job_total)
        assert o.served_by == "gnn" and not o.degraded
        assert o.tau == pytest.approx(float(np.mean(o.job_total)), rel=1e-15)
    reg = obs_registry()
    assert reg.counter("mho_serve_outcomes_captured_total").total() >= COUNT
    hops = [e for e in obs_events.read_events(captured["path"])
            if e["event"] == "trace" and e.get("hop") == "capture"]
    assert sorted(i for h in hops for i in h["request_ids"]) == list(range(COUNT))


def test_outcome_records_equal_jax(captured):
    """The same request and response give JAX's record, JSON for JSON; the
    two services' logged rows agree (floats within 1e-12)."""
    for jq, tq, jr in zip(captured["jreqs"], captured["treqs"], captured["jres"]):
        tr = OffloadResponse(request_id=jr.request_id, dst=np.asarray(jr.dst),
                             is_local=np.asarray(jr.is_local),
                             delay_est=np.asarray(jr.delay_est),
                             job_total=np.asarray(jr.job_total), served_by=jr.served_by,
                             bucket=jr.bucket, latency_s=jr.latency_s)
        assert json.dumps(experience.outcome_record(tq, tr), sort_keys=True) == \
            json.dumps(jexp.outcome_record(jq, jr), sort_keys=True)
    rows = {}
    for name, read in (("jax", jevents.read_events), ("port", obs_events.read_events)):
        path = captured["jpath" if name == "jax" else "path"]
        rows[name] = [e for e in read(path) if e["event"] == "outcome"]
    assert len(rows["port"]) == len(rows["jax"]) == COUNT
    for t, j in zip(rows["port"], rows["jax"]):
        assert set(t) == set(j)
        for k in t:
            if k in ("ts", "trace_id"):
                continue
            if k in ("job_total", "tau"):
                np.testing.assert_allclose(t[k], j[k], rtol=1e-12, atol=0)
            else:
                assert t[k] == j[k], k


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_replay_batches_equal_jax(captured, dtype):
    """The port's replay batches of the log equal JAX's batches of the
    same log, field for field, and each request packs as the service
    packed it."""
    tdt, ndt = {"float32": (torch.float32, np.float32),
                "float64": (torch.float64, np.float64)}[dtype]
    outcomes = experience.read_outcomes(captured["path"])
    jouts = jexp.read_outcomes(captured["path"])
    pad = experience.pad_for_outcomes(outcomes, round_to=8)
    jpad = jexp.pad_for_outcomes(jouts, round_to=8)
    assert (pad.n, pad.l, pad.s, pad.j) == (jpad.n, jpad.l, jpad.s, jpad.j)
    got = list(experience.replay_batches(outcomes, pad, slots=4, dtype=tdt))
    want = list(jexp.replay_batches(jouts, jpad, slots=4, dtype=ndt))
    assert len(got) == len(want) == 2
    for (ti, tj), (ji, jj) in zip(got, want):
        for rec_t, rec_j in ((ti, ji), (tj, jj)):
            for f in type(rec_t).__dataclass_fields__:
                if f == "sparse":
                    continue
                a, b = getattr(rec_t, f).numpy(), np.asarray(getattr(rec_j, f))
                assert a.dtype == b.dtype and a.shape[0] == 4, f
                np.testing.assert_array_equal(a, b, err_msg=f)
    by_id = {o.request.request_id: o for o in outcomes}
    for req in captured["treqs"]:
        a = pack_bucket([by_id[req.request_id].request], pad, 1, dtype=tdt)
        b = pack_bucket([req], pad, 1, dtype=tdt)
        for rec_a, rec_b in zip(a, b):
            for f in type(rec_a).__dataclass_fields__:
                if f != "sparse":
                    assert torch.equal(getattr(rec_a, f), getattr(rec_b, f)), f


# ---- refit -----------------------------------------------------------------


def test_refit_matches_jax(captured):
    """Three steps from the service's weights, lr 1e-2: the candidate
    within 1e-10 (scaled) of JAX's, the losses within 1e-10."""
    jcfg, cfg = _cfgs(**SVC)
    outcomes = experience.read_outcomes(captured["path"])
    jouts = jexp.read_outcomes(captured["path"])
    jsvc, tsvc = captured["jsvc"], captured["tsvc"]
    j_vars, j_info = jrefit.refit(jsvc.executor.model, jsvc.executor.variables, jouts,
                                  jcfg, steps=3, slots=2, seed=0)
    t_vars, t_info = refit(tsvc.executor.model, {"params": _state(tsvc)}, outcomes, cfg,
                           steps=3, slots=2, seed=0, device="cpu")
    moved = []
    for k, p in t_vars["params"].items():
        _, i, leaf = k.split(".")
        want = np.asarray(j_vars["params"][f"cheb_{i}"][leaf])
        got = p.numpy()
        scale = max(np.abs(want).max(), 1e-300)
        assert np.abs(got - want).max() / scale <= 1e-10, k
        if not np.array_equal(got, _state(tsvc)[k].numpy()):
            moved.append(k)
    assert [k for k in t_vars["params"] if k.endswith("kernel")] == \
        [k for k in moved if k.endswith("kernel")]  # every kernel moved
    for key in ("loss_critic_first", "loss_critic_last", "loss_mse_last"):
        np.testing.assert_allclose(t_info[key], j_info[key], rtol=1e-10)
    assert (t_info["steps"], t_info["batches"], t_info["skipped_updates"]) == \
        (j_info["steps"], j_info["batches"], j_info["skipped_updates"]) == (3, 3, 0)
    # the serving model is untouched
    for k, v in tsvc.executor.model.state_dict().items():
        assert torch.equal(v, _state(tsvc)[k])


def test_refit_skips_nonfinite_updates(captured):
    cfg = _cfgs(**SVC)[1]
    outcomes = experience.read_outcomes(captured["path"])
    bad = {k: torch.full_like(v, float("nan")) for k, v in _state(captured["tsvc"]).items()}
    before = obs_registry().counter("mho_refit_skipped_updates_total").total()
    out, info = refit(captured["tsvc"].executor.model, {"params": bad}, outcomes, cfg,
                      steps=2, slots=2, device="cpu")
    assert info["skipped_updates"] == 2
    assert all(bool(torch.isnan(v).all()) for v in out["params"].values())
    assert obs_registry().counter("mho_refit_skipped_updates_total").total() == before + 2


# ---- validation and the gate rule ---------------------------------------------


def _score(ratio, tau, generated=100):
    return {"generated": generated, "delivered": int(ratio * generated),
            "delivered_ratio": ratio, "mean_packet_delay": tau}


def test_gates_pass_within_budgets():
    ok, reasons = apply_gates(_score(0.95, 1.0), _score(0.94, 1.05),
                              max_delivered_drop=0.02, max_tau_ratio=1.10)
    assert ok and reasons == []


def test_gates_fail_on_delivered_drop():
    ok, reasons = apply_gates(_score(0.95, 1.0), _score(0.90, 1.0),
                              max_delivered_drop=0.02, max_tau_ratio=1.10)
    assert not ok and any("delivered_ratio" in r for r in reasons)


def test_gates_fail_on_tau_regression():
    ok, reasons = apply_gates(_score(0.95, 1.0), _score(0.95, 1.2),
                              max_delivered_drop=0.02, max_tau_ratio=1.10)
    assert not ok and any("mean_packet_delay" in r for r in reasons)


def test_gates_degenerate_packet_counts():
    dead = {"generated": 100, "delivered": 0, "delivered_ratio": 0.0,
            "mean_packet_delay": None}
    ok, reasons = apply_gates(_score(0.95, 1.0), dead,
                              max_delivered_drop=0.02, max_tau_ratio=1.10)
    assert not ok and any("no packets" in r for r in reasons)
    ok, _ = apply_gates(dead, _score(0.5, 3.0), max_delivered_drop=0.02,
                        max_tau_ratio=1.10)
    assert ok


def test_gate_and_monitor_verdicts_equal_jax():
    rng = np.random.default_rng(5)
    dead = {"generated": 100, "delivered": 0, "delivered_ratio": 0.0,
            "mean_packet_delay": None}
    pairs = [(dead, _score(0.5, 3.0)), (_score(0.95, 1.0), dead), (dead, dead)]
    pairs += [(_score(*rng.uniform([0.8, 0.5], [1.0, 2.0])),
               _score(*rng.uniform([0.8, 0.5], [1.0, 2.0]))) for _ in range(200)]
    for champ, cand in pairs:
        for drop, ratio in ((0.02, 1.10), (0.1, 1.5)):
            assert apply_gates(champ, cand, drop, ratio) == \
                jvalidate.apply_gates(champ, cand, drop, ratio)
    for pre, post in [(None, 5.0), (1.0, None), (0.0, 3.0)] + \
            [tuple(rng.uniform(0.5, 2.0, 2)) for _ in range(200)]:
        for m in (1.1, 1.5):
            assert monitor_ok(pre, post, m) == jpromote.monitor_ok(pre, post, m)


def test_monitor_rule():
    assert monitor_ok(None, 5.0, 1.5)
    assert monitor_ok(1.0, None, 1.5)
    assert monitor_ok(1.0, 1.49, 1.5)
    assert not monitor_ok(1.0, 1.51, 1.5)


def test_ab_compare_same_weights_tie(captured):
    """Both arms on the same weights and lane seeds score identically; the
    sim replays every held-out request."""
    outcomes = experience.read_outcomes(captured["path"])
    tsvc = captured["tsvc"]
    v = {"params": _state(tsvc)}
    scores = ab_compare(tsvc.executor.model, v, v, outcomes[:3], rounds=1,
                        slots_per_round=40, seed=3, dtype=torch.float64, device="cpu")
    assert scores["champion"] == scores["candidate"]
    assert scores["fleet"] == 3 and scores["slots"] == 40
    assert scores["champion"]["generated"] > 0
    ok, reasons = apply_gates(scores["champion"], scores["candidate"], 0.02, 1.10)
    assert ok and reasons == []


def test_drift_monitor_trips_like_jax():
    """A stationary stream, then a shift in load and offloading: both
    monitors trip at the same ticks with the same statistics."""
    rng = np.random.default_rng(9)
    stream = []
    for tick in range(120):
        shift = tick >= 60
        n = 6
        stream.append({"tau": float(rng.normal(3.0 if shift else 1.0, 0.2)),
                       "is_local": (rng.uniform(size=n) < (0.2 if shift else 0.7)).tolist(),
                       "job_rate": rng.uniform(0.1, 0.6 if shift else 0.3, n).tolist()})
    port, jaxm = tdrift.DriftMonitor(min_samples=16), jdrift.DriftMonitor(min_samples=16)
    for tick, ev in enumerate(stream):
        assert port.update(ev) == jaxm.update(ev), tick
    assert port.trips == jaxm.trips
    assert {t["signal"] for t in port.trips} >= {"tau", "arrival_rate"}
    assert all(t["samples"] > 60 for t in port.trips)  # none before the shift
    port.reset()
    assert not any(d.tripped for d in port.detectors.values())
    with pytest.raises(ValueError):
        tdrift.PageHinkley(min_samples=1)
    with pytest.raises(ValueError):
        tdrift.EWMADetector(alpha=0.0)


# ---- the canary ------------------------------------------------------------------


def test_canary_probe_decisions_equal_jax(captured):
    jsvc, tsvc = captured["jsvc"], captured["tsvc"]
    jc = jcanary_mod.CheckpointCanary(jsvc, captured["jpool"], count=6, seed=11)
    tc = CheckpointCanary(tsvc, captured["tpool"], count=6, seed=11)
    jrows = jc._probe(jsvc.executor.variables)
    trows = tc._probe(_state(tsvc))
    assert len(trows) == len(jrows) >= 1
    for (td, tl, te, tt, tlive), (jd, jl, je, jt, jlive) in zip(trows, jrows):
        np.testing.assert_array_equal(tlive, jlive)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_allclose(te[tlive], je[jlive], rtol=1e-12, atol=0)
        np.testing.assert_allclose(tt[tlive], jt[jlive], rtol=1e-12, atol=0)


def test_canary_is_deterministic_and_gates_on_its_champion(captured):
    tsvc = captured["tsvc"]
    canary = CheckpointCanary(tsvc, captured["tpool"], count=6, seed=13,
                              min_agreement=0.95)
    assert canary.check({"params": _state(tsvc)}) is None  # finiteness only
    canary.record_champion()
    assert canary.check({"params": _state(tsvc)}) is None  # self-agreement
    scrambled = {k: v.reshape(-1).flip(0).reshape(v.shape).contiguous()
                 for k, v in _state(tsvc).items()}
    why = canary.check({"params": scrambled})
    assert why is None or why.startswith("decision_collapse:agreement")
    assert all(canary.check({"params": scrambled}) == why for _ in range(2))
    nan = {k: torch.full_like(v, float("nan")) for k, v in _state(tsvc).items()}
    assert canary.check({"params": nan}) == "nonfinite_probe_outputs"


# ---- the promotion state machine ------------------------------------------------


def _service():
    from multihop_offload_tpu_torch.cli.serve import build_service
    from multihop_offload_tpu_torch.serve.workload import case_pool

    cfg = Config(seed=7, dtype="float32", serve_slots=2, serve_queue_cap=16,
                 serve_deadline_s=60.0, serve_buckets=2, model_root="/nonexistent-model-root")
    return build_service(cfg, pool=case_pool([10, 16], per_size=1, seed=cfg.seed),
                         device="cpu")


def test_promotion_state_machine(tmp_path):
    obs_registry().reset()
    service, _ = _service()
    model_dir = str(tmp_path / "model")
    ctl = PromotionController(model_dir)
    assert ctl.state == "idle"
    with pytest.raises(ValueError, match="unknown loop state"):
        ctl.transition("launched")

    champion = _state(service)
    ckpt_lib.save_checkpoint(os.path.join(model_dir, "torch"), 1, {"params": champion},
                             lineage=ckpt_lib.make_lineage("offline"))
    assert service.hot_reload(model_dir) == 1

    # a structurally wrong candidate is rejected BEFORE any save
    bad = {"params": {"oops": torch.zeros(2, 2)}}
    assert ctl.promote(service, bad, candidate_step=7) is None
    assert ctl.state == "rejected"
    assert service.executor.loaded_step == 1
    assert ckpt_lib.latest_step(ctl.directory) == 1

    # a matching candidate promotes through hot-reload at a fresh step
    cand = {k: v + 0.5 for k, v in champion.items()}
    step = ctl.promote(service, {"params": cand}, candidate_step=7)
    assert step == 2 and ctl.state == "promoted"
    assert service.executor.loaded_step == 2
    assert service.executor.loaded_lineage["source"] == "refit"
    assert service.executor.loaded_lineage["parent_step"] == 7
    for k, v in service.executor.model.state_dict().items():
        assert torch.equal(v, cand[k])

    # rollback re-pins the champion at the NEXT monotone step
    rb = ctl.rollback(service, {"params": champion}, "measured regression",
                      failed_step=step)
    assert rb == 3 and ctl.state == "rolled_back"
    assert service.executor.loaded_step == 3
    lin = service.executor.loaded_lineage
    assert lin["source"] == "rollback" and lin["parent_step"] == 2
    assert lin["reason"] == "measured regression"
    for k, v in service.executor.model.state_dict().items():
        assert torch.equal(v, champion[k])

    reg = obs_registry()
    assert reg.counter("mho_loop_promotions_total").total() == 1
    assert reg.counter("mho_loop_rejections_total").total() == 1
    assert reg.counter("mho_loop_rollbacks_total").total() == 1
    assert [h["state"] for h in ctl.history] == ["rejected", "promoting", "promoted",
                                                 "rolling_back", "rolled_back"]


def test_promotion_canary_refuses_poisoned_candidate(tmp_path):
    """A NaN-poisoned candidate is refused in the journaled 'canarying'
    state BEFORE the write-ahead 'promoting' intent; the same poison at the
    hot-reload surface is refused too, nothing quarantined."""
    obs_registry().reset()
    service, pool = _service()
    model_dir = str(tmp_path / "model")
    ctl = PromotionController(model_dir)
    champion = _state(service)
    ckpt_lib.save_checkpoint(os.path.join(model_dir, "torch"), 1, {"params": champion},
                             lineage=ckpt_lib.make_lineage("offline"))
    assert service.hot_reload(model_dir) == 1
    canary = CheckpointCanary(service, pool, count=6, seed=11)
    canary.record_champion()

    poisoned = {k: torch.full_like(v, float("nan")) for k, v in champion.items()}
    assert ctl.promote(service, {"params": poisoned}, candidate_step=7,
                       canary=canary) is None
    assert ctl.state == "rejected"
    assert service.executor.loaded_step == 1
    assert ckpt_lib.latest_step(ctl.directory) == 1  # nothing saved
    assert [h["state"] for h in ctl.history][:2] == ["canarying", "rejected"]
    reg = obs_registry()
    assert reg.counter("mho_canary_rejections_total").total(
        stage="promote", reason="nonfinite_probe_outputs") == 1

    cand = {k: v + 1e-4 for k, v in champion.items()}
    assert ctl.promote(service, {"params": cand}, candidate_step=8, canary=canary) == 2
    assert ctl.state == "promoted" and service.executor.loaded_step == 2

    # checksum-valid poison on the serving tree: refused at hot reload, twice
    service.executor.canary = canary
    from multihop_offload_tpu_torch.chaos import faults

    bad_step = faults.poison_checkpoint(ctl.directory, mode="nan", seed=1)
    assert service.hot_reload(model_dir) is None
    assert service.hot_reload(model_dir) is None  # the refusal is remembered
    assert service.executor.loaded_step == 2 and bad_step == 3
    assert reg.counter("mho_canary_rejections_total").total(stage="hot_reload") == 1
    assert not os.path.isdir(os.path.join(ctl.directory, "quarantine"))


def test_checkpoint_lineage_sidecar_round_trip(tmp_path):
    d = str(tmp_path / "torch")
    params = {"params": {"w": torch.ones(3)}}
    lin = ckpt_lib.make_lineage("offline", cfg=Config(seed=3), extra={"note": "seed run"})
    ckpt_lib.save_checkpoint(d, 4, params, lineage=lin)
    got = ckpt_lib.load_lineage(d)
    assert got["step"] == 4 and got["source"] == "offline"
    assert got["note"] == "seed run"
    assert got["config_hash"]
    with open(os.path.join(d, "lineage", "4.json")) as f:
        assert json.load(f) == got
    assert ckpt_lib.load_lineage(d, step=99) is None


# ---- mho-loop --------------------------------------------------------------------


def test_loop_smoke_promotes_and_rolls_back(tmp_path):
    """`mho-loop --smoke --device cpu`: >= 2 log segments, gates pass, one
    promotion, the injected regression, rollback lineage; the record is
    written only where --loop_out names."""
    out_path = str(tmp_path / "rec" / "smoke.json")
    assert tloop.main(["--smoke", "--device", "cpu", "--loop_out", out_path]) == 0
    with open(out_path) as f:
        rec = json.load(f)
    assert rec["ok"] and all(rec["checks"].values())
    cyc = rec["cycles"][0]
    assert cyc["promoted_step"] == 2 and cyc["rollback_step"] == 3
    assert rec["final_state"] == "rolled_back" and rec["device"] == "cpu"
    assert cyc["refit"]["steps"] == 2 and len(cyc["refit"]["step_ms"]) == 2
    assert rec["states"][:4] == ["capturing", "refitting", "validating", "canarying"]
