"""PyTorch port, serving across hosts: `multihost/plan.py`,
`multihost/federation.py`, `obs/slo.py`, `loadgen/` and `mho-mesh`, against
the JAX package's.

The counterparts of the planner, loadgen and federation tests of
`tests/test_multihost.py`, each also holding the port's output equal to
the JAX module's on the same inputs: two-level plans, arrival times (bit
for bit: both draw from the standard library's `random`), open-loop
reports, bisection paths, parsed metric families, merged series (the
federated registries' exposition text) and SLO burn rates and alerts.
Last, `mho-mesh --smoke --device cpu` end to end in two gloo processes,
under a time limit of its own.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from multihop_offload_tpu import loadgen as jlg
from multihop_offload_tpu import multihost as jmh
from multihop_offload_tpu.loadgen import driver as jdriver
from multihop_offload_tpu.obs import slo as jslo
from multihop_offload_tpu_torch import loadgen as tlg
from multihop_offload_tpu_torch import multihost as tmh
from multihop_offload_tpu_torch.loadgen import driver as tdriver
from multihop_offload_tpu_torch.obs import slo as tslo

# the registry modules (each package's `obs` also exports a `registry()`)
jregistry = importlib.import_module("multihop_offload_tpu.obs.registry")
tregistry = importlib.import_module("multihop_offload_tpu_torch.obs.registry")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOSTS = {"hostA": [0, 1, 2, 3], "hostB": [10, 11]}


def _same_plan(p, j):
    assert (p.hosts, p.devices) == (j.hosts, j.devices)
    assert p.describe() == j.describe()


# ---------------------------------------------------------------------------
# two-level placement
# ---------------------------------------------------------------------------


def test_plan_two_level_worked_example():
    plan = tmh.plan_two_level([4.0, 2.0, 1.0], HOSTS, slots=4)
    _same_plan(plan, jmh.plan_two_level([4.0, 2.0, 1.0], HOSTS, slots=4))
    assert plan.hosts == ("hostA", "hostB", "hostA")
    assert plan.buckets_on_host("hostA") == [0, 2]
    assert plan.buckets_on_host("hostB") == [1]
    for b in range(3):
        assert set(plan.devices_for(b)) <= set(HOSTS[plan.host_of(b)])
        assert plan.devices_for(b)
    d = plan.describe()
    assert d["1"]["host"] == "hostB" and set(d["1"]["devices"]) <= {10, 11}


def test_plan_two_level_deterministic_and_tie_breaks_lex():
    a = tmh.plan_two_level([3.0, 3.0], HOSTS, slots=4)
    assert a == tmh.plan_two_level([3.0, 3.0], HOSTS, slots=4)
    _same_plan(a, jmh.plan_two_level([3.0, 3.0], HOSTS, slots=4))
    table = {"a": [0, 1], "b": [2, 3]}
    even = tmh.plan_two_level([2.0, 2.0], table, slots=2)
    assert even.hosts == ("a", "b")
    _same_plan(even, jmh.plan_two_level([2.0, 2.0], table, slots=2))


def test_plan_two_level_rejects_bad_tables():
    for mod in (tmh, jmh):
        with pytest.raises(ValueError, match="at least one host"):
            mod.plan_two_level([1.0], {}, slots=4)
        with pytest.raises(ValueError, match="no devices"):
            mod.plan_two_level([1.0], {"a": []}, slots=4)


def test_validate_plan_catches_dcn_spanning():
    for mod in (tmh, jmh):
        with pytest.raises(ValueError, match="spans the DCN boundary"):
            mod.validate_plan(mod.TwoLevelPlan(hosts=("hostA",), devices=((0, 10),)), HOSTS)
        with pytest.raises(ValueError, match="unknown host"):
            mod.validate_plan(mod.TwoLevelPlan(("ghost",), ((0,),)), HOSTS)
        with pytest.raises(ValueError, match="no devices"):
            mod.validate_plan(mod.TwoLevelPlan(("hostA",), ((),)), HOSTS)


def test_local_placement_projects_and_placeholders():
    plan = tmh.plan_two_level([4.0, 2.0, 1.0], HOSTS, slots=4)
    jplan = jmh.plan_two_level([4.0, 2.0, 1.0], HOSTS, slots=4)
    local = ["devX", "devY"]
    pp = tmh.local_placement(plan, "hostB", local)
    assert pp.assignments == jmh.local_placement(jplan, "hostB", local).assignments
    assert len(pp.assignments) == 3
    assert set(pp.assignments[1]) <= set(local)
    assert len(pp.assignments[1]) == len(plan.devices_for(1))
    assert pp.assignments[0] == ("devX",) and pp.assignments[2] == ("devX",)
    pp2 = tmh.local_placement(plan, "hostB", local, fallback_device="devY")
    assert pp2.assignments[0] == ("devY",)
    assert pp2.assignments == jmh.local_placement(jplan, "hostB", local,
                                                  fallback_device="devY").assignments
    with pytest.raises(ValueError, match="has 1 locally"):
        tmh.local_placement(plan, "hostA", ["only_one"])
    with pytest.raises(ValueError, match="at least one local device"):
        tmh.local_placement(plan, "hostB", [])


def _planners(*args, **kw):
    return tmh.TwoLevelPlanner(*args, **kw), jmh.TwoLevelPlanner(*args, **kw)


def _same_planner(p, j):
    _same_plan(p.plan, j.plan)
    assert p.rates == j.rates and p.replans == j.replans and p.hosts == j.hosts


def test_planner_hysteresis_does_not_thrash_on_jitter():
    p, j = _planners(2, HOSTS, slots=4, alpha=0.5, hysteresis=0.2)
    for q in (p, j):
        q.observe([8.0, 4.0])
    first = p.replan()
    j.replan()
    base = p.replans
    for jitter in (1.1, 0.9, 1.05, 0.95, 1.0):
        for q in (p, j):
            q.observe([8.0 * jitter, 4.0 * jitter])
        assert p.replan() is first
        j.replan()
        _same_planner(p, j)
    assert p.replans == base


def test_planner_host_removal_forces_replan_and_recovery_waits():
    p, j = _planners(2, HOSTS, slots=4)
    for q in (p, j):
        q.observe([3.0, 2.0])
    plan = p.replan()
    j.replan()
    assert set(plan.hosts) == {"hostA", "hostB"}
    before = p.replans
    plan2 = p.remove_host("hostB")
    j.remove_host("hostB")
    _same_planner(p, j)
    assert p.replans == before + 1 and set(plan2.hosts) == {"hostA"}
    tmh.validate_plan(plan2, p.hosts)
    plan3 = p.add_host("hostB", HOSTS["hostB"])
    j.add_host("hostB", HOSTS["hostB"])
    _same_planner(p, j)
    tmh.validate_plan(plan3, p.hosts)
    assert "hostB" in p.hosts


def test_planner_rejects_mismatch_and_empty_fleet():
    for q in _planners(2, HOSTS, slots=4):
        with pytest.raises(ValueError, match="arrival counts"):
            q.observe([1.0])
        q.remove_host("hostB")
        with pytest.raises(ValueError, match="empty after host removal"):
            q.remove_host("hostA")


@pytest.mark.parametrize("seed", range(4))
def test_random_host_tables_plan_like_jax(seed):
    """Seeded host tables (1..4 hosts of 1..6 devices), rate vectors with
    ties and slot counts: equal plans, and planners fed the same windows,
    with a host lost and restored midway, equal at every step."""
    rng = np.random.default_rng(seed)
    for _ in range(15):
        hosts = {f"h{k}": list(range(10 * k, 10 * k + int(rng.integers(1, 7))))
                 for k in range(int(rng.integers(1, 5)))}
        rates = [float(x) for x in rng.choice([0.0, 1.0, 2.0, 5.0], int(rng.integers(1, 6)))]
        slots = int(rng.choice([2, 4, 6, 8]))
        _same_plan(tmh.plan_two_level(rates, hosts, slots),
                   jmh.plan_two_level(rates, hosts, slots))
    table = {"h0": [0, 1, 2, 3], "h1": [10, 11], "h2": [20, 21, 22]}
    p, j = _planners(3, table, slots=4, alpha=0.5, hysteresis=0.2)
    for step in range(10):
        arrivals = [int(x) for x in rng.poisson([5.0, 3.0, 1.0])]
        for q in (p, j):
            q.observe(arrivals)
        if step == 4:
            for q in (p, j):
                q.remove_host("h1")
        if step == 7:
            for q in (p, j):
                q.add_host("h1", table["h1"])
        p.replan()
        j.replan()
        _same_planner(p, j)


# ---------------------------------------------------------------------------
# loadgen: arrivals
# ---------------------------------------------------------------------------


def _models(**kw):
    return tlg.TrafficModel(**kw), jlg.TrafficModel(**kw)


def test_arrivals_deterministic_and_sorted():
    kw = dict(base_rate=50.0, diurnal_amplitude=0.3, diurnal_period_s=10.0,
              mmpp_burst_factor=2.0, mmpp_dwell_slow_s=2.0, mmpp_dwell_fast_s=1.0,
              flashes=((4.0, 1.0, 3.0),))
    m, jm = _models(**kw)
    a = tlg.arrival_times(m, 10.0, seed=7)
    assert a == tlg.arrival_times(m, 10.0, seed=7) == jlg.arrival_times(jm, 10.0, seed=7)
    assert a == sorted(a) and all(0.0 <= t < 10.0 for t in a)
    assert tlg.arrival_times(m, 10.0, seed=8) != a
    assert tlg.arrival_times(m, 10.0, seed=8) == jlg.arrival_times(jm, 10.0, seed=8)


def test_arrivals_mean_rate_tracks_base_rate():
    got = tlg.arrival_times(tlg.poisson(200.0), 50.0, seed=3)
    assert got == jlg.arrival_times(jlg.poisson(200.0), 50.0, seed=3)
    assert abs(len(got) - 200.0 * 50.0) < 5 * math.sqrt(200.0 * 50.0)


def test_traffic_model_validation_and_envelope():
    for mod in (tlg, jlg):
        with pytest.raises(ValueError):
            mod.TrafficModel(base_rate=0.0)
        with pytest.raises(ValueError):
            mod.TrafficModel(base_rate=1.0, diurnal_amplitude=1.0)
        with pytest.raises(ValueError):
            mod.TrafficModel(base_rate=1.0, mmpp_burst_factor=0.5)
    m, jm = _models(base_rate=10.0, diurnal_amplitude=0.5, mmpp_burst_factor=2.0,
                    flashes=((0.0, 1.0, 3.0),))
    assert m.envelope_rate() == pytest.approx(10.0 * 1.5 * 2.0 * 3.0) == jm.envelope_rate()
    assert m.at(20.0).base_rate == 20.0
    assert m.flash_factor(0.0) == 3.0 and m.flash_factor(1.0) == 1.0
    for t in (0.0, 0.3, 2.7, 9.9):
        assert m.rate_at(t, True) == jm.rate_at(t, True)


@pytest.mark.parametrize("seed", [0, 5, 12])
def test_arrival_streams_and_rate_profiles_equal_jax(seed):
    """Bursty, diurnal and flash models over several seeds: the same
    arrival times bit for bit, and the same per-segment rate profile."""
    kw = dict(base_rate=30.0, diurnal_amplitude=0.4, diurnal_period_s=7.0,
              mmpp_burst_factor=3.0, mmpp_dwell_slow_s=1.5, mmpp_dwell_fast_s=0.5,
              flashes=((2.0, 0.5, 4.0), (5.0, 1.0, 2.0)))
    m, jm = _models(**kw)
    assert tlg.arrival_times(m, 12.0, seed) == jlg.arrival_times(jm, 12.0, seed)
    for norm in (True, False):
        assert (tlg.rate_profile(m, 12.0, 6, seed, normalize=norm)
                == jlg.rate_profile(jm, 12.0, 6, seed, normalize=norm))


# ---------------------------------------------------------------------------
# loadgen: open-loop driver + bisection (fake service, pure python)
# ---------------------------------------------------------------------------


class FakeService:
    """Bounded queue, fixed drain per tick: the submit/tick subset the
    driver uses (as `tests/test_multihost.py`'s)."""

    def __init__(self, queue_cap: int = 8, per_tick: int = 4):
        self.queue_cap = queue_cap
        self.per_tick = per_tick
        self.q = []
        self.last_submit_outcome = None

    def submit(self, req, now=None):
        if len(self.q) >= self.queue_cap:
            self.last_submit_outcome = "backpressure"
            return False
        self.q.append(float(now))
        self.last_submit_outcome = "admitted"
        return True

    def tick(self, now=None):
        batch, self.q = self.q[: self.per_tick], self.q[self.per_tick:]
        return [SimpleNamespace(latency_s=float(now) - t, served_by="gnn") for t in batch]


def _open_loop(rate, span, seed, **kw):
    """(port report, JAX report) of the same fake service and arrivals."""
    out = []
    for lg in (tlg, jlg):
        arr = lg.arrival_times(lg.poisson(rate), span, seed=seed)
        out.append(lg.run_open_loop(FakeService(queue_cap=8, per_tick=4),
                                    [object()] * len(arr), arr,
                                    clock=lg.VirtualClock(), tick_interval_s=0.1, **kw))
    assert out[0].to_json() == out[1].to_json()
    return out[0]


def test_open_loop_underload_serves_everything():
    rep = _open_loop(10.0, 5.0, seed=1)
    assert rep.dropped == 0 and rep.drop_fraction == 0.0
    assert rep.served == rep.admitted == rep.offered and rep.drained
    assert rep.outcomes == {"admitted": rep.offered}
    assert rep.p99_s is not None and rep.p99_s <= 0.3
    assert rep.meets(p99_slo_s=0.5, max_drop_fraction=0.0)


def test_open_loop_overload_shows_drops_not_backoff():
    rep = _open_loop(200.0, 3.0, seed=2)
    assert rep.drop_fraction > 0.5
    assert rep.outcomes.get("backpressure", 0) == rep.dropped
    assert rep.served == rep.admitted and rep.drained
    assert not rep.meets(p99_slo_s=10.0, max_drop_fraction=0.01)


def test_open_loop_rejects_bad_tick_and_clock_never_rewinds():
    for lg in (tlg, jlg):
        with pytest.raises(ValueError, match="tick_interval_s"):
            lg.run_open_loop(FakeService(), [], [], clock=lg.VirtualClock(),
                             tick_interval_s=0.0)
        c = lg.VirtualClock(5.0)
        with pytest.raises(ValueError, match="rewind"):
            c.seek(4.0)
        c.advance(1.0)
        assert c() == 6.0


def _fake_report(driver, ok: bool):
    return driver.OpenLoopReport(
        offered=100, admitted=100 if ok else 60,
        dropped=0 if ok else 40, served=100 if ok else 60, degraded=0,
        duration_s=1.0, offered_rate=100.0, served_rate=100.0,
        drop_fraction=0.0 if ok else 0.4,
        p50_s=0.01, p95_s=0.02, p99_s=0.05 if ok else 9.0, max_s=0.1,
        drained=True, outcomes={},
    )


def _bisect(passes, **kw):
    """(port result, JAX result) of the same probe outcome function."""
    res = [lg.max_sustained_rate(lambda r, d=d: _fake_report(d, passes(r)), **kw)
           for lg, d in ((tlg, tdriver), (jlg, jdriver))]
    assert res[0].to_json() == res[1].to_json()
    return res[0]


def test_bisection_pins_the_knee():
    res = _bisect(lambda r: r <= 37.0, lo_rps=10.0, p99_slo_s=1.0, iters=8, max_doublings=4)
    assert res.sustained_rps <= 37.0 < res.collapse_rps
    assert res.collapse_rps - res.sustained_rps < 1.0
    assert all("offered_rps" in p for p in res.probes)
    assert any(p["ok"] for p in res.probes) and any(not p["ok"] for p in res.probes)


def test_bisection_walks_down_when_lo_fails_and_reports_zero_floor():
    res = _bisect(lambda r: r <= 5.0, lo_rps=40.0, p99_slo_s=1.0, iters=6, max_doublings=4)
    assert 0 < res.sustained_rps <= 5.0
    res0 = _bisect(lambda r: False, lo_rps=8.0, p99_slo_s=1.0, iters=4, max_doublings=3)
    assert res0.sustained_rps == 0.0
    with pytest.raises(ValueError):
        tlg.max_sustained_rate(lambda r: _fake_report(tdriver, True), lo_rps=0.0,
                               p99_slo_s=1.0)


def test_bisection_never_failing_returns_proven_rate():
    res = _bisect(lambda r: True, lo_rps=10.0, p99_slo_s=1.0, iters=4, max_doublings=3)
    assert res.sustained_rps == 80.0 and res.collapse_rps is None


# ---------------------------------------------------------------------------
# federation (callable targets; the endpoint over loopback once)
# ---------------------------------------------------------------------------


def _host_registry(reg_mod, served: int, lat: float):
    reg = reg_mod.MetricRegistry()
    reg.counter("mho_serve_served_total", "t").inc(served, served_by="gnn")
    reg.histogram("mho_serve_latency_seconds", "t", buckets=[0.1, 1.0]).observe(lat)
    reg.gauge("mho_serve_queue_depth", "t").set(3.0)
    return reg


def _registries(served_lat: dict):
    """{host: registry} in the port and in JAX, with the same contents."""
    return ({h: _host_registry(tregistry, *v) for h, v in served_lat.items()},
            {h: _host_registry(jregistry, *v) for h, v in served_lat.items()})


def _feds(tregs, jregs, **kw):
    return (tmh.FleetFederation({h: r.prometheus_text for h, r in tregs.items()}, **kw),
            jmh.FleetFederation({h: r.prometheus_text for h, r in jregs.items()}, **kw))


def _same_merge(fed, jfed):
    assert fed.registry.prometheus_text() == jfed.registry.prometheus_text()
    assert fed.registry.snapshot() == jfed.registry.snapshot()


def test_prometheus_parse_round_trip():
    treg, jreg = _host_registry(tregistry, 7, 0.05), _host_registry(jregistry, 7, 0.05)
    assert treg.prometheus_text() == jreg.prometheus_text()
    fams = tmh.parse_prometheus_text(treg.prometheus_text())
    assert fams == jmh.parse_prometheus_text(jreg.prometheus_text())
    assert fams["mho_serve_served_total"]["kind"] == "counter"
    assert fams["mho_serve_served_total"]["series"][(("served_by", "gnn"),)] == 7.0
    h = fams["mho_serve_latency_seconds"]
    assert h["kind"] == "histogram" and h["boundaries"] == [0.1, 1.0]
    (key, s), = h["series"].items()
    assert s["count"] == 1 and s["buckets"] == [1, 0, 0]
    assert s["sum"] == pytest.approx(0.05)
    assert fams["mho_serve_queue_depth"]["series"][()] == 3.0


def test_federation_merges_hosts_and_deltas():
    tregs, jregs = _registries({"host0": (7, 0.05), "host1": (5, 2.0)})
    fed, jfed = _feds(tregs, jregs)
    assert fed.scrape() == jfed.scrape() == {"host0": True, "host1": True}
    _same_merge(fed, jfed)
    served = fed.registry.counter("mho_serve_served_total")
    assert served.total() == 12.0
    assert served.total(host="host0") == 7.0 and served.total(host="host1") == 5.0
    for regs in (tregs, jregs):
        regs["host0"].counter("mho_serve_served_total").inc(3, served_by="gnn")
    fed.scrape()
    jfed.scrape()
    _same_merge(fed, jfed)
    assert served.total() == 15.0 and served.total(host="host1") == 5.0
    hist = fed.registry.histogram("mho_serve_latency_seconds", buckets=[0.1, 1.0])
    assert hist.le_total(1.0) == (1, 2)
    assert hist.le_total(1.0) == jfed.registry.histogram(
        "mho_serve_latency_seconds", buckets=[0.1, 1.0]).le_total(1.0)


def test_federation_counter_reset_treated_as_fresh():
    tregs, jregs = _registries({"host0": (10, 0.05)})
    fed, jfed = _feds(tregs, jregs)
    fed.scrape()
    jfed.scrape()
    assert fed.registry.counter("mho_serve_served_total").total() == 10.0
    fed.targets["host0"] = _host_registry(tregistry, 2, 0.05).prometheus_text
    jfed.targets["host0"] = _host_registry(jregistry, 2, 0.05).prometheus_text
    fed.scrape()
    jfed.scrape()
    _same_merge(fed, jfed)
    assert fed.registry.counter("mho_serve_served_total").total() == 12.0


def test_federation_dead_host_is_data():
    def dead():
        raise OSError("connection refused")

    live_t, live_j = _host_registry(tregistry, 7, 0.05), _host_registry(jregistry, 7, 0.05)
    fed = tmh.FleetFederation({"host0": live_t.prometheus_text, "host1": dead})
    jfed = jmh.FleetFederation({"host0": live_j.prometheus_text, "host1": dead})
    assert fed.scrape() == jfed.scrape() == {"host0": True, "host1": False}
    _same_merge(fed, jfed)
    up = fed.registry.gauge("mho_mesh_host_up")
    assert up.value(host="host0") == 1.0 and up.value(host="host1") == 0.0
    assert fed.registry.counter("mho_mesh_scrape_failures_total").total(host="host1") == 1.0
    assert fed.registry.counter("mho_serve_served_total").total() == 7.0


def test_federated_slo_engine_sees_fleet_series():
    tregs, jregs = _registries({"host0": (7, 0.05), "host1": (5, 0.2)})
    for regs in (tregs, jregs):
        for r in regs.values():
            r.counter("mho_serve_submits_total", "t").inc(7, outcome="admitted")
    fed, jfed = _feds(tregs, jregs)
    fed.scrape()
    jfed.scrape()
    engine = tmh.federated_slo_engine(fed, short_s=1.0, long_s=2.0)
    jengine = jmh.federated_slo_engine(jfed, short_s=1.0, long_s=2.0)
    assert engine.registry is fed.registry
    for now in (0.0, 1.0):
        assert engine.observe(now) == jengine.observe(now) == []
    assert engine.state() == jengine.state()


def test_metrics_endpoint_serves_the_registry_over_loopback():
    """The worker's scrape target: the port's endpoint serves its
    registry's text on 127.0.0.1, and a federation scrapes it by URL."""
    reg = _host_registry(tregistry, 4, 0.5)
    ep = tmh.MetricsEndpoint(registry=reg)
    try:
        assert ep.url.startswith("http://127.0.0.1:") and ep.port > 0
        fed = tmh.FleetFederation({"host0": ep.url}, timeout_s=10.0)
        assert fed.scrape() == {"host0": True}
        assert fed.registry.counter("mho_serve_served_total").total(host="host0") == 4.0
    finally:
        ep.close()


# ---------------------------------------------------------------------------
# SLO engine: the same registry contents and clock, the same burn rates
# ---------------------------------------------------------------------------


def _drive_slo(reg_mod, slo_mod, specs_fn, steps):
    """Feed one registry per package the same per-tick traffic on a manual
    clock; returns (every observe's transitions, every tick's burn rates,
    the final state)."""
    reg = reg_mod.MetricRegistry()
    engine = slo_mod.SLOEngine(specs_fn(slo_mod), registry=reg, short_s=2.0, long_s=6.0)
    fired = []
    engine.on_breach(lambda spec, info: fired.append(spec.name))
    lat = reg.histogram("mho_serve_latency_seconds", "t",
                        buckets=list(reg_mod.LATENCY_BUCKETS))
    trans, burns = [], []
    for now, (n_ok, n_slow, shard, depth, nonfinite, refused) in steps:
        for i in range(n_ok):
            lat.observe(0.01 + 0.001 * i, shard=shard)
        for _ in range(n_slow):
            lat.observe(1.5, shard=shard)
        n = n_ok + n_slow
        reg.counter("mho_serve_submits_total", "t").inc(n + refused, outcome="admitted")
        if refused:
            reg.counter("mho_serve_submits_total", "t").inc(refused, outcome="backpressure")
        reg.counter("mho_serve_served_total", "t").inc(n, served_by="gnn")
        reg.gauge("mho_serve_queue_depth", "t").set(depth)
        if nonfinite:
            reg.counter("mho_dev_serve_nonfinite_total", "t").inc(nonfinite, bucket="0")
        trans.append(engine.observe(now))
        burns.append({s.name: engine.burn_rates(s.name, now) for s in engine.specs})
    return trans, burns, engine.state(), fired


def test_slo_engine_burn_rates_and_alerts_equal_jax():
    """A healthy stretch, a burst of slow answers on shard 1 with a deep
    queue and refused submits, a non-finite output, then recovery: the
    default and per-shard specs fire and resolve at the same ticks with
    the same burn rates in both packages."""
    rng = np.random.default_rng(3)
    steps = []
    for k in range(40):
        bad = 12 <= k < 20
        steps.append((0.5 * k, (int(rng.integers(4, 9)), int(rng.integers(2, 6)) if bad else 0,
                                "1" if bad else str(k % 2), 60.0 if bad else 4.0,
                                1 if k == 25 else 0, 3 if bad else 0)))

    def specs(mod):
        return (mod.default_serving_slos(latency_le=0.25, queue_bound=48.0)
                + mod.sharded_serving_slos(["0", "1"]))

    got = _drive_slo(tregistry, tslo, specs, steps)
    want = _drive_slo(jregistry, jslo, specs, steps)
    assert got == want
    trans, _, state, fired = got
    assert {"serve_p99", "serve_p99_shard1", "serve_queue", "serve_nonfinite"} <= set(fired)
    assert "serve_p99_shard0" not in fired
    assert any(t["state"] == "resolved" for tick in trans for t in tick)
    assert [s.name for s in tslo.sharded_serving_slos(["0", "1"])] == \
        ["serve_p99_shard0", "serve_p99_shard1"]


# ---------------------------------------------------------------------------
# mho-mesh --smoke: two gloo processes on the CPU
# ---------------------------------------------------------------------------


def test_mesh_smoke_two_processes_on_cpu(tmp_path):
    """`mho-mesh --smoke --device cpu`: two worker processes join a gloo
    group, serve across the host boundary with the one-process reference's
    decisions, survive a SIGKILL of one host (forced re-plan, identical
    digests, conservation) and bisect a finite sustained rate.  The record
    is written where `--out` says; the retrace check is marked not
    applicable, never passed."""
    out = tmp_path / "mesh_smoke.json"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "multihop_offload_tpu_torch.cli.mesh", "--smoke",
         "--device", "cpu", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=420)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec["pass"] is True and rec["mode"] == "cpu_two_local_processes"
    checks = rec["checks"]
    na = checks.pop("zero_unexpected_retraces_after_recovery")
    assert na["ok"] is None and "not_applicable" in na
    assert set(checks) == {
        "process_group_formed", "plan_spans_hosts", "multi_process_served",
        "decisions_bit_identical_w1", "conservation_w1", "federated_counters_span_hosts",
        "forced_replan_excludes_victim", "federation_marks_victim_down",
        "decisions_bit_identical_after_takeover", "conservation_after_takeover",
        "open_loop_sustained_finite"}
    assert all(c["ok"] for c in checks.values()), checks
    assert rec["open_loop"]["sustained_rps"] > 0
    assert all(w["devices_used"] >= 1 for w in rec["window_1"].values())
