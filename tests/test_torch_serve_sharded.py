"""PyTorch port, sharded serving (`serve/sharded.py`, `serve/placement.py`
wired into `serve/service.py`, `cli/serve.py`'s `serve_mesh`) against the
JAX package's sharded service, in float64 on the CPU.

The counterparts of `tests/test_serve_sharded.py`'s tests (not the
retrace one: a JAX compile property).  The port serves on `[cpu] * k`, JAX
on its virtual CPU devices (`tests/conftest.py`), with the same pool,
stream, clock and weights (the JAX service's fresh-init variables, carried
into the port by `params_from_jax`).  Decisions (`dst`, `is_local`,
`served_by`, bucket, shard) equal JAX's sharded service's and the port's
one-device service's bit for bit; the floats equal the one-device port's
bit for bit (each slot's work does not depend on the batch around it) and
JAX's within 1e-12.  Beside those: a fleet of two distinct replica objects
(`cpu` and `cpu:0`) refreshed by `load_params`, sampled decisions
(`prob=True`) under sharding, the SLO engine and flight recorder wired by
`attach_health`, and the `serve_mesh` / `serve_devices` resolution.
"""

import time

import jax
import numpy as np
import pytest
import torch

from multihop_offload_tpu.cli.serve import build_service as j_build_service
from multihop_offload_tpu.config import Config as JConfig
from multihop_offload_tpu.serve import workload as jwork
from multihop_offload_tpu_torch.cli import serve as tcli
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.models import chebconv as tcheb
from multihop_offload_tpu_torch.serve import workload as twork
from multihop_offload_tpu_torch.serve.placement import PlacementPlan
from tests.test_torch_ops import clear_jax_caches_after_module  # noqa: F401

SEED = 7


def _cfgs(mesh, slots, buckets, sizes, **kw):
    common = dict(seed=SEED, dtype="float64", serve_sizes=sizes, serve_buckets=buckets,
                  serve_slots=slots, serve_mesh=mesh, serve_deadline_s=600.0,
                  serve_queue_cap=256, **kw)
    return JConfig(model_root="/nonexistent-model-root", **common), Config(**common)


def _pools(sizes):
    ns = [int(s) for s in sizes.split(",")]
    return (jwork.case_pool(ns, per_size=1, seed=SEED),
            twork.case_pool(ns, per_size=1, seed=SEED))


def _jax_service(mesh=0, slots=4, buckets=1, sizes="10", clock=None, **kw):
    jcfg, _ = _cfgs(mesh, slots, buckets, sizes, **kw)
    return j_build_service(jcfg, pool=_pools(sizes)[0], clock=clock)[0]


def _port_service(jsvc, mesh=0, slots=4, buckets=1, sizes="10", clock=None,
                  devices=None, **kw):
    """The port's service with the JAX service's weights: `[cpu] * mesh`
    through `serve_mesh` (0: one device), or the fleet `devices`."""
    _, cfg = _cfgs(mesh, slots, buckets, sizes, **kw)
    model = tcheb.make_model(cfg, dtype=torch.float64)
    model.load_state_dict(tcheb.params_from_jax(jax.device_get(jsvc.executor.variables)))
    svc, pool = tcli.build_service(cfg, pool=_pools(sizes)[1], clock=clock, model=model,
                                   device="cpu", devices=devices)
    return svc, pool


def _serve(service, pool, count, seed=11, id_offset=0, stream=None):
    """Closed loop until drained; responses keyed by request id."""
    pending = list((stream or twork).request_stream(pool, count, seed=seed,
                                                    id_offset=id_offset))
    pending.reverse()
    out = {}
    while pending or service.queue_depth:
        while pending:
            req = pending.pop()
            if not service.submit(req):
                pending.append(req)
                break
        for r in service.tick():
            out[r.request_id] = r
    return out


def _jserve(jsvc, count, sizes, seed=11, id_offset=0):
    return _serve(jsvc, _pools(sizes)[0], count, seed=seed, id_offset=id_offset,
                  stream=jwork)


def _same(a, b, exact_floats: bool) -> None:
    np.testing.assert_array_equal(a.dst, b.dst)
    np.testing.assert_array_equal(a.is_local, b.is_local)
    assert (a.served_by, a.bucket) == (b.served_by, b.bucket)
    for x, y in ((a.delay_est, b.delay_est), (a.job_total, b.job_total)):
        if exact_floats:
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=0)


def _clock():
    t = [100.0]
    return t, (lambda: t[0])


# ---- bit parity ----------------------------------------------------------


def test_sharded_decisions_bit_identical_to_unsharded():
    """The port on `[cpu] * 4` against its one-device service (bit for
    bit) and against JAX's sharded service on four virtual devices (the
    same plan, decisions and shards; floats within 1e-12)."""
    t, clock = _clock()
    jsh = _jax_service(mesh=4, buckets=2, sizes="10,16", clock=clock)
    plain, pool = _port_service(jsh, mesh=0, buckets=2, sizes="10,16", clock=clock)
    sharded, _ = _port_service(jsh, mesh=4, buckets=2, sizes="10,16", clock=clock)
    assert sharded.executor.fleet == [torch.device("cpu")] * 4
    assert sharded.planner.plan.describe() == jsh.planner.plan.describe()
    got_plain = _serve(plain, pool, 12)
    got_sharded = _serve(sharded, pool, 12)
    got_jax = _jserve(jsh, 12, "10,16")
    assert set(got_plain) == set(got_sharded) == set(got_jax) and len(got_plain) == 12
    for rid in got_plain:
        a, b, j = got_plain[rid], got_sharded[rid], got_jax[rid]
        assert a.served_by == b.served_by == "gnn"
        _same(b, a, exact_floats=True)
        _same(b, j, exact_floats=False)
        assert b.shard == j.shard != "" and a.shard == ""
    assert sharded.executor.dispatch_count == jsh.executor.dispatch_count


def test_sharded_dispatch_spans_multiple_devices():
    t, clock = _clock()
    jsh = _jax_service(mesh=4, clock=clock)
    service, pool = _port_service(jsh, mesh=4, clock=clock)
    got = _serve(service, pool, 8)
    want = _jserve(jsh, 8, "10")
    assert len(got) == 8
    assert service.executor.last_devices_used == jsh.executor.last_devices_used == 4
    assert len({r.shard for r in got.values()}) > 1
    assert all(r.shard != "" for r in got.values())
    assert {r.shard for r in got.values()} == {r.shard for r in want.values()}
    m, jm = service.executor.last_metrics, jsh.executor.last_metrics
    assert m is not None and set(m) == {"job_total_sum", "delay_est_max"} == set(jm)
    for k in m:
        assert m[k] == pytest.approx(jm[k], rel=1e-12)
    # the decision counters reduced on the placement's first device equal
    # JAX's allreduce of the same dispatch
    dm, jdm = service.executor.last_devmetrics, jsh.executor.last_devmetrics
    assert dm == {k: int(jdm[k]) for k in dm} and sum(dm.values()) > 0
    assert service.executor.placement_host_s and all(
        v > 0 for v in service.executor.placement_host_s.values())


def test_summary_gains_buckets_and_shards_blocks():
    t, clock = _clock()
    jsh = _jax_service(mesh=4, buckets=2, sizes="10,16", clock=clock)
    service, pool = _port_service(jsh, mesh=4, buckets=2, sizes="10,16", clock=clock)
    for svc, serve in ((service, lambda: _serve(service, pool, 12)),
                       (jsh, lambda: _jserve(jsh, 12, "10,16"))):
        t[0] = 100.0
        serve()
    s = service.stats.summary(wall_s=1.0)
    assert s == jsh.stats.summary(wall_s=1.0)
    assert set(s["buckets"]) == {"0", "1"}
    for entry in s["buckets"].values():
        assert entry["offered"] >= entry["served"] > 0
        assert "offered_per_sec" in entry and "served_per_sec" in entry
    assert len(s["shards"]) > 1
    assert sum(e["served"] for e in s["shards"].values()) == s["served"]


def test_unsharded_summary_stays_backward_compatible():
    t, clock = _clock()
    jsvc = _jax_service(mesh=0, clock=clock)
    service, pool = _port_service(jsvc, mesh=0, clock=clock)
    _serve(service, pool, 6)
    _jserve(jsvc, 6, "10")
    s = service.stats.summary(wall_s=1.0)
    assert s == jsvc.stats.summary(wall_s=1.0)
    assert "shards" not in s
    assert s["buckets"]["0"]["offered"] == 6


# ---- per-shard health ----------------------------------------------------


def _stall_bucket0(executor, t, stall):
    orig = executor.run

    def stalling_run(bucket, *a, **kw):
        if bucket == 0:
            t[0] += stall["s"]
        return orig(bucket, *a, **kw)

    executor.run = stalling_run
    return orig


def test_stuck_device_degrades_only_co_placed_buckets():
    """A stall on bucket 0's devices degrades bucket 0 to the baseline for
    the recovery window while bucket 1, on other devices, keeps the GNN;
    recovery restores bucket 0.  Every response equals JAX's under the
    same stalls and clock, and the stuck counters carry `device=` labels."""
    from multihop_offload_tpu.serve.watchdog import TickWatchdog as JWatchdog
    from multihop_offload_tpu_torch.obs.registry import registry
    from multihop_offload_tpu_torch.serve.watchdog import TickWatchdog

    got = {}
    for side in ("jax", "port"):
        t, clock = _clock()
        jsh = _jax_service(mesh=4, buckets=2, sizes="10,16", clock=clock)
        if side == "jax":
            svc, serve = jsh, (lambda n, off, s=jsh: _jserve(s, n, "10,16", id_offset=off))
            wd = JWatchdog(threshold_s=0.5, recovery_s=30.0, stuck_factor=10.0,
                           clock=clock)
        else:
            svc, pool = _port_service(jsh, mesh=4, buckets=2, sizes="10,16", clock=clock)
            serve = (lambda n, off, s=svc, p=pool: _serve(s, p, n, id_offset=off))
            wd = TickWatchdog(threshold_s=0.5, recovery_s=30.0, stuck_factor=10.0,
                              clock=clock)
        svc.attach_watchdog(wd)
        d0, d1 = set(svc.executor.devices_for(0)), set(svc.executor.devices_for(1))
        assert d0 and d1 and not (d0 & d1), "the test needs disjoint placements"
        stall = {"s": 6.0}                    # stuck: 6.0 > 0.5 * 10
        orig = _stall_bucket0(svc.executor, t, stall)
        try:
            runs = [serve(8, 1_000)]
            assert wd.stuck >= 1
            stall["s"] = 0.0                  # wedge cleared, window open
            runs.append(serve(8, 2_000))
            t[0] += 31.0                      # recovery window expires
            runs.append(serve(8, 3_000))
        finally:
            svc.executor.run = orig
        got[side] = runs
        by_bucket = {}
        for r in runs[1].values():
            by_bucket.setdefault(r.bucket, set()).add(r.served_by)
        assert by_bucket[0] == {"baseline"}, "stuck devices must degrade"
        assert by_bucket[1] == {"gnn"}, "a bucket on healthy devices must not degrade"
        assert {r.served_by for r in runs[2].values()} == {"gnn"}
    for want, have in zip(got["jax"], got["port"]):
        assert set(want) == set(have)
        for rid in want:
            _same(have[rid], want[rid], exact_floats=False)
            assert have[rid].latency_s == want[rid].latency_s
    stuck = registry().counter("mho_watchdog_stuck_total")
    assert any("device" in dict(k) for k in stuck._series)


# ---- device loss ---------------------------------------------------------


def test_device_loss_replaces_and_conserves():
    """Device loss between windows: the planner re-places every bucket onto
    the survivors (JAX's plan), the same request ids re-serve with the same
    decisions, and admitted == served throughout."""
    t, clock = _clock()
    jsh = _jax_service(mesh=4, buckets=2, sizes="10,16", clock=clock)
    service, pool = _port_service(jsh, mesh=4, buckets=2, sizes="10,16", clock=clock)
    golden = _serve(service, pool, 12, id_offset=5_000)
    jgolden = _jserve(jsh, 12, "10,16", id_offset=5_000)
    victim = service.executor.devices_for(0)[-1]
    jvictim = jsh.executor.devices_for(0)[-1]
    assert jvictim.id == victim
    service.lose_device(victim)
    jsh.lose_device(jvictim)
    assert service.planner.plan.describe() == jsh.planner.plan.describe()
    assert not service.planner.plan.uses(victim)
    assert all(devs for devs in service.planner.plan.assignments)
    again = _serve(service, pool, 12, id_offset=5_000)
    jagain = _jserve(jsh, 12, "10,16", id_offset=5_000)
    assert set(again) == set(golden) == set(jagain)
    for rid in golden:
        _same(again[rid], golden[rid], exact_floats=True)
        _same(again[rid], jagain[rid], exact_floats=False)
        _same(golden[rid], jgolden[rid], exact_floats=False)
        assert again[rid].shard == jagain[rid].shard
    assert service.stats.admitted == service.stats.served
    assert service.queue_depth == 0
    service.restore_device(victim)
    jsh.restore_device(jvictim)
    assert victim in service.planner.devices
    assert service.planner.plan.describe() == jsh.planner.plan.describe()
    with pytest.raises(RuntimeError, match="sharded service"):
        _port_service(jsh, mesh=0)[0].lose_device(0)


# ---- weights -------------------------------------------------------------


def test_hot_reload_survives_sharding():
    """New weights swapped in through `load_params` (the path `hot_reload`
    takes) reach every shard: the sharded service then decides what JAX's
    sharded service decides with the same scaled variables."""
    t, clock = _clock()
    jsh = _jax_service(mesh=4, clock=clock)
    service, pool = _port_service(jsh, mesh=4, clock=clock)
    _serve(service, pool, 4, id_offset=8_000)
    _jserve(jsh, 4, "10", id_offset=8_000)
    jsh.executor.variables = jax.tree_util.tree_map(
        lambda x: np.asarray(x) * 1.01, jsh.executor.variables)
    state = tcheb.params_from_jax(jax.device_get(jsh.executor.variables))
    assert service.executor.load_params(state, step=1) == 1
    got = _serve(service, pool, 4, id_offset=8_100)
    want = _jserve(jsh, 4, "10", id_offset=8_100)
    assert len(got) == 4
    for rid in want:
        _same(got[rid], want[rid], exact_floats=False)


def test_distinct_replicas_refresh_after_load_params():
    """A fleet of two distinct replica objects on one memory (`cpu` and
    `cpu:0`): the second device serves a copy of the model, refreshed when
    the weights change, so both shards decide with the new weights, as a
    one-device service given them does."""
    t, clock = _clock()
    jsvc = _jax_service(mesh=0, clock=clock)
    fleet = [torch.device("cpu"), torch.device("cpu", 0)]
    service, pool = _port_service(jsvc, slots=4, clock=clock, devices=fleet)
    one, _ = _port_service(jsvc, slots=4, clock=clock)
    ex = service.executor
    assert ex.fleet == fleet and ex.fleet[0] != ex.fleet[1]
    ex.set_placement(PlacementPlan(((0, 1),)))
    first = _serve(service, pool, 8, id_offset=9_000)
    assert {r.shard for r in first.values()} == {"0", "1"}
    copy_ = ex.replica(fleet[1])
    assert copy_ is not ex.model and copy_ is ex.replica(fleet[1])
    state = {k: v * 1.05 + 0.01 for k, v in ex.model.state_dict().items()}
    assert not any(torch.equal(a, state[k]) for k, a in copy_.state_dict().items())
    for svc in (service, one):
        assert svc.executor.load_params(state, step=2) == 2
    got = _serve(service, pool, 8, id_offset=9_100)
    want = _serve(one, pool, 8, id_offset=9_100)
    assert {r.shard for r in got.values()} == {"0", "1"}
    for rid in want:
        _same(got[rid], want[rid], exact_floats=True)
    # the copy on `cpu:0` was refreshed to the new weights
    assert all(torch.equal(a, state[k]) for k, a in copy_.state_dict().items())


def test_sampled_decisions_do_not_depend_on_the_shard():
    """`prob=True`: each request samples from its own generator, made on
    its shard's device, so the sharded service decides what the one-device
    service decides, bit for bit."""
    t, clock = _clock()
    jsvc = _jax_service(mesh=0, buckets=2, sizes="10,16", clock=clock)
    plain, pool = _port_service(jsvc, buckets=2, sizes="10,16", clock=clock, prob=True)
    sharded, _ = _port_service(jsvc, mesh=4, buckets=2, sizes="10,16", clock=clock,
                               prob=True)
    assert sharded.executor.prob
    a, b = _serve(plain, pool, 12, id_offset=300), _serve(sharded, pool, 12, id_offset=300)
    for rid in a:
        _same(b[rid], a[rid], exact_floats=True)


# ---- invalid plans and fleets --------------------------------------------


def test_set_placement_rejects_non_dividing_counts():
    t, clock = _clock()
    jsh = _jax_service(mesh=4, clock=clock)
    service, _ = _port_service(jsh, mesh=4, clock=clock)
    devs = service.planner.devices
    for ex, plan in ((service.executor, devs), (jsh.executor, jsh.planner.devices)):
        with pytest.raises(ValueError, match="do not divide"):
            ex.set_placement(PlacementPlan((tuple(plan[:3]),)))
        with pytest.raises(ValueError, match="plan covers 0 buckets"):
            ex.set_placement(PlacementPlan(()))
    with pytest.raises(ValueError, match="fleet indices"):
        service.executor.set_placement(PlacementPlan(((3, 4),)))


def test_serve_mesh_and_serve_devices_resolve():
    """`serve_mesh = N` with the CPU asked for is `[cpu] * N`; CUDA ids or a
    mesh wider than the local cards raise JAX's "not present" error rather
    than fall back to the CPU."""
    assert tcli.resolve_serve_devices(Config(serve_mesh=3), "cpu") == [torch.device("cpu")] * 3
    assert tcli.resolve_serve_devices(Config(serve_mesh=1), "cpu") is None
    assert tcli.resolve_serve_devices(Config(), "cpu") is None
    with pytest.raises(ValueError, match="must be int ids"):
        tcli.resolve_serve_devices(Config(serve_devices="a,b"), "cpu")
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="not present"):
        tcli.resolve_serve_devices(Config(serve_devices=f"0,{n}"))
    with pytest.raises(ValueError, match="CUDA devices present"):
        tcli.resolve_serve_devices(Config(serve_mesh=n + 2))


# ---- health wiring -------------------------------------------------------


def test_attach_health_observes_slo_and_records_every_tick():
    """`attach_health`: the SLO engine is observed once per tick on the
    service clock and the flight recorder gets one `tick` row per tick,
    with the JAX service's rows, burn rates and alert states."""
    from multihop_offload_tpu.obs import flightrec as jfr
    from multihop_offload_tpu.obs import slo as jslo
    from multihop_offload_tpu_torch.obs import flightrec as tfr
    from multihop_offload_tpu_torch.obs import slo as tslo

    t, clock = _clock()
    jsh = _jax_service(mesh=4, buckets=2, sizes="10,16", clock=clock)
    service, pool = _port_service(jsh, mesh=4, buckets=2, sizes="10,16", clock=clock)
    out = []
    for svc, fr, slo, serve in (
            (service, tfr, tslo, lambda: _serve(service, pool, 10, id_offset=400)),
            (jsh, jfr, jslo, lambda: _jserve(jsh, 10, "10,16", id_offset=400))):
        t[0] = 100.0
        rec = fr.FlightRecorder(capacity=64, clock=clock)
        engine = slo.SLOEngine(slo.default_serving_slos(latency_le=0.25)
                               + slo.sharded_serving_slos(["0", "1", "2", "3"]),
                               short_s=1.0, long_s=2.0)
        svc.attach_health(slo=engine, recorder=rec)
        serve()
        rows = rec.records()
        assert [r["tick"] for r in rows] == list(range(1, svc.stats.ticks + 1))
        out.append((rows, {k: (v["state"], v["burn_short"], v["burn_long"])
                           for k, v in engine.state().items()}))
    assert out[0] == out[1]


# ---- the 8x soak ---------------------------------------------------------


@pytest.mark.slow
def test_soak_8x_load_p99_within_budget():
    """8 shards on `[cpu] * 8` at 8x the one-device per-tick load (32 slots
    against 4): the sharded tick's p99 wall time stays within 1.5x of what
    one device needs for the same 8x window (8 sequential ticks at its
    p50).  The shards share the host's cores, so this bounds the sharded
    path's overhead, not scaling."""
    jsvc = _jax_service(mesh=0, slots=4)
    single, pool = _port_service(jsvc, mesh=0, slots=4)
    _serve(single, pool, 16, id_offset=9_000)
    sharded, _ = _port_service(jsvc, mesh=8, slots=32)
    _serve(sharded, pool, 64, id_offset=9_100)
    walls = {}
    for name, svc, n in (("single", single, 4), ("sharded", sharded, 32)):
        walls[name] = []
        for i in range(12):
            for r in twork.request_stream(pool, n, seed=21 + i,
                                          id_offset=10_000 * (n // 4) + 100 * i):
                assert svc.submit(r)
            t0 = time.perf_counter()
            while svc.queue_depth:
                svc.tick()
            walls[name].append(time.perf_counter() - t0)
    budget = 1.5 * 8 * float(np.percentile(walls["single"], 50))
    assert sharded.executor.last_devices_used == 8
    assert float(np.percentile(walls["sharded"], 99)) <= budget
