"""PyTorch port, the offloading-decision service (serve/, cli/serve.py)
against the JAX package's, in float64 on the CPU.

Both services are built from the same traffic pool (the JAX serving tests'
`SIZES = [10, 16]`), take the same request stream on the same injected
clock, and serve with the same weights: the JAX service's fresh-init flax
variables, carried into the port by `params_from_jax`.  Per request `dst`,
`is_local`, `served_by` and `bucket` must be identical and `delay_est`,
`job_total` within 1e-12; the whole `stats.summary()` must be equal.  That
holds for plain ticks, for `ragged=True, overlap=True` (the same ladder
widths and transitions), for deadline degradation, and for backpressure
and too_large admission.  Beside the service: `pack_bucket` in both
layouts, the admission guards' reasons, the networkx-free
`barabasi_albert` and the workload's draws.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multihop_offload_tpu.chaos import faults
from multihop_offload_tpu.cli.serve import build_service as j_build_service
from multihop_offload_tpu.config import Config as JConfig
from multihop_offload_tpu.graphs import generators as jgen
from multihop_offload_tpu.graphs import topology as jtopo
from multihop_offload_tpu.serve import bucketing as jbucket
from multihop_offload_tpu.serve import guards as jguards
from multihop_offload_tpu.serve import workload as jwork
from multihop_offload_tpu_torch.cli import serve as tcli
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.graphs import generators as tgen
from multihop_offload_tpu_torch.graphs import instance as tinst
from multihop_offload_tpu_torch.graphs import topology as ttopo
from multihop_offload_tpu_torch.models import chebconv as tcheb
from multihop_offload_tpu_torch.serve import bucketing as tbucket
from multihop_offload_tpu_torch.serve import guards as tguards
from multihop_offload_tpu_torch.serve import workload as twork
from multihop_offload_tpu_torch.serve.request import OffloadRequest

SIZES = [10, 16]
SEED = 7


def _cfgs(**kw):
    common = dict(seed=SEED, dtype="float64", serve_buckets=2, **kw)
    return (JConfig(model_root="/nonexistent-model-root", **common), Config(**common))


def _services(clock=None, **kw):
    """(JAX service, port service, JAX pool, port pool) on the same pool and
    clock; the port serves the JAX service's weights."""
    jcfg, cfg = _cfgs(**kw)
    jsvc, jpool = j_build_service(jcfg, pool=jwork.case_pool(SIZES, per_size=1, seed=SEED),
                                  clock=clock)
    model = tcheb.make_model(cfg, dtype=torch.float64)
    model.load_state_dict(tcheb.params_from_jax(jax.device_get(jsvc.executor.variables)))
    tsvc, tpool = tcli.build_service(cfg, pool=twork.case_pool(SIZES, per_size=1, seed=SEED),
                                     clock=clock, model=model, device="cpu")
    assert tsvc.buckets.pads == [tinst.PadSpec(p.n, p.l, p.s, p.j) for p in jsvc.buckets.pads]
    return jsvc, tsvc, jpool, tpool


def _streams(jpool, tpool, count, seed):
    return (list(jwork.request_stream(jpool, count, seed=seed)),
            list(twork.request_stream(tpool, count, seed=seed)))


def _compare(jres, tres):
    assert [r.request_id for r in tres] == [r.request_id for r in jres]
    for t, j in zip(tres, jres):
        np.testing.assert_array_equal(t.dst, j.dst)
        np.testing.assert_array_equal(t.is_local, j.is_local)
        assert (t.served_by, t.bucket) == (j.served_by, j.bucket)
        assert t.latency_s == j.latency_s
        np.testing.assert_allclose(t.delay_est, j.delay_est, rtol=1e-12, atol=0)
        np.testing.assert_allclose(t.job_total, j.job_total, rtol=1e-12, atol=0)


def _compare_stats(jsvc, tsvc):
    assert tsvc.stats.summary(wall_s=2.0) == jsvc.stats.summary(wall_s=2.0)
    assert tsvc.executor.dispatch_count == jsvc.executor.dispatch_count


def _clock():
    t = [100.0]
    return t, (lambda: t[0])


def test_plain_ticks_match_jax():
    """7 requests over 2 buckets at 3 slots: 2 ticks, 4 dispatches with a
    partially filled final batch; every admitted request answered once."""
    t, clock = _clock()
    jsvc, tsvc, jpool, tpool = _services(clock, serve_slots=3, serve_queue_cap=16,
                                         serve_deadline_s=60.0)
    jreqs, treqs = _streams(jpool, tpool, 7, seed=11)
    for jr, tr in zip(jreqs, treqs):
        assert jsvc.submit(jr) and tsvc.submit(tr)
    t[0] += 0.25
    jres, tres = jsvc.drain(), tsvc.drain()
    _compare(jres, tres)
    _compare_stats(jsvc, tsvc)
    assert sorted(r.request_id for r in tres) == list(range(7))
    assert tsvc.stats.ticks == 2 and all(r.served_by == "gnn" for r in tres)
    assert tsvc.executor.last_devmetrics is not None


def test_ragged_overlap_matches_jax():
    """The occupancy ladder narrows a cold bucket and widens it on a
    burst; overlapped ticks answer one tick late.  Widths, transitions,
    responses and counts equal the JAX service's."""
    t, clock = _clock()
    jsvc, tsvc, jpool, tpool = _services(clock, serve_slots=4, serve_queue_cap=32,
                                         serve_deadline_s=60.0, serve_ragged=True,
                                         serve_overlap=True)
    jreqs, treqs = _streams(jpool, tpool, 26, seed=13)
    jres, tres = [], []
    at = 0
    for burst in (8, 1, 1, 1, 1, 1, 1, 1, 1, 0, 6, 1):
        for jr, tr in zip(jreqs[at:at + burst], treqs[at:at + burst]):
            assert jsvc.submit(jr) and tsvc.submit(tr)
        at += burst
        t[0] += 0.01
        jres += jsvc.tick()
        tres += tsvc.tick()
    jres += jsvc.drain()
    tres += tsvc.drain()
    _compare(jres, tres)
    _compare_stats(jsvc, tsvc)
    assert tsvc.ladder.transitions == jsvc.ladder.transitions
    assert {w for _, w in tsvc.executor.dispatches_by_width} > {4}
    assert any(new < old for _, old, new in tsvc.ladder.transitions)
    assert any(new > old for _, old, new in tsvc.ladder.transitions)
    assert sorted(r.request_id for r in tres) == list(range(at))


def test_deadline_degrades_to_baseline_like_jax():
    t, clock = _clock()
    jsvc, tsvc, jpool, tpool = _services(clock, serve_slots=2, serve_queue_cap=16,
                                         serve_deadline_s=0.5)
    jreqs, treqs = _streams(jpool, tpool, 3, seed=31)
    for jr, tr in zip(jreqs, treqs):
        assert jsvc.submit(jr) and tsvc.submit(tr)
    t[0] += 10.0  # the service fell behind: oldest wait >> deadline
    jres, tres = jsvc.drain(), tsvc.drain()
    _compare(jres, tres)
    _compare_stats(jsvc, tsvc)
    assert all(r.served_by == "baseline" for r in tres)
    assert tsvc.stats.degraded == 3


def test_backpressure_and_too_large_like_jax():
    t, clock = _clock()
    jsvc, tsvc, jpool, tpool = _services(clock, serve_slots=2, serve_queue_cap=3,
                                         serve_deadline_s=60.0)
    jreqs, treqs = _streams(jpool, tpool, 6, seed=21)
    for jr, tr in zip(jreqs[:3], treqs[:3]):
        assert jsvc.submit(jr) and tsvc.submit(tr)
    assert not jsvc.submit(jreqs[3]) and not tsvc.submit(treqs[3])
    assert tsvc.last_submit_outcome == jsvc.last_submit_outcome == "backpressure"
    jres, tres = jsvc.tick(), tsvc.tick()
    assert jsvc.submit(jreqs[3]) and tsvc.submit(treqs[3])
    jbig = next(iter(jwork.request_stream(jwork.case_pool([40], per_size=1, seed=5), 1)))
    tbig = next(iter(twork.request_stream(twork.case_pool([40], per_size=1, seed=5), 1)))
    assert not jsvc.submit(jbig) and not tsvc.submit(tbig)
    assert tsvc.last_submit_outcome == jsvc.last_submit_outcome == "too_large"
    bad_j = faults.fuzz_request(jreqs[4], "nan_rate")
    assert not jsvc.submit(bad_j) and not tsvc.submit(_port_request(bad_j))
    assert tsvc.last_submit_outcome == "rejected_invalid"
    jres += jsvc.drain()
    tres += tsvc.drain()
    _compare(jres, tres)
    _compare_stats(jsvc, tsvc)
    s = tsvc.stats
    assert (s.rejected, s.too_large, s.invalid, s.served) == (1, 1, 1, 4)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_pack_bucket_fields_equal_jax(layout):
    jpool = jwork.case_pool(SIZES, per_size=1, seed=SEED)
    tpool = twork.case_pool(SIZES, per_size=1, seed=SEED)
    jreqs, treqs = _streams(jpool, tpool, 3, seed=3)
    jb = jwork.buckets_for_pool(jpool)
    pad = jb.pads[-1]
    tpad = tinst.PadSpec(pad.n, pad.l, pad.s, pad.j)
    ji, jj = jbucket.pack_bucket(jreqs, pad, 4, dtype=np.float64, layout=layout)
    ti, tj = tbucket.pack_bucket(treqs, tpad, 4, dtype=torch.float64, layout=layout,
                                 hop_cache={}, device="cpu")
    for f in tinst.Instance.__dataclass_fields__:
        if f != "sparse":
            got, want = getattr(ti, f).numpy(), np.asarray(getattr(ji, f))
            assert got.dtype == want.dtype, f
            np.testing.assert_array_equal(got, want, err_msg=f)
    for f in tinst.JobSet.__dataclass_fields__:
        got, want = getattr(tj, f).numpy(), np.asarray(getattr(jj, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert ti.adj.shape[0] == 4
    np.testing.assert_array_equal(ti.adj[3].numpy(), ti.adj[2].numpy())  # filler
    if layout == "sparse":
        assert tj.src.dtype == torch.int16 and ti.sparse.ext_csr is not None
        for part in ("ext", "cf"):
            for f in ("rows", "cols", "vals"):
                np.testing.assert_array_equal(
                    getattr(getattr(ti.sparse, part), f).numpy(),
                    np.asarray(getattr(getattr(ji.sparse, part), f)))
    else:
        assert ti.sparse is None and ji.sparse is None
    waste = tbucket.padding_waste(treqs, tpad, 4)
    assert waste == jbucket.padding_waste(jreqs, pad, 4)


def _port_request(j):
    """The port's OffloadRequest carrying a JAX request's arrays."""
    return OffloadRequest(
        request_id=j.request_id, topo=ttopo.build_topology(np.asarray(j.topo.adj)),
        roles=j.roles, proc_bws=j.proc_bws, link_rates=j.link_rates,
        job_src=j.job_src, job_rate=j.job_rate, ul=j.ul, dl=j.dl, t_max=j.t_max,
        topo_key=j.topo_key)


def _valid_jax_request(seed, n=12):
    return next(iter(jwork.request_stream(jwork.case_pool([n], per_size=1, seed=seed), 1,
                                          seed=seed + 1)))


@pytest.mark.parametrize("mutation", [m for m, _ in faults.REQUEST_MUTATIONS] + [None])
def test_guards_give_the_jax_reason(mutation):
    """Every malformed request of the JAX guard tests gets the same reason
    and detail from the port's guards, across seeds; valid ones pass."""
    assert tguards.REASONS == jguards.REASONS
    for seed in range(5):
        j = _valid_jax_request(seed)
        if mutation is not None:
            j = faults.fuzz_request(j, mutation, seed=seed)
        want = jguards.validate_request(j)
        got = tguards.validate_request(_port_request(j))
        assert (got is None) == (want is None) == (mutation is None)
        if want is not None:
            assert (got.reason, got.detail) == (want.reason, want.detail)


def test_guards_topology_reasons_like_jax():
    """disconnected (two rings, no bridge) and bad_role (no server)."""
    ring = np.zeros((12, 12), dtype=np.uint8)
    for comp in (list(range(0, 6)), list(range(6, 12))):
        for a, b in zip(comp, comp[1:] + comp[:1]):
            ring[a, b] = ring[b, a] = 1
    roles = np.zeros(12, dtype=np.int32)
    roles[[1, 7]] = 1
    split = dataclasses.replace(
        _valid_jax_request(0), topo=jtopo.build_topology(ring), roles=roles,
        proc_bws=np.full(12, 50.0), link_rates=np.full(12, 10.0),
        job_src=np.array([0, 6], dtype=np.int32), job_rate=np.array([0.2, 0.2]),
        topo_key=None)
    serverless = dataclasses.replace(split, roles=np.zeros(12, dtype=np.int32))
    for j, reason in ((split, "disconnected"), (serverless, "bad_role")):
        got = tguards.validate_request(_port_request(j))
        assert got.reason == jguards.validate_request(j).reason == reason
    with pytest.raises(ValueError):
        tguards.Rejection("bogus_reason", "nope")


@pytest.mark.parametrize("n,m,seed", [(10, 2, 0), (16, 2, 7), (20, 1, 5), (50, 3, 1),
                                      (80, 4, 11), (110, 2, 3), (110, 2, 0), (200, 2, 42)])
def test_barabasi_albert_equals_jax(n, m, seed):
    got, pos = tgen.barabasi_albert(n, m=m, seed=seed)
    want, _ = jgen.barabasi_albert(n, m=m, seed=seed)
    assert pos is None and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_workload_draws_equal_jax():
    sizes = [20, 50, 80, 110]
    jpool = jwork.case_pool(sizes, per_size=2, seed=0)
    tpool = twork.case_pool(sizes, per_size=2, seed=0)
    for jc, tc in zip(jpool, tpool):
        assert (tc.key, tc.sizes, tc.base_rate) == (jc.key, jc.sizes, jc.base_rate)
        for f in ("roles", "proc_bws", "mobile_nodes"):
            np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
        np.testing.assert_array_equal(tc.topo.link_ends, jc.topo.link_ends)
        np.testing.assert_array_equal(tc.topo.adj_conflict, jc.topo.adj_conflict)
    jreqs, treqs = _streams(jpool, tpool, 24, seed=1)
    for j, t in zip(jreqs, treqs):
        assert (t.request_id, t.topo_key, t.sizes) == (j.request_id, j.topo_key, j.sizes)
        for f in ("link_rates", "job_src", "job_rate"):
            got, want = getattr(t, f), getattr(j, f)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    tb, jb = twork.buckets_for_pool(tpool), jwork.buckets_for_pool(jpool)
    assert tb.pads == [tinst.PadSpec(p.n, p.l, p.s, p.j) for p in jb.pads]
    assert [(p.n, p.l) for p in tb.pads] == [(56, 96), (112, 216)]


def test_load_params_checks_signature_and_refuses_nonfinite(tmp_path):
    cfg = Config(seed=SEED, dtype="float64", serve_slots=2)
    svc, pool = tcli.build_service(cfg, pool=twork.case_pool(SIZES, per_size=1, seed=SEED),
                                   device="cpu")
    ex = svc.executor
    state = {k: v.clone() + 0.5 for k, v in ex.model.state_dict().items()}
    assert ex.load_params(state, step=3) == 3 and ex.loaded_step == 3
    assert all(torch.equal(v, state[k]) for k, v in ex.model.state_dict().items())
    bad = dict(state)
    bad["layers.0.bias"] = torch.full_like(bad["layers.0.bias"], float("nan"))
    assert ex.load_params(bad, step=4) is None and ex.loaded_step == 3
    short = {k: v for k, v in state.items() if k != "layers.0.bias"}
    with pytest.raises(ValueError, match="signature"):
        ex.load_params(short)
    # no checkpoint under the model directory: nothing to reload
    # (tests/test_torch_serve_cli.py drives hot_reload from disk)
    assert svc.hot_reload(str(tmp_path)) is None and ex.loaded_step == 3


def test_cli_serves_every_request_on_cpu_and_refuses_unported_options(capsys):
    summary = tcli.main(["--device", "cpu", "--serve_sizes=10,16", "--serve_slots=3",
                         "--serve_requests=9", "--serve_overlap=true",
                         "--serve_model=SCRATCH800_decay0.99"])
    assert summary["served"] == summary["admitted"] == 9
    assert "committed model SCRATCH800_decay0.99" in capsys.readouterr().out
    for bad in (Config(serve_mesh=2), Config(serve_devices="0,1")):
        with pytest.raises(NotImplementedError):
            tcli.build_service(bad, pool=twork.case_pool(SIZES, per_size=1, seed=0),
                               device="cpu")
    # prob=True is served (per-request generators, tests/test_torch_serve_cli.py)
    svc, _ = tcli.build_service(Config(prob=True),
                                pool=twork.case_pool(SIZES, per_size=1, seed=0),
                                device="cpu")
    assert svc.executor.prob
    # the bf16 precision policy is served (`tests/test_torch_precision.py`)
    svc, _ = tcli.build_service(Config(precision="bf16"),
                                pool=twork.case_pool(SIZES, per_size=1, seed=0),
                                device="cpu")
    assert svc.dtype == torch.bfloat16 and svc.precision.mixed
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.build_service(Config(), pool=twork.case_pool(SIZES, per_size=1, seed=0))


def test_watchdog_degrades_a_stuck_bucket_like_jax():
    """Overlapped ticks settle one tick late; a settle 6 s after its
    dispatch is `stuck` (> 10 x 0.5 s): that bucket serves the baseline
    until the 5 s recovery window passes, then the GNN again."""
    from multihop_offload_tpu.serve.watchdog import TickWatchdog as JWatchdog
    from multihop_offload_tpu_torch.serve.watchdog import TickWatchdog

    t, clock = _clock()
    jsvc, tsvc, jpool, tpool = _services(clock, serve_slots=2, serve_queue_cap=16,
                                         serve_deadline_s=60.0, serve_overlap=True)
    jsvc.attach_watchdog(JWatchdog(0.5, recovery_s=5.0))
    tsvc.attach_watchdog(TickWatchdog(0.5, recovery_s=5.0))
    jreqs, treqs = _streams(jpool, tpool, 10, seed=41)
    jres, tres = [], []
    at = 0
    for burst, step in ((2, 0.0), (2, 6.0), (2, 1.0), (2, 6.0), (2, 0.1)):
        for jr, tr in zip(jreqs[at:at + burst], treqs[at:at + burst]):
            assert jsvc.submit(jr) and tsvc.submit(tr)
        at += burst
        t[0] += step
        jres += jsvc.tick()
        tres += tsvc.tick()
    jres += jsvc.drain()
    tres += tsvc.drain()
    _compare(jres, tres)
    _compare_stats(jsvc, tsvc)
    assert (tsvc.watchdog.stuck, tsvc.watchdog.slow) == (jsvc.watchdog.stuck,
                                                         jsvc.watchdog.slow)
    assert tsvc.watchdog.stuck > 0
    assert {r.served_by for r in tres} == {"gnn", "baseline"}


def test_trace_hops_and_spans_in_the_run_log(tmp_path):
    """With a run log installed, each request's hops read back in order
    (submit, pack, dispatch, decision), tick rows count every answer, and
    the tick and pack spans aggregate in the registry."""
    from multihop_offload_tpu_torch.obs import events, spans, trace

    spans.reset_phases()
    path = str(tmp_path / "run.jsonl")
    log = events.RunLog(path, manifest=events.run_manifest(role="serve"))
    events.set_run_log(log)
    try:
        cfg = Config(seed=SEED, dtype="float64", serve_slots=2)
        svc, pool = tcli.build_service(
            cfg, pool=twork.case_pool(SIZES, per_size=1, seed=SEED), device="cpu")
        for r in twork.request_stream(pool, 3, seed=2):
            assert svc.submit(r)
        svc.drain()
    finally:
        events.set_run_log(None)
        log.close()
    for rid in range(3):
        hops = trace.reconstruct(path, rid)
        assert [h["hop"] for h in hops] == ["submit", "pack", "dispatch", "decision"]
        assert hops[-1]["served_by"] == "gnn"
    rows = list(events.read_events(path))
    assert rows[0]["event"] == "manifest" and rows[0]["platform"] in ("cpu", "gpu")
    assert sum(r["served"] for r in rows if r["event"] == "tick") == 3
    phases = spans.phase_stats()
    assert phases["serve/tick"]["count"] == svc.stats.ticks
    assert phases["serve/pack"]["count"] == svc.stats.dispatches
