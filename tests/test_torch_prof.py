"""PyTorch port of the prof layer (`obs/prof.py`, `obs/memwatch.py`,
`cli/prof.py`) against the JAX package on the CPU.

JAX's pure functions must give the same numbers: `scan_corrected_flops`,
the kernels' cost facts (`chebconv_cost_facts`, `chebconv_ragged_cost_facts`,
`coo_apsp_cost_facts`, at fp32 and bf16 widths), the registry's records,
counters and gauges under the same fake peaks and the same register /
account sequence (the port keeps the gauge unrounded: JAX's value is its
rounding to 6 decimals), the snapshot, `BreachCapture`'s once-per-breach
and cooldown behaviour, memwatch's watermarks under an injected
`stats_fn`, and the report's performance section of a port run log.  The
port's own count of a program's work (`extract_cost`) is held to an
independent reckoning of the dense `forward_backward` at N = 24, a
kernel's count to its analytic facts (its plain version's ops uncounted),
and a wrapped program's launches to the bare program's (`count_plain`).
"""

import os

import numpy as np
import pytest
import torch

from multihop_offload_tpu.obs.memwatch import MemWatch as JMemWatch
from multihop_offload_tpu.obs import prof as j_prof
from multihop_offload_tpu.obs.registry import MetricRegistry as JMetricRegistry
from multihop_offload_tpu.obs import report as j_report
from multihop_offload_tpu.obs import slo as j_slo
from multihop_offload_tpu.ops import chebconv as j_cheb
from multihop_offload_tpu.ops import minplus as j_minplus
from multihop_offload_tpu_torch import obs
from multihop_offload_tpu_torch.cli import prof as prof_cli
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.obs.registry import MetricRegistry
from multihop_offload_tpu_torch.obs import memwatch, prof, report, slo
from multihop_offload_tpu_torch.ops import chebconv as cc
from multihop_offload_tpu_torch.ops import fixed_point as fp
from multihop_offload_tpu_torch.ops import minplus as mp

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def fake_peaks(monkeypatch):
    """JAX's smoke peaks in the environment for one test; the default
    registry re-resolves its peaks before and after."""
    monkeypatch.setenv("MHO_PROF_PEAK_TFLOPS", "1.0")
    monkeypatch.setenv("MHO_PROF_PEAK_HBM_GBPS", "10.0")
    prof.prof_registry().reset_peaks()
    yield
    monkeypatch.undo()
    prof.prof_registry().reset_peaks()


def _series(reg, name: str) -> dict:
    return (reg.snapshot().get(name) or {}).get("series") or {}


# ---- the pure functions -----------------------------------------------------


@pytest.mark.parametrize("pad_n,pad_l,batch,fp_path", [
    (112, 216, 64, "xla"), (112, 216, 64, "pallas"), (24, 40, 2, "xla"),
    (256, 496, 4, "pallas"), (1024, 7694, 1, "xla"), (2, 1, 1, "xla")])
def test_scan_corrected_flops_equals_jax(pad_n, pad_l, batch, fp_path):
    for ca in (0.0, 1.5e9):
        assert prof.scan_corrected_flops(ca, pad_n, pad_l, batch, fp_path=fp_path) == \
            j_prof.scan_corrected_flops(ca, pad_n, pad_l, batch, fp_path=fp_path)
    # the port's own terms are the correction's, summed as the port counts them
    full = prof.scan_corrected_flops(0.0, pad_n, pad_l, batch, fp_path="pallas")
    assert full == pytest.approx(
        prof.apsp_flops(batch, pad_n, mp.squaring_count(pad_n))
        - 2.0 * batch * pad_n ** 3 + 5 * prof.fixed_point_flops(batch, pad_l, 10),
        rel=1e-15)


@pytest.mark.parametrize("dtype_bytes", [4, 2])
@pytest.mark.parametrize("n,nnz,feat", [(328, 4096, 32), (328, 4096, 4), (64, 512, 1),
                                        (1097, 16000, 32)])
def test_chebconv_cost_facts_equal_jax(n, nnz, feat, dtype_bytes):
    assert cc.chebconv_cost_facts(n, nnz, feat, dtype_bytes) == \
        j_cheb.chebconv_cost_facts(n, nnz, feat, dtype_bytes)
    for live in (0, 1, 511, 512, 513, nnz):
        assert cc.chebconv_ragged_cost_facts(n, live, nnz, feat, dtype_bytes) == \
            j_cheb.chebconv_ragged_cost_facts(n, live, nnz, feat, dtype_bytes)


@pytest.mark.parametrize("dtype_bytes", [4, 2])
@pytest.mark.parametrize("n,l", [(112, 216), (24, 40), (256, 752), (1024, 7694)])
def test_coo_apsp_cost_facts_equal_jax(n, l, dtype_bytes):
    iters = mp.squaring_count(n)
    assert mp.coo_apsp_cost_facts(n, l, iters, dtype_bytes) == \
        j_minplus.coo_apsp_cost_facts(n, l, iters, dtype_bytes)


def test_peak_table_and_env_override(monkeypatch):
    assert prof.peak_tflops(H100) == 989.0 and prof.peak_hbm_gbps(H100) == 3350.0
    assert prof.peak_tflops("NVIDIA H100 PCIe") == 756.0
    assert prof.peak_hbm_gbps("NVIDIA H100 NVL") == 3900.0
    assert prof.peak_tflops("") is None and prof.peak_hbm_gbps("cpu") is None
    monkeypatch.setenv("MHO_PROF_PEAK_TFLOPS", "123.5")
    assert prof.peak_tflops("weird accelerator") == 123.5
    monkeypatch.setenv("MHO_PROF_PEAK_TFLOPS", "not-a-number")
    assert prof.peak_tflops(H100) == 989.0
    assert "h100" in prof_cli.render_peaks()


# ---- the registry against JAX's ---------------------------------------------


def _sequence(p) -> None:
    """One register / account sequence: a re-register, labelled series,
    an unregistered name, a zero window, a program with no flops."""
    p.register("g", flops=2e11, bytes_accessed=4e9, compile_s=1.25, temp_bytes=7.0)
    p.account("g", 4.0, calls=10)
    p.account("g", 0.3, calls=1)
    p.register("g", flops=3e11, bytes_accessed=2e9, compile_s=0.5)
    p.account("g", 1.7, calls=3)
    p.register("s", flops=123.0, bytes_accessed=61.0, argument_bytes=8.0,
               labels={"shard": "2", "devices": "0,1"},
               correction=lambda f: f * 3 + 1)
    p.account("s", 0.0123, calls=2, labels={"shard": "2", "devices": "0,1"})
    p.account("unregistered", 0.5, calls=5)
    p.register("noflops", bytes_accessed=1e6)
    p.account("noflops", 0.25)
    p.account("zero", 0.0)


def test_registry_equals_jax_under_the_same_fake_peaks():
    jreg, treg = JMetricRegistry(), MetricRegistry()
    jp = j_prof.ProgramRegistry(jreg, peak_tflops_=1.0, peak_hbm_gbps_=10.0)
    tp = prof.ProgramRegistry(treg, peak_tflops_=1.0, peak_hbm_gbps_=10.0)
    _sequence(jp)
    _sequence(tp)
    # the snapshot (every record's facts and usage) round trips equal
    assert tp.snapshot() == jp.snapshot()
    assert tp.names() == jp.names()
    for name in ("mho_program_calls_total", "mho_program_device_seconds_total",
                 "mho_program_flops_total", "mho_program_bytes_total",
                 "mho_program_compile_seconds", "mho_program_arithmetic_intensity",
                 "mho_program_temp_bytes"):
        assert _series(treg, name) == _series(jreg, name), name
    # the gauges: the port keeps the rate, JAX its 6-decimal rounding
    for name in ("mho_program_mfu", "mho_program_hbm_frac"):
        got, want = _series(treg, name), _series(jreg, name)
        assert set(got) == set(want) and want, name
        for key, v in got.items():
            assert round(v, 6) == want[key], (name, key)
    g = tp.get("g")
    assert g.compiles == 2 and g.calls == 14
    assert _series(treg, "mho_program_mfu")['{program="g"}'] == pytest.approx(
        3e11 * 14 / 6.0 / 1e12)


def test_no_gauges_without_peaks_and_snapshot_keys():
    treg = MetricRegistry()
    tp = prof.ProgramRegistry(treg)
    tp._peaks_resolved = True          # no device kind: no peaks
    tp.register("q", flops=1e9, bytes_accessed=1e6)
    tp.account("q", 1.0)
    assert not _series(treg, "mho_program_mfu")
    snap = tp.snapshot()["q"]
    assert set(snap) == set(j_prof.ProgramRecord("q").to_json())


def test_breach_capture_once_per_breach_and_cooldown_equal_jax(tmp_path):
    """Both packages' engines and captures, driven alike, trace the same
    bundles: one per ok -> firing transition, none while firing, one more
    after resolve and re-breach; an unwatched SLO is ignored and a
    cooldown holds."""
    out = {}
    for tag, regcls, slomod, profmod in (("jax", JMetricRegistry, j_slo, j_prof),
                                        ("port", MetricRegistry, slo, prof)):
        reg = regcls()
        engine = slomod.SLOEngine(slomod.default_serving_slos(latency_le=0.1),
                                  registry=reg, short_s=2.0, long_s=8.0)
        now = [0.0]
        traced = []
        cap = profmod.BreachCapture(
            str(tmp_path), slos=("serve_p99",), clock=lambda: now[0],
            tracer=lambda path, dur, fn, _t=traced: _t.append(path) or path)
        engine.on_breach(cap.on_breach)
        lat = reg.histogram("mho_serve_latency_seconds", "latency")
        counts = []
        for value, ticks in ((0.5, 12), (0.5, 6), (0.01, 30), (0.5, 12)):
            for _ in range(ticks):
                lat.observe(value)
                now[0] += 1.0
                engine.observe(now[0])
            counts.append(len(traced))
        cool = profmod.BreachCapture(
            str(tmp_path), slos=("serve_mfu",), clock=lambda: now[0], min_interval_s=10.0,
            tracer=lambda path, dur, fn: path)

        class Spec:
            name = "serve_p99"

        seq = [cool.on_breach(Spec(), {})]
        Spec.name = "serve_mfu"
        seq.append(cool.on_breach(Spec(), {}))
        now[0] += 5.0
        seq.append(cool.on_breach(Spec(), {}))
        now[0] += 15.0
        seq.append(cool.on_breach(Spec(), {}))
        out[tag] = (counts, traced, cap.captures, seq)
    assert out["port"] == out["jax"]
    assert out["port"][0] == [1, 1, 1, 2]


def test_capture_trace_never_raises_on_bad_dir():
    assert prof.capture_trace("/proc/definitely/not/writable") == ""


def test_memwatch_watermarks_equal_jax():
    stats = {"cuda:0": {"bytes_in_use": 10, "peak_bytes_in_use": 100}}
    jreg, treg = JMetricRegistry(), MetricRegistry()
    jm = JMemWatch(jreg, stats_fn=lambda: stats)
    tm = memwatch.MemWatch(treg, stats_fn=lambda: stats)
    steps = [("warm", {}), ("later", {"peak_bytes_in_use": 50}),
             ("grow", {"peak_bytes_in_use": 300, "largest_alloc_size": 64}),
             ("", {"bytes_in_use": 5})]
    for phase, change in steps:
        stats["cuda:0"].update(change)
        assert tm.snapshot(phase) == jm.snapshot(phase)
    assert tm.watermarks() == jm.watermarks() == {"cuda:0": 300}
    assert _series(treg, "mho_device_mem_bytes") == _series(jreg, "mho_device_mem_bytes")
    broken = memwatch.MemWatch(treg, stats_fn=lambda: (_ for _ in ()).throw(
        RuntimeError("wedged driver")))
    assert broken.snapshot("x") == {}
    # the CPU reports nothing, as JAX's best-effort read on such a backend
    assert memwatch.MemWatch(MetricRegistry()).snapshot("cpu") == {}


def _section(text: str) -> list:
    lines = text.splitlines() + [""]
    i = lines.index("performance (per program)")
    return lines[i:lines.index("", i)]


def test_report_performance_section_from_a_port_run_log(tmp_path, fake_peaks):
    """A port run (start_run, a wrapped program counted and accounted,
    finish_run) writes `program` events and the summary's `programs=`;
    the port's report renders its performance section as JAX's report
    renders the same log."""
    cfg = Config(obs_log=str(tmp_path / "run.jsonl"))
    log = obs.start_run(cfg, role="prof")
    a = torch.rand(3, 8, 8, dtype=torch.float64)
    prog = prof.wrap("test/matmul", lambda x: torch.matmul(x, x))
    for _ in range(3):
        prog(a)
    prog.account(0.05, calls=3)
    obs.finish_run(log)
    run = report.load_run(cfg.obs_log)
    assert run["programs"]["test/matmul"]["calls"] == 3
    assert run["programs"]["test/matmul"]["flops"] == 2 * 3 * 8 * 8 * 8
    port_text = report.render_report(cfg.obs_log)
    sec = _section(port_text)
    assert any("test/matmul" in ln for ln in sec)
    assert sec == _section(j_report.render_report(cfg.obs_log))


# ---- the port's count of a program's work -----------------------------------


def _bare_facts(fn, *args):
    _, facts = prof.extract_cost(fn, *args)
    return facts


def test_a_kernels_count_is_its_analytic_facts():
    """Inside a counted call a kernel adds exactly its facts: the plain
    version's own ops go uncounted (the kernel's are invisible), so the
    count is the same whichever ran."""
    g = torch.Generator().manual_seed(0)
    d = torch.rand(3, 9, 9, dtype=torch.float64, generator=g)
    d.diagonal(dim1=1, dim2=2).zero_()
    facts = _bare_facts(mp.minplus_closure, d, 4)
    assert (facts["flops"], facts["bytes_accessed"]) == mp.minplus_cost_facts(3, 9, 4, 8)
    assert facts["kernels"] == {"minplus": 1}
    adj = (torch.rand(2, 7, 7, generator=g) < 0.3).double()
    r = torch.rand(2, 7, dtype=torch.float64, generator=g) + 0.5
    facts = _bare_facts(fp.fixed_point, adj, r, r * 0.1, r * 0.2)
    assert (facts["flops"], facts["bytes_accessed"]) == fp.fixed_point_cost_facts(2, 7, 10)
    # a kernel inside another's call (K6's squarings) adds nothing of its own
    ends = torch.tensor([[[0, 1], [1, 2], [2, 3]]] * 2, dtype=torch.int32)
    mask = torch.ones(2, 3, dtype=torch.bool)
    delays = torch.rand(2, 3, dtype=torch.float64, generator=g)
    facts = _bare_facts(mp.apsp_minplus_coo, ends, mask, delays, 5)
    f6 = mp.coo_apsp_cost_facts(5, 3, mp.squaring_count(5), 8)
    assert facts["flops"] == 2 * f6["flops"] and facts["bytes_accessed"] == 2 * f6["bytes_accessed"]
    assert facts["kernels"] == {"coo_apsp": 1}
    # outside a counted program nothing is counted and nothing is open
    assert not prof.counting()


def test_kernel_records_register_in_a_count_and_again_after_reset():
    """`ops/coo_apsp` and `ops/chebconv` register once per shape, only
    while a program is counted, with JAX's facts and shape labels; a
    registry `reset` forgets the shapes, so the next count registers them
    again."""
    from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch
    from multihop_offload_tpu_torch.layouts.sparse import sparse_chebyshev_support

    reg = prof.prof_registry()
    reg.reset()
    inst, _, _ = request_batch(load_cases("paper")[:2], 1, seed=0, layout="sparse",
                               device="cpu")
    sup = sparse_chebyshev_support(inst.sparse.ext, mask=inst.ext_mask,
                                   csr=inst.sparse.ext_csr)
    x = torch.rand((2, sup.diag.shape[-1], 8), generator=torch.Generator().manual_seed(0))
    ends = torch.tensor([[[0, 1], [1, 2], [2, 3]]] * 2, dtype=torch.int32)
    mask = torch.ones(2, 3, dtype=torch.bool)
    delays = torch.rand(2, 3)

    def program():
        mp.apsp_minplus_coo(ends, mask, delays, 5)
        return cc.chebconv_propagate(sup, x)

    program()
    assert reg.names() == []
    n, nnz = sup.diag.shape[-1], sup.edges.rows.shape[-1]
    want = {"ops/coo_apsp": mp.coo_apsp_cost_facts(5, 3, mp.squaring_count(5), 4),
            "ops/chebconv": cc.chebconv_cost_facts(n, nnz, 8, 4)}
    for _ in range(2):
        prof.extract_cost(program)
        prof.extract_cost(program)
        snap = reg.snapshot()
        assert sorted(snap) == sorted(want)
        for name, facts in want.items():
            assert snap[name]["compiles"] == 1
            assert (snap[name]["flops"], snap[name]["bytes_accessed"]) == (
                facts["flops"], facts["bytes_accessed"])
        reg.reset()
    assert reg.names() == []


def test_dense_forward_backward_count_equals_an_independent_reckoning():
    """The counted flops of the dense `forward_backward` (model of record,
    K = 1, 2 networks at N = 24) equal 2·m·n·k over the model's matmuls
    (each layer's x @ W forward, its weight gradient, and its input
    gradient past the first layer), the critic's two incidence products
    (`agent/train_step.py:101`, with its VJP, and `env/queueing.py:104`),
    plus the correction terms at the call sites counted here: K2's
    squarings of 2·B·N³ an APSP, K1's passes of 2·B·L² a forward and twice
    that a backward."""
    from multihop_offload_tpu_torch.agent.train_step import forward_backward
    from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch
    from multihop_offload_tpu_torch.models.chebconv import load_model

    cases = [c for c in load_cases("paper") if c.topo.n <= 24][:2]
    inst, jobs, pad = request_batch(cases, 1, seed=0, cfg=Config(arrival_scale=0.15),
                                    dtype=torch.float64, device="cpu")
    model = load_model(prof_cli.MODEL_OF_RECORD, device="cpu").double()
    calls = {"fp": 0, "fpb": 0, "k2": 0}
    orig = (fp._forward, fp._backward, mp.minplus_closure)

    def spy(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call

    fp._forward, fp._backward, mp.minplus_closure = (
        spy("fp", orig[0]), spy("fpb", orig[1]), spy("k2", orig[2]))
    try:
        _, facts = prof.extract_cost(forward_backward, model, inst, jobs,
                                     torch.Generator().manual_seed(0), explore=0.0,
                                     device="cpu")
    finally:
        fp._forward, fp._backward, mp.minplus_closure = orig
    b, n, l, j = inst.adj.shape[0], pad.n, pad.l, pad.j
    e = n + l
    widths = [tuple(layer.kernel.shape[1:]) for layer in model.layers]
    assert all(layer.kernel.shape[0] == 1 for layer in model.layers)  # K = 1
    model_flops = sum(2.0 * b * e * fi * fo * (2 if i == 0 else 3)
                      for i, (fi, fo) in enumerate(widths))
    critic_flops = 2 * (2.0 * b * e * j) + 2.0 * b * l * j
    correction = (calls["k2"] * prof.apsp_flops(b, n, mp.squaring_count(n))
                  + calls["fp"] * prof.fixed_point_flops(b, l, 10)
                  + calls["fpb"] * 2 * prof.fixed_point_flops(b, l, 10))
    assert (n, calls) == (24, {"fp": 3, "fpb": 2, "k2": 1})
    assert facts["flops"] == model_flops + critic_flops + correction
    assert facts["kernels"] == {"fixed_point": 3, "fixed_point_bwd": 2, "minplus": 1}


def test_chip_smoke_reckoning_equals_the_count():
    """`chip_smoke.dense_step_flops`, which the card's 16 x 4 bench count
    is held to, equals the counted flops of the bench step at the CPU
    smoke's 4 x 2, whose kernel calls are `BENCH_KERNELS`."""
    import chip_smoke
    from multihop_offload_tpu_torch.models.chebconv import load_model

    step, args, pad, batch = prof_cli.bench_step("cpu", *prof_cli.BENCH_CPU)
    _, facts = prof.extract_cost(step, *args)
    model = load_model(prof_cli.MODEL_OF_RECORD, device="cpu")
    assert facts["kernels"] == chip_smoke.BENCH_KERNELS
    assert facts["flops"] == chip_smoke.dense_step_flops(model, batch, pad, facts["kernels"])


def test_wrapping_changes_no_launch():
    """`count_plain` (the launches the kernels make, counted on their
    plain versions) of a program's call: the bare function, its counted
    first call through the wrapper and a later call launch alike."""
    import chip_smoke
    from multihop_offload_tpu_torch.train.driver import eval_methods

    from multihop_offload_tpu_torch.models.chebconv import load_model

    _, (inst, jobs, _), _, _ = prof_cli.bench_step("cpu", 2, 1)
    model = load_model(prof_cli.MODEL_OF_RECORD, device="cpu")

    def bare():
        return eval_methods(model, inst, jobs, torch.Generator().manual_seed(3), device="cpu")

    prog = prof.wrap("test/eval", bare)
    out0, bare_counts = chip_smoke.count_plain(bare)
    out1, first = chip_smoke.count_plain(prog)
    out2, later = chip_smoke.count_plain(prog)
    assert prog.built and bare_counts == first == later
    assert bare_counts["fixed_point"] > 0 and bare_counts["minplus"] > 0
    for a, b in zip(out0, out1):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wired_programs_register_under_jax_names():
    """The serve buckets (full width and a ladder rung), the sharded
    executor with its labels, the simulator, the Trainer's three programs,
    the refit step and the RL step register under JAX's names."""
    import inspect

    from multihop_offload_tpu_torch.cli.serve import build_service
    from multihop_offload_tpu_torch.serve.workload import request_stream

    cfg = Config(seed=0, serve_sizes="10", serve_buckets=1, serve_slots=4,
                 model_root="/nonexistent-model-root")
    svc, pool = build_service(cfg, device="cpu")
    for r in request_stream(pool, 3, seed=1):
        assert svc.submit(r)
    svc.drain()
    ex = svc.executor
    assert ex.program(0, 4, False).name == "serve/bucket0/gnn"
    assert ex.program(0, 2, True).name == "serve/bucket0/baseline/w2"
    assert ex.program(0, 4, False).built and not ex.program(0, 4, True).built
    assert prof.prof_registry().get("serve/bucket0/gnn").calls >= 1
    sh, _ = build_service(cfg, device="cpu", devices=[torch.device("cpu")] * 2)
    for r in request_stream(pool, 4, seed=2):
        assert sh.submit(r)
    sh.drain()
    sp = next(iter(sh.executor._sharded_programs.values()))
    assert sp.name == "serve/bucket0/gnn" and set(sp.labels) == {"shard", "devices"}
    assert prof.prof_registry().get("serve/bucket0/gnn").calls >= 1
    from multihop_offload_tpu_torch.loop import refit
    from multihop_offload_tpu_torch.rl import trainer
    from multihop_offload_tpu_torch.sim import runner
    from multihop_offload_tpu_torch.train import driver

    assert '"sim/scan"' in inspect.getsource(runner.FleetSim)
    src = inspect.getsource(driver._Harness)
    assert all(f'"train/{k}"' in src for k in ("step", "eval", "replay"))
    assert '"loop/refit_step"' in inspect.getsource(refit.refit)
    assert '"rl/train_step"' in inspect.getsource(trainer.RLTrainer)


def test_prof_smoke_on_the_cpu():
    """`mho-prof --smoke` at JAX's CPU cut (4 x 2): every check, with the
    fake peaks set for the run and restored after."""
    env = {k: os.environ.get(k) for k in ("MHO_PROF_PEAK_TFLOPS", "MHO_PROF_PEAK_HBM_GBPS")}
    out = prof_cli.run_smoke(Config(seed=0), device="cpu", reps=4)
    assert out["ok"] and all(out["checks"].values())
    assert (out["bench"]["networks"], out["bench"]["instances"]) == (4, 2)
    assert out["peaks"] == {"tflops": 1.0, "hbm_gbps": 10.0,
                            "source": "fake (no table row for the device)"}
    assert {k: os.environ.get(k) for k in env} == env
    assert out["bench"]["kernels_counted"] == {"fixed_point": 3, "fixed_point_bwd": 2,
                                               "minplus": 1}
    assert np.isfinite(out["bench"]["gauge_mfu"])


def test_simulator_count_takes_one_policy_call_and_one_slot(monkeypatch):
    """`sim/scan`'s count (`RepeatedUnits`: one policy call and one slot
    step counted, their facts added for the rest of the schedule) against
    the count of every op of the same run: the same flops and kernel calls
    (the policy's work is the same each round), bytes within 10% (a slot's
    MWIS sweeps follow its queues)."""
    import dataclasses

    from multihop_offload_tpu_torch.cli.sim import build_scenarios

    cfg = dataclasses.replace(Config(seed=0), sim_policy="baseline", sim_fleet=2,
                              sim_nodes=8, sim_jobs=3, sim_rounds=2, sim_slots=6,
                              sim_cap=64)
    counts = {}
    for tag in ("units", "every_op"):
        if tag == "every_op":
            monkeypatch.setattr(prof.RepeatedUnits, "unit",
                                lambda self, key: __import__("contextlib").nullcontext())
        scen = build_scenarios(cfg, "cpu")
        scen["sim"].run(scen["insts"], scen["jobss"], scen["paramss"], scen["seeds"])
        counts[tag] = scen["sim"]._fn.facts
    got, want = counts["units"], counts["every_op"]
    assert got["flops"] == want["flops"] and got["kernels"] == want["kernels"]
    assert got["kernels"] == {"minplus": 2}   # the baseline policy: K2 a round
    assert got["bytes_accessed"] == pytest.approx(want["bytes_accessed"], rel=0.1)
