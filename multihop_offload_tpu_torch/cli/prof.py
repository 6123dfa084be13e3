"""Performance-observability entry point (`mho-prof`): the prof layer's CLI.

Port of `multihop_offload_tpu/cli/prof.py`:

    python -m multihop_offload_tpu_torch.cli.prof            # the peak table
    python -m multihop_offload_tpu_torch.cli.prof capture --prof_seconds N
        [--prof_out DIR]   # a torch.profiler trace of the bench step
    python -m multihop_offload_tpu_torch.cli.prof --smoke [--device cpu]
        [--prof_out F]

The bench step is the paper batch of the port's committed data (the
first `networks` BA cases x `instances` job sets at load 0.15, the
`bench.py` workload of the JAX package) through `forward_backward` with
the model of record, dense: K1 and K2 on the card.  At full width it is
16 x 4; the CPU smoke cuts it to JAX's 4 x 2.

The smoke run is the proof the prof layer closes its loop: the bench step
and a tiny serving bucket register (flops, bytes, arithmetic intensity,
the counted call's wall time); the bench step's live `mho_program_mfu` and
`mho_program_hbm_frac` agree within 1% with a roofline the smoke computes
from the same facts and windows; an injected SLO breach (a latency burst,
and a `serve_mfu` floor of 0.5 that no program here reaches) writes a
profiler capture next to the flight-recorder dump; and what the layer
adds to a bench step (the wrapper's call and accounting, and the count's
test at each kernel dispatcher the step calls) stays under 2% of it.  Where the peak
table has no row for the device (the CPU) the smoke drills the gauge math
on JAX's fake peaks, set in the environment for the run and restored
after; on the card it reads the H100 row.  It runs on CUDA unless
`--device cpu` is given; its record is written only where `--prof_out`
names a file.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import torch

from multihop_offload_tpu_torch.config import Config, build_parser

# JAX's injected peaks (`cli/prof.py:28-29`): O(1e-3) MFU on the CPU, under
# the smoke's 0.5 utilization floor
_FAKE_PEAK_TFLOPS = 1.0
_FAKE_PEAK_HBM_GBPS = 10.0
MODEL_OF_RECORD = "SCRATCH800_decay0.99"
BENCH_FULL = (16, 4)     # networks x job sets a network (`bench.py`'s defaults)
BENCH_CPU = (4, 2)       # JAX's smoke cut (`cli/prof.py:101-102`)
OVERHEAD_BUDGET = 0.02


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bench_step(device, networks: int, instances: int):
    """The bench workload and its step: (step, args, pad, batch).
    `step(inst, jobs, gen)` is `forward_backward` at explore 0 under the
    model of record, returning (grads, loss_critic, job totals)."""
    from multihop_offload_tpu_torch.agent.train_step import forward_backward
    from multihop_offload_tpu_torch.graphs.cases import load_cases, request_batch
    from multihop_offload_tpu_torch.models.chebconv import load_model

    device = torch.device(device)
    paper = load_cases("paper")[:networks]
    inst, jobs, pad = request_batch(paper, instances, seed=0,
                                    cfg=Config(arrival_scale=0.15), device=device)
    model = load_model(MODEL_OF_RECORD, device=device)

    def step(inst, jobs, gen):
        out = forward_backward(model, inst, jobs, gen, explore=0.0, device=device)
        return out.grads, out.loss_critic, out.delays.job_total

    gen = torch.Generator(device=device).manual_seed(1)
    return step, (inst, jobs, gen), pad, int(inst.adj.shape[0])


def smoke_config(cfg: Config, tmp: str) -> Config:
    """Tiny single-bucket service + a dedicated run log under `tmp`."""
    return dataclasses.replace(
        cfg,
        serve_sizes="10", serve_buckets=1, serve_slots=4,
        serve_queue_cap=16, serve_deadline_s=60.0,
        model_root=os.path.join(tmp, "model"),
        obs_log=os.path.join(tmp, "prof_run.jsonl"),
    )


def _dir_has_files(path: str) -> bool:
    return any(files for _, _, files in os.walk(path))


class _FakePeaks:
    """JAX's fake peaks in the environment for the smoke's duration, where
    the table has no row for the device; restored on exit."""

    KEYS = ("MHO_PROF_PEAK_TFLOPS", "MHO_PROF_PEAK_HBM_GBPS")

    def __init__(self, prof, enabled: bool):
        self.prof, self.enabled, self.saved = prof, enabled, {}

    def __enter__(self):
        if self.enabled:
            self.saved = {k: os.environ.get(k) for k in self.KEYS}
            os.environ[self.KEYS[0]] = str(_FAKE_PEAK_TFLOPS)
            os.environ[self.KEYS[1]] = str(_FAKE_PEAK_HBM_GBPS)
            self.prof.reset_peaks()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            for k, v in self.saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            self.prof.reset_peaks()
        return False


def run_smoke(cfg: Config, device=None, networks=None, instances=None,
              reps: int = 10, tmp=None) -> dict:
    """Bench parity -> serve registration -> injected breach capture ->
    overhead budget, asserting every link (see the module doc).  `networks`
    x `instances` default to 16 x 4 on CUDA and 4 x 2 on the CPU; `tmp`
    keeps the run's files (default: a temporary directory)."""
    import tempfile

    from multihop_offload_tpu_torch._device import resolve_device
    from multihop_offload_tpu_torch.obs import prof as obs_prof

    dev = resolve_device(device)
    full = dev.type == "cuda"
    networks = networks or (BENCH_FULL if full else BENCH_CPU)[0]
    instances = instances or (BENCH_FULL if full else BENCH_CPU)[1]
    prof = obs_prof.prof_registry()
    kind = obs_prof._device_kind() if full else ""
    fake = obs_prof._lookup(obs_prof.PEAK_TFLOPS_BY_KIND, kind) is None
    with tempfile.TemporaryDirectory(prefix="mho_prof_smoke_") as own:
        with _FakePeaks(prof, fake):
            record = _smoke_legs(cfg, dev, networks, instances, reps, tmp or own, fake)
    assert record["ok"], f"prof smoke failed: {record['checks']}"
    return record


def _smoke_legs(cfg, dev, networks: int, instances: int, reps: int, tmp: str,
                fake: bool) -> dict:
    from multihop_offload_tpu_torch import obs
    from multihop_offload_tpu_torch.cli.serve import build_service
    from multihop_offload_tpu_torch.obs import events as obs_events
    from multihop_offload_tpu_torch.obs import prof as obs_prof
    from multihop_offload_tpu_torch.obs.flightrec import FlightRecorder
    from multihop_offload_tpu_torch.obs.memwatch import memwatch
    from multihop_offload_tpu_torch.obs.registry import registry as obs_registry
    from multihop_offload_tpu_torch.obs.report import _program_gauge
    from multihop_offload_tpu_torch.obs.slo import SLOEngine, default_serving_slos
    from multihop_offload_tpu_torch.serve.workload import request_stream

    prof = obs_prof.prof_registry()
    peak_tf, peak_bw = prof._peaks()
    scfg = smoke_config(cfg, tmp)
    runlog = obs.start_run(scfg, role="prof")
    record: dict = {
        "device": str(dev),
        "peaks": {"tflops": peak_tf, "hbm_gbps": peak_bw,
                  "source": "fake (no table row for the device)" if fake
                  else f"table: {obs_prof._device_kind()}"},
        "reps": reps,
    }
    try:
        # ---- bench leg: the counted first call registers, then a timed
        # window of `reps` calls is accounted
        step, args, pad, batch = bench_step(dev, networks, instances)
        prior = prof.get("bench/step")
        prior_calls, prior_s = (prior.calls, prior.device_s) if prior else (0, 0.0)
        t_c = time.perf_counter()
        out, facts = obs_prof.extract_cost(step, *args)
        _sync(dev)
        count_s = time.perf_counter() - t_c
        prof.register("bench/step", facts, compile_s=count_s)
        memwatch().snapshot("bench_warmup")
        t0 = time.perf_counter()
        for _ in range(reps):
            out = step(*args)
        _sync(dev)
        dt = time.perf_counter() - t0
        prof.account("bench/step", dt, calls=reps)
        memwatch().snapshot("bench_timed")
        # the roofline from the same facts and windows, computed here
        calls, secs = prior_calls + reps, prior_s + dt
        roof_mfu = (facts["flops"] * calls / secs / 1e12) / peak_tf
        roof_hbm = (facts["bytes_accessed"] * calls / secs / 1e9) / peak_bw
        snap = obs_registry().snapshot()
        gauge_mfu = _program_gauge(snap, "mho_program_mfu").get("bench/step")
        gauge_hbm = _program_gauge(snap, "mho_program_hbm_frac").get("bench/step")
        record["bench"] = {
            "networks": networks, "instances": instances, "batch": batch,
            "pad": {"n": pad.n, "l": pad.l, "j": pad.j}, "dt_s": dt,
            "ms_per_step": dt / reps * 1e3, "count_s": count_s,
            "flops": facts["flops"], "bytes_accessed": facts["bytes_accessed"],
            "kernels_counted": facts["kernels"],
            "roofline_mfu": roof_mfu, "gauge_mfu": gauge_mfu,
            "mfu_rel_err": (abs(gauge_mfu - roof_mfu) / roof_mfu
                            if gauge_mfu and roof_mfu else None),
            "roofline_hbm_frac": roof_hbm, "gauge_hbm_frac": gauge_hbm,
            "hbm_rel_err": (abs(gauge_hbm - roof_hbm) / roof_hbm
                            if gauge_hbm and roof_hbm else None),
        }

        # ---- serve leg: a real BucketExecutor program registers --------
        t = {"now": 0.0}
        service, pool = build_service(scfg, clock=lambda: t["now"], device=dev)
        pending = list(request_stream(pool, 8, seed=scfg.seed + 1,
                                      arrival_scale=scfg.arrival_scale, ul=scfg.ul_data,
                                      dl=scfg.dl_data, t_max=float(scfg.T)))
        served = []
        while pending or service.queue_depth:
            for _ in range(4):
                if pending:
                    service.submit(pending.pop())
            t["now"] += 0.01
            served.extend(service.tick())
        memwatch().snapshot("serve")
        record["serve"] = {"served": len(served),
                           "programs": [n for n in prof.names() if n.startswith("serve/")]}

        # ---- injected breach -> flight dump + profiler capture ---------
        engine = SLOEngine(default_serving_slos(latency_le=0.05, mfu_floor=0.5),
                           short_s=2.0, long_s=8.0)
        recorder = FlightRecorder(capacity=scfg.obs_flight_capacity,
                                  clock=lambda: t["now"])
        breach_dir = os.path.join(tmp, "breach")

        def traced():
            step(*args)
            _sync(dev)

        capture = obs_prof.BreachCapture(breach_dir, slos=("serve_p99", "serve_mfu"),
                                         clock=lambda: t["now"], fn=traced)
        bundles = []
        engine.on_breach(lambda spec, info: bundles.append(
            recorder.dump(breach_dir, spec.name, alerts=engine.state(),
                          extra={"alert": info})))
        engine.on_breach(capture.on_breach)
        lat = obs_registry().histogram("mho_serve_latency_seconds", "queue+serve latency")
        alerts = []
        for _ in range(12):
            lat.observe(0.5)          # every observation busts the bound
            t["now"] += 1.0
            alerts.extend(engine.observe(t["now"]))
        record["breach"] = {
            "alerts": alerts,
            "flight_bundles": [os.path.basename(b) for b in bundles if b],
            "captures": [os.path.relpath(c, tmp) for c in capture.captures],
        }

        # ---- what the prof layer adds to a step: the wrapped program's
        # call and its `account`, and the count's test at each kernel
        # dispatcher (`counted`, `kernel_scope`) times the step's kernel
        # calls, each timed against the bare call it wraps
        record["overhead"] = _overhead(step, args, dev, reps, facts["kernels"])
        record["programs"] = prof.snapshot()
        record["watermarks"] = memwatch().watermarks()
    finally:
        obs.finish_run(runlog)

    # ---- evidence from the run log itself ------------------------------
    summary_programs, program_events = {}, 0
    for ev in obs_events.read_events(scfg.obs_log):
        if ev.get("event") == "program":
            program_events += 1
        if ev.get("event") == "summary":
            summary_programs = ev.get("programs") or {}
    caps_on_disk = [c for c in record["breach"]["captures"]
                    if _dir_has_files(os.path.join(tmp, c))]
    bundle_files = all(
        os.path.exists(os.path.join(breach_dir, b, f))
        for b in record["breach"]["flight_bundles"]
        for f in ("bundle.json", "records.jsonl", "metrics.prom"))
    bench_rec = record["programs"].get("bench/step") or {}
    serve_recs = [record["programs"][n] for n in record["serve"]["programs"]]
    facts_keys = ("flops", "bytes_accessed", "arithmetic_intensity", "compile_s")
    b = record["bench"]
    checks = {
        "bench_registered": bool(bench_rec),
        "serve_registered": bool(serve_recs),
        "facts_complete": all(r.get(k) is not None for r in [bench_rec, *serve_recs]
                              for k in facts_keys),
        "mfu_gauge_parity_1pct": b["mfu_rel_err"] is not None and b["mfu_rel_err"] < 0.01,
        "hbm_gauge_parity_1pct": b["hbm_rel_err"] is not None and b["hbm_rel_err"] < 0.01,
        "p99_breach_fired": any(a["name"] == "serve_p99" and a["state"] == "firing"
                                for a in record["breach"]["alerts"]),
        "mfu_floor_breach_fired": any(a["name"] == "serve_mfu" and a["state"] == "firing"
                                      for a in record["breach"]["alerts"]),
        "flight_bundle_written": bool(record["breach"]["flight_bundles"]) and bundle_files,
        "profiler_capture_written": bool(caps_on_disk),
        "overhead_within_budget": (record["overhead"]["overhead_frac"]
                                   < record["overhead"]["budget_frac"]),
        "runlog_has_program_events": program_events >= 2,
        "runlog_summary_has_programs": "bench/step" in summary_programs,
    }
    record["checks"] = checks
    record["ok"] = all(checks.values())
    return record


def _per_call_s(fn, calls: int = 2000, legs: int = 3) -> float:
    """Seconds a call of `fn()`, the least of `legs` windows of `calls`."""
    best = float("inf")
    for _ in range(legs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls)
    return best


def _overhead(step, args, dev, reps: int, kernels: dict) -> dict:
    """The prof layer's cost a bench step.  `overhead_frac` is the host
    time it adds, over the step: the wrapper's call and `account` against
    the bare call of a no-op, plus the step's kernel calls times the
    dispatchers' test (`counted` and `kernel_scope` outside a count
    against the bare no-op; the larger of the two).  JAX's interleaved
    legs (bare step against wrapped step plus `account`, min of 3) are
    kept beside it as `interleaved_frac`: on a host shared with other work
    their noise passes the 2% budget either way."""
    from multihop_offload_tpu_torch.obs import prof as obs_prof

    def noop():
        return None

    def scoped():
        with obs_prof.kernel_scope("prof_smoke/noop", lambda: (0.0, 0.0)):
            return None

    program = obs_prof.wrap("prof_smoke/overhead", noop)
    program()                          # its counted call, outside the timing

    def wrapped():
        program()
        program.account(0.0)           # the accounting call is the payload

    dispatched = obs_prof.counted("prof_smoke/noop", lambda: (0.0, 0.0))(noop)
    bare_s = _per_call_s(noop)
    wrapper_s = _per_call_s(wrapped) - bare_s
    dispatch_s = max(_per_call_s(dispatched), _per_call_s(scoped)) - bare_s
    kernel_calls = sum(kernels.values())

    step_program = obs_prof.wrap("prof_smoke/overhead_step", step)
    step_program(*args)
    oreps = max(4, reps // 2)
    bare_legs, inst_legs = [], []
    for _ in range(3):
        tb = time.perf_counter()
        for _ in range(oreps):
            step(*args)
        _sync(dev)
        bare_legs.append(time.perf_counter() - tb)
        ti = time.perf_counter()
        for _ in range(oreps):
            step_program(*args)
            step_program.account(0.0)
        _sync(dev)
        inst_legs.append(time.perf_counter() - ti)
    step_s = min(bare_legs) / oreps
    return {
        "wrapper_call_s": wrapper_s, "dispatch_call_s": dispatch_s,
        "kernel_calls_per_step": kernel_calls, "step_s": step_s,
        "overhead_frac": (wrapper_s + kernel_calls * dispatch_s) / step_s,
        "reps_per_leg": oreps, "bare_legs_s": bare_legs, "instrumented_legs_s": inst_legs,
        "interleaved_frac": min(inst_legs) / min(bare_legs) - 1.0,
        "budget_frac": OVERHEAD_BUDGET,
    }


def run_capture(seconds: float, out_dir: str, device=None) -> str:
    """A profiler capture of the bench step (full width on CUDA) run in a
    loop for ~`seconds`; the first call runs untraced.  Returns the trace
    directory ("" on failure)."""
    from multihop_offload_tpu_torch._device import resolve_device
    from multihop_offload_tpu_torch.obs import prof as obs_prof

    dev = resolve_device(device)
    networks, instances = BENCH_FULL if dev.type == "cuda" else BENCH_CPU
    step, args, _, _ = bench_step(dev, networks, instances)
    step(*args)
    _sync(dev)

    def body():
        t_end = time.time() + max(float(seconds), 0.0)
        step(*args)
        while time.time() < t_end:
            step(*args)
        _sync(dev)

    return obs_prof.capture_trace(out_dir, fn=body)


def render_peaks() -> str:
    """The peak table and this host's resolved peaks."""
    from multihop_offload_tpu_torch.obs import prof as obs_prof

    kind = obs_prof._device_kind()
    lines = ["prof peaks (obs.prof; env overrides "
             "MHO_PROF_PEAK_TFLOPS / MHO_PROF_PEAK_HBM_GBPS)",
             f"  device_kind     {kind or '(no CUDA device)'}",
             f"  peak_tflops     {obs_prof.peak_tflops(kind)}",
             f"  peak_hbm_gbps   {obs_prof.peak_hbm_gbps(kind)}",
             "  table (device-kind substring -> dense bf16 TFLOP/s, HBM GB/s):"]
    hbm = dict(obs_prof.PEAK_HBM_GBPS_BY_KIND)
    for sub, tf in obs_prof.PEAK_TFLOPS_BY_KIND:
        lines.append(f"    {sub:<10} {tf:>7g} {hbm[sub]:>7g}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    from multihop_offload_tpu_torch._device import resolve_device
    from multihop_offload_tpu_torch.cli.loop import write_record

    p = build_parser(description=__doc__)
    p.add_argument("command", nargs="?", choices=["capture"],
                   help="'capture' traces the bench step; default prints the peaks")
    p.add_argument("--smoke", action="store_true",
                   help="prof drill: bench gauge/roofline parity, serve registration, "
                        "injected SLO breach -> profiler capture + flight dump, "
                        "accounting overhead; writes its record where --prof_out names")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    ns = vars(p.parse_args(argv))
    command, smoke, device = ns.pop("command"), ns.pop("smoke"), ns.pop("device")
    cfg = Config(**ns)

    if command == "capture":
        dev = resolve_device(device)
        path = run_capture(cfg.prof_seconds, cfg.prof_out or "prof_trace", device=dev)
        if not path:
            print("profiler capture failed", file=sys.stderr)
            return 1
        print(f"profiler trace written to {path}")
        return 0
    if not smoke:
        print(render_peaks(), end="")
        return 0
    out = run_smoke(cfg, device=resolve_device(device))
    if cfg.prof_out:
        write_record(out, cfg.prof_out)
        print(f"prof smoke record written to {cfg.prof_out}")
    print(json.dumps(out["checks"], indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
