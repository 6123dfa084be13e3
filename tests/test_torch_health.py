"""PyTorch port of the health drill (`cli/health.py`) and the run report
(`obs/report.py`, `obs/trace.py:render_trace`, `cli/obs.py`), against the
JAX package on the CPU.

The report, the trace view and `cli/obs.py`'s `--json` / `--prom` must
give exactly the JAX package's text on the same run log: one the test
writes (rotated segments, every section of the report) and the one the
port's health drill writes.  The drill itself passes on the CPU, and its
record carries the JAX record's keys and checks.
"""

import json

import pytest

from multihop_offload_tpu.cli import health as j_health
from multihop_offload_tpu.cli import obs as j_obs_cli
from multihop_offload_tpu.obs import report as j_report
from multihop_offload_tpu.obs import trace as j_trace
from multihop_offload_tpu_torch.cli import health
from multihop_offload_tpu_torch.cli import obs as obs_cli
from multihop_offload_tpu_torch.config import Config
from multihop_offload_tpu_torch.obs import events as obs_events
from multihop_offload_tpu_torch.obs import report
from multihop_offload_tpu_torch.obs import trace
from multihop_offload_tpu_torch.obs.events import RunLog, run_manifest, segment_paths
from multihop_offload_tpu_torch.obs.registry import registry

# the JAX drill's checks and record keys (`multihop_offload_tpu/cli/health.py:
# run_smoke`)
JAX_CHECKS = {
    "alert_fired", "alert_resolved", "p99_alert", "flight_bundle_written",
    "flight_ring_nonempty", "drift_tripped", "capturing_via_drift", "promoted",
    "trace_hops", "log_rotated", "steady_serving_no_retrace", "burst_refused_some",
}
JAX_RECORD_KEYS = {
    "phases", "drift_trips", "refit", "promoted_step", "alerts", "slo_state",
    "flight_bundles", "trace", "log_segments", "unexpected_retraces", "checks", "ok",
}


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """The health drill on the CPU, its files kept."""
    registry().reset()
    tmp = str(tmp_path_factory.mktemp("health"))
    rec = health.run_smoke(Config(), device="cpu", tmp=tmp)
    return rec, health.smoke_config(Config(), tmp).obs_log


def _synthetic_log(path: str) -> None:
    """A rotated run log touching every section of the report."""
    log = RunLog(path, manifest=run_manifest(Config(), role="serve"), max_bytes=700)
    obs_events.set_run_log(log)
    try:
        log.emit("phase", name="bench/warmup", duration_s=0.25)
        log.emit("phase", name="bench/timed", duration_s=1.5)
        log.emit("phase", name="bench/timed", duration_s=1.25)
        trace.hop("submit", [7], bucket=0, queue_depth=1)
        trace.hop("pack", [5, 7, 9], bucket=0, degraded=False)
        for i in range(12):   # filler traffic forces rotations
            trace.hop("decision", [1000 + i], bucket=0, latency_s=[0.001],
                      served_by="gnn")
        trace.hop("decision", [5, 7, 9], bucket=0, latency_s=[0.01, 0.02, 0.03],
                  served_by="gnn")
        log.emit("tick", n=3, served=2, queue_depth=4)
        log.emit("alert", name="serve_p99", state="firing", at=5.0, burn_short=12.0,
                 burn_long=4.0)
        log.emit("alert", name="serve_queue", state="firing", at=6.5)
        log.emit("alert", name="serve_p99", state="resolved", at=9.0)
        log.emit("drift", signal="tau", detector="page_hinkley", samples=40, stat=15.2)
        log.emit("flight_record", path="/x/flight-001-serve_p99", reason="serve_p99",
                 records=64)
        log.emit("watermark", device="cuda:0", bytes=123456, phase="serve/tick")
        log.emit("prof_capture", path=None, error="no profiler")
        log.emit("hot_reload", step=3, source="refit", parent_step=2, git_sha="")
        log.emit("promotion", step=3, reason="gates passed")
        log.emit("rollback", step=2, failed_step=3)
        trace.hop("promotion", [7, 9], step=2, candidate_step=1)
        log.emit("summary", phases={
            "serve/tick": {"count": 4, "total_s": 0.8, "min_s": 0.1, "max_s": 0.3},
            "train/build": {"count": 2, "total_s": 0.5, "mean_s": 0.25, "min_s": 0.2,
                            "max_s": 0.3},
            "xla/compile": {"count": 1, "total_s": 0.125, "min_s": 0.125,
                            "max_s": 0.125}},
            metrics={
                "jax_retraces_total": {"kind": "counter", "help": "traces",
                                       "series": {'{phase="train/step"}': 3.0}},
                "jax_unexpected_retraces_total": {
                    "kind": "counter", "help": "", "series": {'{phase="train/step"}': 1.0}},
                "mho_serve_requests_total": {"kind": "counter", "help": "requests",
                                             "series": {"": 42.0, '{bucket="0"}': 2.5}},
                "mho_serve_latency_seconds": {
                    "kind": "histogram", "help": "latency",
                    "series": {'{bucket="0"}': {"count": 4, "sum": 0.5, "min": 0.01,
                                                "max": 0.3}}},
                "mho_dev_sim_queue_depth": {
                    "kind": "histogram", "help": "",
                    "series": {"": {"count": 10, "sum": 33.0, "min": 0.0, "max": 9.0}}},
                "mho_dev_sim_drops_total": {"kind": "counter", "help": "",
                                            "series": {"": 7.0}},
                "mho_loop_promotions_total": {"kind": "counter", "help": "",
                                              "series": {"": 1.0}},
                "mho_program_mfu": {"kind": "gauge", "help": "",
                                    "series": {'{program="serve_b0"}': 0.125}},
                "mho_device_peak_bytes_in_use": {"kind": "gauge", "help": "",
                                                 "series": {'{device="cuda:0"}': 2048.0}},
            },
            programs={"serve_b0": {"calls": 3, "device_s": 0.5, "compile_s": None,
                                   "flops_corrected": 1.5e9}})
    finally:
        obs_events.set_run_log(None)
        log.close()


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("obs") / "run.jsonl")
    _synthetic_log(path)
    assert len(segment_paths(path)) >= 2
    return path


def test_health_drill_passes_with_the_jax_checks(drill):
    rec, _ = drill
    assert rec["ok"]
    assert set(rec["checks"]) == JAX_CHECKS
    assert set(rec) == JAX_RECORD_KEYS
    assert rec["checks"]["steady_serving_no_retrace"]["ok"] is None
    assert all(v for k, v in rec["checks"].items() if k != "steady_serving_no_retrace")
    assert rec["trace"]["hops"][0] == "submit" and rec["trace"]["hops"][-1] == "promotion"


@pytest.mark.parametrize("which", ["drill", "synthetic"])
def test_report_is_the_jax_report(request, which):
    path = request.getfixturevalue("drill")[1] if which == "drill" \
        else request.getfixturevalue("synthetic")
    text = report.render_report(path)
    assert text == j_report.render_report(path)
    assert report.load_run(path) == j_report.load_run(path)
    if which == "synthetic":
        for part in ("per-phase time", "PERF BUG", "performance (per program)",
                     "memory watermarks", "serving", "device metrics",
                     "continual learning", "still firing at log end: serve_queue",
                     "device memory"):
            assert part in text, part


@pytest.mark.parametrize("rid", [7, 9, 4242])
def test_trace_view_is_the_jax_view(synthetic, rid):
    assert trace.render_trace(synthetic, rid) == j_trace.render_trace(synthetic, rid)
    assert trace.reconstruct(synthetic, rid) == j_trace.reconstruct(synthetic, rid)


@pytest.mark.parametrize("args", [[], ["--json"], ["--prom", "-"], ["--trace", "7"],
                                  ["--json", "--prom", "FILE"]],
                         ids=["report", "json", "prom", "trace", "json_prom_file"])
def test_obs_cli_prints_what_jax_prints(synthetic, tmp_path, capsys, args):
    outs = []
    for main, tag in ((obs_cli.main, "port"), (j_obs_cli.main, "jax")):
        a = [str(tmp_path / f"{tag}.prom") if x == "FILE" else x for x in args]
        assert main([synthetic] + a) == 0
        out = capsys.readouterr().out.replace(str(tmp_path / f"{tag}.prom"), "FILE")
        outs.append(out)
        if "FILE" in args:
            outs.append((tmp_path / f"{tag}.prom").read_text())
    half = len(outs) // 2
    assert outs[:half] == outs[half:]
    if "--json" in args:
        assert set(json.loads(outs[0].split("\nwrote ")[0])) == {
            "manifest", "counts", "phases", "metrics", "programs", "health", "wall_s"}


@pytest.mark.parametrize("name", ["train/build", "serve/prefetch", "x/pack", "sim/step",
                                  "serve/tick", "bench/timed", "xla/compile", "misc"])
def test_phase_classes_are_jax_classes(name):
    assert report.classify_phase(name) == j_report.classify_phase(name)


def test_program_gauge_and_slo_table_are_jax(capsys):
    metrics = {"g": {"series": {'{program="a"}': 1.5, '{x="y"}': 2.0, "": 3.0,
                                '{program="b",k="v"}': 0.25, '{program="c"}': {"n": 1}}}}
    assert report._program_gauge(metrics, "g") == j_report._program_gauge(metrics, "g")
    assert report._program_gauge(metrics, "none") == {}
    assert health.render_specs() == j_health.render_specs()
    assert health.main([]) == 0
    assert capsys.readouterr().out == j_health.render_specs()


def test_health_cli_refuses_a_missing_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        health.main(["--smoke"])
