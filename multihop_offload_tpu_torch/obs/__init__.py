"""Host-side telemetry of the port: metric registry, run log, spans.

Port of the parts of `multihop_offload_tpu/obs/` the serving path and the
drivers use: `registry` (counters, gauges, histograms with labels),
`events` (the JSONL run log), `spans` (nested host spans as profiler
ranges), `trace` (request-scoped hop events) and `flightrec` (the tick
ring dumped on a stuck dispatch), `devmetrics` (the simulator's
accumulators on the card, flushed into the registry), and the drivers'
`start_run` / `finish_run` (JAX `obs/__init__.py:78-110`; no retrace
hooks, no device memory gauges, no per-program cost table: `obs/prof` and
`obs/memwatch` are not ported yet).  Standard library, numpy and torch
only.
"""

from __future__ import annotations


def start_run(cfg, role: str):
    """Open the JSONL run log at ``cfg.obs_log`` (manifest header first)
    and make it the active sink; None when ``cfg.obs_log`` is empty."""
    path = getattr(cfg, "obs_log", "")
    if not path:
        return None
    from multihop_offload_tpu_torch.obs.events import RunLog, run_manifest, set_run_log

    log = RunLog(path, manifest=run_manifest(cfg, role=role))
    set_run_log(log)
    return log


def finish_run(log) -> None:
    """Close an enabled run log: append the summary event (host span
    table, metric snapshot) and detach the active sink.  No-op on None."""
    if log is None:
        return
    from multihop_offload_tpu_torch.obs.events import get_run_log, set_run_log
    from multihop_offload_tpu_torch.obs.registry import registry
    from multihop_offload_tpu_torch.obs.spans import phase_stats

    log.emit("summary", phases=phase_stats(), metrics=registry().snapshot())
    if get_run_log() is log:
        set_run_log(None)
    log.close()
