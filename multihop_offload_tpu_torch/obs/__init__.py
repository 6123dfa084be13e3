"""Host-side telemetry of the port: metric registry, run log, spans.

Port of the parts of `multihop_offload_tpu/obs/` the serving path and the
drivers use: `registry` (counters, gauges, histograms with labels,
Prometheus text), `events` (the JSONL run log, size-rotated segments),
`spans` (nested host spans as profiler ranges), `trace` (request-scoped
hop events) and `flightrec` (the tick ring dumped on a stuck dispatch),
`devmetrics` (the simulator's accumulators on the card, flushed into the
registry), and the entry points' `start_run` / `finish_run` (JAX
`obs/__init__.py:78-119`), `drift` (the flywheel's change detectors
over captured outcomes), `report` (a run log rendered as the operator
view, `cli/obs.py`), `prof` (per-program cost facts, the MFU and
HBM-fraction gauges against an H100 peak table, `program` and
`prof_capture` events, the summary's `programs=` table) and `memwatch`
(allocator watermarks, `watermark` events, a `finish` snapshot).
`jaxhooks` (retrace and compile counters) has no counterpart in eager
torch, so no `retrace` or `compile` events.  Standard library, numpy and
torch only.
"""

from __future__ import annotations

# what the records say of JAX's zero-unexpected-retrace checks
NOT_APPLICABLE_RETRACES = ("a JAX compile property (obs/jaxhooks.py); the port "
                           "runs eagerly and compiles nothing")


def start_run(cfg, role: str):
    """Open the JSONL run log at ``cfg.obs_log`` (manifest header first,
    segments rotated at ``cfg.obs_log_max_bytes``), remember
    ``cfg.obs_prom`` for `finish_run`, and make it the active sink; None
    when ``cfg.obs_log`` is empty."""
    path = getattr(cfg, "obs_log", "")
    if not path:
        return None
    from multihop_offload_tpu_torch.obs.events import RunLog, run_manifest, set_run_log

    log = RunLog(path, manifest=run_manifest(cfg, role=role),
                 max_bytes=getattr(cfg, "obs_log_max_bytes", 0) or None)
    log.prom_path = getattr(cfg, "obs_prom", "") or None
    set_run_log(log)
    return log


def finish_run(log, registry_=None, terminal: bool = False) -> None:
    """Close an enabled run log: take a final memwatch snapshot, append
    the summary event (host span table, metric snapshot, the prof
    layer's per-program table), write the Prometheus text exposition when
    the run asked for it, and detach the active sink.  `terminal=True` (an
    orderly shutdown: the graceful drain) seals the active segment into
    the rotated chain, so a process restarted at the same path needs no
    crash rotate-aside.  No-op on None."""
    if log is None:
        return
    from multihop_offload_tpu_torch.obs.events import get_run_log, set_run_log
    from multihop_offload_tpu_torch.obs.memwatch import memwatch
    from multihop_offload_tpu_torch.obs.prof import prof_registry
    from multihop_offload_tpu_torch.obs.registry import registry
    from multihop_offload_tpu_torch.obs.spans import phase_stats

    memwatch().snapshot("finish")
    reg = registry_ if registry_ is not None else registry()
    log.emit("summary", phases=phase_stats(), metrics=reg.snapshot(),
             programs=prof_registry().snapshot())
    prom = getattr(log, "prom_path", None)
    if prom:
        with open(prom, "w") as f:
            f.write(reg.prometheus_text())
    if get_run_log() is log:
        set_run_log(None)
    log.close(terminal=terminal)
