"""Host-side telemetry of the port: metric registry, run log, spans.

Port of the parts of `multihop_offload_tpu/obs/` the serving path uses:
`registry` (counters, gauges, histograms with labels), `events` (the JSONL
run log), `spans` (nested host spans as profiler ranges), `trace`
(request-scoped hop events) and `flightrec` (the tick ring dumped on a
stuck dispatch).  Standard library and torch only.
"""
