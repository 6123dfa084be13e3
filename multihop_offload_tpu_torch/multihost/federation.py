"""Cross-process metric and SLO federation.

Port of `multihop_offload_tpu/multihost/federation.py` (standard library
only).  Every serving process exposes its metric registry as the
Prometheus text exposition (`obs.registry.MetricRegistry.prometheus_text`).
Federation adds nothing to the data plane: each process gets a small
stdlib HTTP endpoint on loopback (`MetricsEndpoint`) serving that text, and
the coordinator runs a `FleetFederation` that scrapes every endpoint and
merges the series into one registry with a `host=` label per process.

The merge applies deltas: counters and histogram buckets only grow on the
source, so each scrape adds `current - last_seen` to the federated series
(gauges are last-write).  The federated registry is a real registry
(`Counter.total`, `Histogram.le_total` and quantiles work), so the
`obs.slo.SLOEngine` pointed at it (`federated_slo_engine`) computes
fleet-wide burn rates, and per-host breakdowns come from the `host=` label.

A dead host is data, not an exception: a failed scrape sets
`mho_mesh_host_up{host=...} 0`, counts the failure, and keeps the host's
last-known series in the federated registry (a crashed host's requests
still count toward the fleet totals).
"""

from __future__ import annotations

import re
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

from multihop_offload_tpu_torch.obs.registry import (
    MetricRegistry,
    registry as default_registry,
)
from multihop_offload_tpu_torch.obs.slo import SLOEngine, default_serving_slos

_LabelKey = Tuple[Tuple[str, str], ...]

_SAMPLE_RE = re.compile(
    r'^(?P<name>[A-Za-z_:][A-Za-z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$'
)
_LABEL_RE = re.compile(r'(?P<k>[A-Za-z_][A-Za-z0-9_]*)="(?P<v>[^"]*)"')


def _parse_labels(raw: Optional[str]) -> _LabelKey:
    if not raw:
        return ()
    return tuple(sorted(
        (m.group("k"), m.group("v")) for m in _LABEL_RE.finditer(raw)
    ))


def parse_prometheus_text(text: str) -> Dict[str, dict]:
    """Reassemble an exposition into typed metric families.

    Returns {name: {"kind": kind, "series": {...}}}.  Counter/gauge series
    map label-key -> float.  Histogram series are re-assembled from their
    `_bucket`/`_sum`/`_count` sample lines into label-key ->
    {"buckets": [per-bucket counts, +Inf tail last], "sum": float,
    "count": int}, with the family carrying "boundaries" (the finite `le`
    edges) — exactly the shape `Histogram.observe_bucketed` merges."""
    kinds: Dict[str, str] = {}
    flat: Dict[str, Dict[_LabelKey, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                kinds[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        try:
            value = float(m.group("value").replace("+Inf", "inf"))
        except ValueError:
            continue
        flat.setdefault(m.group("name"), {})[
            _parse_labels(m.group("labels"))] = value

    out: Dict[str, dict] = {}
    for name, kind in kinds.items():
        if kind != "histogram":
            out[name] = {"kind": kind, "series": dict(flat.get(name, {}))}
            continue
        # histograms: decumulate _bucket lines grouped by their non-le labels
        series: Dict[_LabelKey, dict] = {}
        boundaries: List[float] = []
        cum: Dict[_LabelKey, List[Tuple[float, float]]] = {}
        for key, v in flat.get(f"{name}_bucket", {}).items():
            le = dict(key).get("le", "")
            base = tuple(kv for kv in key if kv[0] != "le")
            edge = float("inf") if le == "+Inf" else float(le)
            cum.setdefault(base, []).append((edge, v))
        for base, pairs in cum.items():
            pairs.sort()
            edges = [e for e, _ in pairs if e != float("inf")]
            if len(edges) > len(boundaries):
                boundaries = edges
            counts, prev = [], 0.0
            for _, c in pairs:
                counts.append(int(c - prev))
                prev = c
            series[base] = {
                "buckets": counts,
                "sum": flat.get(f"{name}_sum", {}).get(base, 0.0),
                "count": int(flat.get(f"{name}_count", {}).get(base, 0)),
            }
        out[name] = {"kind": kind, "series": series,
                     "boundaries": boundaries}
    return out


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 - http.server API
        body = self.server.render().encode()  # type: ignore[attr-defined]
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # silence per-request stderr noise
        pass


class MetricsEndpoint:
    """This process's scrape target: a daemon-thread stdlib HTTP server
    rendering the (default) registry's text exposition at every GET.
    Port 0 (the default) takes an OS-assigned port; `url` is what the
    coordinator scrapes."""

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 port: int = 0, host: str = "127.0.0.1"):
        reg = registry if registry is not None else default_registry()
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.render = reg.prometheus_text  # type: ignore[attr-defined]
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="mho-metrics", daemon=True
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._server.server_address[0]}:{self.port}/metrics"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


def _http_fetch(url: str, timeout_s: float) -> str:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return resp.read().decode()


class FleetFederation:
    """Scrape every host's endpoint, merge deltas under `host=` labels.

    `targets` maps host id -> scrape URL (or, for tests, a zero-arg
    callable returning exposition text).  The merged registry defaults to
    a PRIVATE one so fleet series never collide with this process's own
    serving metrics — pass `registry=` to merge elsewhere."""

    def __init__(self, targets: Dict[str, object],
                 registry: Optional[MetricRegistry] = None,
                 timeout_s: float = 2.0):
        self.targets = dict(targets)
        self.registry = registry if registry is not None else MetricRegistry()
        self.timeout_s = float(timeout_s)
        # last cumulative value per (host, metric, labelkey): delta base
        self._last: Dict[Tuple[str, str, _LabelKey], object] = {}

    def _fetch(self, target) -> str:
        if callable(target):
            return target()
        return _http_fetch(str(target), self.timeout_s)

    def scrape(self) -> Dict[str, bool]:
        """One federation pass.  Returns {host: scrape_ok}."""
        up = self.registry.gauge(
            "mho_mesh_host_up", "1 if the host's last scrape succeeded")
        fails = self.registry.counter(
            "mho_mesh_scrape_failures_total", "failed federation scrapes")
        ok: Dict[str, bool] = {}
        for host in sorted(self.targets):
            try:
                families = parse_prometheus_text(self._fetch(
                    self.targets[host]))
            except Exception:
                fails.inc(host=host)
                up.set(0.0, host=host)
                ok[host] = False
                continue  # last-known series stay merged
            self._merge(host, families)
            up.set(1.0, host=host)
            ok[host] = True
        return ok

    def _merge(self, host: str, families: Dict[str, dict]) -> None:
        for name, fam in sorted(families.items()):
            kind = fam["kind"]
            if kind == "counter":
                c = self.registry.counter(name)
                for key, v in fam["series"].items():
                    mark = (host, name, key)
                    prev = float(self._last.get(mark, 0.0))  # type: ignore[arg-type]
                    if v < prev:
                        prev = 0.0  # source restarted: treat as fresh
                    delta = v - prev
                    self._last[mark] = v
                    if delta > 0:
                        c.inc(delta, host=host, **dict(key))
            elif kind == "gauge":
                g = self.registry.gauge(name)
                for key, v in fam["series"].items():
                    g.set(v, host=host, **dict(key))
            elif kind == "histogram":
                boundaries = fam.get("boundaries") or []
                if not boundaries:
                    continue
                h = self.registry.histogram(name, buckets=boundaries)
                if tuple(h.buckets) != tuple(boundaries):
                    continue  # boundary clash with an existing family
                for key, s in fam["series"].items():
                    mark = (host, name, key)
                    prev = self._last.get(mark)
                    pb = list(prev["buckets"]) if prev else [0] * len(s["buckets"])  # type: ignore[index]
                    psum = float(prev["sum"]) if prev else 0.0  # type: ignore[index]
                    if s["count"] < (int(prev["count"]) if prev else 0):  # type: ignore[index]
                        pb, psum = [0] * len(s["buckets"]), 0.0
                    delta = [int(c) - int(p) for c, p in zip(s["buckets"], pb)]
                    self._last[mark] = s
                    if any(d > 0 for d in delta):
                        h.observe_bucketed(
                            delta, s["sum"] - psum, host=host, **dict(key))


def federated_slo_engine(
    federation: FleetFederation,
    specs: Optional[Sequence] = None,
    **engine_kw,
) -> SLOEngine:
    """The fleet-wide SLO view: the stock serving SLO specs (or `specs`)
    evaluated over the federation's merged registry — burn rates across
    every host's traffic at once, because the merged histograms/counters
    ARE the fleet totals."""
    return SLOEngine(
        list(specs) if specs is not None else default_serving_slos(),
        registry=federation.registry,
        **engine_kw,
    )
