"""Process-wide metric registry: counters, gauges, histograms with labels.

Port of `multihop_offload_tpu/obs/registry.py` (standard library only; the
port keeps its own copy).  Every method holds the registry lock, so the
serving tick and a main thread may share it.  Snapshots are plain nested
dicts; `prometheus_text()` renders the standard text exposition.
`Histogram.observe_bucketed` takes the device-metric flush
(`obs/devmetrics.py`) and the federation's merge (`multihost/
federation.py`); `Histogram.le_total` feeds the SLO engine (`obs/slo.py`).
"""

from __future__ import annotations

import math
import os
import threading
import warnings
from typing import Dict, Iterable, List, Optional, Tuple

# latency-shaped default buckets (seconds), Prometheus-style, +Inf implicit
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0, 60.0,
)


def log_buckets(lo: float = 0.001, hi: float = 60.0,
                per_decade: int = 4) -> Tuple[float, ...]:
    """Log-spaced histogram boundaries, `per_decade` per decade, rounded to
    3 significant digits (stable text exposition).  Constant RELATIVE
    resolution: a p99 read out of these buckets has the same ~`10^(1/
    per_decade)` error bound whether the tail sits at ~1 ms or ~1 s —
    which a linear-ish ladder like `DEFAULT_BUCKETS` cannot give at both
    scales at once."""
    if not (0.0 < lo < hi):
        raise ValueError("need 0 < lo < hi")
    n = math.ceil(per_decade * math.log10(hi / lo))
    out = []
    for i in range(n + 1):
        b = float(f"{min(lo * 10.0 ** (i / per_decade), hi):.3g}")
        if not out or b > out[-1]:
            out.append(b)
    if out[-1] < hi:
        out.append(float(hi))
    return tuple(out)


# the serving-latency preset (`mho_serve_*` histograms): sub-ms queueing on
# a warm CPU host and multi-second degraded bursts land in the same metric
LATENCY_BUCKETS = log_buckets(0.001, 60.0, per_decade=4)

_LabelKey = Tuple[Tuple[str, str], ...]

# per-metric label-set (series) cap: devmetrics flushes stamp shard/bucket
# labels, and an unbounded label value (a request id, a device string that
# varies per restart) would grow the registry without limit.  Series beyond
# the cap are dropped with a one-time warning per metric and counted in
# `mho_registry_dropped_labelsets_total{metric=...}`.
DEFAULT_MAX_LABELSETS = 256
DROPPED_LABELSETS = "mho_registry_dropped_labelsets_total"


def max_labelsets() -> int:
    """Per-metric distinct-label-set cap (env `MHO_REGISTRY_MAX_LABELSETS`,
    default 256).  Read lazily so tests and operators can retune a live
    process; only consulted when a NEW series would be created."""
    try:
        return int(os.environ.get("MHO_REGISTRY_MAX_LABELSETS",
                                  DEFAULT_MAX_LABELSETS))
    except ValueError:
        return DEFAULT_MAX_LABELSETS


def _label_key(labels: Dict[str, object]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: _LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class _Metric:
    """Shared plumbing: every child series keyed by its sorted label set.

    All mutation goes through the owning registry's lock (`self._lock` IS
    the registry lock, one per process-wide registry)."""

    kind = "untyped"

    def __init__(self, name: str, help_: str, lock: threading.RLock,
                 registry: Optional["MetricRegistry"] = None):
        self.name = name
        self.help = help_
        self._lock = lock
        self._registry = registry
        self._series: Dict[_LabelKey, object] = {}
        self._warned_cap = False

    def _admit(self, key: _LabelKey) -> bool:
        """Cardinality gate, called under the lock before creating a NEW
        series.  Existing series always pass (updates are never lost to
        the cap — only unbounded growth is)."""
        if key in self._series or len(self._series) < max_labelsets():
            return True
        if not self._warned_cap:
            self._warned_cap = True
            warnings.warn(
                f"metric '{self.name}' reached the {max_labelsets()} "
                "label-set cap (MHO_REGISTRY_MAX_LABELSETS); further label "
                "combinations are dropped and counted in "
                f"{DROPPED_LABELSETS}",
                RuntimeWarning, stacklevel=3,
            )
        if self._registry is not None:
            self._registry._note_dropped_labelset(self.name)
        return False


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _label_key(labels)
        with self._lock:
            if not self._admit(key):
                return
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def total(self, **labels) -> float:
        """Sum over every label combination; with labels given, over every
        series whose label set CONTAINS them (subset match — what the SLO
        engine needs to read e.g. `{outcome="admitted"}` regardless of any
        other labels a series carries)."""
        want = set(_label_key(labels))
        with self._lock:
            if not want:
                return float(sum(self._series.values()))
            return float(sum(v for key, v in self._series.items()
                             if want <= set(key)))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            if not self._admit(key):
                return
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            if not self._admit(key):
                return
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> Optional[float]:
        with self._lock:
            v = self._series.get(_label_key(labels))
            return None if v is None else float(v)


class _HistSeries:
    __slots__ = ("count", "sum", "min", "max", "bucket_counts")

    def __init__(self, n_buckets: int):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.bucket_counts = [0] * (n_buckets + 1)  # +Inf tail bucket


class Histogram(_Metric):
    """Fixed-boundary histogram with exact count/sum/min/max per series.

    min/max are first-class (the `phase_stats` shim promises them); bucket
    counts are cumulative-rendered only at exposition time."""

    kind = "histogram"

    def __init__(self, name: str, help_: str, lock: threading.RLock,
                 buckets: Iterable[float] = DEFAULT_BUCKETS,
                 registry: Optional["MetricRegistry"] = None):
        super().__init__(name, help_, lock, registry=registry)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        v = float(value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                if not self._admit(key):
                    return
                s = self._series[key] = _HistSeries(len(self.buckets))
            s.count += 1
            s.sum += v
            s.min = min(s.min, v)
            s.max = max(s.max, v)
            for i, b in enumerate(self.buckets):
                if v <= b:
                    s.bucket_counts[i] += 1
                    break
            else:
                s.bucket_counts[-1] += 1

    def observe_bucketed(self, bucket_counts: List[int], sum_: float,
                         min_: Optional[float] = None,
                         max_: Optional[float] = None, **labels) -> None:
        """Merge a window of observations already bucketed (a device-side
        histogram flushed by `obs.devmetrics`): one count per boundary of
        this histogram plus the +Inf tail.  min/max are optional because
        an empty window has neither."""
        if len(bucket_counts) != len(self.buckets) + 1:
            raise ValueError(
                f"bucket mismatch: got {len(bucket_counts)} counts for "
                f"{len(self.buckets)} boundaries (+Inf tail) of '{self.name}'"
            )
        n = int(sum(bucket_counts))
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                if not self._admit(key):
                    return
                s = self._series[key] = _HistSeries(len(self.buckets))
            s.count += n
            s.sum += float(sum_)
            if n > 0 and min_ is not None:
                s.min = min(s.min, float(min_))
            if n > 0 and max_ is not None:
                s.max = max(s.max, float(max_))
            for i, c in enumerate(bucket_counts):
                s.bucket_counts[i] += int(c)

    def stats(self, **labels) -> Optional[dict]:
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None:
                return None
            return {
                "count": s.count, "total_s": s.sum,
                "mean_s": s.sum / max(s.count, 1),
                "min_s": s.min, "max_s": s.max,
            }

    def _merged_counts(self, labels: Optional[Dict[str, object]] = None):
        """Per-bucket counts summed over every label set (caller holds no
        lock; this takes it) — or, with `labels`, over every series whose
        label set CONTAINS them.  Last slot is the +Inf tail."""
        want = set(_label_key(labels)) if labels else set()
        merged = [0] * (len(self.buckets) + 1)
        with self._lock:
            for key, s in self._series.items():
                if want and not want <= set(key):
                    continue
                for i, c in enumerate(s.bucket_counts):
                    merged[i] += c
        return merged

    def le_total(self, le: float, **labels) -> Tuple[int, int]:
        """(observations <= le, total observations) across every label set,
        or the subset matching `labels` (per-shard SLO burn rates): the
        good/total pair the SLO engine samples.  `le` snaps down to the
        nearest bucket boundary (an observation that might exceed the
        objective never counts as good)."""
        merged = self._merged_counts(labels)
        good = 0
        for b, c in zip(self.buckets, merged):
            if b > float(le):
                break
            good += c
        return good, sum(merged)

    def quantile(self, q: float) -> Optional[float]:
        """Histogram-interpolated quantile over all label sets (linear
        within the containing bucket; the +Inf tail reports the max
        observed).  None before any observation."""
        merged = self._merged_counts()
        total = sum(merged)
        if total == 0:
            return None
        target = max(0.0, min(1.0, float(q))) * total
        cum = 0
        lo = 0.0
        for b, c in zip(self.buckets, merged):
            if cum + c >= target and c > 0:
                frac = (target - cum) / c
                return lo + frac * (b - lo)
            cum += c
            lo = b
        with self._lock:
            return max((s.max for s in self._series.values() if s.count),
                       default=None)


class MetricRegistry:
    """Named metric namespace; get-or-create accessors are idempotent and a
    kind clash (counter re-requested as gauge) fails loudly."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help_: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help_, self._lock,
                                              registry=self, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric '{name}' already registered as {m.kind}"
                )
            return m

    def _note_dropped_labelset(self, metric_name: str) -> None:
        """Account one label-set dropped by a metric's cardinality cap.
        The accounting counter never notes drops against itself — that
        would recurse when the process has more than the cap's worth of
        distinct capped metrics."""
        if metric_name == DROPPED_LABELSETS:
            return
        self.counter(
            DROPPED_LABELSETS,
            "label-sets dropped by the per-metric cardinality cap",
        ).inc(metric=metric_name)

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_, buckets=buckets)

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    # ---- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """Nested plain-dict view: {name: {kind, help, series: {labelstr:
        value-or-stats}}} — the form the run-log summary event embeds."""
        out = {}
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                series = {}
                for key, v in m._series.items():
                    if isinstance(v, _HistSeries):
                        series[_label_str(key) or ""] = {
                            "count": v.count, "sum": v.sum,
                            "min": (None if v.count == 0 else v.min),
                            "max": (None if v.count == 0 else v.max),
                        }
                    else:
                        series[_label_str(key) or ""] = v
                out[name] = {"kind": m.kind, "help": m.help, "series": series}
        return out

    def prometheus_text(self) -> str:
        """Standard Prometheus text exposition (histograms render cumulative
        `_bucket{le=...}` plus `_sum`/`_count`)."""
        lines = []
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
                for key in sorted(m._series):
                    v = m._series[key]
                    if isinstance(v, _HistSeries):
                        cum = 0
                        assert isinstance(m, Histogram)
                        for b, c in zip(m.buckets, v.bucket_counts):
                            cum += c
                            labels = key + (("le", repr(b)),)
                            lines.append(
                                f"{name}_bucket{_label_str(tuple(sorted(labels)))} {cum}"
                            )
                        cum += v.bucket_counts[-1]
                        inf = key + (("le", "+Inf"),)
                        lines.append(
                            f"{name}_bucket{_label_str(tuple(sorted(inf)))} {cum}"
                        )
                        lines.append(f"{name}_sum{_label_str(key)} {v.sum}")
                        lines.append(f"{name}_count{_label_str(key)} {v.count}")
                    else:
                        fv = float(v)
                        sv = repr(int(fv)) if fv == int(fv) else repr(fv)
                        lines.append(f"{name}{_label_str(key)} {sv}")
        return "\n".join(lines) + "\n"


_DEFAULT = MetricRegistry()


def registry() -> MetricRegistry:
    """The process-wide default registry every instrumented loop shares."""
    return _DEFAULT
