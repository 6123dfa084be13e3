"""Declarative SLOs evaluated as multi-window burn rates over the registry.

Port of `multihop_offload_tpu/obs/slo.py`: for the same registry contents
and the same clock, the same burn rates and alerts.  An `SLOSpec` names an
objective ("99% of requests answered within the latency bound") and how to
read its good/total pair out of the live metric registry; the `SLOEngine`
samples every spec on each `observe(now)` call (the serving tick drives
it), keeps a short series of cumulative (good, total) pairs per spec, and
evaluates the multi-window burn-rate rule:

    error_rate(window) = 1 - dgood/dtotal          over the window
    burn(window)       = error_rate / (1 - objective)
    FIRING  iff  burn(short) > threshold  AND  burn(long) > threshold

The short window lets an alert reset soon after the condition clears, the
long one keeps a single bad tick from firing it.  `burn == 1` spends the
error budget at exactly the rate that exhausts it by the end of the SLO
period; the default threshold 1.0 fires on anything worse.

Spec kinds (what `_sample` reads):

    histogram_le   good = histogram observations <= `le` (snapped down to a
                   bucket boundary), total = all observations
    ratio          good = counter `metric` (label-filtered), total =
                   counter `total_metric` (label-filtered)
    gauge_max      each observe() adds total += 1 and good += 1 iff the
                   gauge is <= `bound` (queue depth)
    gauge_min      the mirror: good += 1 iff the worst series is >= `bound`
                   (an unset gauge is good)
    counter_zero   total += 1 per observe, good += 1 iff the counter did
                   not move since the previous observe

The default set keeps JAX's `zero_unexpected_retraces` spec over
`jax_unexpected_retraces_total`; the port compiles nothing, so no code of
it writes that counter and the spec stays good.  State transitions emit
typed ``alert`` events (state="firing"/"resolved"), keep
`mho_alert_active{slo=}` and `mho_slo_burn_rate{slo=,window=}` up to date,
and call the registered breach callbacks (where the flight recorder dumps
its ring).  Timestamps are passed into `observe`, never read from a clock.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from multihop_offload_tpu_torch.obs import events as obs_events
from multihop_offload_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    registry as _default_registry,
)

KINDS = ("histogram_le", "ratio", "gauge_max", "gauge_min", "counter_zero")

_LabelPairs = Tuple[Tuple[str, str], ...]


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective over registry metrics (see module doc)."""

    name: str
    kind: str
    metric: str
    objective: float                      # target good fraction in (0, 1]
    le: float = 0.0                       # histogram_le: the latency bound
    bound: float = 0.0                    # gauge_max: ceiling / gauge_min: floor
    total_metric: str = ""                # ratio: denominator counter
    labels: _LabelPairs = ()              # ratio: numerator label filter;
    #                                       histogram_le: series filter
    #                                       (per-shard burn rates)
    total_labels: _LabelPairs = ()        # ratio: denominator label filter
    description: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown SLO kind '{self.kind}'; one of {KINDS}")
        if not 0.0 < self.objective <= 1.0:
            raise ValueError("objective must be in (0, 1]")

    @property
    def budget(self) -> float:
        """Allowed error fraction; floored so objective=1.0 ("never") makes
        any error an (effectively) infinite burn instead of a div-by-zero."""
        return max(1.0 - self.objective, 1e-9)


def default_serving_slos(
    latency_le: float = 0.25,
    latency_objective: float = 0.99,
    delivered_objective: float = 0.95,
    admit_objective: float = 0.90,
    queue_bound: float = 48.0,
    queue_objective: float = 0.99,
    mfu_floor: float = 0.0,
    mfu_objective: float = 0.95,
) -> List[SLOSpec]:
    """The serving SLO set: p99 tick latency, delivered ratio, drop rate,
    queue depth, the zero-unexpected-retrace invariant (no writer in the
    port) and the non-finite sentinel.  `mfu_floor` > 0 adds `serve_mfu`
    over the `mho_program_mfu` gauges `obs.prof` sets (off by default, as
    in JAX)."""
    specs = [
        SLOSpec(
            "serve_p99", "histogram_le", "mho_serve_latency_seconds",
            objective=latency_objective, le=latency_le,
            description=f"p99 queue+serve latency <= {latency_le}s",
        ),
        SLOSpec(
            "serve_delivered", "ratio", "mho_serve_served_total",
            objective=delivered_objective,
            total_metric="mho_serve_submits_total",
            total_labels=(("outcome", "admitted"),),
            description="admitted requests answered (delivered ratio)",
        ),
        SLOSpec(
            "serve_drops", "ratio", "mho_serve_submits_total",
            objective=admit_objective,
            labels=(("outcome", "admitted"),),
            total_metric="mho_serve_submits_total",
            description="submits admitted (1 - drop rate)",
        ),
        SLOSpec(
            "serve_queue", "gauge_max", "mho_serve_queue_depth",
            objective=queue_objective, bound=queue_bound,
            description=f"queue depth <= {queue_bound:g}",
        ),
        SLOSpec(
            "zero_unexpected_retraces", "counter_zero",
            "jax_unexpected_retraces_total", objective=1.0,
            description="no recompiles after steady state",
        ),
        # fed by the device-side sentinel (`serve.executor.observe_decisions`):
        # any live decision slot coming back NaN/Inf breaches immediately,
        # and the breach callback snapshots the flight recorder
        SLOSpec(
            "serve_nonfinite", "counter_zero",
            "mho_dev_serve_nonfinite_total", objective=1.0,
            description="no non-finite decision outputs",
        ),
    ]
    if mfu_floor > 0.0:
        specs.append(SLOSpec(
            "serve_mfu", "gauge_min", "mho_program_mfu",
            objective=mfu_objective, bound=mfu_floor,
            description=f"per-program MFU >= {mfu_floor:g}",
        ))
    return specs


def sharded_serving_slos(
    shards: Sequence[str],
    latency_le: float = 0.25,
    latency_objective: float = 0.99,
) -> List[SLOSpec]:
    """Per-shard p99 latency objectives over the same
    `mho_serve_latency_seconds` histogram the fleet-wide `serve_p99` reads:
    the sharded service labels every response's latency observation with
    `shard=` (the fleet index of the device that computed its slot), and
    each spec here filters to one shard's series, so a single wedged device
    burns its own budget and fires its own alert while healthy shards stay
    green.  `shards` are the label values to watch, normally the fleet
    indices as strings."""
    return [
        SLOSpec(
            f"serve_p99_shard{s}", "histogram_le", "mho_serve_latency_seconds",
            objective=latency_objective, le=latency_le,
            labels=(("shard", str(s)),),
            description=(f"p99 queue+serve latency <= {latency_le}s "
                         f"on shard {s}"),
        )
        for s in shards
    ]


class _Series:
    """Per-spec cumulative (ts, good, total) samples plus alert state."""

    __slots__ = ("samples", "firing", "since", "last_counter",
                 "synth_good", "synth_total", "burn_short", "burn_long")

    def __init__(self):
        self.samples: deque = deque()
        self.firing = False
        self.since: Optional[float] = None
        self.last_counter: Optional[float] = None
        self.synth_good = 0       # gauge_max / counter_zero cumulative pair
        self.synth_total = 0
        self.burn_short = 0.0
        self.burn_long = 0.0


class SLOEngine:
    """Sample -> evaluate -> alert, one pass per `observe(now)`."""

    def __init__(
        self,
        specs: Sequence[SLOSpec],
        registry: Optional[MetricRegistry] = None,
        short_s: float = 60.0,
        long_s: float = 300.0,
        burn_threshold: float = 1.0,
    ):
        if short_s <= 0 or long_s < short_s:
            raise ValueError("need 0 < short_s <= long_s")
        self.specs = list(specs)
        self.registry = registry if registry is not None else _default_registry()
        self.short_s = float(short_s)
        self.long_s = float(long_s)
        self.burn_threshold = float(burn_threshold)
        self._series: Dict[str, _Series] = {s.name: _Series() for s in self.specs}
        self._breach_cbs: List[Callable[[SLOSpec, dict], None]] = []
        for s in self.specs:
            self._alert_gauge().set(0, slo=s.name)

    def _alert_gauge(self) -> Gauge:
        return self.registry.gauge(
            "mho_alert_active", "1 while the named SLO alert is firing"
        )

    def on_breach(self, cb: Callable[[SLOSpec, dict], None]) -> None:
        """Register a callback invoked once per ok->firing transition
        (the flight recorder's dump hook)."""
        self._breach_cbs.append(cb)

    # ---- sampling ----------------------------------------------------------

    def _counter_total(self, name: str, labels: _LabelPairs) -> float:
        m = self.registry._metrics.get(name)
        if not isinstance(m, Counter):
            return 0.0
        return m.total(**dict(labels))

    def _sample(self, spec: SLOSpec, st: _Series) -> Tuple[float, float]:
        """Cumulative (good, total) for one spec, monotone across calls."""
        if spec.kind == "histogram_le":
            m = self.registry._metrics.get(spec.metric)
            if not isinstance(m, Histogram):
                return 0.0, 0.0
            good, total = m.le_total(spec.le, **dict(spec.labels))
            return float(good), float(total)
        if spec.kind == "ratio":
            return (
                self._counter_total(spec.metric, spec.labels),
                self._counter_total(spec.total_metric, spec.total_labels),
            )
        if spec.kind == "gauge_max":
            m = self.registry._metrics.get(spec.metric)
            v = m.value() if isinstance(m, Gauge) else None
            st.synth_total += 1
            st.synth_good += int(v is None or float(v) <= spec.bound)
            return float(st.synth_good), float(st.synth_total)
        if spec.kind == "gauge_min":
            # worst (minimum) value across every label set: any one
            # program falling under the floor is a bad sample; no data at
            # all is good (an idle service is not a utilization breach)
            m = self.registry._metrics.get(spec.metric)
            v = None
            if isinstance(m, Gauge):
                with m._lock:
                    vals = [float(x) for x in m._series.values()]
                v = min(vals) if vals else None
            st.synth_total += 1
            st.synth_good += int(v is None or v >= spec.bound)
            return float(st.synth_good), float(st.synth_total)
        # counter_zero: good sample iff the counter did not move
        cur = self._counter_total(spec.metric, ())
        moved = st.last_counter is not None and cur > st.last_counter
        st.last_counter = cur
        st.synth_total += 1
        st.synth_good += int(not moved)
        return float(st.synth_good), float(st.synth_total)

    # ---- burn-rate math ----------------------------------------------------

    @staticmethod
    def _window_error(samples, now: float, window: float) -> float:
        """Error rate over [now - window, now] from cumulative samples:
        baseline = newest sample at or before the window start (falling
        back to the oldest retained), head = newest sample."""
        if len(samples) < 2:
            return 0.0
        head = samples[-1]
        base = samples[0]
        cutoff = now - window
        for s in samples:
            if s[0] <= cutoff:
                base = s
            else:
                break
        d_total = head[2] - base[2]
        if d_total <= 0:
            return 0.0
        d_good = head[1] - base[1]
        return min(max(1.0 - d_good / d_total, 0.0), 1.0)

    def burn_rates(self, spec_name: str, now: float) -> Tuple[float, float]:
        spec = next(s for s in self.specs if s.name == spec_name)
        st = self._series[spec_name]
        return (
            self._window_error(st.samples, now, self.short_s) / spec.budget,
            self._window_error(st.samples, now, self.long_s) / spec.budget,
        )

    # ---- the tick hook -----------------------------------------------------

    def observe(self, now: float) -> List[dict]:
        """Sample every spec at time `now`, evaluate, emit transitions.
        Returns the alert transitions this pass produced (usually [])."""
        now = float(now)
        transitions: List[dict] = []
        burn_gauge = self.registry.gauge(
            "mho_slo_burn_rate", "error-budget burn rate per SLO and window"
        )
        for spec in self.specs:
            st = self._series[spec.name]
            good, total = self._sample(spec, st)
            st.samples.append((now, good, total))
            horizon = now - 2.0 * self.long_s
            while len(st.samples) > 2 and st.samples[1][0] <= horizon:
                st.samples.popleft()
            short, long_ = self.burn_rates(spec.name, now)
            st.burn_short, st.burn_long = short, long_
            burn_gauge.set(round(short, 4), slo=spec.name, window="short")
            burn_gauge.set(round(long_, 4), slo=spec.name, window="long")
            breaching = (short > self.burn_threshold
                         and long_ > self.burn_threshold)
            if breaching and not st.firing:
                st.firing, st.since = True, now
                info = self._alert_info(spec, st, now, "firing")
                transitions.append(info)
                self._alert_gauge().set(1, slo=spec.name)
                self.registry.counter(
                    "mho_alerts_total", "SLO alert transitions"
                ).inc(slo=spec.name, state="firing")
                obs_events.emit("alert", **info)
                for cb in self._breach_cbs:
                    cb(spec, info)
            elif st.firing and not breaching:
                st.firing = False
                info = self._alert_info(spec, st, now, "resolved")
                st.since = None
                transitions.append(info)
                self._alert_gauge().set(0, slo=spec.name)
                self.registry.counter(
                    "mho_alerts_total", "SLO alert transitions"
                ).inc(slo=spec.name, state="resolved")
                obs_events.emit("alert", **info)
        return transitions

    def _alert_info(self, spec: SLOSpec, st: _Series, now: float,
                    state: str) -> dict:
        return {
            "name": spec.name,
            "state": state,
            "at": round(now, 6),
            "since": None if st.since is None else round(st.since, 6),
            "burn_short": round(st.burn_short, 4),
            "burn_long": round(st.burn_long, 4),
            "objective": spec.objective,
            "window_short_s": self.short_s,
            "window_long_s": self.long_s,
            "description": spec.description,
        }

    def state(self) -> dict:
        """Current per-spec alert state (the flight bundle / smoke record
        embeds this)."""
        return {
            spec.name: {
                "state": "firing" if st.firing else "ok",
                "since": st.since,
                "burn_short": round(st.burn_short, 4),
                "burn_long": round(st.burn_long, 4),
                "objective": spec.objective,
            }
            for spec in self.specs
            for st in (self._series[spec.name],)
        }
