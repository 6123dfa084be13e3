"""Drift detection over the captured-experience stream.

Port of `multihop_offload_tpu/obs/drift.py` (standard library only).

The continual-learning flywheel's missing signal (ROADMAP "harden the
flywheel under real drift"): instead of refitting on a fixed cadence, watch
the distribution of what the service is actually seeing and serving, and
enter a capture/refit cycle only when it moves.  Detectors here consume the
same ``outcome`` events the refit trains on (`loop.experience`), extracting
three features per outcome:

    tau           mean per-job delay of the decision taken (load proxy)
    offload_frac  1 - mean(is_local): how much work leaves the source node
    arrival_rate  sum of the request's per-job arrival rates (traffic mix)

Two detector families, both sequential and O(1) per sample:

- `PageHinkley`: the classic two-sided CUSUM-style test.  Each stream is
  standardized against a frozen warmup window (first `min_samples` values),
  then the cumulative deviation above/below the warmup mean (minus a drift
  allowance `delta` per step) is compared against `threshold`.  A genuine
  mean shift of s sigmas trips after ~threshold/(s - delta) samples; a
  stationary stream's accumulator hovers near its running extremum.
- `EWMADetector`: an EWMA control chart -- exponentially weighted mean and
  variance, trip after `patience` consecutive samples outside mean +/- k*std.
  Catches slow ramps PH's fixed warmup baseline can under-weight.

`DriftMonitor` fans one outcome into all detectors, latches trips (one
``drift`` event + `mho_drift_trips_total` per signal, re-armed only by
`reset`), and hands the trip dict to the caller -- `cli.loop` wires it into
`loop.promote.PromotionController.drift_triggered`, the capture transition
that replaces the fixed-cadence-only entry.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

from multihop_offload_tpu_torch.obs import events as obs_events
from multihop_offload_tpu_torch.obs.registry import registry as obs_registry


class PageHinkley:
    """Two-sided Page-Hinkley test on a warmup-standardized stream."""

    kind = "page_hinkley"

    def __init__(self, delta: float = 0.2, threshold: float = 12.0,
                 min_samples: int = 16):
        if min_samples < 2:
            raise ValueError("min_samples must be >= 2 (needs a variance)")
        self.delta = float(delta)
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.tripped = False
        self._warm: List[float] = []
        self._mu = 0.0
        self._sigma = 1.0
        # cumulative deviations and their running extrema (up = mean rose)
        self._m_up = 0.0
        self._min_up = 0.0
        self._m_dn = 0.0
        self._max_dn = 0.0
        self.stat = 0.0

    def _freeze_warmup(self) -> None:
        mu = sum(self._warm) / len(self._warm)
        var = sum((x - mu) ** 2 for x in self._warm) / max(len(self._warm) - 1, 1)
        self._mu = mu
        # floor keeps a constant warmup stream usable: any later change is
        # then an (effectively) infinite-sigma excursion, which is correct
        self._sigma = max(math.sqrt(var), 1e-9)

    def update(self, x: float) -> bool:
        """Feed one sample; returns True exactly once, on the trip."""
        if self.tripped:
            return False
        self.n += 1
        if self.n <= self.min_samples:
            self._warm.append(float(x))
            if self.n == self.min_samples:
                self._freeze_warmup()
            return False
        z = (float(x) - self._mu) / self._sigma
        self._m_up += z - self.delta
        self._min_up = min(self._min_up, self._m_up)
        self._m_dn += z + self.delta
        self._max_dn = max(self._max_dn, self._m_dn)
        self.stat = max(self._m_up - self._min_up, self._max_dn - self._m_dn)
        if self.stat > self.threshold:
            self.tripped = True
            return True
        return False


class EWMADetector:
    """EWMA control chart: trip on `patience` consecutive out-of-band samples."""

    kind = "ewma"

    def __init__(self, alpha: float = 0.1, k: float = 4.0,
                 min_samples: int = 16, patience: int = 3):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = float(alpha)
        self.k = float(k)
        self.min_samples = int(min_samples)
        self.patience = int(patience)
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.tripped = False
        self._warm: List[float] = []
        self._mean = 0.0
        self._var = 0.0
        self._streak = 0
        self.stat = 0.0

    def update(self, x: float) -> bool:
        if self.tripped:
            return False
        self.n += 1
        v = float(x)
        if self.n <= self.min_samples:
            self._warm.append(v)
            if self.n == self.min_samples:
                mu = sum(self._warm) / len(self._warm)
                var = sum((w - mu) ** 2 for w in self._warm) \
                    / max(len(self._warm) - 1, 1)
                self._mean, self._var = mu, var
            return False
        sigma = max(math.sqrt(self._var), 1e-9)
        self.stat = abs(v - self._mean) / sigma
        out_of_band = self.stat > self.k
        # the band check runs BEFORE the smoothed stats absorb the sample —
        # otherwise a fast alpha chases the shift and never trips
        d = v - self._mean
        self._mean += self.alpha * d
        self._var = (1.0 - self.alpha) * (self._var + self.alpha * d * d)
        self._streak = self._streak + 1 if out_of_band else 0
        if self._streak >= self.patience:
            self.tripped = True
            return True
        return False


def outcome_features(o) -> Dict[str, float]:
    """The monitored features of one outcome (`loop.experience.Outcome` or
    the raw "outcome" event dict)."""
    if isinstance(o, dict):
        is_local = o.get("is_local") or []
        job_rate = o.get("job_rate") or []
        tau = float(o.get("tau", 0.0))
    else:
        is_local = list(o.is_local)
        job_rate = list(o.request.job_rate)
        tau = float(o.tau)
    n = max(len(is_local), 1)
    return {
        "tau": tau,
        "offload_frac": 1.0 - sum(bool(b) for b in is_local) / n,
        "arrival_rate": float(sum(float(r) for r in job_rate)),
    }


class DriftMonitor:
    """Fan captured outcomes into per-feature change detectors.

    Trips latch (a tripped detector stays tripped until `reset`), are
    recorded as ``drift`` events / `mho_drift_trips_total{signal=}` /
    the `mho_drift_tripped{signal=}` gauge, and are returned to the caller
    as dicts ready for `PromotionController.drift_triggered`."""

    def __init__(self, detectors: Optional[Dict[str, object]] = None,
                 min_samples: int = 16):
        self.detectors = detectors if detectors is not None else {
            "tau": PageHinkley(min_samples=min_samples),
            "arrival_rate": PageHinkley(min_samples=min_samples),
            "offload_frac": EWMADetector(min_samples=min_samples),
        }
        self.samples = 0
        self.trips: List[dict] = []

    def update(self, outcome) -> List[dict]:
        """Feed one outcome; returns the trips it caused (usually [])."""
        self.samples += 1
        feats = outcome_features(outcome)
        new: List[dict] = []
        for signal, det in self.detectors.items():
            if signal not in feats or det.tripped:
                continue
            if det.update(feats[signal]):
                trip = {
                    "signal": signal,
                    "detector": det.kind,
                    "samples": det.n,
                    "value": round(feats[signal], 6),
                    "stat": round(float(det.stat), 4),
                }
                self.trips.append(trip)
                new.append(trip)
                obs_registry().counter(
                    "mho_drift_trips_total", "drift-detector trips by signal"
                ).inc(signal=signal)
                obs_registry().gauge(
                    "mho_drift_tripped", "1 while a signal's detector is tripped"
                ).set(1, signal=signal)
                obs_events.emit("drift", **trip)
        return new

    def feed(self, outcomes: Iterable) -> List[dict]:
        """Feed a batch of outcomes in order; returns all new trips."""
        new: List[dict] = []
        for o in outcomes:
            new.extend(self.update(o))
        return new

    def reset(self) -> None:
        """Re-arm every detector (post-refit: the new policy defines a new
        baseline) without forgetting the trip history."""
        for signal, det in self.detectors.items():
            det.reset()
            obs_registry().gauge(
                "mho_drift_tripped", "1 while a signal's detector is tripped"
            ).set(0, signal=signal)
