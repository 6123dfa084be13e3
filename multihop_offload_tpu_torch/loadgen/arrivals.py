"""Seeded arrival processes: Poisson / MMPP with diurnal swing and flashes.

One `TrafficModel` describes an inhomogeneous arrival intensity
lambda(t) as the product of independent factors:

    lambda(t) = base_rate
                * (1 + diurnal_amplitude * sin(2*pi*t / diurnal_period_s))
                * mmpp_state_factor(t)      # 1 or burst_factor
                * flash_factor(t)           # 1 or a flash's multiplier

and `arrival_times` samples it by Lewis thinning against the envelope
lambda_max: draw a homogeneous Poisson stream at lambda_max, keep each
candidate with probability lambda(t)/lambda_max.  The MMPP modulation is a
two-state Markov chain (slow/fast) whose dwell times are drawn from the
SAME seeded generator, so the whole stream — state path and arrivals — is
a pure function of (model, duration, seed).  Everything is stdlib
`random.Random`, no wall clock: the port draws the JAX package's arrival
times bit for bit (`multihop_offload_tpu/loadgen/arrivals.py`)."""

from __future__ import annotations

import dataclasses
import math
import random
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class TrafficModel:
    """Arrival-intensity description; all times in (virtual) seconds."""

    base_rate: float                       # mean req/s of the slow state
    diurnal_amplitude: float = 0.0         # 0 flat .. <1 full swing
    diurnal_period_s: float = 86400.0
    mmpp_burst_factor: float = 1.0         # fast-state multiplier; 1 = Poisson
    mmpp_dwell_slow_s: float = 60.0        # mean dwell in the slow state
    mmpp_dwell_fast_s: float = 10.0        # mean dwell in the fast state
    # (start_s, duration_s, multiplier) flash-crowd windows
    flashes: Tuple[Tuple[float, float, float], ...] = ()

    def __post_init__(self):
        if self.base_rate <= 0:
            raise ValueError("base_rate must be positive")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1)")
        if self.mmpp_burst_factor < 1.0:
            raise ValueError("mmpp_burst_factor must be >= 1")
        for start, dur, mult in self.flashes:
            if dur <= 0 or mult < 1.0:
                raise ValueError("flash windows need dur > 0 and mult >= 1")

    def at(self, rate: float) -> "TrafficModel":
        """The same shape at a different base rate — what the sustained-
        rate bisection scales."""
        return dataclasses.replace(self, base_rate=float(rate))

    def flash_factor(self, t: float) -> float:
        f = 1.0
        for start, dur, mult in self.flashes:
            if start <= t < start + dur:
                f = max(f, float(mult))
        return f

    def envelope_rate(self) -> float:
        """lambda_max: the thinning bound (every factor at its peak)."""
        flash_max = max([m for _, _, m in self.flashes], default=1.0)
        return (self.base_rate * (1.0 + self.diurnal_amplitude)
                * self.mmpp_burst_factor * flash_max)

    def rate_at(self, t: float, mmpp_fast: bool = False) -> float:
        diurnal = 1.0 + self.diurnal_amplitude * math.sin(
            2.0 * math.pi * t / self.diurnal_period_s)
        mmpp = self.mmpp_burst_factor if mmpp_fast else 1.0
        return self.base_rate * diurnal * mmpp * self.flash_factor(t)


def poisson(rate: float) -> TrafficModel:
    """Plain homogeneous Poisson at `rate` req/s."""
    return TrafficModel(base_rate=rate)


def _mmpp_state_path(
    model: TrafficModel, duration_s: float, rng: random.Random
) -> List[Tuple[float, bool]]:
    """(switch_time, fast?) segments covering [0, duration): the modulating
    chain, drawn before the arrivals so the stream stays reproducible."""
    if model.mmpp_burst_factor == 1.0:
        return [(0.0, False)]
    path, t, fast = [], 0.0, False
    while t < duration_s:
        path.append((t, fast))
        dwell = (model.mmpp_dwell_fast_s if fast
                 else model.mmpp_dwell_slow_s)
        t += rng.expovariate(1.0 / max(dwell, 1e-9))
        fast = not fast
    return path


def _fast_at(path: List[Tuple[float, bool]], t: float) -> bool:
    fast = False
    for start, f in path:
        if start > t:
            break
        fast = f
    return fast


def rate_profile(
    model: TrafficModel, duration_s: float, segments: int, seed: int,
    normalize: bool = True, samples_per_segment: int = 32,
) -> List[float]:
    """Per-segment mean intensity multipliers of lambda(t) over
    ``[0, duration_s)`` split into `segments` equal windows.

    The MMPP state path is drawn from the seeded generator exactly as
    `arrival_times` does, then each segment's mean of
    ``rate_at(t) / base_rate`` is estimated on an even time grid — the
    bridge from the continuous-time model to the simulator's per-segment
    Bernoulli arrival probabilities (`scenarios.matrix` scales
    ``SimParams.arr_p`` by these factors segment by segment).  With
    `normalize=True` the multipliers are rescaled to mean 1, so a workload
    pinned to a target utilization keeps that utilization as its horizon
    MEAN while the shape (bursts, flashes, diurnal swing) moves around it.
    Deterministic per (model, duration, segments, seed)."""
    if duration_s <= 0 or segments < 1:
        raise ValueError("need duration_s > 0 and segments >= 1")
    rng = random.Random(int(seed))  # nondet-ok(explicitly seeded, same contract as arrival_times)
    path = _mmpp_state_path(model, duration_s, rng)
    seg_len = duration_s / segments
    mults = []
    for k in range(segments):
        acc = 0.0
        for i in range(samples_per_segment):
            t = (k + (i + 0.5) / samples_per_segment) * seg_len
            acc += model.rate_at(t, _fast_at(path, t)) / model.base_rate
        mults.append(acc / samples_per_segment)
    if normalize:
        mean = sum(mults) / len(mults)
        if mean > 0:
            mults = [m / mean for m in mults]
    return mults


def arrival_times(
    model: TrafficModel, duration_s: float, seed: int
) -> List[float]:
    """Sorted arrival timestamps in [0, duration_s), deterministic per
    (model, duration, seed) — Lewis thinning against `envelope_rate`."""
    if duration_s <= 0:
        return []
    rng = random.Random(int(seed))  # nondet-ok(explicitly seeded; stdlib Random keeps loadgen import-light)
    path = _mmpp_state_path(model, duration_s, rng)
    lam_max = model.envelope_rate()
    out: List[float] = []
    t = 0.0
    while True:
        t += rng.expovariate(lam_max)
        if t >= duration_s:
            return out
        accept = model.rate_at(t, _fast_at(path, t)) / lam_max
        if rng.random() < accept:
            out.append(t)
