"""Max sustained req/s at a fixed p99 SLO, by bisection over offered rate.

Port of `multihop_offload_tpu/loadgen/search.py`.  The headline serving
number:
"this service sustains R req/s with p99 time-in-system <= S seconds" — a
single figure that is honest about queueing, because each probe is an
OPEN-LOOP run (`loadgen.driver`) where overload shows up as drops and p99
blow-up instead of generator back-off.

`max_sustained_rate` takes a probe function (offered rate -> report),
brackets the knee by doubling from a known-good rate, then bisects.  Every
probe is recorded in the result, so a record shows the whole search path,
not just the answer."""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from multihop_offload_tpu_torch.loadgen.driver import OpenLoopReport


@dataclasses.dataclass
class SustainedRateResult:
    sustained_rps: float          # highest probed rate that met the SLO
    collapse_rps: Optional[float]  # lowest probed rate that failed it
    p99_slo_s: float
    max_drop_fraction: float
    probes: List[dict]            # every probe: rate + report summary

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def max_sustained_rate(
    probe: Callable[[float], OpenLoopReport],
    *,
    lo_rps: float,
    p99_slo_s: float,
    max_drop_fraction: float = 0.01,
    grow: float = 2.0,
    max_doublings: int = 8,
    iters: int = 8,
) -> SustainedRateResult:
    """Bisection with automatic bracketing.

    `lo_rps` is the starting guess.  If it fails the SLO outright, bisect
    downward in [~0, lo]; otherwise double until a rate fails (bounded by
    `max_doublings` — a service that never fails inside the bracket search
    reports the last PROVEN rate, with `collapse_rps=None`).  `iters`
    bisection steps then pin the knee to lo * 2^-iters relative width."""
    if lo_rps <= 0:
        raise ValueError("lo_rps must be positive")
    probes: List[dict] = []

    def run(rate: float) -> bool:
        rep = probe(rate)
        ok = rep.meets(p99_slo_s, max_drop_fraction)
        probes.append({
            "offered_rps": rate, "ok": ok, "p99_s": rep.p99_s,
            "drop_fraction": rep.drop_fraction, "drained": rep.drained,
            "served": rep.served, "offered": rep.offered,
        })
        return ok

    lo, hi = float(lo_rps), None
    if not run(lo):
        hi, lo = lo, lo / float(grow) ** max_doublings
        # walk down to a passing floor; an SLO unmet even there means the
        # service sustains ~nothing at this configuration
        while lo < hi and not run(lo):
            probes[-1]["bracket"] = "floor"
            new_lo = lo / float(grow)
            if new_lo < 1e-6:
                return SustainedRateResult(0.0, hi, p99_slo_s,
                                           max_drop_fraction, probes)
            lo = new_lo
    else:
        for _ in range(int(max_doublings)):
            candidate = lo * float(grow)
            if run(candidate):
                lo = candidate
            else:
                hi = candidate
                break
    if hi is None:
        return SustainedRateResult(lo, None, p99_slo_s,
                                   max_drop_fraction, probes)
    for _ in range(int(iters)):
        mid = 0.5 * (lo + hi)
        if run(mid):
            lo = mid
        else:
            hi = mid
    return SustainedRateResult(lo, hi, p99_slo_s, max_drop_fraction, probes)
