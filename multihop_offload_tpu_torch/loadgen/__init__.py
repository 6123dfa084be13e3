"""Open-loop traffic generation: the load model that can SEE collapse.

Port of `multihop_offload_tpu/loadgen/` (standard library only, as there:
the same arrival times for the same seed, bit for bit).

A closed-loop generator (submit, wait, submit again) self-throttles: when
the service saturates, the generator slows down with it, so offered load
tracks capacity by construction and queueing collapse is structurally
invisible — the one failure mode congestion-aware offloading exists to
avoid.  This package is the honest alternative:

  * `arrivals`  — seeded arrival processes (Poisson / MMPP, diurnal swing,
    flash-crowd bursts), deterministic per seed;
  * `driver`    — open-loop injection on a virtual clock: requests arrive
    when the process says they arrive, a refused submit is a DROP (never a
    retry), and offered-vs-served plus time-in-system are tracked so the
    knee is measurable;
  * `search`    — bisection over offered rate for the max sustained req/s
    at a fixed p99 time-in-system SLO: THE headline serving number.
"""

from multihop_offload_tpu_torch.loadgen.arrivals import (  # noqa: F401
    TrafficModel,
    arrival_times,
    poisson,
    rate_profile,
)
from multihop_offload_tpu_torch.loadgen.driver import (  # noqa: F401
    OpenLoopReport,
    VirtualClock,
    run_open_loop,
)
from multihop_offload_tpu_torch.loadgen.search import (  # noqa: F401
    SustainedRateResult,
    max_sustained_rate,
)

__all__ = [
    "TrafficModel",
    "arrival_times",
    "poisson",
    "OpenLoopReport",
    "VirtualClock",
    "run_open_loop",
    "SustainedRateResult",
    "max_sustained_rate",
]
