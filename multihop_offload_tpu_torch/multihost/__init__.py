"""Crossing the process boundary.

Port of `multihop_offload_tpu/multihost/`, three layers, each usable alone:

  * `runtime`    -- the process-group bring-up over `torch.distributed`
    (gloo, TCP rendezvous) with coordinator retry, timeout and backoff,
    and `all_reduce`, the sum a data mesh across processes reduces with;
  * `plan`       -- the two-level placement planner: buckets -> hosts
    (level 1, weights replicated per host), each bucket's batch -> devices
    within its host (level 2, `serve.placement`'s divisor ladder).  A
    bucket never spans two hosts;
  * `federation` -- cross-process metric and SLO federation: every process
    serves its Prometheus text on loopback, a coordinator-side scraper
    merges the registries under `host=` labels, so burn-rate SLOs see
    fleet-wide series.

`mho-mesh --smoke` (`cli/mesh.py`) drives all three over local processes.
"""

from multihop_offload_tpu_torch.multihost.federation import (  # noqa: F401
    FleetFederation,
    MetricsEndpoint,
    federated_slo_engine,
    parse_prometheus_text,
)
from multihop_offload_tpu_torch.multihost.plan import (  # noqa: F401
    TwoLevelPlan,
    TwoLevelPlanner,
    local_placement,
    plan_two_level,
    validate_plan,
)
from multihop_offload_tpu_torch.multihost.runtime import (  # noqa: F401
    MeshRuntime,
    all_reduce,
    bootstrap,
    init_distributed,
)

__all__ = [
    "FleetFederation",
    "MetricsEndpoint",
    "federated_slo_engine",
    "parse_prometheus_text",
    "TwoLevelPlan",
    "TwoLevelPlanner",
    "local_placement",
    "plan_two_level",
    "validate_plan",
    "MeshRuntime",
    "all_reduce",
    "bootstrap",
    "init_distributed",
]
