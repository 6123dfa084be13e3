"""Crossing the process boundary.

Port of `multihop_offload_tpu/multihost/`: `runtime`, the process-group
bring-up over `torch.distributed` (gloo, TCP rendezvous) with coordinator
retry, timeout and backoff.  The two-level planner (`plan`) and the metric
federation (`federation`) are not ported yet (ROADMAP.md Queue 1 item 7).
"""

from multihop_offload_tpu_torch.multihost.runtime import (  # noqa: F401
    MeshRuntime,
    bootstrap,
    init_distributed,
)

__all__ = ["MeshRuntime", "bootstrap", "init_distributed"]
