"""Deterministic fault injection for the serve -> loop -> promote stack.

Port of `multihop_offload_tpu/chaos/`: `faults`, the named fault sites the
production code calls (`crashpoint()` / `io_gate()`, one dict lookup when
no plan is armed) and the seeded corruption helpers.  The drill matrix
(`chaos/drills.py`, `chaos/fuzz.py`) and their CLIs are not ported yet
(ROADMAP.md Queue 1 item 9).
"""

from multihop_offload_tpu_torch.chaos.faults import (  # noqa: F401
    FaultPlan,
    SimulatedCrash,
    TransientIOError,
    active_plan,
    clear,
    crashpoint,
    install,
    io_gate,
)
