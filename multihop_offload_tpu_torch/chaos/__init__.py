"""Deterministic fault injection for the serve -> loop -> promote stack.

Port of `multihop_offload_tpu/chaos/`: `faults`, the named fault sites the
production code calls (`crashpoint()` / `io_gate()`, one dict lookup when
no plan is armed) and the seeded corruption helpers; `drills`, the drill
matrix over one service (`cli/chaos.py`, `mho-chaos`); and `fuzz`, the
input-fuzzing smoke over the admission guards (`cli/fuzz.py`,
`mho-fuzz`).
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
