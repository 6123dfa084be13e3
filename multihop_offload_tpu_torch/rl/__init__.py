"""Closed-loop RL: the actor, the packet simulator and the learner.

Port of `multihop_offload_tpu/rl/`: rollouts are rounds of policy
decisions with the packet simulator's slots inside each round, batched over
a fleet of instances, differentiated with REINFORCE (through K2's backward
on the card) and updated with the repo's Keras-parity Adam.  See
`rl.rollout` for the episode, `rl.buffer` for the on-device baseline
memory and `rl.trainer` for the step, sharding, telemetry and checkpoint
interop.
"""

from multihop_offload_tpu_torch.rl.buffer import (
    RLBuffer,
    buffer_baseline,
    buffer_init,
    buffer_push,
)
from multihop_offload_tpu_torch.rl.rollout import (
    RolloutOut,
    RoundDeltas,
    reward_from_deltas,
    rollout,
    sample_offloads,
)
from multihop_offload_tpu_torch.rl.trainer import (
    RLStepOut,
    RLTrainer,
    delivered_ratio,
    make_eval,
    rl_devmetrics,
)

__all__ = [
    "RLBuffer",
    "RLStepOut",
    "RLTrainer",
    "RolloutOut",
    "RoundDeltas",
    "buffer_baseline",
    "buffer_init",
    "buffer_push",
    "delivered_ratio",
    "make_eval",
    "reward_from_deltas",
    "rl_devmetrics",
    "rollout",
    "sample_offloads",
]
