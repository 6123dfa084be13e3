"""The reward ring behind the REINFORCE baseline, on the device.

Port of `multihop_offload_tpu/rl/buffer.py`.  The baseline is the mean of
the recently observed round rewards.  The ring and its counters stay on
the run's device as tensors, and pushing or reading the baseline never
syncs with the host, as in JAX, where the buffer rides the compiled step.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RLBuffer:
    rewards: torch.Tensor  # (capacity,) float32 ring of recent round rewards
    count: torch.Tensor    # () int32 filled slots
    ptr: torch.Tensor      # () int32 next write position


def buffer_init(capacity: int, device=None) -> RLBuffer:
    z = torch.zeros((), dtype=torch.int32, device=device)
    # reward statistics accumulate wide by design
    return RLBuffer(rewards=torch.zeros((capacity,), dtype=torch.float32, device=device),
                    count=z, ptr=z.clone())


def buffer_push(buf: RLBuffer, values: torch.Tensor) -> RLBuffer:
    """Append every element of `values` in order, deque(maxlen=capacity)
    semantics (oldest evicted first): the buffer that one push at a time
    leaves, in one scatter of the last `capacity` values.  Returns a new
    buffer."""
    capacity = buf.rewards.shape[0]
    v = values.reshape(-1).to(buf.rewards.dtype)
    n = v.shape[0]
    keep = min(n, capacity)  # only the last `capacity` pushes survive
    slots = (buf.ptr + (n - keep) + torch.arange(keep, device=v.device,
                                                  dtype=torch.int32)) % capacity
    rewards = buf.rewards.index_copy(0, slots.long(), v[n - keep:])
    return RLBuffer(rewards=rewards,
                    count=torch.clamp(buf.count + n, max=capacity).to(torch.int32),
                    ptr=((buf.ptr + n) % capacity).to(torch.int32))


def buffer_baseline(buf: RLBuffer) -> torch.Tensor:
    """Mean of the filled slots; 0 while empty (the first episodes train
    against a zero baseline, exactly REINFORCE without a critic)."""
    capacity = buf.rewards.shape[0]
    filled = torch.arange(capacity, device=buf.rewards.device) < buf.count
    total = torch.where(filled, buf.rewards, 0.0).sum()
    mean = total / torch.clamp(buf.count, min=1).to(buf.rewards.dtype)
    return torch.where(buf.count > 0, mean, torch.zeros((), dtype=buf.rewards.dtype,
                                                        device=buf.rewards.device))
