"""Compact integer storage (port of `multihop_offload_tpu/layouts/compact.py`).

The narrowest signed dtype a static range allows, guarded on the host:
int16 is the floor for anything used as an index, int8 for pure values.
Next-hop tables pack to int16 (node ids are < N <= 32767).
"""

from __future__ import annotations

import numpy as np
import torch

NEXT_HOP_DTYPE = torch.int16


def compact_index_dtype(max_value: int):
    """Narrowest signed numpy dtype holding [0, max_value], at least int16."""
    for dt in (np.int16, np.int32, np.int64):
        if int(max_value) <= np.iinfo(dt).max:
            return dt
    raise ValueError(f"index range {max_value} exceeds int64")


def compact_value_dtype(max_value: int):
    """Narrowest signed numpy dtype for pure value storage (int8 floor)."""
    for dt in (np.int8, np.int16, np.int32, np.int64):
        if int(max_value) <= np.iinfo(dt).max:
            return dt
    raise ValueError(f"value range {max_value} exceeds int64")


def pack_next_hop(next_hop: torch.Tensor) -> torch.Tensor:
    """(..., N, N) int next-hop table -> int16; exact for N <= 32768."""
    n = next_hop.shape[-1]
    if n - 1 > torch.iinfo(NEXT_HOP_DTYPE).max:
        raise ValueError(f"next_hop: node id {n - 1} overflows int16")
    return next_hop.to(NEXT_HOP_DTYPE)


def unpack_next_hop(next_hop: torch.Tensor) -> torch.Tensor:
    return next_hop.to(torch.int32)
