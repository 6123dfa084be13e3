"""The layout knob (port of `multihop_offload_tpu/layouts/policy.py`).

`layout` is a string (dense | sparse | auto) resolved once, before any
work, into a frozen `LayoutPolicy`.  The JAX package resolves `auto` to
`sparse` only on a TPU backend (`layouts/policy.py:57-60`); the port runs
on CUDA or the CPU, so `auto` is `dense` here.  The default stays `dense`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LAYOUT_CHOICES = ("dense", "sparse", "auto")


@dataclasses.dataclass(frozen=True)
class LayoutPolicy:
    name: str  # "dense" | "sparse"

    @property
    def sparse(self) -> bool:
        return self.name == "sparse"

    @property
    def index_dtype(self):
        """Storage dtype of the packed index vectors (jobs' src,
        link_index): int16 under the sparse layout, int32 under dense."""
        return np.int16 if self.sparse else np.int32


DENSE = LayoutPolicy("dense")
SPARSE = LayoutPolicy("sparse")


def resolve_layout(layout=None) -> LayoutPolicy:
    """str | LayoutPolicy | None -> LayoutPolicy.  None means dense."""
    if layout is None:
        return DENSE
    if isinstance(layout, LayoutPolicy):
        return layout
    if layout not in LAYOUT_CHOICES:
        raise ValueError(f"layout must be one of {LAYOUT_CHOICES}, got '{layout}'")
    return SPARSE if layout == "sparse" else DENSE
