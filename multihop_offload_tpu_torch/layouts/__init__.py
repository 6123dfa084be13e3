"""Instance memory layouts: dense (N, N) matrices or padded edge lists.

Port of `multihop_offload_tpu/layouts/`.  `dense` stays the default and the
parity reference; `sparse` stores the extended and conflict adjacencies as
COO lists (`layouts.sparse`) and packs integer indices at int16.
"""

from multihop_offload_tpu_torch.layouts.policy import (  # noqa: F401
    LAYOUT_CHOICES,
    LayoutPolicy,
    resolve_layout,
)
