"""The padded COO record of the sparse layout.

Port of `multihop_offload_tpu/ops/sparse.py:COO`: an (n, n) matrix as
padded (row, col, val) lists of a static length nnz_pad.  Padding entries
are (row=0, col=0, val=0), inert under every segment reduction of the
sparse layout.  With the batch axis B the lists are (B, nnz_pad).
"""

from __future__ import annotations

import dataclasses

import torch

from multihop_offload_tpu_torch._records import TensorRecord


@dataclasses.dataclass
class COO(TensorRecord):
    rows: torch.Tensor  # (..., nnz_pad) int32
    cols: torch.Tensor  # (..., nnz_pad) int32
    vals: torch.Tensor  # (..., nnz_pad) float
    shape: tuple        # static logical (n, n)
