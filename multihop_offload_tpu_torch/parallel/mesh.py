"""Device meshes for the framework's two parallel axes.

Port of `multihop_offload_tpu/parallel/mesh.py`.  The axes (SURVEY.md
§2.8, §5.7):
  `data`  -- independent network instances (episodes): data parallelism,
            each shard's gradients averaged or gathered over the axis;
  `graph` -- rows of a single large graph's distance matrix: the min-plus
            APSP ring (`parallel.ring`), for beyond-paper-scale networks.

A `Mesh` is a (data, graph) grid of `torch.device`s driven by one process
(`parallel/collectives.py`).  It may name a device more than once, the
counterpart of the virtual CPU devices JAX's tests run on: `[cpu] * 4` in
the CPU tests, `[cuda:0] * 4` on one card, every shard's work then queued
on that device.  On a machine with four cards the same code runs over
`cuda:0..3`.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from multihop_offload_tpu_torch._records import slice_records
from multihop_offload_tpu_torch.multihost.runtime import (
    local_devices,
    process_count,
)


def canonical_device(device) -> torch.device:
    """`device` as a `torch.device`, a CUDA device without an index bound to
    the current one (so that it compares equal to its tensors' device)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A (data, graph) grid of devices: `devices` the object array of
    `torch.device`s, `shape` {axis name: size} (as `jax.sharding.Mesh`)."""

    def __init__(self, devices: np.ndarray, axis_names=("data", "graph")):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def data_devices(self) -> List[torch.device]:
        """The device of each data shard: the first of its graph row, where
        its per-episode work runs."""
        return list(self.devices[:, 0])

    def graph_devices(self, d: int) -> List[torch.device]:
        """Data shard `d`'s graph row: the devices its ring APSP spans."""
        return list(self.devices[d, :])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.ravel()]})"


def make_mesh(
    data: Optional[int] = None,
    graph: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Lay `devices` (default: every local CUDA device) out as a (data,
    graph) grid.  The list may repeat a device.

    A grid that does not fit the device count -- more cells than devices, or
    a `graph` axis larger than the fleet -- degrades to a 1-D `data` axis
    over every device with a warning instead of raising: callers sized for
    one fleet shape (a serving config moved between hosts, a card lost
    mid-run) keep a working mesh, they just lose the graph partition.  With
    no device given and no card present this raises: a mesh never falls
    back to the CPU on its own."""
    devices = [canonical_device(d) for d in
               (devices if devices is not None else local_devices())]
    if not devices:
        raise RuntimeError("make_mesh: no CUDA device; pass a device list "
                           "(e.g. [torch.device('cpu')] * 4) to run on the CPU")
    if data is None:
        data = len(devices) // graph
    if data * graph > len(devices) or data * graph == 0:
        warnings.warn(
            f"mesh {data}x{graph} needs {data * graph} devices, have "
            f"{len(devices)}; falling back to a 1-D data axis over all "
            f"{len(devices)}",
            RuntimeWarning,
            stacklevel=2,
        )
        data, graph = len(devices), 1
    grid = np.empty(data * graph, dtype=object)
    grid[:] = devices[: data * graph]
    return Mesh(grid.reshape(data, graph), axis_names=("data", "graph"))


def shard_batch(tree, devices: Sequence[torch.device]) -> list:
    """Split `tree`'s leading batch axis (a tensor, a record of tensors, or
    a dict of either) into one equal slice per device, each moved to its
    device."""
    n = len(devices)
    b = _leading(tree)
    if b % n:
        raise ValueError(f"batch of {b} does not split over {n} devices")
    per = b // n
    return [_to(slice_records(tree, i * per, (i + 1) * per), dev)
            for i, dev in enumerate(devices)]


def _leading(tree) -> int:
    if isinstance(tree, dict):
        return _leading(next(iter(tree.values())))
    if isinstance(tree, torch.Tensor):
        return tree.shape[0]
    return _leading(next(v for v in vars(tree).values()
                         if isinstance(v, torch.Tensor)))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: v.to(device) for k, v in tree.items()}
    return tree.to(device)


def global_batch(mesh: Mesh, tree, axis: str = "data") -> list:
    """This process's batch laid out over `axis`: one equal slice of the
    leading axis per index along it, on that index's first device (JAX
    assembles a global array from every process's local batch; in one
    process the local batch is the global one)."""
    if process_count() > 1:
        raise NotImplementedError(
            "global_batch across processes: a mesh spanning processes is not "
            "ported yet (ROADMAP.md Queue 1 item 7, cross-process meshes)")
    grid = mesh.devices if axis == mesh.axis_names[0] else mesh.devices.T
    return shard_batch(tree, list(grid[:, 0]))


# Process-group bring-up lives in `multihost.runtime`; re-exported for
# callers of parallel.mesh.init_distributed, as in the JAX package.
from multihop_offload_tpu_torch.multihost.runtime import init_distributed  # noqa: F401,E402
