"""Device meshes for the framework's two parallel axes.

Port of `multihop_offload_tpu/parallel/mesh.py`.  The axes (SURVEY.md
§2.8, §5.7):
  `data`  -- independent network instances (episodes): data parallelism,
            each shard's gradients averaged or gathered over the axis;
  `graph` -- rows of a single large graph's distance matrix: the min-plus
            APSP ring (`parallel.ring`), for beyond-paper-scale networks.

A `Mesh` is a (data, graph) grid of `torch.device`s.  Within a process
one host thread drives its devices (`parallel/collectives.py`).  It may
name a device more than once, the counterpart of the virtual CPU devices
JAX's tests run on: `[cpu] * 4` in the CPU tests, `[cuda:0] * 4` on one
card, every shard's work then queued on that device.  On a machine with
four cards the same code runs over `cuda:0..3`.

A mesh may span the processes of a `torch.distributed` group
(`make_mesh(..., runtime=)`, the runtime of `multihost.runtime.bootstrap`):
its grid is every process's devices in process order, each cell owned by
one process, and a graph row never crosses processes.  A process drives
only the data rows it owns (`data_devices()`); `global_batch` lays its
local batch over them, and the data-parallel step reduces across
processes through `multihost.runtime.all_reduce`.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from multihop_offload_tpu_torch._records import slice_records
from multihop_offload_tpu_torch.multihost.runtime import exchange, local_devices


def canonical_device(device) -> torch.device:
    """`device` as a `torch.device`, a CUDA device without an index bound to
    the current one (so that it compares equal to its tensors' device)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A (data, graph) grid of devices: `devices` the object array of
    `torch.device`s, `shape` {axis name: size} (as `jax.sharding.Mesh`).
    `owners` (same shape) names the process that owns each cell, and
    `process` this process's index; by default every cell is this one's."""

    def __init__(self, devices: np.ndarray, axis_names=("data", "graph"),
                 owners: Optional[np.ndarray] = None, process: int = 0):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process = int(process)
        self.owners = (np.full(devices.shape, self.process, dtype=np.int64)
                       if owners is None else np.asarray(owners, dtype=np.int64))
        if (self.owners != self.owners[:, :1]).any():
            raise ValueError("a graph row of the mesh spans processes; make the "
                             "graph axis fit one process's devices")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def spans_processes(self) -> bool:
        return bool((self.owners != self.process).any())

    @property
    def local_rows(self) -> List[int]:
        """The data indices this process owns, ascending (contiguous: the
        grid lists the processes' devices in process order)."""
        return [int(r) for r in np.flatnonzero(self.owners[:, 0] == self.process)]

    def data_devices(self) -> List[torch.device]:
        """The device of each data shard this process drives: the first of
        its graph row, where its per-episode work runs."""
        return [self.devices[r, 0] for r in self.local_rows]

    def graph_devices(self, d: int) -> List[torch.device]:
        """This process's data shard `d`'s graph row: the devices its ring
        APSP spans."""
        return list(self.devices[self.local_rows[d], :])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.ravel()]})"


def make_mesh(
    data: Optional[int] = None,
    graph: int = 1,
    devices: Optional[Sequence] = None,
    runtime=None,
) -> Mesh:
    """Lay `devices` (default: every local CUDA device) out as a (data,
    graph) grid.  The list may repeat a device.

    With `runtime` (a `multihost.runtime.MeshRuntime` of more than one
    process; every process calls this together) the grid is laid over the
    devices of every process, in process order: its own `devices`, and
    each other process's from `runtime.device_counts` (its CUDA devices;
    when `devices` is given, every process's list is exchanged instead).

    A grid that does not fit the device count -- more cells than devices, or
    a `graph` axis larger than the fleet -- degrades to a 1-D `data` axis
    over every device with a warning instead of raising: callers sized for
    one fleet shape (a serving config moved between hosts, a card lost
    mid-run) keep a working mesh, they just lose the graph partition.  With
    no device given and no card present this raises: a mesh never falls
    back to the CPU on its own."""
    given = devices is not None
    devices = [canonical_device(d) for d in (devices if given else local_devices())]
    owners = [0] * len(devices)
    process = 0
    if runtime is not None and runtime.num_processes > 1:
        process = runtime.process_id
        if not given and runtime.device_counts:
            lists = [[f"cuda:{i}" for i in range(c)] for c in runtime.device_counts]
        else:
            lists = exchange([str(d) for d in devices])
        devices = [torch.device(n) for names in lists for n in names]
        owners = [p for p, names in enumerate(lists) for _ in names]
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
    return Mesh(grid.reshape(data, graph), axis_names=("data", "graph"),
                owners=np.asarray(owners[: data * graph]).reshape(data, graph),
                process=process)


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
    """This process's local batch laid out over its own slots of `axis`:
    one equal slice of the leading axis per slot, on that slot's first
    device.  Over a mesh that spans processes the result behaves as the
    concatenation of every process's local batch, in process order, over
    the whole axis (JAX's `make_array_from_process_local_data`); in one
    process the local batch is the global one."""
    if axis == mesh.axis_names[0]:
        return shard_batch(tree, mesh.data_devices())
    if mesh.spans_processes:
        raise ValueError(f"global_batch over '{axis}': only the data axis spans processes")
    return shard_batch(tree, list(mesh.devices.T[:, 0]))


# Process-group bring-up lives in `multihost.runtime`; re-exported for
# callers of parallel.mesh.init_distributed, as in the JAX package.
from multihop_offload_tpu_torch.multihost.runtime import init_distributed  # noqa: F401,E402
