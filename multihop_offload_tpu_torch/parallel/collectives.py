"""Collectives over one mesh axis, driven from one process.

JAX's collectives (`lax.all_gather`, `lax.ppermute`, `lax.pmean`) run inside
one `shard_map` program, every device executing its copy.  The port's mesh
is a single controller: one process holds a list of per-device shards, one
tensor per position along a mesh axis in axis order, each on its device,
and these functions move data between them.

- A copy between two devices is issued on the destination device's
  stream, after an event recorded on the source device's stream, so it
  reads the shard only once the work that wrote it has run.
- A shard that already lives on the destination is used as it is: no
  copy.  A mesh may name one device more than once (`[cpu] * 4` in the
  tests, `[cuda:0] * 4` on one card), and then every collective between
  those positions is free, while the per-shard work still runs once per
  shard.
- A gathered or reduced result is computed once per distinct device and
  shared by the positions on it.

Code written per shard, which meets the other shards mid-computation (the
halo matmul of `parallel/partition.py`, called from inside the model's
forward), runs under `Lockstep`: one thread a shard, its collectives a
rendezvous of all of them.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Sequence

import torch


def device_key(device) -> tuple:
    """What makes two devices one memory: the type and the index (a CUDA
    device without one is the current device; every CPU device is one)."""
    d = torch.device(device)
    if d.type == "cuda":
        return ("cuda", torch.cuda.current_device() if d.index is None else d.index)
    return (d.type, 0)


def copy_to(x: torch.Tensor, device) -> torch.Tensor:
    """`x` on `device`: `x` itself when it already lives there, else a copy
    issued on the destination's stream after an event on the source's."""
    device = torch.device(device)
    if device_key(x.device) == device_key(device):
        return x
    if x.is_cuda and device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(x.device))
        stream = torch.cuda.current_stream(device)
        stream.wait_event(ready)
        with torch.cuda.stream(stream):
            out = x.to(device, non_blocking=True)
        x.record_stream(stream)  # the source stays alive until the copy ran
        return out
    return x.to(device)


def gather(shards: Sequence[torch.Tensor], device, axis: int = 0,
           tiled: bool = False) -> torch.Tensor:
    """Every shard, in order, on `device`: stacked along a new `axis`, or
    concatenated along `axis` when `tiled` (`lax.all_gather`'s layout)."""
    parts = [copy_to(s, device) for s in shards]
    return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)


def _per_device(shards: Sequence[torch.Tensor], fn: Callable) -> List[torch.Tensor]:
    """`fn(device)` for each position's device, computed once per distinct
    device."""
    done, out = {}, []
    for s in shards:
        k = device_key(s.device)
        if k not in done:
            done[k] = fn(s.device)
        out.append(done[k])
    return out


def all_gather(shards: Sequence[torch.Tensor], axis: int = 0,
               tiled: bool = False) -> List[torch.Tensor]:
    """`lax.all_gather` over the list's axis: every position gets every
    shard (`gather`) on its own device."""
    return _per_device(shards, lambda dev: gather(shards, dev, axis, tiled))


def ppermute(shards: Sequence[torch.Tensor], perm) -> List[torch.Tensor]:
    """`lax.ppermute`: position `dst` receives the shard of `src` for each
    (src, dst) of `perm`; a position nothing is sent to gets zeros."""
    out = [None] * len(shards)
    for src, dst in perm:
        out[dst] = copy_to(shards[src], shards[dst].device)
    return [torch.zeros_like(s) if o is None else o for s, o in zip(shards, out)]


def mean_to(shards: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The mean of the shards on `device` (their sum over their count)."""
    return gather(shards, device).sum(0) / len(shards)


def pmean(shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """`lax.pmean` over the list's axis: the shards' mean at every
    position."""
    return _per_device(shards, lambda dev: mean_to(shards, dev))


class Lockstep:
    """Run per-shard code, one thread a shard, whose collectives meet.

    `run(fn)` calls `fn(i)` for every shard index `i` in its own thread and
    returns the results in order; inside `fn`, `index` is the calling
    shard's index and `all_gather(x)` returns every shard's `x` gathered on
    the caller's device: each thread deposits its `x`, all wait at a
    barrier, each gathers onto its device, and all wait again before the
    slots are reused.  Every shard must make the same sequence of
    collectives.  A shard that raises breaks the barrier, so the others
    stop too, and `run` raises the first error; a barrier not met within
    `timeout` seconds raises `threading.BrokenBarrierError`."""

    def __init__(self, n: int, timeout: float = 600.0):
        self.n = n
        self._barrier = threading.Barrier(n, timeout=timeout)
        self._slots: list = [None] * n
        self._local = threading.local()

    @property
    def index(self) -> int:
        return self._local.index

    def all_gather(self, x: torch.Tensor, axis: int = 0,
                   tiled: bool = False) -> torch.Tensor:
        self._slots[self.index] = x
        self._barrier.wait()
        out = gather(self._slots, x.device, axis, tiled)
        self._barrier.wait()
        return out

    def run(self, fn: Callable[[int], object]) -> list:
        results: list = [None] * self.n
        errors: list = [None] * self.n

        def body(i):
            self._local.index = i
            try:
                results[i] = fn(i)
            except BaseException as e:  # re-raised by `run` in the caller
                errors[i] = e
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(i,), daemon=True)
                   for i in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # the shard that failed first, not the ones its abort broke
        first = next((e for e in errors if e is not None
                      and not isinstance(e, threading.BrokenBarrierError)),
                     next((e for e in errors if e is not None), None))
        if first is not None:
            raise first
        return results
