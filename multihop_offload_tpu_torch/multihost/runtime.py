"""`torch.distributed` process-group bring-up, owned in one place.

Port of `multihop_offload_tpu/multihost/runtime.py` (`:133-285`).  Every
`torch.distributed` call of the port lives in this module: scattering
process-group bring-up across entry points is how a fleet ends up with n
independent single-process runs that look like a cluster.

The group runs on the gloo backend over a TCP rendezvous
(`tcp://host:port`; process 0 hosts the store).  It does what
`jax.distributed` does in the JAX package: it names this process's index
and the process count (host 0 writes the CSVs, run logs and checkpoints).
Within a process `parallel/` drives that process's devices, with copies
between them (`parallel/collectives.py`); across processes the group
carries the one collective a data mesh needs, `all_reduce`.

Two entry points:

  * `init_distributed` -- the CLIs' bring-up: explicit arguments, else the
    cluster hints of the environment (JAX's strong and weak hints, and
    torchrun's `MASTER_ADDR` / `WORLD_SIZE` / `RANK`).  A single process is
    a no-op that returns 0; a named coordinator that fails stays an error.
  * `bootstrap` -- explicit coordinator and identity (arguments or the
    `MHO_MESH_*` environment), retried with exponential backoff until a
    deadline (workers routinely start before their coordinator binds), and
    a `MeshRuntime` handle naming this process's host and every host's
    local CUDA devices.

Two local CPU processes form a real group on localhost: `free_port` and
`worker_env` build the child environment.  `exchange` gathers one Python
object from every process (`mho-mesh`'s fleet sizes), `all_reduce` sums a
tensor over the group (the gradients and metrics of a data mesh that spans
processes, `parallel/data_parallel.py`), and `shutdown`
leaves the group within a time limit, so a process whose peer was killed
does not wait on it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from multihop_offload_tpu_torch.obs import events as obs_events
from multihop_offload_tpu_torch.obs.registry import registry as obs_registry

# env carrying explicit process identity into `bootstrap` (worker_env sets
# these for local children; a launcher can set them for real fleets)
ENV_COORDINATOR = "MHO_MESH_COORDINATOR"
ENV_NUM_PROCESSES = "MHO_MESH_NUM_PROCESSES"
ENV_PROCESS_ID = "MHO_MESH_PROCESS_ID"

# environment variables that name a coordinator outright (JAX's three, and
# torchrun's)
STRONG_HINTS = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS",
                "MEGASCALE_COORDINATOR_ADDRESS", "MASTER_ADDR")
# (process count, process index) pairs a launcher exports
_IDENTITY_HINTS = (("WORLD_SIZE", "RANK"), ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK"),
                   ("SLURM_NTASKS", "SLURM_PROCID"))


def host_name(process_index: int) -> str:
    """The canonical host id for a process index: the `host=` label value
    in federated metrics and the host key in two-level plans."""
    return f"host{int(process_index)}"


def free_port() -> int:
    """An OS-assigned localhost port for a local coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env(
    coordinator: str,
    num_processes: int,
    process_id: int,
    base_env: Optional[Dict[str, str]] = None,
) -> Dict[str, str]:
    """The child environment of one local worker process: its identity for
    `bootstrap`.  (JAX's also sets the virtual CPU device count; a torch
    mesh is a device list the caller passes, so nothing else is needed.)"""
    env = dict(os.environ if base_env is None else base_env)
    env[ENV_COORDINATOR] = coordinator
    env[ENV_NUM_PROCESSES] = str(int(num_processes))
    env[ENV_PROCESS_ID] = str(int(process_id))
    return env


def local_devices() -> List[torch.device]:
    """This process's CUDA devices, `cuda:0` .. `cuda:k-1` (empty without
    a card: a mesh never falls back to the CPU on its own)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def process_index() -> int:
    """This process's index in the group (0 outside one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The group's process count (1 outside one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class MeshRuntime:
    """One process's view of the formed group.  `device_counts` holds every
    process's local CUDA device count, in process order, exchanged once at
    bring-up (JAX reads it off the global device list)."""

    process_id: int
    num_processes: int
    coordinator_address: Optional[str]
    device_counts: Tuple[int, ...] = ()

    @property
    def host(self) -> str:
        return host_name(self.process_id)

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    def local_devices(self) -> List[torch.device]:
        """The devices this process may place computations on."""
        return local_devices()

    def host_table(self) -> Dict[str, List[int]]:
        """Every host's devices as global ids (process by process, each
        process's devices in order), grouped by owning process: the same on
        every process of the group."""
        counts = self.device_counts or (len(local_devices()),)
        table, start = {}, 0
        for p, c in enumerate(counts):
            table[host_name(p)] = list(range(start, start + c))
            start += c
        return table

    def describe(self) -> dict:
        counts = self.device_counts or (len(local_devices()),)
        return {
            "host": self.host,
            "process_id": self.process_id,
            "num_processes": self.num_processes,
            "coordinator": self.coordinator_address,
            "local_devices": [str(d) for d in self.local_devices()],
            "global_devices": sum(counts),
        }


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else None


def _init_group(coordinator_address: str, num_processes: int, process_id: int,
                timeout_s: float) -> None:
    """Join the gloo group at `tcp://coordinator_address`."""
    addr = coordinator_address
    if "://" not in addr:
        addr = f"tcp://{addr}"
    dist.init_process_group(
        "gloo", init_method=addr, world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=max(1.0, float(timeout_s))))


def _exchange_device_counts() -> Tuple[int, ...]:
    counts = [None] * process_count()
    dist.all_gather_object(counts, len(local_devices()))
    return tuple(int(c) for c in counts)


def bootstrap(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    timeout_s: float = 60.0,
    backoff_s: float = 0.25,
    max_backoff_s: float = 2.0,
) -> MeshRuntime:
    """Join (or be) the process group, retrying until `timeout_s`.

    Identity comes from the explicit args, else the `MHO_MESH_*` env set
    by `worker_env` / a launcher.  With neither (or a group of one) this
    is a single-process runtime: no store is started, the returned handle
    just says so.

    Workers starting before their coordinator binds are the normal case,
    not an error: each failed attempt backs off exponentially (counted in
    `mho_mesh_bootstrap_retries_total`) until the deadline, and only a
    coordinator still unreachable at the deadline raises."""
    coordinator_address = coordinator_address or os.environ.get(ENV_COORDINATOR) or None
    if num_processes is None:
        num_processes = _env_int(ENV_NUM_PROCESSES)
    if process_id is None:
        process_id = _env_int(ENV_PROCESS_ID)

    if coordinator_address is None or (num_processes or 1) <= 1:
        rt = MeshRuntime(process_id=0, num_processes=1, coordinator_address=None)
        obs_events.emit("mesh_bootstrap", **rt.describe(), attempts=0)
        return rt

    if dist.is_initialized():
        # the group is formed once a process; a second bootstrap re-reads it
        return MeshRuntime(process_id=process_index(), num_processes=process_count(),
                           coordinator_address=coordinator_address,
                           device_counts=_exchange_device_counts())

    retries = obs_registry().counter(
        "mho_mesh_bootstrap_retries_total",
        "failed torch.distributed bring-up attempts before success",
    )
    deadline = time.monotonic() + float(timeout_s)  # nondet-ok(bring-up deadline: the peers are other processes)
    delay = float(backoff_s)
    attempt = 0
    while True:
        attempt += 1
        remaining = deadline - time.monotonic()  # nondet-ok(same wall-clock deadline)
        try:
            _init_group(coordinator_address, num_processes, process_id, remaining)
            break
        except (RuntimeError, ValueError, OSError) as exc:  # DistNetworkError is a RuntimeError
            if time.monotonic() + delay >= deadline:  # nondet-ok(same wall-clock deadline)
                raise RuntimeError(
                    f"mesh bootstrap: coordinator {coordinator_address} "
                    f"unreachable after {attempt} attempt(s) over "
                    f"{timeout_s:.0f}s"
                ) from exc
            retries.inc()
            time.sleep(delay)
            delay = min(delay * 2.0, float(max_backoff_s))
    rt = MeshRuntime(process_id=process_index(), num_processes=process_count(),
                     coordinator_address=coordinator_address,
                     device_counts=_exchange_device_counts())
    obs_events.emit("mesh_bootstrap", **rt.describe(), attempts=attempt)
    return rt


def exchange(obj) -> list:
    """Every process's `obj`, in process order (one `all_gather_object`
    over the group, bounded by the group's timeout); `[obj]` outside a
    group."""
    if not (dist.is_available() and dist.is_initialized()):
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def all_reduce(tensor: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of `tensor` over every process of the group, as
    a new tensor on `tensor`'s device and in its dtype (`tensor` itself
    outside a group).  Every process gets the same bits: gloo reduces each
    chunk in one order and hands the result to all.  The group is gloo, so
    a CUDA tensor is staged through host memory: one copy to the host, the
    reduction there, one copy back."""
    if not (dist.is_available() and dist.is_initialized()):
        return tensor
    host = tensor.detach().to("cpu", copy=True).contiguous()
    dist.all_reduce(host, op=dist.ReduceOp.SUM)
    return host.to(tensor.device)


def shutdown(timeout_s: float = 10.0) -> bool:
    """Leave the group without waiting on a dead peer: `destroy_process_group`
    runs in a daemon thread joined for at most `timeout_s`.  Returns
    whether it finished (a no-op outside a group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return True
    done = threading.Event()

    def _destroy():
        dist.destroy_process_group()
        done.set()

    threading.Thread(target=_destroy, name="mho-mesh-shutdown", daemon=True).start()
    return done.wait(timeout_s)


def _spec_from_env() -> Tuple[str, int, int]:
    """(coordinator, process count, process index) from the environment;
    ValueError when it does not name all three (the incomplete-spec signal,
    as `jax.distributed.initialize()` raises it)."""
    coord = next((os.environ[h] for h in STRONG_HINTS[:3] if os.environ.get(h)), None)
    if coord is None and os.environ.get("MASTER_ADDR"):
        port = os.environ.get("MASTER_PORT", "").strip()
        if not port:
            raise ValueError("MASTER_ADDR is set without MASTER_PORT")
        coord = f"{os.environ['MASTER_ADDR']}:{port}"
    if coord is None:
        raise ValueError("no coordinator address in the environment")
    for count_var, rank_var in _IDENTITY_HINTS:
        n, pid = _env_int(count_var), _env_int(rank_var)
        if n is not None and pid is not None:
            return coord, n, pid
    raise ValueError(f"coordinator {coord} named, but no process count and index "
                     f"({', '.join(c + '/' + r for c, r in _IDENTITY_HINTS)})")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = 300.0,
) -> int:
    """Multi-host bring-up: join the gloo group so that `process_index()`
    names this host (host 0 writes the run's files).  Explicit args win;
    otherwise the environment's cluster hints apply (JAX `:213-285`):
    strong hints name a coordinator (`COORDINATOR_ADDRESS`,
    `JAX_COORDINATOR_ADDRESS`, `MEGASCALE_COORDINATOR_ADDRESS`, torchrun's
    `MASTER_ADDR`), weak hints only suggest a multi-process launch
    (`TPU_WORKER_HOSTNAMES` with more than one host, `OMPI_COMM_WORLD_SIZE`
    or a SLURM task count above 1, `CLOUD_TPU_TASK_ID`).  Single-process
    runs are a no-op.  Returns this process's index."""
    if any(a is not None for a in (coordinator_address, num_processes, process_id)):
        # any explicit arg selects the explicit path; an incomplete set is
        # the same incomplete-spec error the environment path raises
        missing = [n for n, a in (("coordinator_address", coordinator_address),
                                  ("num_processes", num_processes),
                                  ("process_id", process_id)) if a is None]
        if missing:
            raise ValueError(f"init_distributed: missing {', '.join(missing)}")
        if not dist.is_initialized():
            _init_group(coordinator_address, num_processes, process_id, timeout_s)
        return process_index()
    has_strong = any(os.environ.get(h) for h in STRONG_HINTS)

    def _weak_multiprocess() -> bool:
        def as_int(name):
            try:
                return int(os.environ.get(name, ""))
            except ValueError:
                return 0

        hosts = os.environ.get("TPU_WORKER_HOSTNAMES", "")
        n_hosts = len([h for h in hosts.split(",") if h.strip()])
        return (
            n_hosts > 1
            or as_int("OMPI_COMM_WORLD_SIZE") > 1
            or ("SLURM_JOB_ID" in os.environ
                and max(as_int("SLURM_NTASKS"), as_int("SLURM_NPROCS")) > 1)
            or "CLOUD_TPU_TASK_ID" in os.environ
        )

    if not has_strong and not _weak_multiprocess():
        return 0  # genuinely single-process: no multi-process context
    try:
        coord, n, pid = _spec_from_env()
    except ValueError:
        if not has_strong:
            # weak hints alone could not assemble a cluster spec: "no
            # cluster", not a failed bring-up
            return 0
        raise  # a named coordinator with no usable spec is misconfiguration
    if n <= 1:
        return 0
    # real bring-up failures (an unreachable coordinator) propagate: never
    # silently degrade a configured cluster into independent runs
    if not dist.is_initialized():
        _init_group(coord, n, pid, timeout_s)
    return process_index()
