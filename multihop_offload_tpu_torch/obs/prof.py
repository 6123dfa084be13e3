"""Per-program performance observability (the prof layer) on the card.

Port of `multihop_offload_tpu/obs/prof.py`.  Every wired entry point (the
serve buckets, the train step, eval and replay, the simulator run, the
loop's refit step, the RL step) wraps its program here.  Registration
records the program's cost facts (flops, bytes accessed, argument and
temp bytes) and the wall time of the call that counted them; accounting
records invocation counts and the wall time between a dispatch and the
sync boundary that completes it.  Together they drive JAX's live series

    mho_program_flops_total{program=}          flops executed
    mho_program_bytes_total{program=}          bytes accessed
    mho_program_calls_total{program=}          program invocations
    mho_program_device_seconds_total{program=} accounted device wall time
    mho_program_mfu{program=}                  cumulative flop rate / peak
    mho_program_hbm_frac{program=}             cumulative byte rate / peak

against a peak table by device kind (`torch.cuda.get_device_name`).  The
rows are NVIDIA's data sheets; unknown kinds (the CPU) set no gauge, as
JAX's unknown kinds do.  `MHO_PROF_PEAK_TFLOPS` / `MHO_PROF_PEAK_HBM_GBPS`
override the table (the CPU smoke drills the gauge math on fake peaks).
The gauges keep the unrounded rate: JAX rounds to 6 decimals, which keeps
no digit of an H100 program's MFU (1e-7..1e-3); ``round(port, 6)`` is
JAX's value.

The port's answer to XLA's `cost_analysis` is `extract_cost(fn, *args)`:
the program's first call runs under a `TorchDispatchMode` that counts each
aten op, matmul-class flops as `torch.utils.flop_counter` reckons them and
bytes as the sizes of the op's tensor inputs and outputs (views move
none).  The hand kernels are bound through ctypes, so no dispatch mode
sees them: each kernel's dispatcher (`ops/fixed_point.py`,
`ops/minplus.py`, `ops/chebconv.py`) reports its analytic facts through
`kernel_work` instead, and its plain version runs under the same call with
the mode's counting suspended, so the count is the same whichever of the
two ran.  Counting never changes what runs: ops pass through the mode
unchanged, a CUDA tensor still launches its kernel, and once a program
has counted its first call the mode is gone.  The facts are pinned to the
first call's shapes, as JAX's AOT executable is.

`capture_trace` wraps `torch.profiler` into a never-raising Chrome /
Perfetto trace (`mho-prof capture`), and `BreachCapture` hooks it to the
SLO engine so a `serve_p99` / `serve_mfu` breach grabs a short trace next
to the flight-recorder dump.  Standard library and torch only.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from multihop_offload_tpu_torch.obs import events as obs_events
from multihop_offload_tpu_torch.obs.registry import (
    MetricRegistry,
    registry as _default_registry,
)

# ---- peak-by-device-kind tables ---------------------------------------------

# Peak dense bf16 tensor-core throughput per card (the rate MFU is quoted
# against), by `torch.cuda.get_device_name()` substring, first match wins.
# NVIDIA H100 data sheet, dense (without sparsity): SXM 989 TFLOP/s (the
# kind "NVIDIA H100 80GB HBM3"), PCIe 756, NVL 835.
PEAK_TFLOPS_BY_KIND = (
    ("h100 pcie", 756.0),
    ("h100 nvl", 835.0),
    ("h100", 989.0),
)

# HBM bandwidth per card (GB/s), same data sheet and lookup: SXM 3.35 TB/s
# (the figure PERF.md's kernel bounds use), PCIe 2.0, NVL 3.9.
PEAK_HBM_GBPS_BY_KIND = (
    ("h100 pcie", 2000.0),
    ("h100 nvl", 3900.0),
    ("h100", 3350.0),
)


def _env_peak(name: str) -> Optional[float]:
    raw = os.environ.get(name, "")
    try:
        v = float(raw)
        return v if v > 0 else None
    except ValueError:
        return None


def _lookup(table, device_kind: str) -> Optional[float]:
    kind = (device_kind or "").lower()
    for sub, peak in table:
        if sub in kind:
            return peak
    return None


def peak_tflops(device_kind: str) -> Optional[float]:
    """Peak dense bf16 TFLOP/s for a device kind; `MHO_PROF_PEAK_TFLOPS`
    overrides, unknown kinds return None."""
    override = _env_peak("MHO_PROF_PEAK_TFLOPS")
    return override if override is not None else _lookup(PEAK_TFLOPS_BY_KIND, device_kind)


def peak_hbm_gbps(device_kind: str) -> Optional[float]:
    """Peak HBM GB/s for a device kind; `MHO_PROF_PEAK_HBM_GBPS`
    overrides, unknown kinds return None."""
    override = _env_peak("MHO_PROF_PEAK_HBM_GBPS")
    return override if override is not None else _lookup(PEAK_HBM_GBPS_BY_KIND, device_kind)


# ---- the scan-interior FLOP correction (JAX `obs/prof.py:119-138`) ---------

def scan_corrected_flops(ca_flops: float, pad_n: int, pad_l: int, batch: int,
                         fp_iters: int = 10, fp_sites: int = 5,
                         fp_path: str = "xla") -> float:
    """JAX's correction of XLA's cost analysis, which charges a loop body
    once: `ca_flops` plus the (iters-1) uncharged APSP squarings of
    2·B·N³ and the uncharged fixed-point passes of 2·B·L² at each of
    `fp_sites` sites (all `fp_iters` of them when the fixed point is a
    Pallas custom call, `fp_path='pallas'`).  The port counts every
    squaring and pass as it runs (`apsp_flops`, `fixed_point_flops`), so it
    applies no correction; this copy is the same function for the
    records that compare with JAX's."""
    apsp_iters = max(1, math.ceil(math.log2(max(pad_n - 1, 2))))
    apsp_extra = (apsp_iters - 1) * 2.0 * batch * pad_n**3
    fp_uncharged = fp_iters if fp_path == "pallas" else fp_iters - 1
    fp_extra = fp_sites * fp_uncharged * 2.0 * batch * pad_l**2
    return ca_flops + apsp_extra + fp_extra


def apsp_flops(batch: int, n: int, iters: int) -> float:
    """The correction's APSP term as the port counts it: `iters` squarings
    of 2·B·N³ (the full static schedule, wherever an early stop ended)."""
    return iters * 2.0 * batch * n**3


def fixed_point_flops(batch: int, l: int, iters: int) -> float:
    """The correction's fixed-point term for one site: `iters` passes of
    2·B·L²."""
    return iters * 2.0 * batch * l**2


# ---- counting a program's work (the port's `cost_analysis`) -----------------

class WorkCount:
    """The work one counted call did: flops, bytes, the bytes its ops wrote
    into new tensors (`temp_bytes`: an upper bound of its scratch, where
    XLA reports the peak), and each kernel's calls."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.temp_bytes = 0.0
        self.kernels: Dict[str, int] = {}

    def add_kernel(self, name: str, flops: float, bytes_: float) -> None:
        self.flops += float(flops)
        self.bytes += float(bytes_)
        self.kernels[name] = self.kernels.get(name, 0) + 1


# the counts open now (nested programs each keep one); kernel_work adds to
# all of them.  Process-wide, not per thread: autograd runs a CUDA
# backward on its own thread, where torch carries the dispatch mode too.
_ACTIVE: list = []
_SUSPENDED = [0]


def counting() -> bool:
    """Whether a program's first call is being counted now."""
    return bool(_ACTIVE)


@contextmanager
def kernel_work(name: str, flops: float, bytes_: float):
    """A hand kernel's call (or its plain version's) inside a counted
    program: its analytic facts go to every open count and the aten ops
    inside it go uncounted, so the count does not depend on which of the
    two ran.  A kernel called inside another's call (K6's squarings)
    adds nothing of its own."""
    if _SUSPENDED[0] == 0:
        for c in _ACTIVE:
            c.add_kernel(name, flops, bytes_)
    _SUSPENDED[0] += 1
    try:
        yield
    finally:
        _SUSPENDED[0] -= 1


@contextmanager
def _lifted():
    """Nothing inside is counted: the dispatch modes are off the stack (so
    the ops pay nothing for them) and kernels add no facts."""
    from torch.utils._python_dispatch import _disable_current_modes

    _SUSPENDED[0] += 1
    try:
        with _disable_current_modes():
            yield
    finally:
        _SUSPENDED[0] -= 1


class RepeatedUnits:
    """A long program's repeated units (the simulator's policy call and
    slot step): inside a counted call, each unit's first execution is
    counted and every later one runs with the count lifted and adds the
    same facts, so a program of thousands of slots is counted at the cost
    of one.  A unit whose ops depend on the data (a slot's MWIS sweeps)
    is counted as its first execution."""

    def __init__(self):
        self._facts: Dict[str, tuple] = {}

    @contextmanager
    def unit(self, key: str):
        if not _ACTIVE or _SUSPENDED[0]:
            yield
            return
        facts = self._facts.get(key)
        if facts is None:
            c = _ACTIVE[-1]
            before = (c.flops, c.bytes, c.temp_bytes, dict(c.kernels))
            yield
            self._facts[key] = (c.flops - before[0], c.bytes - before[1],
                                c.temp_bytes - before[2],
                                {k: n - before[3].get(k, 0) for k, n in c.kernels.items()
                                 if n != before[3].get(k, 0)})
            return
        with _lifted():
            yield
        flops, bytes_, temp, kernels = facts
        for c in _ACTIVE:
            c.flops += flops
            c.bytes += bytes_
            c.temp_bytes += temp
            for k, n in kernels.items():
                c.kernels[k] = c.kernels.get(k, 0) + n


def kernel_scope(name: str, facts: Callable[[], tuple]):
    """`kernel_work(name, *facts())` inside a counted program, else a null
    context: `facts` (flops, bytes) is only evaluated while counting."""
    return kernel_work(name, *facts()) if _ACTIVE else nullcontext()


def counted(name: str, facts: Callable[..., tuple]):
    """Decorator for a kernel's dispatcher: inside a counted program the
    call runs under `kernel_work(name, *facts(*args, **kwargs))`, `facts`
    giving (flops, bytes) from the call's shapes; outside one it is the
    bare call."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _ACTIVE:
                return fn(*args, **kwargs)
            with kernel_work(name, *facts(*args, **kwargs)):
                return fn(*args, **kwargs)
        return call
    return deco


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _flat_tensors(items) -> list:
    """The tensors among an op's arguments or outputs, one level of
    sequences deep (`cat`'s list, a tuple of outputs)."""
    out = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _tensors(obj, out: list, seen: set) -> list:
    """Every tensor reachable from a call's arguments: tensors, sequences,
    dicts, dataclass records and modules (their parameters and buffers)."""
    if isinstance(obj, torch.Tensor):
        if id(obj) not in seen:
            seen.add(id(obj))
            out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _tensors(x, out, seen)
    elif isinstance(obj, dict):
        for x in obj.values():
            _tensors(x, out, seen)
    elif isinstance(obj, torch.nn.Module):
        for x in obj.state_dict().values():
            _tensors(x, out, seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), out, seen)
    return out


class _CountMode(TorchDispatchMode):
    """Counts each aten op's flops (`flop_counter`'s formulas) and bytes
    into a `WorkCount`; runs every op unchanged."""

    def __init__(self, count: WorkCount):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.count = count
        self.formulas = flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _SUSPENDED[0] or func.is_view:
            return out
        c = self.count
        formula = self.formulas.get(func.overloadpacket)
        if formula is not None:
            c.flops += float(formula(*args, **kwargs, out_val=out))
        ins = _flat_tensors(args)
        if kwargs:
            ins += _flat_tensors(kwargs.values())
        outs = _flat_tensors((out,))
        nin = sum(t.numel() * t.element_size() for t in ins)
        new = sum(t.numel() * t.element_size() for t in outs
                  if not any(t is i for i in ins))  # in-place ops return their input
        c.bytes += nin + sum(t.numel() * t.element_size() for t in outs)
        c.temp_bytes += new
        return out


def extract_cost(fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once with its work counted; returns
    (output, facts), facts = {flops, bytes_accessed, argument_bytes,
    temp_bytes, kernels}.  Flops and bytes are None where the call did no
    such work (as JAX's `extract_cost` reports a missing fact)."""
    count = WorkCount()
    arg_bytes = sum(_nbytes(t) for t in _tensors((args, kwargs), [], set()))
    _ACTIVE.append(count)
    try:
        with _CountMode(count):
            out = fn(*args, **kwargs)
    finally:
        _ACTIVE.remove(count)
    facts = {"flops": count.flops or None, "bytes_accessed": count.bytes or None,
             "argument_bytes": float(arg_bytes) or None,
             "temp_bytes": float(count.temp_bytes), "kernels": dict(count.kernels)}
    return out, facts


# ---- the program registry (JAX `:141-440`) ----------------------------------

class ProgramRecord:
    """Per-program cost/memory facts plus cumulative usage counters."""

    __slots__ = ("name", "flops", "flops_corrected", "bytes_accessed",
                 "argument_bytes", "temp_bytes", "compile_s", "compiles",
                 "calls", "device_s")

    def __init__(self, name: str):
        self.name = name
        self.flops: Optional[float] = None
        self.flops_corrected: Optional[float] = None
        self.bytes_accessed: Optional[float] = None
        self.argument_bytes: Optional[float] = None
        self.temp_bytes: Optional[float] = None
        self.compile_s: Optional[float] = None
        self.compiles = 0
        self.calls = 0
        self.device_s = 0.0

    def to_json(self) -> dict:
        ai = (round(self.flops_corrected / self.bytes_accessed, 4)
              if self.flops_corrected and self.bytes_accessed else None)
        return {
            "flops": self.flops,
            "flops_corrected": self.flops_corrected,
            "bytes_accessed": self.bytes_accessed,
            "argument_bytes": self.argument_bytes,
            "temp_bytes": self.temp_bytes,
            "arithmetic_intensity": ai,
            "compile_s": self.compile_s,
            "compiles": self.compiles,
            "calls": self.calls,
            "device_s": round(self.device_s, 6),
        }


def _device_kind() -> str:
    try:
        return torch.cuda.get_device_name(0) if torch.cuda.is_available() else ""
    except Exception:  # a wedged driver must not kill accounting
        return ""


class ProgramRegistry:
    """Process-wide per-program cost attribution (see module doc).

    `register` is idempotent per name: a re-register refreshes the facts
    and bumps the compile count but keeps the cumulative call and
    device-time counters.  Peaks are injectable for tests; by default they
    resolve once from the device kind (plus the env overrides)."""

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 peak_tflops_: Optional[float] = None,
                 peak_hbm_gbps_: Optional[float] = None):
        self._registry = registry
        self._peak_tflops = peak_tflops_
        self._peak_hbm = peak_hbm_gbps_
        self._injected = peak_tflops_ is not None or peak_hbm_gbps_ is not None
        self._peaks_resolved = self._injected
        self._lock = threading.RLock()
        self._programs: Dict[str, ProgramRecord] = {}
        self._kernel_shapes: set = set()   # `register_kernel_once`'s memo

    def _reg(self) -> MetricRegistry:
        return self._registry if self._registry is not None else _default_registry()

    def _peaks(self):
        """(peak_tflops, peak_hbm_gbps), resolved once from the device kind
        unless injected at construction."""
        if not self._peaks_resolved:
            kind = _device_kind()
            self._peak_tflops = peak_tflops(kind)
            self._peak_hbm = peak_hbm_gbps(kind)
            self._peaks_resolved = True
        return self._peak_tflops, self._peak_hbm

    def reset_peaks(self) -> None:
        """Resolve the peaks again at the next account (after the env
        overrides changed: the prof smoke's fake peaks, and their
        restoration)."""
        self._peaks_resolved = self._injected

    def register(self, name: str, facts: Optional[dict] = None, *,
                 compile_s: Optional[float] = None,
                 correction: Optional[Callable[[float], float]] = None,
                 flops: Optional[float] = None,
                 bytes_accessed: Optional[float] = None,
                 argument_bytes: Optional[float] = None,
                 temp_bytes: Optional[float] = None,
                 labels: Optional[Dict[str, str]] = None) -> ProgramRecord:
        """Record one program's cost facts.  `facts` is `extract_cost`'s
        dict; explicit keyword facts override it (tests, hand counts).
        `correction` maps the counted flops to the corrected count (None:
        the same).  `labels` (the sharded executor's `shard=` /
        `devices=`) land on every exported series beside `program=`."""
        facts = facts or {}
        labels = labels or {}
        with self._lock:
            rec = self._programs.get(name)
            if rec is None:
                rec = self._programs[name] = ProgramRecord(name)
            rec.compiles += 1
            rec.flops = flops if flops is not None else facts.get("flops")
            rec.bytes_accessed = (bytes_accessed if bytes_accessed is not None
                                  else facts.get("bytes_accessed"))
            rec.argument_bytes = (argument_bytes if argument_bytes is not None
                                  else facts.get("argument_bytes"))
            rec.temp_bytes = (temp_bytes if temp_bytes is not None
                              else facts.get("temp_bytes"))
            if rec.flops is not None:
                try:
                    rec.flops_corrected = float(
                        correction(rec.flops) if correction else rec.flops)
                except Exception:  # a broken correction degrades to the raw count
                    rec.flops_corrected = rec.flops
            else:
                rec.flops_corrected = None
            if compile_s is not None:
                rec.compile_s = float(compile_s)
        reg = self._reg()
        if rec.compile_s is not None:
            reg.gauge(
                "mho_program_compile_seconds",
                "wall time of the program's counted first call",
            ).set(round(rec.compile_s, 6), program=name, **labels)
        if rec.flops_corrected and rec.bytes_accessed:
            reg.gauge(
                "mho_program_arithmetic_intensity",
                "corrected flops / bytes accessed per program",
            ).set(round(rec.flops_corrected / rec.bytes_accessed, 4),
                  program=name, **labels)
        if rec.temp_bytes is not None:
            reg.gauge(
                "mho_program_temp_bytes",
                "peak bytes the program's ops held live",
            ).set(rec.temp_bytes, program=name, **labels)
        obs_events.emit("program", name=name, **labels, **rec.to_json())
        return rec

    def account(self, name: str, device_s: float, calls: int = 1,
                labels: Optional[Dict[str, str]] = None) -> None:
        """Account `calls` invocations of `name` covering `device_s` of wall
        time up to the call site's sync boundary.  Unregistered names
        accumulate calls and time only."""
        labels = labels or {}
        with self._lock:
            rec = self._programs.get(name)
            if rec is None:
                rec = self._programs[name] = ProgramRecord(name)
            rec.calls += int(calls)
            rec.device_s += float(device_s)
            flops = rec.flops_corrected
            bytes_ = rec.bytes_accessed
            total_s = rec.device_s
            total_calls = rec.calls
        reg = self._reg()
        reg.counter("mho_program_calls_total", "program invocations"
                    ).inc(calls, program=name, **labels)
        reg.counter("mho_program_device_seconds_total",
                    "accounted device wall seconds per program",
                    ).inc(max(float(device_s), 0.0), program=name, **labels)
        if flops:
            reg.counter("mho_program_flops_total", "corrected flops executed"
                        ).inc(flops * calls, program=name, **labels)
        if bytes_:
            reg.counter("mho_program_bytes_total", "bytes accessed"
                        ).inc(bytes_ * calls, program=name, **labels)
        if total_s <= 0:
            return
        peak_tf, peak_bw = self._peaks()
        if flops and peak_tf:
            reg.gauge("mho_program_mfu",
                      "cumulative corrected-flop rate over peak dense bf16"
                      ).set((flops * total_calls / total_s) / (peak_tf * 1e12),
                            program=name, **labels)
        if bytes_ and peak_bw:
            reg.gauge("mho_program_hbm_frac",
                      "cumulative byte rate over peak HBM bandwidth"
                      ).set((bytes_ * total_calls / total_s) / (peak_bw * 1e9),
                            program=name, **labels)

    def get(self, name: str) -> Optional[ProgramRecord]:
        with self._lock:
            return self._programs.get(name)

    def names(self) -> list:
        with self._lock:
            return sorted(self._programs)

    def snapshot(self) -> dict:
        """{name: record-dict}: the run-log summary's `programs=`, which
        `obs.report` renders as the performance table."""
        with self._lock:
            return {name: rec.to_json() for name, rec in sorted(self._programs.items())}

    def reset(self) -> None:
        with self._lock:
            self._programs.clear()
            self._kernel_shapes.clear()


_DEFAULT = ProgramRegistry()


def prof_registry() -> ProgramRegistry:
    """The process-wide program registry the wired entry points share."""
    return _DEFAULT


def register_kernel(name: str, *, flops: float, bytes_accessed: float,
                    argument_bytes: Optional[float] = None,
                    labels: Optional[Dict[str, str]] = None,
                    registry: Optional[ProgramRegistry] = None) -> None:
    """Register a hand kernel's analytic facts (`ops/chebconv`,
    `ops/chebconv_ragged`, `ops/coo_apsp`), as JAX registers its Pallas
    kernels' facts at trace time."""
    reg = registry or prof_registry()
    reg.register(name, compile_s=0.0, flops=float(flops),
                 bytes_accessed=float(bytes_accessed),
                 argument_bytes=(float(argument_bytes) if argument_bytes is not None
                                 else float(bytes_accessed)),
                 temp_bytes=0.0, labels=labels)


def register_kernel_once(name: str, shape: str, facts: dict, kind: str,
                         registry: Optional[ProgramRegistry] = None) -> None:
    """`register_kernel(name, **facts)` the first time this registry
    sees (name, shape) since its last `reset`: a kernel's record of one
    shape, as JAX registers it once at trace time.  The dispatchers call it
    only inside a counted program, where the port traces."""
    reg = registry or prof_registry()
    with reg._lock:
        if (name, shape) in reg._kernel_shapes:
            return
        reg._kernel_shapes.add((name, shape))
    register_kernel(name, **facts, labels={"kind": kind, "shape": shape}, registry=reg)


# ---- the wrap helper (JAX `:443-517`) ---------------------------------------

class ProfiledProgram:
    """A program that counts its work on its first call and registers.

    The first call runs under `extract_cost`; its wall time is the record's
    `compile_s` and is deducted once from the first accounted window, as
    JAX deducts the compile, so `device_s` counts the calls that ran
    uncounted.  Later calls go straight to the function: no mode, no
    launch, no synchronize.  Accounting stays at the call site's sync
    boundary (`account(device_s, calls)`)."""

    def __init__(self, name: str, fn: Callable, *,
                 prof: Optional[ProgramRegistry] = None,
                 correction: Optional[Callable[[float], float]] = None,
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self._fn = fn
        self._built = False
        self._prof = prof if prof is not None else prof_registry()
        self._correction = correction
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._pending_compile_s = 0.0
        self.facts: Optional[dict] = None   # the counted call's (`extract_cost`)

    @property
    def built(self) -> bool:
        """Whether the counted first call has happened."""
        return self._built

    def __call__(self, *args, **kwargs):
        if self._built:
            return self._fn(*args, **kwargs)
        with self._lock:
            if self._built:
                return self._fn(*args, **kwargs)
            t0 = time.perf_counter()  # nondet-ok(device-time accounting is a measurement)
            out, facts = extract_cost(self._fn, *args, **kwargs)
            dt = time.perf_counter() - t0  # nondet-ok(same measurement)
            self._pending_compile_s = dt
            self.facts = facts
            self._prof.register(self.name, facts, compile_s=dt,
                                correction=self._correction, labels=self.labels)
            self._built = True
            return out

    def account(self, device_s: float, calls: int = 1) -> None:
        """Account a sync-boundary wall window, less the counted first
        call's wall time the first time."""
        with self._lock:
            pending, self._pending_compile_s = self._pending_compile_s, 0.0
        self._prof.account(self.name, max(float(device_s) - pending, 0.0),
                           calls=calls, labels=self.labels)


def wrap(name: str, fn: Callable, *,
         prof: Optional[ProgramRegistry] = None,
         correction: Optional[Callable[[float], float]] = None,
         labels: Optional[Dict[str, str]] = None) -> ProfiledProgram:
    """Wrap a callable as a registered program named `name`; `labels`
    ride along on every series it exports."""
    return ProfiledProgram(name, fn, prof=prof, correction=correction, labels=labels)


# ---- profiler capture (JAX `:519-600`) --------------------------------------

def capture_trace(out_dir: str, duration_s: float = 0.0,
                  fn: Optional[Callable[[], None]] = None) -> str:
    """Trace `fn()` (else an idle wait of `duration_s`) with
    `torch.profiler` (the card's kernels too where CUDA is present) and
    write a Chrome / Perfetto trace, ``<out_dir>/trace.json``.  Never
    raises: a failure is a counter and an empty return."""
    try:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(out_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            if fn is not None:
                fn()
            elif duration_s > 0:
                time.sleep(float(duration_s))
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    except Exception as exc:  # capture is best-effort by contract
        _default_registry().counter(
            "mho_prof_capture_failures_total",
            "profiler captures that failed to start or stop",
        ).inc()
        obs_events.emit("prof_capture", path="", error=str(exc)[:200])
        return ""
    _default_registry().counter(
        "mho_prof_captures_total", "profiler trace bundles captured").inc()
    obs_events.emit("prof_capture", path=out_dir, duration_s=round(float(duration_s), 6))
    return out_dir


class BreachCapture:
    """SLO-breach-triggered profiler capture, companion to FlightRecorder.

    Register `on_breach` with the SLO engine; a firing transition of one
    of the watched SLOs grabs a short trace into
    ``<out_dir>/capture-NNN-<slo>/``, numbered like flight bundles.  The
    engine fires once per ok->firing transition; `min_interval_s` adds a
    cooldown for flapping alerts.  `tracer` is injectable (tests)."""

    def __init__(self, out_dir: str,
                 slos: Sequence[str] = ("serve_p99", "serve_mfu"),
                 duration_s: float = 0.05,
                 clock: Callable[[], float] = time.time,
                 min_interval_s: float = 0.0,
                 tracer: Callable[..., str] = capture_trace,
                 fn: Optional[Callable[[], None]] = None):
        self.out_dir = out_dir
        self.slos = tuple(slos)
        self.duration_s = float(duration_s)
        self.clock = clock
        self.min_interval_s = float(min_interval_s)
        self.tracer = tracer
        self.fn = fn
        self.captures: list = []
        self._seq = 0
        self._last_at: Optional[float] = None

    def on_breach(self, spec, info: dict) -> str:
        """The SLO engine's breach callback; returns the bundle path (empty
        when the SLO is not watched, cooling down, or the capture failed)."""
        name = getattr(spec, "name", str(spec))
        if name not in self.slos:
            return ""
        now = float(self.clock())
        if self._last_at is not None and now - self._last_at < self.min_interval_s:
            return ""
        self._last_at = now
        self._seq += 1
        bundle = os.path.join(self.out_dir, f"capture-{self._seq:03d}-{name}")
        path = self.tracer(bundle, self.duration_s, self.fn)
        if path:
            self.captures.append(path)
        return path
