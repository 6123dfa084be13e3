"""Structured JSONL run log: manifest header + typed event rows.

Port of `multihop_offload_tpu/obs/events.py` (standard library and torch
only).  Every row write passes the chaos hook `io_gate("events:write")`
(`chaos.faults`) under a bounded retry of its own; the manifest names the
torch version and CUDA device instead of JAX's.

One `run.jsonl` per instrumented run.  Line 1 is the run manifest (git sha,
torch version, device kind, platform, config hash, ...); every later line is
one event: `{"event": <type>, "ts": <unix seconds>, ...fields}`.  Not
ported: the typed helpers (`step`, `tick`, `checkpoint`, `phase`,
`summary`), whose callers are not ported yet; `emit` writes any type.

Writes are lock-guarded (the serve tick loop and a main thread may share
one log) and line-buffered to bound instrumentation overhead; `close()`
flushes.

Long-running logs (a service the continual-learning flywheel tails forever)
rotate by size: pass `max_bytes` and a segment that would grow past it is
renamed to ``<path>.NNNN`` (ascending age) and a fresh segment opened at
`path` with a small ``segment`` header row.  `read_events` spans the whole
segment chain transparently and stays tolerant of a truncated final line
in ANY segment (a crash can interrupt a rotation too).
"""

from __future__ import annotations

import glob as _glob
import hashlib
import json
import os
import re
import threading
import time
from typing import Iterator, List, Optional

from multihop_offload_tpu_torch.chaos import faults

SCHEMA_VERSION = 1

def _git_sha() -> Optional[str]:
    try:
        import subprocess

        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5,
        )
        return out.stdout.strip() or None if out.returncode == 0 else None
    except Exception:
        return None


def config_hash(cfg) -> Optional[str]:
    """Stable short hash of the run configuration (dataclass or dict)."""
    try:
        import dataclasses

        d = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else dict(cfg)
        blob = json.dumps(d, sort_keys=True, default=str).encode()
        return hashlib.sha256(blob).hexdigest()[:16]
    except Exception:
        return None


def run_manifest(cfg=None, role: str = "") -> dict:
    """The manifest header fields (best-effort: the manifest must never
    kill the run it describes)."""
    man = {
        "event": "manifest",
        "schema_version": SCHEMA_VERSION,
        "ts": time.time(),  # nondet-ok(manifest stamp: real wall time of the run)
        "role": role,
        "pid": os.getpid(),
        "git_sha": _git_sha(),
    }
    try:
        import platform as _platform

        man["hostname"] = _platform.node()
        man["python"] = _platform.python_version()
    except Exception:  # swallow-ok(manifest is best-effort; platform probes must never kill the run)
        pass
    import torch

    man["torch_version"] = torch.__version__
    if torch.cuda.is_available():
        man["platform"] = "gpu"
        man["device_kind"] = torch.cuda.get_device_name(0)
        man["device_count"] = torch.cuda.device_count()
    else:
        man["platform"] = "cpu"
    if cfg is not None:
        man["config_hash"] = config_hash(cfg)
        try:
            import dataclasses

            if dataclasses.is_dataclass(cfg):
                man["config"] = {
                    k: v for k, v in dataclasses.asdict(cfg).items()
                    if isinstance(v, (int, float, str, bool, type(None)))
                }
        except Exception:  # swallow-ok(config echo is best-effort; an odd cfg type must not kill the run)
            pass
    return man


class RunLog:
    """Append-only JSONL sink with the manifest as its first line.

    With `max_bytes` set, a segment about to exceed the cap is rotated:
    the active file moves to ``<path>.NNNN`` and a fresh ``<path>`` opens
    with a ``segment`` header so readers (and humans) can tell the chain
    apart from independent runs.  Rotation happens under the write lock,
    so concurrent emitters never interleave across a boundary.
    """

    def __init__(self, path: str, manifest: Optional[dict] = None,
                 max_bytes: Optional[int] = None):
        self.path = path
        self.max_bytes = int(max_bytes) if max_bytes else 0
        self._lock = threading.Lock()
        self._bytes = 0        # bytes written to the active segment
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        # crash-restart semantics: a non-empty log already at `path` is a
        # previous (possibly killed) run's — rotate it aside instead of
        # truncating, so durable consumers (the flywheel's experience
        # reader, crash-resume) keep every event already on disk
        seq = 0
        for p in segment_paths(path):
            if p != path:
                seq = max(seq, int(p.rsplit(".", 1)[1]) + 1)
        if os.path.exists(path) and os.path.getsize(path) > 0:
            os.replace(path, f"{path}.{seq:04d}")
            seq += 1
        self._seq = seq        # next rotated-segment suffix
        self._f = open(path, "w", buffering=1)  # line-buffered
        self._closed = False
        self._write(manifest if manifest is not None else run_manifest())

    def _rotate_locked(self) -> None:
        """Move the active segment aside and open a fresh one. Caller
        holds the lock."""
        self._f.flush()
        self._f.close()
        os.replace(self.path, f"{self.path}.{self._seq:04d}")
        self._seq += 1
        self._f = open(self.path, "w", buffering=1)
        header = json.dumps({"event": "segment",
                             "ts": time.time(),  # nondet-ok(segment stamp)
                             "seq": self._seq}) + "\n"
        self._f.write(header)
        self._bytes = len(header)

    def _write(self, rec: dict) -> None:
        line = json.dumps(rec, default=str) + "\n"
        with self._lock:
            if self._closed:
                return
            if (self.max_bytes and self._bytes
                    and self._bytes + len(line) > self.max_bytes):
                self._rotate_locked()
            # bounded retry, hand-rolled: with_backoff's retry event would
            # re-enter this very log (the lock is held), so only the
            # registry counter records the retries here
            for attempt in range(3):
                try:
                    faults.io_gate("events:write")
                    self._f.write(line)
                    break
                except OSError:
                    if attempt == 2:
                        raise
                    from multihop_offload_tpu_torch.obs.registry import registry as _reg

                    _reg().counter(
                        "mho_io_retries_total",
                        "transient I/O failures retried",
                    ).inc(site="events:write")
            self._bytes += len(line)

    def emit(self, event: str, **fields) -> None:
        self._write({"event": event,
                     "ts": time.time(),  # nondet-ok(run-log events carry real wall time)
                     **fields})

    def close(self, terminal: bool = False) -> None:
        """Flush and close the active segment.  `terminal=True` is the
        orderly-shutdown contract (graceful drain): the active segment is
        SEALED into the rotated chain (`path.NNNN`), leaving nothing at
        `path` — so the next process at the same path starts a fresh
        segment without the crash-restart rotate-aside, and readers
        (`read_events` spans the chain) see a clean terminal segment ending
        in this run's summary."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._f.flush()
                self._f.close()
                if terminal and os.path.exists(self.path):
                    os.replace(self.path, f"{self.path}.{self._seq:04d}")
                    self._seq += 1


# ---- active-sink slot ------------------------------------------------------
# Instrumented loops emit through the active run log when one is installed
# and no-op otherwise, so library code never needs config plumbed through.

_active: Optional[RunLog] = None
_active_lock = threading.Lock()


def set_run_log(log: Optional[RunLog]) -> None:
    global _active
    with _active_lock:
        _active = log


def get_run_log() -> Optional[RunLog]:
    return _active


def emit(event: str, **fields) -> None:
    """Emit to the active run log, if any (the no-config call sites use
    this: `obs.events.emit('tick', ...)`)."""
    log = _active
    if log is not None:
        log.emit(event, **fields)


def segment_paths(path: str) -> List[str]:
    """All segments of a (possibly rotated) run log, oldest first: the
    rotated ``<path>.NNNN`` files in suffix order, then the active file."""
    suffixed = []
    pat = re.compile(re.escape(os.path.basename(path)) + r"\.(\d{4,})$")
    for p in _glob.glob(path + ".*"):
        m = pat.match(os.path.basename(p))
        if m:
            suffixed.append((int(m.group(1)), p))
    out = [p for _, p in sorted(suffixed)]
    if os.path.exists(path):
        out.append(path)
    return out


def read_events(path: str) -> Iterator[dict]:
    """Iterate a run log's rows across all rotated segments (oldest
    first); tolerates a truncated final line in any segment (a crashed
    run's log must still render — and a crash can interrupt a rotation).

    Torn writes are byte-level: a record cut mid-UTF-8-sequence used to
    raise `UnicodeDecodeError` out of text-mode iteration, which killed
    the generator and silently dropped every LATER segment — a torn
    mid-chain record looked like end-of-log.  Decoding with
    ``errors="replace"`` turns the torn bytes into a non-JSON line the
    existing skip path drops, and the walk continues into ``.NNNN+1``.
    A segment that vanishes between listing and open (a crashed rotation,
    a pruned chain) is skipped the same way."""
    for seg in segment_paths(path) or [path]:
        try:
            f = open(seg, encoding="utf-8", errors="replace")
        except OSError:
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    continue
