"""Crash-safe file primitives: atomic JSON writes and bounded retry.

Port of `multihop_offload_tpu/utils/durable.py` (standard library only).
Not ported: the chaos fault hooks and `configure()` (`chaos/` is not
ported yet); the retry defaults are the JAX package's.

- `atomic_write_json`: the tmp + fsync + `os.replace` dance, so a reader
  (or a process restarted after a kill) sees the old file or the complete
  new one, never a torn half-write.
- `with_backoff`: bounded retry with exponential backoff around I/O that
  can fail transiently.  Retries only `OSError`; corruption-shaped failures
  (ValueError & co.) propagate so callers can refuse them.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Optional

RETRIES = 3
BACKOFF_S = 0.05


def with_backoff(fn: Callable[[], Any], *, site: str = "",
                 retries: int = RETRIES, backoff_s: float = BACKOFF_S,
                 sleep: Callable[[float], None] = time.sleep) -> Any:
    """Run `fn`, retrying transient `OSError` up to `retries` attempts with
    backoff (backoff_s, 2*backoff_s, ...).  Other exceptions propagate at
    once; the final failed attempt re-raises.  Each retry is counted in
    `mho_io_retries_total` and emitted as an `io_retry` event."""
    n = max(int(retries), 1)
    for attempt in range(n):
        try:
            return fn()
        except OSError as e:
            if attempt == n - 1:
                raise
            from multihop_offload_tpu_torch.obs import events as obs_events
            from multihop_offload_tpu_torch.obs.registry import registry

            registry().counter("mho_io_retries_total",
                               "transient I/O failures retried").inc(site=site or "unknown")
            obs_events.emit("io_retry", site=site, attempt=attempt + 1, error=str(e))
            if backoff_s > 0:
                sleep(backoff_s * (2 ** attempt))


def atomic_write_json(path: str, payload: dict, *, site: str = "") -> None:
    """Write `payload` as JSON to `path` atomically (same-directory tmp
    file, fsync, `os.replace`), retried by `with_backoff`."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)

    def _write() -> None:
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, sort_keys=True, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    with_backoff(_write, site=site or f"atomic_write:{os.path.basename(path)}")


def load_json(path: str) -> Optional[dict]:
    """Read a JSON file written by `atomic_write_json`; None when missing
    or unparseable."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
