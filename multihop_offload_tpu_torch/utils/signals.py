"""Graceful SIGTERM/SIGINT drain for the long-running entry points.

A copy of `multihop_offload_tpu/utils/signals.py` (standard library only).
`mho-serve` is the process an operator (or a pod eviction) stops with a
signal.  An orderly stop should not look like a crash: finish the
in-flight tick, answer what was admitted, and close the run-log segment
terminally (`obs.events.RunLog.close(terminal=True)`), so the next
process starts from a sealed segment chain.

The handler only sets a flag; the drain work happens at the loop's own
safe points, never inside a signal context.
"""

from __future__ import annotations

import signal
from typing import Optional, Tuple


class GracefulDrain:
    """Latches the first SIGTERM/SIGINT; the serving loop polls `requested`
    at its safe points.  A second signal restores the previous handlers
    and raises itself again, so a stuck drain can still be killed."""

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self.signum: Optional[int] = None
        self._previous = {}
        self._signals = signals

    def _handle(self, signum, frame):
        if self.requested:
            # second signal: restore the previous handlers and let it act
            self.uninstall()
            signal.raise_signal(signum)
            return
        self.requested = True
        self.signum = int(signum)

    def install(self) -> "GracefulDrain":
        for s in self._signals:
            try:
                self._previous[s] = signal.signal(s, self._handle)
            except ValueError:
                # not the main thread (tests, embedded use): poll-only mode
                pass
        return self

    def uninstall(self) -> None:
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        self._previous = {}

    def request(self, signum: int = signal.SIGTERM) -> None:
        """Programmatic drain request (tests, embedding loops)."""
        self.requested = True
        self.signum = int(signum)
