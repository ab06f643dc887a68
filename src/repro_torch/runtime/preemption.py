"""Preemption-safe loops: SIGTERM/SIGINT set a flag that a loop polls at
its boundaries; the loop then writes a final atomic checkpoint and stops.
The executor (`runtime.executor.Executor`) polls it at round boundaries and
a resumed executor continues bit-identically: its streams' batches are a
pure function of (seed, batch), the table and link state are in the
checkpoint, and nothing depends on wall clock.

A cluster's maintenance notice would set the same flag; SIGTERM is the
portable stand-in.  Handlers are installed only on `__enter__`.
"""

from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    """Context manager that converts SIGTERM/SIGINT into a poll-able flag.

        with PreemptionGuard() as guard:
            for step in range(...):
                if guard.should_stop:
                    save_checkpoint(...); break
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._event = threading.Event()
        self._old = {}

    @property
    def should_stop(self) -> bool:
        return self._event.is_set()

    def request_stop(self):
        """Programmatic preemption (tests, orchestrator RPC)."""
        self._event.set()

    def _handler(self, signum, frame):
        self._event.set()

    def __enter__(self):
        # Partial-failure safe: if installing handler i raises (non-main
        # thread, exotic signal), handlers 0..i-1 are rolled back before the
        # error propagates — a failed __enter__ never leaks handlers.
        try:
            for s in self._signals:
                self._old[s] = signal.signal(s, self._handler)
        except BaseException:
            self._restore()
            raise
        return self

    def _restore(self):
        first = None
        for s, h in list(self._old.items()):
            try:
                signal.signal(s, h)
            except BaseException as e:
                if first is None:
                    first = e
            else:
                del self._old[s]
        if first is not None:
            raise first

    def __exit__(self, *exc):
        # Runs on body exceptions too (context-manager contract), and a
        # handler that fails to restore doesn't strand the REST un-restored.
        self._restore()
        return False
