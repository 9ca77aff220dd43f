"""Scoped SIGINT/SIGTERM handling for bounded entry points (the port's
copy of the JAX package's ``signals.py::ScopedStopSignal``, ``:35-64``).
"""
from __future__ import annotations

import os
import signal
import threading


class ScopedStopSignal:
    """Context-managed SIGINT/SIGTERM -> stop-event translation that
    restores the previous handlers on exit, for entry points (the train
    command) that may run several times in one process and must not
    keep the host's handlers (pytest's KeyboardInterrupt, an embedding
    application's own shutdown).  A second signal while stopping exits
    at once.  Off the main thread, where signal registration is illegal,
    the event is never set."""

    def __init__(self):
        self.stop = threading.Event()
        self._prev: "dict | None" = {}

    def __enter__(self) -> threading.Event:
        def handler(signum, frame):
            if self.stop.is_set():
                os._exit(1)
            self.stop.set()

        try:
            for sig in (signal.SIGINT, signal.SIGTERM):
                self._prev[sig] = signal.signal(sig, handler)
        except ValueError:  # not the main thread
            self._prev = None
        return self.stop

    def __exit__(self, *exc) -> None:
        if self._prev:
            for sig, prev in self._prev.items():
                signal.signal(sig, prev)
