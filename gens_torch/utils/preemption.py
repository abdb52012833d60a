"""SIGTERM guard for training (counterpart of
gens_tpu/utils/preemption.py): a cloud VM is sent SIGTERM shortly before it
is reclaimed. The guard turns the signal into a flag; the train loop then
writes ``preempt.ckpt`` and returns, and ``--resume auto`` continues from
it. One process, so only the local flag.
"""

from __future__ import annotations

import signal
import threading
from typing import Tuple


class PreemptionGuard:
    """Installs signal handlers (main thread only) that set a flag instead
    of ending the process; a context manager, so that the previous
    handlers are restored."""

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,)):
        self._flag = threading.Event()
        self._signals = signals
        self._prev = {}

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()
        return False

    def _handler(self, signum, frame):
        self._flag.set()

    @property
    def requested(self) -> bool:
        return self._flag.is_set()
