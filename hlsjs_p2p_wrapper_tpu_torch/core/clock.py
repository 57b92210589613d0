# A copy of the reference's core/clock.py
# (hlsjs_p2p_wrapper_tpu/core/clock.py): the same names, formats and bytes;
# the imports point at the port's own modules.
"""Deterministic time & timers.

The reference leans on the browser event loop (``performance.now()``,
``setTimeout`` — e.g. lib/integration/p2p-loader-generator.js:77,163)
and its CHANGELOG is a museum of the races that came from it
(CHANGELOG.md:76,95-96,146-147).  The rebuild makes time an explicit,
injectable dependency so every retry/timeout/abort interleaving is
reproducible in tests: a ``VirtualClock`` drives the whole stack
deterministically, and a ``SystemClock`` backs real deployments.

All times are in **milliseconds** (float), matching the reference's
timebase (retry ceiling 64000 ms, fake RTT 10 ms — see BASELINE.md).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Optional, Protocol


class TimerHandle:
    """Cancelable handle returned by :meth:`Clock.call_later`."""

    __slots__ = ("_cancelled", "_fired", "_cancel_fn")

    def __init__(self, cancel_fn: Optional[Callable[[], None]] = None):
        self._cancelled = False
        self._fired = False
        self._cancel_fn = cancel_fn

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def fired(self) -> bool:
        return self._fired

    def cancel(self) -> None:
        if self._fired or self._cancelled:
            return
        self._cancelled = True
        if self._cancel_fn is not None:
            self._cancel_fn()


class Clock(Protocol):
    """Injectable time source + timer scheduler."""

    def now(self) -> float:
        """Current time in milliseconds (monotonic)."""
        ...

    def call_later(self, delay_ms: float, fn: Callable[[], None]) -> TimerHandle:
        """Schedule ``fn`` to run ``delay_ms`` from now."""
        ...


class SystemClock:
    """Wall-clock implementation backed by ``time.monotonic`` and
    ``threading.Timer``.  Callbacks run on timer threads; the framework's
    mutable state is guarded by coarse locks at the session layer."""

    def now(self) -> float:
        return time.monotonic() * 1000.0

    def call_later(self, delay_ms: float, fn: Callable[[], None]) -> TimerHandle:
        handle = TimerHandle()

        def run() -> None:
            if not handle.cancelled:
                handle._fired = True
                fn()

        timer = threading.Timer(max(delay_ms, 0.0) / 1000.0, run)
        timer.daemon = True
        handle._cancel_fn = timer.cancel
        timer.start()
        return handle


class VirtualClock:
    """Manually advanced clock for deterministic tests and the swarm
    simulator.  ``advance(ms)`` runs due timers in timestamp order
    (FIFO at equal timestamps)."""

    def __init__(self, start_ms: float = 0.0):
        self._now = float(start_ms)
        self._heap: list = []
        self._seq = itertools.count()

    def now(self) -> float:
        return self._now

    def call_later(self, delay_ms: float, fn: Callable[[], None]) -> TimerHandle:
        handle = TimerHandle()
        due = self._now + max(float(delay_ms), 0.0)
        heapq.heappush(self._heap, (due, next(self._seq), fn, handle))
        return handle

    def _pop_due(self, until: float):
        while self._heap and self._heap[0][0] <= until:
            due, _, fn, handle = heapq.heappop(self._heap)
            if handle.cancelled:
                continue
            return due, fn, handle
        return None

    def advance(self, ms: float) -> None:
        """Advance time by ``ms``, firing timers as they come due.
        Timers scheduled by fired callbacks are honored if they land
        inside the window."""
        target = self._now + max(float(ms), 0.0)
        while True:
            item = self._pop_due(target)
            if item is None:
                break
            due, fn, handle = item
            self._now = due
            handle._fired = True
            fn()
        self._now = target

    def run_until_idle(self, max_ms: float = 3_600_000.0) -> None:
        """Advance until no timers remain (bounded by ``max_ms``)."""
        deadline = self._now + max_ms
        while self._heap and self._heap[0][0] <= deadline:
            self.advance(self._heap[0][0] - self._now)

    @property
    def pending(self) -> int:
        return sum(1 for (_, _, _, h) in self._heap if not h.cancelled)
