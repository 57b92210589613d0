"""The part of the reference's ``engine/telemetry.py`` that the port
calls, copied: :class:`Counter`, :class:`Gauge`,
:class:`MetricsRegistry`'s ``counter``, ``gauge``, ``series`` and its
counter-bump listeners (``add_listener`` / ``remove_listener``, the
flight recorder's hook, ``engine/tracer.py``), and
:class:`SpanRecorder`, the dispatch's duck-typed ``tracer=``.  The
histograms, digests, snapshots and the JSON-lines exporter are not
copied: the port records the ``dispatch_faults``,
``aot_cache_events``, ``fabric_*``, ``search_*`` and ``population.*``
families and reads them through ``series``.

A counter bump takes the instrument's lock, then calls the listeners
whose name filter admitted the instrument when it was bound (outside
the lock); the registry memoizes instruments by ``(name, sorted
labels)``, so asking twice for one labeled series returns the same
counter, and ``series(name)`` reads one name's whole label family.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

_Labels = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> _Labels:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter; every bump takes the instrument's lock, then
    calls ``_listeners`` (bound by the owning registry, the registry's
    listeners whose name filter admits this instrument; a directly
    constructed counter has none) outside it."""

    kind = "counter"

    #: bound by the owning registry per instrument
    _listeners: tuple = ()

    def __init__(self, name: str, labels: Optional[Dict] = None):
        self.name = name
        self.labels = _label_key(labels or {})
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n
        for listener in self._listeners:
            listener(self.name, self.labels, n)

    @property
    def value(self):
        with self._lock:
            return self._value

    def read(self):
        return self.value


class Gauge:
    """Point-in-time value (last write wins)."""

    kind = "gauge"

    def __init__(self, name: str, labels: Optional[Dict] = None):
        self.name = name
        self.labels = _label_key(labels or {})
        self._lock = threading.Lock()
        self._value = 0

    def set(self, value) -> None:
        with self._lock:
            self._value = value

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n=1) -> None:
        self.inc(-n)

    @property
    def value(self):
        with self._lock:
            return self._value

    def read(self):
        return self.value


class MetricsRegistry:
    """An instrument store keyed by ``(name, labels)``: ``counter`` and
    ``gauge`` memoize (a name registered as one kind and asked for as
    the other raises), ``series`` reads one name's label family."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, _Labels], object] = {}
        # counter-bump listener specs ``(listener, name_filter)``; each
        # registry-owned Counter carries the listeners whose filter
        # admits its name, rebound on add/remove so a listener attached
        # later still reaches counters created before it
        self._listener_specs: list = []

    def _listeners_for(self, name: str) -> tuple:
        return tuple(listener for listener, name_filter
                     in self._listener_specs
                     if name_filter is None or name_filter(name))

    def _rebind_listeners(self) -> None:
        # caller holds self._lock
        for inst in self._instruments.values():
            if isinstance(inst, Counter):
                inst._listeners = self._listeners_for(inst.name)

    def add_listener(self, listener, name_filter=None) -> None:
        """Subscribe ``listener(name, labels, n)`` to every counter
        ``inc`` on this registry.  ``name_filter`` (a ``name -> bool``
        predicate) is applied when an instrument is bound, so counters
        it rejects never call the listener.  Listeners run outside the
        instrument's lock and must not raise."""
        with self._lock:
            if any(listener == sub for sub, _ in self._listener_specs):
                return
            self._listener_specs.append((listener, name_filter))
            self._rebind_listeners()

    def remove_listener(self, listener) -> None:
        with self._lock:
            kept = [spec for spec in self._listener_specs
                    if spec[0] != listener]
            if len(kept) == len(self._listener_specs):
                return
            self._listener_specs = kept
            self._rebind_listeners()

    def _get(self, cls, name: str, labels: Dict):
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, labels)
                if cls is Counter:
                    inst._listeners = self._listeners_for(name)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"{name!r} already registered as {inst.kind}")
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def _items(self):
        with self._lock:
            return list(self._instruments.items())

    def series(self, name: str) -> List[Tuple[Dict[str, str], object]]:
        """All instruments registered under ``name``, as ``(labels
        dict, read value)`` pairs."""
        return [(dict(labels), inst.read())
                for (n, labels), inst in self._items() if n == name]


class SpanRecorder:
    """Host-side span tracing for the chunked dispatch: ``with
    tracer.span("dispatch", chunk=3):`` appends one record ``{"name",
    "start_s", "end_s", "duration_s", **attrs}`` (``time.perf_counter``
    timebase).  The dispatch's ``tracer=`` (``ops/dispatch.py``) tags
    its build, dispatch and readback phases with it."""

    def __init__(self):
        self.spans: List[Dict] = []
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str, **attrs):
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            with self._lock:
                self.spans.append({"name": name, "start_s": start,
                                   "end_s": end,
                                   "duration_s": end - start, **attrs})

    def total(self, name: str) -> float:
        """Summed duration of every span named ``name``."""
        with self._lock:
            return sum(s["duration_s"] for s in self.spans
                       if s["name"] == name)

    def by_name(self) -> Dict[str, List[Dict]]:
        with self._lock:
            out: Dict[str, List[Dict]] = {}
            for s in self.spans:
                out.setdefault(s["name"], []).append(s)
            return out
