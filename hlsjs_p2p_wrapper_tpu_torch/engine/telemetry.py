"""The part of the reference's ``engine/telemetry.py`` that the fault
policy (``engine/faults.py``) and the population plane
(``engine/population.py``) call, copied: :class:`Counter`,
:class:`Gauge` and :class:`MetricsRegistry`'s ``counter``, ``gauge``
and ``series``, with the same ``(name, labels)`` keying.  Nothing else
of that module is copied: the port records only the
``dispatch_faults{reason,action}`` counters, the
``population.materializations{source}`` counter and the
``population.cohort_peers{cohort}`` gauges.

A counter bump takes the instrument's lock; the registry memoizes
instruments by ``(name, sorted labels)``, so asking twice for one
labeled series returns the same counter, and ``series(name)`` reads
one name's whole label family.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

_Labels = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> _Labels:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter; every bump takes the instrument's lock."""

    kind = "counter"

    def __init__(self, name: str, labels: Optional[Dict] = None):
        self.name = name
        self.labels = _label_key(labels or {})
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

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

    def _get(self, cls, name: str, labels: Dict):
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, labels)
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
