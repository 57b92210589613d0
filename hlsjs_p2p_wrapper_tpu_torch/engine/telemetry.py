# A copy of the reference's engine/telemetry.py
# (hlsjs_p2p_wrapper_tpu/engine/telemetry.py): the same names, formats and
# bytes; the imports point at the port's own modules, and a few comments no
# longer cite the reference's history.
"""Unified host telemetry: metrics registry + span tracing + export.

The reference exposes one stats dict and nothing else
(lib/hlsjs-p2p-wrapper.js:14-18); the rebuild's host engine had
grown counters ad-hoc to match — an unlocked ``+=`` pair and two
locked attack counters on ``TcpEndpoint`` (engine/net.py),
``announce_count`` on the tracker, ``AgentStats`` ints on the agent —
with no shared registry, no histograms, and no export path.  This
module is that registry: every host-side component records into one
:class:`MetricsRegistry` (injected; components that get none record
into a private one, so call sites stay unconditional), and one
JSON-lines exporter serializes VirtualClock-timestamped snapshots for
the soak/swarm harnesses.

Three instrument kinds, deliberately tiny:

- :class:`Counter` — monotonic, **lock-per-bump**: the same contract
  as ``TcpEndpoint._count`` (engine/net.py), whose comment is the
  spec — these counters exist precisely for high-concurrency attack
  bursts, where unlocked ``+=`` from 64 handshake threads drops
  increments.  (The deliberately UNLOCKED hot-path byte totals stay
  attributes on their components; see the ``bytes_sent`` comment in
  net.py for why "fixing" them would be wrong.)
- :class:`Gauge` — last-write-wins point-in-time value.
- :class:`Histogram` — fixed upper-bound buckets plus count/sum,
  Prometheus-style cumulative ``le`` semantics on read.
- :class:`Digest` — a locked wrapper around the fleet observation
  plane's mergeable quantile sketch (engine/digest.py): fixed
  log-spaced bins, integer counts, order-independent merge.  The
  tail-latency instrument (``slo.fetch_ms``, ``slo.announce_rtt_ms``)
  — a histogram answers "how many under X", a digest answers
  "what IS p99", and its counts fold across hosts exactly.

Instruments are keyed by ``(name, labels)``: the registry memoizes,
so ``registry.counter("net.handshake_rejects", reason="psk")`` is a
stable labeled series, and :meth:`MetricsRegistry.series` reads one
name's whole label family (the labeled-snapshot surface net.py's
reject counters migrate onto).

:class:`SpanRecorder` is the host-side dispatch tracer: ``with
tracer.span("readback", chunk=3):`` appends one span record.  The
chunked sweep engine (ops/swarm_sim.py ``run_batch_chunked``) tags
its build / dispatch / readback phases with it, and bench.py turns
the spans into an overlap-efficiency metric — the readback/compute
pipelining the dispatch was built for becomes a measured runtime quantity.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Tuple

from .digest import DEFAULT_EDGES, QuantileDigest

#: default histogram upper bounds (ms-ish scale); pass ``buckets=`` to
#: :meth:`MetricsRegistry.histogram` for anything domain-specific
DEFAULT_BUCKETS = (1.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0,
                   5000.0, 10000.0)

_Labels = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> _Labels:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _format_key(name: str, labels: _Labels) -> str:
    """Flat snapshot key: ``name`` or ``name{k=v,...}`` (sorted)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter; every bump takes the instrument's lock (the
    ``_count`` contract: bursts are exactly when unlocked ``+=``
    drops increments).

    ``_listeners`` is the tuple of registry bump-listeners whose
    name filter admits this instrument, bound by the registry at
    creation and rebound on :meth:`MetricsRegistry.add_listener` /
    ``remove_listener`` — a directly-constructed Counter has none.
    Filtering at bind time means an instrument outside every
    listener's filter pays ZERO per-bump listener cost (the armed
    flight recorder stops taxing families it would only discard).
    Listeners fire OUTSIDE the value lock (they may buffer to disk)
    and only on ``inc``: ``set_value`` mirrors an externally-
    accumulated total, which no event stream could replay
    additively, so it stays invisible by design."""

    kind = "counter"

    #: bound by the owning registry per instrument; the empty tuple
    #: default keeps direct construction listener-free
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

    def set_value(self, value) -> None:
        """Last-write-wins assignment — the attribute-migration form
        (AgentStats setters): mirrors of an externally-accumulated
        total (``stats.upload = mesh.upload_bytes``) converge under
        any interleaving, and ``stats.cdn += delta`` corrections may
        be NEGATIVE (a transport's progress over-report reconciled at
        completion), which is why this is not a clamp.  Racing
        writers keep exactly the replaced plain-attribute semantics:
        one update can be lost, none can double-apply.  Counters fed
        only by ``inc`` stay strictly monotonic; monotonicity of
        assigned values is the caller's contract."""
        with self._lock:
            self._value = value

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


class Histogram:
    """Fixed-bucket histogram: ``observe(v)`` bumps the first bucket
    whose upper bound fits (locked, like Counter).  ``read()`` returns
    cumulative Prometheus-style ``le`` counts plus ``+Inf``/count/sum
    so consumers can compute quantile bounds offline."""

    kind = "histogram"

    def __init__(self, name: str, labels: Optional[Dict] = None,
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        self.name = name
        self.labels = _label_key(labels or {})
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value) -> None:
        value = float(value)
        with self._lock:
            for i, upper in enumerate(self.buckets):
                if value <= upper:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1
            self._sum += value
            self._count += 1

    def read(self) -> Dict:
        with self._lock:
            cumulative = {}
            running = 0
            for upper, n in zip(self.buckets, self._counts):
                running += n
                cumulative[f"le_{upper:g}"] = running
            cumulative["le_inf"] = running + self._counts[-1]
            return {"buckets": cumulative, "count": self._count,
                    "sum": self._sum}

    @property
    def count(self) -> int:
        with self._lock:
            return self._count


class Digest:
    """Streaming quantile sketch instrument (engine/digest.py
    :class:`~.digest.QuantileDigest` under the Counter lock
    discipline): ``observe(v)`` bins one observation, ``read()``
    reports count + p50/p95/p99, :meth:`merge_into` folds this
    instrument into a plain digest (the fleet aggregation path —
    order-independent by the sketch's construction).  The bin layout
    is fixed at construction; a memoized re-request with a DIFFERENT
    explicit layout is refused like Histogram's bucket rule."""

    kind = "digest"

    def __init__(self, name: str, labels: Optional[Dict] = None,
                 edges: Iterable[float] = DEFAULT_EDGES):
        self.name = name
        self.labels = _label_key(labels or {})
        self._lock = threading.Lock()
        self._digest = QuantileDigest(edges)

    @property
    def edges(self) -> Tuple[float, ...]:
        return self._digest.edges

    def observe(self, value) -> None:
        with self._lock:
            self._digest.add(float(value))

    def merge_into(self, target: QuantileDigest) -> QuantileDigest:
        """Fold this instrument's counts into ``target`` (same
        layout required) — a snapshot-consistent read under the
        lock."""
        with self._lock:
            return target.merge(self._digest)

    def snapshot(self) -> QuantileDigest:
        with self._lock:
            return QuantileDigest(self._digest.edges,
                                  list(self._digest.counts))

    @property
    def count(self) -> int:
        with self._lock:
            return self._digest.count

    def read(self) -> Dict:
        with self._lock:
            return self._digest.read()


class MetricsRegistry:
    """One process-wide (or harness-wide) instrument store.

    ``counter``/``gauge``/``histogram`` memoize by ``(name, labels)``
    — asking twice returns the same instrument, so call sites never
    cache handles unless they are hot.  ``snapshot()`` is a flat
    ``{key: value}`` dict (histograms as structs), ``delta(prev)``
    subtracts a previous snapshot's counters/histogram counts (gauges
    pass through — a delta of a point-in-time value is meaningless),
    and ``series(name)`` reads one name's whole label family."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, _Labels], object] = {}
        # counter-bump listener specs ``(listener, name_filter)``;
        # every registry-owned Counter carries the tuple of listeners
        # whose filter admits its name, rebound here on add/remove so
        # attaching after the fact still reaches instruments created
        # before it (the flight recorder attaches once and sees every
        # later bump, whoever memoized the handle)
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
        ``inc`` on this registry — the flight recorder's correlation
        hook (engine/tracer.py): one bump, one causally-ordered
        event.  ``name_filter`` (a ``name -> bool`` predicate)
        restricts the subscription at BIND time: instruments it
        rejects never call the listener, so filtered-out families
        pay nothing per bump.  Listeners run outside the instrument
        lock and must not raise (a tracing failure must never fail
        the counted operation — buffer, don't I/O, in the hot
        path)."""
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

    def _get(self, cls, name: str, labels: Dict, **kwargs):
        key = (name, _label_key(labels))
        buckets = kwargs.pop("buckets", None)
        edges = kwargs.pop("edges", None)
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                if cls is Histogram:
                    kwargs["buckets"] = (DEFAULT_BUCKETS
                                         if buckets is None else buckets)
                if cls is Digest:
                    kwargs["edges"] = (DEFAULT_EDGES
                                       if edges is None else edges)
                inst = cls(name, labels, **kwargs)
                if cls is Counter:
                    inst._listeners = self._listeners_for(name)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"{name!r} already registered as {inst.kind}")
            elif edges is not None and inst.edges != tuple(
                    float(e) for e in edges):
                # the Histogram explicit-bucket rule, for digests: a
                # memoized hit must not silently drop a DIFFERENT
                # explicit bin layout
                raise ValueError(
                    f"{name!r} already registered with edges "
                    f"{inst.edges}")
            elif buckets is not None and inst.buckets != tuple(
                    sorted(float(b) for b in buckets)):
                # a memoized hit must not silently drop an EXPLICIT
                # different bucket layout — the caller's observations
                # would land in the wrong buckets with no error.
                # (``buckets=None``, the default, means "whatever the
                # instrument already has" — re-requesting a
                # custom-bucket histogram never restates the layout.)
                raise ValueError(
                    f"{name!r} already registered with buckets "
                    f"{inst.buckets}")
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, *,
                  buckets: Optional[Iterable[float]] = None,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def digest(self, name: str, *,
               edges: Optional[Iterable[float]] = None,
               **labels) -> Digest:
        return self._get(Digest, name, labels, edges=edges)

    def _items(self):
        with self._lock:
            return list(self._instruments.items())

    def prune(self, **labels) -> int:
        """Drop every instrument carrying ALL the given labels;
        returns how many were removed.  For long-lived shared
        registries under agent churn: per-peer series
        (``agent.*{peer=…}``) accumulate forever otherwise — a host
        that has exported/aggregated a departed peer's totals calls
        ``registry.prune(peer=peer_id)`` to reclaim them.  Callers
        holding a pruned instrument's handle keep a live but
        unregistered object (bumps after prune are invisible to
        snapshots), so prune only after the owner is disposed."""
        match = _label_key(labels)
        if not match:
            raise ValueError("prune needs at least one label")
        wanted = set(match)
        with self._lock:
            doomed = [key for key in self._instruments
                      if wanted <= set(key[1])]
            for key in doomed:
                del self._instruments[key]
            return len(doomed)

    def series(self, name: str) -> List[Tuple[Dict[str, str], object]]:
        """All instruments registered under ``name``, as
        ``(labels dict, read value)`` pairs — the labeled-snapshot
        read (e.g. handshake rejects by reason)."""
        return [(dict(labels), inst.read())
                for (n, labels), inst in self._items() if n == name]

    def snapshot(self) -> Dict[str, object]:
        """Flat ``{key: value}`` of every instrument;
        labeled series serialize as ``name{k=v,...}`` keys."""
        return {_format_key(name, labels): inst.read()
                for (name, labels), inst in self._items()}

    def delta(self, prev: Dict[str, object]) -> Dict[str, object]:
        """Current snapshot minus ``prev`` (a prior ``snapshot()``):
        counters subtract, histogram bucket counts/count/sum
        subtract, gauges — and digests, whose quantiles are
        point-in-time summaries a subtraction would scramble — pass
        through unchanged.  Keys absent from ``prev`` diff against
        zero."""
        out = {}
        for (name, labels), inst in self._items():
            key = _format_key(name, labels)
            cur = inst.read()
            before = prev.get(key)
            if inst.kind == "counter":
                out[key] = cur - (before or 0)
            elif inst.kind == "histogram":
                b4 = before or {"buckets": {}, "count": 0, "sum": 0.0}
                out[key] = {
                    "buckets": {le: n - b4["buckets"].get(le, 0)
                                for le, n in cur["buckets"].items()},
                    "count": cur["count"] - b4["count"],
                    "sum": cur["sum"] - b4["sum"],
                }
            else:
                out[key] = cur
        return out


class JsonlExporter:
    """Append-mode JSON-lines metrics export: one ``export()`` call =
    one line ``{"t_ms": <clock.now()>, "metrics": <snapshot>, ...}``.

    The clock is injectable like everywhere else in the engine — the
    soak/swarm harnesses pass their VirtualClock, so exported
    timestamps are deterministic simulated time, not wall time.
    Usable as a context manager; ``close()`` is idempotent."""

    def __init__(self, registry: MetricsRegistry, clock, path: str):
        self.registry = registry
        self.clock = clock
        self.path = path
        self._fh = open(path, "a", encoding="utf-8")

    def export(self, **extra) -> Dict:
        """Write one snapshot line (plus any ``extra`` top-level
        fields, e.g. a round number); returns the record written."""
        record = {"t_ms": self.clock.now(),
                  "metrics": self.registry.snapshot()}
        record.update(extra)
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        return record

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "JsonlExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SpanRecorder:
    """Host-side span tracing for the chunked dispatch pipeline.

    ``with tracer.span("dispatch", chunk=3):`` appends one record
    ``{"name", "start_s", "end_s", "duration_s", **attrs}``
    (``time.perf_counter`` timebase).  Consumed by
    ``run_batch_chunked`` (ops/swarm_sim.py), tools/profile_step.py,
    and bench.py's overlap-efficiency metric."""

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


def overlap_efficiency(pipelined_wall_s: float,
                       unpipelined_wall_s: float,
                       unpipelined_readback_s: float) -> float:
    """Fraction of the unpipelined engine's blocking readback time the
    pipelined engine hid under device compute, clamped to [0, 1]: 1.0
    means every readback second overlapped a later chunk's compute,
    0.0 means pipelining hid nothing (e.g. readback is already
    negligible, or the backend serializes dispatch)."""
    if unpipelined_readback_s <= 0.0:
        return 0.0
    hidden = unpipelined_wall_s - pipelined_wall_s
    return max(0.0, min(1.0, hidden / unpipelined_readback_s))
