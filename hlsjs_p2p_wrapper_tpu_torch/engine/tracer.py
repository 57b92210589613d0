# A copy of the reference's engine/tracer.py (hlsjs_p2p_wrapper_tpu/engine/tracer.py): the
# same names, formats and bytes; only the imports point at the port's own
# modules.
"""Causal flight recorder: ONE event plane across dispatch, faults,
warm-start caching, and the multi-host fabric.

The reference wrapper could only ever be observed through a browser
tab (PAPER.md §0); this rebuild had grown FOUR disjoint telemetry
surfaces — on-device timelines, the :class:`~.telemetry
.MetricsRegistry` JSONL export, :class:`~.telemetry.SpanRecorder`
chunk spans, and the fabric's claim files — with nothing tying a
retry in engine/faults.py to the chunk span it delayed, the lease it
nearly expired, or the row it finally produced.  This module is the
unifying layer: a single append-only structured EVENT STREAM with a
propagated trace context, written per host and merged causally.

**The stream.**  A :class:`FlightRecorder` owns one per-host shard
(``<trace_dir>/<host_id>.jsonl``) whose first line is a JSONL
``meta`` record (``run_id`` / ``host``) and whose every later
record is one event::

    {"t": <clock>, "host": "host01", "seq": 17, "kind": "span",
     "name": "dispatch", "dur_s": 0.41,
     "ctx": {"group": 0, "chunk": 3, "attempt": 0}}

By default (``binary=True``) events land as the compact CRC-framed
records of :mod:`~.recordio` — hot families as fixed-width frames,
everything else as framed chunked JSON — while ``binary=False``
writes plain JSON lines; either way the record DICTS above are
exactly what every reader returns, and a shard may mix both freely
(readers sniff the format per record on the lead byte).  Events are
BUFFERED in memory and made durable by :meth:`flush` — the same
append + flush + fsync + torn-tail-tolerant record discipline the
sweep journal uses (one fsync per drained chunk, not per event;
readers share :func:`~.recordio.read_records`, so a SIGKILL
mid-append costs at most the torn tail frame or line, and a flipped
bit costs exactly one counted record).  The dispatch engine flushes finalize events
BEFORE the journal fsyncs its row keys, so "journaled" always
implies "its finalize event is on disk" — the direction the trace
gate asserts.  Two hosts never share a shard (the journal-shard
lesson: unsynchronized appends interleave torn), and
:func:`merge_trace` merges shards by ``(virtual-clock, host, seq)``
— per-host order is exactly file order, so a merged stream is
prefix-consistent per host even read mid-write.

**Event kinds** (the whole vocabulary):

- ``span`` — one build / dispatch / readback phase
  (``name`` / ``dur_s``; duck-typed ``.span()`` like SpanRecorder);
- ``counter`` — one registry counter bump
  (``name`` / ``labels`` / ``n``), fed by
  :meth:`~.telemetry.MetricsRegistry.add_listener`: EVERY existing
  ``dispatch_faults`` / ``fabric_claims`` / ``aot_cache_events``
  increment gains a correlated event with zero call-site changes,
  and :func:`replay_counter_families` folds the stream back into
  the exact ``{family: {labels: value}}`` the registry holds — the
  trace gate's completeness proof;
- ``row`` — one grid row streamed out of the dispatch engine
  (``key`` / ``cached`` / ``journaled``: a ``journaled=True`` event
  is that row's ONE finalize record, mirrored 1:1 by the journal
  shard);
- ``lease`` — one fabric protocol step
  (``action=claim|reclaim|steal|beat|done|duplicate``, where
  ``reclaim`` is a host superseding its OWN expired lease;
  ``unit`` / ``gen``), flushed eagerly so a console tailing the
  shard sees lease health live;
- ``mark`` — free-form annotations (tools' run boundaries).

**The context.**  ``run_id`` / ``host_id`` live in the shard meta;
transient coordinates (``group`` / ``chunk`` / ``attempt`` /
``row_key``) are pushed with ``with recorder.context(...):`` and
stamped onto every event emitted inside — including counter bumps
made deep inside the warm-start cache or the fault policy, which is
precisely the correlation the four disjoint surfaces could not
express.  The stack is thread-local; a thread outside any context
inherits none (never another thread's).

Recording is strictly OPT-IN: the dispatch engine's ``trace=``
parameter defaults to ``None`` and every hook degrades to a no-op
(bench.py's ``detail.trace_overhead`` rider holds the armed cost
under 3% of the warm sweep wall, rows bit-identical on vs off).

Wall-clock routes through the injectable ``clock`` callable (the
FaultPolicy convention; tools/lint.py holds this file to it), so
tests order merged streams with fake clocks instead of sleeps.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Tuple

from . import recordio
from .artifact_cache import _digest
from .telemetry import MetricsRegistry

#: the registry counter families the trace gate replays and the
#: fleet console derives activity from — the event plane must carry
#: these completely or `make trace-gate` is red
REPLAYED_FAMILIES = ("dispatch_faults", "fabric_claims",
                     "aot_cache_events")


def run_id_for(meta: dict) -> str:
    """Deterministic run id from the sweep-identity meta — through
    the SAME content-addressing the journal and fabric use
    (:func:`~.artifact_cache._digest`), so every host of one fleet
    run stamps the same id with no coordination and the id follows
    any future canonicalization change in lockstep."""
    return _digest({"kind": "trace-run", **meta})[:16]


def _labels_str(labels) -> str:
    """Canonical ``k=v,...`` (sorted) label rendering — the one
    format the recorder, the replay, and the exported partials
    share, so equality checks are string equality.  Registry bumps
    hand over the registry's interned sorted label TUPLE, so the
    rendering is memoized per distinct label set — the bump listener
    is on the swarm data plane's hot path (one event per fetch
    delta), where re-rendering measured ~25% of the per-event cost."""
    if isinstance(labels, dict):
        items = sorted((k, str(v)) for k, v in labels.items())
        return ",".join(f"{k}={v}" for k, v in items)
    cached = _LABELS_STR_CACHE.get(labels)
    if cached is None:
        if len(_LABELS_STR_CACHE) >= _LABELS_STR_CACHE_MAX:
            # a pure memo, so dropping it only costs re-rendering:
            # clear-on-cap (the re-module cache pattern) keeps the
            # hot path one dict.get while bounding a long-lived
            # host — per-peer tuples outlive registry.prune here,
            # since the registry drops its keys but not this memo
            _LABELS_STR_CACHE.clear()
        cached = ",".join(f"{k}={v}" for k, v in labels)
        _LABELS_STR_CACHE[labels] = cached
    return cached


#: memoized sorted-tuple renderings, capped so a process that churns
#: per-peer label sets for days (soak, the live control-plane
#: service) cannot grow it without bound
_LABELS_STR_CACHE: dict = {}
_LABELS_STR_CACHE_MAX = 65536


class FlightRecorder:
    """One host's handle on the event plane (module docstring).

    ``registry=`` (or a later :meth:`attach`) subscribes the
    recorder to that registry's counter bumps; ``clock`` is the
    virtual-clock injection point (VirtualClock in harnesses, wall
    time in the tools).  Use as a context manager; ``close()``
    flushes and is idempotent."""

    def __init__(self, trace_dir: str, host_id: str = "host00", *,
                 run_id: Optional[str] = None, clock=time.time,
                 registry: Optional[MetricsRegistry] = None,
                 counter_filter=None, bump_filter=None,
                 binary: bool = True):
        #: optional predicate on the counter FAMILY name: when set,
        #: only matching bumps become events (explicit emits — spans,
        #: marks, rows, leases — are never filtered).  For recorders
        #: scoped to one data plane (the twin sampler records the
        #: ``twin.*`` provenance families), where recording every
        #: unrelated family's bumps is measurable hot-path cost; the
        #: default None keeps the complete-ground-truth contract the
        #: trace gate replays (counter events == registries exactly).
        self._counter_filter = counter_filter
        #: optional LABEL-AWARE predicate ``(name, labels_str) ->
        #: bool`` on counter bumps, applied after ``counter_filter``.
        #: The fleet-ingest need: N sampler-host processes observing
        #: the SAME swarm each record only THEIR assigned peers'
        #: ``twin.*`` bumps, so the merged shards carry each event
        #: exactly once.  Unlike the name filter it cannot bind into
        #: the registry (labels are per-bump), so it costs one
        #: predicate call per recorded bump — scope it with a
        #: ``counter_filter`` so unrelated families never reach it.
        self._bump_filter = bump_filter
        os.makedirs(trace_dir, exist_ok=True)
        self.trace_dir = trace_dir
        self.host_id = host_id
        self.run_id = run_id or os.urandom(8).hex()
        self.path = os.path.join(trace_dir, f"{host_id}.jsonl")
        self._clock = clock
        self._lock = threading.Lock()
        self._seq = 0
        self._buffer: List[bytes] = []
        self._local = threading.local()
        self._registries: List[MetricsRegistry] = []
        #: ``binary=True`` (the default) frames hot families through
        #: the recordio codec; ``binary=False`` keeps the pre-0.18
        #: all-JSONL shard.  Either way the file is ONE mixed-format
        #: stream read back by the same sniffing reader, so the
        #: parameter changes bytes, never meaning.
        self.binary = binary
        self._encoder = recordio.ShardEncoder() if binary else None
        self._fh = open(self.path, "ab")
        self._write_now({"kind": "meta", "run_id": self.run_id,
                         "host": host_id})
        if registry is not None:
            self.attach(registry)

    # -- the context stack ---------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current_context(self) -> dict:
        """The merged view of the thread's pushed context frames
        (inner frames win on key collisions)."""
        merged: dict = {}
        for frame in self._stack():
            merged.update(frame)
        return merged

    @contextmanager
    def context(self, **fields):
        """Push trace-context fields (``group`` / ``chunk`` /
        ``attempt`` / ``row_key`` / …) for the dynamic extent: every
        event emitted inside — explicit or via a counter bump —
        carries them."""
        stack = self._stack()
        stack.append(fields)
        try:
            yield self
        finally:
            stack.pop()

    # -- emission -------------------------------------------------------

    def _write_now(self, record: dict) -> None:
        """One immediately-durable record (the shard meta header):
        whole line, flush, fsync.  The meta stays a JSONL line even
        in binary mode — it is the shard's self-describing head, and
        `head -1` / any text tool must keep working on it."""
        line = (json.dumps(record)  # jsonl-ok: meta header line
                + "\n").encode("utf-8")
        with self._lock:
            self._fh.write(line)
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def emit(self, kind: str, **fields) -> dict:
        """Buffer one event (clock-stamped, sequence-numbered,
        context-tagged).  Durability is :meth:`flush`'s job — the
        hot path does dict + append only."""
        ctx = self.current_context()
        record = {"t": self._clock(), "host": self.host_id,
                  "kind": kind, **fields}
        if ctx:
            record["ctx"] = ctx
        with self._lock:
            record["seq"] = self._seq
            self._seq += 1
            if self._encoder is not None:
                # encode under the lock: the shard's string table
                # must be appended in buffer order
                self._buffer.append(self._encoder.encode(record))
            else:
                self._buffer.append(
                    (json.dumps(record)  # jsonl-ok: binary=False
                     + "\n").encode("utf-8"))
        return record

    def flush(self, fsync: bool = True) -> None:
        """Make every buffered event durable under ONE flush +
        fsync — the journal's per-drained-chunk discipline.  The
        dispatch engine calls this BEFORE the journal fsyncs a
        chunk's row keys, so a journaled row's finalize event can
        never be lost to a crash the journal survived.

        ``fsync=False`` stops at the OS write: enough for
        PROCESS-death durability (a SIGKILL'd writer's flushed pages
        survive in the page cache; only a host crash can lose them),
        and what high-cadence flushers use — the twin sampler flushes
        every observation window, where per-window fsyncs were a
        measured double-digit share of the armed event plane's cost
        (bench.py ``detail.twin_overhead``) for no additional
        process-level guarantee."""
        with self._lock:
            if not self._buffer:
                return
            self._fh.write(b"".join(self._buffer))
            self._buffer.clear()
            self._fh.flush()
            if fsync:
                os.fsync(self._fh.fileno())

    @contextmanager
    def span(self, name: str, **attrs):
        """One phase span event (duck-type compatible with
        :class:`~.telemetry.SpanRecorder`, so the engine's existing
        ``tracer=`` plumbing carries either).  Emitted at EXIT —
        the event's ``t`` stamp stays monotone per host, which is
        what keeps the merged per-host order equal to file order —
        with the entry stamp in ``t_start`` and a perf_counter
        ``dur_s``, which is what the Perfetto exporter renders."""
        t0 = self._clock()
        start = time.perf_counter()
        try:
            yield
        finally:
            self.emit("span", name=name, t_start=t0,
                      dur_s=time.perf_counter() - start, **attrs)

    def row(self, key: Optional[str], *, group: int, index: int,
            cached: bool = False, journaled: bool = False) -> None:
        """One completed grid row.  ``journaled=True`` marks THE
        finalize event for that key: the dispatch engine emits it
        exactly once per key it is about to journal, and the trace
        gate maps journal records onto these 1:1."""
        self.emit("row", key=key, group=group, index=index,
                  cached=cached, journaled=journaled)

    def lease(self, action: str, *, unit: int, gen: int,
              **fields) -> None:
        """One fabric lease-protocol step, flushed eagerly (lease
        events are rare and a live console must see them without
        waiting for the next chunk drain)."""
        self.emit("lease", action=action, unit=unit, gen=gen,
                  **fields)
        self.flush()

    def mark(self, name: str, **fields) -> None:
        self.emit("mark", name=name, **fields)

    # -- registry correlation -------------------------------------------

    def attach(self, registry: MetricsRegistry) -> "FlightRecorder":
        """Subscribe to a registry's counter bumps: each ``inc``
        becomes one ``counter`` event carrying the current trace
        context — the correlation layer that ties a
        ``dispatch_faults{reason=oom,action=bisect}`` increment to
        the exact (group, chunk, attempt) that suffered it."""
        if registry not in self._registries:
            # the filter rides into the registry as the listener's
            # bind-time name_filter, so instruments outside it never
            # call back at all (zero per-bump cost, not a cheap
            # early return)
            registry.add_listener(self._on_bump,
                                  name_filter=self._counter_filter)
            self._registries.append(registry)
        return self

    def detach(self) -> None:
        for registry in self._registries:
            registry.remove_listener(self._on_bump)
        self._registries.clear()

    def _on_bump(self, name: str, labels, n) -> None:
        if (self._counter_filter is not None
                and not self._counter_filter(name)):
            # belt-and-suspenders: bind-time filtering already keeps
            # filtered instruments from calling here, but a listener
            # invoked directly (tests, foreign registries) must still
            # honor the filter
            return
        if self._bump_filter is not None \
                and not self._bump_filter(name, _labels_str(labels)):
            return
        encoder = self._encoder
        if encoder is not None \
                and not getattr(self._local, "stack", None):
            # the armed hot path: no context frames, so skip the
            # record dict entirely — clock, labels memo, one framed
            # struct.pack under the buffer lock
            labels_s = _labels_str(labels)
            t = self._clock()
            with self._lock:
                encoded = encoder.encode_bump(
                    t, self.host_id, name, labels_s, n, self._seq)
                if encoded is not None:
                    self._seq += 1
                    self._buffer.append(encoded)
                    return
        self.emit("counter", name=name, labels=_labels_str(labels),
                  n=n)

    # -- lifecycle ------------------------------------------------------

    def close(self) -> None:
        self.detach()
        if not self._fh.closed:
            self.flush()
            self._fh.close()

    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- reading / merging / replaying --------------------------------------

def shard_paths(trace_dir: str) -> List[str]:
    """Every event shard in a trace directory, host-sorted."""
    if not os.path.isdir(trace_dir):
        return []
    return [os.path.join(trace_dir, name)
            for name in sorted(os.listdir(trace_dir))
            if name.endswith(".jsonl")]


def read_shard(path: str) -> Tuple[Optional[dict], List[dict]]:
    """One shard's ``(meta, events)`` — torn-tail tolerant, so a
    shard read mid-write (or SIGKILLed mid-append) yields the
    durable prefix and never raises on the tail.  Format-sniffing
    (:func:`~.recordio.read_records`): binary, JSONL, and mixed
    shards all decode here, so every pre-0.18 consumer reads new
    shards with zero call-site changes."""
    meta = None
    events = []
    records, _stats = recordio.read_records(path)
    for record in records:
        if record.get("kind") == "meta":
            meta = record
        else:
            events.append(record)
    return meta, events


def merge_trace(source) -> List[dict]:
    """The causally-merged event stream of a trace directory (or an
    explicit iterable of shard paths): sorted by
    ``(virtual-clock, host, seq)``.  Per-host relative order is
    file order (``seq`` is monotone per shard and the clock is
    monotone per host), so the merge is prefix-consistent per host
    even against a shard still being appended; cross-host order is
    as good as the hosts' clock agreement — the fabric's NTP caveat
    applies here verbatim."""
    paths = (shard_paths(source) if isinstance(source, str)
             else list(source))
    events: List[dict] = []
    for path in paths:
        try:
            _meta, shard_events = read_shard(path)
        except OSError:
            continue
        events.extend(shard_events)
    events.sort(key=lambda e: (e.get("t", 0.0), str(e.get("host")),
                               e.get("seq", 0)))
    return events


def counter_families(registry: MetricsRegistry,
                     names: Iterable[str] = REPLAYED_FAMILIES
                     ) -> Dict[str, Dict[str, float]]:
    """The registry's live view of the replayed families, in the
    canonical ``{family: {"k=v,...": value}}`` form — what the fabric
    workers export into their partial artifacts and the trace gate
    compares :func:`replay_counter_families` against."""
    return {name: {_labels_str(labels): value
                   for labels, value in registry.series(name)}
            for name in names}


def replay_counter_families(events: Iterable[dict],
                            names: Iterable[str] = REPLAYED_FAMILIES
                            ) -> Dict[str, Dict[str, float]]:
    """Fold a merged (or single-shard) event stream back into
    counter families: summing every ``counter`` event's ``n`` per
    (name, labels) must reproduce the source registry EXACTLY —
    the event plane is complete ground truth or the trace gate is
    red."""
    wanted = set(names)
    out: Dict[str, Dict[str, float]] = {name: {} for name in names}
    for event in events:
        if event.get("kind") != "counter":
            continue
        name = event.get("name")
        if name not in wanted:
            continue
        family = out[name]
        key = event.get("labels", "")
        family[key] = family.get(key, 0) + event.get("n", 0)
    return out


def finalize_keys(events: Iterable[dict]) -> Dict[str, int]:
    """``{row key: finalize-event count}`` over a stream — the
    journal↔trace cross-check's trace side (each key a host
    journaled must appear here exactly once for that host's
    shard)."""
    counts: Dict[str, int] = {}
    for event in events:
        if (event.get("kind") == "row" and event.get("journaled")
                and event.get("key")):
            counts[event["key"]] = counts.get(event["key"], 0) + 1
    return counts
