"""The chunked, pipelined dispatch of scenario grids: the reference's
``RowEvent``, ``stream_groups_chunked``, ``run_groups_chunked`` and
``run_batch_chunked`` (``ops/swarm_sim.py`` :1935-2478), with its fault
plane, its row cache, its crash-safe journal and its tracing hooks
(``_span`` and ``_trace_ctx``, :1782-1798).

A grid is one or more groups of ``(config, items, build)``: one static
config per group, and ``build(item)`` makes one item's ``(scenario,
join_s)``.  On the general ``[P, K]`` path each scenario carries its
neighbour list and inbound edge lists, which stack with the lanes (the
lanes of one chunk share a width), go through every retry and bisection
with them, and count in the autotuner's footprint at their real widths
(``batch_lane_bytes`` from a built lane).  Each group's items are cut
into chunks of ``chunk`` lanes (``autotune_chunk`` when None), each
chunk is stacked and stepped as one ``run_swarm_batch``, and every row
comes back as ``(offload, rebuffer[, timeline])`` in item order.
Chunks of several groups go round-robin (``interleave``), and with
``pipeline`` the next chunk's scenarios are built on the host while the
card still runs the previous chunk's launches, which are drained only
then.

The fault plane (``faults``, an ``engine.faults.FaultPolicy``): the
policy's plan may inject a fault at the top of every dispatch attempt;
a failed attempt is classified, and an OOM of more than one lane bisects
the chunk (recursively, with ``note_oom_bisection`` feeding the
autotuner's memory fraction), a transient, a timeout or a single lane's
OOM retries after a jittered backoff within ``max_retries``, and a
dispatch whose budget ran out becomes a structured failure: its items
in ``stats[g]["failures"]`` and ``RowEvent``s with ``reason``, ``error``
and a ``None`` metric (``run_*_chunked`` return ``None`` there).  A
classified fault that surfaces at readback re-dispatches its segment
through the same recovery, blocking.  An unclassified error re-raises;
without a policy the first error propagates.

The row cache (``warm_start``, an ``engine.artifact_cache.WarmStart``
with its row cache on): before any dispatch, each item is built once,
keyed (``row_key``) and looked up (``row_load``); a hit streams at once
as a ``RowEvent`` with its ``key`` and ``cached=True`` (a row with a
timeline exactly when ``record_every`` asks for one, else it is
recomputed), and only the misses are chunked, built again at chunk time
and dispatched.  The chunk size still comes from the item count before
the prefilter, and a group whose every row hits dispatches nothing (no
probe build, no autotune, no capture).  ``stats[g]["row_hits"]`` counts
the hits, and ``warm_start.note_prefilter`` gets the prefilter's
seconds.  Each drained row is stored (``row_store``) and streamed with
its key; rows that gave up under the fault plane are neither stored
nor journaled.  While the stream runs, the kernel libraries' checks and
builds are counted by the warm start (``ops/_build.py``'s listeners)
unless its ``aot_enabled`` is off.

The journal (``journal``, an ``engine.artifact_cache.SweepJournal``):
once a drained chunk's rows are stored, their keys go to
``journal.record_rows`` under one fsync, so a killed sweep resumes by
opening its journal with ``resume=True`` and the row cache serves what
it finished.  The journal records keys and the row cache holds the
values: a ``journal`` without the row cache records nothing.

Tracing (``tracer``, ``trace``; both duck-typed and off by default):
``tracer`` (``engine.telemetry.SpanRecorder`` or anything with
``.span(name, **attrs)``) gets a ``build``, a ``dispatch`` and a
``readback`` span of each chunk, tagged ``group`` and ``chunk``.
``trace`` (``engine.tracer.FlightRecorder``) gets the same spans, one
``row`` event a row (a cache hit's before any dispatch, ``cached=True``;
a drained row's with ``journaled=True`` exactly when the journal is
about to record its key for the first time: that row's one finalize
event), and a ``(group, chunk, attempt)`` context around each dispatch
attempt, so the counter bumps the recorder hears from the fault policy
and the warm start inside an attempt carry its coordinates.  The
recorder is flushed before ``journal.record_rows`` (a journaled row's
finalize event is durable before the journal's fsync) and once more at
the end of the stream.  Spans wrap whole dispatches (graph captures and
replays included) and readbacks on the host's clock, never the inside
of a capture.  With both None nothing of this runs: no event objects
and no synchronization.

What differs from the reference, and why:

- no padding of a short chunk.  The reference repeats the last scenario
  so that every dispatch reuses one compiled ``[B, P, …]`` program; the
  port's kernels are launched eagerly and take any ``B``, so a tail
  chunk, and each half of a bisected chunk, runs only its own lanes.
  ``exact_chunk`` is accepted and changes nothing: it fixed that
  canonical shape.  So where the reference's bisection only narrows a
  persistent OOM to the lanes that trip it (its halves allocate what
  the whole chunk did), the port's halves allocate about half: a real
  out-of-memory chunk recovers by bisection.  The failed attempt's
  exception, and with it every tensor its frames hold, is released
  before the halves run, and on the card PyTorch's cache of free memory
  is emptied (a graph capture cannot free cached blocks mid-way).  Rows
  still equal the unfaulted run's to the bit, since lanes are
  independent and each lane's reductions sum in a fixed order
  (``ops/swarm_kernels.py``);
- a warm start has no executables to serve (PyTorch has no serialized
  executable): its ``layer="executable"`` counts the kernel libraries'
  checks and builds instead (``engine/artifact_cache.py``).
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional

import torch

from . import _build
from .swarm_sim import (autotune_chunk, init_swarm, note_oom_bisection,
                        offload_ratio_batch, rebuffer_ratio_batch,
                        run_swarm_batch, stack_pytrees)

class RowEvent(NamedTuple):
    """One completed (or failed) sweep row, streamed out of
    :func:`stream_groups_chunked` the moment its chunk drains.
    ``metric`` is the ``(offload, rebuffer[, timeline])`` tuple, or
    None for a row whose recovery budget ran out (``reason`` and
    ``error`` then carry the failure).  With a row cache, ``key`` is the
    row's cache key and ``cached`` whether the cache served it."""

    group: int
    index: int               # position in the group's item list
    metric: object           # tuple, or None when failed
    key: Optional[str] = None
    cached: bool = False
    reason: Optional[str] = None
    error: Optional[str] = None


def _span(tracer, name: str, **attrs):
    """A span of dispatch tracing (duck-typed: anything with
    ``.span(name, **attrs)``, a ``SpanRecorder`` or a
    ``FlightRecorder``), or nothing when tracing is off."""
    if tracer is None:
        return contextlib.nullcontext()
    return tracer.span(name, **attrs)


def _trace_ctx(trace, **fields):
    """A context frame of the flight recorder (duck-typed: anything
    with ``.context(**fields)``), or nothing when tracing is off."""
    if trace is None:
        return contextlib.nullcontext()
    return trace.context(**fields)


def _release_cache(built) -> None:
    """After an out-of-memory failure on the card, free PyTorch's cache of
    unused device memory before the re-dispatch: the blocks the failed
    attempt left cached cannot be freed while a graph capture is open,
    so they would crowd the next attempt's graph pool."""
    if built[0][0].join_s.device.type == "cuda":
        torch.cuda.empty_cache()


def stream_groups_chunked(groups, n_steps: int, *, watch_s: float,
                          chunk: Optional[int] = None,
                          record_every: int = 0, tracer=None,
                          pipeline: bool = True, interleave: bool = True,
                          warm_start=None, faults=None, journal=None,
                          stats_out=None, exact_chunk: bool = False,
                          trace=None):
    """The dispatch engine as a row stream: a generator of one
    :class:`RowEvent` per grid row as its chunk drains (one chunk
    behind the card with ``pipeline``; a chunk's failed rows after its
    rows; row-cache hits before any dispatch).  ``stats_out``, a list,
    gets one stats dict per group as the groups are prepared (``items``,
    ``chunk`` (None where every row hit and ``chunk`` was None: nothing
    was sized), ``chunks``, ``row_hits`` (0: no row cache),
    ``first_dispatch_s``, ``failures``); the dicts keep updating as the
    stream advances.  See the module docstring for ``faults``,
    ``warm_start``, ``journal``, ``exact_chunk``, ``tracer`` and
    ``trace``."""
    return _stream(groups, n_steps, watch_s=watch_s, chunk=chunk,
                   record_every=record_every, pipeline=pipeline,
                   interleave=interleave, faults=faults,
                   warm_start=warm_start, journal=journal,
                   stats_out=stats_out, exact_chunk=exact_chunk,
                   tracer=tracer, trace=trace)


def _stream(groups, n_steps, *, watch_s, chunk, record_every, pipeline,
            interleave, faults, warm_start, journal, stats_out,
            exact_chunk, tracer, trace):
    """The engine, with the warm start listening to the kernel
    libraries' events while it runs."""
    observe = warm_start is not None and warm_start.aot_enabled
    if observe:
        _build.listen(warm_start)
    try:
        return (yield from _engine(
            groups, n_steps, watch_s=watch_s, chunk=chunk,
            record_every=record_every, pipeline=pipeline,
            interleave=interleave, faults=faults, warm_start=warm_start,
            journal=journal, stats_out=stats_out, exact_chunk=exact_chunk,
            tracer=tracer, trace=trace))
    finally:
        if observe:
            _build.unlisten(warm_start)


def _prefilter(gi, config, items, build, warm_start, n_steps, watch_s,
               record_every):
    """Each item built once, keyed and looked up: ``(hit events, kept
    indices, their keys)``."""
    hits, keep, keys = [], [], []
    for idx, item in enumerate(items):
        scenario, join = build(item)
        key = warm_start.row_key(config, scenario, join, n_steps,
                                 watch_s=watch_s, record_every=record_every)
        del scenario, join
        cached = warm_start.row_load(key)
        if cached is not None and (len(cached) > 2) == bool(record_every):
            hits.append(RowEvent(gi, idx, cached, key=key, cached=True))
        else:
            keep.append(idx)
            keys.append(key)
    return hits, keep, keys


def _engine(groups, n_steps, *, watch_s, chunk, record_every, pipeline,
            interleave, faults, warm_start, journal, stats_out,
            exact_chunk, tracer, trace):
    rows_on = warm_start is not None and warm_start.rows_enabled
    hit_events = []
    prepared = []
    for gi, (config, items, build) in enumerate(groups):
        items = list(items)
        keep, keys = list(range(len(items))), None
        if rows_on:
            t0 = time.perf_counter()
            hits, keep, keys = _prefilter(gi, config, items, build,
                                          warm_start, n_steps, watch_s,
                                          record_every)
            warm_start.note_prefilter(time.perf_counter() - t0)
            hit_events.extend(hits)
        # the chunk comes from the item count before the prefilter: how
        # many rows the cache served does not change a dispatch's shape
        if chunk is None and not keep:
            batch = None   # every row hit: nothing to size
        elif chunk is None:
            # one lane built ahead, so the autotuner sizes the real
            # scenario on the device it lives on
            probe = build(items[keep[0]])[0]
            batch = autotune_chunk(
                config, len(items), n_steps, record_every=record_every,
                scenario=probe, device=probe.join_s.device)
            del probe
        elif exact_chunk:
            batch = max(chunk, 1)
        else:
            batch = max(min(chunk, len(items)), 1)
        prepared.append((config, items, build, batch, keep, keys))
    stats = [{"items": len(items), "chunk": batch, "chunks": 0,
              "row_hits": len(items) - len(keep),
              "first_dispatch_s": None, "failures": []}
             for _, items, _, batch, keep, _ in prepared]
    if stats_out is not None:
        stats_out.extend(stats)
    # hits are already durable in the row cache: they stream first
    for event in hit_events:
        if trace is not None:
            trace.row(event.key, group=event.group, index=event.index,
                      cached=True)
        yield event

    starts = [list(range(0, len(keep), batch)) if keep else []
              for _, _, _, batch, keep, _ in prepared]
    schedule = []  # (group, group-local chunk index, first item)
    if interleave:
        ci = 0
        while any(ci < len(s) for s in starts):
            schedule.extend((gi, ci, s[ci]) for gi, s in enumerate(starts)
                            if ci < len(s))
            ci += 1
    else:
        for gi, s in enumerate(starts):
            schedule.extend((gi, ci, off) for ci, off in enumerate(s))

    def dispatch(gi, ci, config, built, block):
        """One attempt: the plan's injection point, then stack
        ``built`` into lanes, step them, and queue the final ratios;
        the card runs on while the host returns, unless ``block``."""
        if faults is not None:
            faults.before_dispatch(group=gi, chunk=ci)
        scenarios = stack_pytrees([sc for sc, _ in built])
        dev = scenarios.join_s.device
        joins = torch.stack([torch.as_tensor(j, dtype=torch.float32,
                                             device=dev)
                             for _, j in built])
        states = init_swarm(config, device=dev, batch=len(built))
        res = run_swarm_batch(config, scenarios, states, n_steps,
                              record_every=record_every)
        offs = offload_ratio_batch(res[0])
        rebs = rebuffer_ratio_batch(res[0], watch_s, joins)
        rows = res[2] if record_every else None
        if block and dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        return offs, rebs, rows

    def resilient(gi, ci, config, built, start, block):
        """Dispatch ``built`` (``start``-offset within its chunk) under
        the policy's bounded recovery.  Returns ``(segments,
        failures)``: ``(start, n, offs, rebs, rows)`` pieces covering
        the lanes that dispatched, and ``{"offset", "count", "reason",
        "error"}`` for lanes whose budget ran out."""
        attempt = 0
        while True:
            # the attempt, its recovery and the counters they bump carry
            # the attempt's coordinates
            with _trace_ctx(trace, group=gi, chunk=ci, attempt=attempt):
                result = attempt_once(gi, ci, config, built, start, block,
                                      attempt)
            if result is not None:
                return result
            attempt += 1

    def attempt_once(gi, ci, config, built, start, block, attempt):
        """One attempt of :func:`resilient`'s loop: its result, or None
        to retry."""
        try:
            out = dispatch(gi, ci, config, built, block)
            return [(start, len(built)) + out], []
        except Exception as exc:  # fault-ok: classified below —
            # unrecognized reasons (shape errors, typos) re-raise
            reason = faults.classify(exc) if faults is not None else None
            if reason is None:
                raise
            error = str(exc)
        # past the except clause the failed attempt's traceback, and the
        # tensors its frames hold, are released before any re-dispatch
        if reason == "oom":
            _release_cache(built)
            if len(built) > 1:
                faults.record(reason, "bisect")
                note_oom_bisection()
                mid = (len(built) + 1) // 2
                left = resilient(gi, ci, config, built[:mid], start, block)
                right = resilient(gi, ci, config, built[mid:],
                                  start + mid, block)
                return left[0] + right[0], left[1] + right[1]
        # a transient, a timeout, or a single lane's OOM (often another
        # process's burst): jittered backoff within the budget, then a
        # structured give-up
        if attempt >= faults.max_retries:
            faults.record(reason, "giveup")
            return [], [{"offset": start, "count": len(built),
                         "reason": reason, "error": error}]
        faults.record(reason, "retry")
        faults.sleep_backoff(attempt)
        return None

    def readback(offs, rebs, rows):
        offs, rebs = offs.cpu().numpy(), rebs.cpu().numpy()
        arr = None if rows is None else rows.cpu().numpy()
        return [((float(o), float(r)) if arr is None
                 else (float(o), float(r), arr[lane]))
                for lane, (o, r) in enumerate(zip(offs, rebs))]

    def drain(gi, ci, idxs, keys, config, built, segments, failures):
        """The chunk's rows, then its failed items, as events, under the
        chunk's readback span.  With a row cache each row is stored; with
        a journal too, the chunk's stored keys are journaled under one
        fsync, after the recorder's flush."""
        with _span(tracer, "readback", group=gi, chunk=ci), \
                _span(trace, "readback", group=gi, chunk=ci):
            events = []
            journaled = []
            work = list(segments)
            while work:
                start, n, *out = work.pop(0)
                try:
                    out = readback(*out)
                except Exception as exc:  # fault-ok: classified — an
                    # unrecognized readback failure re-raises
                    reason = faults.classify(exc) if faults is not None \
                        else None
                    if reason is None:
                        raise
                    # an asynchronous fault surfacing at readback: count it,
                    # then re-dispatch the segment through the same
                    # recovery, blocking
                    faults.record(reason, "retry")
                    resegs, refails = resilient(gi, ci, config,
                                                built[start:start + n], start,
                                                True)
                    work = resegs + work
                    failures = failures + refails
                    continue
                for pos, metric in enumerate(out):
                    key = None if keys is None else keys[start + pos]
                    fresh = False
                    if key is not None:
                        warm_start.row_store(key, metric)
                        if journal is not None:
                            fresh = key not in journal.completed
                            journaled.append(key)
                    if trace is not None:
                        # fresh: record_rows below journals the key, so this
                        # is the row's one finalize event
                        trace.row(key, group=gi, index=idxs[start + pos],
                                  journaled=fresh)
                    events.append(RowEvent(gi, idxs[start + pos], metric,
                                           key=key))
            if journaled:
                if trace is not None:
                    trace.flush()
                journal.record_rows(journaled)
            for failure in failures:
                items = [idxs[failure["offset"] + j]
                         for j in range(failure["count"])]
                stats[gi]["failures"].append({"items": items,
                                              "reason": failure["reason"],
                                              "error": failure["error"]})
                events.extend(RowEvent(gi, i, None, reason=failure["reason"],
                                       error=failure["error"]) for i in items)
            return events

    pending = None
    for gi, ci, off in schedule:
        config, items, build, batch, keep, keys = prepared[gi]
        idxs = keep[off:off + batch]
        chunk_keys = None if keys is None else keys[off:off + batch]
        with _span(tracer, "build", group=gi, chunk=ci), \
                _span(trace, "build", group=gi, chunk=ci):
            built = [build(items[i]) for i in idxs]
        t0 = time.perf_counter()
        with _span(tracer, "dispatch", group=gi, chunk=ci), \
                _span(trace, "dispatch", group=gi, chunk=ci):
            segments, failures = resilient(gi, ci, config, built, 0,
                                           not pipeline)
        if stats[gi]["first_dispatch_s"] is None:
            stats[gi]["first_dispatch_s"] = time.perf_counter() - t0
        stats[gi]["chunks"] += 1
        entry = (gi, ci, idxs, chunk_keys, config, built, segments,
                 failures)
        if not pipeline:
            yield from drain(*entry)
            continue
        if pending is not None:
            yield from drain(*pending)
        pending = entry
    if pending is not None:
        yield from drain(*pending)
    if trace is not None:
        trace.flush()
    return stats


def run_groups_chunked(groups, n_steps: int, *, watch_s: float,
                       chunk: Optional[int] = None,
                       record_every: int = 0, tracer=None,
                       pipeline: bool = True, interleave: bool = True,
                       warm_start=None, faults=None, journal=None,
                       trace=None):
    """Chunked, pipelined dispatch over several groups: drains
    :func:`stream_groups_chunked` and returns ``(results, stats)``.
    ``results[g]`` lists group ``g``'s per-item ``(offload, rebuffer)``
    floats in item order, with a ``[n_steps // record_every, M]`` numpy
    timeline appended when ``record_every > 0``, and None for an item
    whose recovery budget ran out; ``stats[g]`` is the group's stats
    dict.  Chunks are independent, so the schedule (``interleave``,
    ``pipeline``), the recovery and the row cache never change a row."""
    groups = [(config, list(items), build)
              for config, items, build in groups]
    results = [[None] * len(items) for _, items, _ in groups]
    stats = []
    for event in stream_groups_chunked(
            groups, n_steps, watch_s=watch_s, chunk=chunk,
            record_every=record_every, tracer=tracer, pipeline=pipeline,
            interleave=interleave, warm_start=warm_start, faults=faults,
            journal=journal, stats_out=stats, trace=trace):
        if event.metric is not None:
            results[event.group][event.index] = event.metric
    return results, stats


def run_batch_chunked(config, items, build, n_steps: int, *,
                      watch_s: float, chunk: Optional[int] = None,
                      record_every: int = 0, tracer=None,
                      pipeline: bool = True, warm_start=None, faults=None,
                      journal=None, trace=None):
    """Single-group front end for :func:`run_groups_chunked`: per-item
    ``(offload, rebuffer[, timeline])`` in item order (None for an item
    whose recovery budget ran out).  ``chunk=None`` autotunes the lanes
    per dispatch from the card's free memory (``autotune_chunk``)."""
    items = list(items)
    if not items:
        return []
    results, _stats = run_groups_chunked(
        [(config, items, build)], n_steps, watch_s=watch_s, chunk=chunk,
        record_every=record_every, tracer=tracer, pipeline=pipeline,
        warm_start=warm_start, faults=faults, journal=journal, trace=trace)
    return results[0]
