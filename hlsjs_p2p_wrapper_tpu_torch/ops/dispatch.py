"""The chunked, pipelined dispatch of scenario grids: the reference's
``RowEvent``, ``stream_groups_chunked``, ``run_groups_chunked`` and
``run_batch_chunked`` (``ops/swarm_sim.py`` :1935-2478), with its fault
plane.

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
- the warm-start caches, the journal and tracing are not ported: a
  ``warm_start``, ``journal``, ``trace`` or ``tracer`` other than None
  raises ``NotImplementedError`` (ROADMAP queue 1 items 7-8).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from .swarm_sim import (autotune_chunk, init_swarm, note_oom_bisection,
                        offload_ratio_batch, rebuffer_ratio_batch,
                        run_swarm_batch, stack_pytrees)

#: the dispatch options the port does not take yet, and the ROADMAP
#: queue 1 item that brings each
_NOT_PORTED = {"warm_start": "item 7 (warm-start caches)",
               "journal": "item 7 (the crash-safe journal)",
               "trace": "item 8 (the flight recorder)",
               "tracer": "item 8 (dispatch spans)"}


class RowEvent(NamedTuple):
    """One completed (or failed) sweep row, streamed out of
    :func:`stream_groups_chunked` the moment its chunk drains.
    ``metric`` is the ``(offload, rebuffer[, timeline])`` tuple, or
    None for a row whose recovery budget ran out (``reason`` and
    ``error`` then carry the failure).  ``key`` and ``cached``, which
    the reference's row cache fills, keep their defaults here."""

    group: int
    index: int               # position in the group's item list
    metric: object           # tuple, or None when failed
    key: Optional[str] = None
    cached: bool = False
    reason: Optional[str] = None
    error: Optional[str] = None


def _refuse_unported(**options) -> None:
    for name, value in options.items():
        if value is not None:
            raise NotImplementedError(
                f"dispatch option {name!r} is not ported yet (ROADMAP "
                f"queue 1 {_NOT_PORTED[name]})")


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
    rows).  ``stats_out``, a list, gets one stats dict per group as the
    groups are prepared (``items``, ``chunk``, ``chunks``, ``row_hits``
    (0: no row cache), ``first_dispatch_s``, ``failures``); the dicts
    keep updating as the stream advances.  See the module docstring
    for ``faults``, ``exact_chunk`` and the unported options, which are
    checked here, before the first row is asked for."""
    _refuse_unported(tracer=tracer, warm_start=warm_start, journal=journal,
                     trace=trace)
    return _stream(groups, n_steps, watch_s=watch_s, chunk=chunk,
                   record_every=record_every, pipeline=pipeline,
                   interleave=interleave, faults=faults,
                   stats_out=stats_out, exact_chunk=exact_chunk)


def _stream(groups, n_steps, *, watch_s, chunk, record_every, pipeline,
            interleave, faults, stats_out, exact_chunk):
    prepared = []
    for config, items, build in groups:
        items = list(items)
        if chunk is None:
            # one lane built ahead, so the autotuner sizes the real
            # scenario on the device it lives on
            probe = build(items[0])[0] if items else None
            batch = autotune_chunk(
                config, len(items), n_steps, record_every=record_every,
                scenario=probe,
                device=None if probe is None else probe.join_s.device)
        elif exact_chunk:
            batch = max(chunk, 1)
        else:
            batch = max(min(chunk, len(items)), 1)
        prepared.append((config, items, build, batch))
    stats = [{"items": len(items), "chunk": batch, "chunks": 0,
              "row_hits": 0, "first_dispatch_s": None, "failures": []}
             for _, items, _, batch in prepared]
    if stats_out is not None:
        stats_out.extend(stats)

    starts = [list(range(0, len(items), batch))
              for _, items, _, batch in prepared]
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

    def drain(gi, ci, idxs, config, built, segments, failures):
        """The chunk's rows, then its failed items, as events."""
        events = []
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
            events.extend(RowEvent(gi, idxs[start + pos], metric)
                          for pos, metric in enumerate(out))
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
        config, items, build, batch = prepared[gi]
        idxs = list(range(off, min(off + batch, len(items))))
        built = [build(items[i]) for i in idxs]
        t0 = time.perf_counter()
        segments, failures = resilient(gi, ci, config, built, 0,
                                       not pipeline)
        if stats[gi]["first_dispatch_s"] is None:
            stats[gi]["first_dispatch_s"] = time.perf_counter() - t0
        stats[gi]["chunks"] += 1
        entry = (gi, ci, idxs, config, built, segments, failures)
        if not pipeline:
            yield from drain(*entry)
            continue
        if pending is not None:
            yield from drain(*pending)
        pending = entry
    if pending is not None:
        yield from drain(*pending)
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
    ``pipeline``) and the recovery never change a row."""
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
        _refuse_unported(tracer=tracer, warm_start=warm_start,
                         journal=journal, trace=trace)
        return []
    results, _stats = run_groups_chunked(
        [(config, items, build)], n_steps, watch_s=watch_s, chunk=chunk,
        record_every=record_every, tracer=tracer, pipeline=pipeline,
        warm_start=warm_start, faults=faults, journal=journal, trace=trace)
    return results[0]
