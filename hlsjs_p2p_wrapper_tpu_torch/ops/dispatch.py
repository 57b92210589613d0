"""The chunked, pipelined dispatch of scenario grids: the reference's
``RowEvent``, ``stream_groups_chunked``, ``run_groups_chunked`` and
``run_batch_chunked`` (``ops/swarm_sim.py`` :1935-2478), their
no-fault core.

A grid is one or more groups of ``(config, items, build)``: one static
config per group, and ``build(item)`` makes one item's ``(scenario,
join_s)``.  Each group's items are cut into chunks of ``chunk`` lanes
(``autotune_chunk`` when None), each chunk is stacked and stepped as one
``run_swarm_batch``, and every row comes back as ``(offload, rebuffer[,
timeline])`` in item order.  Chunks of several groups go round-robin
(``interleave``), and with ``pipeline`` the next chunk's scenarios are
built on the host while the card still runs the previous chunk's
launches, which are drained only then.

What differs from the reference, and why:

- no padding of a short tail chunk.  The reference repeats the last
  scenario so that every dispatch reuses one compiled ``[B, P, …]``
  program; the port's kernels are launched eagerly and take any ``B``,
  so a tail chunk runs only its own lanes.  ``exact_chunk`` is accepted
  and changes nothing: it fixed that canonical shape;
- the fault plane (retries, OOM bisection), the warm-start caches, the
  journal and tracing are not ported: a ``faults``, ``warm_start``,
  ``journal``, ``trace`` or ``tracer`` other than None raises
  ``NotImplementedError`` (ROADMAP queue 1 items 6-8).

Rows do not depend on the chunking: lanes are independent and each
lane's reductions sum in a fixed order (``ops/swarm_kernels.py``).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from .swarm_sim import (autotune_chunk, init_swarm, offload_ratio_batch,
                        rebuffer_ratio_batch, run_swarm_batch,
                        stack_pytrees)

#: the dispatch options the port does not take yet, and the ROADMAP
#: queue 1 item that brings each
_NOT_PORTED = {"faults": "item 6 (the fault plane)",
               "warm_start": "item 7 (warm-start caches)",
               "journal": "item 7 (the crash-safe journal)",
               "trace": "item 8 (the flight recorder)",
               "tracer": "item 8 (dispatch spans)"}


class RowEvent(NamedTuple):
    """One completed sweep row, streamed out of
    :func:`stream_groups_chunked` the moment its chunk drains.
    ``metric`` is the ``(offload, rebuffer[, timeline])`` tuple.  The
    fields the reference's caches and fault plane fill (``key``,
    ``cached``, ``reason``, ``error``) keep their defaults here."""

    group: int
    index: int               # position in the group's item list
    metric: object
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


def stream_groups_chunked(groups, n_steps: int, *, watch_s: float,
                          chunk: Optional[int] = None,
                          record_every: int = 0, tracer=None,
                          pipeline: bool = True, interleave: bool = True,
                          warm_start=None, faults=None, journal=None,
                          stats_out=None, exact_chunk: bool = False,
                          trace=None):
    """The dispatch engine as a row stream: a generator of one
    :class:`RowEvent` per grid row as its chunk drains (one chunk
    behind the card with ``pipeline``).  ``stats_out``, a list, gets
    one stats dict per group as the groups are prepared (``items``,
    ``chunk``, ``chunks``, ``row_hits`` (0: no row cache),
    ``first_dispatch_s``, ``failures`` (empty: no fault plane)); the
    dicts keep updating as the stream advances.  See the module
    docstring for what ``exact_chunk`` and the unported options do.
    The options are checked here, before the first row is asked for."""
    _refuse_unported(tracer=tracer, warm_start=warm_start, faults=faults,
                     journal=journal, trace=trace)
    return _stream(groups, n_steps, watch_s=watch_s, chunk=chunk,
                   record_every=record_every, pipeline=pipeline,
                   interleave=interleave, stats_out=stats_out,
                   exact_chunk=exact_chunk)


def _stream(groups, n_steps, *, watch_s, chunk, record_every, pipeline,
            interleave, stats_out, exact_chunk):
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

    def dispatch(config, built, block):
        """Stack ``built`` into lanes, step them, and queue the final
        ratios; the card runs on while the host returns, unless
        ``block``."""
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

    def drain(gi, idxs, offs, rebs, rows):
        offs, rebs = offs.cpu().numpy(), rebs.cpu().numpy()
        arr = None if rows is None else rows.cpu().numpy()
        out = []
        for lane, (i, o, r) in enumerate(zip(idxs, offs, rebs)):
            metric = ((float(o), float(r)) if arr is None
                      else (float(o), float(r), arr[lane]))
            out.append(RowEvent(gi, i, metric))
        return out

    pending = None
    for gi, _ci, off in schedule:
        config, items, build, batch = prepared[gi]
        idxs = list(range(off, min(off + batch, len(items))))
        built = [build(items[i]) for i in idxs]
        t0 = time.perf_counter()
        result = dispatch(config, built, not pipeline)
        if stats[gi]["first_dispatch_s"] is None:
            stats[gi]["first_dispatch_s"] = time.perf_counter() - t0
        stats[gi]["chunks"] += 1
        entry = (gi, idxs) + result
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
    timeline appended when ``record_every > 0``; ``stats[g]`` is the
    group's stats dict.  Chunks are independent, so the schedule
    (``interleave``, ``pipeline``) never changes a row."""
    groups = [(config, list(items), build)
              for config, items, build in groups]
    results = [[None] * len(items) for _, items, _ in groups]
    stats = []
    for event in stream_groups_chunked(
            groups, n_steps, watch_s=watch_s, chunk=chunk,
            record_every=record_every, tracer=tracer, pipeline=pipeline,
            interleave=interleave, warm_start=warm_start, faults=faults,
            journal=journal, stats_out=stats, trace=trace):
        results[event.group][event.index] = event.metric
    return results, stats


def run_batch_chunked(config, items, build, n_steps: int, *,
                      watch_s: float, chunk: Optional[int] = None,
                      record_every: int = 0, tracer=None,
                      pipeline: bool = True, warm_start=None, faults=None,
                      journal=None, trace=None):
    """Single-group front end for :func:`run_groups_chunked`: per-item
    ``(offload, rebuffer[, timeline])`` in item order.  ``chunk=None``
    autotunes the lanes per dispatch from the card's free memory
    (``autotune_chunk``)."""
    items = list(items)
    if not items:
        _refuse_unported(tracer=tracer, warm_start=warm_start,
                         faults=faults, journal=journal, trace=trace)
        return []
    results, _stats = run_groups_chunked(
        [(config, items, build)], n_steps, watch_s=watch_s, chunk=chunk,
        record_every=record_every, tracer=tracer, pipeline=pipeline,
        warm_start=warm_start, faults=faults, journal=journal, trace=trace)
    return results[0]
