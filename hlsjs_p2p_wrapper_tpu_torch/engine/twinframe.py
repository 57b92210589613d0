# A copy of the reference's engine/twinframe.py (hlsjs_p2p_wrapper_tpu/engine/twinframe.py): the
# same names, formats and bytes; the imports point at the port's own modules
# and a few comments no longer cite the reference's history.
"""Twin observation plane: ONE calibration frame across both system
models.

The repo carries two full implementations of the paper's delivery
loop — the scanned step kernel (ops/swarm_sim.py: millions of
peers, bit-exact, warm-startable) and the real-protocol agent swarm
(engine/mesh.py + engine/p2p_agent.py + engine/tracker.py over a
shared VirtualClock fabric).  Each had its own telemetry: the kernel
emits ``record_every`` metrics timelines (``timeline_columns``), the
swarm exports registry series and flight-recorder events
(engine/tracer.py).  Nothing compared them — so "digital twin" was a
name, not a measured quantity (ROADMAP: the twin-calibration gate is
the credibility prerequisite for the live control plane).

This module is the shared vocabulary plus the machinery that lands
BOTH planes in it:

- :data:`FRAME_COLUMNS` / :class:`ObservationFrame` — one canonical
  windowed frame: per-window cumulative offload and rebuffer ratios,
  interval CDN/P2P byte rates, the interval stalled-peer count, and
  peer presence with join/leave counts.  Every column is defined
  once, here, with one window convention (window ``k`` covers
  ``(t_{k-1}, t_k]``; the first window reaches back to 0 inclusive)
  so the two extractors can never drift apart silently.
- :func:`frames_from_timelines` — folds the sim kernel's
  ``record_every`` timeline (one sample per record interval) into
  frames; presence comes from the per-level peer counts, join/leave
  counts from the scenario's own ``join_s``/``leave_s`` arrays.
- :class:`FrameBuilder` + :func:`frames_from_events` — the real
  plane's pair.  ``FrameBuilder`` is the ONE reducer both real-side
  extractors drive: the harness's registry sampler feeds it absolute
  per-peer totals read live from the shared
  :class:`~.telemetry.MetricsRegistry` (the ``twin.*`` provenance
  families: per-fetch cdn/p2p bytes, stall accrual, join/leave), and
  :func:`frames_from_events` feeds it the SAME bumps replayed from a
  flight-recorder shard, closing a window at each ``twin_window``
  mark the sampler emitted.  Because both paths accumulate the same
  deltas in the same order and reduce through the same code, frames
  reconstructed from the event stream alone are EXACTLY equal to the
  registry-derived frames — the trace-gate completeness discipline,
  extended to the swarm data plane (``make twin-gate`` asserts it,
  through a SIGKILL'd writer included: the shard reader is the
  torn-tail-tolerant one).
- divergence detectors in the triage_timelines.py mold:
  :func:`detect_band_divergence` (per-window bounded relative error:
  WHICH metric, WHICH window, and which side moved first) and
  :func:`detect_distribution_divergence` (two-sample KS distance
  over the window samples); :func:`compare_frames` runs both against
  a calibrated tolerance-band artifact (the committed
  ``TWIN_r10.json``), and :func:`frame_errors` is the console's
  per-metric max-error panel.

The fleet observation round widened the module in two directions:
the frame carries TAIL columns (:data:`QUANTILE_COLUMNS` — the
per-window per-peer interval stall distribution's p50/p95/p99,
computed through the ONE mergeable digest definition in
engine/digest.py by both planes), and ingest scales from one shard
to a fleet: :class:`ShardFollower` (moved here from the controller)
tail-follows one shard, and :class:`ShardMuxFollower` merges N of
them on the virtual window clock with explicit per-shard watermarks
— merged rows bit-identical to single-shard ingest under any peer
partition, dead shards excluded-and-counted (``mux.*`` families),
per-shard sub-frames for the SLO layer's attribution
(engine/slo.py).  :func:`frames_from_shards` is the batch form,
and it replays binary shards (engine/recordio.py — the default
recorder format) through a VECTORIZED columnar tier when it can:
mmap'd frame columns, window partitioning by ``searchsorted`` over
the mark positions, per-key ``cumsum`` prefix totals — guarded by
conservative qualification checks (any doubt routes to the
always-correct dict-tier mux) and asserted bit-identical to it on
every gate.

Pure stdlib + host arithmetic — no device framework import (numpy only, lazily,
for the columnar replay), so frames compare anywhere the artifacts
travel (the triage-tool discipline).  Frames
carry VirtualClock-derived timestamps only; this file is under
tools/lint.py's injectable-clock rule, so a naked wall-clock read
here is a lint failure by construction.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

from . import recordio
from .digest import (DEFAULT_EDGES, QuantileDigest,
                     quantiles_from_counts)

#: the per-window tail columns (the fleet observation round): the
#: per-peer interval stall distribution's quantile trio, computed
#: through ONE digest definition in both planes (engine/digest.py;
#: the sim kernel bins the same values with the same edges via
#: ``stall_digest`` timeline columns) — so the twin can band p99
#: rebuffer, not just the mean
QUANTILE_COLUMNS = ("rebuffer_ms_p50", "rebuffer_ms_p95",
                    "rebuffer_ms_p99")

#: the canonical frame vocabulary, shared with the sim kernel's
#: ``timeline_columns``: sample clock, cumulative north-star pair,
#: interval byte rates, interval stall count — plus the membership
#: columns the twin comparison adds (presence and join/leave counts)
#: and the per-window stall-quantile trio
FRAME_COLUMNS = ("t_s", "offload", "rebuffer", "cdn_rate_bps",
                 "p2p_rate_bps", "stalled_peers", "present_peers",
                 "joins", "leaves") + QUANTILE_COLUMNS


class ObservationFrame(NamedTuple):
    """One plane's windowed observation of a scenario run.

    ``samples`` is a tuple of per-window rows over ``columns``
    (:data:`FRAME_COLUMNS`); ``source`` names the plane ("sim" /
    "real").  NamedTuple equality is the exactness check the twin
    gate uses (event-reconstructed == registry-derived)."""

    source: str
    window_s: float
    columns: Tuple[str, ...]
    samples: Tuple[Tuple[float, ...], ...]

    def column(self, name: str) -> List[float]:
        idx = self.columns.index(name)
        return [row[idx] for row in self.samples]

    @property
    def n_windows(self) -> int:
        return len(self.samples)

    def as_dict(self) -> dict:
        return {"source": self.source, "window_s": self.window_s,
                "columns": list(self.columns),
                "samples": [list(row) for row in self.samples]}

    @classmethod
    def from_dict(cls, data: dict) -> "ObservationFrame":
        return cls(source=data["source"],
                   window_s=float(data["window_s"]),
                   columns=tuple(data["columns"]),
                   samples=tuple(tuple(float(v) for v in row)
                                 for row in data["samples"]))


def _in_window(t: Optional[float], prev_t: float, end_t: float,
               first: bool) -> bool:
    """The ONE window-membership convention: ``(prev_t, end_t]``,
    with the first window reaching back through 0 (a join at the
    scenario origin belongs to window 0, not to no window)."""
    if t is None:
        return False
    if first:
        return t <= end_t
    return prev_t < t <= end_t


class FrameBuilder:
    """The shared real-plane reducer (module docstring): accumulate
    per-peer provenance totals — incrementally (event replay) or
    absolutely (registry sampling) — and :meth:`close_window` them
    into canonical frame rows.  All clocks are in MILLISECONDS (the
    engine timebase); rows are emitted in seconds."""

    def __init__(self, source: str, window_s: float):
        self.source = source
        self.window_s = float(window_s)
        self._bytes: Dict[Tuple[str, str], float] = {}
        self._stall_ms: Dict[str, float] = {}
        self._join_ms: Dict[str, float] = {}
        self._leave_ms: Dict[str, float] = {}
        self._stalled: set = set()   # peers whose stall clock moved
        self._prev_cdn = 0.0
        self._prev_p2p = 0.0
        self._prev_t_ms = 0.0
        #: per-peer stall totals at the previous window close — the
        #: interval view the quantile digest bins (QUANTILE_COLUMNS)
        self._prev_stall: Dict[str, float] = {}
        #: per-(peer, src) byte totals at the previous window close —
        #: the interval view behind ``last_peer_p2p_bytes``
        self._prev_bytes: Dict[Tuple[str, str], float] = {}
        #: the last closed window's per-peer interval stall / interval
        #: P2P bytes (present peers only) — the SLO layer's
        #: cohort-attribution inputs (engine/slo.py), snapshotted so
        #: a consumer never reads half-advanced FrameBuilder state
        self.last_peer_stall_ms: Dict[str, float] = {}
        self.last_peer_p2p_bytes: Dict[str, float] = {}
        self._first = True
        self._rows: List[Tuple[float, ...]] = []

    # -- incremental feeders (flight-recorder event replay) -----------

    def add_bytes(self, peer: str, src: str, n: float) -> None:
        key = (peer, src)
        self._bytes[key] = self._bytes.get(key, 0.0) + n

    def add_stall(self, peer: str, ms: float) -> None:
        self._stall_ms[peer] = self._stall_ms.get(peer, 0.0) + ms
        self._stalled.add(peer)

    # -- absolute feeders (live registry sampling) --------------------

    def set_bytes_total(self, peer: str, src: str,
                        value: float) -> None:
        self._bytes[(peer, src)] = value

    def set_stall_total(self, peer: str, value: float) -> None:
        if value != self._stall_ms.get(peer, 0.0):
            self._stalled.add(peer)
        self._stall_ms[peer] = value

    def mark_stalled(self, peer: str) -> None:
        """Mark ``peer``'s stall clock as having MOVED this window
        even when the delta was zero — the columnar replay's pairing
        for :meth:`add_stall`'s unconditional mark
        (:meth:`set_stall_total` alone cannot distinguish a
        zero-delta stall event from no event at all)."""
        self._stalled.add(peer)

    # -- membership (both feeders) ------------------------------------

    def set_join(self, peer: str, t_ms: float) -> None:
        self._join_ms[peer] = t_ms

    def set_leave(self, peer: str, t_ms: float) -> None:
        self._leave_ms[peer] = t_ms

    def membership(self) -> Tuple[Dict[str, float], Dict[str, float]]:
        """Snapshot of the observed join/leave clocks (engine ms) per
        peer — the control plane reconstructs its forecast scenario
        from exactly what the reducer has seen, never from a second
        bookkeeping path that could drift from the frames."""
        return dict(self._join_ms), dict(self._leave_ms)

    # -- reduction ----------------------------------------------------

    def close_window(self, t_ms: float) -> Tuple[float, ...]:
        """Emit the frame row for the window ending at ``t_ms``.
        Reductions iterate peers in SORTED order so both feeders sum
        identical floats in identical order — the exact-equality
        contract between the registry and event extractions."""
        cdn = 0.0
        p2p = 0.0
        for peer, src in sorted(self._bytes):
            if src == "cdn":
                cdn += self._bytes[(peer, src)]
            elif src == "p2p":
                p2p += self._bytes[(peer, src)]
        total = cdn + p2p
        offload = p2p / total if total > 0 else 0.0
        stall = 0.0
        for peer in sorted(self._stall_ms):
            stall += self._stall_ms[peer]
        watched = 0.0
        present = 0
        joins = 0
        leaves = 0
        stall_digest = QuantileDigest(DEFAULT_EDGES)
        peer_stall: Dict[str, float] = {}
        peer_p2p: Dict[str, float] = {}
        for peer in sorted(self._join_ms):
            j = self._join_ms[peer]
            leave = self._leave_ms.get(peer)
            end = t_ms if leave is None else min(leave, t_ms)
            watched += max(end - j, 0.0)
            if j <= t_ms and (leave is None or leave > t_ms):
                present += 1
                # the interval stall digest counts PRESENT peers
                # (zeros included: p50 of a healthy window IS 0) —
                # the same present-mask convention the sim plane's
                # stall_digest columns apply at the sample clock
                interval = (self._stall_ms.get(peer, 0.0)
                            - self._prev_stall.get(peer, 0.0))
                peer_stall[peer] = interval
                stall_digest.add(interval)
                key = (peer, "p2p")
                peer_p2p[peer] = (self._bytes.get(key, 0.0)
                                  - self._prev_bytes.get(key, 0.0))
            if _in_window(j, self._prev_t_ms, t_ms, self._first):
                joins += 1
            if _in_window(leave, self._prev_t_ms, t_ms, self._first):
                leaves += 1
        rebuffer = stall / watched if watched > 0 else 0.0
        dt_s = max((t_ms - self._prev_t_ms) / 1000.0, 1e-9)
        row = (t_ms / 1000.0, offload, rebuffer,
               (cdn - self._prev_cdn) * 8.0 / dt_s,
               (p2p - self._prev_p2p) * 8.0 / dt_s,
               float(len(self._stalled)), float(present),
               float(joins), float(leaves)) \
            + tuple(stall_digest.quantiles())
        self._prev_cdn = cdn
        self._prev_p2p = p2p
        self._prev_t_ms = t_ms
        self._prev_stall = dict(self._stall_ms)
        self._prev_bytes = dict(self._bytes)
        self.last_peer_stall_ms = peer_stall
        self.last_peer_p2p_bytes = peer_p2p
        self._first = False
        self._stalled = set()
        self._rows.append(row)
        return row

    def frame(self) -> ObservationFrame:
        return ObservationFrame(source=self.source,
                                window_s=self.window_s,
                                columns=FRAME_COLUMNS,
                                samples=tuple(self._rows))


def parse_labels(labels: str) -> Dict[str, str]:
    """Inverse of the recorder's canonical ``k=v,...`` rendering
    (engine/tracer.py ``_labels_str``) — public because every
    consumer that joins exported families on their labels (the frame
    reconstruction here, tools/soak.py's invariants) must share ONE
    inverse of the one rendering."""
    out: Dict[str, str] = {}
    for part in labels.split(","):
        if "=" in part:
            key, value = part.split("=", 1)
            out[key] = value
    return out


#: the provenance counter families the real-plane extractors consume
#: — emitted by engine/stats.py (per-fetch bytes + completions),
#: player/sim.py via the harness (stall accrual/edges), and
#: testing/swarm.py (membership); METRICS.md carries the signatures
TWIN_EVENT_FAMILIES = ("twin.fetch_bytes", "twin.fetches",
                       "twin.stall_ms", "twin.stalls", "twin.peer",
                       "twin.upload_bytes")

#: the sampler's window-boundary mark in the event stream: replaying
#: a shard closes one frame window per mark, in SHARD ORDER (same-
#: timestamp bumps landing after the mark belong to the next window,
#: exactly as the live sampler saw them)
TWIN_WINDOW_MARK = "twin_window"


def feed_builder_event(builder: FrameBuilder, event: dict) -> bool:
    """Apply one NON-MARK flight-recorder event's ``twin.*``
    provenance to a :class:`FrameBuilder` — the ONE event vocabulary
    shared by the single-shard reducer (:class:`EventFrameFeeder`)
    and the multi-shard mux (:class:`ShardMuxFollower`), so the two
    ingest paths can never drift on what a bump means.  Returns True
    when the event carried provenance."""
    if event.get("kind") != "counter":
        return False
    name = event.get("name", "")
    if not name.startswith("twin."):
        return False
    labels = parse_labels(event.get("labels", ""))
    peer = labels.get("peer", "")
    n = event.get("n", 0)
    if name == "twin.fetch_bytes":
        builder.add_bytes(peer, labels.get("src", ""), n)
    elif name == "twin.stall_ms":
        builder.add_stall(peer, n)
    elif name == "twin.peer":
        if labels.get("event") == "join":
            builder.set_join(peer, event.get("t", 0.0))
        elif labels.get("event") == "leave":
            builder.set_leave(peer, event.get("t", 0.0))
    return True


class EventFrameFeeder:
    """The event-replay extractor as an INCREMENTAL reducer: feed
    flight-recorder events one at a time (in SHARD ORDER) and a
    canonical frame row comes back at every ``twin_window`` mark —
    exactly :func:`frames_from_events`' window partitioning, exposed
    so a live consumer (the control plane's tail-follow ingest) can
    reduce a growing shard without re-reading it.  The batch
    function below is this class applied to a finished stream, so
    the two can never drift."""

    def __init__(self, source: str = "real"):
        # window_s is learned from the first mark (every mark of one
        # sampler carries the same window_ms)
        self.builder = FrameBuilder(source, 0.0)
        self.windows = 0

    def feed(self, event: dict) -> Optional[Tuple[float, ...]]:
        """One event; returns the closed frame row when ``event`` is
        a window mark, else None."""
        if event.get("kind") == "mark" \
                and event.get("name") == TWIN_WINDOW_MARK:
            if self.windows == 0:
                self.builder.window_s = \
                    event.get("window_ms", 0.0) / 1000.0
            self.windows += 1
            return self.builder.close_window(event.get("t", 0.0))
        feed_builder_event(self.builder, event)
        return None

    def frame(self) -> ObservationFrame:
        return self.builder.frame()


def frames_from_events(events: Iterable[dict], *,
                       source: str = "real") -> ObservationFrame:
    """Reconstruct the canonical frame purely from one host's
    flight-recorder event stream — no live objects, no registries.

    ``events`` must be in SHARD ORDER (``read_shard`` file order —
    per-host emission order), not clock-sorted: the ``twin_window``
    marks partition the stream exactly where the live sampler stood,
    which is what makes the reconstruction equal the registry-derived
    frames bit-for-bit.  A torn tail (SIGKILL'd writer) simply ends
    the stream early: every window whose mark survived reconstructs
    exactly."""
    feeder = EventFrameFeeder(source)
    for event in events:
        feeder.feed(event)
    return feeder.frame()


# -- multi-shard ingest (the fleet observation round) -------------------

class ShardFollower:
    """Tolerant tail-follow of one flight-recorder shard: each
    :meth:`poll` yields the records that became COMPLETE since the
    last poll — only whole records are consumed (a torn tail stays
    buffered in the decoder until its closing bytes land), and a
    record that fails to decode is counted and skipped, the
    torn-tail discipline applied to a growing file.  The decoder is
    a persistent :class:`~.recordio.RecordDecoder`, so binary,
    JSONL, and mixed shards all follow identically.  (Moved here
    from engine/controller.py so the mux below can reuse it without
    the observation plane importing the control plane.)"""

    def __init__(self, path: str):
        self.path = path
        self._offset = 0
        self._decoder = recordio.RecordDecoder()

    @property
    def stats(self) -> "recordio.DecodeStats":
        """The follower's running decode accounting (bad frames /
        torn tails), for the mux's corruption counters."""
        return self._decoder.stats

    def poll(self) -> List[dict]:
        try:
            with open(self.path, "rb") as fh:
                fh.seek(self._offset)
                data = fh.read()
        except OSError:
            return []
        if not data:
            return []
        self._offset += len(data)
        return self._decoder.feed(data)


class _MuxLane:
    """One shard's buffered view inside the mux: the tail-follower,
    the open (un-marked) event tail, and the completed window
    segments — ``(mark, events)`` pairs — awaiting the merge."""

    __slots__ = ("shard_id", "follower", "open_events", "segments",
                 "started", "dead", "stall_polls")

    def __init__(self, shard_id: str, path: str):
        self.shard_id = shard_id
        self.follower = ShardFollower(path)
        self.open_events: List[dict] = []
        self.segments: deque = deque()
        self.started = False
        self.dead = False
        self.stall_polls = 0

    def ingest(self) -> bool:
        """Poll the follower, partition new records into window
        segments at the ``twin_window`` marks; True when anything
        new arrived (the mux's liveness evidence)."""
        records = self.follower.poll()
        for event in records:
            if event.get("kind") == "mark" \
                    and event.get("name") == TWIN_WINDOW_MARK:
                self.segments.append((event, self.open_events))
                self.open_events = []
            else:
                self.open_events.append(event)
        if records:
            self.started = True
        return bool(records)


class ShardMuxFollower:
    """Tail-follow N flight-recorder shards and merge them into ONE
    canonical frame stream on the virtual window clock.

    Each shard keeps :class:`ShardFollower`'s torn-tail / corrupt-
    line discipline; per-shard ``twin_window`` marks are the
    WATERMARKS: a merged window closes only when every LIVE shard's
    watermark has passed it (its segment for that window is
    buffered), and the segments then feed one shared
    :class:`FrameBuilder` in shard-id order.  Because per-(peer,src)
    accumulation order within a shard is file order and the FrameBuilder
    reduces in sorted-peer order, the merged rows are BIT-IDENTICAL
    to a single-shard ingest of the same traffic however it was
    partitioned across shards — the determinism contract
    ``tools/slo_gate.py`` asserts, and what makes the controller's
    decisions independent of the shard layout.

    Liveness is explicit, never inferred silently:

    - a shard whose file has not produced a record yet has NOT
      started and does not block the merge (a shard may appear
      mid-run; segments for already-closed windows are dropped and
      counted ``mux.late_windows``) — but while the fleet closes
      windows without it, it accrues the same stall polls as a
      stalled shard, so a host that crashed before its first write
      is declared dead and COUNTED, never silently treated as
      absent forever;
    - a shard that stops advancing (or never starts) while others
      buffer windows is a WATERMARK STALL: after
      ``dead_after_polls`` CONSECUTIVE no-progress lagging polls
      (progress, or simply not lagging, resets the count) it is
      declared dead (counted ``mux.shard_dead``) and subsequent
      windows close WITHOUT it — each such window records the
      exclusion (:attr:`exclusions`, counted
      ``mux.excluded_windows{shard=...}``), so a dead shard is
      excluded-and-counted, never silently merged;
    - a dead shard that produces a fresh (non-stale) window again is
      revived (counted ``mux.shard_revived``) and rejoins from the
      next unclosed window.

    ``dead_after_polls=None`` (the default) waits forever — the
    batch-replay setting, where a finished shard set has no liveness
    question.  ``per_shard=True`` additionally reduces each shard's
    own events through a private FrameBuilder (:attr:`shard_rows`),
    the SLO layer's worst-shard attribution input."""

    def __init__(self, paths: Iterable[str], *,
                 source: str = "real",
                 dead_after_polls: Optional[int] = None,
                 registry=None, per_shard: bool = False):
        paths = list(paths)
        # duplicate detection on the RESOLVED path: the same file
        # under two spellings (./dir/x vs dir/x, abs vs rel) would
        # otherwise be followed twice and silently double every
        # merged count
        resolved = [os.path.realpath(path) for path in paths]
        if len(set(resolved)) != len(resolved):
            raise ValueError("duplicate shard paths in the mux path "
                             "list — the same shard followed twice "
                             "would double every merged count")
        paths = [os.path.normpath(path) for path in paths]

        def ids_from(depth: int) -> List[str]:
            out = []
            for path in paths:
                parts = path.replace("\\", "/").split("/")
                tail = "/".join(parts[-depth:])
                out.append(tail[:-len(".jsonl")]
                           if tail.endswith(".jsonl") else tail)
            return out

        # shard ids come from the basename (the per-host
        # `<host>.jsonl` layout); per-host DIRECTORIES holding
        # same-named files (`host01/trace.jsonl`) are a legitimate
        # fleet layout too, so colliding basenames widen to include
        # parent components until the ids are distinct — only
        # genuinely identical paths are refused
        depth = 1
        shard_ids = ids_from(depth)
        while len(set(shard_ids)) != len(shard_ids):
            depth += 1
            widened = ids_from(depth)
            if widened == shard_ids:
                raise ValueError("duplicate shard paths in the mux "
                                 "path list — the merge order would "
                                 "be ambiguous")
            shard_ids = widened
        lanes = [_MuxLane(shard_id, path)
                 for shard_id, path in zip(shard_ids, paths)]
        lanes.sort(key=lambda lane: lane.shard_id)
        if not lanes:
            raise ValueError("ShardMuxFollower needs >= 1 shard path")
        self._lanes = lanes
        self._dead_after = dead_after_polls
        # mux health counts into the shared registry when given one,
        # else a private instance — call sites stay unconditional
        # (the AgentStats convention; telemetry is imported lazily so
        # this pure-host module's import surface stays stdlib)
        if registry is None:
            from .telemetry import MetricsRegistry
            registry = MetricsRegistry()
        self._registry = registry
        self.builder = FrameBuilder(source, 0.0)
        self.windows = 0
        self.rows: List[Tuple[float, ...]] = []
        #: per closed window: the shard ids excluded from it (dead at
        #: close time) — empty tuple for a fully-merged window
        self.exclusions: List[Tuple[str, ...]] = []
        #: per closed window: (join_ms, leave_ms) membership
        #: snapshots, captured at the close (the control plane's
        #: resume-determinism contract)
        self.memberships: List[Tuple[Dict[str, float],
                                     Dict[str, float]]] = []
        #: per closed window: the merged FrameBuilder's per-peer interval
        #: stall / interval P2P bytes (present peers) — the SLO
        #: layer's cohort-attribution inputs (engine/slo.py)
        self.peer_stall: List[Dict[str, float]] = []
        self.peer_p2p: List[Dict[str, float]] = []
        self._last_key: Optional[float] = None
        self._shard_builders: Optional[Dict[str, FrameBuilder]] = None
        self.shard_rows: Dict[str, List[Optional[Tuple[float, ...]]]] \
            = {}
        if per_shard:
            self._shard_builders = {
                lane.shard_id: FrameBuilder(
                    f"{source}:{lane.shard_id}", 0.0)
                for lane in lanes}
            self.shard_rows = {lane.shard_id: [] for lane in lanes}

    @property
    def shard_ids(self) -> List[str]:
        return [lane.shard_id for lane in self._lanes]

    @staticmethod
    def _mark_key(mark: dict) -> float:
        """The merge watermark of one ``twin_window`` mark: the
        sampler's WINDOW INDEX when the mark carries one (every
        sampler stamps it), else the mark's clock.
        Index-keyed merging is what lets a fleet of sampler hosts on
        LOOSELY SYNCHRONIZED clocks merge exactly — hosts agree on
        the window schedule (the logical watermark) even when their
        clock stamps disagree by a skew; clock-keyed merging would
        exclude every host but the earliest from every window.  On
        an aligned fleet (and on every pre-HA shard layout, where
        marks are replicated byte-identical) the two keys order
        identically, so the merge is unchanged there."""
        window = mark.get("window")
        if isinstance(window, (int, float)) \
                and not isinstance(window, bool):
            return float(window)
        return mark.get("t", 0.0)

    def _drop_stale(self) -> None:
        """Discard buffered segments whose window already closed —
        a late-appearing or revived shard must not smear old BYTE
        and STALL deltas into a newer window's intervals (counted
        ``mux.late_windows``, never silent).  MEMBERSHIP events are
        the exception: a ``twin.peer`` join/leave carries its own
        absolute clock, so applying it late is exact — without this,
        a shard that appears mid-run would leave its peers
        permanently invisible to presence, watched-time, and the
        per-peer attribution surfaces of every later window."""
        if self._last_key is None:
            return
        for lane in self._lanes:
            while lane.segments and \
                    self._mark_key(lane.segments[0][0]) \
                    <= self._last_key:
                _mark, events = lane.segments.popleft()
                shard_builder = (self._shard_builders or {}).get(
                    lane.shard_id)
                for event in events:
                    if event.get("kind") != "counter" \
                            or event.get("name") != "twin.peer":
                        continue
                    feed_builder_event(self.builder, event)
                    if shard_builder is not None:
                        feed_builder_event(shard_builder, event)
                self._registry.counter("mux.late_windows",
                                       shard=lane.shard_id).inc()

    def _live(self) -> List[_MuxLane]:
        return [lane for lane in self._lanes
                if lane.started and not lane.dead]

    def _close(self, live: List[_MuxLane]) -> Tuple[float, ...]:
        """Close one merged window at the EARLIEST buffered mark
        watermark among the live lanes (lanes already sorted by
        shard id — the deterministic feed order; see
        :meth:`_mark_key` for why the watermark is the window INDEX
        on an index-stamping fleet).  A lane whose next mark sits
        BEYOND that watermark is ahead of this window — a
        late-started host missing the earlier marks, or a shard
        whose mark line was lost to corruption — and skips it
        (recorded in the window's exclusions) instead of having a
        LATER window's segment consumed positionally, which would
        desynchronize every subsequent merge.  The merged row's
        clock is the EARLIEST contributing mark clock, so a fleet
        containing one unskewed host closes every window at that
        host's boundary clock — bit-identical to a single-host
        ingest of the same traffic, whatever the other hosts'
        skews."""
        key = min(self._mark_key(lane.segments[0][0])
                  for lane in live)
        t = min(lane.segments[0][0].get("t", 0.0) for lane in live
                if self._mark_key(lane.segments[0][0]) <= key)
        window_ms = None
        contributed = set()
        for lane in live:
            if self._mark_key(lane.segments[0][0]) > key:
                continue  # ahead of this window: contributes later
            mark, events = lane.segments.popleft()
            if window_ms is None:
                window_ms = mark.get("window_ms", 0.0)
            shard_builder = (self._shard_builders or {}).get(
                lane.shard_id)
            for event in events:
                feed_builder_event(self.builder, event)
                if shard_builder is not None:
                    feed_builder_event(shard_builder, event)
            contributed.add(lane.shard_id)
        if self.windows == 0:
            self.builder.window_s = (window_ms or 0.0) / 1000.0
            for builder in (self._shard_builders or {}).values():
                builder.window_s = (window_ms or 0.0) / 1000.0
        row = self.builder.close_window(t)
        if self._shard_builders is not None:
            for shard_id, builder in self._shard_builders.items():
                self.shard_rows[shard_id].append(
                    builder.close_window(t)
                    if shard_id in contributed else None)
        excluded = tuple(sorted(
            lane.shard_id for lane in self._lanes
            if lane.dead or (lane in live
                             and lane.shard_id not in contributed)))
        self.exclusions.append(excluded)
        for shard_id in excluded:
            self._registry.counter("mux.excluded_windows",
                                   shard=shard_id).inc()
        self._registry.counter("mux.windows").inc()
        self.windows += 1
        self._last_key = key
        self.rows.append(row)
        self.memberships.append(self.builder.membership())
        self.peer_stall.append(dict(self.builder.last_peer_stall_ms))
        self.peer_p2p.append(dict(self.builder.last_peer_p2p_bytes))
        return row

    def _drain(self) -> List[Tuple[float, ...]]:
        rows = []
        while True:
            self._drop_stale()
            for lane in self._lanes:
                if lane.dead and lane.segments:
                    # fresh post-stall window: the shard is back
                    lane.dead = False
                    lane.stall_polls = 0
                    self._registry.counter(
                        "mux.shard_revived",
                        shard=lane.shard_id).inc()
            live = self._live()
            if live and all(lane.segments for lane in live):
                rows.append(self._close(live))
                continue
            return rows

    def poll(self) -> List[Tuple[float, ...]]:
        """Ingest whatever every shard grew and return the frame
        rows whose merged windows closed.  Dead-shard detection runs
        once per poll: only a shard that is LAGGING the merge
        (blocking a closable window, or never started while other
        shards close windows) and made no progress accrues stall
        polls — CONSECUTIVE polls only (any progress, or simply not
        lagging, resets the count), so an idle fleet times nobody
        out and an old stall can never shorten a later one's fuse."""
        progressed = {lane.shard_id for lane in self._lanes
                      if lane.ingest()}
        rows = self._drain()
        if self._dead_after is not None:
            live = self._live()
            # a lane is LAGGING when the merge has evidence it fell
            # behind: a started lane lags while it BLOCKS a closable
            # window — after the drain, another live lane still
            # holds a buffered segment this lane has no counterpart
            # for (a fully-drained fleet blocks on nobody, however
            # many rows just closed); a never-started lane lags as
            # soon as the merge has closed ANY window without it (a
            # crashed-before-first-write host must be excluded and
            # counted, not silently treated as absent forever)
            lagging = []
            if any(lane.segments for lane in live):
                lagging = [lane for lane in live
                           if not lane.segments]
            if self.windows > 0:
                lagging += [lane for lane in self._lanes
                            if not lane.started and not lane.dead]
            lagging_ids = {lane.shard_id for lane in lagging}
            for lane in self._lanes:
                if lane.shard_id in progressed \
                        or lane.shard_id not in lagging_ids:
                    lane.stall_polls = 0
            died = False
            for lane in lagging:
                if lane.shard_id in progressed:
                    continue
                lane.stall_polls += 1
                if lane.stall_polls >= self._dead_after:
                    lane.dead = True
                    died = True
                    self._registry.counter(
                        "mux.shard_dead",
                        shard=lane.shard_id).inc()
            if died:
                rows.extend(self._drain())
        return rows

    def membership_at(self, window: int) \
            -> Tuple[Dict[str, float], Dict[str, float]]:
        return self.memberships[window]

    def frame(self) -> ObservationFrame:
        return self.builder.frame()

    def shard_frame(self, shard_id: str) -> ObservationFrame:
        if self._shard_builders is None:
            raise ValueError("mux built without per_shard=True")
        return self._shard_builders[shard_id].frame()


def frames_from_shards(paths: Iterable[str], *,
                       source: str = "real",
                       engine: str = "auto") -> ObservationFrame:
    """Batch replay of a finished shard set into the merged frame.

    ``engine="auto"`` (the default) replays through the COLUMNAR
    fast path when the shard set allows it — mmap'd vectorized
    decode (:func:`~.recordio.frame_columns`), per-key running
    totals sampled at the ``twin_window`` marks by ``searchsorted``
    — and falls back to the mux dict tier whenever it cannot prove
    bit-identity (misaligned marks, a key accumulating across
    shards, hot families in the JSON tier, corruption).  Both
    engines produce the SAME rows: the fast path assigns each key's
    cumulative total (an f8 prefix sum — the identical additions in
    the identical order as the incremental feed) into the one shared
    :class:`FrameBuilder` before each window close, so
    ``engine="mux"`` vs the default is a throughput choice, never a
    semantic one — the exactness contract, kept.
    ``engine="columns"`` asserts the fast path (raises when it
    declines; tests and the bench's decode-throughput rider)."""
    paths = list(paths)
    if engine in ("auto", "columns"):
        frame = _frames_from_shard_columns(paths, source)
        if frame is not None:
            return frame
        if engine == "columns":
            raise ValueError(
                "columnar replay declined these shards (no numpy, "
                "misaligned marks, cross-shard keys, or hot events "
                "in the JSON tier) — use engine='auto' for the mux "
                "fallback")
    elif engine != "mux":
        raise ValueError(f"unknown frames_from_shards engine "
                         f"{engine!r}")
    mux = ShardMuxFollower(paths, source=source)
    mux.poll()
    return mux.frame()


def _shard_sort_ids(paths: List[str]) -> Optional[List[str]]:
    """The mux's basename shard ids for a path list, or None when
    they collide (the mux widens with parent components; the fast
    path just hands the job back to it)."""
    ids = []
    for path in paths:
        name = os.path.basename(os.path.normpath(path))
        ids.append(name[:-len(".jsonl")]
                   if name.endswith(".jsonl") else name)
    return ids if len(set(ids)) == len(ids) else None


def _twin_groups(np, cols):
    """One shard's twin provenance in columnar form: per-key
    ``(positions, running totals)`` for the cumulative families
    (``twin.fetch_bytes`` by (peer, src), ``twin.stall_ms`` by
    peer) and the pos-ordered membership events.  None when the
    columnar form cannot reproduce the event-order contract — a hot
    family riding the JSON tier (ctx-bearing bumps interleave with
    the frame runs) or two label renderings colliding on one key."""
    strings = cols.strings
    membership: List[Tuple[int, str, str, float]] = []
    for pos, record in cols.py_events:
        if record.get("kind") != "counter":
            continue
        name = record.get("name", "")
        if name in ("twin.fetch_bytes", "twin.stall_ms"):
            return None
        if name == "twin.peer":
            labels = parse_labels(record.get("labels", ""))
            event = labels.get("event")
            if event in ("join", "leave"):
                membership.append((pos, labels.get("peer", ""),
                                   event, record.get("t", 0.0)))
    fetch: Dict[Tuple[str, str], tuple] = {}
    stall: Dict[str, tuple] = {}
    if len(cols.ctr_pos):
        name_ids = cols.ctr_name
        labels_ids = cols.ctr_labels
        for name_id in np.unique(name_ids).tolist():
            # an unresolved id (its K_STR definition lost to a
            # counted corruption) drops its rows — exactly the dict
            # tier's unresolved-record accounting
            name = strings.get(name_id)
            if name not in ("twin.fetch_bytes", "twin.stall_ms",
                            "twin.peer"):
                continue
            rows = np.flatnonzero(name_ids == name_id)
            if name == "twin.peer":
                row_pos = cols.ctr_pos[rows]
                row_t = cols.ctr_t[rows]
                row_labels = labels_ids[rows]
                for j in range(len(rows)):
                    labels_text = strings.get(int(row_labels[j]))
                    if labels_text is None:
                        continue
                    labels = parse_labels(labels_text)
                    event = labels.get("event")
                    if event in ("join", "leave"):
                        membership.append(
                            (int(row_pos[j]),
                             labels.get("peer", ""), event,
                             float(row_t[j])))
                continue
            row_labels = labels_ids[rows]
            for label_id in np.unique(row_labels).tolist():
                labels_text = strings.get(label_id)
                if labels_text is None:
                    continue
                labels = parse_labels(labels_text)
                peer = labels.get("peer", "")
                sel = rows[row_labels == label_id]
                pos_g = cols.ctr_pos[sel]
                # np.cumsum is the same left-to-right f8 additions
                # the incremental feeders perform — prefix sums are
                # bit-identical, which is the whole exactness trick
                csum = np.cumsum(cols.ctr_n[sel])
                if name == "twin.fetch_bytes":
                    key = (peer, labels.get("src", ""))
                    if key in fetch:
                        return None
                    fetch[key] = (pos_g, csum)
                else:
                    if peer in stall:
                        return None
                    stall[peer] = (pos_g, csum)
    membership.sort(key=lambda item: item[0])
    return fetch, stall, membership


def _frames_from_shard_columns(paths: List[str], source: str
                               ) -> Optional[ObservationFrame]:
    """The columnar batch replay behind :func:`frames_from_shards`:
    decode every shard to columns, prove the shard set replays
    exactly (aligned marks, shard-local keys), then drive the one
    shared :class:`FrameBuilder` from prefix sums sampled at the
    marks.  Returns None whenever the mux dict tier must own the
    job instead."""
    try:
        import numpy as np
    except ImportError:      # pragma: no cover - numpy is baked in
        return None
    if not paths:
        return None
    if len({os.path.realpath(path) for path in paths}) != len(paths):
        return None  # the mux's duplicate-shard refusal owns this
    ids = _shard_sort_ids(paths)
    if ids is None:
        return None
    order = sorted(range(len(paths)), key=lambda i: ids[i])
    cols_list = []
    for i in order:
        try:
            cols = recordio.frame_columns(paths[i])
        except OSError:
            return None
        if cols is None:
            return None
        if cols.stats.bad_records or cols.stats.torn:
            # corrupt or torn shard: the frame contents would still
            # match (both tiers drop the same bad records), but only
            # the mux surfaces the corruption accounting (mux.*
            # counter families) — it owns damaged shards
            return None
        cols_list.append(cols)
    first = cols_list[0]
    n_marks = len(first.mark_pos)
    if n_marks == 0:
        return None
    for cols in cols_list[1:]:
        if len(cols.mark_pos) != n_marks \
                or not np.array_equal(cols.mark_t, first.mark_t):
            return None  # misaligned fleet: mux exclusions own this
    shard_groups = []
    seen_fetch: set = set()
    seen_stall: set = set()
    for cols in cols_list:
        groups = _twin_groups(np, cols)
        if groups is None:
            return None
        fetch, stall, _membership = groups
        if seen_fetch & fetch.keys() or seen_stall & stall.keys():
            # a key accumulating across shards interleaves additions
            # in poll order — only the mux reproduces that
            return None
        seen_fetch |= fetch.keys()
        seen_stall |= stall.keys()
        shard_groups.append(groups)
    builder = FrameBuilder(source,
                           float(first.mark_window_ms[0]) / 1000.0)
    totals = [[] for _ in range(n_marks)]
    member_sched = [[] for _ in range(n_marks)]
    for cols, (fetch, stall, membership) in zip(cols_list,
                                                shard_groups):
        mark_pos = cols.mark_pos
        for (peer, src), (pos_g, csum) in fetch.items():
            idx = np.searchsorted(pos_g, mark_pos, side="left")
            for k in np.flatnonzero(
                    np.diff(idx, prepend=0)).tolist():
                totals[k].append(("b", peer, src,
                                  float(csum[idx[k] - 1])))
        for peer, (pos_g, csum) in stall.items():
            idx = np.searchsorted(pos_g, mark_pos, side="left")
            for k in np.flatnonzero(
                    np.diff(idx, prepend=0)).tolist():
                totals[k].append(("s", peer, None,
                                  float(csum[idx[k] - 1])))
        if membership:
            mpos = np.asarray([m[0] for m in membership],
                              dtype=np.int64)
            windows = np.searchsorted(mark_pos, mpos, side="left")
            for w, (_pos, peer, event, t) in zip(windows.tolist(),
                                                 membership):
                if w < n_marks:
                    member_sched[w].append((peer, event, t))
    for k in range(n_marks):
        for peer, event, t in member_sched[k]:
            if event == "join":
                builder.set_join(peer, t)
            else:
                builder.set_leave(peer, t)
        for what, peer, src, value in totals[k]:
            if what == "b":
                builder.set_bytes_total(peer, src, value)
            else:
                builder.set_stall_total(peer, value)
                builder.mark_stalled(peer)
        builder.close_window(float(first.mark_t[k]))
    return builder.frame()


def frames_from_timelines(columns, samples, *,
                          join_s: Optional[Iterable[float]] = None,
                          leave_s: Optional[Iterable[float]] = None,
                          never_s: float = 1e17,
                          source: str = "sim") -> ObservationFrame:
    """Fold one sim ``record_every`` metrics timeline
    (``timeline_columns`` columns × per-interval samples) into the
    canonical frame.  The record interval IS the frame window —
    the twin adapter picks ``record_every`` so one sample maps to
    one window, and the offload / rebuffer / rate / stall columns
    carry over directly (they already share this module's
    definitions op-for-op; ops/swarm_sim.py ``_timeline_row``).

    Presence is the per-level present-peer mass summed; join/leave
    counts come from the scenario's own ``join_s``/``leave_s``
    arrays (seconds) under the shared window convention — the sim
    plane has no per-peer event stream, but its scenario arrays ARE
    its membership ground truth.  ``leave_s`` entries at or above
    ``never_s`` mean "never departs" (ops/swarm_sim.py NEVER_S).

    The quantile columns fold from the kernel's ``stall_ms_bin{i}``
    timeline columns (``SwarmConfig.stall_digest``: per-peer interval
    stall binned in-kernel with the SAME log-spaced edges this
    module's real-plane digest uses) through the one quantile
    estimator (engine/digest.py ``quantiles_from_counts``); a
    timeline recorded without the digest columns reports zeros —
    columns never silently vanish from the frame."""
    columns = list(columns)
    samples = [list(row) for row in samples]
    t_col = columns.index("t_s")
    level_cols = [i for i, c in enumerate(columns)
                  if c.startswith("level_") and c.endswith("_peers")]
    copy_cols = [columns.index(c) for c in
                 ("offload", "rebuffer", "cdn_rate_bps",
                  "p2p_rate_bps", "stalled_peers")]
    bin_cols = [columns.index(f"stall_ms_bin{i}")
                for i in range(len(DEFAULT_EDGES) + 1)] \
        if "stall_ms_bin0" in columns else None
    joins = [float(j) for j in join_s] if join_s is not None else []
    leaves = ([float(v) for v in leave_s]
              if leave_s is not None else [])
    leaves = [v for v in leaves if v < never_s]
    if len(samples) > 1:
        window_s = samples[1][t_col] - samples[0][t_col]
    elif samples:
        window_s = samples[0][t_col]
    else:
        window_s = 0.0
    rows = []
    prev_t = 0.0
    for k, sample in enumerate(samples):
        t = sample[t_col]
        first = k == 0
        n_joins = sum(1 for j in joins
                      if _in_window(j, prev_t, t, first))
        n_leaves = sum(1 for v in leaves
                       if _in_window(v, prev_t, t, first))
        present = sum(sample[i] for i in level_cols)
        if bin_cols is not None:
            quantiles = quantiles_from_counts(
                DEFAULT_EDGES,
                [int(round(sample[i])) for i in bin_cols])
        else:
            quantiles = [0.0] * len(QUANTILE_COLUMNS)
        rows.append((t,) + tuple(sample[i] for i in copy_cols)
                    + (float(present), float(n_joins),
                       float(n_leaves)) + tuple(quantiles))
        prev_t = t
    return ObservationFrame(source=source, window_s=float(window_s),
                            columns=FRAME_COLUMNS,
                            samples=tuple(rows))


# -- divergence detectors (the triage_timelines.py mold) ---------------

def detect_band_divergence(sim: ObservationFrame,
                           real: ObservationFrame, metric: str, *,
                           rtol: float, atol: float):
    """Per-window bounded-relative-error band: window ``w`` diverges
    when ``|sim[w] - real[w]| > atol + rtol * max(|sim[w]|,
    |real[w]|)``.  The finding names WHICH metric, WHICH windows
    (first and worst, with their sample clocks), and which side
    moved first — at the first flagged window, the plane whose value
    changed more since the previous window is the mover (the side
    that departed from the shared trajectory)."""
    s = sim.column(metric)
    r = real.column(metric)
    t_s = sim.column("t_s")
    n = min(len(s), len(r))
    flagged = []
    for w in range(n):
        tol = atol + rtol * max(abs(s[w]), abs(r[w]))
        err = abs(s[w] - r[w])
        if err > tol:
            flagged.append((w, err))
    if not flagged:
        return None
    first_w = flagged[0][0]
    worst_w, worst_err = max(flagged, key=lambda pair: pair[1])
    d_sim = abs(s[first_w] - (s[first_w - 1] if first_w else 0.0))
    d_real = abs(r[first_w] - (r[first_w - 1] if first_w else 0.0))
    moved = ("sim" if d_sim > d_real
             else "real" if d_real > d_sim else "both")
    return {"reason": "band_divergence", "metric": metric,
            "windows": [w for w, _err in flagged],
            "first_window": first_w,
            "first_t_s": round(t_s[first_w], 3),
            "worst_window": worst_w,
            "worst_abs_err": round(worst_err, 6),
            "sim_value": round(s[worst_w], 6),
            "real_value": round(r[worst_w], 6),
            "moved_first": moved}


def _ks_distance(a: List[float], b: List[float]) -> float:
    """Two-sample Kolmogorov-Smirnov statistic: the max gap between
    the empirical CDFs (stdlib merge walk, no scipy)."""
    if not a or not b:
        return 1.0 if (a or b) else 0.0
    sa, sb = sorted(a), sorted(b)
    i = j = 0
    d = 0.0
    while i < len(sa) and j < len(sb):
        x = min(sa[i], sb[j])
        while i < len(sa) and sa[i] <= x:
            i += 1
        while j < len(sb) and sb[j] <= x:
            j += 1
        d = max(d, abs(i / len(sa) - j / len(sb)))
    return max(d, abs(1.0 - j / len(sb)), abs(i / len(sa) - 1.0))


def detect_distribution_divergence(sim: ObservationFrame,
                                   real: ObservationFrame,
                                   metric: str, *, max_ks: float):
    """Distributional agreement OVER windows: the two planes' window
    samples of one metric, compared as distributions (two-sample KS
    distance).  Catches what per-window bands structurally cannot —
    e.g. the same values arriving in a different order, or one plane
    spending systematically more windows in a regime — and fires
    when the distance exceeds the calibrated ``max_ks``."""
    ks = _ks_distance(sim.column(metric), real.column(metric))
    if ks <= max_ks:
        return None
    return {"reason": "distribution_divergence", "metric": metric,
            "ks": round(ks, 4), "max_ks": max_ks}


def compare_frames(sim: ObservationFrame, real: ObservationFrame,
                   bands: Dict[str, dict]) -> List[dict]:
    """Run every calibrated band against the frame pair; findings in
    metric order, structural mismatches first.  ``bands`` maps
    metric → ``{"rtol", "atol", "max_ks"}`` (``max_ks`` optional) —
    the committed ``TWIN_r10.json`` shape."""
    findings: List[dict] = []
    if sim.n_windows != real.n_windows:
        findings.append({"reason": "window_count_mismatch",
                         "metric": "t_s",
                         "sim_windows": sim.n_windows,
                         "real_windows": real.n_windows})
    for metric in sorted(bands):
        band = bands[metric]
        found = detect_band_divergence(
            sim, real, metric, rtol=float(band.get("rtol", 0.0)),
            atol=float(band.get("atol", 0.0)))
        if found is not None:
            findings.append(found)
        if "max_ks" in band:
            found = detect_distribution_divergence(
                sim, real, metric, max_ks=float(band["max_ks"]))
            if found is not None:
                findings.append(found)
    return findings


#: calibration floors per metric family: the smallest absolute band
#: worth claiming (float/platform jitter for the ratio columns, "off
#: by half a peer" for the integer membership columns, one pacing
#: quantum of rate).  Everything else falls back to the ratio floor.
_CALIBRATION_FLOORS = {
    "present_peers": 0.5, "joins": 0.5, "leaves": 0.5,
    "stalled_peers": 1.5, "cdn_rate_bps": 200_000.0,
    "p2p_rate_bps": 200_000.0, "offload": 0.01, "rebuffer": 0.005,
    # the stall-quantile columns: a couple of digest bins of slack
    # (the sketch's ~1.6× relative resolution at the second scale)
    "rebuffer_ms_p50": 250.0, "rebuffer_ms_p95": 500.0,
    "rebuffer_ms_p99": 500.0}


def calibrate_bands(sim: ObservationFrame, real: ObservationFrame, *,
                    rtol: float = 0.25,
                    headroom: float = 1.5) -> Dict[str, dict]:
    """Measured tolerance bands for a frame pair: with the relative
    term fixed at ``rtol``, the absolute term is the worst RESIDUAL
    the measurement actually needed (``max_w(err_w - rtol·scale_w)``)
    times ``headroom``, floored per metric family; ``max_ks`` is the
    measured KS distance with the same headroom (plus one window's
    CDF mass, floored — two same-shape distributions never get a
    zero-width band).  ``tools/twin_gate.py --write-bands`` persists
    the result as the committed ``TWIN_r10.json``: the bands are a
    MEASURED error envelope, recalibrated deliberately, never
    silently."""
    bands: Dict[str, dict] = {}
    n = min(sim.n_windows, real.n_windows)
    for metric in sim.columns:
        if metric == "t_s":
            continue
        s = sim.column(metric)
        r = real.column(metric)
        residual = 0.0
        for w in range(n):
            scale = max(abs(s[w]), abs(r[w]))
            residual = max(residual,
                           abs(s[w] - r[w]) - rtol * scale)
        floor = _CALIBRATION_FLOORS.get(metric, 0.01)
        ks = _ks_distance(s[:n], r[:n])
        bands[metric] = {
            "rtol": rtol,
            "atol": round(max(residual * headroom, floor), 6),
            "max_ks": round(min(max(ks * headroom + 1.0 / max(n, 1),
                                    0.15), 1.0), 4)}
    return bands


def frame_errors(sim: ObservationFrame,
                 real: ObservationFrame) -> Dict[str, dict]:
    """Per-metric worst-case agreement summary — the fleet console's
    twin panel and the band-calibration input: max absolute and
    relative error with the worst window's index and clock, plus the
    KS distance."""
    out: Dict[str, dict] = {}
    t_s = sim.column("t_s")
    n = min(sim.n_windows, real.n_windows)
    for metric in sim.columns:
        if metric == "t_s":
            continue
        s = sim.column(metric)
        r = real.column(metric)
        worst_abs = 0.0
        worst_rel = 0.0
        worst_w = 0
        worst_rel_w = 0
        for w in range(n):
            err = abs(s[w] - r[w])
            if err > worst_abs:
                worst_abs = err
                worst_w = w
            scale = max(abs(s[w]), abs(r[w]))
            if scale > 0 and err / scale > worst_rel:
                worst_rel = err / scale
                worst_rel_w = w
        # the two maxima land in DIFFERENT windows whenever the
        # metric's scale swings (a big abs gap on a big value vs a
        # big ratio on a small one) — each is reported with its own
        # window so a consumer never points at the wrong one
        out[metric] = {
            "max_abs_err": round(worst_abs, 6),
            "max_rel_err": round(worst_rel, 4),
            "worst_window": worst_w,
            "worst_t_s": round(t_s[worst_w], 3) if n else 0.0,
            "worst_rel_window": worst_rel_w,
            "worst_rel_t_s": round(t_s[worst_rel_w], 3) if n else 0.0,
            "ks": round(_ks_distance(s[:n], r[:n]), 4)}
    return out
