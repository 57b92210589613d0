# A copy of the reference's engine/p2p_agent.py
# (hlsjs_p2p_wrapper_tpu/engine/p2p_agent.py): the same names, formats and
# bytes; the imports point at the port's own modules, and a few comments no
# longer cite the reference's history.
"""The full P2P delivery agent — the reference's missing closed half.

Implements the complete §2.10 contract (SURVEY.md) the reference only
*calls* into its closed-source ``streamroot-p2p`` module
(lib/hlsjs-p2p-wrapper-private.js:224): tracker-based swarm discovery,
peer mesh with truthful availability, an LRU segment cache that doubles
as the upload store, deadline-aware peer/CDN source selection with
bounded failover, background P2P prefetch into the playback window,
public stats ``{cdn, p2p, upload, peers}`` and the
``p2p_download_on`` / ``p2p_upload_on`` toggles
(lib/hlsjs-p2p-wrapper.js:14-36).

``p2p_config`` keys understood (beyond the reference's
``content_id``/``debug``):

- ``network``: a :class:`~.transport.LoopbackNetwork` (or compatible)
  to attach to — REQUIRED for P2P; without it the agent degrades to
  CDN-only delivery
- ``peer_id``: our swarm identity (default: generated)
- ``clock``, ``cdn_transport``: injectables as in
  :class:`~.cdn_agent.CdnOnlyAgent`
- ``cache_max_bytes``: upload store budget
- ``announce_interval_ms``, ``request_timeout_ms``
- ``max_concurrent_prefetch``, ``prefetch_interval_ms``
- ``prefetch_rotation`` (default True): rotate failed prefetch
  retries across holders; False restores the original head-holder
  retry for A/B studies
- ``live_buffer_margin``: if set and the stream is live, the agent
  steers the player's buffer target via ``set_buffer_margin_live``
  (player-interface.js:63-66)
- ``live_edge_spread_ms`` (default 2000): live swarms are nearly
  synchronized — every viewer wants each new segment the moment it
  appears, so everyone races to the CDN before any HAVE can
  propagate.  Each peer therefore waits a stable per-peer fraction of
  this spread before falling back to the CDN for a segment no peer
  has yet; low-rank peers seed, the rest catch the HAVE and ride P2P.
  Skipped when playback is urgent or no peers are connected.
- scheduling knobs: see :class:`~.scheduler.SchedulingPolicy`
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import math
import uuid
from typing import Callable, Dict, Optional

from ..core.clock import Clock, SystemClock
from ..core.errors import PlayerStateError
from . import protocol as P
from .cache import DEFAULT_MAX_BYTES as DEFAULT_CACHE_MAX_BYTES
from .cache import SegmentCache
from .cdn import CdnTransport, HttpCdnTransport
from .cdn_agent import StreamTypes
from .mesh import DEFAULT_REQUEST_TIMEOUT_MS, MAX_TOTAL_SERVES, PeerMesh
from .scheduler import SchedulingPolicy, decide
from .stats import AgentStats
from .tracker import (DEFAULT_ANNOUNCE_INTERVAL_MS, TRACKER_PEER_ID,
                      TrackerClient, swarm_id_for)

log = logging.getLogger(__name__)

DEFAULT_MAX_CONCURRENT_PREFETCH = 2
DEFAULT_PREFETCH_INTERVAL_MS = 1_000.0

#: scheduling-policy fields a live KNOB_UPDATE may retune, with the
#: coercion each applies (the wire carries every value as f64).  The
#: allowlist is the actuation trust boundary: a controller can move
#: the scheduler's published tunables and NOTHING else — no epoch can
#: rewire transports, identities, or cache budgets.
LIVE_KNOB_FIELDS = {
    "urgent_margin_s": float,
    "p2p_budget_fraction": float,
    "p2p_budget_cap_ms": float,
    "p2p_budget_floor_ms": float,
    "max_p2p_attempts": int,
}


class _GetSegmentRequest:
    """Abortable handle for one foreground ``get_segment`` call,
    spanning the P2P attempt and/or the CDN leg
    (reference contract: loader-generator.js:164,31-37)."""

    def __init__(self, clock: Clock):
        self.clock = clock
        self.aborted = False
        self.done = False
        self.p2p_handle = None
        self.cdn_handle = None
        self.failover_timer = None

    def abort(self) -> None:
        self.aborted = True
        self._teardown()

    def finish(self) -> None:
        self.done = True
        self._teardown()

    def _teardown(self) -> None:
        if self.failover_timer is not None:
            self.failover_timer.cancel()
            self.failover_timer = None
        if self.p2p_handle is not None:
            self.p2p_handle.abort()
            self.p2p_handle = None
        if self.cdn_handle is not None:
            self.cdn_handle.abort()
            self.cdn_handle = None


class P2PAgent:
    """Complete peer-to-peer segment-delivery engine."""

    StreamTypes = StreamTypes

    def __init__(self, player_bridge, content_url: str, media_map,
                 p2p_config: Dict, segment_view_class, stream_type: str,
                 integration_version: str):
        self.player_bridge = player_bridge
        self.content_url = content_url
        self.media_map = media_map
        self.p2p_config = dict(p2p_config or {})
        self.segment_view_class = segment_view_class
        self.stream_type = stream_type
        self.integration_version = integration_version

        cfg = self.p2p_config
        # single-threaded by construction: if the network brings its
        # own dispatch loop (TcpNetwork's NetLoop implements Clock),
        # timers default onto THAT thread — a SystemClock default here
        # would fire timeouts on threading.Timer threads racing the
        # NetLoop's frame handling over unlocked engine state
        self.clock: Clock = (cfg.get("clock")
                             or getattr(cfg.get("network"), "loop", None)
                             or SystemClock())
        self.cdn_transport: CdnTransport = (cfg.get("cdn_transport")
                                            or HttpCdnTransport())
        self.policy = SchedulingPolicy.from_config(cfg)

        # unified telemetry (engine/telemetry.py): a harness-shared
        # registry makes this agent's stats + mesh lifecycle counters
        # exportable labeled series; absent, the instruments are
        # private and the public stats dict is unchanged
        self.metrics_registry = cfg.get("metrics_registry")
        self.media_element = None
        self.disposed = False
        self.p2p_download_on = True
        self.p2p_upload_on = True

        self.swarm_id = swarm_id_for(content_url, cfg)
        self.peer_id: str = cfg.get("peer_id") or f"peer-{uuid.uuid4().hex[:12]}"

        self.cache = SegmentCache(
            max_bytes=cfg.get("cache_max_bytes", DEFAULT_CACHE_MAX_BYTES),
            on_evict=self._on_cache_evict)
        # engine-measured transfer time per cached segment, so instant
        # cache hits can report a truthful duration for ABR shaping
        # (the reference FIXME at loader-generator.js:195-196 asks for
        # exactly this: real RTT/durations surfaced from the engine)
        self._transfer_ms: Dict[bytes, float] = {}
        # cumulative stats count each segment's NETWORK transfer once,
        # at transfer time; cache replays move no bytes and add nothing
        # (offload_ratio is the north-star metric — BASELINE.json)

        self._current_track = None
        self._live_steered = False
        self._is_live: Optional[bool] = None  # unknown until manifest
        self._prefetches: Dict[bytes, object] = {}
        # per-key failed-attempt counts: retries rotate to the NEXT
        # holder instead of deterministically re-asking the one that
        # just denied/timed out (holders_of is stable per key)
        self._prefetch_failures: Dict[bytes, int] = {}
        self._prefetch_timer = None

        network = cfg.get("network")
        if network is not None:
            self.endpoint = network.register(
                self.peer_id, uplink_bps=cfg.get("uplink_bps"))
            # real fabrics assign identity at bind time (TcpNetwork:
            # the listener address IS the peer id); adopt it
            self.peer_id = self.endpoint.peer_id
            # stats are labeled by the adopted id, and MUST exist
            # before on_receive / the tracker client go live below —
            # on a real fabric a network-thread callback can complete
            # a transfer (bumping _stats) the moment frames flow
            self._stats = AgentStats(self.metrics_registry,
                                     peer_id=self.peer_id)
            self.mesh = PeerMesh(
                self.endpoint, self.swarm_id, self.clock, self.cache,
                request_timeout_ms=cfg.get("request_timeout_ms",
                                           DEFAULT_REQUEST_TIMEOUT_MS),
                is_upload_on=lambda: self.p2p_upload_on and not self.disposed,
                # "spread" by default: least-loaded +
                # rendezvous hash + retry rotation.  The earlier
                # "adaptive" feedback (BUSY/timeout penalty window)
                # measured a net loss — it never paid the +0.03 A/B
                # bar and herds demand onto the few fast holders in
                # slow-majority swarms (POLICY_AB_r05.json meta);
                # announce-order ("ranked") still herds the whole
                # swarm onto one uplink under contention
                # (mesh.holders_of)
                holder_selection=cfg.get("holder_selection", "spread"),
                # serve admission control (mesh.MAX_TOTAL_SERVES)
                max_total_serves=cfg.get("max_total_serves",
                                         MAX_TOTAL_SERVES),
                registry=self.metrics_registry)
            self.mesh.on_remote_have = lambda _peer: self._schedule_prefetch()
            # reject-path visibility (the TrackerEndpoint convention):
            # undecodable frames are dropped — one malformed peer must
            # not kill the dispatch path — but COUNTED, so the fuzz
            # suite and dashboards see a poisoning attempt, not silence
            self._m_decode_rejects = self.mesh.metrics.counter(
                "mesh.decode_rejects")
            self.tracker_client = TrackerClient(
                self.endpoint, self.swarm_id, self.peer_id, self.clock,
                tracker_peer_id=cfg.get("tracker_peer_id", TRACKER_PEER_ID),
                announce_interval_ms=cfg.get("announce_interval_ms",
                                             DEFAULT_ANNOUNCE_INTERVAL_MS),
                on_peers=lambda peers: self.mesh.on_tracker_peers(peers),
                on_knobs=self._apply_knobs,
                registry=self.metrics_registry)
            # frames claiming to be FROM the tracker are trusted
            # (TrackerClient matches on src id); on a fabric where
            # inbound identity is self-declared, forbid peers from
            # claiming it (engine/net.py trust model)
            reject = getattr(self.endpoint, "reject_inbound_ids", None)
            if reject is not None:
                reject.add(self.tracker_client.tracker_peer_id)
            self.endpoint.on_receive = self._on_frame
            self.tracker_client.start()
            self._arm_prefetch_timer()
        else:
            self.endpoint = None
            self.mesh = None
            self.tracker_client = None
            self._stats = AgentStats(self.metrics_registry,
                                     peer_id=self.peer_id)

        # stable edge-fetch rank in [0, 1): who seeds fresh live
        # segments from the CDN, and who waits for the swarm.  Hashed
        # from the ADOPTED id — real fabrics assign identity at
        # register time, and a config-supplied id they ignore would
        # give every viewer the same rank (thundering herd).
        digest = hashlib.sha256(self.peer_id.encode()).digest()
        self._edge_rank = int.from_bytes(digest[:4], "little") / 2**32

        player_bridge.add_event_listener("onTrackChange", self._on_track_change)

    # -- transport dispatch --------------------------------------------
    def _on_frame(self, src_id: str, frame: bytes) -> None:
        if self.disposed:
            return
        try:
            msg = P.decode(frame)
        except P.ProtocolError:
            log.warning("dropping malformed frame from %s", src_id)
            self._m_decode_rejects.inc()
            return
        if self.tracker_client.handle_frame(src_id, msg):
            return
        self.mesh.handle_frame(src_id, msg)

    # -- live knob actuation (control plane) ---------------------------
    def _apply_knobs(self, epoch: int, knobs: Dict[str, float]) -> None:
        """One KNOB_UPDATE epoch, applied to the scheduling policy.
        The TrackerClient already gated on epoch monotonicity, so
        this runs EXACTLY once per epoch regardless of how many
        announces piggybacked it.  Unknown names are skipped (a newer
        controller may publish knobs this build does not have) and
        non-finite values are refused — a hostile or buggy SET_KNOBS
        must not poison the scheduler's arithmetic."""
        updates = {}
        skipped = 0
        for name, value in knobs.items():
            if name not in LIVE_KNOB_FIELDS \
                    or not math.isfinite(value):
                skipped += 1
                continue
            updates[name] = LIVE_KNOB_FIELDS[name](value)
        if updates:
            self.policy = dataclasses.replace(self.policy, **updates)
        log.debug("peer %s applied knob epoch %d: %s (%d skipped)",
                  self.peer_id, epoch, updates, skipped)
        if self.metrics_registry is not None:
            if updates:
                self.metrics_registry.counter(
                    "control.knob_applies", peer=self.peer_id,
                    result="applied").inc()
            if skipped:
                self.metrics_registry.counter(
                    "control.knob_applies", peer=self.peer_id,
                    result="skipped").inc(skipped)

    # -- §2.10 data plane ----------------------------------------------
    def get_segment(self, req_info: Dict, callbacks: Dict[str, Callable],
                    segment_view) -> _GetSegmentRequest:
        if self.disposed:
            raise RuntimeError("get_segment called on disposed agent")
        self._maybe_steer_live_buffer()
        request = _GetSegmentRequest(self.clock)
        key = segment_view.to_bytes()

        # 1. cache hit: instant delivery, reported p2p-shaped with the
        #    truthful ORIGINAL transfer duration so the loader's
        #    back-dating keeps the ABR estimate honest
        #    (loader-generator.js:181-201).  No stats credit: the bytes
        #    moved over the network exactly once, at transfer time.
        if self.p2p_download_on:
            cached = self.cache.get(key)
            if cached is not None:
                size = len(cached)
                duration = self._transfer_ms.get(key, 0.0)
                callbacks["on_progress"]({
                    "cdn_downloaded": 0, "p2p_downloaded": size,
                    "cdn_duration": 0, "p2p_duration": duration})
                request.finish()
                callbacks["on_success"](cached)
                return request

        # 2. source selection
        holders = self.mesh.holders_of(key) if (
            self.mesh is not None and self.p2p_download_on) else []
        margin_s = self._playback_margin_s(segment_view)
        decision = decide(self.policy, margin_s=margin_s,
                          holder_count=len(holders),
                          download_on=self.p2p_download_on)

        if decision.use_p2p:
            self._start_p2p_leg(request, key, req_info, callbacks,
                                decision.p2p_budget_ms, segment_view)
        else:
            wait_ms = self._edge_wait_ms(holders, margin_s)
            if wait_ms > 0:
                self._start_edge_wait(request, key, req_info, callbacks,
                                      segment_view, wait_ms)
            else:
                self._start_cdn_leg(request, key, req_info, callbacks)
        return request

    # -- live edge stagger ---------------------------------------------
    def _edge_wait_ms(self, holders, margin_s) -> float:
        """How long to hold the CDN trigger for a fresh live segment no
        peer serves yet.  0 = fetch now (non-live, urgent, alone, rank
        says we're a seeder, or toggled off)."""
        if (holders or not self.p2p_download_on or self.mesh is None
                or self.mesh.connected_count == 0
                or not self._check_live()):
            return 0.0
        if margin_s is not None and margin_s < self.policy.urgent_margin_s:
            return 0.0
        spread = self.p2p_config.get("live_edge_spread_ms", 2_000.0)
        return self._edge_rank * spread

    def _start_edge_wait(self, request: _GetSegmentRequest, key: bytes,
                         req_info: Dict, callbacks: Dict,
                         segment_view, wait_ms: float) -> None:
        def re_evaluate() -> None:
            if request.aborted or request.done or self.disposed:
                return
            request.failover_timer = None
            holders = self.mesh.holders_of(key) if self.p2p_download_on \
                else []
            if holders:
                margin_s = self._playback_margin_s(segment_view)
                decision = decide(self.policy, margin_s=margin_s,
                                  holder_count=len(holders),
                                  download_on=True)
                if decision.use_p2p:
                    self._start_p2p_leg(request, key, req_info, callbacks,
                                        decision.p2p_budget_ms, segment_view)
                    return
            self._start_cdn_leg(request, key, req_info, callbacks)

        request.failover_timer = self.clock.call_later(wait_ms, re_evaluate)

    def _start_p2p_leg(self, request: _GetSegmentRequest, key: bytes,
                       req_info: Dict, callbacks: Dict,
                       budget_ms: float, segment_view) -> None:
        """Walk the holders within ONE time budget: best holder first,
        then — on deny/timeout — the next untried (least-loaded)
        holder with the remaining budget split across the attempts
        left, up to ``policy.max_p2p_attempts``.  CDN only when
        holders or budget are exhausted — a dead best-holder must not
        spend the whole budget when another peer has the bytes."""
        t_start = self.clock.now()
        deadline = t_start + budget_ms
        max_attempts = max(1, self.policy.max_p2p_attempts)
        tried: set = set()

        def to_cdn(_err=None) -> None:
            # dispose() closes the mesh, which fails in-flight P2P
            # downloads through this path — it must not resurrect the
            # request as a CDN fetch into a torn-down player
            if request.aborted or request.done or self.disposed:
                return
            if request.failover_timer is not None:
                request.failover_timer.cancel()
                request.failover_timer = None
            if request.p2p_handle is not None:
                handle, request.p2p_handle = request.p2p_handle, None
                handle.abort()
            # partial P2P bytes are discarded: the CDN leg restarts the
            # payload, so progress reverts to cdn-only accounting
            self._start_cdn_leg(request, key, req_info, callbacks)

        def on_progress(received: int) -> None:
            if request.aborted or request.done:
                return
            callbacks["on_progress"]({
                "cdn_downloaded": 0, "p2p_downloaded": received,
                "cdn_duration": 0,
                "p2p_duration": self.clock.now() - t_start})

        def on_success(payload: bytes) -> None:
            if request.aborted or request.done:
                return
            duration = self.clock.now() - t_start
            self._stats.p2p += len(payload)
            # twin provenance: same delta, additive view (stats.py)
            self._stats.note_fetch_bytes("p2p", len(payload))
            self._stats.note_fetch_done("p2p")
            self._stats.note_fetch_ms("p2p", duration)
            request.finish()
            self._store(key, payload, duration)
            callbacks["on_success"](payload)

        def try_next(_err=None) -> None:
            if request.aborted or request.done or self.disposed:
                return
            request.p2p_handle = None
            remaining_ms = deadline - self.clock.now()
            attempts_left = max_attempts - len(tried)
            # re-query live: HAVEs that arrived mid-leg are candidates
            # too; a denying holder already pruned itself from have
            candidates = [p for p in self.mesh.holders_of(key)
                          if p not in tried]
            if not candidates or attempts_left <= 0 or remaining_ms <= 0:
                to_cdn()
                return
            peer_id = candidates[0]
            tried.add(peer_id)
            per_try_ms = remaining_ms / min(attempts_left, len(candidates))
            request.p2p_handle = self.mesh.request(
                peer_id, key, on_success=on_success, on_error=try_next,
                on_progress=on_progress, timeout_ms=per_try_ms)

        # belt over suspenders: per-attempt mesh timeouts already keep
        # inside the budget; this timer survives even if a mesh entry
        # leaks, enforcing the whole-leg deadline
        request.failover_timer = self.clock.call_later(budget_ms + 50.0,
                                                       to_cdn)
        try_next()

    def _start_cdn_leg(self, request: _GetSegmentRequest, key: bytes,
                       req_info: Dict, callbacks: Dict) -> None:
        t_start = self.clock.now()
        state = {"reported": 0}

        def on_progress(event: Dict) -> None:
            if request.aborted or request.done:
                return
            downloaded = event.get("cdn_downloaded", 0)
            delta = downloaded - state["reported"]
            self._stats.cdn += delta
            self._stats.note_fetch_bytes("cdn", delta)
            state["reported"] = downloaded
            callbacks["on_progress"]({
                "cdn_downloaded": downloaded, "p2p_downloaded": 0,
                "cdn_duration": self.clock.now() - t_start,
                "p2p_duration": 0})

        def on_success(data: bytes) -> None:
            if request.aborted or request.done:
                return
            delta = len(data) - state["reported"]
            self._stats.cdn += delta
            self._stats.note_fetch_bytes("cdn", delta)
            self._stats.note_fetch_done("cdn")
            duration = self.clock.now() - t_start
            self._stats.note_fetch_ms("cdn", duration)
            request.finish()
            self._store(key, data, duration)
            callbacks["on_success"](data)

        def on_error(error: Dict) -> None:
            if request.aborted or request.done:
                return
            request.finish()
            callbacks["on_error"](error)

        request.cdn_handle = self.cdn_transport.fetch(
            req_info, {"on_progress": on_progress, "on_success": on_success,
                       "on_error": on_error})

    # -- cache + availability ------------------------------------------
    def _store(self, key: bytes, payload: bytes, duration_ms: float) -> None:
        self.cache.put(key, payload)
        if self.cache.has(key):
            self._transfer_ms[key] = duration_ms
            if self.mesh is not None:
                self.mesh.broadcast_have(key)

    def _on_cache_evict(self, key: bytes) -> None:
        self._transfer_ms.pop(key, None)
        if self.mesh is not None and not self.mesh.closed:
            self.mesh.broadcast_lost(key)

    # -- prefetch ------------------------------------------------------
    def _arm_prefetch_timer(self) -> None:
        if self.disposed:
            return
        interval = self.p2p_config.get("prefetch_interval_ms",
                                       DEFAULT_PREFETCH_INTERVAL_MS)
        self._prefetch_timer = self.clock.call_later(
            interval, self._prefetch_tick)

    def _prefetch_tick(self) -> None:
        self._schedule_prefetch()
        self._arm_prefetch_timer()

    def _schedule_prefetch(self) -> None:
        """Pull upcoming in-window segments from peers while playback
        has slack — this is where swarm offload beyond natural cache
        hits comes from."""
        if (self.disposed or self.mesh is None or not self.p2p_download_on
                or self._current_track is None):
            return
        max_concurrent = self.p2p_config.get(
            "max_concurrent_prefetch", DEFAULT_MAX_CONCURRENT_PREFETCH)
        if len(self._prefetches) >= max_concurrent:
            return
        try:
            window_s = self.player_bridge.get_buffer_level_max()
        except Exception:  # fault-ok: player not ready yet — absence is the signal
            return
        playhead = (self.media_element.current_time
                    if self.media_element is not None else 0.0)
        try:
            segments = self.media_map.get_segment_list(
                self._current_track, playhead, window_s)
        except Exception:  # fault-ok: level vanished mid-switch; skip this tick
            return
        rotate = self.p2p_config.get("prefetch_rotation", True)
        for segment in segments:
            if len(self._prefetches) >= max_concurrent:
                break
            key = segment.to_bytes()
            if self.cache.has(key) or key in self._prefetches:
                continue
            holders = self.mesh.holders_of(key)
            if not holders:
                continue
            # rotate past holders that already failed this key —
            # holders_of is deterministic per (requester, key), so an
            # unrotated retry would re-ask the same overloaded peer
            # forever.  ``prefetch_rotation: False`` restores the
            # original retry behavior (always the head holder) for
            # A/B studies of the rotation itself.
            attempt = (self._prefetch_failures.get(key, 0)
                       if rotate else 0)
            self._start_prefetch(key, holders[attempt % len(holders)])

    def _start_prefetch(self, key: bytes, peer_id: str) -> None:
        t_start = self.clock.now()

        def on_success(payload: bytes) -> None:
            self._prefetches.pop(key, None)
            self._prefetch_failures.pop(key, None)
            self._stats.p2p += len(payload)
            self._stats.note_fetch_bytes("p2p", len(payload))
            self._stats.note_fetch_done("p2p")
            self._store(key, payload, self.clock.now() - t_start)
            self._schedule_prefetch()

        def on_error(_error: Dict) -> None:
            self._prefetches.pop(key, None)
            if len(self._prefetch_failures) > 512:
                # stale keys (played past, evicted elsewhere) must not
                # accumulate for the session lifetime
                self._prefetch_failures.clear()
            self._prefetch_failures[key] = (
                self._prefetch_failures.get(key, 0) + 1)

        # reserve the slot BEFORE issuing the request: under a
        # SystemClock the callbacks can fire on a timer thread before
        # request() returns, and assigning afterwards would resurrect
        # a completed entry as a permanent stale slot
        self._prefetches[key] = None
        handle = self.mesh.request(peer_id, key, on_success=on_success,
                                   on_error=on_error)
        if key in self._prefetches:
            self._prefetches[key] = handle

    # -- control plane -------------------------------------------------
    def _on_track_change(self, data: Dict) -> None:
        self._current_track = data["video"]
        self._schedule_prefetch()

    def _playback_margin_s(self, segment_view) -> Optional[float]:
        if self.media_element is None or segment_view.time is None:
            return None
        return segment_view.time - self.media_element.current_time

    def _check_live(self) -> bool:
        """Cached liveness; False until the manifest can answer."""
        if self._is_live is None:
            try:
                self._is_live = bool(self.player_bridge.is_live())
            except Exception:  # fault-ok: manifest not parsed yet — retry next call
                return False
        return self._is_live

    def _maybe_steer_live_buffer(self) -> None:
        """Live swarm health: widen/pin the player's buffer target once
        the stream is known to be live (player-interface.js:63-66)."""
        if self._live_steered:
            return
        margin = self.p2p_config.get("live_buffer_margin")
        if margin is None:
            return
        try:
            live = self.player_bridge.is_live()
        except PlayerStateError:
            return  # manifest not parsed yet; retry on a later call
        self._live_steered = True
        if live:
            self.player_bridge.set_buffer_margin_live(margin)

    def set_media_element(self, media) -> None:
        """Media handoff (wrapper-private.js:174-182): gives the agent
        the playhead, which drives deadline margins and the prefetch
        window."""
        self.media_element = media

    def dispose(self) -> None:
        if self.disposed:
            return
        self.disposed = True
        if self._prefetch_timer is not None:
            self._prefetch_timer.cancel()
        for handle in list(self._prefetches.values()):
            if handle is not None:  # None = reservation mid-request
                handle.abort()
        self._prefetches.clear()
        if self.tracker_client is not None:
            self.tracker_client.stop()
        if self.mesh is not None:
            self.mesh.close()
        if self.endpoint is not None:
            self.endpoint.close()
        # the peers gauge is point-in-time: a departed agent has zero
        # live connections, and a shared-registry export must not
        # keep reporting its pre-leave count forever (byte totals
        # stay — they are cumulative by contract)
        self._stats.peers = 0

    @property
    def stats(self) -> Dict:
        if self.mesh is not None:
            self._stats.upload = self.mesh.upload_bytes
            self._stats.peers = self.mesh.connected_count
        return self._stats.as_dict()
