# A copy of the reference's player/sim.py
# (hlsjs_p2p_wrapper_tpu/player/sim.py): the same names, formats and bytes;
# the imports point at the port's own modules, and a few comments no longer
# cite the reference's history.
"""Simulated media engine (the in-tree L0 player).

The reference integrates against hls.js, an external dependency that
owns ABR, the stream controller, and the media buffer (SURVEY.md §1
L0).  This rebuild is self-contained, so it ships a deterministic
player with the same integration surface the wrapper layer consumes:

- ``levels`` with ``details.fragments`` / ``url`` / ``url_id``
- ``config`` dict honoring the forced defaults and instantiating
  ``config["f_loader"]`` once per fragment (the fLoader seam,
  wrapper-private.js:82-86)
- the :class:`~..core.events.Events` bus (MANIFEST_LOADING,
  LEVEL_SWITCH, MEDIA_ATTACHING, DESTROYING, ERROR, ...)
- hls.js-shaped dynamics: ABR via the in-tree dual-EWMA estimator,
  buffer-length-bounded fetching, playback/rebuffer accounting, seek

Driven entirely by an injectable clock: on a VirtualClock it powers
the e2e tests (the reference's karma tier) and the swarm simulator;
on a SystemClock it plays "in real time".
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, List, Optional

from ..core.abr import AbrController, compute_frag_last_kbps
from ..core.clock import Clock, SystemClock
from ..core.events import EventEmitter, Events
from .manifest import Manifest

DEFAULT_CONFIG = {
    "f_loader": None,
    "loader": None,
    "max_buffer_size": 60 * 1000 * 1000,
    "max_buffer_length": 30,
    "live_sync_duration": None,
    "live_sync_duration_count": None,
    "frag_load_timeout": 20_000,
    "frag_load_max_retry": 6,
    "frag_load_retry_delay": 1000,
    "request_setup": None,
    "clock": None,
    "manifest": None,
    "manifest_delay_ms": 30.0,
    "autoplay": True,
}

TICK_MS = 100.0


class Level:
    """Runtime level state with the attribute surface MediaMap and
    PlayerInterface read (url list, url_id, details.fragments)."""

    def __init__(self, index: int, spec, live: bool):
        self.index = index
        self.bitrate = spec.bitrate
        self.url = list(spec.urls)
        self.url_id = 0
        # fragments are shared with the manifest (NOT copied): live
        # timelines mutate in place and every reader — player,
        # MediaMap, agent prefetcher — must see the sliding window
        self.details = SimpleNamespace(
            live=live, fragments=spec.fragments,
            totalduration=sum(f.duration for f in spec.fragments))


class MediaElementSim:
    """Stand-in for the HTML media element handed to the agent."""

    def __init__(self):
        self.current_time = 0.0
        self.paused = False


class SimPlayer(EventEmitter):
    """Deterministic hls.js-shaped media engine."""

    Events = Events
    DefaultConfig = dict(DEFAULT_CONFIG)

    def __init__(self, config: Optional[dict] = None):
        super().__init__()
        self.config = dict(DEFAULT_CONFIG)
        self.config.update(config or {})
        self.clock: Clock = self.config.get("clock") or SystemClock()

        self.url: Optional[str] = None
        self.media: Optional[MediaElementSim] = None
        self._manifest: Optional[Manifest] = None
        self._levels: Optional[List[Level]] = None

        self.abr = AbrController(self)
        self.current_level = 0
        #: hls.js fires LEVEL_SWITCH on EVERY level assignment,
        #: including the initial selection at playback start (its
        #: level-controller's setter has no was-it-different guard on
        #: first set) — so the first fetch must announce the level
        #: even when ABR keeps the default.  Without this, a
        #: constant-level session never tells the agent its track and
        #: the prefetcher sits dark for the whole session (found by
        #: harness instrumentation: 1-level swarms ran
        #: foreground-only).
        self._level_announced = False
        self.frag_last_kbps = 0

        self.buffer_end = 0.0          # contiguous buffer ahead of playhead
        self.next_sn: Optional[int] = None
        self.ended = False
        self.destroyed = False
        self.last_error = None

        self.rebuffer_ms = 0.0         # stall time while playing
        self.play_ms = 0.0
        self.bytes_loaded = 0
        self.frags_loaded = 0

        #: twin-observability hooks (engine/twinframe.py): the swarm
        #: harness wires these to ``twin.stall_ms`` / ``twin.stalls``
        #: registry counters so every rebuffer accrual and stall
        #: open/close transition reaches the shared event plane with
        #: the EXACT dt the ``rebuffer_ms`` clock advanced by.  None
        #: (the default) costs nothing.
        self.stalled = False
        self.on_stall_accrue: Optional[Callable[[float], None]] = None
        self.on_stall_edge: Optional[Callable[[bool], None]] = None

        self._loading = False
        self._loader = None
        self._tick_timer = None
        self._redundant_rotations = 0  # backup-URL switches per frag run

    # -- public surface (hls.js-shaped) --------------------------------
    @property
    def levels(self):
        return self._levels

    @property
    def load_level(self) -> int:
        return self.current_level

    @property
    def next_load_level(self) -> int:
        return self.abr.next_level(self._levels) if self._levels else 0

    @property
    def buffer_length(self) -> float:
        position = self.media.current_time if self.media else 0.0
        return max(0.0, self.buffer_end - position)

    @staticmethod
    def is_supported() -> bool:
        return True

    def load_source(self, url: str, manifest: Optional[Manifest] = None) -> None:
        self.url = url
        if manifest is not None:
            self._manifest = manifest
        elif self.config.get("manifest") is not None:
            self._manifest = self.config["manifest"]
        else:
            raise ValueError(
                "SimPlayer needs a Manifest (pass to load_source or set "
                "config['manifest'])")
        self.emit(Events.MANIFEST_LOADING, {"url": url})
        self.clock.call_later(self.config["manifest_delay_ms"],
                              self._parse_manifest)

    def attach_media(self, media: Optional[MediaElementSim] = None) -> None:
        # media is set before the event fires: MEDIA_ATTACHING handlers
        # read `player.media` (reference: wrapper-private.js:178-180)
        self.media = media or MediaElementSim()
        if self.is_live and self._levels is not None:
            # manifest parsed before attach: join at the live position
            self.media.current_time = max(self.media.current_time,
                                          getattr(self, "_live_start_t", 0.0))
        self.emit(Events.MEDIA_ATTACHING, {})
        self._ensure_ticking()

    def seek(self, t: float) -> None:
        """Jump the playhead; drops the buffer and any in-flight
        fragment, like a real player flushing on seek."""
        if self.media is None:
            raise RuntimeError("seek before attach_media")
        self._abort_inflight()
        self.media.current_time = t
        self.buffer_end = t
        self.next_sn = self._sn_for_time(t)
        # a VOD seek past the end is ended NOW: deciding it on the
        # next tick would let _advance_playback charge one spurious
        # TICK_MS of rebuffer first (tick order: playback then fetch)
        self.ended = self.next_sn is None and not self.is_live

    def destroy(self) -> None:
        self.emit(Events.DESTROYING, {})
        self._abort_inflight()
        if self._tick_timer is not None:
            self._tick_timer.cancel()
            self._tick_timer = None
        self.destroyed = True
        self.remove_all_listeners()

    def trigger(self, event, *args) -> None:
        self.emit(event, *args)

    # -- internals ------------------------------------------------------
    def _parse_manifest(self) -> None:
        if self.destroyed:
            return
        manifest = self._manifest
        self._levels = [Level(i, spec, manifest.live)
                        for i, spec in enumerate(manifest.levels)]
        frags = manifest.levels[0].fragments
        if manifest.live and frags:
            # start behind the live edge by the sync target
            # (the forced default liveSyncDuration=30 s is usually
            # clamped by the window — wrapper-private.js:87-89)
            start_t = max(frags[0].start,
                          frags[-1].start + frags[-1].duration
                          - self._live_sync_s())
            self.next_sn = self._sn_for_time_in(frags, start_t)
            if self.media is not None:
                self.media.current_time = start_t
            self.buffer_end = start_t
            self._live_start_t = start_t
        else:
            self.next_sn = frags[0].sn if frags else None
        self.emit(Events.MANIFEST_PARSED,
                  {"levels": self._levels, "live": manifest.live})
        for i in range(len(self._levels)):
            self.emit(Events.LEVEL_LOADED, {"level": i})
        self._ensure_ticking()

    def _ensure_ticking(self) -> None:
        if self._tick_timer is None and not self.destroyed:
            self._tick_timer = self.clock.call_later(TICK_MS, self._tick)

    def _tick(self) -> None:
        self._tick_timer = None
        if self.destroyed:
            return
        self._advance_playback(TICK_MS)
        self._maybe_fetch()
        self._tick_timer = self.clock.call_later(TICK_MS, self._tick)

    def _advance_playback(self, dt_ms: float) -> None:
        if self.media is None or self.media.paused or self._levels is None:
            return
        dt_s = dt_ms / 1000.0
        position = self.media.current_time
        available = self.buffer_end - position
        if available <= 0 and not self.ended:
            self.rebuffer_ms += dt_ms
            self._note_stall(dt_ms)
            return
        advance = min(dt_s, max(available, 0.0))
        self.media.current_time = position + advance
        self.play_ms += advance * 1000.0
        # a partial advance whose accrual rounds to exactly 0.0 ms
        # (advance/dt_s == 1.0 to the float while advance < dt_s) is
        # a full tick to every clock consumer: opening the stall
        # anyway would emit a zero-delta twin.stall_ms event the
        # registry totals cannot reflect, breaking the twin gate's
        # event==registry exactness (stats.note_fetch_bytes skips
        # zero deltas for the same reason)
        stalled_ms = (dt_ms * (1.0 - advance / dt_s)
                      if advance < dt_s and not self.ended else 0.0)
        if stalled_ms > 0.0:
            self.rebuffer_ms += stalled_ms
            self._note_stall(stalled_ms)
        elif self.stalled:
            self.stalled = False
            if self.on_stall_edge is not None:
                self.on_stall_edge(False)

    def _note_stall(self, dt_ms: float) -> None:
        """One rebuffer accrual: open the stall on the first accruing
        tick, then report the exact ms the stall clock advanced."""
        if not self.stalled:
            self.stalled = True
            if self.on_stall_edge is not None:
                self.on_stall_edge(True)
        if self.on_stall_accrue is not None:
            self.on_stall_accrue(dt_ms)

    def _frags(self, level_index: int):
        return self._levels[level_index].details.fragments

    def _sn_for_time(self, t: float) -> Optional[int]:
        return self._sn_for_time_in(self._frags(self.current_level), t)

    @staticmethod
    def _sn_for_time_in(frags, t: float) -> Optional[int]:
        for frag in frags:
            if frag.start + frag.duration > t:
                return frag.sn
        return None

    def _live_sync_s(self) -> float:
        sync = self.config.get("live_sync_duration")
        if sync is None:
            count = self.config.get("live_sync_duration_count") or 3
            seg = self._frags(0)[0].duration if self._frags(0) else 4.0
            sync = count * seg
        return float(sync)

    @property
    def is_live(self) -> bool:
        return bool(self._manifest is not None and self._manifest.live)

    def _frag_by_sn(self, level_index: int, sn: int):
        for frag in self._frags(level_index):
            if frag.sn == sn:
                return frag
        return None

    def _maybe_fetch(self) -> None:
        if (self._levels is None or self._loading or self.ended
                or self.media is None):
            return
        if self.next_sn is None:
            # a live seek to/past the edge lands on no fragment yet;
            # resync once the window catches up — a VOD player here is
            # simply past the end
            frags = self._frags(self.current_level)
            if self.is_live and frags:
                self._resync_to_live_edge(frags)
            if self.next_sn is None:
                if not self.is_live:
                    # VOD seek past the end: nothing will ever be
                    # fetchable again — without this, the playhead
                    # sits at an empty buffer accruing rebuffer time
                    # forever
                    self.ended = True
                return
        if self.buffer_length >= self.config["max_buffer_length"]:
            return

        next_level = self.abr.next_level(self._levels)
        if next_level != self.current_level or not self._level_announced:
            self._level_announced = True
            self.current_level = next_level
            self.emit(Events.LEVEL_SWITCH, {"level": next_level})

        frag = self._frag_by_sn(self.current_level, self.next_sn)
        if frag is None:
            if self.is_live:
                frags = self._frags(self.current_level)
                if frags and self.next_sn < frags[0].sn:
                    # fell out of the sliding window: resync behind
                    # the live edge, like a real player's liveSync jump
                    self._resync_to_live_edge(frags)
                return  # at the live edge: wait for new segments
            self.ended = True
            return

        loader_cls = self.config.get("f_loader") or self.config.get("loader")
        if loader_cls is None:
            raise RuntimeError("SimPlayer has no fragment loader configured")

        self._loading = True
        self._loader = loader_cls(self.config)
        self.emit(Events.FRAG_LOADING, {"frag": frag})
        self.abr.on_frag_loading({"frag": frag})
        level = self._levels[self.current_level]
        self._loader.load(
            frag.url_for(level.url_id), "arraybuffer",
            lambda event, stats, f=frag: self._on_frag_loaded(f, event, stats),
            lambda event, f=frag: self._on_frag_error(f, event),
            lambda event, stats, f=frag: self._on_frag_timeout(f, event),
            self.config["frag_load_timeout"],
            self.config["frag_load_max_retry"],
            self.config["frag_load_retry_delay"],
            on_progress=lambda event, stats: None,
            frag=frag)

    def _on_frag_loaded(self, frag, event, stats) -> None:
        if self.destroyed:
            return
        self._loading = False
        self._loader = None
        self._redundant_rotations = 0  # this stream is healthy again
        payload = event["current_target"]["response"]
        stats["tbuffered"] = self.clock.now()
        stats["length"] = len(payload) if payload is not None else stats.get(
            "loaded", 0)
        self.abr.on_frag_loaded({"frag": frag, "stats": stats})
        self.frag_last_kbps = compute_frag_last_kbps(stats)
        self.bytes_loaded += stats["length"]
        self.frags_loaded += 1
        self.buffer_end = frag.start + frag.duration
        self.next_sn = frag.sn + 1
        self.emit(Events.FRAG_LOADED, {"frag": frag, "stats": stats})
        self.emit(Events.FRAG_BUFFERED, {"frag": frag, "stats": stats})

    def _on_frag_error(self, frag, event) -> None:
        if self.destroyed:
            return
        self._loading = False
        self._loader = None
        self.last_error = event
        # redundant-stream failover (hls.js behavior the reference's
        # v3.8.0 fix depends on — media-map.js:60-73, CHANGELOG.md:
        # 20-22): rotate the level to its backup URL and refetch the
        # same sn before giving up.  url_id is part of track identity,
        # so the rotation is announced as a track change.
        level = self._levels[frag.level] if self._levels else None
        if (level is not None and len(level.url) > 1
                and self._redundant_rotations < len(level.url) - 1):
            self._redundant_rotations += 1
            level.url_id = (level.url_id + 1) % len(level.url)
            self.emit(Events.ERROR, {"type": "networkError",
                                     "details": "fragLoadError",
                                     "fatal": False, "frag": frag,
                                     "event": event})
            self.emit(Events.LEVEL_SWITCH, {"level": frag.level})
            return  # next tick refetches this sn from the backup
        # DELIBERATE divergence from hls.js, which halts loading on a
        # fatal error until the app intervenes: the sim player keeps
        # refetching (each cycle paced by the loader's full retry
        # ladder), so harness scenarios recover from transient total
        # outages without modeling an app-recovery layer.  The fatal
        # ERROR event below is still emitted for the session's
        # fatal/non-fatal logging parity (wrapper-private.js:228-235).
        self.emit(Events.ERROR, {"type": "networkError",
                                 "details": "fragLoadError", "fatal": True,
                                 "frag": frag, "event": event})

    def _on_frag_timeout(self, frag, event) -> None:
        if self.destroyed:
            return
        self._abort_inflight()
        self.last_error = {"timeout": True}
        self.emit(Events.ERROR, {"type": "networkError",
                                 "details": "fragLoadTimeOut", "fatal": False,
                                 "frag": frag})

    def _resync_to_live_edge(self, frags) -> None:
        start_t = max(frags[0].start,
                      frags[-1].start + frags[-1].duration
                      - self._live_sync_s())
        self.next_sn = self._sn_for_time_in(frags, start_t)
        if self.media is not None:
            self.media.current_time = max(self.media.current_time, start_t)
        self.buffer_end = max(self.buffer_end, start_t)

    def _abort_inflight(self) -> None:
        if self._loader is not None:
            self._loader.abort()
            self._loader = None
        self._loading = False
