# A copy of the reference's core/loader.py
# (hlsjs_p2p_wrapper_tpu/core/loader.py): the same names, formats and bytes;
# the imports point at the port's own modules.
"""P2P fragment loader — the data-plane hot path.

Rebuild of the reference's generated ``P2PLoader``
(lib/integration/p2p-loader-generator.js:11-213), the class installed
as the player's fragment loader (``fLoader``) so every media-segment
request routes through the peer agent with CDN fallback.

Per SURVEY.md §7.3(3), the reference's nulled-fields-and-boolean-guards
design bred a museum of abort/retry races (CHANGELOG.md:76,95-96,
146-147); this rebuild is an **explicit state machine** over an
injectable clock so every interleaving is deterministic under test.

Contract honored (reference line cites inline):
- media-fragment-only guards (loader-generator.js:53-64)
- byte ranges → HTTP Range header, end exclusive (:66-68,142-144)
- capped exponential retry: delay ← min(2·delay, 64000) ms (:105-131)
- retry timer survives the per-attempt reset (:39-50)
- abort-safety: late agent callbacks are swallowed (:87-90,106-110)
- ABR stat shaping for instant P2P bytes (:167-204): back-date
  ``trequest`` by the reported transfer time and fake an RTT of
  ``min(round(sr_time/2), 10)`` ms so the player's bandwidth
  estimator sees real transfer rates instead of ∞.
"""

from __future__ import annotations

import logging
from enum import Enum
from typing import Optional

from .clock import SystemClock
from .errors import LoaderError
from .request_setup import extract_info_from_request_setup
from .segment_view import SegmentView
from .track_view import TrackView

log = logging.getLogger(__name__)

RETRY_DELAY_CEILING_MS = 64_000.0  # loader-generator.js:118
FAKE_RTT_CAP_MS = 10.0  # loader-generator.js:196


class LoaderState(Enum):
    IDLE = "idle"
    LOADING = "loading"
    WAITING_RETRY = "waiting_retry"
    DONE = "done"
    ABORTED = "aborted"


def p2p_loader_generator(wrapper, clock=None):
    """Closure factory returning a ``P2PLoader`` class bound to
    ``wrapper`` (reference: loader-generator.js:11) — the player
    instantiates one loader per fragment and never sees the wrapper.

    ``wrapper`` must expose ``peer_agent_module`` (the §2.10 agent) and
    ``player`` (for ``levels[frag.level].url_id``).  The clock is
    resolved lazily at call time — explicit arg, else the player's
    clock, else the wrapper's, else wall time — because the loader
    class is generated before the player exists and its timestamps MUST
    share the player's timebase (mixing timebases silently corrupts
    every bandwidth estimate downstream).
    """

    def resolve_clock():
        return (clock
                or getattr(getattr(wrapper, "player", None), "clock", None)
                or getattr(wrapper, "clock", None)
                or SystemClock())

    class P2PLoader:
        """Player-facing fragment loader (hls.js Loader interface:
        ``load`` / ``abort`` / ``destroy``)."""

        CLASS_KIND = "p2p-fragment-loader"  # marker for config guards

        def __init__(self, config=None):
            self._clock = resolve_clock()
            self.request_setup = None
            if config:
                self.request_setup = (config.get("request_setup")
                                      if isinstance(config, dict)
                                      else getattr(config, "request_setup", None))
            self.state = LoaderState.IDLE
            self.stats: dict = {}
            self.byte_range: Optional[str] = None
            self.frag = None
            self._agent_request = None
            self._attempt_open = False
            self._request_timer = None
            self._retry_timer = None

        # -- lifecycle -------------------------------------------------
        def destroy(self) -> None:
            self.abort()

        def abort(self) -> None:
            if self._agent_request is not None:
                self.stats["aborted"] = True
                self._agent_request.abort()
            self.state = LoaderState.ABORTED
            self._reset()

        def _reset(self, cancel_retry: bool = True) -> None:
            """Clear per-attempt state.  The retry timer is kept alive
            unless this is a full reset (loader-generator.js:39-50 —
            that distinction fixed real races)."""
            if self._request_timer is not None:
                self._request_timer.cancel()
                self._request_timer = None
            if cancel_retry and self._retry_timer is not None:
                self._retry_timer.cancel()
                self._retry_timer = None
            self._agent_request = None
            self._attempt_open = False

        # -- entry point (player calls this) ---------------------------
        def load(self, url, response_type, on_success, on_error, on_timeout,
                 timeout, max_retry, retry_delay, on_progress=None, frag=None):
            if on_progress is None:
                raise LoaderError(
                    "P2P loader expects a progress callback for ABR stats "
                    "(use only as the fragment loader in config)")
            if frag is None:
                raise LoaderError(
                    "P2P loader can only be used for media fragments "
                    "(use only as the fragment loader in config)")
            if getattr(wrapper, "peer_agent_module", None) is None:
                # Means a frag loaded before the manifest, or a broken
                # dispose sequence (loader-generator.js:61-64)
                raise LoaderError("Peer agent is not existing yet")

            start = _attr(frag, "byte_range_start_offset")
            end = _attr(frag, "byte_range_end_offset")
            if start is not None and end is not None:
                self.byte_range = f"{start}-{end}"

            self.frag = frag
            self.url = url
            self.response_type = response_type
            self.on_success = on_success
            self.on_progress = on_progress
            self.on_timeout = on_timeout
            self.on_error = on_error
            self.stats = {"trequest": self._clock.now(), "retry": 0,
                          "aborted": False}
            self.timeout = timeout
            self.max_retry = max_retry
            self.retry_delay = retry_delay

            self._load_internal()

        # -- one attempt -----------------------------------------------
        def _load_internal(self) -> None:
            if self._agent_request is not None:
                raise LoaderError(
                    "P2P loader was not reset correctly, internal state "
                    "indicates unfinalized request")
            self.state = LoaderState.LOADING
            self._retry_timer = None

            headers, with_credentials = extract_info_from_request_setup(
                self.request_setup, self.url)

            if self.byte_range:
                start = _attr(self.frag, "byte_range_start_offset")
                end = _attr(self.frag, "byte_range_end_offset")
                # Range end is inclusive on the wire → end-1
                # (loader-generator.js:142-144)
                headers["Range"] = f"bytes={start}-{end - 1}"

            frag_level = _attr(self.frag, "level") or 0
            level = wrapper.player.levels[frag_level]
            track_view = TrackView(level=frag_level,
                                   url_id=getattr(level, "url_id", 0) or 0)
            segment_view = SegmentView(sn=_attr(self.frag, "sn"),
                                       track_view=track_view,
                                       time=_attr(self.frag, "start"))

            req_info = {"url": self.url, "headers": headers,
                        "with_credentials": with_credentials}
            callbacks = {"on_success": self._load_success,
                         "on_error": self._load_error,
                         "on_progress": self._load_progress}

            self.stats["tfirst"] = None
            self.stats["loaded"] = 0
            self._request_timer = self._clock.call_later(
                self.timeout, self._load_timeout)
            # The agent may fire callbacks before get_segment returns
            # (sync cache hit, instant failure from a threaded
            # transport): only keep the handle if this attempt is still
            # open, or a dead handle would poison the next retry's
            # unfinalized-request invariant.
            self._attempt_open = True
            handle = wrapper.peer_agent_module.get_segment(
                req_info, callbacks, segment_view)
            if self._attempt_open:
                self._agent_request = handle

        # -- agent callbacks -------------------------------------------
        def _load_success(self, segment_data) -> None:
            if self.stats.get("aborted"):
                return  # late callback after abort — swallow
            event = {"current_target": {"response": segment_data}}
            self.stats["tload"] = self._clock.now()
            self.state = LoaderState.DONE
            self.on_success(event, self.stats)
            self._reset()

        def _load_error(self, http_error) -> None:
            """Errors from the agent are always XHR/HTTP-shaped because
            it ultimately fails through to the CDN
            (loader-generator.js:103-112)."""
            if self.stats.get("aborted"):
                return
            status = _attr(http_error, "status")

            if self.stats["retry"] < self.max_retry:
                log.warning("%s while loading %s, retrying in %s ms",
                            status, self.url, self.retry_delay)
                self.state = LoaderState.WAITING_RETRY
                self._retry_timer = self._clock.call_later(
                    self.retry_delay, self._load_internal)
                self.retry_delay = min(2 * self.retry_delay,
                                       RETRY_DELAY_CEILING_MS)
                self.stats["retry"] += 1
                self._reset(cancel_retry=False)
            else:
                log.error("%s while loading %s", status, self.url)
                self.state = LoaderState.DONE
                self.on_error({"target": {"status": status}})
                self._reset()

        def _load_progress(self, event) -> None:
            loaded = (_attr(event, "cdn_downloaded") or 0) + \
                     (_attr(event, "p2p_downloaded") or 0)
            self.stats["loaded"] = loaded

            if self.stats["tfirst"] is None:
                now = self._clock.now()
                p2p_duration = _attr(event, "p2p_duration") or 0
                cdn_duration = _attr(event, "cdn_duration") or 0
                # Instant P2P bytes (cache/swarm) would otherwise make
                # the ABR estimator compute ~infinite bandwidth; shift
                # trequest back by the engine-reported transfer time and
                # fake a small RTT (loader-generator.js:181-201)
                if (p2p_duration + cdn_duration > 0) and \
                        (_attr(event, "p2p_downloaded") or 0) > 0:
                    sr_time = p2p_duration + cdn_duration
                    self.stats["trequest"] = now - sr_time
                    self.stats["tfirst"] = self.stats["trequest"] + \
                        min(round(sr_time / 2), FAKE_RTT_CAP_MS)
                else:
                    self.stats["tfirst"] = now

            self.on_progress(event, self.stats)

        def _load_timeout(self) -> None:
            self.on_timeout(None, self.stats)

    return P2PLoader


def _attr(obj, name, default=None):
    """Field access tolerant of dicts and objects."""
    if isinstance(obj, dict):
        return obj.get(name, default)
    return getattr(obj, name, default)
