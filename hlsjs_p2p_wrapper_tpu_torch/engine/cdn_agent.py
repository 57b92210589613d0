# A copy of the reference's engine/cdn_agent.py
# (hlsjs_p2p_wrapper_tpu/engine/cdn_agent.py): the same names, formats and
# bytes; the imports point at the port's own modules.
"""CDN-only delivery agent.

The reference tests its whole integration against a fake agent that
fetches everything over plain XHR (test/mocks/peer-agent.js:3-44);
SURVEY.md §7.2 M1 promotes that to a first-class engine: a complete
implementation of the §2.10 agent contract with no swarm — every
segment comes from the origin.  It is the base the full P2P agent
builds on (same contract, same stats, same lifecycle) and a useful
production fallback when WebRTC is unavailable.
"""

from __future__ import annotations

from typing import Callable, Dict

from ..core.clock import Clock, SystemClock
from .cdn import CdnTransport, HttpCdnTransport
from .stats import AgentStats


class StreamTypes:
    """Stream-type enum passed at agent construction
    (reference: lib/hlsjs-p2p-wrapper-private.js:202)."""

    HLS = "hls"
    DASH = "dash"


class _AgentRequest:
    """Abortable handle returned by :meth:`get_segment`
    (reference contract: loader-generator.js:164,31-37)."""

    def __init__(self, inner_abort: Callable[[], None]):
        self._inner_abort = inner_abort
        self.aborted = False

    def abort(self) -> None:
        self.aborted = True
        self._inner_abort()


class CdnOnlyAgent:
    """§2.10 contract implementation with origin-only delivery.

    Constructor signature mirrors the reference composition root
    (lib/hlsjs-p2p-wrapper-private.js:224):
    ``(player_bridge, content_url, media_map, p2p_config,
    segment_view_class, stream_type, integration_version)``.

    ``p2p_config`` extras understood by the rebuild:
      - ``cdn_transport``: a :class:`CdnTransport` (default real HTTP)
      - ``clock``: a :class:`Clock` (default wall time)
      - ``metrics_registry`` / ``peer_id``: bind the stats to a
        shared telemetry registry as a per-peer labeled series, same
        as the full agent — a CDN-only fallback peer must not vanish
        from a harness export (the soak checks per-peer series
        against the swarm-level gauges)
    """

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

        self.clock: Clock = self.p2p_config.get("clock") or SystemClock()
        self.cdn_transport: CdnTransport = (
            self.p2p_config.get("cdn_transport") or HttpCdnTransport())

        self._stats = AgentStats(self.p2p_config.get("metrics_registry"),
                                 peer_id=self.p2p_config.get("peer_id"))
        self.media_element = None
        self.disposed = False

        # toggles are part of the public surface
        # (lib/hlsjs-p2p-wrapper.js:20-36); download toggle is
        # meaningless without a swarm but kept for contract parity
        self.p2p_download_on = True
        self.p2p_upload_on = True

    # -- data plane ----------------------------------------------------
    def get_segment(self, req_info: Dict, callbacks: Dict[str, Callable],
                    segment_view) -> _AgentRequest:
        if self.disposed:
            raise RuntimeError("get_segment called on disposed agent")
        t_start = self.clock.now()
        state = {"last_reported": 0}

        def on_progress(event: Dict) -> None:
            downloaded = event.get("cdn_downloaded", 0)
            delta = downloaded - state["last_reported"]
            self._stats.cdn += delta
            # twin provenance: same delta, additive view (stats.py)
            self._stats.note_fetch_bytes("cdn", delta)
            state["last_reported"] = downloaded
            callbacks["on_progress"]({
                "cdn_downloaded": downloaded,
                "p2p_downloaded": 0,
                "cdn_duration": self.clock.now() - t_start,
                "p2p_duration": 0,
            })

        def on_success(data: bytes) -> None:
            # account for bytes the transport didn't report as progress
            delta = len(data) - state["last_reported"]
            self._stats.cdn += delta
            self._stats.note_fetch_bytes("cdn", delta)
            self._stats.note_fetch_done("cdn")
            self._stats.note_fetch_ms("cdn",
                                      self.clock.now() - t_start)
            state["last_reported"] = len(data)
            callbacks["on_success"](data)

        handle = self.cdn_transport.fetch(
            req_info, {"on_progress": on_progress, "on_success": on_success,
                       "on_error": callbacks["on_error"]})
        return _AgentRequest(handle.abort)

    # -- control plane -------------------------------------------------
    def set_media_element(self, media) -> None:
        """Media handoff (reference: wrapper-private.js:174-182); the
        CDN-only engine has no use for it beyond bookkeeping."""
        self.media_element = media

    def dispose(self) -> None:
        self.disposed = True

    @property
    def stats(self) -> Dict:
        return self._stats.as_dict()
