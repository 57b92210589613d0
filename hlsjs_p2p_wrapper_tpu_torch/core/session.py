# A copy of the reference's core/session.py
# (hlsjs_p2p_wrapper_tpu/core/session.py): the same names, formats and
# bytes; the imports point at the port's own modules.
"""Session lifecycle core.

Rebuild of ``HlsjsP2PWrapperPrivate``
(lib/hlsjs-p2p-wrapper-private.js:12-242): owns exactly one playback
session (one agent instance) at a time, forces the loader/buffer
config onto the player, and is the composition root wiring
player ⇄ bridges ⇄ agent.
"""

from __future__ import annotations

import logging
from typing import Optional

from .clock import Clock, SystemClock
from .errors import ConfigurationError, SessionError
from .events import Events
from .loader import p2p_loader_generator
from .media_map import MediaMap
from .player_interface import PlayerInterface
from .segment_view import SegmentView
from ..version import get_version

log = logging.getLogger(__name__)


class P2PSessionManager:
    """One wrapper = one session = one agent instance at a time
    (wrapper-private.js:116-117,205-207)."""

    def __init__(self, player_constructor=None, peer_agent_constructor=None,
                 clock: Optional[Clock] = None):
        if peer_agent_constructor is None:
            raise SessionError("Constructor needs DI of a peer-agent class")
        # player class may be absent until needed (wrapper-private.js:23)
        self.player_constructor = player_constructor
        self.peer_agent_constructor = peer_agent_constructor
        self.clock = clock or SystemClock()
        self.peer_agent_module = None
        self.player = None

    # -- player construction ------------------------------------------
    def create_media_engine(self, player_config=None, p2p_config=None):
        """Build the player, then defer session start to
        MANIFEST_LOADING so ``player.url`` is guaranteed set
        (wrapper-private.js:35-43)."""
        player = self.new_media_engine(player_config or {})
        events_enum = self._events_enum()

        def on_manifest_loading(*args) -> None:
            self.start_session(player, player_config, p2p_config, player.url)

        player.on(events_enum.MANIFEST_LOADING, on_manifest_loading)
        return player

    def create_player(self, player_config=None, p2p_config=None):
        """Alias (wrapper-private.js:50)."""
        return self.create_media_engine(player_config, p2p_config)

    def create_sr_module(self, p2p_config, media_engine, events_enum,
                         content_id: Optional[str] = None) -> None:
        """Legacy async path (wrapper-private.js:63-66,
        MIGRATION.md:32-62): app owns player construction; contentId
        folded into p2p_config for tracker compatibility."""
        # fold content_id in without mutating the caller's dict
        p2p_config = {**(p2p_config or {}), "content_id": content_id}
        self.create_peer_agent(p2p_config, media_engine, events_enum, None)

    @property
    def P2PLoader(self):
        """Loader class generated on access (wrapper-private.js:72-74),
        for apps that wire the fragment loader themselves."""
        return p2p_loader_generator(self)

    def get_config(self) -> dict:
        """Forced defaults (wrapper-private.js:80-91).  The fragment
        loader — NOT the generic loader, which would route playlists
        and keys through P2P (the reference's explicit warning,
        :82-86)."""
        return {
            "f_loader": p2p_loader_generator(self),
            "max_buffer_size": 0,
            "max_buffer_length": 30,
            "live_sync_duration": 30,
        }

    def new_media_engine(self, player_config: Optional[dict] = None):
        """Merge forced defaults *under* user config
        (lodash.defaults semantics, wrapper-private.js:145-158)."""
        player_config = dict(player_config or {})
        if self.player_constructor is None:
            raise SessionError(
                "Can not create player instance: dependency was not injected")
        if player_config.get("f_loader") is not None:
            raise ConfigurationError(
                "`f_loader` in player config must not be defined")
        defaults = self.get_config()
        if player_config.get("live_sync_duration_count") is not None:
            # Don't override live_sync_duration if the user steers via
            # live_sync_duration_count (wrapper-private.js:154-156,
            # CHANGELOG 3.9.1)
            del defaults["live_sync_duration"]
        for key, value in defaults.items():
            player_config.setdefault(key, value)
        return self.player_constructor(player_config)

    # -- session lifecycle --------------------------------------------
    def start_session(self, player, player_config, p2p_config, content_url):
        if not isinstance(p2p_config, dict):
            raise ConfigurationError("p2p_config must be a valid config object")
        media_engine = player or self.new_media_engine(player_config or {})
        self.create_peer_agent(p2p_config, media_engine, self._events_enum(),
                               content_url)
        return media_engine

    def stop_session(self) -> None:
        if self.peer_agent_module is None:
            return
        self.peer_agent_module.dispose()
        self.peer_agent_module = None

    def on_dispose(self) -> None:
        self.stop_session()

    def has_session(self) -> bool:
        return self.peer_agent_module is not None

    # -- composition root ---------------------------------------------
    def create_peer_agent(self, p2p_config, player, events_enum,
                          url: Optional[str] = None) -> None:
        """Wire bridges and construct the agent
        (wrapper-private.js:198-226)."""
        self.player = player

        agent_cls = self.peer_agent_constructor
        stream_type = agent_cls.StreamTypes.HLS
        integration_version = "v2"

        if self.has_session():
            raise SessionError("P2P session already started")

        content_url = url or getattr(player, "url", None)
        if not content_url:
            raise SessionError(
                "Player instance must have a valid `url` property or "
                "`content_url` must be passed")

        if events_enum is None:
            raise SessionError("Need a valid player events enumeration")

        player.on(events_enum.ERROR, self.on_media_engine_error)

        player_bridge = PlayerInterface(player, events_enum, self.on_dispose)
        media_map = MediaMap(player)

        self.peer_agent_module = agent_cls(
            player_bridge, content_url, media_map, p2p_config, SegmentView,
            stream_type, integration_version)
        self._set_media_element(player, events_enum)

    def _set_media_element(self, player, events_enum) -> None:
        """Hand the media element over now, or on MEDIA_ATTACHING
        (wrapper-private.js:174-182)."""
        if getattr(player, "media", None) is not None:
            self.peer_agent_module.set_media_element(player.media)
        else:
            player.on(events_enum.MEDIA_ATTACHING,
                      lambda *a: self.peer_agent_module.set_media_element(
                          player.media))

    def on_media_engine_error(self, *args) -> None:
        """Fatal vs non-fatal logging (wrapper-private.js:228-235)."""
        data = args[-1] if args else None
        fatal = bool(data and _get(data, "fatal"))
        kind = _get(data, "type") if data else None
        details = _get(data, "details") if data else None
        if fatal:
            log.error("Player fatal error: %s - %s", kind, details)
        else:
            log.warning("Player non-fatal error: %s - %s", kind, details)

    def _events_enum(self):
        return getattr(self.player_constructor, "Events", Events)

    @staticmethod
    def version() -> str:
        return get_version()


def _get(obj, name, default=None):
    if isinstance(obj, dict):
        return obj.get(name, default)
    return getattr(obj, name, default)
