# A copy of the reference's core/player_interface.py
# (hlsjs_p2p_wrapper_tpu/core/player_interface.py): the same names, formats
# and bytes; the imports point at the port's own modules.
"""Control-plane bridge between the P2P engine and the player.

Rebuild of the reference ``PlayerInterface``
(lib/integration/player-interface.js:4-86): the agent uses it to
observe the player (live/VOD, buffer policy, track switches) and to
*steer* it (live buffer margin).  Player internals are touched only
here and in ``MediaMap`` — the version-coupling seam SURVEY.md §7.3(4)
calls out.
"""

from __future__ import annotations

from typing import Callable

from .errors import ConfigurationError, PlayerStateError
from .events import EventEmitter
from .track_view import TrackView


class PlayerInterface(EventEmitter):
    """Adapter the agent calls into; emits ``onTrackChange`` on level
    switches and triggers session disposal on player destruction."""

    TRACK_CHANGE = "onTrackChange"

    def __init__(self, player, events_enum, on_dispose: Callable[[], None]):
        super().__init__()
        self.player = player
        self.on_dispose = on_dispose

        def handle_level_switch(data) -> None:
            # data: {"level": int} (player-interface.js:15-20)
            level_index = data["level"] if isinstance(data, dict) else data.level
            level = self.player.levels[level_index]
            self.emit(self.TRACK_CHANGE, {
                "video": TrackView(level=level_index,
                                   url_id=getattr(level, "url_id", 0) or 0)
            })

        player.on(events_enum.LEVEL_SWITCH, handle_level_switch)
        player.on(events_enum.DESTROYING, lambda *a: self.on_dispose())

    def is_live(self) -> bool:
        """Tri-state contract (player-interface.js:31-43): raises
        before the master playlist, raises before any level playlist,
        else the first parsed level's liveness."""
        levels = self.player.levels
        if levels is None:
            raise PlayerStateError(
                "Called is_live before the master playlist was parsed")
        for level in levels:
            details = getattr(level, "details", None)
            if details is not None:
                return bool(getattr(details, "live", False))
        raise PlayerStateError(
            "Called is_live before any level playlist was parsed")

    def get_buffer_level_max(self) -> float:
        """Buffer policy read: ``live_sync_duration`` wins over
        ``max_buffer_length`` (player-interface.js:45-61)."""
        config = self.player.config
        if config.get("live_sync_duration"):
            param = "live_sync_duration"
            max_buffer_level = config["live_sync_duration"]
        else:
            param = "max_buffer_length"
            max_buffer_level = config["max_buffer_length"]

        if max_buffer_level < 0:
            raise ConfigurationError(
                f"Invalid configuration: {param} must be greater than "
                "p2p_config live_min_buffer_margin")
        return max_buffer_level

    def set_buffer_margin_live(self, buffer_level: float) -> None:
        """Buffer policy *write* — the agent steers the player's buffer
        for live swarm health (player-interface.js:63-66)."""
        self.player.config["max_buffer_size"] = 0
        self.player.config["max_buffer_length"] = buffer_level

    # Gated listener registry: only onTrackChange is exposed; other
    # names are silently tolerated (player-interface.js:68-82)
    def add_event_listener(self, event_name: str, listener: Callable) -> None:
        if event_name == self.TRACK_CHANGE:
            self.on(event_name, listener)

    def remove_event_listener(self, event_name: str, listener: Callable) -> None:
        if event_name == self.TRACK_CHANGE:
            self.remove_listener(event_name, listener)
