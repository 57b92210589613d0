# A copy of the reference's core/events.py
# (hlsjs_p2p_wrapper_tpu/core/events.py): the same names, formats and bytes;
# the imports point at the port's own modules.
"""Event plumbing.

The reference rides on hls.js's event bus and Node's ``EventEmitter``
(lib/integration/player-interface.js:1-25).  The rebuild ships its own
minimal emitter plus the player-event enumeration the integration layer
consumes (reference touchpoints: MANIFEST_LOADING at
lib/hlsjs-p2p-wrapper-private.js:38, MEDIA_ATTACHING at :178,
LEVEL_SWITCH / DESTROYING at lib/integration/player-interface.js:15,22,
ERROR at lib/hlsjs-p2p-wrapper-private.js:219).
"""

from __future__ import annotations

from enum import Enum
from typing import Callable, Dict, List


class Events(str, Enum):
    """Player event names (hls.js-compatible surface)."""

    MANIFEST_LOADING = "hlsManifestLoading"
    MANIFEST_PARSED = "hlsManifestParsed"
    LEVEL_LOADED = "hlsLevelLoaded"
    LEVEL_SWITCH = "hlsLevelSwitch"
    FRAG_LOADING = "hlsFragLoading"
    FRAG_LOADED = "hlsFragLoaded"
    FRAG_BUFFERED = "hlsFragBuffered"
    MEDIA_ATTACHING = "hlsMediaAttaching"
    DESTROYING = "hlsDestroying"
    ERROR = "hlsError"


class EventEmitter:
    """Small synchronous event emitter (Node ``events`` analogue)."""

    def __init__(self) -> None:
        self._listeners: Dict[str, List[Callable]] = {}

    def on(self, event, listener: Callable) -> Callable:
        self._listeners.setdefault(_key(event), []).append(listener)
        return listener

    def once(self, event, listener: Callable) -> Callable:
        key = _key(event)

        def wrapper(*args, **kwargs):
            self.off(key, wrapper)
            return listener(*args, **kwargs)

        wrapper.__wrapped__ = listener  # type: ignore[attr-defined]
        return self.on(key, wrapper)

    def off(self, event, listener: Callable) -> None:
        key = _key(event)
        lst = self._listeners.get(key, [])
        for cb in list(lst):
            # equality, not identity: bound methods are re-created per
            # attribute access, so `emitter.off(ev, obj.method)` must work
            if cb == listener or getattr(cb, "__wrapped__", None) == listener:
                lst.remove(cb)

    # Node-style alias used by PlayerInterface (player-interface.js:79)
    remove_listener = off

    def emit(self, event, *args, **kwargs) -> bool:
        lst = list(self._listeners.get(_key(event), []))
        for cb in lst:
            cb(*args, **kwargs)
        return bool(lst)

    def listener_count(self, event) -> int:
        return len(self._listeners.get(_key(event), []))

    def remove_all_listeners(self) -> None:
        self._listeners.clear()


def _key(event) -> str:
    return event.value if isinstance(event, Enum) else str(event)
