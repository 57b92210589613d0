# A copy of the reference's core/track_view.py (hlsjs_p2p_wrapper_tpu/core/track_view.py): the
# same names, formats and bytes; only the imports point at the port's own
# modules.
"""Track identity value object.

A track is (quality level index, redundant-URL index) — the reference's
``TrackView`` (lib/integration/mapping/track-view.js:1-31).  Redundant
URL handling exists because HLS masters may list backup streams per
level (reference CHANGELOG.md:20-22, v3.8.0 fix).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional


class TrackView:
    """Identity of one renditions track: ``(level, url_id)``.

    String form ``L{level}U{url_id}`` is part of the swarm's content
    addressing (reference: track-view.js:11-13).
    """

    __slots__ = ("level", "url_id")

    def __init__(self, obj: Optional[Any] = None, *, level: Optional[int] = None,
                 url_id: Optional[int] = None):
        if obj is not None:
            if isinstance(obj, TrackView):
                level, url_id = obj.level, obj.url_id
            elif isinstance(obj, Mapping):
                level = obj.get("level")
                url_id = obj.get("url_id", obj.get("urlId"))
            else:  # duck-typed object with attributes
                level = getattr(obj, "level")
                url_id = getattr(obj, "url_id", getattr(obj, "urlId", None))
        self.level = int(level)  # type: ignore[arg-type]
        self.url_id = int(url_id)  # type: ignore[arg-type]

    def view_to_string(self) -> str:
        return f"L{self.level}U{self.url_id}"

    def is_equal(self, other: Optional["TrackView"]) -> bool:
        """None-tolerant equality (reference: track-view.js:19-24)."""
        if other is None:
            return False
        return other.level == self.level and other.url_id == self.url_id

    @property
    def type(self) -> str:
        """Always ``"video"`` — required by the agent's async loading
        path (reference: track-view.js:26-28, CHANGELOG.md:37)."""
        return "video"

    # Pythonic protocol on top of the reference surface
    def __eq__(self, other: object) -> bool:
        return isinstance(other, TrackView) and self.is_equal(other)

    def __hash__(self) -> int:
        return hash((self.level, self.url_id))

    def __repr__(self) -> str:
        return f"TrackView(level={self.level}, url_id={self.url_id})"
