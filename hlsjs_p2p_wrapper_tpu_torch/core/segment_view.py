# A copy of the reference's core/segment_view.py (hlsjs_p2p_wrapper_tpu/core/segment_view.py): the
# same names, formats and bytes; only the imports point at the port's own
# modules.
"""Segment identity value object + wire codec.

The reference's ``SegmentView``
(lib/integration/mapping/segment-view.js:3-68): identity is
``(sequence number, track)``; ``time`` is advisory (excluded from
equality, segment-view.js:33-39).  The 12-byte little-endian
``uint32[level, url_id, sn]`` buffer (segment-view.js:9-17,59-61) is
the swarm protocol's content-addressing wire format and is preserved
bit-for-bit so captures are comparable across implementations.
"""

from __future__ import annotations

import struct
from typing import Any, Mapping, Optional

from .track_view import TrackView

_WIRE = struct.Struct("<3I")  # JS Uint32Array is LE on all shipping platforms
WIRE_SIZE = _WIRE.size  # 12 bytes


class SegmentView:
    """Identity of one media segment: ``(sn, track_view[, time])``."""

    __slots__ = ("sn", "track_view", "time")

    def __init__(self, obj: Optional[Any] = None, *, sn: Optional[int] = None,
                 track_view: Optional[Any] = None, time: Optional[float] = None):
        if obj is not None:
            if isinstance(obj, SegmentView):
                sn, track_view, time = obj.sn, obj.track_view, obj.time
            elif isinstance(obj, Mapping):
                sn = obj.get("sn")
                track_view = obj.get("track_view", obj.get("trackView"))
                time = obj.get("time")
            else:
                sn = getattr(obj, "sn")
                track_view = getattr(obj, "track_view", getattr(obj, "trackView", None))
                time = getattr(obj, "time", None)
        self.sn = int(sn)  # type: ignore[arg-type]
        # Re-wrap like the reference ctor does for JSON round-trips
        # (segment-view.js:22-26)
        self.track_view = TrackView(track_view)
        self.time = time

    # --- wire format -------------------------------------------------
    @classmethod
    def from_bytes(cls, buf: bytes) -> "SegmentView":
        level, url_id, sn = _WIRE.unpack_from(bytes(buf))
        return cls(sn=sn, track_view=TrackView(level=level, url_id=url_id))

    def to_bytes(self) -> bytes:
        return _WIRE.pack(self.track_view.level, self.track_view.url_id, self.sn)

    # reference-parity aliases (segment-view.js:9,59)
    from_array_buffer = from_bytes
    to_array_buffer = to_bytes

    # --- identity ----------------------------------------------------
    def is_equal(self, other: Optional["SegmentView"]) -> bool:
        if other is None:
            return False
        return self.sn == other.sn and self.track_view.is_equal(other.track_view)

    def is_in_track(self, track_view: Optional[TrackView]) -> bool:
        return self.track_view.is_equal(track_view)

    def view_to_string(self) -> str:
        return f"{self.track_view.view_to_string()}S{self.sn}"

    def get_id(self) -> int:
        return self.sn

    def __eq__(self, other: object) -> bool:
        return isinstance(other, SegmentView) and self.is_equal(other)

    def __hash__(self) -> int:
        return hash((self.sn, self.track_view))

    def __repr__(self) -> str:
        return (f"SegmentView(sn={self.sn}, track={self.track_view.view_to_string()}, "
                f"time={self.time})")
