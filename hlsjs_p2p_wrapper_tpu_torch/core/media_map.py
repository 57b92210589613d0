# A copy of the reference's core/media_map.py
# (hlsjs_p2p_wrapper_tpu/core/media_map.py): the same names, formats and
# bytes; the imports point at the port's own modules.
"""Manifest/timeline queries for the swarm.

Rebuild of the reference ``MediaMap``
(lib/integration/mapping/media-map.js:4-90): answers the P2P engine's
discovery questions from the player's parsed playlist state
(``player.levels[..].details.fragments``).  Error contract preserved:
nonexistent level raises, unparsed level returns ``[]`` with a warning
(media-map.js:30-37).
"""

from __future__ import annotations

import logging
from typing import List

from .errors import MappingError
from .segment_view import SegmentView
from .track_view import TrackView

log = logging.getLogger(__name__)


class MediaMap:
    """Timeline window queries over a player's ``levels`` state."""

    def __init__(self, player):
        self.player = player

    def get_segment_time(self, segment_view: SegmentView) -> float:
        """Segment start time in seconds (media-map.js:14-19)."""
        if segment_view.time is None:
            raise MappingError("get_segment_time: segment_view.time is undefined")
        return segment_view.time

    def get_segment_list(self, track_view: TrackView, begin_time: float,
                         duration: float) -> List[SegmentView]:
        """Segments of ``track_view`` whose start falls inside
        ``[begin_time, begin_time + duration]`` (inclusive on both ends,
        media-map.js:41-51)."""
        levels = self.player.levels
        level = levels[track_view.level] if levels and 0 <= track_view.level < len(levels) else None

        if level is None:
            raise MappingError("get_segment_list: level doesn't exist")

        details = getattr(level, "details", None)
        if details is None:
            log.warning("get_segment_list: level not parsed yet")
            return []

        out: List[SegmentView] = []
        for fragment in details.fragments:
            if begin_time <= fragment.start <= begin_time + duration:
                out.append(SegmentView(sn=fragment.sn, track_view=track_view,
                                       time=fragment.start))
        return out

    def get_track_list(self) -> List[TrackView]:
        """All tracks = levels × their redundant URLs
        (media-map.js:60-73; redundant-stream fix CHANGELOG.md:20-22).
        Empty before the master playlist is parsed."""
        levels = self.player.levels
        if not levels:
            return []
        tracks: List[TrackView] = []
        for i, level in enumerate(levels):
            for j in range(len(level.url)):
                tracks.append(TrackView(level=i, url_id=j))
        return tracks

    def get_segment_duration(self, segment_view: SegmentView) -> float:
        """First fragment's duration — debug-display helper only
        (media-map.js:75-87)."""
        level = self.player.levels[segment_view.track_view.level]
        for fragment in level.details.fragments:
            return fragment.duration
        raise MappingError("All segments should have a duration")
