# A copy of the reference's player/manifest.py
# (hlsjs_p2p_wrapper_tpu/player/manifest.py): the same names, formats and
# bytes; the imports point at the port's own modules.
"""HLS manifest model for the simulated media engine.

The reference reads hls.js's parsed playlist state
(``hls.levels[..].details.fragments`` — SURVEY.md §2.9); this module
is the rebuild's equivalent parsed-manifest representation plus
helpers to synthesize multi-bitrate VOD/live timelines for tests,
demos, and the swarm simulator.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Frag:
    """One media segment on a level's timeline."""

    sn: int
    start: float
    duration: float
    url: str
    level: int = 0
    byte_range_start_offset: Optional[int] = None
    byte_range_end_offset: Optional[int] = None
    #: per-redundant-stream URLs, indexed by ``url_id`` (hls.js
    #: redundant/backup streams — media-map.js:60-73).  ``None`` means
    #: the level has a single stream and ``url`` is it.
    urls: Optional[List[str]] = None

    def url_for(self, url_id: int) -> str:
        """This fragment's URL on the given redundant stream."""
        if self.urls and 0 <= url_id < len(self.urls):
            return self.urls[url_id]
        return self.url


@dataclass
class LevelSpec:
    """One quality level: bitrate + primary/redundant playlist URLs +
    fragment timeline."""

    bitrate: int
    urls: List[str]
    fragments: List[Frag] = field(default_factory=list)


@dataclass
class Manifest:
    levels: List[LevelSpec]
    live: bool = False

    @property
    def duration(self) -> float:
        frags = self.levels[0].fragments
        return frags[-1].start + frags[-1].duration if frags else 0.0


def make_vod_manifest(level_bitrates=(300_000, 800_000, 2_000_000),
                      frag_count: int = 60, seg_duration: float = 4.0,
                      base_url: str = "http://cdn.example",
                      first_sn: int = 0, live: bool = False,
                      redundant: bool = False) -> Manifest:
    """Synthesize an aligned multi-bitrate timeline.  Segment payload
    sizes implied by bitrate: ``bitrate * seg_duration / 8`` bytes."""
    levels = []
    for li, bitrate in enumerate(level_bitrates):
        urls = [f"{base_url}/{li}/0/playlist.m3u8"]
        if redundant:
            urls.append(f"{base_url}/{li}/1/playlist.m3u8")
        frags = []
        for i in range(frag_count):
            sn = first_sn + i
            per_stream = ([f"{base_url}/{li}/{u}/seg{sn}.ts"
                           for u in range(len(urls))] if redundant else None)
            frags.append(
                Frag(sn=sn, start=sn * seg_duration, duration=seg_duration,
                     url=(per_stream[0] if per_stream
                          else f"{base_url}/{li}/seg{sn}.ts"),
                     level=li, urls=per_stream))
        levels.append(LevelSpec(bitrate=bitrate, urls=urls, fragments=frags))
    return Manifest(levels=levels, live=live)


def segment_size_bytes(level: LevelSpec, frag: Frag) -> int:
    """Payload size implied by the level bitrate."""
    return max(1, int(level.bitrate * frag.duration / 8))


def make_live_manifest(level_bitrates=(300_000, 800_000, 2_000_000),
                       window_count: int = 6, seg_duration: float = 4.0,
                       base_url: str = "http://cdn.example",
                       first_sn: int = 100) -> Manifest:
    """A live manifest: a sliding window of ``window_count`` segments
    ending at the live edge.  Pair with :class:`LiveFeeder` to make
    the window advance (the reference reads live state from
    ``level.details.live`` — player-interface.js:36-39)."""
    manifest = make_vod_manifest(level_bitrates=level_bitrates,
                                 frag_count=window_count,
                                 seg_duration=seg_duration,
                                 base_url=base_url, first_sn=first_sn,
                                 live=True)
    return manifest


class LiveFeeder:
    """Advances a live manifest's sliding window in (virtual) real
    time: every ``seg_duration`` seconds a new fragment appears at the
    live edge of EVERY level and the oldest slides out.  Fragment
    lists are mutated in place, so players/maps holding references see
    updates — exactly how hls.js level.details refreshes on live
    playlist reloads."""

    def __init__(self, manifest: Manifest, clock):
        if not manifest.live:
            raise ValueError("LiveFeeder needs a live manifest")
        self.manifest = manifest
        self.clock = clock
        frags = manifest.levels[0].fragments
        self.seg_duration = frags[0].duration
        self.window_count = len(frags)
        # URL prefixes derive from the manifest's own fragments, so
        # appended live-edge segments stay on the manifest's CDN host
        self._prefixes = [level.fragments[-1].url.rsplit("/seg", 1)[0]
                          for level in manifest.levels]
        self._timer = None
        self.stopped = False

    def start(self) -> None:
        self._arm()

    def _arm(self) -> None:
        self._timer = self.clock.call_later(self.seg_duration * 1000.0,
                                            self._advance)

    def _advance(self) -> None:
        if self.stopped:
            return
        for li, level in enumerate(self.manifest.levels):
            last = level.fragments[-1]
            sn = last.sn + 1
            level.fragments.append(
                Frag(sn=sn, start=sn * self.seg_duration,
                     duration=self.seg_duration,
                     url=f"{self._prefixes[li]}/seg{sn}.ts", level=li))
            while len(level.fragments) > self.window_count:
                level.fragments.pop(0)
        self._arm()

    def stop(self) -> None:
        self.stopped = True
        if self._timer is not None:
            self._timer.cancel()
