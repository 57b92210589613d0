# A copy of the reference's testing/fixtures.py
# (hlsjs_p2p_wrapper_tpu/testing/fixtures.py): the same names, formats and
# bytes; the imports point at the port's own modules.
"""Parameterized fake-player fixtures.

The reference's ``HlsMock`` (test/mocks/hls.js:3-59) promoted to
supported tooling: a player stand-in parameterized by
``(level_count, live, defined_level, empty_level)`` generating
fragments ``sn in [25, 200)`` with ``start = sn * 10`` and two playlist
URLs per level (redundant streams).
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import List, Optional

from ..core.events import EventEmitter


def wait_for(predicate, timeout_s=25.0, interval_s=0.02):
    """Poll ``predicate`` on real wall-clock time until True or the
    budget runs out — for tests of the real-socket fabric, which
    cannot ride a VirtualClock.  The budget is generous: the test
    process may be paying JAX compile/GC pauses from earlier tests,
    and a passing run returns at the first True, so only genuine
    failures pay the full wait (one-off full-suite flakes were
    observed at 8 s)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return False

DEFAULT_CONFIG = {
    "max_buffer_size": 60 * 1000 * 1000,
    "max_buffer_length": 30,
    "live_sync_duration": None,
    "live_sync_duration_count": 3,
    "frag_load_timeout": 20000,
    "frag_load_max_retry": 6,
    "frag_load_retry_delay": 1000,
    "request_setup": None,
}


def make_fragments(first_sn: int = 25, last_sn: int = 200,
                   seg_duration: float = 10.0) -> List[SimpleNamespace]:
    """Fragments like the reference mock: start = sn * duration
    (test/mocks/hls.js:12-19)."""
    return [
        SimpleNamespace(sn=sn, start=sn * seg_duration, duration=seg_duration,
                        byte_range_start_offset=None, byte_range_end_offset=None)
        for sn in range(first_sn, last_sn)
    ]


class FakePlayer(EventEmitter):
    """Minimal player fake exposing ``levels`` / ``config`` the way the
    integration layer consumes them."""

    def __init__(self, level_count: int, live: Optional[bool] = None,
                 defined_level: int = 0, empty_level: bool = True):
        super().__init__()
        self.config = dict(DEFAULT_CONFIG)
        self.url = "http://foo.bar/master.m3u8"
        self.media = None
        self._levels: Optional[List[SimpleNamespace]] = None

        if level_count > 0:
            self._levels = []

        fragments = make_fragments()
        for i in range(level_count):
            url = [
                f"http://foo.bar/{i}/0/playlist.m3u8",
                f"http://foo.bar/{i}/1/playlist.m3u8",
            ]
            if empty_level:
                level = SimpleNamespace(url=url, details=None, url_id=0)
            else:
                level = SimpleNamespace(
                    url=url, url_id=0,
                    details=SimpleNamespace(totalduration=120, live=False,
                                            fragments=fragments),
                    audio_codec="fooCodec")
            if live is not None and i == defined_level:
                level.details = SimpleNamespace(live=live, fragments=fragments)
            self._levels.append(level)

    @property
    def levels(self):
        return self._levels

    def trigger(self, event, *args) -> None:
        self.emit(event, *args)
