# A copy of the reference's testing/mock_cdn.py
# (hlsjs_p2p_wrapper_tpu/testing/mock_cdn.py): the same names, formats and
# bytes; the imports point at the port's own modules.
"""Deterministic shaped CDN fake.

The reference shapes real XHRs with ``xhr-shaper``
(``XMLHttpRequest.Shaper.maxBandwidth`` — test/html/tests.js:5-9,
test/html/p2p-loader-generator.js:37) to test ABR under throttling.
The rebuild's analogue is a VirtualClock-driven origin: configurable
latency, bandwidth, per-URL payloads/status codes, chunked progress.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, Optional, Union

from ..core.clock import VirtualClock
from ..engine.cdn import slice_for_range


def synthetic_payload(url: str, size: int) -> bytes:
    """Deterministic pseudo-random payload derived from the URL."""
    out = bytearray()
    seed = url.encode()
    counter = 0
    while len(out) < size:
        out.extend(hashlib.sha256(seed + counter.to_bytes(4, "little")).digest())
        counter += 1
    return bytes(out[:size])


class _MockFetch:
    def __init__(self):
        self.timers = []
        self.aborted = False

    def abort(self) -> None:
        self.aborted = True
        for t in self.timers:
            t.cancel()


class MockCdnTransport:
    """Virtual-clock origin server.

    - ``bandwidth_bps``: shaping in bits/s (None = infinite; the
      xhr-shaper ``maxBandwidth`` analogue, settable mid-test)
    - ``latency_ms``: time to first byte
    - ``responses``: url → bytes payload, int status (error), or
      callable(url, headers) → (status, payload)
    - ``default_size``: payload size when a URL has no entry
    """

    CHUNK_MS = 100.0  # progress-reporting cadence while shaped

    def __init__(self, clock: VirtualClock, *, latency_ms: float = 20.0,
                 bandwidth_bps: Optional[float] = None,
                 default_size: int = 128_000):
        self.clock = clock
        self.latency_ms = latency_ms
        self.bandwidth_bps = bandwidth_bps
        self.default_size = default_size
        self.responses: Dict[str, Union[bytes, int, Callable]] = {}
        self.resolver: Optional[Callable] = None  # fallback for unknown URLs
        self.fetch_count = 0
        self.bytes_served = 0

    def _resolve(self, url: str, headers) -> tuple:
        entry = self.responses.get(url)
        if entry is None and self.resolver is not None:
            return self.resolver(url, headers)
        if callable(entry):
            return entry(url, headers)
        if isinstance(entry, int):
            return entry, b""
        if isinstance(entry, (bytes, bytearray)):
            return 200, bytes(entry)
        return 200, synthetic_payload(url, self.default_size)

    def fetch(self, req_info: Dict, callbacks: Dict[str, Callable]) -> _MockFetch:
        handle = _MockFetch()
        self.fetch_count += 1
        url = req_info["url"]
        headers = req_info.get("headers") or {}
        status, payload = self._resolve(url, headers)
        if status in (200, 206):
            payload = slice_for_range(payload, headers)

        def start() -> None:
            if handle.aborted:
                return
            if status not in (200, 206):
                callbacks["on_error"]({"status": status})
                return
            self._stream(handle, payload, callbacks)

        handle.timers.append(self.clock.call_later(self.latency_ms, start))
        return handle

    def _stream(self, handle: _MockFetch, payload: bytes,
                callbacks: Dict[str, Callable]) -> None:
        total = len(payload)
        if not self.bandwidth_bps:
            callbacks["on_progress"]({"cdn_downloaded": total})
            callbacks["on_success"](payload)
            self.bytes_served += total
            return

        bytes_per_ms = self.bandwidth_bps / 8000.0
        state = {"sent": 0}

        def tick() -> None:
            if handle.aborted:
                return
            state["sent"] = min(total,
                                state["sent"] + bytes_per_ms * self.CHUNK_MS)
            sent = int(state["sent"])
            callbacks["on_progress"]({"cdn_downloaded": sent})
            if sent >= total:
                self.bytes_served += total
                callbacks["on_success"](payload)
            else:
                handle.timers.append(self.clock.call_later(self.CHUNK_MS, tick))

        handle.timers.append(self.clock.call_later(self.CHUNK_MS, tick))


def serve_manifest(cdn: MockCdnTransport, manifest) -> None:
    """Serve every fragment URL of a manifest from the mock CDN with
    bitrate-implied payload sizes, synthesized lazily on first fetch
    (a 3-level x 60-frag manifest would otherwise precompute ~90 MB
    up front).  Live manifests resolve by URL pattern so fragments
    that appear at the live edge later are served too."""
    from ..player.manifest import segment_size_bytes

    if manifest.live:
        # bounded by what the origin would actually have: segments
        # from the first window ever published up to the current live
        # edge, on the manifest's own URLs (a slid-out segment still
        # serves, as real origins briefly do)
        prefixes = [level.fragments[-1].url.rsplit("/seg", 1)[0]
                    for level in manifest.levels]
        first_sn_ever = manifest.levels[0].fragments[0].sn

        def resolve(url, headers):
            for li, level in enumerate(manifest.levels):
                prefix = f"{prefixes[li]}/seg"
                if url.startswith(prefix) and url.endswith(".ts"):
                    try:
                        sn = int(url[len(prefix):-3])
                    except ValueError:
                        return 404, b""
                    frags = level.fragments
                    if first_sn_ever <= sn <= frags[-1].sn:
                        frag = next((f for f in frags if f.sn == sn),
                                    frags[0])
                        return 200, synthetic_payload(
                            url, segment_size_bytes(level, frag))
                    return 404, b""
            return 404, b""
    else:
        sizes = {}
        for level in manifest.levels:
            for frag in level.fragments:
                sizes[frag.url] = segment_size_bytes(level, frag)
                for backup_url in frag.urls or ():
                    # redundant streams: every url_id's copy is served
                    sizes[backup_url] = segment_size_bytes(level, frag)

        def resolve(url, headers):
            if url in sizes:
                return 200, synthetic_payload(url, sizes[url])
            return 404, b""

    cdn.resolver = resolve
