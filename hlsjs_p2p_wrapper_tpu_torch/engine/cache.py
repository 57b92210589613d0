# A copy of the reference's engine/cache.py
# (hlsjs_p2p_wrapper_tpu/engine/cache.py): the same names, formats and
# bytes; the imports point at the port's own modules.
"""Segment cache.

The reference's agent keeps delivered segments in a cache so they can
be re-served to peers (the ``upload`` stat in its public surface,
README.md:230-237); the implementation is closed source.  The
rebuild's cache is an LRU over a byte budget, keyed by the canonical
12-byte segment key (segment-view.js:59-61) so cache keys ARE wire
keys — what a peer announces is exactly what it can serve.

Each entry also carries the payload's SHA-256, computed once at
``put`` time: announcements (HAVE/BITFIELD) publish ``(key, size,
digest)`` so downloaders can verify what they receive — the
content-integrity half of the swarm's trust model (the closed
reference agent was that trust boundary; see engine/protocol.py).

Eviction raises an ``on_evict`` callback so the owning agent can
broadcast LOST and keep remote have-maps truthful.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

DEFAULT_MAX_BYTES = 64 * 1024 * 1024  # a few minutes of mid-bitrate video


class SegmentCache:
    """Byte-budgeted LRU of segment payloads + their digests."""

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES,
                 on_evict: Optional[Callable[[bytes], None]] = None):
        if max_bytes <= 0:
            raise ValueError("max_bytes must be positive")
        self.max_bytes = max_bytes
        self.on_evict = on_evict
        # key -> (payload, sha256(payload))
        self._entries: "OrderedDict[bytes, Tuple[bytes, bytes]]" = OrderedDict()
        self.bytes_used = 0
        self.hits = 0
        self.misses = 0

    def put(self, key: bytes, payload: bytes) -> None:
        """Insert/refresh.  A payload larger than the whole budget is
        refused silently — caching it would evict everything for one
        unservable entry."""
        key = bytes(key)
        if len(payload) > self.max_bytes:
            return
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes_used -= len(old[0])
        self._entries[key] = (payload, hashlib.sha256(payload).digest())
        self.bytes_used += len(payload)
        while self.bytes_used > self.max_bytes:
            evicted_key, (evicted, _) = self._entries.popitem(last=False)
            self.bytes_used -= len(evicted)
            if self.on_evict is not None:
                self.on_evict(evicted_key)

    def get(self, key: bytes) -> Optional[bytes]:
        """Fetch + LRU-touch."""
        entry = self._entries.get(bytes(key))
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(bytes(key))
        self.hits += 1
        return entry[0]

    def meta(self, key: bytes) -> Optional[Tuple[int, bytes]]:
        """(size, sha256) of a cached payload — the announcement body.
        No LRU touch: announcing is not demand."""
        entry = self._entries.get(bytes(key))
        if entry is None:
            return None
        return len(entry[0]), entry[1]

    def has(self, key: bytes) -> bool:
        return bytes(key) in self._entries

    def keys(self) -> List[bytes]:
        """All cached keys, oldest first."""
        return list(self._entries)

    def entries(self) -> List[Tuple[bytes, int, bytes]]:
        """All ``(key, size, digest)`` triples, oldest first (the
        BITFIELD announce body)."""
        return [(key, len(payload), digest)
                for key, (payload, digest) in self._entries.items()]

    def remove(self, key: bytes) -> None:
        entry = self._entries.pop(bytes(key), None)
        if entry is not None:
            self.bytes_used -= len(entry[0])

    def clear(self) -> None:
        self._entries.clear()
        self.bytes_used = 0

    def __len__(self) -> int:
        return len(self._entries)
