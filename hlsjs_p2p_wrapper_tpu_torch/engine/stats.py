# A copy of the reference's engine/stats.py
# (hlsjs_p2p_wrapper_tpu/engine/stats.py): the same names, formats and
# bytes; the imports point at the port's own modules.
"""Engine transfer statistics.

The public stats surface the reference exposes from its closed-source
agent: ``{cdn, p2p, upload, peers}`` byte/peer counters
(lib/hlsjs-p2p-wrapper.js:14-18, README.md:230-237).

Since the telemetry round the counters live in the unified host
registry (engine/telemetry.py): bound to a shared
:class:`~.telemetry.MetricsRegistry` (the swarm harness passes one
registry to every agent, labeled per peer) they become exportable
labeled series; unbound they fall back to private instruments, so the
attribute surface (``stats.cdn += n``) and the reference's dict shape
are unchanged either way.
"""

from __future__ import annotations

import itertools
from typing import Optional

from .telemetry import Counter, Digest, Gauge, MetricsRegistry

#: fallback labels for registry-bound stats built without a peer id:
#: two anonymous agents sharing a registry must NOT resolve to the
#: same memoized unlabeled series (their byte totals would silently
#: merge and per-peer completeness checks would misattribute them)
_ANON_IDS = itertools.count()


class AgentStats:
    """Cumulative transfer counters, read-only to consumers.

    ``cdn``/``p2p``/``upload`` are monotonic byte totals (registry
    Counters); ``peers`` is a point-in-time connection count (a
    Gauge).  Attribute assignment keeps working — a setter ASSIGNS
    the counter's stored value under its lock (Counter.set_value) —
    so the agent's existing call sites did not change when the
    storage migrated.  Assignment preserves the replaced plain
    attributes' semantics exactly: the idempotent mirror
    (``stats.upload = mesh.upload_bytes``) converges to the source
    total under any interleaving, ``stats.cdn += delta`` corrections
    may be negative (progress over-reports reconciled at transfer
    completion must adjust the total DOWN), and racing writers can
    at worst lose one update — never double-apply one, which a
    read-then-inc delta would."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 peer_id: Optional[str] = None):
        if registry is not None and not peer_id:
            peer_id = f"anon-{next(_ANON_IDS)}"
        labels = {"peer": peer_id} if peer_id else {}
        if registry is None:
            self._cdn = Counter("agent.cdn_bytes", labels)
            self._p2p = Counter("agent.p2p_bytes", labels)
            self._upload = Counter("agent.upload_bytes", labels)
            self._peers = Gauge("agent.peers", labels)
            self._fetch_bytes = {
                src: Counter("twin.fetch_bytes",
                             {**labels, "src": src})
                for src in ("cdn", "p2p")}
            self._fetches = {
                src: Counter("twin.fetches", {**labels, "src": src})
                for src in ("cdn", "p2p")}
            self._fetch_ms = {
                src: Digest("slo.fetch_ms", {"src": src})
                for src in ("cdn", "p2p")}
        else:
            self._cdn = registry.counter("agent.cdn_bytes", **labels)
            self._p2p = registry.counter("agent.p2p_bytes", **labels)
            self._upload = registry.counter("agent.upload_bytes",
                                            **labels)
            self._peers = registry.gauge("agent.peers", **labels)
            self._fetch_bytes = {
                src: registry.counter("twin.fetch_bytes", src=src,
                                      **labels)
                for src in ("cdn", "p2p")}
            self._fetches = {
                src: registry.counter("twin.fetches", src=src,
                                      **labels)
                for src in ("cdn", "p2p")}
            # the fetch-latency digest is deliberately NOT per-peer:
            # a fleet p99 is one order-independent merge of per-src
            # sketches (engine/digest.py), and per-peer instruments
            # would multiply registry cardinality for a statistic
            # whose whole point is aggregation
            self._fetch_ms = {
                src: registry.digest("slo.fetch_ms", src=src)
                for src in ("cdn", "p2p")}

    @property
    def cdn(self) -> int:
        return self._cdn.value

    @cdn.setter
    def cdn(self, value) -> None:
        self._cdn.set_value(value)

    @property
    def p2p(self) -> int:
        return self._p2p.value

    @p2p.setter
    def p2p(self, value) -> None:
        self._p2p.set_value(value)

    @property
    def upload(self) -> int:
        return self._upload.value

    @upload.setter
    def upload(self, value) -> None:
        self._upload.set_value(value)

    @property
    def peers(self) -> int:
        return self._peers.value

    @peers.setter
    def peers(self, value) -> None:
        self._peers.set(value)

    # -- fetch provenance (the twin observation plane) -----------------
    # The ``cdn``/``p2p`` setters above MIRROR externally-reconciled
    # totals (``set_value``), which deliberately stays invisible to
    # the registry's bump listeners — no event stream could replay an
    # assignment additively (engine/telemetry.py Counter docs).  The
    # twin plane needs the additive view: the agent calls these with
    # the SAME deltas it applies to the totals, so the
    # ``twin.fetch_bytes{peer,src}`` family converges to the exact
    # byte totals AND every delta reaches the flight recorder as one
    # causally-ordered counter event (engine/twinframe.py
    # reconstructs observation frames from nothing else).

    def note_fetch_bytes(self, src: str, n) -> None:
        """One per-fetch byte delta (progress or completion
        reconciliation — may be negative, like the ``cdn`` setter's
        contract); zero deltas are skipped, not emitted."""
        if n:
            self._fetch_bytes[src].inc(n)

    def note_fetch_done(self, src: str) -> None:
        """One COMPLETED fetch on ``src`` — the companion count that
        lets tools/soak.py catch an agent reporting bytes without
        matching fetch events."""
        self._fetches[src].inc()

    def note_fetch_ms(self, src: str, ms: float) -> None:
        """One completed fetch's wall (engine clock ms) into the
        ``slo.fetch_ms{src}`` quantile digest — the fleet tail-
        latency instrument (engine/digest.py; the SLO layer and the
        console read its p50/p95/p99)."""
        self._fetch_ms[src].observe(ms)

    def as_dict(self) -> dict:
        return {"cdn": self.cdn, "p2p": self.p2p, "upload": self.upload,
                "peers": self.peers}

    @property
    def offload_ratio(self) -> float:
        """Fraction of downloaded bytes that came from peers — the
        repo-native north-star metric (BASELINE.json)."""
        total = self.cdn + self.p2p
        return self.p2p / total if total else 0.0

    def __repr__(self) -> str:
        return f"AgentStats({self.as_dict()})"
