# A copy of the reference's engine/mesh.py
# (hlsjs_p2p_wrapper_tpu/engine/mesh.py): the same names, formats and bytes;
# the imports point at the port's own modules, and a few comments no longer
# cite the reference's history.
"""Peer mesh: per-neighbor protocol state over one transport endpoint.

The reference's mesh lives in the closed-source agent; what is
observable is its effect — segments arrive from peers, the ``upload``
and ``peers`` stats move (README.md:230-237), and availability is
addressed by the 12-byte segment key (segment-view.js:59-61).  This
module implements that half from scratch:

- handshake (HELLO + full BITFIELD), truthful incremental HAVE/LOST,
  with HELLO re-sent on later tracker rounds if the first one was
  lost (a lossy fabric must not leave a pair permanently strangers)
- chunked segment transfer with strictly sequential reassembly —
  chunks must arrive in offset order with no gaps or overlaps (both
  fabrics are FIFO per link), so a completed download is covered
  end-to-end, never hole-filled
- content integrity: announcements carry ``(size, sha256)``; the
  downloader records them at request time and verifies the
  reassembled payload, dropping any peer whose bytes don't match
  what it announced (content-poisoning defense)
- upload serving straight out of the cache, gated by the public
  ``p2p_upload_on`` toggle; the ``upload`` stat counts only frames
  the transport accepted
- per-download timeout; deny/disconnect/timeout all fail the download
  without tearing down the link
"""

from __future__ import annotations

import hashlib
import itertools
from typing import Callable, Dict, Optional, Tuple

from ..core.clock import Clock
from . import protocol as P
from .cache import SegmentCache
from .telemetry import MetricsRegistry
from .transport import Endpoint

CHUNK_PAYLOAD_BYTES = 16 * 1024
DEFAULT_REQUEST_TIMEOUT_MS = 8_000.0
#: if a HELLO went unanswered this long, the next tracker round
#: re-sends it (frame loss must not be permanent)
HANDSHAKE_RETRY_MS = 5_000.0
#: reap a half-open PeerState (HELLO sent, never answered) after this
#: long: a peer that departed or crashed BEFORE completing the
#: handshake never sends BYE — to anyone who only ever dialed it —
#: so without a reap its entry lives forever (the tracker re-lists
#: live peers, and connect_to recreates the state, so reaping an
#: actually-alive-but-slow peer costs one extra HELLO round)
HANDSHAKE_REAP_MS = 4 * HANDSHAKE_RETRY_MS
#: reap a handshaked neighbor not heard from in this long (no HAVE,
#: no requests, nothing) with no transfer in flight either way —
#: the crashed-without-BYE case on a real fabric.  Generous: quiet
#: VOD neighbors get re-handshaked via the tracker on the next
#: announce round if reaped, so the only cost of a false positive is
#: one HELLO/BITFIELD exchange.
PEER_IDLE_REAP_MS = 300_000.0
#: per-neighbor bound on announced segment keys.  A truthful peer's
#: announcements are bounded by its own cache budget (64 MiB at
#: typical segment sizes is a few hundred keys); a hostile one can
#: stream HAVE frames (or one huge BITFIELD — the 64 MiB frame cap
#: alone admits ~1.4M entries) to grow our per-peer state without
#: limit.  At the cap, the OLDEST announcement is evicted: fresh
#: segments are the useful ones, and anything this stale is likely
#: evicted remotely anyway.  Generous (~50× a truthful cache).
MAX_REMOTE_HAVE = 8_192
#: how long a peer that served bytes contradicting its own
#: announcement stays banned.  Finite, so one corrupted transfer
#: (bit-rot, not malice) doesn't permanently shrink a small swarm.
DEFAULT_BAN_MS = 600_000.0
#: serve pacing (the WebRTC ``bufferedAmount`` model): stop pushing
#: chunks once this much traffic is queued on the shaped uplink, and
#: re-pump on this cadence.  Pacing is what makes CANCEL effective —
#: a burst-everything serve pre-commits a whole segment of uplink
#: that an aborting downloader can never reclaim, and under
#: contention that waste storm collapses the swarm to CDN.
PACE_BACKLOG_MS = 200.0
PACE_RETRY_MS = 50.0
#: concurrent serves one requesting peer may hold open (foreground +
#: prefetches + slack); excess requests are denied BUSY
MAX_SERVES_PER_PEER = 4
#: concurrent serves across ALL requesters (admission control): an
#: uplink split N ways makes every transfer N× slower, and past the
#: requesters' timeouts each serve becomes pure waste — the
#: timeout-retry congestion collapse measured in the swarm harness
#: (~7× more bytes uploaded than delivered at tight uplinks, offload
#: 0.22).  Refusing early (BUSY) costs one RTT and redirects the
#: requester to an idler holder or the CDN; serving 2 at a time keeps
#: the uplink saturated with transfers that actually finish (same
#: scenario: offload 0.65, waste 1.6×).  Tune per deployment via
#: ``max_total_serves``.
MAX_TOTAL_SERVES = 2
#: give up on an upload that can't make progress (partitioned peer)
UPLOAD_TTL_MS = 30_000.0
#: how long a holder that denied (BUSY) or timed out on us is
#: deprioritized in holder selection (the "adaptive" policy's
#: feedback window).  Long enough to cover a typical transfer on the
#: loaded holder (so we route around it while it drains), short
#: enough that a momentary burst doesn't exile a good holder.
HOLDER_PENALTY_MS = 3_000.0


class _Download:
    """One in-flight inbound transfer."""

    __slots__ = ("request_id", "key", "peer_id", "buf", "total", "received",
                 "on_success", "on_error", "on_progress", "timer",
                 "expected_size", "expected_digest")

    def __init__(self, request_id, key, peer_id, on_success, on_error,
                 on_progress, timer, expected_size=None, expected_digest=None):
        self.request_id = request_id
        self.key = key
        self.peer_id = peer_id
        self.buf: Optional[bytearray] = None
        self.total: Optional[int] = None
        self.received = 0
        self.on_success = on_success
        self.on_error = on_error
        self.on_progress = on_progress
        self.timer = timer
        # what the serving peer ANNOUNCED for this key — the payload
        # must match or the peer is dropped as misbehaving
        self.expected_size: Optional[int] = expected_size
        self.expected_digest: Optional[bytes] = expected_digest


class _Upload:
    """One paced outbound serve."""

    __slots__ = ("src_id", "request_id", "payload", "offset", "timer",
                 "deadline_ms", "reported")

    def __init__(self, src_id, request_id, payload, deadline_ms):
        self.src_id = src_id
        self.request_id = request_id
        self.payload = payload
        self.offset = 0
        self.timer = None
        self.deadline_ms = deadline_ms
        #: bytes already counted into the twin provenance family —
        #: flushed once per serve EXIT (complete / cancel / expiry),
        #: not per pump: one 16 KiB-chunked serve would otherwise be
        #: dozens of armed events (measured 5% event-plane overhead
        #: at gate size; aggregated, the rider sits under the 3% bar)
        self.reported = 0


class DownloadHandle:
    """Abort handle for an inbound transfer."""

    def __init__(self, mesh: "PeerMesh", request_id: int):
        self._mesh = mesh
        self._request_id = request_id

    def abort(self) -> None:
        self._mesh._cancel_download(self._request_id)


class PeerState:
    """What we know about one neighbor."""

    __slots__ = ("peer_id", "have", "hello_sent", "hello_at",
                 "hello_first_at", "handshaked", "last_seen_ms")

    def __init__(self, peer_id: str):
        self.peer_id = peer_id
        # key -> (announced size, announced sha256)
        self.have: Dict[bytes, Tuple[int, bytes]] = {}
        self.hello_sent = False
        self.hello_at = 0.0       # last HELLO (retries refresh this)
        #: clock of the FIRST HELLO of the current half-open
        #: cycle (None = no cycle open); retries must not refresh
        self.hello_first_at: Optional[float] = None
        self.handshaked = False
        self.last_seen_ms = 0.0   # clock of the last frame they sent


class PeerMesh:
    """All neighbor links of one agent, sharing one endpoint.

    The owner wires ``endpoint.on_receive`` to :meth:`handle_frame`
    (after giving tracker traffic first refusal) and provides the
    cache to serve uploads from.
    """

    def __init__(self, endpoint: Endpoint, swarm_id: str, clock: Clock,
                 cache: SegmentCache, *,
                 request_timeout_ms: float = DEFAULT_REQUEST_TIMEOUT_MS,
                 is_upload_on: Callable[[], bool] = lambda: True,
                 chunk_bytes: int = CHUNK_PAYLOAD_BYTES,
                 ban_ms: float = DEFAULT_BAN_MS,
                 holder_selection: str = "spread",
                 max_total_serves: int = MAX_TOTAL_SERVES,
                 registry: Optional[MetricsRegistry] = None):
        if holder_selection not in ("adaptive", "spread", "ranked"):
            raise ValueError(f"unknown holder_selection "
                             f"{holder_selection!r}")
        self.holder_selection = holder_selection
        # unified telemetry (engine/telemetry.py): membership
        # lifecycle events — reaps by kind, poisoning bans, adaptive
        # congestion penalties — as counters the soak/harness export
        metrics = registry if registry is not None else MetricsRegistry()
        self.metrics = metrics
        self._m_reap_half_open = metrics.counter("mesh.reaps",
                                                 kind="half_open")
        self._m_reap_idle = metrics.counter("mesh.reaps", kind="idle")
        self._m_bans = metrics.counter("mesh.bans")
        self._m_penalties = metrics.counter("mesh.penalties")
        # twin provenance (engine/twinframe.py): the additive event
        # view of ``upload_bytes`` — flushed once per serve exit with
        # the accepted-byte total (see _Upload.reported), so it
        # converges to ``upload_bytes`` whenever no serve is mid-
        # flight (tools/soak.py checks exactly that at quiesce)
        self._m_twin_upload = metrics.counter(
            "twin.upload_bytes", peer=endpoint.peer_id)
        self.max_total_serves = max_total_serves
        self.endpoint = endpoint
        self.swarm_id = swarm_id
        self.clock = clock
        self.cache = cache
        self.request_timeout_ms = request_timeout_ms
        self.is_upload_on = is_upload_on
        self.chunk_bytes = chunk_bytes
        self.ban_ms = ban_ms
        self.peers: Dict[str, PeerState] = {}
        # peer id -> penalty expiry (ms): holders that recently said
        # BUSY or timed out on us are deprioritized by the "adaptive"
        # selection until the window passes (congestion feedback)
        self._holder_penalty: Dict[str, float] = {}
        # peer id -> ban expiry (ms); the tracker keeps re-listing a
        # punished peer every round, so dropping without remembering
        # would re-trust the poisoner seconds later
        self._banned: Dict[str, float] = {}
        # (requester id, request id) -> in-flight paced serve
        self._uploads: Dict[tuple, _Upload] = {}
        self.upload_bytes = 0
        # per-edge transfer attribution (the reference demo pages'
        # p2pGraph edge weights, example/bundle/index.html:13-14):
        # cumulative payload bytes pulled from / served to each peer.
        # Size-bounded via _bump_edge — churning neighbors over a
        # long live session must not grow these for the mesh lifetime
        self.downloaded_from: Dict[str, int] = {}
        self.uploaded_to: Dict[str, int] = {}
        self._downloads: Dict[int, _Download] = {}
        self._request_ids = itertools.count(1)
        self.closed = False
        # availability hook: fires when a neighbor announces segments
        # (the prefetcher's trigger); None = nobody cares
        self.on_remote_have: Optional[Callable[[str], None]] = None

    # -- membership ----------------------------------------------------
    def connect_to(self, peer_id: str) -> None:
        """Initiate a handshake (idempotent while one is pending; an
        unanswered HELLO is retried after :data:`HANDSHAKE_RETRY_MS`
        so one lost frame can't leave the pair strangers forever —
        the tracker keeps re-listing the peer either way)."""
        if self.closed or peer_id == self.endpoint.peer_id \
                or self._is_banned(peer_id):
            return
        state = self.peers.setdefault(peer_id, PeerState(peer_id))
        if state.handshaked:
            return
        now = self.clock.now()
        if state.hello_sent and now - state.hello_at < HANDSHAKE_RETRY_MS:
            return
        state.hello_sent = True
        state.hello_at = now
        if state.hello_first_at is None:
            state.hello_first_at = now  # retries must NOT refresh this
        self._send(peer_id, P.Hello(self.swarm_id, self.endpoint.peer_id))
        self._send(peer_id, P.Bitfield(tuple(self.cache.entries())))

    def on_tracker_peers(self, peer_ids) -> None:
        self._reap_stale_peers(self.clock.now())
        for peer_id in peer_ids:
            self.connect_to(peer_id)

    def _reap_stale_peers(self, now: float) -> None:
        """Bounded-state sweep, run at announce cadence: drop
        half-open handshakes nobody ever answered
        (:data:`HANDSHAKE_REAP_MS`) and handshaked neighbors silent
        past :data:`PEER_IDLE_REAP_MS` with nothing in flight either
        way.  Departure-by-crash never sends BYE, so without this the
        peers map grows with every churned neighbor for the life of
        the session (tests/test_swarm.py
        test_churn_soak_mesh_state_stays_bounded)."""
        # expired bans otherwise only clear when that exact id is
        # queried again — churned-and-banned ids would accumulate
        for peer_id in [p for p, exp in self._banned.items()
                        if now >= exp]:
            del self._banned[peer_id]
        stale = []
        for peer_id, state in self.peers.items():
            if not state.handshaked:
                # measured from the FIRST unanswered HELLO of this
                # cycle: retries refresh hello_at, and a peer the
                # tracker keeps listing (alive but unreachable to us,
                # e.g. one-way reachability) would otherwise never
                # age past the reap bound
                if (state.hello_first_at is not None
                        and now - state.hello_first_at
                        >= HANDSHAKE_REAP_MS):
                    # Bye here too: under one-way loss the remote may
                    # be fully handshaked with us (our HELLO arrived,
                    # its replies did not) and would otherwise keep
                    # selecting us as a holder, burning a request
                    # timeout per attempt until ITS idle reap — which
                    # our per-announce retries keep pushing out
                    self._send(peer_id, P.Bye())
                    stale.append(peer_id)
                    self._m_reap_half_open.inc()
                continue
            last = max(state.last_seen_ms, state.hello_at)
            if now - last < PEER_IDLE_REAP_MS:
                continue
            busy = (any(k[0] == peer_id for k in self._uploads)
                    or any(d.peer_id == peer_id
                           for d in self._downloads.values()))
            if not busy:
                # tell them: otherwise the pair is asymmetrically
                # handshaked and their next request to us burns a
                # full request timeout before failover (close() has
                # the same symmetry via its Bye broadcast)
                self._send(peer_id, P.Bye())
                stale.append(peer_id)
                self._m_reap_idle.inc()
        for peer_id in stale:
            self.drop_peer(peer_id)

    def drop_peer(self, peer_id: str) -> None:
        """Forget a neighbor; fail its in-flight downloads and stop
        serving it.  The penalty entry goes with the peer — a departed
        neighbor's unexpired window is dead state (found by the
        100-round churn soak: penalties referencing departed peers
        linger up to HOLDER_PENALTY_MS after every reap)."""
        self.peers.pop(peer_id, None)
        self._holder_penalty.pop(peer_id, None)
        for request_id in [r for r, d in self._downloads.items()
                           if d.peer_id == peer_id]:
            self._fail_download(request_id, {"status": 0})
        for key in [k for k in self._uploads if k[0] == peer_id]:
            self._drop_upload(key)

    # -- availability --------------------------------------------------
    #: edge-attribution dicts keep at most this many peers; beyond
    #: it the smallest edges are pruned (all the graph view renders
    #: is the heavy edges anyway)
    MAX_EDGE_ENTRIES = 256

    @staticmethod
    def _bump_edge(edges: Dict[str, int], peer_id: str, n: int) -> None:
        edges[peer_id] = edges.get(peer_id, 0) + n
        # prune LAZILY at 2× cap, never evicting the key just bumped:
        # a new neighbor starts with the smallest byte count, so an
        # eager at-cap prune would evict each new edge's first chunk
        # over and over, leaving fresh edges permanently invisible
        if len(edges) > 2 * PeerMesh.MAX_EDGE_ENTRIES:
            victims = sorted((k for k in edges if k != peer_id),
                             key=lambda k: edges[k])
            for victim in victims[:len(edges)
                                  - PeerMesh.MAX_EDGE_ENTRIES]:
                del edges[victim]

    def holders_of(self, key: bytes) -> list:
        """Handshaked neighbors announcing this segment, least-loaded
        first so concurrent fetches spread across the swarm.

        Load is LOCAL knowledge (my own in-flight requests), so ties
        are the common case — and under the old announce-order
        tie-break every peer in the swarm ordered ties identically,
        herding all requests onto the earliest announcer: its uplink
        became the swarm-wide bottleneck while other holders idled,
        collapsing offload under tight uplinks (found by the device
        sim's contention model, ops/swarm_sim.py holder_selection).
        Three policies:

        - "spread" (the default): least-loaded + rendezvous
          hash over (my id, holder id, key).  A re-measurement of the
          earlier "adaptive" default against the full model (the sim
          now carries both the load key and the penalty window) and
          across heterogeneous-uplink / flash-crowd / slow-majority
          regimes: the feedback never beat spread by the +0.03
          acceptance bar anywhere — the load key already routes
          around busy holders — and in slow-majority swarms the
          penalty window actively HERDS demand onto the few fast
          holders (measured −0.13 offload at the harness level), so
          the simpler policy ships (POLICY_AB_r05.json meta).
        - "adaptive": spread + holders that recently denied BUSY or
          timed out on us sort LAST for :data:`HOLDER_PENALTY_MS`
          (kept for A/B study).
        - "ranked": announce order (the original herding behavior,
          kept for A/B study).
        """
        key = bytes(key)
        holders = [p for p in self.peers.values()
                   if p.handshaked and key in p.have]
        load = {p.peer_id: 0 for p in holders}
        for d in self._downloads.values():
            if d.peer_id in load:
                load[d.peer_id] += 1
        if self.holder_selection in ("adaptive", "spread"):
            me = self.endpoint.peer_id.encode()
            now = self.clock.now()

            def penalized(p):
                if self.holder_selection != "adaptive":
                    return 0
                expiry = self._holder_penalty.get(p.peer_id)
                if expiry is None:
                    return 0
                if now >= expiry:
                    del self._holder_penalty[p.peer_id]
                    return 0
                return 1

            def rendezvous(p):
                return hashlib.sha256(
                    me + b"\x00" + p.peer_id.encode() + b"\x00" + key
                ).digest()

            holders.sort(key=lambda p: (load[p.peer_id], penalized(p),
                                        rendezvous(p)))
        else:
            holders.sort(key=lambda p: load[p.peer_id])
        return [p.peer_id for p in holders]

    def _penalize_holder(self, peer_id: str) -> None:
        """Congestion feedback for the "adaptive" selection: this
        holder just signalled overload (BUSY) or silently failed a
        transfer (timeout) — deprioritize it for a window instead of
        immediately re-electing it by hash.  A no-op under the other
        policies: only "adaptive" ever reads the map, and dead
        bookkeeping on the default path earned the sim twin a review
        finding (ops/swarm_sim.py init_swarm's zero-width field)."""
        if self.holder_selection != "adaptive":
            return
        self._holder_penalty[peer_id] = self.clock.now() + HOLDER_PENALTY_MS
        self._m_penalties.inc()
        if len(self._holder_penalty) > self.MAX_EDGE_ENTRIES:
            now = self.clock.now()
            for pid in [pid for pid, exp in self._holder_penalty.items()
                        if now >= exp]:
                del self._holder_penalty[pid]

    @property
    def connected_count(self) -> int:
        return sum(1 for p in self.peers.values() if p.handshaked)

    def broadcast_have(self, key: bytes) -> None:
        meta = self.cache.meta(key)
        if meta is None:
            return  # evicted since; announcing it would be a lie
        size, digest = meta
        self._broadcast(P.Have(bytes(key), size, digest))

    def broadcast_lost(self, key: bytes) -> None:
        self._broadcast(P.Lost(bytes(key)))

    def _broadcast(self, msg) -> None:
        if self.closed:
            return
        frame = P.encode(msg)
        for state in self.peers.values():
            if state.handshaked:
                self.endpoint.send(state.peer_id, frame)

    # -- downloads (we → peer) -----------------------------------------
    def request(self, peer_id: str, key: bytes, *,
                on_success: Callable[[bytes], None],
                on_error: Callable[[dict], None],
                on_progress: Optional[Callable[[int], None]] = None,
                timeout_ms: Optional[float] = None) -> DownloadHandle:
        """Fetch a segment from a specific neighbor.  Errors are
        HTTP-shaped ``{"status": int}`` like everything the agent
        surfaces (loader-generator.js:103-112): 0 = transport/timeout,
        403 = denied, 404 = peer no longer has it."""
        request_id = next(self._request_ids)
        timer = self.clock.call_later(
            timeout_ms if timeout_ms is not None else self.request_timeout_ms,
            lambda: self._timeout_download(request_id))
        # snapshot what this peer ANNOUNCED for the key; the payload is
        # verified against it (content-poisoning defense)
        state = self.peers.get(peer_id)
        announced = state.have.get(bytes(key)) if state is not None else None
        size, digest = announced if announced is not None else (None, None)
        self._downloads[request_id] = _Download(
            request_id, bytes(key), peer_id, on_success, on_error,
            on_progress, timer, expected_size=size, expected_digest=digest)
        self._send(peer_id, P.Request(request_id, bytes(key)))
        return DownloadHandle(self, request_id)

    def _cancel_download(self, request_id: int) -> None:
        download = self._downloads.pop(request_id, None)
        if download is None:
            return
        download.timer.cancel()
        self._send(download.peer_id, P.Cancel(request_id))

    def _timeout_download(self, request_id: int) -> None:
        """Per-download timeout: the holder silently failed to
        deliver — congestion feedback for adaptive selection, then
        the ordinary transport-shaped failure."""
        download = self._downloads.get(request_id)
        if download is not None:
            self._penalize_holder(download.peer_id)
        self._fail_download(request_id, {"status": 0})

    def _fail_download(self, request_id: int, error: dict) -> None:
        download = self._downloads.pop(request_id, None)
        if download is None:
            return
        download.timer.cancel()
        # tell the server to reclaim its paced serve: a timeout that
        # stays silent leaves it pushing bytes nobody will use
        if not self.closed:
            self._send(download.peer_id, P.Cancel(request_id))
        download.on_error(error)

    # -- frame handling ------------------------------------------------
    def handle_frame(self, src_id: str, msg) -> None:
        """Dispatch one decoded peer message."""
        if self.closed or self._is_banned(src_id):
            return
        known = self.peers.get(src_id)
        if known is not None:
            known.last_seen_ms = self.clock.now()
        if isinstance(msg, P.Hello):
            if msg.swarm_id != self.swarm_id:
                return  # different content; not our neighbor
            state = self.peers.setdefault(src_id, PeerState(src_id))
            # a HELLO from a peer we ALREADY handshaked is a retry:
            # our earlier reply was lost, so reply again — otherwise
            # one lost reply leaves the pair strangers forever.  The
            # re-reply is rate-limited by the same grace as the
            # initiator's retries: without it, two crossed late
            # replies ignite an infinite HELLO+BITFIELD ping-pong
            # between two healthy, already-handshaked peers.
            now = self.clock.now()
            retried = (state.handshaked
                       and now - state.hello_at >= HANDSHAKE_RETRY_MS)
            state.handshaked = True
            state.hello_first_at = None  # half-open cycle resolved
            if not state.hello_sent or retried:
                state.hello_sent = True
                state.hello_at = now
                self._send(src_id, P.Hello(self.swarm_id, self.endpoint.peer_id))
                self._send(src_id, P.Bitfield(tuple(self.cache.entries())))
            return

        state = known
        if state is None or not (state.handshaked or state.hello_sent):
            return  # never handshaked with this peer; ignore

        if isinstance(msg, P.Bitfield):
            # keep the TAIL on overflow: bitfields are built from
            # cache.entries(), oldest-first, and fresh segments are
            # the ones worth knowing a holder for
            state.have = {key: (size, digest)
                          for key, size, digest
                          in msg.entries[-MAX_REMOTE_HAVE:]}
            if state.have and self.on_remote_have is not None:
                self.on_remote_have(src_id)
        elif isinstance(msg, P.Have):
            # refresh-to-newest on re-announce, then cap FIFO: the
            # oldest announcement goes, never the one just received
            state.have.pop(msg.key, None)
            state.have[msg.key] = (msg.size, msg.digest)
            while len(state.have) > MAX_REMOTE_HAVE:
                state.have.pop(next(iter(state.have)))
            if self.on_remote_have is not None:
                self.on_remote_have(src_id)
        elif isinstance(msg, P.Lost):
            state.have.pop(msg.key, None)
        elif isinstance(msg, P.Request):
            self._serve(src_id, msg)
        elif isinstance(msg, P.Cancel):
            # reclaim the unsent remainder of a paced serve
            self._drop_upload((src_id, msg.request_id))
        elif isinstance(msg, P.Chunk):
            self._on_chunk(src_id, msg)
        elif isinstance(msg, P.Deny):
            self._on_deny(src_id, msg)
        elif isinstance(msg, P.Bye):
            self.drop_peer(src_id)

    # -- uploads (peer → us asks) --------------------------------------
    def _serve(self, src_id: str, msg: P.Request) -> None:
        if not self.is_upload_on():
            self._send(src_id, P.Deny(msg.request_id, P.DenyReason.UPLOAD_OFF))
            return
        payload = self.cache.get(msg.key)
        if payload is None:
            # our LOST may still be in flight to them — stay truthful
            self._send(src_id, P.Deny(msg.request_id, P.DenyReason.NOT_FOUND))
            return
        if len(payload) == 0:
            self._send(src_id, P.Chunk(msg.request_id, 0, 0, b""))
            return
        key = (src_id, msg.request_id)
        self._drop_upload(key)  # a duplicate request restarts cleanly
        # admission control (see MAX_TOTAL_SERVES): refuse work this
        # uplink cannot finish before the requesters' timeouts —
        # BUSY redirects them to idler holders instead of letting
        # every transfer crawl to a timeout and discard.  <= 0 means
        # UNCAPPED (fair-share every inbound transfer) — the same
        # convention the simulator documents (ops/swarm_sim.py
        # SwarmConfig.max_total_serves), so a config carried between
        # the two never silently denies every serve.
        if (self.max_total_serves > 0
                and len(self._uploads) >= self.max_total_serves):
            self._send(src_id, P.Deny(msg.request_id, P.DenyReason.BUSY))
            return
        # bounded serves per requesting peer, on two grounds: (a)
        # abuse — without a cap, one handshaked peer issuing many
        # request_ids pins a payload reference + a repeating pump
        # timer each for up to UPLOAD_TTL_MS, a memory/timer
        # amplification vector (MAX_SERVES_PER_PEER); (b) fairness —
        # one requester must not monopolize the whole admission
        # budget, so a single peer gets at most half of
        # max_total_serves (floor 1; the abuse bound alone when
        # uncapped).  Excess is denied BUSY (which the requester's
        # multi-holder failover handles like any other deny).
        per_peer_cap = (MAX_SERVES_PER_PEER if self.max_total_serves <= 0
                        else min(MAX_SERVES_PER_PEER,
                                 max(1, self.max_total_serves // 2)))
        active_for_peer = sum(1 for (sid, _rid) in self._uploads
                              if sid == src_id)
        if active_for_peer >= per_peer_cap:
            self._send(src_id, P.Deny(msg.request_id, P.DenyReason.BUSY))
            return
        self._uploads[key] = _Upload(src_id, msg.request_id, payload,
                                     self.clock.now() + UPLOAD_TTL_MS)
        self._pump_upload(key)

    def _pump_upload(self, key: tuple) -> None:
        """Send chunks while the uplink backlog stays under the pacing
        threshold, then re-arm.  Pacing keeps most of a serve
        reclaimable: a CANCEL (or peer drop) stops everything not yet
        handed to the transport."""
        upload = self._uploads.get(key)
        if upload is None or self.closed:
            return
        upload.timer = None
        if self.clock.now() >= upload.deadline_ms:
            self._flush_upload_provenance(upload)
            del self._uploads[key]  # peer unreachable; stop retrying
            return
        total = len(upload.payload)
        # per-destination where the fabric distinguishes links (TCP:
        # one stalled peer must not head-of-line-block other serves);
        # the loopback fabric ignores the argument (one shared uplink)
        backlog_fn = getattr(self.endpoint, "backlog_ms", None)
        backlog = ((lambda: backlog_fn(upload.src_id))
                   if backlog_fn is not None else (lambda: 0.0))
        while upload.offset < total and backlog() < PACE_BACKLOG_MS:
            piece = upload.payload[upload.offset:
                                   upload.offset + self.chunk_bytes]
            if not self._send(upload.src_id,
                              P.Chunk(upload.request_id, upload.offset,
                                      total, piece)):
                break  # transport refused: retry this SAME chunk later
            # count only what the transport accepted — `upload` is a
            # conservation metric, not an intent metric; offset only
            # advances on acceptance, so the receiver never sees a gap
            self.upload_bytes += len(piece)
            self._bump_edge(self.uploaded_to, upload.src_id, len(piece))
            upload.offset += len(piece)
        if upload.offset >= total:
            self._flush_upload_provenance(upload)
            del self._uploads[key]
            return
        upload.timer = self.clock.call_later(
            PACE_RETRY_MS, lambda: self._pump_upload(key))

    def _flush_upload_provenance(self, upload: _Upload) -> None:
        """Count a serve's accepted-but-unreported bytes into the
        twin provenance family — called on every serve exit path, so
        ``twin.upload_bytes`` equals ``upload_bytes`` whenever no
        serve is in flight."""
        delta = upload.offset - upload.reported
        if delta:
            upload.reported = upload.offset
            self._m_twin_upload.inc(delta)

    def _drop_upload(self, key: tuple) -> None:
        upload = self._uploads.pop(key, None)
        if upload is not None:
            self._flush_upload_provenance(upload)
            if upload.timer is not None:
                upload.timer.cancel()

    def _on_chunk(self, src_id: str, msg: P.Chunk) -> None:
        download = self._downloads.get(msg.request_id)
        if download is None or download.peer_id != src_id:
            return  # cancelled/timed out; stray chunk
        if download.buf is None:
            # the remote-declared total must not drive allocation
            # unbounded (same defense as the BITFIELD count): nothing
            # larger than the cache budget could ever be stored
            if msg.total > self.cache.max_bytes:
                self._fail_download(msg.request_id, {"status": 0})
                return
            # the peer announced a size at request time; a different
            # total is already a lie — don't even allocate
            if (download.expected_size is not None
                    and msg.total != download.expected_size):
                self._punish(src_id, msg.request_id)
                return
            download.total = msg.total
            download.buf = bytearray(msg.total)
        # strictly sequential reassembly: both fabrics are FIFO per
        # link, so honest serves arrive in offset order.  Gaps,
        # overlaps, and duplicates all fail here — a "complete"
        # download can never contain zero-filled holes or
        # double-counted bytes
        if msg.offset != download.received or \
                msg.offset + len(msg.payload) > download.total:
            self._fail_download(msg.request_id, {"status": 0})
            return
        download.buf[msg.offset:msg.offset + len(msg.payload)] = msg.payload
        download.received += len(msg.payload)
        if msg.payload:  # empty serves create no edge on either side
            self._bump_edge(self.downloaded_from, src_id,
                            len(msg.payload))
        if download.on_progress is not None:
            download.on_progress(download.received)
        if download.received >= download.total:
            payload = bytes(download.buf)
            if (download.expected_digest is not None
                    and hashlib.sha256(payload).digest()
                    != download.expected_digest):
                # served bytes don't match what the peer announced:
                # poisoned or corrupt — drop the peer entirely
                self._punish(src_id, msg.request_id)
                return
            del self._downloads[msg.request_id]
            download.timer.cancel()
            download.on_success(payload)

    def _punish(self, src_id: str, request_id: int) -> None:
        """A peer served something it never announced (size or digest
        mismatch): fail the download and cut the peer loose — its
        other announcements can't be trusted either.  The ban is
        remembered (``ban_ms``): the tracker re-lists the peer every
        round, and re-handshaking seconds later would re-trust the
        poisoner at the cost of one wasted download per round."""
        self._fail_download(request_id, {"status": 0})
        self._banned[src_id] = self.clock.now() + self.ban_ms
        self._m_bans.inc()
        self.drop_peer(src_id)

    def _is_banned(self, peer_id: str) -> bool:
        expiry = self._banned.get(peer_id)
        if expiry is None:
            return False
        if self.clock.now() >= expiry:
            del self._banned[peer_id]
            return False
        return True

    def _on_deny(self, src_id: str, msg: P.Deny) -> None:
        download = self._downloads.get(msg.request_id)
        if download is None or download.peer_id != src_id:
            return
        if msg.reason == P.DenyReason.BUSY:
            # transient overload: the peer still HAS the key — keep
            # the holder knowledge so failover can come back later,
            # but route around it while its uplink drains (adaptive)
            self._penalize_holder(src_id)
            self._fail_download(msg.request_id, {"status": 503})
            return
        # a denying peer can't serve this key now — stop asking it
        state = self.peers.get(src_id)
        if state is not None:
            state.have.pop(download.key, None)
        status = 403 if msg.reason == P.DenyReason.UPLOAD_OFF else 404
        self._fail_download(msg.request_id, {"status": status})

    # -- lifecycle -----------------------------------------------------
    def close(self) -> None:
        if self.closed:
            return
        self._broadcast(P.Bye())
        self.closed = True
        for request_id in list(self._downloads):
            self._fail_download(request_id, {"status": 0})
        for key in list(self._uploads):
            self._drop_upload(key)
        self.peers.clear()

    def _send(self, peer_id: str, msg) -> bool:
        return self.endpoint.send(peer_id, P.encode(msg))
