# A copy of the reference's engine/tracker.py
# (hlsjs_p2p_wrapper_tpu/engine/tracker.py): the same names, formats and
# bytes; the imports point at the port's own modules, and a few comments no
# longer cite the reference's history.
"""Swarm membership tracker — sharded, slab-backed control plane.

The reference's swarm discovery happens through Streamroot's hosted
tracker, reachable only from inside the closed-source agent (SURVEY.md
§2.4 "tracker-based signaling").  The rebuild ships its own: a
:class:`Tracker` service keyed by swarm id (derived from the content
URL — peers watching the same content find each other), spoken to over
the same message transport peers use, plus a :class:`TrackerClient`
that re-announces periodically and notifies the agent of membership
changes.

Membership is leased: an entry expires ``lease_ms`` after its last
announce, so crashed peers age out without an orderly LEAVE.

**Scale.**  The seed store was one dict-of-dicts behind one
implicit lock (the GIL), swept by an O(total members) Python walk —
fine for a harness, not for the million-lease control plane the
ROADMAP's digital-twin loop rendezvouses through.  The store is now a
**sharded slab**:

- **N shards by ``crc32(swarm_id)``** (auto-sized from CPU count,
  pinnable via ``shards=`` or ``TRACKER_SHARDS``), each with its own
  lock, so concurrent transport adapters (``TcpEndpoint.
  deliver_inline`` readers) stop serializing on one table.  A stable
  hash, not ``hash()``: shard placement must not move with
  ``PYTHONHASHSEED``.
- **Slab-backed leases**: per shard, one preallocated numpy float64
  deadline array plus parallel slot→swarm/peer/owner reference lists
  with free-list reuse — a lease costs one swarm-dict entry, 8 bytes
  of deadline, and three list slots, instead of the seed's nested
  dict entries + float boxes + per-membership attribution tuples
  (``bench.py detail.tracker_churn`` tracks bytes/lease).
- **Vectorized lazy expiry**: each shard keeps a min-deadline "wheel
  position"; the throttled global sweep (same ``EXPIRE_SWEEP_MS``
  schedule as the seed, so observable behavior is unchanged) skips
  shards whose earliest deadline has not arrived and scans the rest
  as ONE numpy comparison instead of a Python dict walk.  Announce
  and ``members`` touch only their own shard inline.

Every seed semantic is preserved EXACTLY — per-source quotas with
self-LRU eviction, swarm-create refusal, foreign-owner announce/leave
rejection, lease reclaim when the observed transport id equals the
claimed peer id, forced pre-refusal sweeps at the swarm cap, and the
registry counter families — pinned by the oracle equivalence suite:
the seed store is retained verbatim as ``testing/tracker_oracle.py``
and randomized announce/leave/expire/quota interleavings are replayed
against both stores (tests/test_tracker_oracle.py,
``tools/tracker_gate.py``; the ``elig_oracle`` pattern applied to the
control plane).

Locking discipline (deadlock-free by construction): at most ONE shard
lock is held at a time; the quota ``RLock`` nests inside a shard lock
and never acquires shard locks itself; the tiny sweep-clock lock
nests inside either and acquires nothing.  A quota LRU eviction whose
victim lives on ANOTHER shard is applied after the announcing shard's
lock is released (the victim's attribution is already removed under
the quota lock, so the deferred apply is guarded and idempotent).
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import zlib
from array import array
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from ..core.clock import Clock
from .protocol import (Announce, CtrlLease, CtrlLeaseAck, KnobUpdate,
                       Leave, Peers, ProtocolError, SetKnobs, decode,
                       encode)
from .telemetry import MetricsRegistry
from .transport import Endpoint

log = logging.getLogger(__name__)

TRACKER_PEER_ID = "tracker"
DEFAULT_LEASE_MS = 30_000.0
DEFAULT_ANNOUNCE_INTERVAL_MS = 10_000.0

_INF = float("inf")

#: hard ceiling on auto-sized shard counts — tracker shards are lock
#: domains, not worker threads; past the adapter thread count more
#: shards only fragment the slabs
MAX_AUTO_SHARDS = 32


def swarm_id_for(content_url: str, p2p_config: Optional[dict] = None) -> str:
    """Derive the swarm id peers rendezvous on.  ``content_id`` in the
    p2p config overrides the URL — the reference's legacy
    ``createSRModule(p2pConfig, …, contentId)`` path exists precisely
    to let apps pin swarm identity across CDN hostnames
    (wrapper-private.js:63-66, MIGRATION.md:32-62)."""
    basis = (p2p_config or {}).get("content_id") or content_url
    return hashlib.sha256(str(basis).encode()).hexdigest()[:16]


def default_shards() -> int:
    """Auto-sized shard count: ``TRACKER_SHARDS`` env override, else
    the CPU count capped at :data:`MAX_AUTO_SHARDS`."""
    env = int(os.environ.get("TRACKER_SHARDS", "0"))
    if env > 0:
        return env
    return min(MAX_AUTO_SHARDS, max(1, os.cpu_count() or 1))


class _Shard:
    """One lock domain of the lease store: a slab of lease slots plus
    the swarm tables whose ids hash here.

    Slot ``s`` is live iff ``slot_swarm[s] is not None``; live slots
    carry their deadline in ``deadlines[s]`` (freed slots hold +inf so
    the vectorized sweep never matches them), their identity in
    ``slot_swarm``/``slot_peer`` (references to the same str objects
    the swarm dict keys — no copies), and their quota attribution in
    ``slot_owner`` (guarded by the tracker's quota lock, like every
    other piece of quota state).  ``min_deadline`` is the expiry
    wheel's next-fire position: a LOWER bound on every live deadline
    (stale-low is safe — it costs one no-op scan; stale-high would
    skip real expiries, so it is only raised by a full rescan).

    Deadlines live in a stdlib ``array('d')``, not an ndarray: the
    announce hot path touches ONE element at a time (array setitem is
    a plain C store; ndarray ``__setitem__`` pays the ufunc dispatch
    machinery per call), while the sweep gets its vectorization
    through a zero-copy ``np.frombuffer`` view (:meth:`dl_view`)."""

    __slots__ = ("index", "lock", "swarms", "deadlines", "slot_swarm",
                 "slot_peer", "slot_owner", "free", "hi",
                 "min_deadline", "m_members", "m_sweeps", "m_evictions")

    #: initial slots per shard; the slab doubles as it fills
    INITIAL_SLOTS = 256

    def __init__(self, index: int, registry: MetricsRegistry):
        self.index = index
        self.lock = threading.Lock()
        # swarm id -> peer id -> slot (dict insertion order IS the
        # recency order, exactly like the seed's expiry-value dicts)
        self.swarms: Dict[str, Dict[str, int]] = {}
        self.deadlines = array("d", [_INF]) * self.INITIAL_SLOTS
        self.slot_swarm: list = [None] * self.INITIAL_SLOTS
        self.slot_peer: list = [None] * self.INITIAL_SLOTS
        self.slot_owner: list = [None] * self.INITIAL_SLOTS
        self.free: List[int] = []
        self.hi = 0
        self.min_deadline = _INF
        self.m_members = registry.gauge("tracker.shard_members",
                                        shard=index)
        self.m_sweeps = registry.counter("tracker.shard_sweeps",
                                         shard=index)
        self.m_evictions = registry.counter("tracker.shard_evictions",
                                            shard=index)

    def dl_view(self) -> np.ndarray:
        """Zero-copy ndarray view of the used slab prefix — built per
        use, never cached: ``array.extend`` in :meth:`_grow` may
        reallocate the buffer under a stale view."""
        return np.frombuffer(self.deadlines,
                             dtype=np.float64)[:self.hi]

    def alloc(self, swarm_id: str, peer_id: str, deadline: float) -> int:
        """Claim a slot (free-list first — the int objects in the
        free list are recycled, so a churning shard stops allocating
        even the slot numbers)."""
        if self.free:
            slot = self.free.pop()
        else:
            slot = self.hi
            if slot == len(self.slot_swarm):
                self._grow()
            self.hi += 1
        self.deadlines[slot] = deadline
        self.slot_swarm[slot] = swarm_id
        self.slot_peer[slot] = peer_id
        if deadline < self.min_deadline:
            self.min_deadline = deadline
        self.m_members.inc()
        return slot

    def release(self, slot: int) -> None:
        self.deadlines[slot] = _INF
        self.slot_swarm[slot] = None
        self.slot_peer[slot] = None
        self.slot_owner[slot] = None
        self.free.append(slot)
        self.m_members.dec()

    def _grow(self) -> None:
        cap = len(self.slot_swarm)
        new_cap = max(cap * 2, self.INITIAL_SLOTS)
        pad = new_cap - cap
        # in-place extends: cross-shard readers (the quota evictor
        # resolving a victim gid) index these lists without this
        # shard's lock, and append-only growth keeps every existing
        # index valid under the GIL
        self.deadlines.extend(array("d", [_INF]) * pad)
        self.slot_swarm.extend([None] * pad)
        self.slot_peer.extend([None] * pad)
        self.slot_owner.extend([None] * pad)


class Tracker:
    """Authoritative membership store — sharded core, transport-
    agnostic, safe for concurrent announce/leave/members callers
    (module docstring: locking discipline)."""

    #: bounds on attacker-mintable state — within one lease window an
    #: announce flood could otherwise register unlimited
    #: (swarm, peer) pairs.  At a cap, NEW ids are not registered
    #: (the service stays up and existing members keep refreshing);
    #: slots free as leases expire.  Discovery only needs recency
    #: (max_peers_returned is 30), so the member cap is a discovery
    #: working set, not an audience size.  Both caps are GLOBAL
    #: (enforced across shards — the swarm count sums the shards, and
    #: the at-cap forced sweep walks every shard), so deployments
    #: tune them exactly as before sharding.
    MAX_SWARMS = 1_024
    MAX_MEMBERS_PER_SWARM = 2_048
    #: per-SOURCE quotas (a review's finding #6: the global caps
    #: alone let one paying announcer squat them all).  The source is
    #: the transport-level sender identity the adapter observes —
    #: on the TCP fabric an address-verified ``host:port``, quota-
    #: keyed by HOST so one machine opening many ports stays one
    #: bucket.  A source at its member quota evicts ITS OWN least-
    #: recently-refreshed (swarm, peer) entry — the attacker hurts
    #: only itself, and the global table keeps room for others.  A
    #: source at its swarm-creation quota is refused new swarms
    #: (refusal, not eviction: evicting an attacker-created swarm
    #: would also kick innocent members who since joined it).
    #: Deployment-tunable class attributes; generous for honest
    #: clients (a NAT'd audience shares a host, but honest watchers
    #: hold ONE membership each).
    MAX_SWARM_CREATES_PER_SOURCE = 64
    MAX_MEMBERS_PER_SOURCE = 256
    #: global expiry sweep cadence: sweeping every announce would make
    #: each announce O(total members) — the touched swarm is expired
    #: inline (bounded by the member cap); everything else on this
    #: clock throttle.  The schedule is the seed's; only the sweep
    #: BODY changed (min-deadline shard skip + one vectorized
    #: comparison per dirty shard instead of a Python dict walk).
    EXPIRE_SWEEP_MS = 1_000.0
    #: inline touched-swarm expiry vectorizes past this size; below
    #: it a plain loop beats the numpy round-trip
    VECTOR_EXPIRE_MIN = 64

    def __init__(self, clock: Clock, *, lease_ms: float = DEFAULT_LEASE_MS,
                 max_peers_returned: int = 30,
                 registry: Optional[MetricsRegistry] = None,
                 shards: Optional[int] = None,
                 trace=None):
        self.clock = clock
        self.lease_ms = lease_ms
        self.max_peers_returned = max_peers_returned
        # unified telemetry (engine/telemetry.py): lease decisions are
        # counted here — rejects as a reason-labeled series, plus a
        # discovery-quality histogram of how many co-members each
        # successful announce was answered with
        self.metrics = registry if registry is not None \
            else MetricsRegistry()
        #: optional flight recorder (engine/tracer.py, duck-typed
        #: ``.span()``): global sweeps emit a ``tracker_sweep`` span
        self._trace = trace
        self._m_announces = self.metrics.counter("tracker.announces")
        self._m_reclaims = self.metrics.counter("tracker.lease_reclaims")
        self._m_expiries = self.metrics.counter("tracker.lease_expiries")
        # reject handles pre-created: _reject fires exactly during
        # announce floods, where a per-event registry lookup (label
        # keying + registry lock) on top of the bump lock would be
        # avoidable per-reject overhead
        self._m_rejects = {
            reason: self.metrics.counter("tracker.announce_rejects",
                                         reason=reason)
            for reason in ("swarm_cap", "create_quota",
                           "foreign_owner", "member_cap")}
        self._m_leave_rejects = self.metrics.counter(
            "tracker.leave_rejects")
        self._m_peers_returned = self.metrics.histogram(
            "tracker.peers_returned",
            buckets=(0.0, 1.0, 2.0, 5.0, 10.0, 20.0, 30.0))
        n = shards if shards and shards > 0 else default_shards()
        self._n_shards = n
        self._shards = [_Shard(i, self.metrics) for i in range(n)]
        self.metrics.gauge("tracker.shards").set(n)
        # sweep clocks (seed names kept: tests monkeypatch
        # _expire_swarms and read _last_sweep_ms to count executed
        # sweeps); both guarded by the innermost _sweep_lock
        self._sweep_lock = threading.Lock()
        self._last_sweep_ms = -1e18
        self._last_forced_sweep_ms = -1e18
        # per-source quota state.  Swarm-creation charges stay plain
        # dicts (one entry per live swarm / per source — small);
        # MEMBERSHIP attribution lives in the slab (slot_owner) with
        # per-source LRU buckets keyed by global slot id
        # (slot * n_shards + shard.index), so a lease's quota
        # bookkeeping costs one bucket entry instead of the seed's
        # (swarm, peer) tuple + two dict entries.  A source holding
        # ONE membership stores its gid bare (no dict): at million-
        # lease scale most sources are honest single-membership
        # watchers, and a 232-byte dict each was the store's single
        # largest memory term.  A second membership promotes the
        # bucket to an insertion-ordered dict (the LRU).  All of it
        # behind ONE quota lock (module docstring) — a plain Lock on
        # the announce hot path; the one nested caller
        # (_drop_swarm_q from the eviction path) is factored to run
        # with the lock already held.
        self._quota_lock = threading.Lock()
        self._swarm_creator: Dict[str, str] = {}
        self._creates_by_source: Dict[str, int] = {}
        # source host -> gid | {gid: None} in least-recently-
        # refreshed order (dict insertion order IS the LRU, seed-like)
        self._buckets: Dict[str, Union[int, Dict[int, None]]] = {}
        # live control plane: per-swarm policy-knob state
        # the controller publishes through SET_KNOBS and the adapter
        # piggybacks onto every answered announce.  Deliberately NOT
        # lease-coupled — knobs are operator configuration and must
        # survive a swarm whose members all churned out — but capped
        # like every other attacker-mintable table.
        self._knob_lock = threading.Lock()
        self._knobs: Dict[str, Tuple[int, tuple]] = {}
        self._m_knob_sets = {
            result: self.metrics.counter("tracker.knob_sets",
                                         result=result)
            for result in ("accepted", "stale", "cap", "fenced")}
        # HA controller pair: tracker-arbitrated control
        # lease per swarm.  The WorkLedger claim/steal discipline
        # ported to the control channel — TTL judged entirely on THIS
        # clock (controllers never compare wall clocks), generation
        # strictly advancing on every ownership change so a deposed
        # leader's generation is a permanent fencing floor, and the
        # accepted-knob-epoch history the fleet gate audits for
        # exactly-once actuation.
        self._ctrl_lock = threading.Lock()
        # swarm -> [leader_id, generation, expires_at_ms]
        self._ctrl_leases: Dict[str, list] = {}
        self._knob_gen: Dict[str, int] = {}
        self._knob_history: Dict[str, list] = {}
        self._m_ctrl_leases = {
            result: self.metrics.counter("tracker.ctrl_leases",
                                         result=result)
            for result in ("granted", "renewed", "stolen", "refused",
                           "cap")}

    # -- policy knobs (live control plane) -----------------------------

    #: ceiling on distinct swarms holding knob state — SET_KNOBS
    #: bodies are as unauthenticated as ANNOUNCE's, so the table must
    #: not be mintable without bound
    MAX_KNOB_SWARMS = 1_024
    #: same mintability bound for the controller-lease table
    MAX_CTRL_LEASES = 1_024
    #: accepted-epoch history kept per swarm (the HA gate's
    #: exactly-once audit trail) — bounded like every other table
    KNOB_HISTORY_CAP = 4_096
    #: requested lease TTLs are clamped into this window: a zero TTL
    #: would make every grant instantly stealable and a huge one
    #: would wedge the channel on a dead leader forever
    CTRL_LEASE_TTL_MS = (100.0, 3_600_000.0)

    def ctrl_lease(self, swarm_id: str, controller_id: str,
                   generation: int, ttl_ms: float
                   ) -> Tuple[bool, str, int, float]:
        """Claim or renew the controller lease for one swarm's
        control channel.  Returns ``(granted, leader_id, generation,
        ttl_ms)`` — on refusal the CURRENT holder and its remaining
        TTL, so a standby's refused claim doubles as its
        leader-identity subscription.

        Semantics (the fabric WorkLedger's claim/steal discipline):

        - no lease, or the held lease EXPIRED on this tracker's
          clock → granted, with a generation STRICTLY above every
          generation ever granted for the swarm (the fencing floor
          :meth:`set_knobs` enforces);
        - held unexpired by the same controller presenting its
          granted generation → renewed (TTL extended);
        - anything else — another live holder, or the same id with a
          stale generation (a resurrected deposed leader) → refused.
        """
        lo, hi = self.CTRL_LEASE_TTL_MS
        ttl = min(max(float(ttl_ms), lo), hi)
        now = self.clock.now()
        with self._ctrl_lock:
            entry = self._ctrl_leases.get(swarm_id)
            if entry is None:
                if len(self._ctrl_leases) >= self.MAX_CTRL_LEASES:
                    self._m_ctrl_leases["cap"].inc()
                    return False, "", 0, 0.0
                self._ctrl_leases[swarm_id] = \
                    [controller_id, 1, now + ttl]
                self._m_ctrl_leases["granted"].inc()
                return True, controller_id, 1, ttl
            leader, gen, expires = entry
            if leader == controller_id and generation == gen \
                    and expires > now:
                entry[2] = now + ttl
                self._m_ctrl_leases["renewed"].inc()
                return True, controller_id, gen, ttl
            if expires <= now:
                # steal: the dead (or silent) leader's generation is
                # permanently superseded — its in-flight publishes
                # will be fenced, never applied
                entry[0] = controller_id
                entry[1] = gen + 1
                entry[2] = now + ttl
                self._m_ctrl_leases["stolen"].inc()
                return True, controller_id, gen + 1, ttl
            self._m_ctrl_leases["refused"].inc()
            return False, leader, gen, max(expires - now, 0.0)

    def ctrl_lease_state(self, swarm_id: str
                         ) -> Optional[Tuple[str, int, float]]:
        """The swarm's current ``(leader_id, generation,
        remaining_ttl_ms)`` — remaining TTL may be <= 0 (expired but
        not yet stolen; the generation floor still fences) — or None
        when no controller ever claimed."""
        entry = None
        with self._ctrl_lock:
            if swarm_id in self._ctrl_leases:
                entry = list(self._ctrl_leases[swarm_id])
        if entry is None:
            return None
        return entry[0], entry[1], entry[2] - self.clock.now()

    def set_knobs(self, swarm_id: str, epoch: int, knobs: tuple,
                  generation: int = 0) -> Tuple[bool, int, tuple]:
        """Publish a knob epoch for one swarm.  Accepted only when
        ``epoch`` is STRICTLY greater than the current one — the
        monotonicity that makes controller resume safe (a re-sent
        stale decision is counted and refused, never re-applied) —
        AND, once the swarm's control channel is lease-arbitrated,
        only when ``generation`` is at least the lease's: a deposed
        leader (stale generation — including the pre-HA 0) is FENCED
        (counted ``tracker.knob_sets{result=fenced}``) on this
        tracker's own state, with no wall-clock trust between
        controllers.  Returns ``(accepted, current_epoch,
        current_knobs)`` — the current state either way, which is
        what the adapter answers as the :class:`~.protocol
        .KnobUpdate` ack."""
        with self._ctrl_lock:
            entry = self._ctrl_leases.get(swarm_id)
            lease_gen = entry[1] if entry is not None else None
        with self._knob_lock:
            current = self._knobs.get(swarm_id)
            if lease_gen is not None and generation < lease_gen:
                self._m_knob_sets["fenced"].inc()
                if current is None:
                    return False, 0, ()
                return False, current[0], current[1]
            if current is None and \
                    len(self._knobs) >= self.MAX_KNOB_SWARMS:
                self._m_knob_sets["cap"].inc()
                return False, 0, ()
            if current is not None and epoch <= current[0]:
                self._m_knob_sets["stale"].inc()
                return False, current[0], current[1]
            self._knobs[swarm_id] = (epoch, tuple(knobs))
            self._knob_gen[swarm_id] = generation
            history = self._knob_history.setdefault(swarm_id, [])
            history.append((epoch, generation, self.clock.now()))
            del history[:-self.KNOB_HISTORY_CAP]
            self._m_knob_sets["accepted"].inc()
            return True, epoch, tuple(knobs)

    def knobs_for(self, swarm_id: str) -> Optional[Tuple[int, tuple]]:
        """The swarm's current ``(epoch, knobs)``, or None when no
        controller ever published any."""
        with self._knob_lock:
            return self._knobs.get(swarm_id)

    def knob_generation(self, swarm_id: str) -> int:
        """The lease generation that last wrote the swarm's knobs
        (0 when never written, or written by a pre-HA publisher)."""
        with self._knob_lock:
            return self._knob_gen.get(swarm_id, 0)

    def knob_history(self, swarm_id: str) -> list:
        """Every ACCEPTED knob publish for the swarm, oldest first,
        as ``(epoch, generation, t_ms)`` — the HA fleet gate's
        exactly-once audit trail (epochs are strictly monotone by
        construction; the history proves nothing was applied
        twice)."""
        with self._knob_lock:
            return list(self._knob_history.get(swarm_id, ()))

    # -- sharding ------------------------------------------------------

    def _shard_for(self, swarm_id: str) -> _Shard:
        """Stable shard placement: crc32, not ``hash()`` — placement
        must not move with PYTHONHASHSEED (per-shard series would
        flake across runs)."""
        return self._shards[zlib.crc32(swarm_id.encode("utf-8"))
                            % self._n_shards]

    def _swarm_count(self) -> int:
        """Live (unswept) swarms across shards.  Lock-free dict lens:
        each is GIL-atomic, and the cap check that consumes this re-
        checks after the forced sweep exactly like the seed did."""
        return sum(len(shard.swarms) for shard in self._shards)

    @staticmethod
    def _source_key(source: Optional[str]) -> Optional[str]:
        """Quota bucket for a transport-level sender identity: the
        HOST of a ``host:port`` id (one machine, many ports = one
        bucket), the id itself otherwise."""
        if source is None:
            return None
        return source.rsplit(":", 1)[0] if ":" in source else source

    # -- the message surface -------------------------------------------

    def announce(self, swarm_id: str, peer_id: str,
                 source: Optional[str] = None) -> List[str]:
        """Join/refresh; returns current co-members (excluding self),
        most-recently-announced first, capped at
        ``max_peers_returned``.  At the state caps (MAX_SWARMS /
        MAX_MEMBERS_PER_SWARM / the per-``source`` quotas) a NEW
        swarm or member is answered but not registered — refusal to
        remember is not refusal to serve.  ``source`` is the
        transport-level sender identity (the adapter passes it; the
        un-sourced core API applies no per-source quotas)."""
        self._m_announces.inc()
        now = self.clock.now()
        self._expire_swarms(now)
        key = self._source_key(source)
        shard = self._shard_for(swarm_id)
        forced = False
        while True:
            deferred = None
            force_sweep = False
            with shard.lock:
                swarm = shard.swarms.get(swarm_id)
                if swarm is not None:
                    self._expire_swarm_locked(shard, swarm_id, now)
                    swarm = shard.swarms.get(swarm_id)
                if swarm is None:
                    if self._swarm_count() >= self.MAX_SWARMS:
                        # before refusing, sweep past the throttle:
                        # swarms whose leases all expired between
                        # throttled sweeps must not hold slots against
                        # a live newcomer.  At most ONE forced sweep
                        # per EXPIRE_SWEEP_MS window — a refused-
                        # announce flood at the cap must not make
                        # every announce O(total members), the exact
                        # cost the throttle exists to amortize.  The
                        # sweep walks OTHER shards, so it runs after
                        # this shard's lock is dropped (never two
                        # shard locks at once) and the loop re-checks.
                        if not forced:
                            with self._sweep_lock:
                                if (now - self._last_forced_sweep_ms
                                        >= self.EXPIRE_SWEEP_MS):
                                    self._last_forced_sweep_ms = now
                                    self._last_sweep_ms = -1e18
                                    force_sweep = True
                        if not force_sweep:
                            self._reject("swarm_cap", swarm_id,
                                         peer_id, source)
                            return []
                    else:
                        refused = cap_raced = False
                        with self._quota_lock:
                            # EVERY creation inserts under the quota
                            # lock, so the global cap re-check here is
                            # atomic across shards: two concurrent
                            # creators on different shards (inline-
                            # delivery reader threads) serialize on
                            # this lock, and the loser sees the
                            # winner's insert — the cap is a hard
                            # ceiling, not a per-thread snapshot.
                            # (Serial callers re-check the value the
                            # unlocked branch above already proved
                            # under-cap.)
                            if self._swarm_count() >= self.MAX_SWARMS:
                                cap_raced = True
                            elif key is not None and \
                                    self._creates_by_source.get(key, 0) \
                                    >= self.MAX_SWARM_CREATES_PER_SOURCE:
                                # this source's creation quota is spent
                                refused = True
                            else:
                                if key is not None:
                                    self._swarm_creator[swarm_id] = key
                                    self._creates_by_source[key] = \
                                        self._creates_by_source.get(
                                            key, 0) + 1
                                swarm = shard.swarms[swarm_id] = {}
                        if cap_raced:
                            # lost a cross-shard creation race to the
                            # cap: re-run the at-cap branch (forced
                            # sweep or refusal) on the next iteration
                            continue
                        if refused:
                            self._reject("create_quota", swarm_id,
                                         peer_id, source)
                            return []
                if swarm is not None:
                    if key is not None and peer_id in swarm:
                        with self._quota_lock:
                            owner = shard.slot_owner[swarm[peer_id]]
                        if owner is not None and owner != key \
                                and source != peer_id:
                            # a membership another source owns: answer
                            # the peer list but touch NOTHING —
                            # refreshing the lease or recency here
                            # would let an attacker keep a crashed
                            # victim alive at the head of discovery
                            # forever (and at zero quota cost).  The
                            # announce bodies are unauthenticated, so
                            # ownership is the usual signal — EXCEPT
                            # when the announcer's address-verified
                            # transport id IS the claimed peer id
                            # (source == peer_id): that peer self-
                            # evidently owns its own listen address,
                            # so a squatter who announced it first
                            # must not lock the real peer out of its
                            # lease (SECURITY.md: claim-squatting).
                            self._reject("foreign_owner", swarm_id,
                                         peer_id, source)
                            return self._others_locked(swarm, peer_id)
                    slot = swarm.pop(peer_id, None)
                    known = slot is not None
                    registered = known or len(swarm) \
                        < self.MAX_MEMBERS_PER_SWARM
                    if registered:
                        deadline = now + self.lease_ms
                        if known:
                            # refresh raises this slot's deadline;
                            # min_deadline stays a valid lower bound
                            shard.deadlines[slot] = deadline
                        else:
                            slot = shard.alloc(swarm_id, peer_id,
                                               deadline)
                        if key is not None:
                            deferred = self._attribute_member(
                                shard, swarm_id, peer_id, slot, key,
                                reclaim=(source == peer_id))
                        # re-insert to refresh both lease and recency
                        swarm[peer_id] = slot
                    else:
                        self._reject("member_cap", swarm_id, peer_id,
                                     source)
                    answered = self._others_locked(swarm, peer_id)
                    if registered:
                        # discovery quality is defined over SUCCESSFUL
                        # announces (__init__): reject answers (squat
                        # probes, cap floods) must not skew the
                        # distribution a dashboard reads
                        self._m_peers_returned.observe(len(answered))
            if force_sweep:
                forced = True
                self._expire_swarms(now)
                continue
            if deferred is not None:
                self._apply_deferred_eviction(*deferred)
            return answered

    @property
    def announce_count(self) -> int:
        """Total announces handled — derived from the registry
        counter, so the attribute the pre-telemetry API exposed
        cannot drift from the exported series."""
        return self._m_announces.value

    def _others_locked(self, swarm: Dict[str, int],
                       peer_id: str) -> List[str]:
        """Co-members most-recently-announced first, capped — read
        off the recency tail via reversed dict iteration, O(cap)
        instead of the seed's O(members) list build (the response
        path is the announce hot path at scale)."""
        cap = self.max_peers_returned
        if cap <= 0:
            return []
        out: List[str] = []
        for p in reversed(swarm):
            if p == peer_id:
                continue
            out.append(p)
            if len(out) == cap:
                break
        return out

    def _reject(self, reason: str, swarm_id: str, peer_id: str,
                source: Optional[str]) -> None:
        """Count + log an announce the tracker answered but refused to
        register (refusal to remember is not refusal to serve).
        DEBUG level: rejects spike exactly during announce floods, and
        per-event WARNING lines would make logging itself the DoS —
        the labeled counter is the alerting surface."""
        self._m_rejects[reason].inc()
        log.debug("announce rejected (%s): swarm=%s peer=%s source=%s",
                  reason, swarm_id, peer_id, source)

    # -- quota attribution ---------------------------------------------

    def _gid(self, shard: _Shard, slot: int) -> int:
        """Global slot id — the LRU buckets span shards, so bucket
        keys must not collide across slabs."""
        return slot * self._n_shards + shard.index

    def _attribute_member(self, shard: _Shard, swarm_id: str,
                          peer_id: str, slot: int, key: str,
                          reclaim: bool = False):
        """Charge the membership in ``slot`` to source ``key``,
        evicting the source's own least-recently-refreshed membership
        at its quota — one squatter can fill only its own bucket,
        never the global table.  Returns a deferred cross-shard
        eviction ``(shard, swarm, peer, slot)`` for the caller to
        apply after releasing its shard lock, or ``None``."""
        gid = self._gid(shard, slot)
        deferred = None
        with self._quota_lock:
            prior = shard.slot_owner[slot]
            if prior is not None and prior != key:
                if not reclaim:
                    # FIRST attribution wins while the membership
                    # lives: the ANNOUNCE body's peer id is
                    # unauthenticated, so letting a different source
                    # re-charge an existing membership to its own
                    # bucket would let an attacker adopt victims'
                    # memberships and then evict them via its own LRU
                    # — the exact cross-source denial the quotas exist
                    # to stop.  A peer that genuinely moves hosts
                    # re-attributes when its old lease expires.
                    return None
                # reclaim: the announcer's address-verified transport
                # id equals the claimed peer id — stronger evidence of
                # ownership than announce order, so the prior
                # (squatted) attribution is uncharged and the
                # membership moves to its rightful bucket.  WARNING,
                # not debug: a reclaim firing means someone squatted a
                # real peer's id (SECURITY.md claim-squatting) and the
                # rightful owner just took it back — rare, security-
                # relevant, and worth a human's attention
                log.warning(
                    "lease reclaim: peer %s (swarm %s) took its "
                    "membership back from squatting source %s — "
                    "announcer's address-verified transport id equals "
                    "the claimed peer id", peer_id, swarm_id, prior)
                self._m_reclaims.inc()
                self._unattribute_locked(shard, slot)
            bucket = self._buckets.get(key)
            if isinstance(bucket, int):
                contains = bucket == gid
                size = 1
            elif bucket is not None:
                contains = gid in bucket
                size = len(bucket)
            else:
                contains, size = False, 0
            if not contains and size >= self.MAX_MEMBERS_PER_SOURCE:
                vgid = (bucket if isinstance(bucket, int)
                        else next(iter(bucket)))
                vshard = self._shards[vgid % self._n_shards]
                vslot = vgid // self._n_shards
                # an attributed slot is live by invariant (attribution
                # is removed BEFORE a slot is released), so these
                # reads are stable even without vshard's lock
                victim_swarm = vshard.slot_swarm[vslot]
                victim_peer = vshard.slot_peer[vslot]
                self._unattribute_locked(vshard, vslot)
                vshard.m_evictions.inc()
                if vshard is shard:
                    vswarm = shard.swarms.get(victim_swarm)
                    if vswarm is not None:
                        s = vswarm.pop(victim_peer, None)
                        if s is not None:
                            shard.release(s)
                        # never drop the swarm being announced INTO,
                        # even if the victim was its last member — the
                        # caller is about to insert into the dict it
                        # holds a reference to
                        if not vswarm and victim_swarm != swarm_id:
                            self._drop_swarm_q(shard, victim_swarm)
                else:
                    deferred = (vshard, victim_swarm, victim_peer,
                                vslot)
                bucket = self._buckets.get(key)
            # insert/refresh at the LRU tail
            if bucket is None:
                self._buckets[key] = gid
            elif isinstance(bucket, int):
                if bucket != gid:
                    self._buckets[key] = {bucket: None, gid: None}
            else:
                bucket.pop(gid, None)
                bucket[gid] = None
            shard.slot_owner[slot] = key
        return deferred

    def _unattribute_locked(self, shard: _Shard, slot: int) -> None:
        """Remove a slot's quota attribution (quota lock held)."""
        owner = shard.slot_owner[slot]
        if owner is None:
            return
        gid = self._gid(shard, slot)
        bucket = self._buckets.get(owner)
        if isinstance(bucket, int):
            if bucket == gid:
                del self._buckets[owner]
        elif bucket is not None:
            bucket.pop(gid, None)
            if not bucket:
                del self._buckets[owner]
        shard.slot_owner[slot] = None

    def _apply_deferred_eviction(self, vshard: _Shard,
                                 victim_swarm: str, victim_peer: str,
                                 vslot: int) -> None:
        """Apply a quota eviction whose victim lives on another shard
        — after the announcing shard's lock was released (one shard
        lock at a time).  The victim's attribution was already
        removed under the quota lock; this removes the lease itself.
        Guarded and idempotent: if the membership was removed, or
        removed AND re-announced onto a different slot, or
        re-attributed, in the window since the decision, it is no
        longer the victim and nothing is touched.  (The one
        indistinguishable interleave — removed and re-announced
        UN-sourced onto the same recycled slot — loses a lease the
        quota had just ruled evictable; harmless, and unreachable in
        the serial oracle suite.)"""
        with vshard.lock:
            vswarm = vshard.swarms.get(victim_swarm)
            if vswarm is None:
                return
            slot = vswarm.get(victim_peer)
            if slot != vslot:
                return
            with self._quota_lock:
                if vshard.slot_owner[slot] is not None:
                    return  # re-attributed since the decision
                del vswarm[victim_peer]
                vshard.release(slot)
            if not vswarm:
                self._drop_swarm_locked(vshard, victim_swarm)

    def _drop_swarm_locked(self, shard: _Shard, swarm_id: str) -> None:
        """Remove a swarm and every quota attribution hanging off it
        (members AND the creator's creation charge) — quota state
        must never outlive the state it charges for.  Caller holds
        the shard's lock but NOT the quota lock."""
        with self._quota_lock:
            self._drop_swarm_q(shard, swarm_id)

    def _drop_swarm_q(self, shard: _Shard, swarm_id: str) -> None:
        """:meth:`_drop_swarm_locked` body with the quota lock ALREADY
        held — the eviction and sweep paths call this from inside
        their quota critical sections (the lock is not reentrant)."""
        swarm = shard.swarms.pop(swarm_id, None)
        if swarm:
            for slot in list(swarm.values()):
                self._unattribute_locked(shard, slot)
                shard.release(slot)
        self._refund_creator_q(swarm_id)

    def _refund_creator_q(self, swarm_id: str) -> None:
        """Uncharge a dead swarm's creation (quota lock held)."""
        creator = self._swarm_creator.pop(swarm_id, None)
        if creator is not None:
            n = self._creates_by_source.get(creator, 0) - 1
            if n > 0:
                self._creates_by_source[creator] = n
            else:
                self._creates_by_source.pop(creator, None)

    # -- leave / members -----------------------------------------------

    def leave(self, swarm_id: str, peer_id: str,
              source: Optional[str] = None) -> None:
        """Remove a membership.  With a ``source``, only the source
        that OWNS the membership's attribution may remove it — the
        LEAVE body's peer id is as unauthenticated as ANNOUNCE's, and
        without this check any sender could deny any member for free
        (cheaper than the squatting the quotas close).  The un-sourced
        core API (operator use) removes unconditionally."""
        shard = self._shard_for(swarm_id)
        with shard.lock:
            swarm = shard.swarms.get(swarm_id)
            if not swarm or peer_id not in swarm:
                return
            slot = swarm[peer_id]
            if source is not None:
                with self._quota_lock:
                    owner = shard.slot_owner[slot]
                if owner is not None \
                        and owner != self._source_key(source):
                    # not yours to remove — without ownership any
                    # sender could deny any member for free (docstring)
                    self._m_leave_rejects.inc()
                    log.debug("leave rejected: source %s does not own "
                              "membership (%s, %s)", source, swarm_id,
                              peer_id)
                    return
            del swarm[peer_id]
            with self._quota_lock:
                self._unattribute_locked(shard, slot)
                shard.release(slot)
            if not swarm:
                self._drop_swarm_locked(shard, swarm_id)

    def members(self, swarm_id: str) -> List[str]:
        now = self.clock.now()
        self._expire_swarms(now)
        shard = self._shard_for(swarm_id)
        with shard.lock:
            if swarm_id in shard.swarms:
                self._expire_swarm_locked(shard, swarm_id, now)
            return list(shard.swarms.get(swarm_id, ()))

    # -- expiry --------------------------------------------------------

    def _expire_swarm_locked(self, shard: _Shard, swarm_id: str,
                             now: float) -> None:
        """Expire ONE swarm's leases inline (cost bounded by the
        member cap) — the swarm being touched must be current even
        between global sweeps, or a full swarm would refuse newcomers
        while holding dead leases.  Vectorized past
        VECTOR_EXPIRE_MIN members (one gather + compare)."""
        swarm = shard.swarms.get(swarm_id)
        if swarm is None:
            return
        if shard.min_deadline > now:
            # the wheel's announce-path payoff: nothing in the WHOLE
            # shard has expired, so the touched swarm has nothing to
            # expire either — the common announce pays one float
            # compare here instead of a per-member scan
            return
        n = len(swarm)
        if n >= self.VECTOR_EXPIRE_MIN:
            slots = np.fromiter(swarm.values(), dtype=np.int64,
                                count=n)
            mask = shard.dl_view()[slots] <= now
            if mask.any():
                peers = list(swarm)
                expired = [peers[i]
                           for i in np.flatnonzero(mask).tolist()]
            else:
                expired = []
        else:
            dl = shard.deadlines
            expired = [p for p, s in swarm.items() if dl[s] <= now]
        if expired:
            with self._quota_lock:
                for peer_id in expired:
                    slot = swarm.pop(peer_id)
                    self._unattribute_locked(shard, slot)
                    shard.release(slot)
            self._m_expiries.inc(len(expired))
            log.debug("swarm %s: %d lease(s) expired", swarm_id,
                      len(expired))
        if not swarm:
            self._drop_swarm_locked(shard, swarm_id)

    def _sweep_shard_locked(self, shard: _Shard, now: float) -> None:
        """One shard's expiry pass (shard lock held): a single
        vectorized deadline comparison over the slab replaces the
        seed's Python walk; freed slots sit at +inf and never match.
        The unavoidable per-lease dict removals stay, but every
        batchable side effect is batched — one vectorized deadline
        reset, one free-list extend, one gauge bump — so a million-
        lease drain is bounded by the dict pops alone.  Recomputes
        the shard's wheel position (min live deadline)."""
        if shard.min_deadline > now or shard.hi == 0:
            return
        shard.m_sweeps.inc()
        view = shard.dl_view()
        expired = np.flatnonzero(view <= now)
        if expired.size:
            slots = expired.tolist()
            slot_swarm, slot_peer = shard.slot_swarm, shard.slot_peer
            slot_owner = shard.slot_owner
            # group by swarm first: slot order interleaves swarms
            # (cache-hostile at a million leases), and a swarm whose
            # EVERY member expired — the dominant drain/flash-crowd
            # case — can drop its whole dict without per-member dels
            by_swarm: Dict[str, List[int]] = {}
            for slot in slots:
                sid = slot_swarm[slot]
                lst = by_swarm.get(sid)
                if lst is None:
                    by_swarm[sid] = [slot]
                else:
                    lst.append(slot)
            n_shards, index = self._n_shards, shard.index
            with self._quota_lock:
                buckets = self._buckets
                for sw_id, sw_slots in by_swarm.items():
                    swarm = shard.swarms[sw_id]
                    whole = len(sw_slots) == len(swarm)
                    for slot in sw_slots:
                        owner = slot_owner[slot]
                        if owner is not None:
                            # _unattribute_locked, inlined: this loop
                            # runs once per expired lease and the
                            # call + gid-helper overhead is the
                            # drain's measurable tax
                            gid = slot * n_shards + index
                            bucket = buckets.get(owner)
                            if isinstance(bucket, int):
                                if bucket == gid:
                                    del buckets[owner]
                            elif bucket is not None:
                                bucket.pop(gid, None)
                                if not bucket:
                                    del buckets[owner]
                            slot_owner[slot] = None
                        if not whole:
                            del swarm[slot_peer[slot]]
                        slot_swarm[slot] = None
                        slot_peer[slot] = None
                    if whole:
                        del shard.swarms[sw_id]
                        self._refund_creator_q(sw_id)
                view[expired] = _INF
                shard.free.extend(slots)
            shard.m_members.dec(len(slots))
            self._m_expiries.inc(len(slots))
        shard.min_deadline = float(np.min(shard.dl_view(),
                                          initial=_INF))

    def _expire_swarms(self, now: float) -> None:
        """Drop expired leases AND emptied swarms — a long-lived
        tracker must not leak a dict per content ever served.
        Throttled to EXPIRE_SWEEP_MS on the seed's exact schedule;
        the body is the per-shard lazy wheel: shards whose earliest
        deadline has not arrived are skipped without taking their
        lock, the rest pay one vectorized scan.  Never called with a
        shard lock held (it takes them one at a time)."""
        if now - self._last_sweep_ms < self.EXPIRE_SWEEP_MS:
            # unlocked throttle peek — this runs on EVERY announce,
            # so the common not-due case must not pay a lock; the
            # read is GIL-atomic and re-checked under the lock
            return
        with self._sweep_lock:
            if now - self._last_sweep_ms < self.EXPIRE_SWEEP_MS:
                return
            self._last_sweep_ms = now
        if self._trace is not None:
            with self._trace.span("tracker_sweep"):
                self._sweep_all(now)
        else:
            self._sweep_all(now)

    def _sweep_all(self, now: float) -> None:
        for shard in self._shards:
            # unlocked wheel peek: stale-low at worst (a no-op scan),
            # re-checked under the lock
            if shard.min_deadline > now:
                continue
            with shard.lock:
                self._sweep_shard_locked(shard, now)

    # -- introspection (seed-layout views + invariant checks) ----------

    @property
    def _swarms(self) -> Dict[str, Dict[str, float]]:
        """Seed-layout snapshot ``{swarm_id: {peer_id: expiry_ms}}``,
        merged across shards — a read-only debugging/test view (the
        seed exposed its live table under this name; several tests
        and operator habits read it)."""
        out: Dict[str, Dict[str, float]] = {}
        for shard in self._shards:
            with shard.lock:
                for sw_id, swarm in shard.swarms.items():
                    out[sw_id] = {p: float(shard.deadlines[s])
                                  for p, s in swarm.items()}
        return out

    @property
    def _member_source(self) -> Dict[Tuple[str, str], str]:
        """Seed-layout snapshot of membership attribution:
        ``{(swarm_id, peer_id): source_host}``."""
        out: Dict[Tuple[str, str], str] = {}
        for shard in self._shards:
            with shard.lock, self._quota_lock:
                for slot in range(shard.hi):
                    owner = shard.slot_owner[slot]
                    if owner is not None:
                        out[(shard.slot_swarm[slot],
                             shard.slot_peer[slot])] = owner
        return out

    @property
    def _members_by_source(self) -> Dict[str, Dict[Tuple[str, str], None]]:
        """Seed-layout snapshot of the per-source LRU buckets, in
        least-recently-refreshed order."""
        out: Dict[str, Dict[Tuple[str, str], None]] = {}
        with self._quota_lock:
            for owner, bucket in self._buckets.items():
                gids = ((bucket,) if isinstance(bucket, int)
                        else bucket)
                entries: Dict[Tuple[str, str], None] = {}
                for gid in gids:
                    sh = self._shards[gid % self._n_shards]
                    slot = gid // self._n_shards
                    entries[(sh.slot_swarm[slot],
                             sh.slot_peer[slot])] = None
                out[owner] = entries
        return out

    def lease_count(self) -> int:
        """Live leases across shards (the per-shard occupancy gauges,
        summed)."""
        return sum(int(shard.m_members.value)
                   for shard in self._shards)

    def _assert_consistent(self) -> None:
        """Cross-structure invariant check for tests and
        ``tools/tracker_gate.py`` — every slab slot, swarm entry,
        quota bucket, and creation charge must agree.  Raises
        AssertionError on any violation.  For QUIESCENT stores (no
        concurrent mutators — the only honest time to assert global
        invariants); locks are still taken, in the canonical
        shard→quota order, so a stray concurrent caller deadlocks
        nothing and merely risks a spurious assert."""
        seen_gids = set()
        for shard in self._shards:
            with shard.lock, self._quota_lock:
                used = {}
                for sw_id, swarm in shard.swarms.items():
                    assert swarm, f"empty swarm {sw_id} retained"
                    for peer, slot in swarm.items():
                        assert shard.slot_swarm[slot] == sw_id
                        assert shard.slot_peer[slot] == peer
                        assert shard.deadlines[slot] < _INF
                        used[slot] = True
                free = set(shard.free)
                assert not (free & set(used)), "slot both free+used"
                assert len(free) + len(used) == shard.hi, \
                    "slab watermark out of sync"
                for slot in free:
                    assert shard.slot_swarm[slot] is None
                    assert shard.slot_owner[slot] is None
                    assert shard.deadlines[slot] == _INF
                if used:
                    assert shard.min_deadline <= float(
                        np.min(shard.dl_view())), \
                        "wheel position stale-high"
                assert int(shard.m_members.value) == len(used), \
                    "occupancy gauge out of sync"
                for slot in used:
                    owner = shard.slot_owner[slot]
                    if owner is not None:
                        gid = self._gid(shard, slot)
                        bucket = self._buckets.get(owner)
                        in_bucket = (bucket == gid
                                     if isinstance(bucket, int)
                                     else bucket is not None
                                     and gid in bucket)
                        assert in_bucket, \
                            "owned slot missing from its bucket"
                        seen_gids.add(gid)
        with self._quota_lock:
            bucket_gids = {
                gid for bucket in self._buckets.values()
                for gid in ((bucket,) if isinstance(bucket, int)
                            else bucket)}
            assert bucket_gids == seen_gids, \
                "bucket entry for a dead or disowned slot"
            recount: Dict[str, int] = {}
            for creator in self._swarm_creator.values():
                recount[creator] = recount.get(creator, 0) + 1
            assert recount == self._creates_by_source, \
                "creation charges out of sync with creators"
            creators = list(self._swarm_creator)
        for sw in creators:
            # liveness read outside the locks: quiescent-store check
            assert sw in self._shard_for(sw).swarms, \
                "creator charge for a dead swarm"


class TrackerEndpoint:
    """Adapter exposing a :class:`Tracker` as a peer on the message
    transport (peer id ``"tracker"``), speaking ANNOUNCE/LEAVE → PEERS.

    With ``concurrent=True`` on a transport whose endpoints support
    inline delivery (``TcpEndpoint.deliver_inline``), frames are
    handled directly on the transport's reader threads instead of
    being serialized through the dispatch loop — safe because the
    sharded tracker core is thread-safe, and the whole point of
    sharding: concurrent adapters contend per shard, not on one
    table."""

    def __init__(self, tracker: Tracker, endpoint: Endpoint, *,
                 concurrent: bool = False):
        self.tracker = tracker
        self.endpoint = endpoint
        # reject-path visibility: frames that fail to decode are
        # dropped (one malformed peer must not take down the shared
        # service) but COUNTED — the fuzz suite asserts the counter
        self._m_decode_rejects = tracker.metrics.counter(
            "tracker.decode_rejects")
        if concurrent and hasattr(endpoint, "deliver_inline"):
            endpoint.deliver_inline = True
        endpoint.on_receive = self._on_receive

    def _on_receive(self, src_id: str, frame: bytes) -> None:
        try:
            msg = decode(frame)
        except ProtocolError:
            # one malformed peer must not take down the shared service
            self._m_decode_rejects.inc()
            return
        if isinstance(msg, Announce):
            # the transport-level sender identity is the quota source:
            # on the TCP fabric it is address-verified (engine/net.py
            # trust model), so quota buckets cannot be minted by
            # claiming fresh ids in the ANNOUNCE body
            peers = self.tracker.announce(msg.swarm_id, msg.peer_id,
                                          source=src_id)
            self.endpoint.send(src_id,
                               encode(Peers(msg.swarm_id, tuple(peers))))
            # knob piggyback (live control plane): every answered
            # announce of a swarm with published knobs is followed by
            # the current epoch, so re-announce cadence — including
            # the reconnect listener's immediate re-announce on a
            # healed link — IS the knob-convergence path.  Idempotent
            # at the client (applied only when the epoch advances).
            current = self.tracker.knobs_for(msg.swarm_id)
            if current is not None:
                self.endpoint.send(src_id, encode(
                    KnobUpdate(msg.swarm_id, current[0], current[1],
                               self.tracker.knob_generation(
                                   msg.swarm_id))))
        elif isinstance(msg, Leave):
            self.tracker.leave(msg.swarm_id, msg.peer_id, source=src_id)
        elif isinstance(msg, SetKnobs):
            _accepted, epoch, knobs = self.tracker.set_knobs(
                msg.swarm_id, msg.epoch, msg.knobs,
                generation=msg.generation)
            # ack with the CURRENT state either way — a refused stale
            # (or fenced) publish tells the possibly-resumed,
            # possibly-deposed controller where the epoch actually
            # stands and which generation owns it
            self.endpoint.send(src_id, encode(
                KnobUpdate(msg.swarm_id, epoch, knobs,
                           self.tracker.knob_generation(
                               msg.swarm_id))))
        elif isinstance(msg, CtrlLease):
            granted, leader, gen, ttl = self.tracker.ctrl_lease(
                msg.swarm_id, msg.controller_id, msg.generation,
                msg.ttl_ms)
            current = self.tracker.knobs_for(msg.swarm_id)
            self.endpoint.send(src_id, encode(CtrlLeaseAck(
                msg.swarm_id, leader, gen, int(ttl), granted,
                current[0] if current is not None else 0)))


class TrackerClient:
    """Agent-side membership client: periodic re-announce over the
    transport, membership-change callback, orderly leave.

    On a self-healing transport (``TcpEndpoint.
    add_reconnect_listener``), a healed tracker link triggers an
    IMMEDIATE re-announce instead of waiting out the announce
    interval: the tracker may have expired our lease during the
    outage, and swarm membership must converge at reconnect speed,
    not at lease-refresh speed."""

    def __init__(self, endpoint: Endpoint, swarm_id: str, peer_id: str,
                 clock: Clock, *,
                 tracker_peer_id: str = TRACKER_PEER_ID,
                 announce_interval_ms: float = DEFAULT_ANNOUNCE_INTERVAL_MS,
                 on_peers: Optional[Callable[[Tuple[str, ...]], None]] = None,
                 on_knobs: Optional[Callable[[int, dict], None]] = None,
                 registry=None):
        self.endpoint = endpoint
        self.swarm_id = swarm_id
        self.peer_id = peer_id
        self.clock = clock
        self.tracker_peer_id = tracker_peer_id
        self.announce_interval_ms = announce_interval_ms
        self.on_peers = on_peers
        self.on_knobs = on_knobs
        self.known_peers: Tuple[str, ...] = ()
        #: announce→PEERS round-trip digest (engine/digest.py): the
        #: control-plane tail-latency instrument the fleet
        #: observation layer reads as ``slo.announce_rtt_ms`` —
        #: only the FIRST Peers after each announce is an RTT
        #: sample (later pushes are piggybacks, not replies)
        self._rtt_digest = (registry.digest("slo.announce_rtt_ms")
                            if registry is not None else None)
        self._announced_at_ms: Optional[float] = None
        #: last APPLIED knob epoch — the idempotency floor: the
        #: tracker piggybacks the current epoch on every answered
        #: announce, so the same update arrives many times and must
        #: apply exactly once
        self.knob_epoch = 0
        self._timer = None
        self._stopped = False
        hook = getattr(endpoint, "add_reconnect_listener", None)
        if hook is not None:
            hook(self._on_transport_reconnect)

    def _on_transport_reconnect(self, remote_id: str) -> None:
        """Transport-link healed: if it was OUR tracker link,
        re-announce now (delivered on the dispatch loop, so the timer
        churn below is single-threaded like every other timer op)."""
        if remote_id != self.tracker_peer_id or self._stopped:
            return
        if self._timer is not None:
            self._timer.cancel()
        self._announce()

    def start(self) -> None:
        self._announce()

    def handle_frame(self, src_id: str, frame_msg) -> bool:
        """Feed a decoded message; returns True if it was tracker
        traffic (the agent's dispatch calls this first)."""
        if src_id != self.tracker_peer_id:
            return False
        if isinstance(frame_msg, Peers):
            if frame_msg.swarm_id == self.swarm_id:
                if self._rtt_digest is not None \
                        and self._announced_at_ms is not None:
                    self._rtt_digest.observe(
                        self.clock.now() - self._announced_at_ms)
                    self._announced_at_ms = None
                self.known_peers = frame_msg.peer_ids
                if self.on_peers is not None:
                    self.on_peers(frame_msg.peer_ids)
            return True
        if isinstance(frame_msg, KnobUpdate):
            if frame_msg.swarm_id == self.swarm_id \
                    and frame_msg.epoch > self.knob_epoch:
                self.knob_epoch = frame_msg.epoch
                if self.on_knobs is not None:
                    self.on_knobs(frame_msg.epoch,
                                  dict(frame_msg.knobs))
            return True
        return False

    def _announce(self) -> None:
        if self._stopped:
            return
        self._announced_at_ms = self.clock.now()
        self.endpoint.send(self.tracker_peer_id,
                           encode(Announce(self.swarm_id, self.peer_id)))
        self._timer = self.clock.call_later(self.announce_interval_ms,
                                            self._announce)

    def stop(self) -> None:
        self._stopped = True
        if self._timer is not None:
            self._timer.cancel()
        self.endpoint.send(self.tracker_peer_id,
                           encode(Leave(self.swarm_id, self.peer_id)))
