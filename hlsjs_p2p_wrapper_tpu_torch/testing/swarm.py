# A copy of the reference's testing/swarm.py
# (hlsjs_p2p_wrapper_tpu/testing/swarm.py): the same names, formats and
# bytes; the imports point at the port's own modules.
"""Multi-player swarm harness.

The reference's answer to "how do I see P2P traffic?" is literally
"open several browser tabs playing the same manifest"
(reference README.md:253) — SURVEY.md §7.3(5) calls out the missing
harness as a top-five hard part.  This is that harness: N complete
players (SimPlayer + wrapper + full P2P agent) on ONE VirtualClock,
sharing a LoopbackNetwork, a Tracker, and a shaped mock CDN, with
peer churn and fault injection, measuring the repo-native north-star
metrics (BASELINE.json): **P2P offload ratio** and **rebuffer ratio**.

Everything is deterministic: same seed + same schedule = same bytes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..core.clock import VirtualClock
from ..core.wrapper import P2PWrapper
from ..engine.p2p_agent import P2PAgent
from ..engine.telemetry import JsonlExporter, MetricsRegistry
from ..engine.tracker import Tracker, TrackerEndpoint
from ..engine.transport import LoopbackNetwork
from ..player.manifest import LiveFeeder, make_live_manifest, make_vod_manifest
from ..player.sim import SimPlayer
from .mock_cdn import MockCdnTransport, serve_manifest


class SwarmPeer:
    """One participant: wrapper + player + (lazily created) agent."""

    def __init__(self, peer_id: str, wrapper: P2PWrapper, player: SimPlayer,
                 clock: VirtualClock,
                 registry: Optional[MetricsRegistry] = None):
        self.peer_id = peer_id
        self.wrapper = wrapper
        self.player = player
        self._clock = clock
        self.joined_at_ms = clock.now()
        self.left_at_ms: Optional[float] = None
        self.left = False
        self._final_stats: Optional[Dict] = None
        # twin membership provenance (engine/twinframe.py): one
        # clock-stamped join/leave bump per lifecycle transition, so
        # a flight recorder attached to the harness registry carries
        # presence as events and observation frames reconstruct
        # membership from the stream alone
        self._m_leave = None
        if registry is not None:
            registry.counter("twin.peer", peer=peer_id,
                             event="join").inc()
            self._m_leave = registry.counter("twin.peer", peer=peer_id,
                                             event="leave")

    @property
    def agent(self) -> Optional[P2PAgent]:
        return self.wrapper.peer_agent

    @property
    def stats(self) -> Dict:
        """Live agent stats; after departure, the snapshot taken at
        leave time — departed peers' transfers must keep counting in
        swarm totals or offload/conservation metrics lie."""
        if self._final_stats is not None:
            return self._final_stats
        agent = self.agent
        if agent is None:
            return {"cdn": 0, "p2p": 0, "upload": 0, "peers": 0}
        return agent.stats

    @property
    def position_s(self) -> float:
        media = self.player.media
        return media.current_time if media else 0.0

    @property
    def rebuffer_ms(self) -> float:
        return self.player.rebuffer_ms

    def refresh_stats(self) -> Dict:
        """Read the stats surface FOR its side effect: the agent's
        stats property pushes the live mesh totals (upload bytes,
        peer count) into the registry-backed instruments, which is
        what the telemetry export reads — an exporter that skipped
        this would serialize stale series."""
        return self.stats

    def leave(self) -> None:
        """Orderly departure: the player teardown disposes the agent
        (DESTROYING → dispose, player-interface.js:22-24)."""
        if not self.left:
            self.left = True
            self.left_at_ms = self._clock.now()
            if self._m_leave is not None:
                self._m_leave.inc()
            self._final_stats = dict(self.stats)
            self.player.destroy()


class SwarmHarness:
    """Deterministic N-player swarm on one virtual clock."""

    def __init__(self, *, seg_duration: float = 4.0, frag_count: int = 40,
                 level_bitrates=(300_000, 800_000, 2_000_000),
                 cdn_bandwidth_bps: Optional[float] = None,
                 cdn_latency_ms: float = 15.0,
                 p2p_latency_ms: float = 8.0,
                 loss_rate: float = 0.0, seed: int = 0,
                 live: bool = False, redundant: bool = False,
                 registry: Optional[MetricsRegistry] = None,
                 fault_plan_specs: Optional[str] = None,
                 fault_plan_kwargs: Optional[dict] = None):
        self.clock = VirtualClock()
        #: ONE registry for the whole swarm (engine/telemetry.py):
        #: every agent's stats land here as per-peer labeled series,
        #: the tracker and every mesh count into it, and
        #: :meth:`open_exporter` serializes it VirtualClock-stamped
        #: (after a :meth:`record_metrics` refresh)
        self.metrics = registry if registry is not None \
            else MetricsRegistry()
        if live:
            self.manifest = make_live_manifest(level_bitrates=level_bitrates,
                                               window_count=frag_count,
                                               seg_duration=seg_duration)
            self.feeder = LiveFeeder(self.manifest, self.clock)
            self.feeder.start()
        else:
            self.manifest = make_vod_manifest(level_bitrates=level_bitrates,
                                              frag_count=frag_count,
                                              seg_duration=seg_duration,
                                              redundant=redundant)
            self.feeder = None
        self.cdn = MockCdnTransport(self.clock, latency_ms=cdn_latency_ms,
                                    bandwidth_bps=cdn_bandwidth_bps)
        serve_manifest(self.cdn, self.manifest)
        # optional scheduled chaos (engine/netfaults.py): a
        # ``kind@t0-t1`` spec string drives the loopback loss/latency/
        # partition knobs on THIS swarm's VirtualClock, counting every
        # injection into the shared registry — the soak's --chaos mode
        self.fault_plan = None
        if fault_plan_specs is not None:
            from ..engine.netfaults import NetFaultPlan
            self.fault_plan = NetFaultPlan.parse(
                fault_plan_specs, clock=self.clock,
                registry=self.metrics, **(fault_plan_kwargs or {}))
            self.fault_plan.arm()
        self.network = LoopbackNetwork(self.clock,
                                       default_latency_ms=p2p_latency_ms,
                                       loss_rate=loss_rate, seed=seed,
                                       fault_plan=self.fault_plan)
        self.tracker = Tracker(self.clock, registry=self.metrics)
        TrackerEndpoint(self.tracker, self.network.register("tracker"))
        self.peers: List[SwarmPeer] = []
        self._counter = 0
        self._partitioned: set = set()

    # -- membership ----------------------------------------------------
    def add_peer(self, peer_id: Optional[str] = None, *,
                 uplink_bps: Optional[float] = None,
                 p2p_config: Optional[dict] = None,
                 player_config: Optional[dict] = None,
                 player_class=None,
                 start: bool = True) -> SwarmPeer:
        """Join a new player to the swarm (defaults start playback
        immediately).  ``player_class`` swaps the media engine —
        swarms may MIX implementations (e.g. SimPlayer and
        MinimalPlayer), which is exactly how the integration seam is
        proven against the contract rather than one player's shape."""
        if peer_id is None:
            peer_id = f"peer-{self._counter}"
        self._counter += 1
        wrapper = P2PWrapper(player_class or SimPlayer, P2PAgent,
                             clock=self.clock)
        cfg = {"clock": self.clock, "cdn_transport": self.cdn,
               "network": self.network, "peer_id": peer_id,
               "uplink_bps": uplink_bps, "content_id": "swarm-content",
               "announce_interval_ms": 2_000.0,
               "metrics_registry": self.metrics,
               **(p2p_config or {})}
        player = wrapper.create_player(
            {"clock": self.clock, "manifest": self.manifest,
             **(player_config or {})}, cfg)
        # twin stall provenance: players exposing the stall hooks
        # (player/sim.py) count every rebuffer accrual and stall
        # open/close into the shared registry with the exact dt their
        # rebuffer clock advanced by — the real plane's stall signal
        # for engine/twinframe.py frames.  Hook-less media engines
        # simply contribute no stall series (both frame extractors
        # agree on the absence).
        if hasattr(player, "on_stall_accrue"):
            player.on_stall_accrue = self.metrics.counter(
                "twin.stall_ms", peer=peer_id).inc
            opened = self.metrics.counter("twin.stalls", peer=peer_id,
                                          edge="open")
            closed = self.metrics.counter("twin.stalls", peer=peer_id,
                                          edge="close")
            player.on_stall_edge = (
                lambda is_open, _o=opened, _c=closed:
                (_o if is_open else _c).inc())
        peer = SwarmPeer(peer_id, wrapper, player, self.clock,
                         registry=self.metrics)
        self.peers.append(peer)
        # a peer joining after a crash-partition must not open a fresh
        # link to the "crashed" peer
        for dark in self._partitioned:
            self.network.partition(peer_id, dark)
        if start:
            player.load_source("http://cdn.example/master.m3u8")
            player.attach_media()
        return peer

    def partition_peer(self, peer_id: str, blocked: bool = True) -> None:
        """Fault injection: cut (or restore) a peer's links to every
        other participant AND the tracker — including peers that join
        later."""
        if blocked:
            self._partitioned.add(peer_id)
        else:
            self._partitioned.discard(peer_id)
        for other in [p.peer_id for p in self.peers] + ["tracker"]:
            if other != peer_id:
                self.network.partition(peer_id, other, blocked)

    # -- time ----------------------------------------------------------
    def run(self, ms: float) -> None:
        self.clock.advance(ms)

    def run_until_all_finished(self, max_ms: float = 3_600_000.0) -> bool:
        """Advance until every non-departed player reaches the end of
        the VOD timeline.  Returns False if ``max_ms`` elapses first —
        callers should assert the result so a stalled player cannot
        masquerade as a finished run."""
        duration_s = self.manifest.duration
        step = 1_000.0
        elapsed = 0.0
        while elapsed < max_ms:
            active = [p for p in self.peers if not p.left]
            if all(p.position_s >= duration_s - 0.25 for p in active):
                return True
            self.clock.advance(step)
            elapsed += step
        return False

    # -- metrics (the north-star pair, BASELINE.json) ------------------
    def total_stats(self) -> Dict:
        total = {"cdn": 0, "p2p": 0, "upload": 0}
        for peer in self.peers:
            s = peer.stats
            for k in total:
                total[k] += s[k]
        return total

    @property
    def offload_ratio(self) -> float:
        """Swarm-wide fraction of downloaded bytes served by peers."""
        t = self.total_stats()
        downloaded = t["cdn"] + t["p2p"]
        return t["p2p"] / downloaded if downloaded else 0.0

    @property
    def rebuffer_ratio(self) -> float:
        """Swarm-wide stall time / per-peer watch time (join → leave
        or now) — a late joiner's stalls must not be diluted by time
        it wasn't even present for."""
        now = self.clock.now()
        stalled = sum(p.rebuffer_ms for p in self.peers)
        watched = sum((p.left_at_ms if p.left_at_ms is not None else now)
                      - p.joined_at_ms for p in self.peers)
        return stalled / watched if watched > 0 else 0.0

    # -- telemetry export (engine/telemetry.py) ------------------------
    def record_metrics(self) -> None:
        """Refresh the harness-level gauges from the live swarm so a
        following exporter line (:meth:`open_exporter` →
        :meth:`JsonlExporter.export`) is self-contained: the
        north-star pair plus each peer's stall/watch clocks — enough
        to RE-DERIVE offload and rebuffer from the artifact alone,
        which is how tools/soak.py proves the export is complete."""
        now = self.clock.now()
        for peer in self.peers:
            peer.refresh_stats()
            self.metrics.gauge("peer.rebuffer_ms",
                               peer=peer.peer_id).set(peer.rebuffer_ms)
            end = peer.left_at_ms if peer.left_at_ms is not None else now
            self.metrics.gauge("peer.watched_ms", peer=peer.peer_id) \
                .set(end - peer.joined_at_ms)
        self.metrics.gauge("swarm.peers_total").set(len(self.peers))
        self.metrics.gauge("swarm.peers_live").set(
            sum(1 for p in self.peers if not p.left))
        self.metrics.gauge("swarm.offload_ratio").set(self.offload_ratio)
        self.metrics.gauge("swarm.rebuffer_ratio").set(
            self.rebuffer_ratio)
        self.metrics.gauge("swarm.upload_waste_ratio").set(
            self.upload_waste_ratio)

    def open_exporter(self, path: str) -> JsonlExporter:
        """JSON-lines exporter over this swarm's registry, stamped by
        the swarm's VirtualClock (deterministic simulated time)."""
        return JsonlExporter(self.metrics, self.clock, path)

    @property
    def upload_waste_ratio(self) -> float:
        """Bytes uploaded per byte DELIVERED as P2P (1.0 = perfect).
        The contention-collapse tell: transfers that crawl to a
        timeout discard their bytes, so under a bad scheduling policy
        this climbs (measured 7× pre-fix at 2.4 Mbps uplinks, 1.6×
        after spread + admission control — see
        engine/mesh.py holders_of / MAX_TOTAL_SERVES)."""
        totals = self.total_stats()
        return (totals["upload"] / totals["p2p"]
                if totals["p2p"] > 0 else 0.0)
