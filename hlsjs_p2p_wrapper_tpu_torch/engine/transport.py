# A copy of the reference's engine/transport.py
# (hlsjs_p2p_wrapper_tpu/engine/transport.py): the same names, formats and
# bytes; the imports point at the port's own modules.
"""Peer-to-peer message transport.

The reference delivers segments over WebRTC data channels inside the
closed-source agent (SURVEY.md §2.4); the rebuild abstracts the
transport behind a tiny endpoint interface so the same engine runs on
(a) an in-process :class:`LoopbackNetwork` — a deterministic,
virtual-clock network model with per-peer uplink shaping, per-link
latency, loss, and partitions, which is how swarms are tested without
"open several browser tabs" (reference README.md:253) — and (b) real
sockets in deployments.

Delivery model: unordered datagram-style messages with per-endpoint
FIFO uplink serialization.  Each sent frame occupies the sender's
uplink for ``size * 8 / uplink_bps`` seconds (back-to-back sends
queue), then arrives after the link latency.  This mirrors the
dominant physical constraint of browser P2P (asymmetric uplink).
"""

from __future__ import annotations

import random
from typing import Callable, Dict, Optional, Tuple

from ..core.clock import Clock

ReceiveFn = Callable[[str, bytes], None]  # (source peer id, frame)


class Endpoint:
    """One peer's attachment to the network."""

    def __init__(self, network: "LoopbackNetwork", peer_id: str,
                 uplink_bps: Optional[float]):
        self.network = network
        self.peer_id = peer_id
        self.uplink_bps = uplink_bps
        self.on_receive: Optional[ReceiveFn] = None
        self.closed = False
        self._uplink_free_at = 0.0  # ms timestamp when uplink drains
        self.bytes_sent = 0
        self.bytes_received = 0

    def send(self, dest_id: str, frame: bytes) -> bool:
        """Queue a frame for delivery.  Returns False only for
        conditions a real sender could observe locally (closed
        endpoint, unknown destination, hard partition).  Injected loss
        is silent — send returns True and the frame vanishes, like the
        UDP it models — so receivers must rely on timeouts either way."""
        if self.closed:
            return False
        return self.network._transmit(self, dest_id, frame)

    def backlog_ms(self, dest_id: Optional[str] = None) -> float:
        """How much already-accepted traffic is still waiting on this
        peer's shaped uplink — the WebRTC ``bufferedAmount`` analogue.
        Senders that pace on this can stop pushing when a transfer is
        cancelled instead of having pre-queued a whole segment.
        ``dest_id`` is accepted for signature parity with the TCP
        fabric and ignored: the loopback uplink is ONE serialized
        queue shared by every destination, so the backlog is the same
        whichever peer you ask about."""
        if self.uplink_bps is None:
            return 0.0
        return max(0.0, self._uplink_free_at - self.network.clock.now())

    def close(self) -> None:
        self.closed = True
        self.network._endpoints.pop(self.peer_id, None)


class LoopbackNetwork:
    """Deterministic in-process network on an injectable clock.

    - ``default_latency_ms``: one-way delay applied to every link
    - ``loss_rate``: uniform probability a frame is dropped (seeded
      RNG, reproducible)
    - per-link overrides via :meth:`set_link`; hard partitions via
      :meth:`partition`
    - ``fault_plan``: a :class:`~.netfaults.NetFaultPlan` driving the
      SAME knobs on a schedule — ``loss`` windows drop frames through
      the plan's seeded RNG, ``partition`` windows block a
      deterministic fraction of peer pairs, ``latency`` windows add
      delay — so the loopback fabric and the TCP fabric
      (``TcpNetwork(fault_plan=...)``) run one chaos schedule
    """

    def __init__(self, clock: Clock, *, default_latency_ms: float = 10.0,
                 loss_rate: float = 0.0, seed: int = 0,
                 fault_plan=None):
        self.clock = clock
        self.default_latency_ms = default_latency_ms
        self.loss_rate = loss_rate
        self.fault_plan = fault_plan
        self._rng = random.Random(seed)
        self._endpoints: Dict[str, Endpoint] = {}
        self._links: Dict[Tuple[str, str], Dict] = {}
        self.frames_delivered = 0
        self.frames_dropped = 0

    # -- topology ------------------------------------------------------
    def register(self, peer_id: str,
                 uplink_bps: Optional[float] = None) -> Endpoint:
        """``uplink_bps=None`` means unshaped (infinite) uplink; a rate
        must be positive — model an upload-disabled peer with the
        agent's ``p2p_upload_on`` toggle, not a zero-capacity link."""
        if peer_id in self._endpoints:
            raise ValueError(f"peer id already registered: {peer_id}")
        if uplink_bps is not None and uplink_bps <= 0:
            raise ValueError("uplink_bps must be positive (or None)")
        endpoint = Endpoint(self, peer_id, uplink_bps)
        self._endpoints[peer_id] = endpoint
        return endpoint

    def set_link(self, a: str, b: str, *, latency_ms: Optional[float] = None,
                 loss_rate: Optional[float] = None) -> None:
        """Override latency/loss for the (a, b) pair, both directions."""
        for key in ((a, b), (b, a)):
            link = self._links.setdefault(key, {})
            if latency_ms is not None:
                link["latency_ms"] = latency_ms
            if loss_rate is not None:
                link["loss_rate"] = loss_rate

    def partition(self, a: str, b: str, blocked: bool = True) -> None:
        """Block (or restore) all traffic between two peers."""
        for key in ((a, b), (b, a)):
            self._links.setdefault(key, {})["blocked"] = blocked

    # -- transmission --------------------------------------------------
    def _transmit(self, src: Endpoint, dest_id: str, frame: bytes) -> bool:
        dest = self._endpoints.get(dest_id)
        link = self._links.get((src.peer_id, dest_id), {})
        plan = self.fault_plan
        if dest is None or dest.closed or link.get("blocked") or (
                plan is not None
                and plan.link_blocked(src.peer_id, dest_id)):
            # a scheduled partition window behaves exactly like the
            # hard partition() knob: an observable send failure
            self.frames_dropped += 1
            return False
        loss = link.get("loss_rate", self.loss_rate)
        if loss and self._rng.random() < loss:
            self.frames_dropped += 1
            return True  # loss is silent, like the UDP it models
        if plan is not None and plan.drop_frame():
            self.frames_dropped += 1
            return True  # scheduled loss is silent too

        now = self.clock.now()
        size = len(frame)
        src.bytes_sent += size

        # uplink serialization: the frame transmits only after every
        # previously queued frame has drained
        if src.uplink_bps is not None:
            transmit_ms = size * 8000.0 / src.uplink_bps
            start = max(now, src._uplink_free_at)
            src._uplink_free_at = start + transmit_ms
            ready = src._uplink_free_at
        else:
            ready = now

        latency = link.get("latency_ms", self.default_latency_ms)
        if plan is not None:
            latency += plan.extra_latency_ms()
        src_id = src.peer_id

        def deliver() -> None:
            target = self._endpoints.get(dest_id)
            # identity check: frames addressed to a closed endpoint must
            # not leak into a new endpoint re-registered under its id
            if target is not dest or target.closed or target.on_receive is None:
                self.frames_dropped += 1
                return
            if self._links.get((src_id, dest_id), {}).get("blocked"):
                self.frames_dropped += 1
                return
            target.bytes_received += size
            self.frames_delivered += 1
            target.on_receive(src_id, frame)

        self.clock.call_later((ready - now) + latency, deliver)
        return True

    @property
    def peer_ids(self):
        return list(self._endpoints)
