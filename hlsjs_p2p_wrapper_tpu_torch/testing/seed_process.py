# A copy of the reference's testing/seed_process.py
# (hlsjs_p2p_wrapper_tpu/testing/seed_process.py): the same names, formats
# and bytes; the imports point at the port's own modules; the docstring's
# ``python -m`` line names the port.
"""Standalone seeder process for cross-process swarm tests/demos.

Run: ``python -m hlsjs_p2p_wrapper_tpu_torch.testing.seed_process
<tracker_host:port> <content_id> <sn> <size>``

Joins the swarm over real TCP, fetches one segment from a synthetic
instant CDN (caching + announcing it), emits ``READY`` on stdout, and
serves peers until stdin closes — the minimal living proof that two
OS processes exchange segments through this framework's real-socket
transport.

``READY`` / ``SEED-FAILED`` are a line PROTOCOL the parent process
reads from the stdout pipe (tests/test_net.py), not human logging —
they go through a message-only ``logging`` handler bound to stdout
(configured in :func:`main`, where the process owns its output), so
the package stays print-free (tools/lint.py enforces it) without
changing a byte on the wire.

On an authenticated fabric, pass the swarm secret via the
``P2P_SWARM_PSK`` environment variable (env, not argv: secrets must
not appear in process lists) — the seeder then runs the same HMAC
challenge-response handshake as every other member.
"""

from __future__ import annotations

import logging
import os
import sys
import threading

log = logging.getLogger(__name__)


class _NullHandle:
    def abort(self):
        pass


class InstantCdn:
    """Deterministic origin: URL-derived payload (the canonical
    ``synthetic_payload``), served synchronously on the caller thread."""

    def __init__(self, size: int):
        self.size = size
        self.fetch_count = 0

    def fetch(self, req_info, callbacks):
        from .mock_cdn import synthetic_payload
        self.fetch_count += 1
        payload = synthetic_payload(req_info["url"], self.size)
        callbacks["on_progress"]({"cdn_downloaded": len(payload)})
        callbacks["on_success"](payload)
        return _NullHandle()


class NullBridge:
    def add_event_listener(self, name, fn):
        pass

    def get_buffer_level_max(self):
        return 30.0

    def is_live(self):
        return False


class NullMediaMap:
    def get_segment_list(self, track_view, begin_time, duration):
        return []


def _bind_protocol_handler() -> None:
    """Route this module's log records, message-only and flushed, to
    the stdout pipe the parent reads — StreamHandler flushes per
    emit, preserving the old ``print(..., flush=True)`` timing."""
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("%(message)s"))
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    log.propagate = False


def main() -> int:
    _bind_protocol_handler()
    tracker_addr, content_id, sn_s, size_s = sys.argv[1:5]
    sn, size = int(sn_s), int(size_s)

    from ..core.segment_view import SegmentView
    from ..core.track_view import TrackView
    from ..engine.net import TcpNetwork
    from ..engine.p2p_agent import P2PAgent

    psk = os.environ.get("P2P_SWARM_PSK")
    if psk == "":
        # an empty secret is a misconfiguration (templating rendered
        # an unset value), not a request for an open fabric — joining
        # unauthenticated would just die later as an opaque timeout
        log.error("SEED-FAILED P2P_SWARM_PSK is set but empty")
        return 1
    network = TcpNetwork(psk=psk.encode() if psk else None)
    agent = P2PAgent(
        NullBridge(), "http://cdn.example/master.m3u8", NullMediaMap(),
        {"network": network, "clock": network.loop,
         "cdn_transport": InstantCdn(size),
         "tracker_peer_id": tracker_addr, "content_id": content_id,
         "announce_interval_ms": 200.0},
        SegmentView, "hls", "v2")

    done = threading.Event()
    outcome = {}
    segment_view = SegmentView(sn=sn,
                               track_view=TrackView(level=0, url_id=0),
                               time=sn * 10.0)
    # callbacks run on the NetLoop thread: record + signal (sys.exit
    # there would only kill the loop thread and swallow the message)
    agent.get_segment(
        {"url": f"http://cdn.example/seg{sn}.ts", "headers": {}},
        {"on_success": lambda d: (outcome.__setitem__("ok", True),
                                  done.set()),
         "on_error": lambda e: (outcome.__setitem__("error", e),
                                done.set()),
         "on_progress": lambda e: None}, segment_view)
    if not done.wait(10.0) or "error" in outcome:
        log.error("SEED-FAILED %s", outcome.get("error", "timeout"))
        return 1

    log.info("READY %s", agent.peer_id)
    sys.stdin.read()  # serve until the parent closes our stdin
    agent.dispose()
    network.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
