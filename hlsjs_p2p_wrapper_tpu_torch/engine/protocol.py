# A copy of the reference's engine/protocol.py (hlsjs_p2p_wrapper_tpu/engine/protocol.py): the
# same names, formats and bytes; the imports point at the port's own modules
# and a few comments no longer cite the reference's history.
"""Swarm wire protocol.

The reference's peer protocol lives inside the closed-source
``streamroot-p2p`` module; the only part that is observable in-tree is
its content-addressing wire format — the 12-byte
``uint32[level, url_id, sn]`` segment key (reference:
lib/integration/mapping/segment-view.js:9-17,59-61).  This module
defines the rest from scratch: a compact binary framing for
peer ⇄ peer and peer ⇄ tracker messages, built around that exact
12-byte key so segment identity is bit-compatible with the reference's
captures.

Frame layout (little-endian throughout, like the JS ``Uint32Array``
wire format it embeds)::

    magic   u16 = 0x5350  ("SP")
    version u8  = 1
    type    u8
    body    (type-specific)

Strings are u16-length-prefixed UTF-8.  Segment keys are the raw
12-byte SegmentView buffer.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Tuple

from ..core.segment_view import WIRE_SIZE, SegmentView

MAGIC = 0x5350
VERSION = 1
_HEADER = struct.Struct("<HBB")


class MsgType:
    """Message type codes.  0x0x = peer ⇄ peer, 0x1x = peer ⇄ tracker."""

    HELLO = 0x01      # handshake: swarm id + peer id
    HAVE = 0x02       # "I now cache this segment" (+ size + sha256)
    BITFIELD = 0x03   # full have-map (sent after HELLO)
    REQUEST = 0x04    # ask for a segment
    CANCEL = 0x05     # withdraw a request
    CHUNK = 0x06      # segment payload piece
    DENY = 0x07       # request refused (miss / upload off / busy)
    LOST = 0x08       # "segment evicted from my cache"
    BYE = 0x09        # orderly departure
    ANNOUNCE = 0x10   # tracker: join/refresh swarm membership
    PEERS = 0x11      # tracker: current member list
    LEAVE = 0x12      # tracker: orderly departure
    SET_KNOBS = 0x13  # controller → tracker: publish a knob epoch
    KNOB_UPDATE = 0x14  # tracker → peer: current knob epoch
    CTRL_LEASE = 0x15  # controller → tracker: claim/renew the lease
    CTRL_LEASE_ACK = 0x16  # tracker → controller: lease verdict


class DenyReason:
    NOT_FOUND = 0
    UPLOAD_OFF = 1
    BUSY = 2


@dataclass(frozen=True)
class Hello:
    swarm_id: str
    peer_id: str


#: bytes of SHA-256 carried per announced segment.  Announcements bind
#: a peer to the exact payload it will serve: the downloader records
#: (size, digest) at request time and verifies the reassembled bytes,
#: so a peer cannot serve arbitrary content for a requested key
#: (content-poisoning defense — the closed reference agent was the
#: trust boundary; this rebuild carries its own).
DIGEST_SIZE = 32


@dataclass(frozen=True)
class Have:
    key: bytes     # 12-byte SegmentView buffer
    size: int      # payload length in bytes
    digest: bytes  # sha256(payload)


@dataclass(frozen=True)
class Bitfield:
    entries: Tuple[Tuple[bytes, int, bytes], ...]  # (key, size, digest)


@dataclass(frozen=True)
class Request:
    request_id: int
    key: bytes


@dataclass(frozen=True)
class Cancel:
    request_id: int


@dataclass(frozen=True)
class Chunk:
    request_id: int
    offset: int
    total: int
    payload: bytes


@dataclass(frozen=True)
class Deny:
    request_id: int
    reason: int


@dataclass(frozen=True)
class Lost:
    key: bytes


@dataclass(frozen=True)
class Bye:
    pass


@dataclass(frozen=True)
class Announce:
    swarm_id: str
    peer_id: str


@dataclass(frozen=True)
class Peers:
    swarm_id: str
    peer_ids: Tuple[str, ...]


@dataclass(frozen=True)
class Leave:
    swarm_id: str
    peer_id: str


@dataclass(frozen=True)
class SetKnobs:
    """Controller → tracker: publish a new policy-knob epoch for one
    swarm.  ``knobs`` is a tuple of ``(name, value)`` pairs — value
    is an f64 so any scheduler scalar travels; names the receiving
    agent does not recognize are skipped there (forward compat).
    Epochs are STRICTLY monotone per swarm: the tracker refuses
    ``epoch <= current`` (a resumed controller can never re-actuate
    a stale decision) and clients apply idempotently by epoch.

    ``generation`` is the publisher's controller-lease generation
    (the HA pair): when the swarm's control channel is lease-arbitrated
    the tracker additionally refuses any publish whose generation is
    below the lease's — a deposed leader is FENCED on the tracker's
    own state, with no wall-clock trust between controllers.  0 is
    the pre-HA publisher (no lease claimed); it is fenced too once a
    lease exists."""

    swarm_id: str
    epoch: int
    knobs: Tuple[Tuple[str, float], ...]
    generation: int = 0


@dataclass(frozen=True)
class KnobUpdate:
    """Tracker → peer (and tracker → controller, as the SET_KNOBS
    ack): the swarm's CURRENT knob epoch.  Piggybacked on the
    Announce/Peers channel — every answered announce of a swarm with
    published knobs is followed by one of these, so periodic
    re-announce (and the reconnect-listener's immediate re-announce
    on a healed link) IS the knob-convergence path; no new timer, no
    new channel.  ``generation`` echoes the lease generation that
    last wrote the state (0 when no lease-fenced controller ever
    published)."""

    swarm_id: str
    epoch: int
    knobs: Tuple[Tuple[str, float], ...]
    generation: int = 0


@dataclass(frozen=True)
class CtrlLease:
    """Controller → tracker: claim or renew THE controller lease for
    one swarm's control channel (the HA pair).  ``generation``
    is the generation the sender believes it holds — 0 for a fresh
    claim; a renewal presents its granted generation so a deposed
    holder can never extend a lease that was stolen from it.
    ``ttl_ms`` is the requested time-to-live, judged entirely on the
    TRACKER's clock (the WorkLedger claim/steal discipline ported to
    the control channel: no wall-clock agreement between controllers
    is assumed, ever)."""

    swarm_id: str
    controller_id: str
    generation: int
    ttl_ms: int


@dataclass(frozen=True)
class CtrlLeaseAck:
    """Tracker → controller: the lease verdict.  Always carries the
    CURRENT holder (``leader_id`` / ``generation`` / remaining
    ``ttl_ms``) so a refused claimant doubles as a leader-identity
    subscription, and ``knob_epoch`` — the swarm's current knob
    epoch — so the hot standby's replay watermark rides the lease
    channel (no extra probe traffic)."""

    swarm_id: str
    leader_id: str
    generation: int
    ttl_ms: int
    granted: bool
    knob_epoch: int


class ProtocolError(ValueError):
    """Malformed or unknown frame."""


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    if len(raw) > 0xFFFF:
        raise ProtocolError("string too long for wire format")
    return struct.pack("<H", len(raw)) + raw


def _unpack_str(buf: memoryview, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<H", buf, off)
    off += 2
    if off + n > len(buf):
        raise ProtocolError("truncated string field")
    try:
        s = bytes(buf[off:off + n]).decode("utf-8")
    except UnicodeDecodeError as exc:
        # must surface as ProtocolError: dispatchers (tracker,
        # p2p_agent) rely on decode()'s one-except-clause contract,
        # and a peer-supplied id is exactly where hostile bytes land
        raise ProtocolError(f"invalid UTF-8 in string field: {exc}") \
            from exc
    return s, off + n


def _check_key(key: bytes) -> bytes:
    if len(key) != WIRE_SIZE:
        raise ProtocolError(f"segment key must be {WIRE_SIZE} bytes")
    return bytes(key)


def _check_digest(digest: bytes) -> bytes:
    if len(digest) != DIGEST_SIZE:
        raise ProtocolError(f"digest must be {DIGEST_SIZE} bytes")
    return bytes(digest)


_ENTRY_SIZE = WIRE_SIZE + 4 + DIGEST_SIZE  # key + u32 size + digest


def _pack_entry(key: bytes, size: int, digest: bytes) -> bytes:
    return (_check_key(key) + struct.pack("<I", size)
            + _check_digest(digest))


def _unpack_entry(body: memoryview, off: int) -> Tuple[bytes, int, bytes]:
    key = bytes(body[off:off + WIRE_SIZE])
    (size,) = struct.unpack_from("<I", body, off + WIRE_SIZE)
    digest = bytes(body[off + WIRE_SIZE + 4:off + _ENTRY_SIZE])
    return _check_key(key), size, _check_digest(digest)


def encode(msg) -> bytes:
    """Serialize a message dataclass to one wire frame."""
    t = type(msg)
    if t is Hello:
        return _frame(MsgType.HELLO,
                      _pack_str(msg.swarm_id) + _pack_str(msg.peer_id))
    if t is Have:
        return _frame(MsgType.HAVE,
                      _pack_entry(msg.key, msg.size, msg.digest))
    if t is Bitfield:
        body = struct.pack("<I", len(msg.entries)) + b"".join(
            _pack_entry(*entry) for entry in msg.entries)
        return _frame(MsgType.BITFIELD, body)
    if t is Request:
        return _frame(MsgType.REQUEST,
                      struct.pack("<I", msg.request_id) + _check_key(msg.key))
    if t is Cancel:
        return _frame(MsgType.CANCEL, struct.pack("<I", msg.request_id))
    if t is Chunk:
        return _frame(MsgType.CHUNK,
                      struct.pack("<III", msg.request_id, msg.offset,
                                  msg.total) + msg.payload)
    if t is Deny:
        return _frame(MsgType.DENY,
                      struct.pack("<IB", msg.request_id, msg.reason))
    if t is Lost:
        return _frame(MsgType.LOST, _check_key(msg.key))
    if t is Bye:
        return _frame(MsgType.BYE, b"")
    if t is Announce:
        return _frame(MsgType.ANNOUNCE,
                      _pack_str(msg.swarm_id) + _pack_str(msg.peer_id))
    if t is Peers:
        body = _pack_str(msg.swarm_id) + struct.pack("<H", len(msg.peer_ids))
        body += b"".join(_pack_str(p) for p in msg.peer_ids)
        return _frame(MsgType.PEERS, body)
    if t is Leave:
        return _frame(MsgType.LEAVE,
                      _pack_str(msg.swarm_id) + _pack_str(msg.peer_id))
    if t is SetKnobs:
        return _frame(MsgType.SET_KNOBS, _pack_knob_body(msg))
    if t is KnobUpdate:
        return _frame(MsgType.KNOB_UPDATE, _pack_knob_body(msg))
    if t is CtrlLease:
        return _frame(
            MsgType.CTRL_LEASE,
            _pack_str(msg.swarm_id) + _pack_str(msg.controller_id)
            + struct.pack("<II", _check_u32(msg.generation,
                                            "lease generation"),
                          _check_u32(msg.ttl_ms, "lease ttl_ms")))
    if t is CtrlLeaseAck:
        return _frame(
            MsgType.CTRL_LEASE_ACK,
            _pack_str(msg.swarm_id) + _pack_str(msg.leader_id)
            + struct.pack("<IIBI",
                          _check_u32(msg.generation,
                                     "lease generation"),
                          _check_u32(msg.ttl_ms, "lease ttl_ms"),
                          1 if msg.granted else 0,
                          _check_u32(msg.knob_epoch, "knob epoch")))
    raise ProtocolError(f"cannot encode {t.__name__}")


def _check_u32(value: int, what: str) -> int:
    if not 0 <= value <= 0xFFFFFFFF:
        raise ProtocolError(f"{what} {value} outside u32")
    return value


def _pack_knob_body(msg) -> bytes:
    """Shared SET_KNOBS / KNOB_UPDATE body: swarm id, u32 epoch, u32
    lease generation, u16 knob count, then ``(name, f64 value)``
    pairs."""
    _check_u32(msg.epoch, "knob epoch")
    _check_u32(msg.generation, "lease generation")
    if len(msg.knobs) > 0xFFFF:
        raise ProtocolError("too many knobs for wire format")
    body = _pack_str(msg.swarm_id)
    body += struct.pack("<IIH", msg.epoch, msg.generation,
                        len(msg.knobs))
    for name, value in msg.knobs:
        body += _pack_str(name) + struct.pack("<d", float(value))
    return body


def _unpack_knob_body(body: memoryview) -> Tuple[str, int, tuple, int]:
    swarm_id, off = _unpack_str(body, 0)
    epoch, generation, count = struct.unpack_from("<IIH", body, off)
    off += 10
    knobs = []
    for _ in range(count):
        name, off = _unpack_str(body, off)
        if off + 8 > len(body):
            raise ProtocolError("truncated knob value")
        (value,) = struct.unpack_from("<d", body, off)
        off += 8
        knobs.append((name, value))
    _consumed(off, body)
    return swarm_id, epoch, tuple(knobs), generation


def _frame(msg_type: int, body: bytes) -> bytes:
    return _HEADER.pack(MAGIC, VERSION, msg_type) + body


def decode(frame: bytes):
    """Parse one wire frame back into its message dataclass.  Every
    malformed input raises :class:`ProtocolError` (struct underflows
    are translated), so transport-facing dispatchers need exactly one
    except clause."""
    if len(frame) < _HEADER.size:
        raise ProtocolError("frame shorter than header")
    magic, version, msg_type = _HEADER.unpack_from(frame)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic 0x{magic:04x}")
    if version != VERSION:
        raise ProtocolError(f"unsupported protocol version {version}")
    body = memoryview(frame)[_HEADER.size:]
    try:
        return _decode_body(msg_type, body)
    except struct.error as exc:
        raise ProtocolError(f"truncated body: {exc}") from exc


def _consumed(off: int, body: memoryview) -> None:
    """Reject trailing bytes: every frame must be exactly its message.
    Keeps decoding canonical (``encode(decode(f)) == f`` for every
    accepted frame) — laxity here would let two different byte strings
    mean the same message, a classic protocol-confusion foothold."""
    if off != len(body):
        raise ProtocolError(f"{len(body) - off} trailing bytes in body")


def _decode_body(msg_type: int, body: memoryview):
    if msg_type == MsgType.HELLO:
        swarm_id, off = _unpack_str(body, 0)
        peer_id, off = _unpack_str(body, off)
        _consumed(off, body)
        return Hello(swarm_id, peer_id)
    if msg_type == MsgType.HAVE:
        if len(body) != _ENTRY_SIZE:
            raise ProtocolError("have body size mismatch")
        return Have(*_unpack_entry(body, 0))
    if msg_type == MsgType.BITFIELD:
        (count,) = struct.unpack_from("<I", body, 0)
        # validate the declared count against the actual body BEFORE
        # allocating: a forged count must not drive allocation size
        if 4 + count * _ENTRY_SIZE != len(body):
            raise ProtocolError("bitfield count/body size mismatch")
        entries = tuple(_unpack_entry(body, 4 + i * _ENTRY_SIZE)
                        for i in range(count))
        return Bitfield(entries)
    if msg_type == MsgType.REQUEST:
        (request_id,) = struct.unpack_from("<I", body, 0)
        return Request(request_id, _check_key(bytes(body[4:])))
    if msg_type == MsgType.CANCEL:
        (request_id,) = struct.unpack_from("<I", body, 0)
        _consumed(4, body)
        return Cancel(request_id)
    if msg_type == MsgType.CHUNK:
        request_id, offset, total = struct.unpack_from("<III", body, 0)
        return Chunk(request_id, offset, total, bytes(body[12:]))
    if msg_type == MsgType.DENY:
        request_id, reason = struct.unpack_from("<IB", body, 0)
        _consumed(5, body)
        return Deny(request_id, reason)
    if msg_type == MsgType.LOST:
        return Lost(_check_key(bytes(body)))
    if msg_type == MsgType.BYE:
        _consumed(0, body)
        return Bye()
    if msg_type == MsgType.ANNOUNCE:
        swarm_id, off = _unpack_str(body, 0)
        peer_id, off = _unpack_str(body, off)
        _consumed(off, body)
        return Announce(swarm_id, peer_id)
    if msg_type == MsgType.PEERS:
        swarm_id, off = _unpack_str(body, 0)
        (count,) = struct.unpack_from("<H", body, off)
        off += 2
        peer_ids = []
        for _ in range(count):
            p, off = _unpack_str(body, off)
            peer_ids.append(p)
        _consumed(off, body)
        return Peers(swarm_id, tuple(peer_ids))
    if msg_type == MsgType.LEAVE:
        swarm_id, off = _unpack_str(body, 0)
        peer_id, off = _unpack_str(body, off)
        _consumed(off, body)
        return Leave(swarm_id, peer_id)
    if msg_type == MsgType.SET_KNOBS:
        return SetKnobs(*_unpack_knob_body(body))
    if msg_type == MsgType.KNOB_UPDATE:
        return KnobUpdate(*_unpack_knob_body(body))
    if msg_type == MsgType.CTRL_LEASE:
        swarm_id, off = _unpack_str(body, 0)
        controller_id, off = _unpack_str(body, off)
        generation, ttl_ms = struct.unpack_from("<II", body, off)
        _consumed(off + 8, body)
        return CtrlLease(swarm_id, controller_id, generation, ttl_ms)
    if msg_type == MsgType.CTRL_LEASE_ACK:
        swarm_id, off = _unpack_str(body, 0)
        leader_id, off = _unpack_str(body, off)
        generation, ttl_ms, granted, knob_epoch = \
            struct.unpack_from("<IIBI", body, off)
        _consumed(off + 13, body)
        if granted not in (0, 1):
            # canonical encoding: exactly one byte string per message
            raise ProtocolError(f"non-boolean granted byte {granted}")
        return CtrlLeaseAck(swarm_id, leader_id, generation, ttl_ms,
                            bool(granted), knob_epoch)
    raise ProtocolError(f"unknown message type 0x{msg_type:02x}")


def segment_key(segment_view: SegmentView) -> bytes:
    """Canonical cache/wire key for a segment (the reference's 12-byte
    ``toArrayBuffer`` form, segment-view.js:59-61)."""
    return segment_view.to_bytes()
