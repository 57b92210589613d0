# A copy of the reference's engine/recordio.py (hlsjs_p2p_wrapper_tpu/engine/recordio.py): the
# same names, formats and bytes; only the imports point at the port's own
# modules.
"""Binary flight-recorder codec: the event plane's hot families as
fixed-width CRC-framed records, decoded at numpy speed.

The flight recorder is the fleet's observation plane; at
fleet scale its cost structure was measured and indicted
(BENCH_r12 ``detail.fleet_ingest``): every hot event — a ``twin.*``
provenance bump, a ``twin_window`` / ``slo_window`` boundary mark —
was a JSON line built dict-by-dict in the writer and re-parsed
dict-by-dict in every reader, so mux ingest wall grew 2×+ at 16
shards and the armed recorder cost 12.5% of the twin scenario
against a 3% bar.  This module replaces the TEXT on the hot path
while keeping every durability and tolerance contract bit-for-bit:

**The frame.**  A shard remains one append-only file whose first
line is the JSONL ``meta`` header (greppable, and what lets a
format-sniffing reader tell old shards from new).  Binary records
are fixed-width 88-byte frames::

    MAGIC(1)=0xF5  kind(1)  len(2,LE)  payload(80, zero-padded)
    crc32(4,LE over kind+len+payload)

``0xF5`` can never begin a JSONL record: the recorder's JSON is
``ensure_ascii`` and a bare ``0xF5`` is not valid UTF-8 at all, so
the first byte of every record position decides text vs binary with
no escaping.  The fixed width is what makes the decoder vectorize —
a run of frames is an ``(n, 88)`` uint8 matrix, CRC-checked
column-wise and column-sliced into numpy arrays with zero per-record
Python — and it is also what keeps the torn-tail discipline exact:

- a SIGKILL mid-append leaves a partial last frame, which the
  decoder leaves buffered (incremental) or counts as the one torn
  tail (batch) — every complete frame before it decodes;
- a flipped bit fails exactly one frame's CRC: the decoder counts
  ONE bad record and resyncs at the next verifiable frame start or
  JSONL line, so corruption never cascades (the
  ``read_jsonl_tolerant`` promise, byte-for-byte).

**Record kinds.**  Fixed-width codecs cover the measured-hot
families — counter bumps (``K_COUNTER``), ``twin_window`` marks
(``K_TWIN_WINDOW``), ``slo_window`` marks (``K_SLO_WINDOW``) — with
strings interned once per shard via ``K_STR`` definition frames
(id → utf-8), so a per-fetch bump is 33 payload bytes and zero
string re-rendering.  Everything else (spans, rows, leases, ``ctx``
-bearing bumps, the nested-attribution ``slo_alert`` marks) rides
``K_JSON``/``K_CONT``: the record's compact JSON chunked into the
same CRC frames — rare by construction, still framed, still
isolated under corruption.  A codec that cannot represent a record
EXACTLY (string too long, u32 out of range, unexpected field set)
declines and the record falls through to ``K_JSON``: the encoder
never widens, never truncates, never raises.

**The contract** is the tracer's exactness oracle, extended: decoding a
binary shard yields dict-for-dict the records the JSONL path would
have written (``replay_counter_families`` folds either back to the
exact registry form), and the frame pipeline built on the columnar
decoder is bit-identical to the dict pipeline on the same traffic
(``tools/slo_gate.py`` asserts it on real traffic; the unit suite
on adversarial bytes).
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Dict, List, Optional, Tuple

#: first byte of every binary frame; invalid as UTF-8 and so never
#: the first byte of a JSONL record — the one-byte format sniff
MAGIC = 0xF5
_MAGIC_B = bytes([MAGIC])

#: total frame width / payload capacity.  One width for every kind
#: is the vectorization contract: frame boundaries are arithmetic,
#: never data-dependent, so a run of frames reshapes to (n, 88)
FRAME_BYTES = 88
PAYLOAD_BYTES = 80

_HEADER = struct.Struct("<BH")       # kind, payload length
_CRC = struct.Struct("<I")

# record kinds
K_STR = 1          # string-table definition: id u32 + utf-8 bytes
K_COUNTER = 2      # one registry counter bump
K_TWIN_WINDOW = 3  # one twin_window sampler mark
K_SLO_WINDOW = 4   # one slo_window evaluator mark
K_JSON = 5         # chunked compact-JSON record (first chunk)
K_CONT = 6         # continuation chunk of the preceding K_JSON

_STR_DEF = struct.Struct("<I")
#: t, seq, host_id, name_id, labels_id, n, flags
_COUNTER = struct.Struct("<dIIIIdB")
#: t, seq, host_id, window, window_ms, flags
_TWIN_WINDOW = struct.Struct("<dIIIdB")
#: t, seq, host_id, slo_id, metric_id, quantile_id, window,
#: value, burn_fast, burn_slow, budget_remaining, t_s, flags
_SLO_WINDOW = struct.Struct("<dIIIIIIdddddB")

# flag bits shared by the fixed codecs (bit 0 is always "t was an
# int": virtual clocks hand out floats, but tests inject integer
# clocks and decode must reproduce the record EXACTLY, type and all)
_F_T_INT = 1
_F_N_INT = 2          # K_COUNTER: n was an int
_F_WMS_INT = 2        # K_TWIN_WINDOW: window_ms was an int
_F_FIRING = 2         # K_SLO_WINDOW
_F_GOOD_SET = 4       # K_SLO_WINDOW: good is not None
_F_GOOD_TRUE = 8      # K_SLO_WINDOW
_F_VALUE_SET = 16     # K_SLO_WINDOW: value is not None

_U32_MAX = 0xFFFFFFFF
#: longest intern-able string: a K_STR payload is id(4) + utf-8
_STR_MAX = PAYLOAD_BYTES - _STR_DEF.size


def _is_u32(value) -> bool:
    return (type(value) is int and 0 <= value <= _U32_MAX)


def _is_real(value) -> bool:
    """int-or-float, bools excluded (bool is an int subclass and a
    re-decoded True would otherwise come back as 1)."""
    return type(value) is int or type(value) is float


def frame(kind: int, payload: bytes) -> bytes:
    """One complete frame around ``payload`` (≤ 80 bytes): header +
    zero padding + CRC over everything after the magic — padding
    included, so a flipped PAD bit is detected too, not silently
    accepted."""
    body = (_HEADER.pack(kind, len(payload)) + payload
            + b"\x00" * (PAYLOAD_BYTES - len(payload)))
    return _MAGIC_B + body + _CRC.pack(zlib.crc32(body))


class ShardEncoder:
    """One shard's write-side codec: a per-shard string table (ids
    are shard-local, defined by ``K_STR`` frames strictly before
    first use) plus the fixed-width codecs, with ``K_JSON`` chunking
    as the never-fails fallback.  NOT thread-safe by itself — the
    recorder already serializes emission under its buffer lock, and
    the string table must be appended in buffer order anyway (an id
    used before its definition frame would be undecodable)."""

    def __init__(self):
        self._ids: Dict[str, int] = {}
        self._next_id = 1  # 0 is the "no string / None" sentinel
        #: (name, labels) -> preassembled (name_id, labels_id) for
        #: the bump fast path: the ids are interned once per distinct
        #: instrument, so the steady-state bump encode is one
        #: struct.pack with zero dict or string work
        self._bump_memo: Dict[Tuple[str, str], Tuple[int, int]] = {}

    # -- string interning ------------------------------------------------

    def _intern(self, text: str, defs: List[bytes],
                added: List[str]) -> Optional[int]:
        """The id for ``text``, appending its one-time ``K_STR``
        definition frame to ``defs`` and its text to ``added`` on
        first sight; None when the string cannot be interned (too
        long for one frame — the caller's codec declines and the
        record rides K_JSON).  Interning is TENTATIVE until the
        whole record encodes: a codec that declines after a
        successful intern must :meth:`_rollback` its ``added`` list,
        because the definition frames only exist in the discarded
        ``defs`` — an id left committed would cache-hit on a later
        record and reference a definition never written to the
        shard, turning every later record of that family into an
        unresolvable-id bad record at decode."""
        cached = self._ids.get(text)
        if cached is not None:
            return cached
        raw = text.encode("utf-8")
        if len(raw) > _STR_MAX:
            return None
        if self._next_id > _U32_MAX:
            return None
        ident = self._next_id
        self._next_id += 1
        self._ids[text] = ident
        added.append(text)
        defs.append(frame(K_STR, _STR_DEF.pack(ident) + raw))
        return ident

    def _rollback(self, added: List[str]) -> None:
        """Un-commit the ids a declining encode call interned (their
        K_STR frames die with the caller's ``defs`` list).  Ids are
        assigned sequentially and emission is serialized, so popping
        in reverse restores the table exactly."""
        for text in reversed(added):
            del self._ids[text]
            self._next_id -= 1

    # -- the never-fails fallback ---------------------------------------

    def encode_json(self, record: dict) -> bytes:
        """Any record as chunked framed JSON: rare events stay
        CRC-protected and torn-tail-isolated without needing a
        fixed layout.  A chunk shorter than the payload capacity
        terminates the record; an exact-multiple body gets one
        empty terminating continuation."""
        raw = json.dumps(record).encode("utf-8")  # jsonl-ok: framed K_JSON
        out = []
        kind = K_JSON
        for start in range(0, len(raw), PAYLOAD_BYTES):
            out.append(frame(kind, raw[start:start + PAYLOAD_BYTES]))
            kind = K_CONT
        if len(raw) % PAYLOAD_BYTES == 0:
            out.append(frame(K_CONT if out else K_JSON, b""))
        return b"".join(out)

    # -- fixed-width codecs ---------------------------------------------

    def encode_bump(self, t, host, name, labels, n,
                    seq) -> Optional[bytes]:
        """One counter bump straight from its arguments — the armed
        hot path's no-dict encode (tracer ``_on_bump`` outside any
        trace context).  Steady state is two memo hits and one
        ``struct.pack``; None means the bump needs the full record
        path (odd types, uninternable strings)."""
        if not (_is_real(t) and _is_real(n) and _is_u32(seq)
                and type(name) is str and type(labels) is str):
            return None
        defs: List[bytes] = []
        added: List[str] = []
        memo_key = None
        ids = self._bump_memo.get((name, labels))
        if ids is None:
            name_id = self._intern(name, defs, added)
            labels_id = self._intern(labels, defs, added)
            if name_id is None or labels_id is None:
                self._rollback(added)
                return None
            ids = (name_id, labels_id)
            memo_key = (name, labels)
        host_id = (self._intern(host, defs, added)
                   if type(host) is str else None)
        if host_id is None:
            self._rollback(added)
            return None
        flags = ((_F_T_INT if type(t) is int else 0)
                 | (_F_N_INT if type(n) is int else 0))
        try:
            body = _COUNTER.pack(t, seq, host_id, ids[0], ids[1],
                                 n, flags)
        except (struct.error, OverflowError):
            # e.g. an int clock/delta too large for f8: the record
            # rides K_JSON, exactly — never widened, never raised
            self._rollback(added)
            return None
        if memo_key is not None:
            self._bump_memo[memo_key] = ids
        defs.append(frame(K_COUNTER, body))
        return b"".join(defs)

    def _encode_counter(self, record: dict) -> Optional[bytes]:
        if len(record) != 7:
            return None  # a ctx-bearing (or widened) bump: K_JSON
        return self.encode_bump(
            record.get("t"), record.get("host"), record.get("name"),
            record.get("labels"), record.get("n"),
            record.get("seq"))

    def _encode_twin_window(self, record: dict) -> Optional[bytes]:
        if len(record) != 7:
            return None
        t = record.get("t")
        window = record.get("window")
        window_ms = record.get("window_ms")
        seq = record.get("seq")
        host = record.get("host")
        if not (_is_real(t) and _is_real(window_ms) and _is_u32(seq)
                and _is_u32(window) and type(host) is str):
            return None
        defs: List[bytes] = []
        added: List[str] = []
        host_id = self._intern(host, defs, added)
        if host_id is None:
            return None
        flags = ((_F_T_INT if type(t) is int else 0)
                 | (_F_WMS_INT if type(window_ms) is int else 0))
        try:
            body = _TWIN_WINDOW.pack(t, seq, host_id, window,
                                     window_ms, flags)
        except (struct.error, OverflowError):
            self._rollback(added)
            return None
        defs.append(frame(K_TWIN_WINDOW, body))
        return b"".join(defs)

    _SLO_KEYS = frozenset((
        "t", "host", "kind", "name", "seq", "slo", "metric",
        "quantile", "value", "good", "burn_fast", "burn_slow",
        "budget_remaining", "firing", "window", "t_s"))

    def _encode_slo_window(self, record: dict) -> Optional[bytes]:
        if record.keys() != self._SLO_KEYS:
            return None
        t = record.get("t")
        seq = record.get("seq")
        slo = record.get("slo")
        metric = record.get("metric")
        quantile = record.get("quantile")
        value = record.get("value")
        good = record.get("good")
        firing = record.get("firing")
        window = record.get("window")
        host = record.get("host")
        if not (_is_real(t) and _is_u32(seq) and _is_u32(window)
                and type(slo) is str and type(metric) is str
                and type(host) is str
                and (quantile is None or type(quantile) is str)
                and (value is None or type(value) is float)
                and (good is None or type(good) is bool)
                and type(firing) is bool
                and type(record.get("burn_fast")) is float
                and type(record.get("burn_slow")) is float
                and type(record.get("budget_remaining")) is float
                and type(record.get("t_s")) is float):
            return None
        defs: List[bytes] = []
        added: List[str] = []
        host_id = self._intern(host, defs, added)
        slo_id = self._intern(slo, defs, added)
        metric_id = self._intern(metric, defs, added)
        quantile_id = (0 if quantile is None
                       else self._intern(quantile, defs, added))
        if None in (host_id, slo_id, metric_id, quantile_id):
            self._rollback(added)
            return None
        flags = ((_F_T_INT if type(t) is int else 0)
                 | (_F_FIRING if firing else 0)
                 | (_F_GOOD_SET if good is not None else 0)
                 | (_F_GOOD_TRUE if good else 0)
                 | (_F_VALUE_SET if value is not None else 0))
        try:
            body = _SLO_WINDOW.pack(
                t, seq, host_id, slo_id, metric_id, quantile_id,
                window, value if value is not None else 0.0,
                record["burn_fast"], record["burn_slow"],
                record["budget_remaining"], record["t_s"], flags)
        except (struct.error, OverflowError):
            self._rollback(added)
            return None
        defs.append(frame(K_SLO_WINDOW, body))
        return b"".join(defs)

    # -- dispatch --------------------------------------------------------

    def encode(self, record: dict) -> bytes:
        """One record → its framed bytes (fixed-width when a codec
        matches exactly, chunked JSON otherwise).  Never raises on
        record shape: the fallback is total."""
        kind = record.get("kind")
        encoded = None
        if kind == "counter":
            encoded = self._encode_counter(record)
        elif kind == "mark":
            name = record.get("name")
            if name == "twin_window":
                encoded = self._encode_twin_window(record)
            elif name == "slo_window":
                encoded = self._encode_slo_window(record)
        if encoded is None:
            return self.encode_json(record)
        return encoded


def _resync(data, start: int, limit: int) -> int:
    """First offset ≥ ``start`` that begins a VERIFIABLE record: a
    complete frame whose CRC checks, or a newline followed by a
    JSON-looking line start.  Used after a corrupt frame or
    unparsable line so one flipped bit costs one counted record —
    scanning candidates instead of trusting the next MAGIC byte is
    what stops a corrupted payload byte from desynchronizing the
    stream.  Returns ``limit`` when nothing verifiable remains."""
    pos = start
    while pos < limit:
        magic_at = data.find(_MAGIC_B, pos, limit)
        nl_at = data.find(b"\n", pos, limit)
        if magic_at < 0 and nl_at < 0:
            return limit
        if magic_at >= 0 and (nl_at < 0 or magic_at < nl_at):
            candidate = magic_at
            if candidate + FRAME_BYTES <= limit:
                body = data[candidate + 1:
                            candidate + FRAME_BYTES - _CRC.size]
                (crc,) = _CRC.unpack_from(data,
                                          candidate + FRAME_BYTES
                                          - _CRC.size)
                if zlib.crc32(bytes(body)) == crc:
                    return candidate
                pos = candidate + 1
                continue
            # partial candidate frame at the tail: resume here so an
            # incremental reader can verify it once the bytes land
            return candidate
        # newline candidate: accept only when the next byte opens a
        # JSON object (every text-tier record is a dict, so a real
        # record line starts with "{"); a MAGIC byte is left for the
        # frame branch to verify, and anything else is more of the
        # same corruption episode — skipping it instead of resyncing
        # onto garbage text is what keeps one episode at ONE count
        if nl_at + 1 < limit and data[nl_at + 1] == ord("{"):
            return nl_at + 1
        pos = nl_at + 1
    return limit


def _verified_frame(data, start: int, end: int, limit: int) -> int:
    """First offset in ``[start, end)`` that begins a COMPLETE frame
    with a valid CRC (the frame body may extend past ``end``, up to
    ``limit``); -1 when none.  The text tier's rescue scan: the
    recorder's JSONL is ``ensure_ascii`` so a magic byte inside a
    would-be line is proof the line head was corrupted binary — the
    verified frame is where the stream provably resynchronizes."""
    pos = start
    while True:
        magic_at = data.find(_MAGIC_B, pos, end)
        if magic_at < 0:
            return -1
        if magic_at + FRAME_BYTES <= limit:
            body = bytes(data[magic_at + 1:
                              magic_at + FRAME_BYTES - _CRC.size])
            (crc,) = _CRC.unpack_from(data, magic_at + FRAME_BYTES
                                      - _CRC.size)
            if zlib.crc32(body) == crc:
                return magic_at
        pos = magic_at + 1


class DecodeStats:
    """Counts one decoder accumulated: ``bad_records`` (CRC
    failures, unparsable lines, unresolvable string ids — each
    isolated corruption episode counts ONCE), ``torn`` (incomplete
    tail present at finish), ``records`` (successfully decoded)."""

    __slots__ = ("bad_records", "torn", "records")

    def __init__(self):
        self.bad_records = 0
        self.torn = 0
        self.records = 0

    def as_dict(self) -> dict:
        return {"bad_records": self.bad_records, "torn": self.torn,
                "records": self.records}


class RecordDecoder:
    """The incremental dict-tier reader: feed it byte chunks in file
    order (any split — a tail-follower's polls, or one whole file)
    and complete records come back as the EXACT dicts the JSONL path
    would have parsed.  Incomplete tails (partial frame, unfinished
    JSON chunk sequence, line missing its newline) stay buffered
    until their bytes arrive; :meth:`finish` declares the stream
    over and counts whatever is still pending as the torn tail."""

    def __init__(self):
        self._buf = bytearray()
        self._strings: Dict[int, str] = {}
        self._pending_json: Optional[bytearray] = None
        self.stats = DecodeStats()

    # -- fixed-codec reconstruction -------------------------------------

    def _string(self, ident: int) -> Optional[str]:
        return self._strings.get(ident)

    def _decode_fixed(self, kind: int, payload: bytes
                      ) -> Optional[dict]:
        """One verified fixed-width frame → its record dict (None =
        undecodable content: wrong payload size for the kind, or a
        string id whose definition frame was lost — counted by the
        caller, never raised)."""
        if kind == K_COUNTER:
            if len(payload) != _COUNTER.size:
                return None
            (t, seq, host_id, name_id, labels_id, n,
             flags) = _COUNTER.unpack(payload)
            host = self._string(host_id)
            name = self._string(name_id)
            labels = self._string(labels_id)
            if host is None or name is None or labels is None:
                return None
            if flags & _F_T_INT:
                t = int(t)
            if flags & _F_N_INT:
                n = int(n)
            return {"t": t, "host": host, "kind": "counter",
                    "name": name, "labels": labels, "n": n,
                    "seq": seq}
        if kind == K_TWIN_WINDOW:
            if len(payload) != _TWIN_WINDOW.size:
                return None
            (t, seq, host_id, window, window_ms,
             flags) = _TWIN_WINDOW.unpack(payload)
            host = self._string(host_id)
            if host is None:
                return None
            if flags & _F_T_INT:
                t = int(t)
            if flags & _F_WMS_INT:
                window_ms = int(window_ms)
            return {"t": t, "host": host, "kind": "mark",
                    "name": "twin_window", "window": window,
                    "window_ms": window_ms, "seq": seq}
        if kind == K_SLO_WINDOW:
            if len(payload) != _SLO_WINDOW.size:
                return None
            (t, seq, host_id, slo_id, metric_id, quantile_id,
             window, value, burn_fast, burn_slow, budget_remaining,
             t_s, flags) = _SLO_WINDOW.unpack(payload)
            host = self._string(host_id)
            slo = self._string(slo_id)
            metric = self._string(metric_id)
            quantile = (None if quantile_id == 0
                        else self._string(quantile_id))
            if (host is None or slo is None or metric is None
                    or (quantile_id != 0 and quantile is None)):
                return None
            if flags & _F_T_INT:
                t = int(t)
            return {"t": t, "host": host, "kind": "mark",
                    "name": "slo_window", "slo": slo,
                    "metric": metric, "quantile": quantile,
                    "value": (value if flags & _F_VALUE_SET
                              else None),
                    "good": (bool(flags & _F_GOOD_TRUE)
                             if flags & _F_GOOD_SET else None),
                    "burn_fast": burn_fast, "burn_slow": burn_slow,
                    "budget_remaining": budget_remaining,
                    "firing": bool(flags & _F_FIRING),
                    "window": window, "t_s": t_s, "seq": seq}
        return None

    def _finish_json(self) -> Optional[dict]:
        raw = bytes(self._pending_json)
        self._pending_json = None
        try:
            record = json.loads(raw)
        except ValueError:
            return None
        return record if isinstance(record, dict) else None

    # -- the scan --------------------------------------------------------

    def feed(self, data) -> List[dict]:
        """Consume ``data`` (bytes-like) appended after everything
        previously fed; returns the records that became complete."""
        if data:
            self._buf.extend(data)
        buf = self._buf
        limit = len(buf)
        pos = 0
        out: List[dict] = []
        while pos < limit:
            lead = buf[pos]
            if lead == MAGIC:
                if pos + FRAME_BYTES > limit:
                    break  # partial frame: wait for its bytes
                body = bytes(buf[pos + 1:
                                 pos + FRAME_BYTES - _CRC.size])
                (crc,) = _CRC.unpack_from(buf, pos + FRAME_BYTES
                                          - _CRC.size)
                if zlib.crc32(body) != crc:
                    self.stats.bad_records += 1
                    nxt = _resync(buf, pos + 1, limit)
                    if nxt + FRAME_BYTES > limit \
                            and nxt < limit and buf[nxt] == MAGIC:
                        pos = nxt
                        break  # unverified partial at tail: wait
                    pos = nxt
                    continue
                kind, length = _HEADER.unpack_from(body, 0)
                if length > PAYLOAD_BYTES:
                    self.stats.bad_records += 1
                    pos += FRAME_BYTES
                    continue
                payload = body[_HEADER.size:_HEADER.size + length]
                pos += FRAME_BYTES
                if kind == K_STR:
                    if length >= _STR_DEF.size:
                        (ident,) = _STR_DEF.unpack_from(payload, 0)
                        try:
                            self._strings[ident] = \
                                payload[_STR_DEF.size:].decode(
                                    "utf-8")
                            continue
                        except UnicodeDecodeError:
                            pass
                    self.stats.bad_records += 1
                elif kind == K_JSON:
                    if self._pending_json is not None:
                        # a new record began before the previous
                        # chunk sequence terminated: the tail of the
                        # old one was lost — count it, keep going
                        self.stats.bad_records += 1
                    self._pending_json = bytearray(payload)
                    if length < PAYLOAD_BYTES:
                        record = self._finish_json()
                        if record is None:
                            self.stats.bad_records += 1
                        else:
                            self.stats.records += 1
                            out.append(record)
                elif kind == K_CONT:
                    if self._pending_json is None:
                        self.stats.bad_records += 1
                        continue
                    self._pending_json.extend(payload)
                    if length < PAYLOAD_BYTES:
                        record = self._finish_json()
                        if record is None:
                            self.stats.bad_records += 1
                        else:
                            self.stats.records += 1
                            out.append(record)
                else:
                    record = self._decode_fixed(kind, payload)
                    if record is None:
                        self.stats.bad_records += 1
                    else:
                        self.stats.records += 1
                        out.append(record)
                continue
            # text tier: one JSONL line
            nl = buf.find(b"\n", pos)
            if nl < 0:
                # no newline yet: a growing text line waits — unless
                # a VERIFIED frame begins inside the pending bytes,
                # which proves the head is corrupted binary (ASCII
                # JSONL cannot contain the magic byte): count the
                # garbage once and resynchronize there
                rescue = _verified_frame(buf, pos + 1, limit, limit)
                if rescue >= 0:
                    self.stats.bad_records += 1
                    pos = rescue
                    continue
                break  # line still growing: wait for its newline
            line = bytes(buf[pos:nl]).strip()
            if not line:
                pos = nl + 1
                continue
            try:
                record = json.loads(line)
            except ValueError:
                self.stats.bad_records += 1
                # the failed "line" may be a corrupted frame whose
                # magic byte was hit: resync at a verified frame
                # inside it rather than blindly skipping to the
                # newline (which can sit mid-frame in binary data)
                rescue = _verified_frame(buf, pos + 1, nl, limit)
                pos = rescue if rescue >= 0 else nl + 1
                continue
            pos = nl + 1
            if isinstance(record, dict):
                self.stats.records += 1
                out.append(record)
            else:
                self.stats.bad_records += 1
        del buf[:pos]
        return out

    def finish(self) -> List[dict]:
        """Declare end-of-stream: anything still buffered (partial
        frame, headless line, unterminated chunk sequence) is the
        torn tail — counted, discarded, never raised.  One
        exception, for :func:`~.artifact_cache.read_jsonl_tolerant`
        parity: a COMPLETE text record whose writer merely never got
        to the newline still parses, and is returned rather than
        counted torn."""
        out: List[dict] = []
        if self._buf:
            tail = bytes(self._buf)
            self._buf.clear()
            record = None
            if tail[0] != MAGIC:
                try:
                    record = json.loads(tail)
                except ValueError:
                    record = None
            if isinstance(record, dict):
                self.stats.records += 1
                out.append(record)
            else:
                self.stats.torn += 1
        if self._pending_json is not None:
            self.stats.torn += 1
            self._pending_json = None
        return out


def read_records(path: str) -> Tuple[List[dict], DecodeStats]:
    """Batch-read one shard (binary, JSONL, or mixed) into its
    record dicts — the format-sniffing reader behind
    ``tracer.read_shard``, so every existing consumer reads new
    shards with zero call-site changes."""
    decoder = RecordDecoder()
    with open(path, "rb") as fh:
        records = decoder.feed(fh.read())
    records.extend(decoder.finish())
    return records, decoder.stats


# -- the columnar tier ---------------------------------------------------

class FrameColumns:
    """One shard's twin-plane view as numpy columns: counter bumps
    (stream position, clock, interned name/labels ids, delta) and
    ``twin_window`` marks (position, clock, window_ms), plus the
    leftover dict-tier records (rare kinds, JSONL lines) with their
    positions — everything :func:`~.twinframe.frames_from_shards`'
    vectorized reducer needs, nothing it does not (slo marks, spans
    and leases are never even dict-decoded on this path)."""

    __slots__ = ("meta", "strings", "ctr_pos", "ctr_t", "ctr_name",
                 "ctr_labels", "ctr_n", "mark_pos", "mark_t",
                 "mark_window_ms", "py_events", "stats", "n_records")

    def __init__(self, meta, strings, ctr_pos, ctr_t, ctr_name,
                 ctr_labels, ctr_n, mark_pos, mark_t, mark_window_ms,
                 py_events, stats, n_records):
        self.meta = meta
        self.strings = strings
        self.ctr_pos = ctr_pos
        self.ctr_t = ctr_t
        self.ctr_name = ctr_name
        self.ctr_labels = ctr_labels
        self.ctr_n = ctr_n
        self.mark_pos = mark_pos
        self.mark_t = mark_t
        self.mark_window_ms = mark_window_ms
        self.py_events = py_events
        self.stats = stats
        self.n_records = n_records


#: below this many frames the 83 fixed-cost numpy steps of the
#: column-wise CRC cost more than n calls into zlib's C loop —
#: measured crossover is ~1k rows on CPython 3.10
_CRC_SCALAR_MAX = 1024


def _crc32_rows_scalar(np, data, offset, n_frames):
    """Per-row ``zlib.crc32`` over the body slices — the small-run
    twin of :func:`_crc32_columns` (same bytes, same answer), where
    n C calls beat 83 whole-array numpy steps."""
    step = FRAME_BYTES
    stop = FRAME_BYTES - _CRC.size
    crc32 = zlib.crc32
    view = memoryview(data)
    return np.fromiter(
        (crc32(view[pos + 1:pos + stop])
         for pos in range(offset, offset + n_frames * step, step)),
        dtype=np.uint32, count=n_frames)


def _crc32_columns(np, matrix):
    """Vectorized CRC-32 of every row's ``body`` slice (columns
    1..83): the classic one-byte-per-step table recurrence, run
    column-wise so each of the 83 steps is a whole-array gather +
    xor instead of n Python iterations.  Matches ``zlib.crc32``
    bit-for-bit (same polynomial, init, and final inversion)."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (0xEDB88320 if crc & 1 else 0)
            table.append(crc)
        _CRC_TABLE = np.asarray(table, dtype=np.uint32)
    crc = np.full(matrix.shape[0], 0xFFFFFFFF, dtype=np.uint32)
    for col in range(1, FRAME_BYTES - _CRC.size):
        crc = (_CRC_TABLE[(crc ^ matrix[:, col]) & 0xFF]
               ^ (crc >> np.uint32(8)))
    return crc ^ np.uint32(0xFFFFFFFF)


_CRC_TABLE = None


def _column(np, rows, start, stop, dtype):
    """One fixed payload field across a frame subset, as a numpy
    array (contiguous copy then reinterpret — the rows themselves
    are strided views into the (n, 88) matrix)."""
    return np.ascontiguousarray(rows[:, start:stop]).view(
        dtype).reshape(-1)


def frame_columns(path: str) -> Optional["FrameColumns"]:
    """Decode one shard STRAIGHT to columns (mmap-friendly single
    read, no per-record dicts for the hot kinds).  Returns None when
    numpy is unavailable — callers fall back to the dict tier, which
    is always correct."""
    try:
        import mmap

        import numpy as np
    except ImportError:      # pragma: no cover - numpy is baked in
        return None
    stats = DecodeStats()
    with open(path, "rb") as fh:
        try:
            buf = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:
            return _columns_from_buffer(np, b"", stats)
        try:
            # the frame matrix is sliced straight off the mapping;
            # every extracted column is a copy (fancy indexing /
            # ascontiguousarray / concatenate), so nothing outlives
            # the map
            return _columns_from_buffer(np, buf, stats)
        finally:
            buf.close()


def columns_from_bytes(data: bytes) -> Optional["FrameColumns"]:
    """The in-memory twin of :func:`frame_columns` (tests, and any
    consumer already holding the shard bytes)."""
    try:
        import numpy as np
    except ImportError:      # pragma: no cover - numpy is baked in
        return None
    return _columns_from_buffer(np, data, DecodeStats())


def _columns_from_buffer(np, data: bytes, stats: DecodeStats
                         ) -> "FrameColumns":
    meta = None
    strings: Dict[int, str] = {}
    py_events: List[Tuple[int, dict]] = []
    ctr_chunks = []          # (pos, t, name, labels, n) arrays
    mark_rows: List[Tuple[int, float, float]] = []
    decoder = RecordDecoder()
    decoder._strings = strings  # share the table across tiers
    pos_base = 0             # monotone stream position
    limit = len(data)
    offset = 0
    while offset < limit:
        if data[offset] != MAGIC:
            # text segment: scan to the start of the next frame run.
            # Frames only ever begin where a record could (after a
            # newline), so the next "\n" + MAGIC pair bounds it.
            end = limit
            scan = offset
            while True:
                nl = data.find(b"\n", scan)
                if nl < 0:
                    break
                if nl + 1 < limit and data[nl + 1] == MAGIC:
                    end = nl + 1
                    break
                scan = nl + 1
            records = decoder.feed(data[offset:end])
            if end == limit:
                records.extend(decoder.finish())
            for record in records:
                if record.get("kind") == "meta" and meta is None:
                    meta = record
                    pos_base += 1
                    continue
                _bucket_record(record, pos_base, mark_rows,
                               py_events)
                pos_base += 1
            offset = end
            continue
        # frame run: fixed stride until the lead byte stops matching
        run_end = offset
        while run_end + FRAME_BYTES <= limit \
                and data[run_end] == MAGIC:
            run_end += FRAME_BYTES
        n_frames = (run_end - offset) // FRAME_BYTES
        if n_frames == 0:
            # partial frame at the tail (or a lone MAGIC byte in
            # what should be text): dict tier settles it
            records = decoder.feed(data[offset:limit])
            records.extend(decoder.finish())
            for record in records:
                _bucket_record(record, pos_base, mark_rows,
                               py_events)
                pos_base += 1
            offset = limit
            continue
        matrix = np.frombuffer(data, dtype=np.uint8,
                               count=n_frames * FRAME_BYTES,
                               offset=offset).reshape(
                                   n_frames, FRAME_BYTES)
        stored = _column(np, matrix, FRAME_BYTES - _CRC.size,
                         FRAME_BYTES, "<u4")
        computed = (_crc32_rows_scalar(np, data, offset, n_frames)
                    if n_frames < _CRC_SCALAR_MAX
                    else _crc32_columns(np, matrix))
        ok = stored == computed
        if not ok.all():
            # corruption inside the run: hand the whole run to the
            # dict tier, whose resync logic counts each episode once
            records = decoder.feed(data[offset:run_end])
            if run_end == limit:
                records.extend(decoder.finish())
            stats.bad_records += decoder.stats.bad_records
            decoder.stats.bad_records = 0
            for record in records:
                _bucket_record(record, pos_base, mark_rows,
                               py_events)
                pos_base += 1
            offset = run_end
            continue
        kinds = matrix[:, 1]
        positions = pos_base + np.arange(n_frames, dtype=np.int64)
        pos_base += n_frames
        # hot column extraction: counters
        cmask = kinds == K_COUNTER
        # every CRC-verified hot frame is one decoded record —
        # K_SLO_WINDOW included even though the frame reducer never
        # consumes it, for stat parity with the dict tier
        stats.records += int(cmask.sum()) \
            + int((kinds == K_TWIN_WINDOW).sum()) \
            + int((kinds == K_SLO_WINDOW).sum())
        if cmask.any():
            crows = matrix[cmask]
            ctr_chunks.append((
                positions[cmask],
                _column(np, crows, 4, 12, "<f8"),
                _column(np, crows, 20, 24, "<u4"),
                _column(np, crows, 24, 28, "<u4"),
                _column(np, crows, 28, 36, "<f8")))
        wmask = kinds == K_TWIN_WINDOW
        if wmask.any():
            wrows = matrix[wmask]
            wt = _column(np, wrows, 4, 12, "<f8")
            wms = _column(np, wrows, 24, 32, "<f8")
            for row_i, row_pos in enumerate(
                    positions[wmask].tolist()):
                mark_rows.append((row_pos, float(wt[row_i]),
                                  float(wms[row_i])))
        # the rare kinds stay per-row Python (strdefs: a handful per
        # shard; K_JSON: rare by construction; slo marks: skipped —
        # the frame reducer never consumes them)
        rare = ~(cmask | wmask | (kinds == K_SLO_WINDOW))
        if rare.any():
            lens = _column(np, matrix, 2, 4, "<u2")
            for row_i in np.nonzero(rare)[0].tolist():
                kind = int(kinds[row_i])
                length = int(lens[row_i])
                if length > PAYLOAD_BYTES:
                    stats.bad_records += 1
                    continue
                payload = bytes(matrix[row_i,
                                       4:4 + length].tobytes())
                if kind == K_STR:
                    if length >= _STR_DEF.size:
                        (ident,) = _STR_DEF.unpack_from(payload, 0)
                        try:
                            strings[ident] = \
                                payload[_STR_DEF.size:].decode(
                                    "utf-8")
                            continue
                        except UnicodeDecodeError:
                            pass
                    stats.bad_records += 1
                elif kind == K_JSON:
                    if decoder._pending_json is not None:
                        stats.bad_records += 1
                    decoder._pending_json = bytearray(payload)
                    if length < PAYLOAD_BYTES:
                        record = decoder._finish_json()
                        if record is None:
                            stats.bad_records += 1
                        else:
                            stats.records += 1
                            _bucket_record(
                                record, int(positions[row_i]),
                                mark_rows, py_events)
                elif kind == K_CONT:
                    if decoder._pending_json is None:
                        stats.bad_records += 1
                        continue
                    decoder._pending_json.extend(payload)
                    if length < PAYLOAD_BYTES:
                        record = decoder._finish_json()
                        if record is None:
                            stats.bad_records += 1
                        else:
                            stats.records += 1
                            _bucket_record(
                                record, int(positions[row_i]),
                                mark_rows, py_events)
                else:
                    stats.bad_records += 1
        offset = run_end
    stats.bad_records += decoder.stats.bad_records
    stats.torn += decoder.stats.torn
    stats.records += decoder.stats.records
    if decoder._pending_json is not None:
        stats.torn += 1
    if ctr_chunks:
        ctr_pos = np.concatenate([c[0] for c in ctr_chunks])
        ctr_t = np.concatenate([c[1] for c in ctr_chunks])
        ctr_name = np.concatenate([c[2] for c in ctr_chunks])
        ctr_labels = np.concatenate([c[3] for c in ctr_chunks])
        ctr_n = np.concatenate([c[4] for c in ctr_chunks])
    else:
        ctr_pos = np.zeros(0, dtype=np.int64)
        ctr_t = np.zeros(0, dtype=np.float64)
        ctr_name = np.zeros(0, dtype=np.uint32)
        ctr_labels = np.zeros(0, dtype=np.uint32)
        ctr_n = np.zeros(0, dtype=np.float64)
    mark_rows.sort(key=lambda row: row[0])
    mark_pos = np.asarray([row[0] for row in mark_rows],
                          dtype=np.int64)
    mark_t = np.asarray([row[1] for row in mark_rows],
                        dtype=np.float64)
    mark_window_ms = np.asarray([row[2] for row in mark_rows],
                                dtype=np.float64)
    return FrameColumns(meta, strings, ctr_pos, ctr_t, ctr_name,
                        ctr_labels, ctr_n, mark_pos, mark_t,
                        mark_window_ms, py_events, stats, pos_base)


def _bucket_record(record: dict, pos: int, mark_rows,
                   py_events) -> None:
    """Route one dict-tier record into the columnar view: window
    marks join the mark columns (their clock is the partition key),
    everything else keeps its dict with its position."""
    if record.get("kind") == "mark" \
            and record.get("name") == "twin_window":
        mark_rows.append((pos, record.get("t", 0.0),
                          record.get("window_ms", 0.0)))
        return
    py_events.append((pos, record))
