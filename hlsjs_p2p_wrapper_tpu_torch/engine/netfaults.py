# A copy of the reference's engine/netfaults.py
# (hlsjs_p2p_wrapper_tpu/engine/netfaults.py): the same names, formats and
# bytes; the imports point at the port's own modules, and a few comments no
# longer cite the reference's history.
"""Socket-level fault plane for the peer transports.

The dispatch plane got its chaos reflex first (engine/faults.py:
deterministic ``kind@group:chunk`` injection through the SAME
classifier real XLA faults flow through) and the tracker got its churn
generator next.  The wire had neither: every chaos knob lived in
the loopback simulator (``engine/transport.py`` loss/latency/
partition), which the real handshake/framing/reader/writer code paths
in ``engine/net.py`` never execute under.  This module closes that
gap with one deterministic plan both fabrics consume:

- :class:`NetFaultPlan` — a seeded schedule in the ``kind@where[xN]``
  grammar of :class:`~.faults.FaultPlan`, where ``where`` is either an
  **operation index** (the Nth outbound connect, the Nth
  post-handshake frame send) or a **time window** ``t0-t1`` in seconds
  on the injected clock (VirtualClock in harnesses, the NetLoop's
  monotonic clock on real sockets).
- On the TCP fabric the plan rides a **socket shim**
  (:class:`FaultSocket`, installed by ``TcpNetwork(fault_plan=...)``)
  so the *real* connect/handshake/framing/reader/writer paths run
  under: connect refusal (``refuse``), handshake stall (``stall``),
  mid-frame RST (``rst``), partial-write-then-stall (``partial``),
  frame corruption (``corrupt`` → the existing per-frame MAC drop),
  and ``blackhole`` / ``latency`` windows.
- On the loopback fabric (``LoopbackNetwork(fault_plan=...)``) the
  same plan drives the existing knobs: ``loss`` windows drop frames
  through the seeded RNG, ``partition`` windows block a deterministic
  fraction of peer pairs, ``latency`` windows add delay.

Every injected fault is COUNTED into the shared registry as
``mesh.transport_faults{kind=...}`` — the join key the net chaos gate
(``tools/net_chaos_gate.py``) uses to assert that every injected
fault class maps to at least one counted recovery action
(``net.reconnects`` / ``net.circuit`` / ``net.mac_drops`` /
``net.send_drops``).  :meth:`NetFaultPlan.schedule` is the
deterministic fired-spec log two same-seed runs must agree on.
"""

from __future__ import annotations

import random
import socket
import threading
import time
import zlib
from typing import Optional

from .telemetry import MetricsRegistry

#: operation-indexed kinds: fire on the Nth matching socket operation
REFUSE = "refuse"      # outbound connect raises ConnectionRefusedError
STALL = "stall"        # connect succeeds; every op then stalls to the
#                        caller's deadline (the byte-dribbler model)
RST = "rst"            # frame send tears mid-record (half sent, reset)
PARTIAL = "partial"    # frame send writes half, then wedges until the
#                        socket is torn down (half-open probe fodder)
CORRUPT = "corrupt"    # one payload byte flipped → receiver MAC drop
#: window kinds: active while plan-clock time is inside ``t0-t1``
BLACKHOLE = "blackhole"  # sends swallowed whole, reads held
LATENCY = "latency"      # fixed extra delay on every op / delivery
LOSS = "loss"            # loopback: seeded frame drops
PARTITION = "partition"  # loopback: deterministic pair blocking

CONNECT_KINDS = (REFUSE, STALL)
SEND_KINDS = (RST, PARTIAL, CORRUPT)
WINDOW_KINDS = (BLACKHOLE, LATENCY, LOSS, PARTITION)
NET_FAULT_KINDS = CONNECT_KINDS + SEND_KINDS + WINDOW_KINDS


class NetFaultPlan:
    """Deterministic socket-fault schedule (module docstring).

    ``specs`` mix two shapes, mirroring :class:`~.faults.FaultPlan`:

    - ``{"kind", "at", "count"}`` — fire on operation indices
      ``[at, at + count)`` of the kind's domain (connect ops for
      ``refuse``/``stall``, armed frame sends for
      ``rst``/``partial``/``corrupt``);
    - ``{"kind", "t0", "t1"}`` — active while ``t0 <= t < t1``
      seconds since :meth:`arm` on the injected clock.

    ``clock`` is anything with a ``.now()`` returning milliseconds
    (VirtualClock, NetLoop); ``None`` falls back to wall monotonic
    time.  ``registry`` receives one
    ``mesh.transport_faults{kind=...}`` bump per injected fault; a
    private registry keeps call sites unconditional (the telemetry
    module's convention).  The ``seed`` drives ONLY payload choices
    (loss draws, corrupt byte position) — which spec fires where is
    pure arithmetic, so :meth:`schedule` is run-stable.
    """

    def __init__(self, specs, *, seed: int = 0, clock=None,
                 registry: Optional[MetricsRegistry] = None,
                 latency_ms: float = 150.0, loss_rate: float = 0.2,
                 partition_fraction: float = 0.3):
        self.specs = []
        for spec in specs:
            spec = dict(spec)
            if spec["kind"] not in NET_FAULT_KINDS:
                raise ValueError(f"unknown net fault kind "
                                 f"{spec['kind']!r} (one of "
                                 f"{NET_FAULT_KINDS})")
            if "t0" in spec:
                if spec["kind"] not in WINDOW_KINDS:
                    raise ValueError(f"{spec['kind']!r} takes an op "
                                     f"index, not a time window")
                if not spec["t1"] > spec["t0"] >= 0.0:
                    raise ValueError(f"bad window {spec!r}")
            else:
                if spec["kind"] in WINDOW_KINDS:
                    raise ValueError(f"{spec['kind']!r} takes a time "
                                     f"window t0-t1, not an op index")
                spec.setdefault("count", 1)
                if spec["at"] < 0 or spec["count"] < 1:
                    raise ValueError(f"bad op spec {spec!r}")
            self.specs.append(spec)
        self.seed = seed
        self.latency_ms = float(latency_ms)
        self.loss_rate = float(loss_rate)
        self.partition_fraction = float(partition_fraction)
        self._clock = clock
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._epoch_ms: Optional[float] = None
        self._connects = 0
        self._sends = 0
        self._fired: list = []   # spec keys, first-fire order
        registry = registry if registry is not None else MetricsRegistry()
        self.registry = registry
        self._m_kinds = {kind: registry.counter("mesh.transport_faults",
                                                kind=kind)
                         for kind in NET_FAULT_KINDS}

    # -- grammar --------------------------------------------------------

    @classmethod
    def parse(cls, text: str, **kwargs) -> "NetFaultPlan":
        """``"refuse@0x2,rst@1,blackhole@2-4.5"`` → refuse connects 0
        and 1, tear frame send 1 mid-record, swallow/hold traffic
        between t=2 s and t=4.5 s (the ``kind@where[xN]`` grammar of
        engine/faults.py, with windows where time is the coordinate)."""
        specs = []
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                kind, coord = part.split("@")
                kind = kind.strip()
                if "-" in coord:
                    t0, t1 = coord.split("-")
                    specs.append({"kind": kind, "t0": float(t0),
                                  "t1": float(t1)})
                else:
                    count = 1
                    if "x" in coord:
                        coord, count = coord.rsplit("x", 1)
                    specs.append({"kind": kind, "at": int(coord),
                                  "count": int(count)})
            except (ValueError, IndexError):
                raise ValueError(
                    f"bad net fault spec {part!r} (want kind@OP[xN] or "
                    f"kind@T0-T1, kind one of {NET_FAULT_KINDS})") \
                    from None
        return cls(specs, **kwargs)

    # -- clock ----------------------------------------------------------

    def _now_ms(self) -> float:
        if self._clock is not None:
            return self._clock.now()
        return time.monotonic() * 1000.0

    def arm(self) -> None:
        """Zero the window epoch: ``t0``/``t1`` count from here.
        Idempotent; auto-armed on the first window query so plans on a
        VirtualClock need no explicit call."""
        with self._lock:
            if self._epoch_ms is None:
                self._epoch_ms = self._now_ms()

    def rearm(self) -> None:
        """FORCE a fresh window epoch, even if a query already
        auto-armed the plan.  For drivers whose setup traffic runs on
        the faulted fabric (every socket op queries the windows, so
        the first handshake arms the plan): call this when setup is
        done and the chaos windows should actually begin.  Windows
        already fired keep their counted record; their ``t0``/``t1``
        now measure from here."""
        with self._lock:
            self._epoch_ms = self._now_ms()

    def _elapsed_s(self) -> float:
        with self._lock:
            if self._epoch_ms is None:
                self._epoch_ms = self._now_ms()
            return (self._now_ms() - self._epoch_ms) / 1000.0

    # -- firing ---------------------------------------------------------

    def _spec_key(self, spec) -> str:
        if "t0" in spec:
            return f"{spec['kind']}@{spec['t0']:g}-{spec['t1']:g}"
        return f"{spec['kind']}@{spec['at']}" + (
            f"x{spec['count']}" if spec["count"] > 1 else "")

    def _fire(self, spec) -> str:
        key = self._spec_key(spec)
        with self._lock:
            if key not in self._fired:
                self._fired.append(key)
        self._m_kinds[spec["kind"]].inc()
        return spec["kind"]

    def _match_op(self, kinds, idx: int) -> Optional[str]:
        for spec in self.specs:
            if (spec["kind"] in kinds and "at" in spec
                    and spec["at"] <= idx < spec["at"] + spec["count"]):
                return self._fire(spec)
        return None

    def on_connect(self) -> Optional[str]:
        """Consulted once per outbound dial; returns ``refuse`` /
        ``stall`` / None for this connect index."""
        with self._lock:
            idx = self._connects
            self._connects += 1
        return self._match_op(CONNECT_KINDS, idx)

    def on_send(self) -> Optional[str]:
        """Consulted once per armed (post-handshake) frame send;
        returns ``rst`` / ``partial`` / ``corrupt`` / None."""
        with self._lock:
            idx = self._sends
            self._sends += 1
        return self._match_op(SEND_KINDS, idx)

    def in_window(self, kind: str, *, fire: bool = True) -> bool:
        """Is a ``kind`` window active now?  ``fire=True`` (the
        operation-affecting callers) counts the injection; peeking
        callers pass ``fire=False``."""
        t = self._elapsed_s()
        for spec in self.specs:
            if spec["kind"] == kind and "t0" in spec \
                    and spec["t0"] <= t < spec["t1"]:
                if fire:
                    self._fire(spec)
                return True
        return False

    def window_horizon_s(self) -> float:
        """Latest ``t1`` across window specs (0.0 with none) — how
        long a driver must keep the workload alive for every window
        to have been live."""
        return max((spec["t1"] for spec in self.specs if "t0" in spec),
                   default=0.0)

    # -- loopback drive --------------------------------------------------

    def drop_frame(self) -> bool:
        """Loopback loss: inside a ``loss`` window, drop with the
        plan's seeded RNG at ``loss_rate`` (deterministic on a
        VirtualClock fabric — one caller, one draw order)."""
        if not self.in_window(LOSS, fire=False):
            return False
        with self._lock:
            dropped = self._rng.random() < self.loss_rate
        if dropped:
            for spec in self.specs:
                if spec["kind"] == LOSS and "t0" in spec:
                    self._fire(spec)
                    break
        return dropped

    def link_blocked(self, src_id: str, dest_id: str) -> bool:
        """Loopback partition: inside a ``partition`` window, block a
        deterministic ``partition_fraction`` of ordered peer pairs —
        seed-stable hashing, no RNG draw, so which pairs go dark never
        depends on traffic order."""
        if not self.in_window(PARTITION, fire=False):
            return False
        basis = f"{self.seed}\x00{src_id}\x00{dest_id}".encode()
        if zlib.crc32(basis) % 1000 >= self.partition_fraction * 1000:
            return False
        for spec in self.specs:
            if spec["kind"] == PARTITION and "t0" in spec:
                self._fire(spec)
                break
        return True

    def extra_latency_ms(self) -> float:
        """Extra one-way delay while a ``latency`` window is active."""
        return self.latency_ms if self.in_window(LATENCY) else 0.0

    # -- shim payload helpers --------------------------------------------

    def corrupt_index(self, lo: int, hi: int) -> int:
        """Seeded byte position for a ``corrupt`` flip in ``[lo, hi)``."""
        with self._lock:
            return self._rng.randrange(lo, hi)

    # -- observability ----------------------------------------------------

    def schedule(self) -> list:
        """Spec keys that have fired, in first-fire order — the
        deterministic schedule two same-seed runs must agree on."""
        with self._lock:
            return list(self._fired)

    def remaining(self) -> list:
        """Spec keys that have never fired (gate precondition: a
        schedule that never ran is not evidence)."""
        fired = set(self.schedule())
        return [self._spec_key(spec) for spec in self.specs
                if self._spec_key(spec) not in fired]


class _FaultHold(BlockingIOError):
    """Non-blocking shim verdict: the operation is held by an active
    fault (injected stall / blackhole window).  The event-loop
    transport cannot sleep the way the blocking shim does, so instead
    of blocking it receives this exception, drops the relevant
    selector interest, and re-arms a timer for :attr:`retry_ms` —
    the non-blocking spelling of the blocking shim's poll tick."""

    def __init__(self, msg: str, retry_ms: float):
        super().__init__(msg)
        self.retry_ms = retry_ms


class FaultSocket:
    """The TCP shim: wraps a connected socket (or a ``_SafeTls``) and
    consults the plan on every operation the transport performs.
    Installed by ``TcpNetwork(fault_plan=...)`` AFTER any TLS wrap and
    BEFORE the identity handshake, so refusal/stall/latency exercise
    the real deadline discipline and rst/partial/corrupt exercise the
    real framing + MAC paths.

    Frame-send faults (``rst``/``partial``/``corrupt``) apply only
    once :meth:`arm_frames` is called (post-handshake), so a plan's
    send indices count protocol frames, not handshake records.

    Two I/O disciplines share this shim.  The blocking surface
    (``recv``/``sendall``) is what the thread-per-connection transport
    uses and is pinned byte-for-byte by tests.  The non-blocking
    surface (``setblocking``/``send``/``stage_frame`` plus ``recv``
    when the socket was set non-blocking) serves the event-loop
    transport: holds become :class:`_FaultHold` (a ``BlockingIOError``
    with a retry hint) instead of sleeps, and per-frame send faults
    are *staged* — the loop consults :meth:`stage_frame` once per
    framed record at flush start and enacts the verdict itself, since
    a partial-write wedge cannot block a shared loop thread."""

    #: tick used by injected stalls/holds so a torn-down socket frees
    #: the blocked thread promptly
    TICK_S = 0.05
    #: stall budget when the caller set no timeout (post-handshake
    #: sockets block freely; the probe/teardown is the way out)
    UNBOUNDED_STALL_S = 60.0

    def __init__(self, sock, plan: NetFaultPlan, *,
                 stalled: bool = False):
        self._sock = sock
        self._plan = plan
        self._stalled = stalled
        self._frames_armed = False
        self._timeout: Optional[float] = None
        self._closed = False
        self._nonblocking = False
        # one counted blackhole injection per hold EPISODE on the
        # non-blocking path (the loop re-polls recv every retry tick;
        # counting per call would make the counter wall-clock shaped)
        self._hole_counted = False

    # -- passthrough surface ---------------------------------------------

    def settimeout(self, value) -> None:
        self._timeout = value
        self._sock.settimeout(value)

    def setblocking(self, flag: bool) -> None:
        self._nonblocking = not flag
        self._sock.setblocking(flag)

    def getpeername(self):
        return self._sock.getpeername()

    def shutdown(self, how) -> None:
        self._closed = True
        self._sock.shutdown(how)

    def close(self) -> None:
        self._closed = True
        self._sock.close()

    def fileno(self):
        return self._sock.fileno()

    # -- fault machinery --------------------------------------------------

    def arm_frames(self) -> None:
        """Handshake complete: frame-send faults may fire from here."""
        self._frames_armed = True

    def _tick_until(self, deadline: float) -> None:
        while not self._closed and time.monotonic() < deadline:
            time.sleep(min(self.TICK_S, deadline - time.monotonic()))

    def _stall_out(self) -> None:
        """Block to the caller's current timeout budget, then expire —
        the injected byte-dribbler: the real deadline code path (not
        the fault plane) must be what cuts the operation off."""
        budget = (self._timeout if self._timeout is not None
                  else self.UNBOUNDED_STALL_S)
        self._tick_until(time.monotonic() + budget)
        raise socket.timeout("injected handshake stall")

    def _hold_blackhole(self) -> None:
        # ONE counted injection per held read; the poll ticks peek
        # (fire=False) so the counter stays a per-injection count,
        # not a wall-clock-dependent poll count
        self._plan.in_window(BLACKHOLE)
        deadline = time.monotonic() + (
            self._timeout if self._timeout is not None
            else self.UNBOUNDED_STALL_S)
        while (not self._closed
               and self._plan.in_window(BLACKHOLE, fire=False)
               and time.monotonic() < deadline):
            time.sleep(self.TICK_S)
        if not self._closed and time.monotonic() >= deadline:
            raise socket.timeout("blackhole window outlived timeout")

    def _maybe_delay(self) -> None:
        extra = self._plan.extra_latency_ms()
        if extra > 0.0:
            self._tick_until(time.monotonic() + extra / 1000.0)

    # -- faulted I/O -------------------------------------------------------

    def recv(self, n: int) -> bytes:
        if self._nonblocking:
            if self._stalled:
                raise _FaultHold("injected handshake stall",
                                 self.TICK_S * 1000.0)
            if self._plan.in_window(BLACKHOLE, fire=False):
                if not self._hole_counted:
                    self._hole_counted = True
                    self._plan.in_window(BLACKHOLE)  # count the injection
                raise _FaultHold("blackhole window",
                                 self.TICK_S * 1000.0)
            self._hole_counted = False
            return self._sock.recv(n)
        if self._stalled:
            self._stall_out()
        self._maybe_delay()
        if self._plan.in_window(BLACKHOLE, fire=False):
            self._hold_blackhole()
        return self._sock.recv(n)

    def sendall(self, data) -> None:
        if self._stalled:
            self._stall_out()
        self._maybe_delay()
        if self._plan.in_window(BLACKHOLE):
            return  # swallowed whole: the wire never sees the record
        kind = self._plan.on_send() if self._frames_armed else None
        if kind is None:
            # fault-free fast path: pass the caller's buffer through
            # untouched — the writer's single-copy join discipline
            # must survive the shim (a 64 MiB chunk memcpy'd again
            # per send would tax every chaos run's clean traffic)
            self._sock.sendall(data)
            return
        data = bytes(data)
        if kind == CORRUPT:
            # flip one payload byte past the 4-byte length prefix so
            # framing survives and the MAC layer is what rejects it
            mutated = bytearray(data)
            if len(mutated) > 4:
                mutated[self._plan.corrupt_index(4, len(mutated))] ^= 0x01
            self._sock.sendall(bytes(mutated))
            return
        half = data[:max(1, len(data) // 2)]
        try:
            self._sock.sendall(half)
        except OSError:
            pass  # fault-ok: the injected fault below is the outcome
        if kind == RST:
            raise ConnectionResetError("injected mid-frame reset")
        # PARTIAL: wedge until the connection is torn down around us
        # (the half-open shape the idle-probe deadline exists for)
        self._tick_until(time.monotonic() + self.UNBOUNDED_STALL_S)
        raise OSError("injected partial-write stall released")

    # -- non-blocking (event-loop) surface --------------------------------

    def send(self, data):
        """Non-blocking raw send for the loop transport's handshake
        and staged-frame bytes.  Frame faults are decided up front by
        :meth:`stage_frame`; here only the handshake-dial stall
        applies (latency/blackhole hold the READ side instead, which
        is what makes the handshake deadline bind)."""
        if self._stalled:
            raise _FaultHold("injected handshake stall",
                             self.TICK_S * 1000.0)
        return self._sock.send(data)

    def stage_frame(self, wire, *, delayed: bool = False):
        """Decide the fate of ONE framed record at flush start —
        the non-blocking mirror of :meth:`sendall`'s fault order.
        Returns a ``(verdict, arg)`` pair:

        - ``("delay", ms)``: hold the frame ``ms`` then re-stage with
          ``delayed=True`` (skips the latency check, like the blocking
          path which sleeps first and then consults the next fault).
        - ``("swallow", None)``: the wire never sees the record; the
          caller accounts it as sent (MAC sequence desync downstream
          is the point, exactly as the blocking swallow behaves).
        - ``("send", bytes)``: flush these bytes (possibly corrupted).
        - ``("rst", half)``: flush ``half`` then treat the link as
          reset by peer.
        - ``("partial", half)``: flush ``half`` then wedge the writer
          (keep the frame queued, keep the in-flight-send stamp so the
          idle probe is what tears the link down).
        """
        if not delayed:
            extra = self._plan.extra_latency_ms()
            if extra > 0.0:
                return ("delay", extra)
        if self._plan.in_window(BLACKHOLE):
            return ("swallow", None)
        kind = self._plan.on_send() if self._frames_armed else None
        if kind is None:
            return ("send", wire)
        wire = bytes(wire)
        if kind == CORRUPT:
            mutated = bytearray(wire)
            if len(mutated) > 4:
                mutated[self._plan.corrupt_index(4, len(mutated))] ^= 0x01
            return ("send", bytes(mutated))
        half = wire[:max(1, len(wire) // 2)]
        if kind == RST:
            return ("rst", half)
        return ("partial", half)
