# A copy of the reference's engine/net.py
# (hlsjs_p2p_wrapper_tpu/engine/net.py): the same names, formats and bytes;
# the imports point at the port's own modules, and a few comments no longer
# cite the reference's history.
"""Real-socket peer transport (deployments).

The reference's production transport is WebRTC data channels inside
the closed-source agent (SURVEY.md §2.4); this module is the
rebuild's deployable equivalent: TCP with u32-length-prefixed frames,
carrying exactly the same wire protocol (`engine/protocol.py`) the
loopback model carries in tests — one engine, two fabrics.

Design points:

- **One event loop per network** (:class:`NetLoop`): socket reader
  threads never touch engine state; they post frames onto a single
  dispatcher thread that also implements the :class:`~..core.clock.
  Clock` protocol.  An agent constructed with ``clock=network.loop``
  is single-threaded by construction — the same discipline the
  VirtualClock gives tests, on real time.
- **Addresses are identities**: a peer's id IS ``"host:port"`` of its
  listener, assigned at ``register()`` time (the WebRTC analogue is
  ICE credentials).  Outbound connections send a one-shot peer-id
  preamble so the receiver can tag inbound frames with their source.
- Connections are created on first send and reused both ways.

Trust model (explicit, because the reference's closed agent was the
trust boundary and WebRTC gave it DTLS for free):

- **Outbound links are address-verified**: we dialed ``host:port``,
  so frames read back on that socket genuinely come from whoever
  owns that listener.
- **Inbound identity is self-declared** in the preamble.  Two
  defenses bound the lie: the claimed host must resolve to the
  socket's observed remote address (``getpeername``; disable via
  ``verify_inbound_host=False`` for NAT/multi-homed fabrics) — a
  peer can only impersonate listeners on its OWN address — and ids in
  ``reject_inbound_ids`` (the agent registers its tracker id there)
  may never be claimed inbound at all, since tracker-tagged frames
  steer mesh membership.  The tracker never usefully dials peers
  (PEERS replies reuse the announce connection), so rejecting
  inbound claims of its id costs nothing.
- **Per-swarm PSK** (``TcpNetwork(psk=...)``): when set, every
  connection runs an HMAC-SHA256 challenge-response right after the
  preamble — both sides contribute a random nonce, and the connector
  must answer ``HMAC(psk, a_nonce ‖ c_nonce ‖ claimed_id)`` before
  any protocol frame is accepted.  This is the WebRTC-DTLS analogue
  the reference's closed agent got for free (SURVEY §2.4): a
  same-host process WITHOUT the swarm secret can no longer claim a
  registered peer's id (previously it could — a review's finding
  #3).  Residual, by the nature of a shared symmetric key: a
  peer that legitimately holds the PSK can still claim another
  member's id — per-member non-forgeability needs asymmetric
  identity keys pinned via the tracker, the same residual DTLS has
  without signaling-bound fingerprints.
- **Every post-handshake frame is MACed** on a PSK fabric (a review's
  finding #1 — DTLS protects every *record*, not just the
  handshake): both sides derive per-connection, per-direction keys
  from the PSK and both handshake nonces (HKDF-style extract/expand
  over stdlib ``hmac``), and each frame carries a truncated
  HMAC-SHA256 tag over ``direction-key ‖ sequence-number ‖ payload``.
  An on-path active attacker who observed the whole handshake can
  therefore neither inject a well-formed frame (no session key ⇒ no
  valid tag), replay one from another connection (keys are
  nonce-unique), reflect one back to its sender (keys are
  directional), nor reorder/splice within a stream (the tag binds the
  per-direction sequence number).  A frame failing verification
  drops the connection — the same fail-closed discipline the wire
  decoder applies to malformed frames.
- **Optional TLS** (``TcpNetwork(ssl_server_context=...,
  ssl_client_context=...)``): when the deployment also needs
  confidentiality, every connection can be wrapped in stdlib ``ssl``
  before the preamble; the PSK handshake and frame MACs then run
  inside the encrypted channel and keep providing swarm-membership
  authentication independent of the certificate story.
- Without a PSK, same-host peers (one machine, many ports) can claim
  each other's ids and frames are not integrity-protected — use a
  PSK, a fronting proxy, or kernel-level isolation in hostile
  deployments.
"""

from __future__ import annotations

import errno
import heapq
import hmac
import itertools
import logging
import os
import selectors
import socket
import ssl
import struct
import threading
import time
from typing import Callable, Dict, Optional

from ..core.clock import TimerHandle
from .faults import FaultPolicy
from .netfaults import FaultSocket, _FaultHold
from .telemetry import MetricsRegistry

log = logging.getLogger(__name__)

_LEN = struct.Struct("<I")
_SEQ = struct.Struct("<Q")
MAX_FRAME_BYTES = 64 * 1024 * 1024  # matches the cache-budget defense
#: auth nonce/MAC frames are tiny; anything bigger is a poisoned stream
MAX_AUTH_BYTES = 64
#: whole-handshake socket timeout (preamble + challenge-response): an
#: unauthenticated connection must not pin a handshake thread forever
HANDSHAKE_TIMEOUT_S = 5.0
#: per-frame tag length: HMAC-SHA256 truncated to 16 bytes — the
#: GCM/DTLS-standard tag size; forging it is a 2^-128 guess per try
#: and every failed try costs the attacker the connection
FRAME_MAC_LEN = 16
#: handshake nonces are EXACTLY this long, enforced on both sides:
#: the MAC/KDF inputs join variable-length fields with NUL bytes, so
#: a variable-length attacker-supplied nonce could shift bytes
#: between the nonce and the claimed id without changing the MAC
#: input (field-boundary ambiguity) — fixed length makes every field
#: boundary unambiguous
NONCE_LEN = 32


def _psk_response(psk: bytes, a_nonce: bytes, c_nonce: bytes,
                  claimed_id: bytes) -> bytes:
    """The challenge answer: binds the PSK, both nonces (no replay —
    each side contributes freshness), and the id the connector claims
    (no splice onto another preamble)."""
    return hmac.digest(psk, a_nonce + b"\x00" + c_nonce + b"\x00"
                       + claimed_id, "sha256")


def _derive_frame_keys(psk: bytes, a_nonce: bytes, c_nonce: bytes,
                       claimed_id: bytes) -> tuple:
    """Per-connection frame-MAC keys, HKDF-style over stdlib ``hmac``:
    extract a connection secret from the PSK salted by both handshake
    nonces + the claimed id, then expand one independent key per
    direction.  Returns ``(c2a_key, a2c_key)`` — connector-to-acceptor
    and acceptor-to-connector.  Directional keys stop reflection
    (echoing a peer's own frame back at it); nonce-salted extraction
    stops cross-connection replay even under PSK reuse."""
    prk = hmac.digest(psk, b"p2p-frame-mac-v1\x00" + a_nonce + b"\x00"
                      + c_nonce + b"\x00" + claimed_id, "sha256")
    return (hmac.digest(prk, b"c2a", "sha256"),
            hmac.digest(prk, b"a2c", "sha256"))


def _frame_tag(key: bytes, seq: int, payload: bytes) -> bytes:
    """The per-frame tag: binds the directional key, the per-direction
    sequence number (TCP is ordered, so a simple counter detects both
    replay-within-stream and deletion/splice), and the payload."""
    return hmac.digest(key, _SEQ.pack(seq) + payload,
                       "sha256")[:FRAME_MAC_LEN]


def _tls_wrap(sock: socket.socket, ctx, deadline: float, *,
              server_side: bool, server_hostname: Optional[str] = None):
    """Complete a TLS handshake under an ABSOLUTE deadline (the same
    discipline ``_read_exact`` applies to the identity handshake).  A
    plain ``settimeout`` before ``wrap_socket`` is a per-recv budget —
    a ClientHello dribbled one byte per almost-timeout would hold the
    handshake thread ~indefinitely, exactly the slot-pinning DoS the
    deadline exists to close.  Non-blocking ``do_handshake`` +
    ``select`` bounded by the REMAINING budget makes the bound real.
    Returns the wrapped socket (blocking mode restored) or ``None``.
    On failure the socket is closed HERE: ``wrap_socket`` detaches the
    caller's fd into the SSLSocket, so a caller-side ``close()`` on
    the original object would release nothing."""
    import selectors
    import ssl
    tls = None
    try:
        sock.setblocking(False)
        tls = ctx.wrap_socket(sock, server_side=server_side,
                              server_hostname=server_hostname,
                              do_handshake_on_connect=False)
        # selectors (epoll/kqueue), not select.select: the latter
        # raises on any fd >= FD_SETSIZE (1024), which a process with
        # a few busy endpoints reaches easily
        with selectors.DefaultSelector() as sel:
            key = sel.register(tls, selectors.EVENT_READ)
            while True:
                remaining = deadline - time.monotonic()  # clock-ok: TLS handshake socket deadline
                if remaining <= 0:
                    raise OSError("TLS handshake deadline exceeded")
                try:
                    tls.do_handshake()
                    break
                except ssl.SSLWantReadError:
                    events = selectors.EVENT_READ
                except ssl.SSLWantWriteError:
                    events = selectors.EVENT_WRITE
                if key.events != events:
                    sel.modify(tls, events)
                    key = sel.get_key(tls)
                if not sel.select(remaining):
                    raise OSError("TLS handshake deadline exceeded")
        return _SafeTls(tls)
    except (OSError, ValueError):
        for s in (tls, sock):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        return None


class _SafeTls:
    """Make one TLS connection safe under the endpoint's two-thread
    socket discipline.  A plain TCP socket tolerates a reader thread
    in ``recv`` concurrent with a writer thread in ``sendall``; an
    ``SSLSocket`` does NOT — OpenSSL ``SSL`` objects are not
    thread-safe for simultaneous ``SSL_read``/``SSL_write`` (TLS 1.3
    post-handshake records like NewSessionTicket/KeyUpdate mutate
    shared connection state from the READ path), and CPython releases
    the GIL around both calls with no per-object lock.  This wrapper
    keeps the socket non-blocking and serializes every OpenSSL entry
    under one lock, held ONLY for the non-blocking call itself —
    readiness waits happen outside the lock, so a reader waiting for
    bytes never starves the writer (the classic
    lock-around-blocking-recv deadlock).

    ``close``/``shutdown`` follow the plain-socket idiom the
    endpoint already uses: ``shutdown`` wakes both waiters (the fd
    signals readable/writable on EOF), and the bounded wait tick
    re-checks the closed flag as a backstop."""

    _WAIT_TICK_S = 1.0

    def __init__(self, tls):
        import selectors
        self._tls = tls
        self._lock = threading.Lock()
        self._closed = False
        self._timeout: Optional[float] = None
        tls.setblocking(False)
        # one persistent selector per waiting side, registered once —
        # a per-wait DefaultSelector would cost an epoll instance
        # create/destroy on every block/unblock cycle of every link
        self._rsel = selectors.DefaultSelector()
        self._rsel.register(tls, selectors.EVENT_READ)
        self._wsel = selectors.DefaultSelector()
        self._wsel.register(tls, selectors.EVENT_WRITE)

    def _wait(self, want_write: bool) -> None:
        try:
            (self._wsel if want_write else self._rsel).select(
                self._WAIT_TICK_S)
        except (OSError, ValueError):
            raise OSError("TLS socket closed under waiter")

    def recv(self, n: int) -> bytes:
        import ssl
        deadline = (time.monotonic() + self._timeout  # clock-ok: socket deadline
                    if self._timeout is not None else None)
        while True:
            if self._closed:
                raise OSError("TLS connection closed")
            if deadline is not None and time.monotonic() >= deadline:  # clock-ok: socket deadline
                raise socket.timeout("timed out")  # OSError: caller drops
            with self._lock:
                try:
                    return self._tls.recv(n)  # loop-ok: legacy threaded TLS read
                except ssl.SSLWantReadError:
                    want_write = False
                except ssl.SSLWantWriteError:
                    want_write = True
                except ssl.SSLEOFError:
                    return b""
            self._wait(want_write)

    def sendall(self, data: bytes) -> None:
        import ssl
        view = memoryview(data)
        deadline = (time.monotonic() + self._timeout  # clock-ok: socket deadline
                    if self._timeout is not None else None)
        while view.nbytes:
            if self._closed:
                raise OSError("TLS connection closed")
            if deadline is not None and time.monotonic() >= deadline:  # clock-ok: socket deadline
                raise socket.timeout("timed out")  # OSError: caller drops
            want_write = True
            with self._lock:
                try:
                    sent = self._tls.send(view)
                    view = view[sent:]
                    continue
                except ssl.SSLWantWriteError:
                    pass
                except ssl.SSLWantReadError:
                    want_write = False
            self._wait(want_write)

    def settimeout(self, value) -> None:
        """Honored by ``recv`` AND ``sendall`` as an absolute per-call
        budget — the identity handshake's deadline discipline
        (``_read_exact`` / ``_send_with_deadline``) must keep binding
        after the TLS wrap, or a post-TLS dribbler (or a
        never-writable backpressuring peer) would pin the handshake
        thread the old way."""
        self._timeout = value

    def getpeername(self):
        return self._tls.getpeername()

    def shutdown(self, how) -> None:
        self._closed = True
        self._tls.shutdown(how)  # plain fd shutdown: wakes both waiters

    def close(self) -> None:
        self._closed = True
        with self._lock:
            for sel in (self._rsel, self._wsel):
                try:
                    sel.close()
                except OSError:
                    pass
            self._tls.close()


class NetLoop:
    """Single-threaded selector event loop + Clock implementation (the
    C10K round): ONE thread multiplexes every registered non-blocking
    socket through ``selectors.DefaultSelector`` (epoll/kqueue) AND
    runs the timer heap + posted-callback queue the Clock protocol
    needs.  Timers, inbound frames, handshake stages, and write
    flushes all execute on this thread — an agent constructed with
    ``clock=network.loop`` stays single-threaded by construction, now
    with the socket I/O itself on the same thread instead of two
    threads per connection.

    Selector mutations (:meth:`register` / :meth:`modify` /
    :meth:`unregister`) are loop-thread-only by contract — cross-
    thread callers go through :meth:`post` / :meth:`run_soon`.  A
    non-blocking socketpair waker makes ``post``/``call_later`` safe
    from any thread while the loop is parked in ``select``.

    Loop health is observable once a registry is attached
    (:meth:`attach_registry`, done by ``TcpNetwork``):
    ``net.loop.sockets`` (registered fds), ``net.loop.iteration_ms``
    (latency histogram per select-dispatch cycle),
    ``net.loop.stalls`` (one callback hogged the loop past
    ``STALL_MS``), and ``net.loop.backpressure_high_water_bytes``
    (high-water of pending write-buffer bytes across the loop's
    connections)."""

    #: a single callback running longer than this starves every other
    #: socket on the loop — counted as ``net.loop.stalls``
    STALL_MS = 100.0

    _ids = itertools.count()

    def __init__(self):
        self.name = f"netloop-{next(NetLoop._ids)}"
        self._lock = threading.Lock()
        self._heap: list = []
        self._seq = itertools.count()
        self._queue: list = []
        self._stopped = False
        self._sel = selectors.DefaultSelector()
        # self-pipe waker: post()/call_later() from another thread
        # must interrupt a parked select(); loop-thread posts skip it
        # (the next timeout computation sees the queue)
        self._waker_r, self._waker_w = socket.socketpair()
        self._waker_r.setblocking(False)
        self._waker_w.setblocking(False)
        self._sel.register(self._waker_r, selectors.EVENT_READ, None)
        self._wake_pending = False
        self._m: Optional[dict] = None  # metric handles once attached
        self._io_count = 0
        self._pending_write = 0
        self._pending_write_high = 0
        self._thread = threading.Thread(  # loop-ok: THE loop thread itself
            target=self._run, daemon=True, name="p2p-netloop")
        self._thread.start()

    # -- Clock protocol ------------------------------------------------
    def now(self) -> float:
        return time.monotonic() * 1000.0  # clock-ok: NetLoop IS the wall clock

    def call_later(self, delay_ms: float, fn: Callable[[], None]) -> TimerHandle:
        handle = TimerHandle()
        due = self.now() + max(float(delay_ms), 0.0)
        with self._lock:
            heapq.heappush(self._heap, (due, next(self._seq), fn, handle))
        self._wake()
        return handle

    # -- dispatch ------------------------------------------------------
    def post(self, fn: Callable[[], None]) -> bool:
        """Run ``fn`` on the loop thread as soon as possible.  Returns
        False when the loop is already stopped (the callback will
        never run — callers owning an fd must fall back to closing it
        directly)."""
        with self._lock:
            if self._stopped:
                return False
            self._queue.append(fn)
        self._wake()
        return True

    def run_soon(self, fn: Callable[[], None]) -> bool:
        """``fn()`` synchronously when already on the loop thread,
        else :meth:`post` — for teardown paths (selector unregister
        before fd close) that must not reorder behind a busy loop
        when the caller IS the loop.  Returns False when the loop is
        stopped and the callback will never run."""
        if threading.current_thread() is self._thread:
            fn()
            return True
        return self.post(fn)

    def on_loop_thread(self) -> bool:
        return threading.current_thread() is self._thread

    def _wake(self) -> None:
        if threading.current_thread() is self._thread:
            return  # the loop re-checks its queues before selecting
        with self._lock:
            if self._wake_pending or self._stopped:
                return
            self._wake_pending = True
        try:
            self._waker_w.send(b"\x00")  # loop-ok: non-blocking self-pipe write, not socket traffic
        except OSError:
            pass  # loop torn down under the caller; nothing to wake

    # -- selector surface (loop-thread-only) ---------------------------
    def register(self, fileobj, events: int, callback) -> None:
        """Register ``fileobj`` for ``events``; ``callback(mask)``
        runs on the loop thread when ready.  Loop-thread-only."""
        self._sel.register(fileobj, events, callback)
        self._io_count += 1
        if self._m is not None:
            self._m["sockets"].set(self._io_count)

    def modify(self, fileobj, events: int, callback) -> None:
        self._sel.modify(fileobj, events, callback)

    def unregister(self, fileobj) -> bool:
        """Drop a registration (loop-thread-only; MUST precede the fd
        close, or a recycled descriptor inherits the stale selector
        key).  Returns False when the fileobj was not registered."""
        try:
            self._sel.unregister(fileobj)
        except (KeyError, ValueError):
            return False
        self._io_count -= 1
        if self._m is not None:
            self._m["sockets"].set(self._io_count)
        return True

    def selector_size(self) -> int:
        """Registered socket count, waker excluded (tests assert a
        torn-down handshake leaves no key behind)."""
        return max(0, len(self._sel.get_map()) - 1)

    # -- telemetry -----------------------------------------------------
    def attach_registry(self, registry: MetricsRegistry) -> None:
        """Wire the loop-health instruments into ``registry`` (first
        attach wins — a loop shared by several networks reports
        once)."""
        if self._m is not None:
            return
        self._m = {
            "sockets": registry.gauge("net.loop.sockets",
                                      loop=self.name),
            "iter": registry.histogram(
                "net.loop.iteration_ms", loop=self.name,
                buckets=(0.1, 0.5, 1.0, 5.0, 20.0, 50.0, 100.0,
                         500.0, 2000.0)),
            "stalls": registry.counter("net.loop.stalls",
                                       loop=self.name),
            "backpressure": registry.gauge(
                "net.loop.backpressure_high_water_bytes",
                loop=self.name),
        }

    def note_pending_write(self, delta: int) -> None:
        """Connections report write-buffer growth/drain here; the
        loop-wide high-water feeds the backpressure gauge."""
        with self._lock:
            self._pending_write += delta
            if self._pending_write > self._pending_write_high:
                self._pending_write_high = self._pending_write
                high = self._pending_write_high
            else:
                return
        if self._m is not None:
            self._m["backpressure"].set(high)

    def _run_cb(self, fn, mask) -> None:
        t0 = time.monotonic()  # clock-ok: stall-accounting span
        try:
            if mask is None:
                fn()
            else:
                fn(mask)
        except Exception:  # noqa: BLE001
            log.exception("unhandled error on net loop")
        if self._m is not None:
            elapsed_ms = (time.monotonic() - t0) * 1000.0  # clock-ok: stall-accounting span
            if elapsed_ms >= self.STALL_MS:
                self._m["stalls"].inc()

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._stopped:
                    break
                timeout = None
                if self._queue:
                    timeout = 0.0
                elif self._heap:
                    timeout = max(0.0,
                                  (self._heap[0][0] - self.now())
                                  / 1000.0)
            try:
                events = self._sel.select(timeout)
            except OSError:
                break  # selector closed under a racing stop()
            t0 = time.monotonic()  # clock-ok: iteration-latency span
            with self._lock:
                if self._stopped:
                    break
                batch, self._queue = self._queue, []
                now = self.now()
                while self._heap and self._heap[0][0] <= now:
                    _, _, fn, handle = heapq.heappop(self._heap)
                    if not handle.cancelled:
                        handle._fired = True
                        batch.append(fn)
            for fn in batch:
                self._run_cb(fn, None)
            live = self._sel.get_map()
            for key, mask in events:
                if key.data is None:  # the waker
                    try:
                        while self._waker_r.recv(4096):  # loop-ok: non-blocking self-pipe drain
                            pass
                    except OSError:
                        pass
                    with self._lock:
                        self._wake_pending = False
                    continue
                # a callback earlier in this very batch may have
                # unregistered this key (teardown) — or closed the fd
                # and dialed a NEW socket onto the same number; the
                # identity check drops exactly those stale events
                cur = live.get(key.fd)
                if cur is None or cur.fileobj is not key.fileobj:
                    continue
                self._run_cb(key.data, mask)
            if self._m is not None:
                self._m["iter"].observe(
                    (time.monotonic() - t0) * 1000.0)  # clock-ok: iteration-latency span
        # loop exit owns the teardown: selector + waker pair
        try:
            self._sel.close()
        except OSError:
            pass
        for sock in (self._waker_r, self._waker_w):
            try:
                sock.close()
            except OSError:
                pass

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        try:
            self._waker_w.send(b"\x00")  # loop-ok: non-blocking self-pipe wake for stop
        except OSError:
            pass  # loop already past its select


class ReconnectPolicy:
    """Self-healing knobs for the TCP fabric: how a dead
    link is re-dialed, when a remote is circuit-broken, and how a
    half-open link is detected.

    The backoff is the dispatch plane's machinery REUSED verbatim — a
    :class:`~.faults.FaultPolicy` provides the bounded
    jittered-exponential schedule with its injectable ``sleep`` and
    ``seed``, so reconnect tests pin the exact delays the same way the
    chaos gate pins dispatch retries.  ``clock`` (seconds, monotonic
    by default) drives the CIRCUIT COOLDOWN arithmetic — tests
    inject a fake to step a breaker through open → half-open without
    waiting.  (The idle probe deliberately stays on wall monotonic
    time: a stuck ``sendall`` is wall-clock evidence, and its test
    drives the deadline by backdating ``_send_started``.)

    - ``max_retries``: dial attempts per (re)connect cycle beyond the
      first, each separated by the jittered backoff;
    - ``circuit_threshold`` consecutive no-progress failures against
      one remote open its breaker for ``circuit_cooldown_s`` — sends
      during the cooldown drop immediately
      (``net.send_drops{reason=circuit_open}``), never a hot retry
      loop; the first dial after the cooldown is a half-open probe;
    - ``idle_probe_s``: a send stuck in flight this long declares the
      link half-open and tears it down for a fresh dial (the
      full-socket-buffer wedge TCP itself never reports; quieter
      forms of peer death stay the mesh reap's and the protocol
      timeouts' job)."""

    def __init__(self, *, max_retries: int = 3,
                 backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0, jitter: float = 0.5,
                 seed: int = 0, sleep=time.sleep,
                 clock=time.monotonic,
                 circuit_threshold: int = 4,
                 circuit_cooldown_s: float = 15.0,
                 idle_probe_s: float = 30.0):
        if circuit_threshold < 1:
            raise ValueError("circuit_threshold must be >= 1")
        if idle_probe_s <= 0.0:
            raise ValueError("idle_probe_s must be positive")
        self._backoff = FaultPolicy(max_retries=max_retries,
                                    backoff_base_s=backoff_base_s,
                                    backoff_cap_s=backoff_cap_s,
                                    jitter=jitter, seed=seed,
                                    sleep=sleep)
        self.max_retries = max_retries
        self.circuit_threshold = circuit_threshold
        self.circuit_cooldown_s = circuit_cooldown_s
        self.idle_probe_s = idle_probe_s
        self.clock = clock

    def backoff_s(self, attempt: int) -> float:
        return self._backoff.backoff_s(attempt)

    def sleep_backoff(self, attempt: int) -> float:
        return self._backoff.sleep_backoff(attempt)


class _Circuit:
    """Per-remote circuit breaker: ``closed`` → (threshold
    consecutive no-progress failures) → ``open`` for the cooldown →
    one ``half_open`` probe dial → ``closed`` on progress, back to
    ``open`` on failure.  State transitions are returned to the
    caller so the endpoint counts them exactly once
    (``net.circuit{state=...}``)."""

    __slots__ = ("_lock", "failures", "state", "open_until")

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self):
        self._lock = threading.Lock()
        self.failures = 0
        self.state = self.CLOSED
        self.open_until = 0.0

    def blocked(self, now: float) -> bool:
        """Sends must not mint fresh connections while cooling."""
        with self._lock:
            return self.state == self.OPEN and now < self.open_until

    def allow_attempt(self, now: float):
        """May a dial start?  ``(allowed, transition)`` — transition
        is ``"half_open"`` when this dial is the cooldown's single
        probe."""
        with self._lock:
            if self.state != self.OPEN:
                return True, None
            if now < self.open_until:
                return False, None
            self.state = self.HALF_OPEN
            return True, self.HALF_OPEN

    def record_failure(self, now: float, policy: ReconnectPolicy):
        """A dial failed, or a link died with zero inbound progress;
        returns ``"open"`` when this trips (or re-trips) the
        breaker."""
        with self._lock:
            self.failures += 1
            if (self.state == self.HALF_OPEN
                    or (self.state == self.CLOSED
                        and self.failures
                        >= policy.circuit_threshold)):
                self.state = self.OPEN
                self.open_until = now + policy.circuit_cooldown_s
                return self.OPEN
            return None

    def record_success(self):
        """Inbound progress on a live link; returns ``"closed"`` when
        this transition re-closes a tripped breaker."""
        with self._lock:
            was = self.state
            self.state = self.CLOSED
            self.failures = 0
            return self.CLOSED if was != self.CLOSED else None


class _Connection:
    """One TCP link, reused for both directions — and, under the
    network's :class:`ReconnectPolicy`, SELF-HEALING: a link that dies
    with frames still queued (or that the idle probe declares
    half-open) is re-dialed by its own writer thread with bounded
    jittered backoff, redoing the FULL preamble + PSK handshake (fresh
    nonces, fresh frame keys, sequence numbers from zero — no
    resumption shortcut).  A link that dies idle with an empty queue
    closes exactly as before: the next send mints a fresh connection.

    Writes never block the caller: frames go onto a bounded
    per-connection queue drained by a writer thread, which also
    performs the (blocking) connect + preamble for outbound links —
    the NetLoop dispatcher must never stall on socket I/O.  Frames
    dropped anywhere (full queue, dead endpoint, give-up after the
    retry budget, circuit cooldown) are counted
    (``net.send_drops{reason}``) — no silent ``False`` paths.  The
    frame being written when a link dies stays queued (the writer
    PEEKS, popping only after ``sendall`` returns), so a mid-frame
    RST re-sends it on the healed link; receivers may therefore see a
    duplicate, which the protocol layer already tolerates (stray
    CHUNK/REQUEST handling)."""

    MAX_QUEUED_FRAMES = 4096

    #: drain-rate assumption before any send completes (connection
    #: still connecting / first frame in flight): pessimistic enough
    #: that a connect stall registers as backlog and pauses pacing
    ASSUMED_DRAIN_BPS = 8_000_000.0

    def __init__(self, endpoint: "TcpEndpoint", remote_id: str,
                 sock: Optional[socket.socket] = None):
        self.endpoint = endpoint
        self.remote_id = remote_id
        self.sock = sock  # None → outbound; writer thread connects
        #: constructed around an accepted socket (inbound)?  start()
        #: must key its reader-spawn on THIS, not on `sock is not
        #: None`: for an outbound conn the writer thread may complete
        #: a (localhost-fast) connect and set `sock` before start()'s
        #: check runs, and the sock-based test then spawned a SECOND
        #: reader — two readers on one socket steal bytes from each
        #: other and permanently desync the frame stream (the
        #: long-standing intermittent mesh-never-connects flake)
        self._inbound = sock is not None
        #: per-frame MAC state (PSK fabrics; None on open fabrics).
        #: send side is touched only by the writer thread, recv side
        #: only by the reader thread — no lock needed beyond the
        #: handshake happens-before (keys are set before start()/
        #: before the writer's send loop begins)
        self.send_key: Optional[bytes] = None
        self.recv_key: Optional[bytes] = None
        self._send_seq = 0
        self.closed = False
        self._queue: list = []
        self._queued_bytes = 0   # enqueued but not yet handed to the OS
        self._drain_bps = 0.0    # EWMA of observed sendall throughput
        self._send_started: Optional[float] = None  # in-flight sendall t0
        #: last send/receive on this link (monotonic s) — the idle
        #: signal the endpoint's at-cap LRU eviction ranks by.
        #: INTENTIONALLY unsynchronized (written by writer/reader
        #: threads, read under _conn_lock): it is a monotonic hint
        #: whose worst-case staleness is one store, and eviction
        #: already tolerates minutes of slack — unlike the
        #: queue-state fields, no invariant hangs off it
        self.last_activity = time.monotonic()  # clock-ok: eviction hint, wall time by contract
        # self-healing state (ReconnectPolicy): why the current link
        # died (labels net.reconnects) and whether this link session
        # has seen inbound progress (circuit accounting)
        self._down_reason: Optional[str] = None
        self._progressed = False
        #: may the writer dial when it finds sock None?  True for the
        #: initial outbound dial; _link_down sets it to its redial
        #: decision UNDER _cond — the writer must never observe
        #: "sock gone" without also observing whether healing was
        #: sanctioned, or it races close() into a spurious redial
        self._heal_pending = sock is None
        self._cond = threading.Condition()
        self._writer = threading.Thread(  # loop-ok: legacy threads transport
            target=self._write_loop, daemon=True,
            name=f"p2p-writer-{remote_id}")

    def start(self) -> None:
        """Begin I/O.  Called AFTER the endpoint has registered this
        connection — a fast connect failure must not race the
        registration and resurrect a pruned entry.  The reader is
        spawned here only for INBOUND connections; an outbound
        connection's reader is spawned by its writer thread once the
        connect completes (see the `_inbound` field docs for the
        double-reader race the sock-based check here used to cause)."""
        self._writer.start()
        if self._inbound:
            threading.Thread(  # loop-ok: legacy threads transport
                target=self.endpoint._reader_loop, args=(self,),
                daemon=True).start()

    def enqueue(self, frame: bytes) -> bool:
        with self._cond:
            if self.closed:
                dropped = "closed"
            elif len(self._queue) >= self.MAX_QUEUED_FRAMES:
                dropped = "queue_full"
            else:
                self.last_activity = time.monotonic()  # clock-ok: eviction hint
                self._queue.append(frame)
                self._queued_bytes += len(frame)
                self._cond.notify()
                return True
        self.endpoint._count("send_drops", dropped)
        return False

    def backlog_ms(self) -> float:
        """Estimated time for the unsent queue to drain, from the
        observed ``sendall`` throughput (the OS absorbs sends at
        link speed until its buffers fill, so the EWMA converges on
        the real bottleneck rate once the socket pushes back).
        Before any send completes, a pessimistic assumed rate makes a
        connect stall register as backlog.

        The EWMA alone is blind to a HARD stall: it only updates when
        a send completes, so a receiver that stops reading after the
        connection warmed up would leave a stale multi-Gbps estimate
        while ``sendall`` blocks.  The in-flight send's own elapsed
        time is therefore a floor on the reported backlog — a blocked
        send reads as backlog within one pacing interval."""
        with self._cond:
            queued = self._queued_bytes
            started = self._send_started
            drain_bps = self._drain_bps
        stall_ms = ((time.monotonic() - started) * 1000.0  # clock-ok: socket deadline
                    if started is not None else 0.0)
        if queued <= 0:
            return stall_ms
        rate = drain_bps if drain_bps > 0 else self.ASSUMED_DRAIN_BPS
        return max(queued * 8.0 / rate * 1000.0, stall_ms)

    def _write_loop(self) -> None:
        while True:
            dial = False
            with self._cond:
                if self.closed:
                    return
                sock = self.sock
                if sock is None:
                    if not self._heal_pending:
                        # teardown landing: close() is about to set
                        # closed (its notify frees this wait) — do
                        # NOT slip a dial in between
                        self._cond.wait()
                        continue
                    dial = True
            if dial:
                # initial dial, or a sanctioned redial — the
                # backoff/circuit loop owns give-up and close
                if not self._establish():
                    return
                continue
            with self._cond:
                while not self._queue and not self.closed \
                        and self.sock is sock:
                    self._cond.wait()
                if self.closed:
                    return
                if self.sock is not sock:
                    continue  # link died (or healed) under the wait
                # PEEK, don't pop: a frame the link dies under stays
                # queued and re-sends on the healed link.  The MAC
                # key + sequence are snapshotted UNDER the same lock
                # _link_down nulls them under — reading them after
                # release could deref a mid-teardown None (or send an
                # untagged frame on an authenticated link)
                frame = self._queue[0]
                send_key = self.send_key
                send_seq = self._send_seq
                if send_key is not None:
                    self._send_seq += 1
                t0 = time.monotonic()  # clock-ok: stall-floor timebase
                self._send_started = t0
            try:
                if send_key is not None:
                    tag = _frame_tag(send_key, send_seq, frame)
                    # single-copy join: frame + tag then prefix + wire
                    # would memcpy a 64 MiB chunk twice
                    wire = b"".join((_LEN.pack(len(frame) + len(tag)),
                                     frame, tag))
                else:
                    wire = _LEN.pack(len(frame)) + frame
                sock.sendall(wire)  # loop-ok: legacy threaded writer's blocking send
                elapsed = time.monotonic() - t0  # clock-ok: EWMA measurement
                self.endpoint.bytes_sent += len(frame)
            except OSError:
                with self._cond:
                    self._send_started = None
                self._link_down("send_error", sock)
                continue
            with self._cond:
                self._send_started = None
                if self._queue and self._queue[0] is frame:
                    self._queue.pop(0)
                    self._queued_bytes -= len(frame)
                # EWMA update under the same lock as the other
                # queue-state fields: backlog_ms() reads it from the
                # dispatcher thread, and one consistent concurrency
                # contract beats "safe under the GIL today"
                if elapsed > 0.0:
                    inst_bps = len(frame) * 8.0 / elapsed
                    self._drain_bps = (inst_bps if self._drain_bps == 0.0
                                       else 0.8 * self._drain_bps
                                       + 0.2 * inst_bps)

    def _establish(self) -> bool:
        """Dial (or re-dial) under bounded jittered backoff and the
        per-remote circuit breaker.  Returns True with the socket
        installed, MAC state reset, and a reader spawned; False after
        closing the connection (give-up / circuit open / endpoint
        closed).  Every retry and every redial is counted
        (``net.reconnects{reason}``)."""
        endpoint = self.endpoint
        heal = endpoint._heal
        reason = self._down_reason or "connect"
        redialing = self._down_reason is not None
        attempt = 0
        while True:
            with self._cond:
                if self.closed:
                    return False
            circuit = endpoint._circuit_for(self.remote_id)
            if circuit is not None:
                allowed, probe = circuit.allow_attempt(endpoint._hclock())
                if not allowed:
                    self.close(drop_reason="circuit_open")
                    return False
                if probe is not None:
                    endpoint._count("circuit", "half_open")
            if redialing or attempt > 0:
                endpoint._count("reconnects", reason)
                endpoint._trace("reconnect", remote=self.remote_id,
                                reason=reason, attempt=attempt)
            sock = self._connect_with_preamble()
            if sock is not None:
                with self._cond:
                    installed = not self.closed
                    if installed:
                        self.sock = sock
                        self._heal_pending = False
                        # whatever its origin, the link is now one WE
                        # dialed — probe-healing is ours from here
                        self._inbound = False
                        self._send_seq = 0
                        self._down_reason = None
                        self._progressed = False
                if not installed:
                    # close() raced the dial; this thread owns cleanup
                    try:
                        sock.close()
                    except OSError:
                        pass
                    return False
                # the reader gets ITS link's socket + key at spawn
                # time: capturing conn.sock when the thread body runs
                # would let a stale reader grab a newer link's socket
                # after a fast die-and-heal cycle (two readers on one
                # socket steal bytes from each other)
                threading.Thread(target=endpoint._reader_loop,  # loop-ok: legacy threads transport
                                 args=(self, sock, self.recv_key),
                                 daemon=True).start()
                if redialing or attempt > 0:
                    endpoint._notify_reconnect(self.remote_id)
                return True
            if circuit is not None and heal is not None:
                tripped = circuit.record_failure(endpoint._hclock(), heal)
                if tripped is not None:
                    endpoint._count("circuit", "open")
                    endpoint._trace("circuit_open", remote=self.remote_id)
                    self.close(drop_reason="circuit_open")
                    return False
            attempt += 1
            if heal is None or attempt > heal.max_retries:
                self.close(drop_reason="giveup")
                return False
            heal.sleep_backoff(attempt - 1)

    def _link_down(self, reason: str, sock) -> None:
        """A live link failed (reader EOF/error, writer send error,
        MAC verification, idle probe): tear the socket, keep the
        connection for a writer-thread redial when healing applies —
        frames still queued, or a probe tore a half-open link —
        otherwise close outright (the pre-heal behavior, so an idle
        remote departure never spawns dial churn)."""
        heal = self.endpoint._heal
        # circuit handle fetched BEFORE _cond (lock order: _conn_lock
        # is never taken inside a connection's _cond)
        circuit = (self.endpoint._circuit_for(self.remote_id)
                   if heal is not None else None)
        tripped = None
        with self._cond:
            if self.closed or sock is None or self.sock is not sock:
                return  # stale report from an already-replaced link
            self.sock = None
            self._down_reason = reason
            self.send_key = self.recv_key = None
            # redial when frames are queued, or when the probe tore a
            # half-open link WE dialed — an inbound link's remote owns
            # healing it (and a tracker-style protected id could never
            # redial inbound anyway: reject_inbound_ids)
            redial = heal is not None and (bool(self._queue)
                                           or (reason == "probe"
                                               and not self._inbound))
            if circuit is not None and not self._progressed:
                # a session that never received anything counts
                # against the breaker (a progressed one reset it on
                # its first frame); a trip vetoes the redial
                tripped = circuit.record_failure(
                    self.endpoint._hclock(), heal)
                if tripped is not None:
                    redial = False
            # the decision and the torn sock become visible to the
            # writer TOGETHER — deciding after notify would race the
            # parked writer into a spurious dial before close() lands
            self._heal_pending = redial
            self._cond.notify_all()
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass
        if tripped is not None:
            self.endpoint._count("circuit", "open")
            self.endpoint._trace("circuit_open", remote=self.remote_id)
        if not redial:
            self.close("circuit_open" if tripped is not None
                       else "closed")

    def _mark_progress(self) -> None:
        """Reader-side: a frame arrived on this link session —
        re-close a tripped circuit on first progress."""
        if not self._progressed:
            self._progressed = True
            circuit = self.endpoint._circuit_for(self.remote_id)
            if circuit is not None and circuit.record_success() \
                    is not None:
                self.endpoint._count("circuit", "closed")

    def probe(self, probe_s: float) -> None:
        """Half-open detection (endpoint maintenance timer): a send
        stuck IN FLIGHT past the probe deadline tears the link for a
        fresh dial — the blackholed-peer shape where ``sendall``
        blocks forever once the socket buffer fills and TCP itself
        never reports an error.  Deliberately NOT a send-without-
        reply heuristic: one-way push links (a seeder broadcasting
        HAVEs to a quiet neighbor) are legitimate, and tearing them
        on a reply deadline would re-handshake every healthy such
        link once per probe window; a dead-but-unfilled pipe is the
        mesh layer's job (``PEER_IDLE_REAP_MS``) and the protocol
        timeouts' — transport healing triggers on transport
        evidence."""
        with self._cond:
            sock = self.sock
            if sock is None or self.closed:
                return
            started = self._send_started
            stuck = (started is not None
                     and time.monotonic() - started >= probe_s)  # clock-ok: _send_started timebase
        if stuck:
            self._link_down("probe", sock)

    def _connect_with_preamble(self) -> Optional[socket.socket]:
        try:
            host, port_s = self.remote_id.rsplit(":", 1)
            plan = self.endpoint.network.fault_plan
            stalled = False
            if plan is not None:
                kind = plan.on_connect()
                if kind == "refuse":
                    raise ConnectionRefusedError(
                        "injected connect refusal")
                stalled = kind == "stall"
            sock = socket.create_connection((host, int(port_s)),
                                            timeout=HANDSHAKE_TIMEOUT_S)
            # one absolute deadline for the whole handshake — TLS wrap
            # included: a byte-dribbling acceptor must not wedge the
            # writer thread
            deadline = time.monotonic() + HANDSHAKE_TIMEOUT_S  # clock-ok: socket deadline
            ssl_ctx = self.endpoint.network.ssl_client_context
            if ssl_ctx is not None:
                # confidentiality wrap BEFORE any identity bytes; the
                # PSK handshake + frame MACs run inside the channel
                tls = _tls_wrap(sock, ssl_ctx, deadline,
                                server_side=False, server_hostname=host)
                if tls is None:
                    return None  # _tls_wrap owns failure cleanup
                sock = tls
            if plan is not None:
                # the fault shim rides ABOVE any TLS wrap and UNDER
                # the identity handshake, so stall/latency exercise
                # the real deadline discipline (engine/netfaults.py)
                sock = FaultSocket(sock, plan, stalled=stalled)
            raw = self.endpoint.peer_id.encode()
            _send_with_deadline(sock, _LEN.pack(len(raw)) + raw,
                                deadline)
            psk = self.endpoint.network.psk
            if psk is not None:
                # prove swarm membership before any protocol frame;
                # contribute our own nonce so the per-connection frame
                # keys are fresh even if the acceptor's nonce repeats
                c_nonce = os.urandom(NONCE_LEN)
                _send_with_deadline(
                    sock, _LEN.pack(len(c_nonce)) + c_nonce, deadline)
                a_nonce = _read_frame(sock, max_bytes=MAX_AUTH_BYTES,
                                      deadline=deadline)
                # exact-length check (see NONCE_LEN): a variable-length
                # nonce makes the NUL-joined MAC/KDF input ambiguous
                if a_nonce is None or len(a_nonce) != NONCE_LEN:
                    sock.close()
                    return None
                mac = _psk_response(psk, a_nonce, c_nonce, raw)
                _send_with_deadline(sock, _LEN.pack(len(mac)) + mac,
                                    deadline)
                c2a, a2c = _derive_frame_keys(psk, a_nonce, c_nonce, raw)
                self.send_key, self.recv_key = c2a, a2c
            sock.settimeout(None)  # handshake timeout must not poison recv
            if isinstance(sock, FaultSocket):
                sock.arm_frames()  # send-fault indices count frames only
            return sock
        except (OSError, ValueError):
            return None

    def close(self, drop_reason: str = "closed") -> None:
        """Final teardown (no healing past this point).  Frames still
        queued are dropped and COUNTED under ``drop_reason`` — the
        self-heal give-up paths pass ``"giveup"``/``"circuit_open"``
        so the gate can join every abandoned queue to its cause."""
        with self._cond:
            if self.closed:
                return
            self.closed = True
            dropped = len(self._queue)
            self._queue.clear()
            self._queued_bytes = 0
            self._send_started = None
            sock = self.sock
            self._cond.notify_all()
        if dropped:
            self.endpoint._count("send_drops", drop_reason, n=dropped)
        if sock is not None:
            try:
                # shutdown, not just close: close() while the reader
                # thread is blocked in recv neither wakes it nor sends
                # FIN (the in-flight syscall pins the open file);
                # shutdown delivers EOF to both sides immediately
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        self.endpoint._forget(self)


def _read_exact(sock: socket.socket, n: int,
                deadline: Optional[float] = None) -> Optional[bytes]:
    """Read exactly ``n`` bytes.  With a ``deadline`` (absolute
    ``time.monotonic()`` seconds), every recv runs under the REMAINING
    budget — a per-recv timeout alone would let a byte-dribbling
    client pin the thread ~indefinitely (one byte per almost-timeout),
    which is exactly the handshake DoS the deadline exists to close."""
    buf = bytearray()
    while len(buf) < n:
        try:
            if deadline is not None:
                remaining = deadline - time.monotonic()  # clock-ok: socket deadline
                if remaining <= 0:
                    return None
                sock.settimeout(remaining)
            chunk = sock.recv(n - len(buf))  # loop-ok: legacy handshake read
        except OSError:
            return None  # connection torn down under us (or expired)
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def _send_with_deadline(sock: socket.socket, data: bytes,
                        deadline: float) -> None:
    """Handshake-side write under the REMAINING absolute budget —
    the write mirror of ``_read_exact``'s deadline discipline.  A
    backpressuring peer (zero receive window, never reads) blocks
    ``sendall`` just as effectively as a byte-dribbler blocks
    ``recv``, and each pinned handshake thread holds a
    MAX_PENDING_HANDSHAKES slot; plain sockets treat ``settimeout``
    as an overall sendall deadline, and ``_SafeTls`` honors it in
    its want-write loop.  Raises ``OSError`` on expiry like any
    other torn-down-connection write."""
    remaining = deadline - time.monotonic()  # clock-ok: socket deadline
    if remaining <= 0:
        raise socket.timeout("handshake deadline exceeded")
    sock.settimeout(remaining)
    sock.sendall(data)  # loop-ok: legacy threaded handshake send (deadline-bounded)


def _read_frame(sock: socket.socket,
                max_bytes: int = MAX_FRAME_BYTES,
                deadline: Optional[float] = None) -> Optional[bytes]:
    header = _read_exact(sock, _LEN.size, deadline)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > max_bytes:
        return None  # poisoned stream; drop the connection
    return _read_exact(sock, length, deadline)


class TcpEndpoint:
    """Socket-backed endpoint with the same surface the engine uses on
    the loopback fabric: ``peer_id``, ``send(dest_id, frame)``,
    ``on_receive``, ``close()``."""

    def __init__(self, network: "TcpNetwork", host: str):
        self.network = network
        self.loop = network.loop
        self.on_receive: Optional[Callable[[str, bytes], None]] = None
        self.closed = False
        #: traffic totals, deliberately UNLOCKED best-effort ``+=``
        #: from every writer/reader thread: they feed throughput
        #: dashboards where a dropped increment under a GIL-release
        #: race skews a rate chart by one frame, which is noise —
        #: unlike the attack counters below, whose bursts are exactly
        #: the moments contended increments get lost, so those bump
        #: locked registry Counters (_count).  Don't "fix" the
        #: asymmetry by locking these: they sit on the per-frame hot
        #: path.
        self.bytes_sent = 0
        self.bytes_received = 0
        # attack visibility (SECURITY.md): EVERY inbound handshake
        # turned away — failed TLS wrap, missing/oversized/non-UTF-8
        # preamble, host mismatch, protected-id claim, PSK failure,
        # and connect-flood shedding at the pending-handshake gate —
        # plus post-handshake frames dropped for MAC failure.  Since
        # the telemetry round the ONE store is the network registry's
        # labeled series (``net.handshake_rejects{reason=...}`` /
        # ``net.mac_drops``; Counter.inc carries the same per-bump
        # lock the old ``_stats_lock`` provided — these counters
        # exist precisely for high-concurrency attack bursts, where
        # unlocked += from 64 handshake threads would drop counts).
        # The ``handshake_rejects`` / ``mac_drops`` totals alerting
        # reads stay available as derived properties below.
        #: ids an inbound preamble may never claim (module docstring:
        #: trust model).  The agent adds its tracker id here.
        self.reject_inbound_ids: set = set()
        #: deliver inbound frames directly on the reader thread
        #: instead of posting them to the NetLoop.  Default False —
        #: the loop keeps single-threaded engine components
        #: single-threaded by construction.  A handler that is
        #: thread-safe end to end (the sharded tracker service:
        #: ``TrackerEndpoint(..., concurrent=True)`` sets this) opts
        #: in so concurrent remote announcers stop serializing on the
        #: one dispatch thread — the host-side analogue of the store's
        #: shard locks.
        self.deliver_inline = False
        self._conns: Dict[str, _Connection] = {}
        self._extra_conns: list = []  # crossed-dial inbound links
        self._conn_lock = threading.Lock()
        self._pending_handshakes = 0  # guarded by _conn_lock
        #: the network's ReconnectPolicy (None = self-healing off:
        #: every failure path behaves exactly as before this round)
        self._heal: Optional[ReconnectPolicy] = network.heal
        #: the policy clock (injectable seconds) every self-heal
        #: decision reads; plain monotonic when healing is off
        self._hclock = (self._heal.clock if self._heal is not None
                        else time.monotonic)
        #: per-remote circuit breakers (guarded by _conn_lock;
        #: size-bounded — attacker-claimable state, like the
        #: resolver cache)
        self._circuits: Dict[str, _Circuit] = {}
        self._reconnect_listeners: list = []
        self._probe_timer = None

        # deployment-scale knobs (TcpNetwork construction): instance
        # attributes so ONE big endpoint (a tracker serving a whole
        # fleet) can outgrow the class defaults without patching them
        # for every endpoint in the process
        if network.max_connections is not None:
            self.MAX_CONNECTIONS = network.max_connections
        if network.max_pending_handshakes is not None:
            self.MAX_PENDING_HANDSHAKES = network.max_pending_handshakes
        backlog = (network.listen_backlog
                   if network.listen_backlog is not None
                   else self.LISTEN_BACKLOG)

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, 0))
        self._listener.listen(backlog)
        self.peer_id = f"{host}:{self._listener.getsockname()[1]}"
        # registry handles pre-created (BEFORE the accept thread can
        # fire a flood reject): these bump during exactly the
        # high-concurrency attack bursts where a per-event registry
        # lookup (label keying + the registry lock) on top of the
        # bump lock would be avoidable contention — the same
        # reasoning as Tracker's reject handles
        registry = network.registry
        self._m_counts = {
            ("handshake_rejects", reason): registry.counter(
                "net.handshake_rejects", endpoint=self.peer_id,
                reason=reason)
            for reason in ("flood", "tls", "preamble", "identity",
                           "psk", "socket")}
        self._m_counts[("mac_drops", None)] = registry.counter(
            "net.mac_drops", endpoint=self.peer_id)
        # the self-healing families: reconnect attempts by
        # what took the link down, dropped frames by cause, circuit
        # transitions by new state
        for reason in ("connect", "send_error", "recv", "mac", "probe"):
            self._m_counts[("reconnects", reason)] = registry.counter(
                "net.reconnects", endpoint=self.peer_id, reason=reason)
        for reason in ("closed", "admission", "circuit_open",
                       "queue_full", "giveup"):
            self._m_counts[("send_drops", reason)] = registry.counter(
                "net.send_drops", endpoint=self.peer_id, reason=reason)
        for state in ("open", "half_open", "closed"):
            self._m_counts[("circuit", state)] = registry.counter(
                "net.circuit", endpoint=self.peer_id, state=state)
        self._begin_accept()
        self._arm_probe_timer()

    def _begin_accept(self) -> None:
        """Start taking inbound connections.  The threaded transport
        dedicates an accept thread; ``_LoopEndpoint`` registers the
        listener on the selector instead."""
        threading.Thread(target=self._accept_loop, daemon=True,  # loop-ok: legacy threads transport
                         name=f"p2p-accept-{self.peer_id}").start()

    def _make_connection(self, remote_id: str,
                         sock=None) -> "_Connection":
        """Connection factory — the one seam the loop transport
        overrides to mint per-connection state machines instead of
        thread pairs."""
        return _Connection(self, remote_id, sock)

    def _count(self, counter: str, reason: Optional[str] = None,
               n: int = 1) -> None:
        """Locked counter bump into the registry series — ONE lock per
        event (Counter.inc's): these feed alerting during exactly the
        high-concurrency bursts where unlocked ``+=`` from 64
        handshake threads would drop increments.  The handle table is
        built COMPLETE in ``__init__`` (keeping the registry lock off
        the burst path) and never mutated after, so an unknown
        ``(counter, reason)`` combo is a programming error that
        raises ``KeyError`` loudly instead of silently minting a new
        series — add new reasons to the ``__init__`` table."""
        self._m_counts[(counter, reason)].inc(n)

    def _trace(self, event: str, **fields) -> None:
        """One flight-recorder event per self-heal action when the
        network carries a recorder (``TcpNetwork(trace=...)``); the
        registry counters stay the source of truth either way."""
        recorder = self.network.trace
        if recorder is not None:
            recorder.emit("net", event=event, endpoint=self.peer_id,
                          **fields)

    #: bound on per-remote circuit-breaker entries (dialed remote ids
    #: are attacker-influenced state on open fabrics)
    MAX_CIRCUITS = 1024

    def _circuit_for(self, remote_id: str) -> Optional[_Circuit]:
        """Get-or-create the remote's breaker (None with healing
        off).  At the cap, clean breakers are pruned first — a dirty
        one holds cooldown state that still gates dials."""
        if self._heal is None:
            return None
        with self._conn_lock:
            circuit = self._circuits.get(remote_id)
            if circuit is None:
                if len(self._circuits) >= self.MAX_CIRCUITS:
                    clean = [rid for rid, c in self._circuits.items()
                             if c.state == _Circuit.CLOSED
                             and c.failures == 0]
                    for rid in clean or [next(iter(self._circuits))]:
                        del self._circuits[rid]
                circuit = self._circuits[remote_id] = _Circuit()
            return circuit

    def add_reconnect_listener(self, fn) -> None:
        """Subscribe ``fn(remote_id)`` to link RE-establishments
        (never first connects), delivered on the NetLoop.  The
        tracker client uses this to re-announce immediately after its
        tracker link heals, so swarm membership converges without
        waiting out the announce interval."""
        self._reconnect_listeners.append(fn)

    def _notify_reconnect(self, remote_id: str) -> None:
        listeners = list(self._reconnect_listeners)
        self._trace("reconnected", remote=remote_id)
        if not listeners:
            return

        def deliver() -> None:
            for fn in listeners:
                try:
                    fn(remote_id)
                except Exception:  # noqa: BLE001
                    log.exception("reconnect listener failed")

        self.loop.post(deliver)

    def _arm_probe_timer(self) -> None:
        """Start the half-open maintenance tick (no-op with healing
        off): every quarter of the probe deadline, every primary
        connection is checked for a stuck send or a silent
        send-without-reply window (see :meth:`_Connection.probe`)."""
        heal = self._heal
        if heal is None:
            return
        interval_ms = max(heal.idle_probe_s * 250.0, 50.0)

        def tick() -> None:
            if self.closed:
                return
            with self._conn_lock:
                conns = list(self._conns.values())
            for conn in conns:
                conn.probe(heal.idle_probe_s)
            self._probe_timer = self.loop.call_later(interval_ms, tick)

        self._probe_timer = self.loop.call_later(interval_ms, tick)

    @property
    def handshake_rejects(self) -> int:
        """Total inbound handshakes turned away (all reasons) —
        derived from the registry series, so the total and the
        :meth:`handshake_reject_reasons` breakdown cannot diverge.
        (The handle table is immutable after ``__init__``, so the
        bare iteration is thread-safe.)"""
        return sum(handle.value
                   for (counter, _r), handle in self._m_counts.items()
                   if counter == "handshake_rejects")

    @property
    def mac_drops(self) -> int:
        """Post-handshake frames dropped for MAC failure."""
        return self._m_counts[("mac_drops", None)].value

    def handshake_reject_reasons(self) -> Dict[str, int]:
        """Labeled snapshot of this endpoint's handshake rejects by
        reason (flood / tls / preamble / identity / psk / socket) —
        the registry-backed replacement for growing one attribute per
        reject class.  Read from the endpoint's own immutable handle
        table (the same instruments the registry serves), not a full
        registry scan: this may be polled while attack bursts bump
        the same registry."""
        return {reason: int(handle.value)
                for (counter, reason), handle in self._m_counts.items()
                if counter == "handshake_rejects"}

    def backlog_ms(self, dest_id: Optional[str] = None) -> float:
        """Uplink backlog estimate for the mesh's serve pacing
        (engine/mesh.py _pump_upload) — previously only the loopback
        fabric implemented this, silently disabling pacing on real
        sockets and letting a whole segment burst into the write
        queue where CANCEL could no longer reclaim it.

        With ``dest_id``, reports that destination's OWN link (TCP
        links drain independently, so one stalled peer must not
        head-of-line-block serves to healthy ones); without, the
        most-backlogged link."""
        with self._conn_lock:
            if dest_id is not None:
                conn = self._conns.get(dest_id)
                return conn.backlog_ms() if conn is not None else 0.0
            conns = list(self._conns.values()) + list(self._extra_conns)
        return max((conn.backlog_ms() for conn in conns), default=0.0)

    def _evict_for_admission_locked(self):
        """Caller holds ``_conn_lock``.  Decide whether a NEW
        connection may register: under the cap → yes; at the cap →
        evict the least-recently-active link idle past
        CONN_IDLE_EVICT_S (returned for the caller to close OUTSIDE
        the lock — close() re-enters via _forget); every link busy →
        refuse.  See MAX_CONNECTIONS."""
        # count only live links: a conn sets closed=True before its
        # close() reaches _forget, and a replacement racing that
        # window must not evict a healthy third party (or be refused)
        # on account of a dead entry that is already on its way out
        live = [c for c in list(self._conns.values()) + self._extra_conns
                if not c.closed]
        if len(live) < self.MAX_CONNECTIONS:
            return True, None
        now = time.monotonic()  # clock-ok: at-cap idle eviction reads the eviction-hint timebase
        candidates = [
            c for c in live
            if now - c.last_activity >= self.CONN_IDLE_EVICT_S]
        if not candidates:
            return False, None
        victim = min(candidates, key=lambda c: c.last_activity)
        if self._conns.get(victim.remote_id) is victim:
            del self._conns[victim.remote_id]
        elif victim in self._extra_conns:
            self._extra_conns.remove(victim)
        return True, victim

    # -- outbound ------------------------------------------------------
    def send(self, dest_id: str, frame: bytes) -> bool:
        """Queue a frame; never blocks.  True means queued — like the
        loopback fabric, delivery is not acknowledged and receivers
        rely on protocol timeouts.  Every False is a COUNTED drop
        (``net.send_drops{reason}``): dead endpoint, circuit cooldown,
        all-links-busy admission refusal, or the bounded queue."""
        started = victim = None
        drop = None
        with self._conn_lock:
            # closed-check inside the lock: a send racing close() must
            # not register a fresh connection on a dead endpoint
            if self.closed:
                drop = "closed"
            else:
                conn = self._conns.get(dest_id)
                if conn is None or conn.closed:
                    circuit = self._circuits.get(dest_id)
                    if circuit is not None \
                            and circuit.blocked(self._hclock()):
                        # cooling down: never a hot dial loop
                        drop = "circuit_open"
                    else:
                        admit, victim = \
                            self._evict_for_admission_locked()
                        if not admit:
                            # every link busy; like a full queue
                            drop = "admission"
                        else:
                            conn = started = \
                                self._make_connection(dest_id)
                            self._conns[dest_id] = conn
        if drop is not None:
            self._count("send_drops", drop)
            return False
        if victim is not None:
            victim.close()
        queued = conn.enqueue(frame)
        if started is not None:
            started.start()
        return queued

    def _forget(self, conn: "_Connection") -> None:
        """Prune a dead connection so reconnects get a fresh link."""
        with self._conn_lock:
            if self._conns.get(conn.remote_id) is conn:
                del self._conns[conn.remote_id]
            elif conn in self._extra_conns:
                self._extra_conns.remove(conn)

    # -- inbound -------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self.closed:
            try:
                sock, _addr = self._listener.accept()  # loop-ok: legacy threaded accept loop
            except OSError:
                return
            with self._conn_lock:
                # gate BEFORE spawning: a connect flood must not pin
                # one thread + fd per dial for the handshake timeout
                admit = (not self.closed and self._pending_handshakes
                         < self.MAX_PENDING_HANDSHAKES)
                if admit:
                    self._pending_handshakes += 1
            if not admit:
                if not self.closed:
                    # flood shedding — but the close()-time wake
                    # self-connect must not count as an attack
                    self._count("handshake_rejects", reason="flood")
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            threading.Thread(target=self._handshake_tracked,  # loop-ok: legacy threads transport
                             args=(sock,), daemon=True).start()

    def _handshake_tracked(self, sock: socket.socket) -> None:
        try:
            self._handshake_inbound(sock)
        finally:
            with self._conn_lock:
                self._pending_handshakes -= 1

    #: a peer-id preamble is a short host:port string — an
    #: unauthenticated connection must not get to buffer a full-size
    #: frame before identity validation
    MAX_PREAMBLE_BYTES = 512
    #: bound on live connections (each one holds a socket + writer
    #: thread + reader thread): a swarm neighbor set is tracker-fed
    #: and small, so hundreds is already generous.  At the cap, the
    #: least-recently-active connection idle past
    #: CONN_IDLE_EVICT_S is evicted to admit the newcomer (so
    #: neighbor churn can never wedge the endpoint deaf behind dead
    #: links); if every link is genuinely active, the newcomer is
    #: refused.  Enforced on BOTH inbound registration and outbound
    #: connection creation.
    MAX_CONNECTIONS = 256
    #: a connection this long without a frame either way is fair
    #: game for at-cap eviction (the mesh's announce cadence keeps
    #: healthy neighbors far below this)
    CONN_IDLE_EVICT_S = 60.0
    #: concurrent inbound handshakes allowed to be in flight; past
    #: this, accepted sockets are closed immediately — a connect
    #: flood must not pin one thread + fd per dial for the whole
    #: handshake timeout
    MAX_PENDING_HANDSHAKES = 64
    #: kernel accept backlog.  Sized for the loop transport, where a
    #: pack of hundreds of peers may dial one tracker endpoint inside
    #: a single RTT; the threaded transport drains accepts fast
    #: enough that the old 16 never mattered, and a deeper backlog
    #: costs nothing there
    LISTEN_BACKLOG = 128

    def _handshake_inbound(self, sock: socket.socket) -> None:
        # the whole identity handshake runs under ONE absolute
        # deadline: a connection that sends nothing — or dribbles one
        # byte per almost-timeout — must not pin this thread
        deadline = time.monotonic() + HANDSHAKE_TIMEOUT_S  # clock-ok: socket deadline
        ssl_ctx = self.network.ssl_server_context
        if ssl_ctx is not None:
            # the TLS handshake runs on THIS per-handshake thread,
            # under the same ABSOLUTE deadline as the identity bytes
            # that follow — never on the accept loop
            tls = _tls_wrap(sock, ssl_ctx, deadline, server_side=True)
            if tls is None:
                self._count("handshake_rejects", reason="tls")
                return  # _tls_wrap owns failure cleanup
            sock = tls
        if self.network.fault_plan is not None:
            # accepted links get the fault shim too (send-side faults
            # apply wherever the serve traffic actually rides)
            sock = FaultSocket(sock, self.network.fault_plan)
        preamble = _read_frame(sock, max_bytes=self.MAX_PREAMBLE_BYTES,
                               deadline=deadline)
        if preamble is None:
            self._count("handshake_rejects", reason="preamble")
            sock.close()
            return
        try:
            remote_id = preamble.decode("utf-8")
        except UnicodeDecodeError:
            self._count("handshake_rejects", reason="preamble")
            sock.close()
            return
        # identity binding (module docstring: trust model): the
        # claimed listener must live on the address this socket
        # actually comes from, and protected ids (the tracker's) may
        # not be claimed inbound at all
        claimed_host = remote_id.rsplit(":", 1)[0]
        try:
            observed_host = sock.getpeername()[0]
        except OSError:
            self._count("handshake_rejects", reason="socket")
            sock.close()
            return
        if remote_id in self.reject_inbound_ids or (
                self.network.verify_inbound_host
                and not self.network._host_matches(claimed_host,
                                                   observed_host)):
            log.warning("rejecting inbound connection claiming %r from %s",
                        remote_id, observed_host)
            self._count("handshake_rejects", reason="identity")
            sock.close()
            return
        psk = self.network.psk
        frame_keys = None
        if psk is not None:
            # challenge-response (module docstring: trust model): the
            # claimed id is only believed once the connector proves it
            # holds the swarm PSK for THIS nonce
            a_nonce = os.urandom(NONCE_LEN)
            try:
                # deadline-bounded write: a connector that opens the
                # connection and never reads would otherwise block
                # this sendall indefinitely, pinning the
                # MAX_PENDING_HANDSHAKES slot its dial consumed
                _send_with_deadline(
                    sock, _LEN.pack(len(a_nonce)) + a_nonce, deadline)
            except OSError:
                self._count("handshake_rejects", reason="socket")
                sock.close()
                return
            c_nonce = _read_frame(sock, max_bytes=MAX_AUTH_BYTES,
                                  deadline=deadline)
            # exact-length check (see NONCE_LEN): a connector-chosen
            # variable-length nonce could shift bytes between the
            # nonce and claimed-id fields of the NUL-joined MAC/KDF
            # input without changing it — the boundary-ambiguity
            # splice an on-path attacker needs
            if c_nonce is not None and len(c_nonce) != NONCE_LEN:
                c_nonce = None
            mac = (None if c_nonce is None else
                   _read_frame(sock, max_bytes=MAX_AUTH_BYTES,
                               deadline=deadline))
            if mac is None or not hmac.compare_digest(
                    mac, _psk_response(psk, a_nonce, c_nonce, preamble)):
                log.warning("rejecting unauthenticated inbound claiming "
                            "%r from %s", remote_id, observed_host)
                self._count("handshake_rejects", reason="psk")
                sock.close()
                return
            frame_keys = _derive_frame_keys(psk, a_nonce, c_nonce, preamble)
        try:
            sock.settimeout(None)  # handshake done; reads block freely
        except OSError:
            # the peer passed auth but the socket died under us before
            # registration — still a turned-away inbound handshake,
            # and alerting should see it
            self._count("handshake_rejects", reason="socket")
            sock.close()
            return
        if isinstance(sock, FaultSocket):
            sock.arm_frames()  # send-fault indices count frames only
        conn = self._make_connection(remote_id, sock)
        if frame_keys is not None:
            # acceptor sends on the a2c key, verifies on c2a — set
            # before start() spawns the reader (happens-before)
            conn.recv_key, conn.send_key = frame_keys
        self._admit_inbound(conn)

    def _admit_inbound(self, conn: "_Connection") -> bool:
        """Register an authenticated inbound connection (shared by
        the blocking and staged handshake paths).  Returns True with
        the connection started, False after closing it (endpoint
        closed, or admission refused at the cap)."""
        victim = None
        with self._conn_lock:
            # a handshake racing close() must not register a fresh
            # connection on a dead endpoint (same guard as send()):
            # close() has already reaped its snapshot, so anything
            # added now would leak its writer thread + socket forever
            if self.closed:
                register = False
            else:
                # reuse: an inbound link doubles as our outbound to
                # them; a stale dead entry must not shadow the fresh
                # link
                existing = self._conns.get(conn.remote_id)
                if existing is not None and not existing.closed:
                    # crossed dial: both sides connected
                    # simultaneously.  This inbound IS the remote's
                    # working outbound — keep reading from it, but
                    # track it separately so close() still reaps it
                    # (untracked = socket+thread leak).  A duplicate
                    # link to an ALREADY-CONNECTED peer never evicts
                    # a third party (a re-dialing neighbor must not
                    # be able to churn out idle legitimate links);
                    # admit only if the cap has room.
                    register = (len(self._conns) + len(self._extra_conns)
                                < self.MAX_CONNECTIONS)
                    if register:
                        self._extra_conns.append(conn)
                else:
                    register, victim = self._evict_for_admission_locked()
                    if register:
                        self._conns[conn.remote_id] = conn
        if victim is not None:
            victim.close()  # outside the lock: close() re-enters _forget
        if not register:
            conn.close()
            return False
        conn.start()
        return True

    def _reader_loop(self, conn: _Connection, sock=None,
                     recv_key=None) -> None:
        # THIS link session's socket and key: a healed connection
        # swaps both, and a stale reader must neither read the fresh
        # socket nor touch the fresh MAC state (its _link_down
        # reports are ignored by the sock identity check).  Redial
        # spawns pass them explicitly AT SPAWN TIME; the inbound
        # start() spawn reads them here, which is race-free there —
        # an inbound conn's sock cannot be replaced before its first
        # reader runs (no queue, so no redial path)
        if sock is None:
            sock = conn.sock
            recv_key = conn.recv_key
        # the inbound MAC sequence is LOCAL to this reader: every
        # link session starts at 0 by protocol, and a shared field
        # would let a stale reader's increment corrupt the healed
        # session's expectation (one spurious MAC tear per race)
        recv_seq = 0
        # the tag rides INSIDE the length-prefixed record, so an
        # authenticated link's wire records run up to tag-length past
        # the payload cap — a max-size frame must stay deliverable on
        # both fabrics
        max_wire = MAX_FRAME_BYTES + (FRAME_MAC_LEN
                                      if recv_key is not None else 0)
        while not self.closed and not conn.closed \
                and conn.sock is sock:
            frame = _read_frame(sock, max_bytes=max_wire)
            if frame is None:
                conn._link_down("recv", sock)
                return
            if recv_key is not None:
                # per-frame integrity (module docstring: trust model):
                # strip + verify the tag against this direction's key
                # and the expected sequence number.  Any mismatch —
                # missing tag, forged tag, replayed/spliced frame —
                # drops the connection, the same fail-closed
                # discipline the wire decoder applies (a healed link
                # re-handshakes from scratch: fresh keys, sequence 0)
                if len(frame) < FRAME_MAC_LEN:
                    log.warning("dropping %s: untagged frame on an "
                                "authenticated link", conn.remote_id)
                    self._count("mac_drops")
                    conn._link_down("mac", sock)
                    return
                body, tag = frame[:-FRAME_MAC_LEN], frame[-FRAME_MAC_LEN:]
                if not hmac.compare_digest(
                        tag, _frame_tag(recv_key, recv_seq, body)):
                    log.warning("dropping %s: frame MAC mismatch "
                                "(injection or splice?)", conn.remote_id)
                    self._count("mac_drops")
                    conn._link_down("mac", sock)
                    return
                recv_seq += 1
                frame = body
            conn.last_activity = time.monotonic()  # clock-ok: eviction hint
            conn._mark_progress()
            self.bytes_received += len(frame)
            src = conn.remote_id

            if self.deliver_inline:
                # opt-in fast path (see the field docs): the handler
                # runs HERE, concurrently across reader threads.  A
                # handler bug must cost this connection's frame, not
                # the reader thread (the loop path gets the same
                # containment from NetLoop._run)
                if not self.closed and self.on_receive is not None:
                    try:
                        self.on_receive(src, frame)
                    except Exception:  # noqa: BLE001
                        log.exception("unhandled error in inline "
                                      "frame handler")
                continue

            def deliver(frame=frame, src=src) -> None:
                if not self.closed and self.on_receive is not None:
                    self.on_receive(src, frame)

            self.loop.post(deliver)

    def close(self) -> None:
        with self._conn_lock:
            if self.closed:
                return  # idempotent: dispose() and network.close() race
            self.closed = True
            conns = list(self._conns.values()) + list(self._extra_conns)
            self._conns.clear()
            self._extra_conns.clear()
            probe_timer = self._probe_timer
            self._probe_timer = None
        if probe_timer is not None:
            probe_timer.cancel()
        self._close_listener()
        for conn in conns:  # outside the lock: close() calls _forget()
            conn.close()
        self.network._forget_endpoint(self)

    def _close_listener(self) -> None:
        try:
            # shutdown BEFORE close, like _Connection.close: close()
            # alone does not wake a thread blocked in accept() — the
            # in-flight syscall pins the fd and the accept loop (and
            # its listener socket) leaks on every endpoint close.
            # Linux wakes the accept here; BSD/macOS raise ENOTCONN
            # on a LISTEN socket, so the self-connect below is the
            # portable wake-up for them.
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            wake_host, wake_port = self._listener.getsockname()[:2]
            if wake_host in ("0.0.0.0", "::"):
                # a wildcard bind address is not dialable; the wake
                # must target a concrete loopback or BSD/macOS
                # (where shutdown doesn't wake accept) re-leaks the
                # accept thread this self-connect exists to free
                wake_host = "127.0.0.1" if wake_host == "0.0.0.0" else "::1"
            wake = socket.create_connection((wake_host, wake_port),
                                            timeout=1.0)
            wake.close()
        except OSError:
            pass  # already woken (Linux) or listener already dead
        try:
            self._listener.close()
        except OSError:
            pass


class _LoopConnection(_Connection):
    """One TCP link as a per-connection state machine on the NetLoop
    selector core (the C10K round) — same wire protocol, framing,
    MAC discipline, healing policy, and counter semantics as the
    threaded :class:`_Connection`, with the writer/reader thread pair
    replaced by non-blocking callbacks:

    - partial reads accumulate in ``_rbuf`` until a full
      length-prefixed record parses;
    - partial writes keep the in-flight wire + offset in
      ``_wire``/``_wire_off`` and resume on the next writable event;
    - the wire for a frame is built LAZILY at flush start (MAC key +
      sequence snapshotted then), so a frame that survives a link
      death re-MACs under the healed link's fresh keys;
    - dials/redials are staged through :class:`_LoopDial` with the
      exact per-attempt accounting of ``_Connection._establish``
      (circuit gate → reconnect count → backoff timer);
    - fault verdicts come from ``FaultSocket.stage_frame`` /
      ``_FaultHold`` instead of blocking sleeps.

    Threading contract: ``enqueue``/``probe``/``close``/``_link_down``
    are callable from ANY thread (the engine and the probe timer use
    them); every fd operation — selector registration and the final
    ``close()`` of a socket — happens ONLY on the loop thread, so a
    freshly dialed socket can never collide with a stale selector key
    for a recycled descriptor.  Foreign threads ``shutdown()`` (which
    wakes the loop with EOF/error) and post the fd teardown."""

    def __init__(self, endpoint: "TcpEndpoint", remote_id: str,
                 sock=None):
        super().__init__(endpoint, remote_id, sock)
        self.loop = endpoint.loop
        # loop-thread-private I/O state (no lock: single-threaded by
        # construction; _link_down from foreign threads never touches
        # these — the posted teardown resets them on the loop)
        self._rbuf = bytearray()
        self._recv_seq = 0
        self._wire = None          # staged bytes of the in-flight frame
        self._wire_off = 0
        self._wire_kind = "send"   # "send" | "rst" | "partial"
        self._wire_staged = False  # fault verdict already taken?
        self._wire_delayed = False  # injected latency already applied?
        self._wire_t0 = 0.0
        self._wedged = False       # injected partial-write stall
        self._read_paused = False  # _FaultHold on recv
        self._write_paused = False  # _FaultHold / injected latency
        self._flush_on_read = False  # TLS wants READ to finish a send
        self._registered_sock = None
        self._events = 0
        self._dial: Optional["_LoopDial"] = None
        self._attempt = 0
        self._redialing = False
        self._dial_reason = "connect"

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        if self._inbound:
            self.loop.run_soon(self._attach_inbound)
        else:
            self.loop.run_soon(self._begin_dial)

    def _attach_inbound(self) -> None:  # loop thread
        with self._cond:
            sock = self.sock
            if self.closed or sock is None:
                return
        try:
            sock.setblocking(False)
        except OSError:
            self._link_down("recv", sock)
            return
        self._update_interest()
        # bytes the handshake's reads overshot into (the first
        # frames can ride the same segment as the final MAC record)
        # are already drained from the kernel — select will never
        # re-report them, so parse them NOW
        if self._rbuf and not self._parse_records(sock):
            return

    # -- selector interest ---------------------------------------------

    def _update_interest(self) -> None:  # loop thread
        with self._cond:
            sock = self.sock
            closed = self.closed
            pending = self._wire is not None or bool(self._queue)
        if closed or sock is None:
            return
        want = 0
        if not self._read_paused:
            want |= selectors.EVENT_READ
        if pending and not (self._wedged or self._write_paused):
            want |= selectors.EVENT_WRITE
        if self._registered_sock is not sock:
            if self._registered_sock is not None:
                self.loop.unregister(self._registered_sock)
                self._registered_sock = None
            if want:
                self.loop.register(sock, want, self._on_io)
                self._registered_sock = sock
            self._events = want
            return
        if want == self._events:
            return
        if want == 0:
            self.loop.unregister(sock)
            self._registered_sock = None
        else:
            self.loop.modify(sock, want, self._on_io)
        self._events = want

    def _kick(self) -> None:  # loop thread (posted by enqueue)
        if self.closed:
            return
        self._update_interest()

    def enqueue(self, frame: bytes) -> bool:
        queued = super().enqueue(frame)
        if queued:
            self.loop.note_pending_write(len(frame))
            self.loop.run_soon(self._kick)
        return queued

    # -- I/O callbacks -------------------------------------------------

    def _on_io(self, mask: int) -> None:  # loop thread
        with self._cond:
            sock = self.sock
            if self.closed or sock is None:
                return
        if sock is not self._registered_sock:
            return  # stale event for a replaced link
        if mask & selectors.EVENT_READ:
            self._on_readable(sock)
            with self._cond:
                if self.closed or self.sock is not sock:
                    return
        if mask & selectors.EVENT_WRITE:
            self._flush(sock)

    def _resume_read(self) -> None:  # loop thread (fault-hold timer)
        if self.closed:
            return
        self._read_paused = False
        self._update_interest()

    def _resume_write(self) -> None:  # loop thread (delay/hold timer)
        if self.closed:
            return
        self._write_paused = False
        self._update_interest()

    def _on_readable(self, sock) -> None:  # loop thread
        # drain until EAGAIN: an SSLSocket buffers decrypted bytes
        # internally, so stopping after one recv would strand them
        # (the kernel fd never signals readable for them again)
        while True:
            try:
                data = sock.recv(65536)  # loop-ok: non-blocking recv on the loop
            except _FaultHold as hold:
                self._read_paused = True
                self.loop.call_later(hold.retry_ms, self._resume_read)
                self._update_interest()
                return
            except (ssl.SSLWantReadError, ssl.SSLWantWriteError):
                break
            except BlockingIOError:
                break
            except OSError:
                self._link_down("recv", sock)
                return
            if not data:
                self._link_down("recv", sock)
                return
            self._rbuf += data
            if not self._parse_records(sock):
                return
        if self._flush_on_read:
            self._flush_on_read = False
            self._write_paused = False
            self._update_interest()
            self._flush(sock)

    def _parse_records(self, sock) -> bool:  # loop thread
        """Deliver every complete record buffered so far.  Returns
        False when the link died (or was replaced) under a handler."""
        while True:
            with self._cond:
                if self.closed or self.sock is not sock:
                    return False
                recv_key = self.recv_key
            max_wire = MAX_FRAME_BYTES + (FRAME_MAC_LEN
                                          if recv_key is not None else 0)
            if len(self._rbuf) < _LEN.size:
                return True
            (length,) = _LEN.unpack_from(self._rbuf)
            if length > max_wire:
                self._link_down("recv", sock)  # poisoned stream
                return False
            if len(self._rbuf) < _LEN.size + length:
                return True
            frame = bytes(self._rbuf[_LEN.size:_LEN.size + length])
            del self._rbuf[:_LEN.size + length]
            if recv_key is not None:
                if len(frame) < FRAME_MAC_LEN:
                    log.warning("dropping %s: untagged frame on an "
                                "authenticated link", self.remote_id)
                    self.endpoint._count("mac_drops")
                    self._link_down("mac", sock)
                    return False
                body, tag = (frame[:-FRAME_MAC_LEN],
                             frame[-FRAME_MAC_LEN:])
                if not hmac.compare_digest(
                        tag, _frame_tag(recv_key, self._recv_seq, body)):
                    log.warning("dropping %s: frame MAC mismatch "
                                "(injection or splice?)", self.remote_id)
                    self.endpoint._count("mac_drops")
                    self._link_down("mac", sock)
                    return False
                self._recv_seq += 1
                frame = body
            self.last_activity = time.monotonic()  # clock-ok: eviction hint
            self._mark_progress()
            endpoint = self.endpoint
            endpoint.bytes_received += len(frame)
            # delivery runs HERE — the loop thread IS the dispatch
            # thread, so the single-threaded-engine contract holds by
            # construction (deliver_inline is a no-op distinction on
            # this transport).  A handler bug costs this frame, not
            # the loop (same containment as NetLoop._run_cb).
            if not endpoint.closed and endpoint.on_receive is not None:
                try:
                    endpoint.on_receive(self.remote_id, frame)
                except Exception:  # noqa: BLE001
                    log.exception("unhandled error in frame handler")

    # -- write path ----------------------------------------------------

    def _flush(self, sock) -> None:  # loop thread
        while True:
            if self._wire is None:
                with self._cond:
                    if self.closed or self.sock is not sock:
                        return
                    if not self._queue:
                        self._update_interest()
                        return
                    frame = self._queue[0]
                    send_key = self.send_key
                    send_seq = self._send_seq
                    if send_key is not None:
                        self._send_seq += 1
                    t0 = time.monotonic()  # clock-ok: stall-floor timebase
                    self._send_started = t0
                if send_key is not None:
                    tag = _frame_tag(send_key, send_seq, frame)
                    wire = b"".join((_LEN.pack(len(frame) + len(tag)),
                                     frame, tag))
                else:
                    wire = _LEN.pack(len(frame)) + frame
                self._wire = wire
                self._wire_off = 0
                self._wire_kind = "send"
                self._wire_staged = False
                self._wire_delayed = False
                self._wire_t0 = t0
            else:
                with self._cond:
                    if self.closed or self.sock is not sock \
                            or not self._queue:
                        return
                    frame = self._queue[0]
            if not self._wire_staged:
                if isinstance(sock, FaultSocket):
                    verdict, arg = sock.stage_frame(
                        self._wire, delayed=self._wire_delayed)
                    if verdict == "delay":
                        self._wire_delayed = True
                        self._write_paused = True
                        self.loop.call_later(arg, self._resume_write)
                        self._update_interest()
                        return
                    if verdict == "swallow":
                        # the wire never sees the record, but the
                        # sender accounts it sent (the MAC-sequence
                        # desync downstream is the injected fault)
                        self._complete_frame(sock, frame,
                                             self._wire_t0)
                        continue
                    self._wire_kind = verdict
                    self._wire = arg
                    self._wire_off = 0
                self._wire_staged = True
            view = memoryview(self._wire)
            while self._wire_off < len(view):
                try:
                    n = sock.send(view[self._wire_off:])  # loop-ok: non-blocking send on the loop
                except _FaultHold as hold:
                    self._write_paused = True
                    self.loop.call_later(hold.retry_ms,
                                         self._resume_write)
                    self._update_interest()
                    return
                except ssl.SSLWantWriteError:
                    self._update_interest()
                    return
                except ssl.SSLWantReadError:
                    # TLS needs inbound bytes to make write progress;
                    # writable-spin until then would starve the loop
                    self._flush_on_read = True
                    self._write_paused = True
                    self._update_interest()
                    return
                except BlockingIOError:
                    self._update_interest()
                    return
                except OSError:
                    with self._cond:
                        self._send_started = None
                    self._link_down("send_error", sock)
                    return
                self._wire_off += n
            if self._wire_kind == "rst":
                # half the frame left, then the injected reset: the
                # frame stays queued for the healed link (peek/pop
                # discipline), exactly like the blocking shim's
                # ConnectionResetError out of sendall
                with self._cond:
                    self._send_started = None
                self._link_down("send_error", sock)
                return
            if self._wire_kind == "partial":
                # half the frame then a wedge: keep _send_started so
                # the idle probe is what tears the half-open link
                self._wedged = True
                self._update_interest()
                return
            self._complete_frame(sock, frame, self._wire_t0)

    def _complete_frame(self, sock, frame, t0) -> None:  # loop thread
        elapsed = time.monotonic() - t0  # clock-ok: EWMA measurement
        self.endpoint.bytes_sent += len(frame)
        self._wire = None
        self._wire_off = 0
        self._wire_staged = False
        with self._cond:
            self._send_started = None
            if self._queue and self._queue[0] is frame:
                self._queue.pop(0)
                self._queued_bytes -= len(frame)
                self.loop.note_pending_write(-len(frame))
            if elapsed > 0.0:
                inst_bps = len(frame) * 8.0 / elapsed
                self._drain_bps = (inst_bps if self._drain_bps == 0.0
                                   else 0.8 * self._drain_bps
                                   + 0.2 * inst_bps)

    # -- link death / healing ------------------------------------------

    def _link_down(self, reason: str, sock) -> None:
        """Any-thread-safe (the probe timer and engine threads call
        this): state flips under ``_cond``, the socket is shutdown()
        immediately (wakes the loop), and the fd teardown + redial
        run on the loop thread in FIFO order — teardown strictly
        before any new dial, so a recycled descriptor can never meet
        a stale selector key."""
        heal = self.endpoint._heal
        circuit = (self.endpoint._circuit_for(self.remote_id)
                   if heal is not None else None)
        tripped = None
        with self._cond:
            if self.closed or sock is None or self.sock is not sock:
                return  # stale report from an already-replaced link
            self.sock = None
            self._down_reason = reason
            self.send_key = self.recv_key = None
            self._send_started = None
            redial = heal is not None and (bool(self._queue)
                                           or (reason == "probe"
                                               and not self._inbound))
            if circuit is not None and not self._progressed:
                tripped = circuit.record_failure(
                    self.endpoint._hclock(), heal)
                if tripped is not None:
                    redial = False
            self._heal_pending = redial
            self._cond.notify_all()
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        if not self.loop.run_soon(lambda: self._teardown_sock(sock)):
            try:
                sock.close()  # loop already stopped: nothing to race
            except OSError:
                pass
        if tripped is not None:
            self.endpoint._count("circuit", "open")
            self.endpoint._trace("circuit_open", remote=self.remote_id)
        if not redial:
            self.close("circuit_open" if tripped is not None
                       else "closed")
        else:
            self.loop.run_soon(self._begin_redial)

    def _teardown_sock(self, sock) -> None:  # loop thread
        if self._registered_sock is sock:
            self.loop.unregister(sock)
            self._registered_sock = None
            self._events = 0
        with self._cond:
            current = self.sock
        if current is None or current is sock:
            # loop-private I/O state belongs to the dead link; a
            # healed link re-initializes its own on install (the
            # guard keeps a late teardown from clobbering it)
            self._wire = None
            self._wire_staged = False
            self._wedged = False
            self._read_paused = self._write_paused = False
            self._flush_on_read = False
        try:
            sock.close()
        except OSError:
            pass

    # -- outbound dial machinery ---------------------------------------

    def _begin_dial(self) -> None:  # loop thread
        with self._cond:
            if self.closed:
                return
            self._redialing = self._down_reason is not None
            self._dial_reason = self._down_reason or "connect"
        self._attempt = 0
        self._dial_attempt()

    def _begin_redial(self) -> None:  # loop thread
        with self._cond:
            if self.closed or not self._heal_pending \
                    or self.sock is not None:
                return
        self._begin_dial()

    def _dial_attempt(self) -> None:  # loop thread
        # per-attempt accounting mirrors _Connection._establish
        # exactly: circuit gate → reconnect count/trace → dial
        endpoint = self.endpoint
        with self._cond:
            if self.closed:
                return
        circuit = endpoint._circuit_for(self.remote_id)
        if circuit is not None:
            allowed, probe = circuit.allow_attempt(endpoint._hclock())
            if not allowed:
                self.close(drop_reason="circuit_open")
                return
            if probe is not None:
                endpoint._count("circuit", "half_open")
        if self._redialing or self._attempt > 0:
            endpoint._count("reconnects", self._dial_reason)
            endpoint._trace("reconnect", remote=self.remote_id,
                            reason=self._dial_reason,
                            attempt=self._attempt)
        self._dial = _LoopDial(self)
        self._dial.start()

    def _dial_failed(self, dial: "_LoopDial") -> None:  # loop thread
        if dial is not self._dial:
            return  # aborted by close(); nothing more to do
        self._dial = None
        endpoint = self.endpoint
        heal = endpoint._heal
        circuit = endpoint._circuit_for(self.remote_id)
        if circuit is not None and heal is not None:
            tripped = circuit.record_failure(endpoint._hclock(), heal)
            if tripped is not None:
                endpoint._count("circuit", "open")
                endpoint._trace("circuit_open", remote=self.remote_id)
                self.close(drop_reason="circuit_open")
                return
        self._attempt += 1
        if heal is None or self._attempt > heal.max_retries:
            self.close(drop_reason="giveup")
            return
        self.loop.call_later(heal.backoff_s(self._attempt - 1) * 1000.0,
                             self._dial_attempt)

    def _dial_succeeded(self, dial: "_LoopDial", sock,
                        send_key, recv_key) -> None:  # loop thread
        if dial is not self._dial:
            try:
                sock.close()  # close() raced the dial; we own cleanup
            except OSError:
                pass
            return
        self._dial = None
        with self._cond:
            installed = not self.closed
            if installed:
                self.sock = sock
                self._heal_pending = False
                # whatever its origin, the link is now one WE dialed
                # — probe-healing is ours from here
                self._inbound = False
                self.send_key, self.recv_key = send_key, recv_key
                self._send_seq = 0
                self._down_reason = None
                self._progressed = False
                self._send_started = None
        if not installed:
            try:
                sock.close()
            except OSError:
                pass
            return
        # fresh link session: loop-private I/O state starts clean
        # (fresh buffer OBJECT — a foreign-thread _link_down must
        # never mutate the one a stale parse might still hold).  The
        # dial's read overshoot seeds the buffer: the acceptor's
        # first frames can ride the same segment as its last
        # handshake record, and select never re-reports drained bytes
        self._rbuf = bytearray(dial._rbuf)
        self._recv_seq = 0
        self._wire = None
        self._wire_off = 0
        self._wire_staged = False
        self._wedged = False
        self._read_paused = self._write_paused = False
        self._flush_on_read = False
        self._update_interest()
        if self._redialing or self._attempt > 0:
            self.endpoint._notify_reconnect(self.remote_id)
        if self._rbuf and not self._parse_records(sock):
            return

    # -- teardown ------------------------------------------------------

    def _flush_pending(self) -> bool:
        """Would giving the loop a moment let queued frames still
        reach the wire?  Advisory (endpoint close drain): True while
        bytes are queued AND a live link, an in-flight dial, or a
        sanctioned redial could drain them."""
        with self._cond:
            if self.closed or self._wedged:
                return False
            if self._queued_bytes <= 0 and self._wire is None:
                return False
            return (self.sock is not None or self._dial is not None
                    or self._heal_pending)

    def close(self, drop_reason: str = "closed") -> None:
        with self._cond:
            if self.closed:
                return
            self.closed = True
            dropped = len(self._queue)
            dropped_bytes = self._queued_bytes
            self._queue.clear()
            self._queued_bytes = 0
            self._send_started = None
            sock = self.sock
            self._cond.notify_all()
        if dropped:
            self.endpoint._count("send_drops", drop_reason, n=dropped)
        if dropped_bytes:
            self.loop.note_pending_write(-dropped_bytes)
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

        def teardown() -> None:
            dial, self._dial = self._dial, None
            if dial is not None:
                dial.abort()
            if sock is not None:
                self._teardown_sock(sock)

        if not self.loop.run_soon(teardown):
            # loop already stopped: no selector left to race, close
            # the fd directly so it cannot leak
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        self.endpoint._forget(self)


class _LoopDial:
    """ONE staged outbound connect + preamble/PSK handshake attempt
    on the loop thread — the non-blocking mirror of
    ``_Connection._connect_with_preamble`` with the same record
    order, nonce-length checks, and single absolute deadline
    (``HANDSHAKE_TIMEOUT_S``, read at dial time so tests patching the
    module global keep binding).  Reports exactly once into
    ``conn._dial_succeeded`` / ``conn._dial_failed``."""

    _CONNECTING, _TLS, _SEND, _READ_A_NONCE, _SEND_MAC = range(5)

    def __init__(self, conn: _LoopConnection):
        self.conn = conn
        self.endpoint = conn.endpoint
        self.loop = conn.loop
        self.sock = None
        self._host = ""
        self._stage = self._CONNECTING
        self._out = bytearray()
        self._rbuf = bytearray()
        self._raw_preamble = b""
        self._c_nonce: Optional[bytes] = None
        self._keys = (None, None)
        self._stalled = False
        self._registered = False
        self._events = 0
        self._done = False
        self._deadline_timer = None

    def start(self) -> None:  # loop thread
        network = self.endpoint.network
        try:
            host, port_s = self.conn.remote_id.rsplit(":", 1)
            port = int(port_s)
        except ValueError:
            self._fail()
            return
        self._host = host
        plan = network.fault_plan
        if plan is not None:
            kind = plan.on_connect()
            if kind == "refuse":
                self._fail()  # injected connect refusal
                return
            self._stalled = kind == "stall"
        family = socket.AF_INET6 if ":" in host else socket.AF_INET
        try:
            sock = socket.socket(family, socket.SOCK_STREAM)
            sock.setblocking(False)
            # peer ids are listener addresses (numeric in practice);
            # a hostname resolves synchronously here, same as the
            # threaded create_connection did on its writer thread
            err = sock.connect_ex((host, port))
        except OSError:
            self._fail()
            return
        if err not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK,
                       errno.EALREADY):
            try:
                sock.close()
            except OSError:
                pass
            self._fail()
            return
        self.sock = sock
        self._deadline_timer = self.loop.call_later(
            HANDSHAKE_TIMEOUT_S * 1000.0, self._on_deadline)
        self._set_interest(selectors.EVENT_WRITE)

    # -- plumbing ------------------------------------------------------

    def _set_interest(self, events: int) -> None:  # loop thread
        if events == 0:
            if self._registered:
                self.loop.unregister(self.sock)
                self._registered = False
            self._events = 0
            return
        if not self._registered:
            self.loop.register(self.sock, events, self._on_io)
            self._registered = True
        elif events != self._events:
            self.loop.modify(self.sock, events, self._on_io)
        self._events = events

    def _pause(self, retry_ms: float) -> None:
        self._set_interest(0)
        self.loop.call_later(retry_ms, self._resume)

    def _resume(self) -> None:
        if self._done:
            return
        self._dispatch()

    def _on_io(self, mask: int) -> None:  # loop thread
        if self._done:
            return
        if self._stage == self._CONNECTING:
            err = self.sock.getsockopt(socket.SOL_SOCKET,
                                       socket.SO_ERROR)
            if err:
                self._fail()
                return
            self._connected()
            return
        self._dispatch()

    def _dispatch(self) -> None:
        if self._stage == self._TLS:
            self._tls_step()
        elif self._stage in (self._SEND, self._SEND_MAC):
            self._flush_out()
        elif self._stage == self._READ_A_NONCE:
            self._set_interest(selectors.EVENT_READ)
            self._read_step()

    # -- stages --------------------------------------------------------

    def _connected(self) -> None:
        ctx = self.endpoint.network.ssl_client_context
        if ctx is not None:
            raw = self.sock
            # unregister BEFORE wrap_socket: the wrap detaches raw's
            # fd into the SSLSocket, leaving a dead fileobj behind
            self._set_interest(0)
            try:
                self.sock = ctx.wrap_socket(
                    raw, server_hostname=self._host,
                    do_handshake_on_connect=False)
            except (OSError, ValueError):
                self._fail()
                return
            self._stage = self._TLS
            self._tls_step()
            return
        self._post_channel_setup()

    def _tls_step(self) -> None:
        try:
            self.sock.do_handshake()
        except ssl.SSLWantReadError:
            self._set_interest(selectors.EVENT_READ)
            return
        except ssl.SSLWantWriteError:
            self._set_interest(selectors.EVENT_WRITE)
            return
        except (OSError, ValueError):
            self._fail()
            return
        self._post_channel_setup()

    def _post_channel_setup(self) -> None:
        network = self.endpoint.network
        plan = network.fault_plan
        if plan is not None:
            # the fault shim rides ABOVE any TLS wrap and UNDER the
            # identity handshake, exactly like the threaded path
            if self._registered:
                self.loop.unregister(self.sock)
                self._registered = False
                self._events = 0
            shim = FaultSocket(self.sock, plan, stalled=self._stalled)
            shim.setblocking(False)
            self.sock = shim
        raw = self.endpoint.peer_id.encode()
        self._raw_preamble = raw
        self._out += _LEN.pack(len(raw)) + raw
        psk = network.psk
        if psk is not None:
            self._c_nonce = os.urandom(NONCE_LEN)
            self._out += _LEN.pack(len(self._c_nonce)) + self._c_nonce
        self._stage = self._SEND
        self._flush_out()

    def _flush_out(self) -> None:
        while self._out:
            try:
                n = self.sock.send(memoryview(self._out))  # loop-ok: non-blocking handshake send
            except _FaultHold as hold:
                self._pause(hold.retry_ms)
                return
            except ssl.SSLWantWriteError:
                self._set_interest(selectors.EVENT_WRITE)
                return
            except ssl.SSLWantReadError:
                self._set_interest(selectors.EVENT_READ)
                return
            except BlockingIOError:
                self._set_interest(selectors.EVENT_WRITE)
                return
            except OSError:
                self._fail()
                return
            del self._out[:n]
        if self._stage == self._SEND:
            if self.endpoint.network.psk is None:
                self._succeed()
                return
            self._stage = self._READ_A_NONCE
            self._set_interest(selectors.EVENT_READ)
            self._read_step()  # TLS may have buffered it already
            return
        self._succeed()  # _SEND_MAC flushed

    def _read_step(self) -> None:
        a_nonce = None
        while a_nonce is None:
            if len(self._rbuf) >= _LEN.size:
                (length,) = _LEN.unpack_from(self._rbuf)
                if length > MAX_AUTH_BYTES:
                    self._fail()
                    return
                if len(self._rbuf) >= _LEN.size + length:
                    a_nonce = bytes(
                        self._rbuf[_LEN.size:_LEN.size + length])
                    del self._rbuf[:_LEN.size + length]
                    break
            try:
                data = self.sock.recv(4096)  # loop-ok: non-blocking handshake recv
            except _FaultHold as hold:
                self._pause(hold.retry_ms)
                return
            except ssl.SSLWantReadError:
                self._set_interest(selectors.EVENT_READ)
                return
            except ssl.SSLWantWriteError:
                self._set_interest(selectors.EVENT_WRITE)
                return
            except BlockingIOError:
                self._set_interest(selectors.EVENT_READ)
                return
            except OSError:
                self._fail()
                return
            if not data:
                self._fail()
                return
            self._rbuf += data
        # exact-length check (see NONCE_LEN): a variable-length nonce
        # makes the NUL-joined MAC/KDF input ambiguous
        if len(a_nonce) != NONCE_LEN:
            self._fail()
            return
        psk = self.endpoint.network.psk
        mac = _psk_response(psk, a_nonce, self._c_nonce,
                            self._raw_preamble)
        self._out += _LEN.pack(len(mac)) + mac
        self._keys = _derive_frame_keys(psk, a_nonce, self._c_nonce,
                                        self._raw_preamble)
        self._stage = self._SEND_MAC
        self._flush_out()

    # -- outcomes ------------------------------------------------------

    def _succeed(self) -> None:
        if self._done:
            return
        self._done = True
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
        self._set_interest(0)  # the connection takes over the fd
        sock = self.sock
        if isinstance(sock, FaultSocket):
            sock.arm_frames()  # send-fault indices count frames only
        send_key, recv_key = self._keys
        self.conn._dial_succeeded(self, sock, send_key, recv_key)

    def _fail(self) -> None:
        if self._done:
            return
        self._done = True
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
        if self.sock is not None:
            self._set_interest(0)
            try:
                self.sock.close()
            except OSError:
                pass
        self.conn._dial_failed(self)

    def _on_deadline(self) -> None:
        self._fail()

    def abort(self) -> None:  # loop thread (close() teardown)
        if self._done:
            return
        self._done = True
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
        if self.sock is not None:
            self._set_interest(0)
            try:
                self.sock.close()
            except OSError:
                pass


class _LoopHandshake:
    """ONE staged inbound handshake on the loop thread — the
    non-blocking mirror of ``TcpEndpoint._handshake_inbound`` with
    the same stage order (TLS → preamble → identity → a_nonce →
    c_nonce → MAC), the same reject-reason taxonomy, and one absolute
    deadline for the whole exchange.  On success the socket hands off
    to ``endpoint._admit_inbound``; on any reject the selector key is
    dropped and the fd closed on this thread (the leak-freedom the
    handshake tests pin)."""

    _TLS, _PREAMBLE, _SEND_NONCE, _C_NONCE, _MAC = range(5)

    def __init__(self, endpoint: "TcpEndpoint", sock):
        self.endpoint = endpoint
        self.loop = endpoint.loop
        self.sock = sock
        self._stage = self._PREAMBLE
        self._rbuf = bytearray()
        self._out = bytearray()
        self._a_nonce: Optional[bytes] = None
        self._c_nonce: Optional[bytes] = None
        self._preamble: Optional[bytes] = None
        self._remote_id: Optional[str] = None
        self._observed_host = ""
        self._registered = False
        self._events = 0
        self._done = False
        self._deadline_timer = None

    def start(self) -> None:  # loop thread
        try:
            self.sock.setblocking(False)
        except OSError:
            self._reject("socket")
            return
        self._deadline_timer = self.loop.call_later(
            HANDSHAKE_TIMEOUT_S * 1000.0, self._on_deadline)
        ctx = self.endpoint.network.ssl_server_context
        if ctx is not None:
            raw = self.sock
            try:
                self.sock = ctx.wrap_socket(
                    raw, server_side=True, do_handshake_on_connect=False)
            except (OSError, ValueError):
                self.sock = raw
                self._reject("tls")
                return
            self._stage = self._TLS
            self._tls_step()
            return
        self._post_channel_setup()

    # -- plumbing (same shape as _LoopDial's) --------------------------

    def _set_interest(self, events: int) -> None:
        if events == 0:
            if self._registered:
                self.loop.unregister(self.sock)
                self._registered = False
            self._events = 0
            return
        if not self._registered:
            self.loop.register(self.sock, events, self._on_io)
            self._registered = True
        elif events != self._events:
            self.loop.modify(self.sock, events, self._on_io)
        self._events = events

    def _pause(self, retry_ms: float) -> None:
        self._set_interest(0)
        self.loop.call_later(retry_ms, self._resume)

    def _resume(self) -> None:
        if self._done:
            return
        self._dispatch()

    def _on_io(self, mask: int) -> None:  # loop thread
        if self._done:
            return
        self._dispatch()

    def _dispatch(self) -> None:
        if self._stage == self._TLS:
            self._tls_step()
        elif self._stage == self._SEND_NONCE:
            self._flush_out()
        else:
            self._read_step()

    def _stage_reason(self) -> str:
        if self._stage == self._TLS:
            return "tls"
        if self._stage == self._PREAMBLE:
            return "preamble"
        if self._stage == self._SEND_NONCE:
            return "socket"
        return "psk"

    # -- stages --------------------------------------------------------

    def _tls_step(self) -> None:
        try:
            self.sock.do_handshake()
        except ssl.SSLWantReadError:
            self._set_interest(selectors.EVENT_READ)
            return
        except ssl.SSLWantWriteError:
            self._set_interest(selectors.EVENT_WRITE)
            return
        except (OSError, ValueError):
            self._reject("tls")
            return
        self._post_channel_setup()

    def _post_channel_setup(self) -> None:
        network = self.endpoint.network
        if network.fault_plan is not None:
            # accepted links get the fault shim too (send-side faults
            # apply wherever the serve traffic actually rides)
            if self._registered:
                self.loop.unregister(self.sock)
                self._registered = False
                self._events = 0
            shim = FaultSocket(self.sock, network.fault_plan)
            shim.setblocking(False)
            self.sock = shim
        self._stage = self._PREAMBLE
        self._read_step()

    def _read_step(self) -> None:
        while not self._done:
            max_bytes = (self.endpoint.MAX_PREAMBLE_BYTES
                         if self._stage == self._PREAMBLE
                         else MAX_AUTH_BYTES)
            if len(self._rbuf) >= _LEN.size:
                (length,) = _LEN.unpack_from(self._rbuf)
                if length > max_bytes:
                    # reject at HEADER-parse time: an unauthenticated
                    # connection must not get to stream a claimed-
                    # gigabyte body before the bound applies
                    self._reject(self._stage_reason())
                    return
                if len(self._rbuf) >= _LEN.size + length:
                    record = bytes(
                        self._rbuf[_LEN.size:_LEN.size + length])
                    del self._rbuf[:_LEN.size + length]
                    if not self._on_record(record):
                        return
                    continue
            try:
                data = self.sock.recv(4096)  # loop-ok: non-blocking handshake recv
            except _FaultHold as hold:
                self._pause(hold.retry_ms)
                return
            except ssl.SSLWantReadError:
                self._set_interest(selectors.EVENT_READ)
                return
            except ssl.SSLWantWriteError:
                self._set_interest(selectors.EVENT_WRITE)
                return
            except BlockingIOError:
                self._set_interest(selectors.EVENT_READ)
                return
            except OSError:
                self._reject(self._stage_reason())
                return
            if not data:
                self._reject(self._stage_reason())
                return
            self._rbuf += data

    def _on_record(self, record: bytes) -> bool:
        """Advance the state machine by one parsed record.  Returns
        True to keep reading (another record expected), False when
        the handshake finished, failed, or switched to a send
        stage."""
        if self._stage == self._PREAMBLE:
            return self._on_preamble(record)
        if self._stage == self._C_NONCE:
            # exact-length check (see NONCE_LEN): boundary-ambiguity
            # splice defense, same as the blocking path
            if len(record) != NONCE_LEN:
                log.warning("rejecting unauthenticated inbound "
                            "claiming %r from %s", self._remote_id,
                            self._observed_host)
                self._reject("psk")
                return False
            self._c_nonce = record
            self._stage = self._MAC
            return True
        # _MAC
        psk = self.endpoint.network.psk
        if not hmac.compare_digest(
                record, _psk_response(psk, self._a_nonce,
                                      self._c_nonce, self._preamble)):
            log.warning("rejecting unauthenticated inbound claiming "
                        "%r from %s", self._remote_id,
                        self._observed_host)
            self._reject("psk")
            return False
        keys = _derive_frame_keys(psk, self._a_nonce, self._c_nonce,
                                  self._preamble)
        self._admit(keys)
        return False

    def _on_preamble(self, record: bytes) -> bool:
        endpoint = self.endpoint
        network = endpoint.network
        try:
            remote_id = record.decode("utf-8")
        except UnicodeDecodeError:
            self._reject("preamble")
            return False
        self._preamble = record
        self._remote_id = remote_id
        claimed_host = remote_id.rsplit(":", 1)[0]
        try:
            observed_host = self.sock.getpeername()[0]
        except OSError:
            self._reject("socket")
            return False
        self._observed_host = observed_host
        # identity binding (module docstring: trust model).  The
        # resolver runs ON the loop thread: the claimed-host fast
        # path is equality, misses hit a bounded refresh-throttled
        # cache (TcpNetwork._host_matches), so the blocking lookup
        # is rare and localhost-fast in every deployment this
        # transport serves; a DNS-heavy fabric should front-load the
        # cache or disable verify_inbound_host
        if remote_id in endpoint.reject_inbound_ids or (
                network.verify_inbound_host
                and not network._host_matches(claimed_host,
                                              observed_host)):
            log.warning("rejecting inbound connection claiming %r "
                        "from %s", remote_id, observed_host)
            self._reject("identity")
            return False
        if network.psk is None:
            self._admit(None)
            return False
        self._a_nonce = os.urandom(NONCE_LEN)
        self._out += _LEN.pack(len(self._a_nonce)) + self._a_nonce
        self._stage = self._SEND_NONCE
        self._flush_out()
        return False

    def _flush_out(self) -> None:
        while self._out:
            try:
                n = self.sock.send(memoryview(self._out))  # loop-ok: non-blocking handshake send
            except _FaultHold as hold:
                self._pause(hold.retry_ms)
                return
            except ssl.SSLWantWriteError:
                self._set_interest(selectors.EVENT_WRITE)
                return
            except ssl.SSLWantReadError:
                self._set_interest(selectors.EVENT_READ)
                return
            except BlockingIOError:
                self._set_interest(selectors.EVENT_WRITE)
                return
            except OSError:
                self._reject("socket")
                return
            del self._out[:n]
        self._stage = self._C_NONCE
        self._set_interest(selectors.EVENT_READ)
        self._read_step()

    # -- outcomes ------------------------------------------------------

    def _on_deadline(self) -> None:
        if self._done:
            return
        self._reject(self._stage_reason())

    def _reject(self, reason: str) -> None:
        if self._done:
            return
        self._done = True
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
        self._set_interest(0)
        try:
            self.sock.close()
        except OSError:
            pass
        self.endpoint._count("handshake_rejects", reason=reason)
        self.endpoint._handshake_done(self)

    def _admit(self, keys) -> None:
        if self._done:
            return
        self._done = True
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
        self._set_interest(0)  # the connection takes over the fd
        sock = self.sock
        if isinstance(sock, FaultSocket):
            sock.arm_frames()  # send-fault indices count frames only
        conn = self.endpoint._make_connection(self._remote_id, sock)
        if keys is not None:
            # acceptor sends on the a2c key, verifies on c2a
            conn.recv_key, conn.send_key = keys
        # bytes read past the final handshake record belong to the
        # frame stream — hand them over (select won't re-report them)
        conn._rbuf = bytearray(self._rbuf)
        self.endpoint._handshake_done(self)
        self.endpoint._admit_inbound(conn)

    def abort(self) -> None:  # loop thread (endpoint close)
        if self._done:
            return
        self._done = True
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
        self._set_interest(0)
        try:
            self.sock.close()
        except OSError:
            pass
        self.endpoint._handshake_done(self)


class _LoopEndpoint(TcpEndpoint):
    """TcpEndpoint on the selector core: the listener, every inbound
    handshake, and every connection's I/O multiplex on the network's
    ONE NetLoop thread — no accept thread, no per-connection
    writer/reader pair, no per-handshake thread.  Counter semantics,
    admission/eviction policy, healing, and the wire protocol are the
    base class's; only the I/O discipline differs.  The blocking
    inherited paths (``_handshake_inbound``/``_reader_loop``) remain
    functional for direct callers (tests drive them synchronously)."""

    def __init__(self, network: "TcpNetwork", host: str):
        #: in-flight staged handshakes (guarded by _conn_lock) so
        #: close() can abort them — a handshake is not yet a
        #: connection, and close()'s conn sweep would miss it
        self._handshakes: set = set()
        super().__init__(network, host)

    def _make_connection(self, remote_id: str,
                         sock=None) -> _LoopConnection:
        return _LoopConnection(self, remote_id, sock)

    def _begin_accept(self) -> None:
        self._listener.setblocking(False)

        def attach() -> None:
            if not self.closed:
                self.loop.register(self._listener,
                                   selectors.EVENT_READ,
                                   self._on_acceptable)

        self.loop.run_soon(attach)

    def _on_acceptable(self, mask: int) -> None:  # loop thread
        while True:
            try:
                sock, _addr = self._listener.accept()  # loop-ok: non-blocking accept on the loop
            except OSError:  # includes BlockingIOError: drained
                return
            with self._conn_lock:
                # same flood gate as the threaded accept loop: past
                # the cap, accepted sockets close immediately
                admit = (not self.closed and self._pending_handshakes
                         < self.MAX_PENDING_HANDSHAKES)
                if admit:
                    self._pending_handshakes += 1
            if not admit:
                if not self.closed:
                    self._count("handshake_rejects", reason="flood")
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            handshake = _LoopHandshake(self, sock)
            with self._conn_lock:
                self._handshakes.add(handshake)
            handshake.start()

    def _handshake_done(self, handshake: _LoopHandshake) -> None:
        with self._conn_lock:
            self._pending_handshakes -= 1
            self._handshakes.discard(handshake)

    def _close_listener(self) -> None:
        listener = self._listener

        def tear() -> None:
            self.loop.unregister(listener)
            try:
                listener.close()
            except OSError:
                pass

        if not self.loop.run_soon(tear):
            try:
                listener.close()  # loop stopped: close directly
            except OSError:
                pass

    #: graceful-close drain bound: close() gives the shared loop this
    #: long to flush frames already committed to live/healing links
    #: before dropping them — the threaded transport's parallel
    #: writers usually won this race for free; one serialized loop
    #: needs the explicit grace or a prompt close() drops frames the
    #: caller reasonably considers sent
    CLOSE_DRAIN_S = 0.25

    def close(self) -> None:
        was_closed = self.closed
        if not was_closed and not self.loop.on_loop_thread():
            deadline = time.monotonic() + self.CLOSE_DRAIN_S  # clock-ok: drain bound
            while time.monotonic() < deadline:  # clock-ok: drain bound
                with self._conn_lock:
                    if self.closed:
                        break
                    conns = (list(self._conns.values())
                             + list(self._extra_conns))
                if not any(conn._flush_pending() for conn in conns
                           if isinstance(conn, _LoopConnection)):
                    break
                time.sleep(0.005)  # clock-ok: close-drain poll
        super().close()
        if was_closed:
            return
        with self._conn_lock:
            handshakes = list(self._handshakes)
        if handshakes:
            def abort_all() -> None:
                for handshake in handshakes:
                    handshake.abort()

            self.loop.run_soon(abort_all)
        # fence: the conn/handshake teardowns above are POSTED to the
        # loop; close() returning with their fds still open would
        # fail every zero-leak gate.  On the loop thread run_soon was
        # synchronous and there is nothing to wait for (and waiting
        # would deadlock the loop against itself).
        if not self.loop.on_loop_thread():
            fence = threading.Event()
            if self.loop.post(fence.set):
                fence.wait(2.0)


class TcpNetwork:
    """Factory matching the engine's network contract
    (``register(peer_id, uplink_bps) -> endpoint``).  The requested
    peer id is ignored — on a real fabric the listener address IS the
    identity; callers must adopt ``endpoint.peer_id``."""

    #: minimum seconds between resolver refreshes per claimed host
    #: (bounds attacker-driven DNS traffic; see _host_matches)
    RESOLVE_REFRESH_S = 30.0
    #: global resolver budget per RESOLVE_REFRESH_S window — the
    #: per-host limit alone is bypassable by varying the claimed
    #: host, so total lookups are token-bucketed too
    MAX_RESOLVES_PER_WINDOW = 32
    #: bound on distinct cached hostnames (attacker-claimable state)
    MAX_RESOLVE_CACHE = 1024

    def __init__(self, host: str = "127.0.0.1",
                 loop: Optional[NetLoop] = None,
                 verify_inbound_host: bool = True,
                 psk: Optional[bytes] = None,
                 ssl_server_context=None,
                 ssl_client_context=None,
                 registry: Optional[MetricsRegistry] = None,
                 heal=None, fault_plan=None, trace=None,
                 transport: str = "loop",
                 max_connections: Optional[int] = None,
                 max_pending_handshakes: Optional[int] = None,
                 listen_backlog: Optional[int] = None):
        if transport not in ("loop", "threads"):
            raise ValueError(
                f"transport must be 'loop' or 'threads', got {transport!r}")
        #: I/O discipline for endpoints this network mints:
        #: ``"loop"`` (default since 0.19) multiplexes every socket
        #: on the network's one NetLoop thread via per-connection
        #: state machines; ``"threads"`` keeps the pre-0.19
        #: thread-per-connection transport (same wire protocol — the
        #: two interoperate freely across hosts/processes).
        self.transport = transport
        #: per-endpoint sizing knobs for C10K deployments (a tracker
        #: endpoint fronting 4 packs needs >256 admitted conns).
        #: ``None`` keeps the TcpEndpoint class defaults.
        self.max_connections = max_connections
        self.max_pending_handshakes = max_pending_handshakes
        self.listen_backlog = listen_backlog
        self.host = host
        self._owns_loop = loop is None
        self.loop = loop or NetLoop()
        #: unified telemetry (engine/telemetry.py): endpoints mirror
        #: their attack counters here as labeled series; a private
        #: registry keeps call sites unconditional when none is given
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        #: self-healing policy: ``None`` = the default
        #: :class:`ReconnectPolicy` (bounded jittered redial +
        #: circuit breaker + half-open probe); ``False`` disables
        #: healing entirely (pre-0.12 failure behavior); or inject a
        #: tuned/seeded policy.  Fault-free traffic is byte-identical
        #: under any of the three.
        self.heal: Optional[ReconnectPolicy] = \
            ReconnectPolicy() if heal is None else (heal or None)
        #: deterministic socket-fault injection
        #: (engine/netfaults.py NetFaultPlan): when set, outbound
        #: dials consult the plan and every connection is wrapped in
        #: the FaultSocket shim — the REAL handshake/framing/reader/
        #: writer paths run under the schedule.  Production fabrics
        #: leave this None; the net chaos gate does not.
        self.fault_plan = fault_plan
        #: optional FlightRecorder (engine/tracer.py): self-heal
        #: actions (reconnect / circuit transitions) emit one ``net``
        #: event each, alongside the counter-bump correlation the
        #: recorder already gets from an attached registry
        self.trace = trace
        #: per-swarm pre-shared key: when set, every connection must
        #: pass the HMAC challenge-response before its claimed id is
        #: believed, and every subsequent frame carries a sequence-
        #: bound MAC under per-connection directional keys (module
        #: docstring: trust model).  All peers of one fabric must
        #: agree (mismatched sides fail the handshake and the
        #: connection is dropped — fail closed).
        self.psk = psk
        #: optional ``ssl.SSLContext`` pair for confidentiality: the
        #: server context wraps accepted sockets, the client context
        #: wraps outbound connects, both BEFORE any identity bytes.
        #: Orthogonal to the PSK (which keeps authenticating swarm
        #: membership inside the channel); both sides of a fabric
        #: must agree, as with the PSK.
        self.ssl_server_context = ssl_server_context
        self.ssl_client_context = ssl_client_context
        #: reject inbound preambles whose claimed host doesn't resolve
        #: to the socket's observed remote address (module docstring:
        #: trust model).  Disable for NAT/multi-homed deployments where
        #: a peer's outbound source address legitimately differs from
        #: its listener address.
        self.verify_inbound_host = verify_inbound_host
        #: claimed-host → (resolved addresses, refresh timestamp)
        self._resolve_cache: Dict[str, tuple] = {}
        self._resolve_lock = threading.Lock()
        self._resolve_window_start = 0.0
        self._resolve_window_count = 0
        self._endpoints: list = []
        self._endpoints_lock = threading.Lock()
        # net.loop.* observability rides the network's registry
        # (first attach wins when several networks share one loop)
        self.loop.attach_registry(self.registry)

    def _host_matches(self, claimed_host: str, observed_host: str) -> bool:
        """Does the claimed listener host resolve to the observed
        remote address?  Runs on a per-handshake thread, so the
        (cached) blocking DNS lookup never stalls the dispatch loop.
        Unresolvable claims are rejected.

        A cached MISS re-resolves before rejecting — a host that
        legitimately re-resolves to a new address (DNS change, lease
        renewal) must not be rejected for the process lifetime on
        stale cache, the mirror image of the failure-caching hazard
        below.  Resolver traffic is bounded on TWO axes: at most one
        refresh per RESOLVE_REFRESH_S per hostname, AND at most
        MAX_RESOLVES_PER_WINDOW lookups per window in total (the
        per-host limit alone is bypassable by flooding handshakes
        with ever-changing claimed hosts); the cache itself is
        size-capped for the same reason.  Over budget → reject
        without resolving: under attack, unverifiable claims fail
        closed."""
        if claimed_host == observed_host:
            return True
        now = time.monotonic()  # clock-ok: resolver throttle window is wall time
        with self._resolve_lock:
            cached = self._resolve_cache.get(claimed_host)
            if cached is not None:
                addrs, refreshed_at = cached
                if observed_host in addrs:
                    return True
                if now - refreshed_at < self.RESOLVE_REFRESH_S:
                    return False  # recently refreshed: a real mismatch
            # global token bucket, charged BEFORE the blocking lookup
            if now - self._resolve_window_start >= self.RESOLVE_REFRESH_S:
                self._resolve_window_start = now
                self._resolve_window_count = 0
            if self._resolve_window_count >= self.MAX_RESOLVES_PER_WINDOW:
                return False  # resolver budget exhausted: fail closed
            self._resolve_window_count += 1
        try:
            infos = socket.getaddrinfo(claimed_host, None)
            fresh = frozenset(info[4][0] for info in infos)
        except OSError:
            # do NOT cache failures: one transient resolver hiccup
            # must not permanently reject every inbound connection
            # claiming this host for the process lifetime
            return False
        with self._resolve_lock:
            if (claimed_host not in self._resolve_cache
                    and len(self._resolve_cache) >= self.MAX_RESOLVE_CACHE):
                # evict the stalest entry: bounded attacker-claimable
                # state, and the evictee is the least likely to recur
                oldest = min(self._resolve_cache,
                             key=lambda h: self._resolve_cache[h][1])
                del self._resolve_cache[oldest]
            self._resolve_cache[claimed_host] = (fresh, now)
        return observed_host in fresh

    def register(self, peer_id: Optional[str] = None,
                 uplink_bps: Optional[float] = None) -> TcpEndpoint:
        # uplink shaping is the OS/network's job on a real fabric
        cls = _LoopEndpoint if self.transport == "loop" else TcpEndpoint
        endpoint = cls(self, self.host)
        with self._endpoints_lock:
            self._endpoints.append(endpoint)
        return endpoint

    def _forget_endpoint(self, endpoint: TcpEndpoint) -> None:
        """Closed endpoints must not accumulate for the network's
        lifetime (agents come and go on one shared fabric)."""
        with self._endpoints_lock:
            try:
                self._endpoints.remove(endpoint)
            except ValueError:
                pass  # concurrent close already removed it

    def close(self) -> None:
        with self._endpoints_lock:
            endpoints = list(self._endpoints)
        for endpoint in endpoints:
            endpoint.close()
        # a caller-injected loop may serve other networks — only stop
        # what we created
        if self._owns_loop:
            self.loop.stop()
