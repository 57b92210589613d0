# A copy of the reference's engine/fabric.py (hlsjs_p2p_wrapper_tpu/engine/fabric.py): the
# same names, formats and bytes; only the imports point at the port's own
# modules.
"""Multi-host sweep fabric: a journal-backed work ledger with
lease-based work stealing, over nothing but a shared filesystem.

The reference wrapper's defining reflex is that ONE failing peer
never stalls playback — the segment request falls back to another
source and the swarm routes around the loss (PAPER.md §0).  The
fault plane gave a single sweep process that reflex (retry/backoff, OOM
bisection, crash-safe resume); this module lifts it to the FLEET:
the million-point grids serialize through one process on one host
today, so a single host loss costs the whole run.  Here the grid's
scenario axis is sharded into chunk-sized WORK UNITS that
cooperating host processes claim, compute, and finalize through
shared files — and host death, stragglers, and double completion
are first-class, counted, recoverable events.

**The ledger** (:class:`WorkLedger`).  A fabric directory holds

- ``meta.json`` — the sweep-identity digest (the same
  content-addressing the :class:`~.artifact_cache.SweepJournal`
  uses); a host joining with a different sweep configuration is
  refused, so two grids can never interleave one ledger;
- ``units.json`` — the work-unit manifest (one unit = one
  chunk-sized slice of one compile group, plus the fleet-wide chunk
  shape), published EXCLUSIVELY by whichever host arrives first
  (``os.link`` of a fsync'd temp file — atomic on POSIX) and
  adopted verbatim by everyone else, so all hosts agree on unit
  boundaries and the one ``[B, P, …]`` program shape;
- ``claims/unit-NNNNN.jsonl`` — one append-only claim journal per
  unit: ``claim`` / ``beat`` / ``done`` records, each a full JSON
  line, fsync'd per append, torn-tail tolerant exactly like the
  sweep journal (a reader skips an unparsable fragment).

**The lease protocol.**  A host CLAIMS a unit by appending a
``claim`` record carrying a TTL lease (``expires_s``); it
HEARTBEATS (``beat`` records, same lease extension) while holding
units between dispatches.  The LAST claim record in file order
holds the lease: a later claim is only ever appended after the
previous lease expired, so "last claim wins" is exactly
"supersede the dead".  A host that dies (SIGKILL, preemption) or
stalls past its lease simply stops renewing — a surviving host
observes the expiry and STEALS the unit by appending a fresh claim
with the next generation number.  Completion appends a ``done``
record; the FIRST ``done`` in file order wins deterministically,
and a slow-but-alive host finishing a stolen unit later counts a
``duplicate`` — which is SAFE BY CONSTRUCTION: every row lands in
the content-addressed layer-2 row cache keyed by scenario bytes,
so the loser's rows are bit-identical to the winner's (vmap lanes
are independent; pad content never bleeds), and the merged
artifact cannot depend on who won.

Two hosts can, in a narrow append race, both believe they hold a
fresh claim.  The protocol does not fight that race — it makes it
harmless (double compute, deterministic single winner, counted) —
because a protocol that instead required fleet-wide locks would
reintroduce the single point of failure this module exists to
remove.

Observability rides the metrics registry: every ledger decision
counts into ``fabric_claims{action=claim|steal|expire|duplicate}``
and each host maintains a ``fabric_heartbeat_s{host=…}`` gauge
(last-renewal clock) plus a ``fabric_units_done{host=…}`` counter.
``tools/fleet_gate.py`` (``make fleet-gate``) proves the whole
ladder at process granularity: SIGKILL one worker mid-grid, stall
another into lease expiry, and the merged artifact is bit-identical
to the single-host fault-free reference with every steal / expiry /
duplicate counted.

Wall-clock and sleeping route through the INJECTABLE ``clock`` /
``sleep`` callables (the :class:`~.faults.FaultPolicy` convention;
``tools/lint.py`` rejects naked ``time.time()`` / ``time.sleep()``
in this module), so lease-expiry edge cases are tested with a fake
clock instead of real waits.

**Deployment caveats (shared-FS fleets).**  Claim appends rely on
POSIX ``O_APPEND`` atomicity for whole-line writes — true on local
and cluster filesystems (ext4/xfs/Lustre/GPFS), NOT on plain NFS,
where the client emulates append with seek-to-EOF + write and two
hosts can overwrite each other's records mid-file (a corruption the
torn-TAIL tolerance cannot see).  And leases compare one host's
``expires_s`` against another host's clock: hosts must be loosely
NTP-synchronized, with skew well under ``lease_s`` — skew degrades
to spurious steals (wasted duplicate compute, never wrong results)
or delayed stealing, proportionally.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import time
from typing import List, NamedTuple, Optional

from .artifact_cache import _digest, read_jsonl_tolerant
from .telemetry import MetricsRegistry

#: ``next_unit`` sentinel: units remain but none is claimable right
#: now (live leases elsewhere) — poll again after a short sleep
WAIT = "wait"

#: chaos kinds the fleet gate injects at claim time
KILL = "kill"
STALL = "stall"


class WorkUnit(NamedTuple):
    """One chunk-sized slice of one compile group's item list."""

    unit: int    # ordinal in the manifest (names the claim file)
    group: int   # index into the groups sequence
    start: int   # first item index within the group
    count: int   # real items in this unit (≤ the fleet chunk)


def plan_units(group_sizes, chunks) -> List[WorkUnit]:
    """Slice each group's item count into chunk-sized units, in
    group-major order — the manifest every host must agree on."""
    units = []
    for gi, (size, chunk) in enumerate(zip(group_sizes, chunks)):
        for start in range(0, size, max(int(chunk), 1)):
            units.append(WorkUnit(len(units), gi, start,
                                  min(chunk, size - start)))
    return units


class FleetChaos:
    """Deterministic fleet-level fault injection, consulted right
    after every successful claim (the moment a host holds a fresh
    lease — the worst time to die or stall):

    - ``kill@N`` — SIGKILL this host upon its (N+1)-th successful
      claim: the preemption model, mid-grid, lease held, no flush;
    - ``stall@N:S`` — sleep ``S`` wall seconds after the (N+1)-th
      claim, then CONTINUE computing: the slow-but-alive host whose
      lease expires under it (``S`` > the lease makes the claim
      stealable while its holder still finishes — the
      double-completion path).

    Parsed from ``"kill@1"`` / ``"stall@1:6.0"`` (comma-separated);
    the stall rides the ledger's injectable ``sleep``."""

    def __init__(self, specs):
        self.specs = [dict(spec) for spec in specs]
        for spec in self.specs:
            if spec["kind"] not in (KILL, STALL):
                raise ValueError(
                    f"unknown fleet chaos kind {spec['kind']!r} "
                    f"(one of {(KILL, STALL)})")
            spec.setdefault("stall_s", 0.0)

    @classmethod
    def parse(cls, text: str) -> "FleetChaos":
        specs = []
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                kind, coord = part.split("@")
                stall_s = 0.0
                if ":" in coord:
                    coord, stall = coord.split(":")
                    stall_s = float(stall)
                specs.append({"kind": kind.strip(),
                              "claim": int(coord),
                              "stall_s": stall_s})
            except (ValueError, IndexError):
                raise ValueError(
                    f"bad fleet chaos spec {part!r} (want kill@N or "
                    f"stall@N:SECONDS)") from None
        return cls(specs)

    def fire(self, claim_ordinal: int, sleep) -> None:
        for spec in self.specs:
            if spec["claim"] != claim_ordinal:
                continue
            if spec["kind"] == KILL:
                # the preemption model: die NOW, holding a fresh
                # lease, with no chance to flush or finalize —
                # exactly what lease expiry + stealing must absorb
                os.kill(os.getpid(), signal.SIGKILL)
            sleep(spec["stall_s"])


def _publish_exclusive(path: str, data: bytes) -> bool:
    """Atomically publish ``data`` at ``path`` IF nobody else has:
    fsync'd temp file + ``os.link`` (which fails with EEXIST instead
    of overwriting).  Returns True when this call published; False
    when another host won — the caller then adopts the winner's
    file.  Either way, a reader never sees a partial file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + f".tmp-{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    try:
        os.link(tmp, path)
        return True
    except FileExistsError:
        return False
    finally:
        os.unlink(tmp)


def _read_records(path: str) -> list:
    """All parseable records of one claim file — the journal's
    torn-tail-tolerance protocol (one shared implementation,
    :func:`~.artifact_cache.read_jsonl_tolerant`); a missing file is
    an unclaimed unit, not an error."""
    try:
        return list(read_jsonl_tolerant(path))
    except OSError:
        return []


class WorkLedger:
    """One host's handle on the fabric directory: claim, heartbeat,
    steal, finalize (module docstring has the protocol).  ``meta``
    is the sweep-identity material (the same dict the journal is
    addressed by); a ledger opened with a different meta against the
    same directory raises.  ``clock``/``sleep`` are injectable for
    deterministic lease tests; ``registry`` receives the
    ``fabric_claims`` family and the per-host heartbeat gauge."""

    def __init__(self, fabric_dir: str, meta: dict, host_id: str, *,
                 lease_s: float = 30.0, clock=time.time,
                 sleep=time.sleep,
                 registry: Optional[MetricsRegistry] = None,
                 chaos: Optional[FleetChaos] = None, trace=None):
        if lease_s <= 0:
            raise ValueError("lease_s must be > 0")
        # flight recorder (engine/tracer.py, duck-typed): every
        # claim/steal/beat/done/duplicate also emits a ``lease``
        # event, so the one event plane carries the fabric protocol
        # alongside the dispatch spans and fault counters
        self.trace = trace
        self.fabric_dir = fabric_dir
        self.host_id = host_id
        self.lease_s = lease_s
        self.digest = _digest({"kind": "sweep-fabric", **meta})
        self._clock = clock
        self._sleep = sleep
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.chaos = chaos
        self.units: List[WorkUnit] = []
        self._chunks: List[int] = []
        self._done_units: set = set()
        self._held_gen: dict = {}   # unit ordinal -> my claim gen
        self._busy_until: dict = {}  # unit -> observed lease expiry
        self._claims_made = 0       # chaos ordinal
        # stable scan rotation (builtin str hash is salted per
        # process — useless for spreading a fleet deterministically)
        self._rotation = int(_digest({"kind": "fabric-rotation",
                                      "host": host_id})[:8], 16)
        os.makedirs(os.path.join(fabric_dir, "claims"), exist_ok=True)
        meta_path = os.path.join(fabric_dir, "meta.json")
        payload = json.dumps({"digest": self.digest}).encode() + b"\n"
        if not _publish_exclusive(meta_path, payload):
            with open(meta_path, encoding="utf-8") as fh:
                found = json.load(fh).get("digest")
            if found != self.digest:
                raise ValueError(
                    f"fabric dir {fabric_dir} belongs to a different "
                    f"sweep configuration — refusing to join it")

    # -- manifest -------------------------------------------------------

    def ensure_manifest(self, group_sizes, chunks):
        """Publish this host's unit plan — or adopt the one already
        published (first writer wins; late hosts MUST run the
        winner's boundaries and chunk shapes or their dispatches
        would compile different programs and their claims would name
        different slices).  Returns ``(units, chunks)`` as adopted."""
        path = os.path.join(self.fabric_dir, "units.json")
        mine = {"digest": self.digest,
                "chunks": [int(c) for c in chunks],
                "units": [list(u) for u in
                          plan_units(group_sizes, chunks)]}
        payload = json.dumps(mine, indent=0).encode() + b"\n"
        _publish_exclusive(path, payload)
        with open(path, encoding="utf-8") as fh:
            adopted = json.load(fh)
        if adopted.get("digest") != self.digest:
            raise ValueError(
                f"fabric manifest {path} belongs to a different sweep "
                f"configuration — refusing to run it")
        self.units = [WorkUnit(*u) for u in adopted["units"]]
        self._chunks = [int(c) for c in adopted["chunks"]]
        return self.units, self._chunks

    def chunk(self, group: int) -> int:
        """The fleet-wide canonical batch shape for one group."""
        return self._chunks[group]

    # -- claim-file plumbing --------------------------------------------

    def _claim_path(self, unit: int) -> str:
        return os.path.join(self.fabric_dir, "claims",
                            f"unit-{unit:05d}.jsonl")

    def _append(self, unit: int, record: dict) -> None:
        """One fsync'd O_APPEND record: the kernel serializes
        same-file appends, so concurrent hosts interleave whole
        lines, never bytes — and a crash mid-write tears at most the
        tail line, which readers skip."""
        line = (json.dumps(record) + "\n").encode()
        fd = os.open(self._claim_path(unit),
                     os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
        try:
            os.write(fd, line)
            os.fsync(fd)
        finally:
            os.close(fd)

    @staticmethod
    def _view(records):
        """(first done record or None, last claim record or None,
        latest lease expiry for that claim's generation)."""
        done = next((r for r in records if r.get("kind") == "done"),
                    None)
        lease = None
        expires = 0.0
        for r in records:
            if r.get("kind") == "claim":
                lease = r
                expires = float(r.get("expires_s", 0.0))
            elif (r.get("kind") == "beat" and lease is not None
                  and r.get("host") == lease.get("host")
                  and r.get("gen") == lease.get("gen")):
                expires = max(expires, float(r.get("expires_s", 0.0)))
        return done, lease, expires

    def _count(self, action: str) -> None:
        self.registry.counter("fabric_claims", action=action).inc()

    def claim_counts(self) -> dict:
        """``{action: count}`` — the summary surface the workers
        export into their partial artifacts and the fleet gate
        asserts on."""
        return {labels["action"]: value
                for labels, value in
                self.registry.series("fabric_claims")}

    # -- the lease protocol ---------------------------------------------

    def try_claim(self, unit: WorkUnit) -> str:
        """One claim attempt: ``"claimed"`` (lease held — compute
        it), ``"done"`` (someone finished it), ``"busy"`` (live
        lease elsewhere), or ``"lost"`` (append race — another claim
        landed after ours; back off, its holder computes)."""
        records = _read_records(self._claim_path(unit.unit))
        done, lease, expires = self._view(records)
        now = self._clock()
        if done is not None:
            self._done_units.add(unit.unit)
            self._busy_until.pop(unit.unit, None)
            return "done"
        if lease is not None and expires > now:
            # remember when this lease could expire so the scan loop
            # can skip re-reading the file until then (next_unit)
            self._busy_until[unit.unit] = expires
            return "busy"
        self._busy_until.pop(unit.unit, None)
        gen = (int(lease["gen"]) + 1) if lease is not None else 0
        self._append(unit.unit, {"kind": "claim", "host": self.host_id,
                                 "gen": gen,
                                 "expires_s": now + self.lease_s})
        # re-read: the LAST claim record holds the lease, so if a
        # concurrent claim landed after ours we lost the race (the
        # rare both-read-before-both-append interleave leaves two
        # hosts computing one unit — safe: first finalized done wins
        # and the rows are bit-identical via the row cache)
        _done2, lease2, _exp2 = self._view(
            _read_records(self._claim_path(unit.unit)))
        if (lease2 is None or lease2.get("host") != self.host_id
                or lease2.get("gen") != gen):
            return "lost"
        self._held_gen[unit.unit] = gen
        if lease is not None:
            # superseding an expired lease: the expiry is observed
            # here (a dead host never reports its own), and a
            # takeover from ANOTHER host is a steal
            self._count("expire")
            stolen = lease.get("host") != self.host_id
            self._count("steal" if stolen else "claim")
            if self.trace is not None:
                self.trace.lease("steal" if stolen else "reclaim",
                                 unit=unit.unit, gen=gen,
                                 prev_host=lease.get("host"))
        else:
            self._count("claim")
            if self.trace is not None:
                self.trace.lease("claim", unit=unit.unit, gen=gen)
        self.registry.gauge("fabric_heartbeat_s",
                            host=self.host_id).set(now)
        ordinal = self._claims_made
        self._claims_made += 1
        if self.chaos is not None:
            self.chaos.fire(ordinal, self._sleep)
        return "claimed"

    def next_unit(self):
        """Scan for work (starting at a host-dependent rotation so a
        fleet does not pile onto unit 0) and claim the first
        claimable unit.  Returns the claimed :class:`WorkUnit`,
        ``WAIT`` (live leases elsewhere — poll again), or ``None``
        (every unit is done: the grid is complete)."""
        if not self.units:
            raise RuntimeError("ensure_manifest() before next_unit()")
        n = len(self.units)
        rot = self._rotation % n
        now = self._clock()
        outstanding = False
        for i in range(n):
            unit = self.units[(i + rot) % n]
            if unit.unit in self._done_units:
                continue
            if self._busy_until.get(unit.unit, 0.0) > now:
                # another host's lease cannot have expired yet — no
                # point re-reading the claim file (at million-point
                # scale a scan re-parsing every leased unit's file
                # per poll would be O(units) I/O for nothing); the
                # file is re-read once the remembered expiry passes,
                # which also picks up any heartbeat renewals
                outstanding = True
                continue
            status = self.try_claim(unit)
            if status == "claimed":
                return unit
            if status != "done":
                outstanding = True
        return WAIT if outstanding else None

    def heartbeat(self, unit: WorkUnit) -> None:
        """Renew the lease on a held unit (between dispatches; the
        lease must out-live one unit's compute — size ``lease_s``
        accordingly)."""
        gen = self._held_gen.get(unit.unit)
        if gen is None:
            return
        now = self._clock()
        self._append(unit.unit, {"kind": "beat", "host": self.host_id,
                                 "gen": gen,
                                 "expires_s": now + self.lease_s})
        self.registry.gauge("fabric_heartbeat_s",
                            host=self.host_id).set(now)
        if self.trace is not None:
            self.trace.lease("beat", unit=unit.unit, gen=gen,
                             expires_s=now + self.lease_s)

    def finalize(self, unit: WorkUnit, rows: int) -> bool:
        """Append this unit's completion.  The FIRST ``done`` record
        in file order wins; finishing second (the stolen-but-alive
        path) counts a ``duplicate`` and returns False — the rows
        are already bit-identical in the row cache either way, so a
        loser's work is redundant, never wrong."""
        gen = self._held_gen.get(unit.unit)
        # ALWAYS append (even when a done record is already visible):
        # the claim file is the post-mortem ground truth
        # (fleet_report), so a double completion must be on disk, not
        # just in the loser's in-process counter
        self._append(unit.unit, {"kind": "done", "host": self.host_id,
                                 "gen": gen, "rows": int(rows)})
        records = _read_records(self._claim_path(unit.unit))
        done, _lease, _exp = self._view(records)
        self._done_units.add(unit.unit)
        if (done is None or done.get("host") != self.host_id
                or done.get("gen") != gen):
            self._count("duplicate")
            if self.trace is not None:
                self.trace.lease("duplicate", unit=unit.unit,
                                 gen=gen if gen is not None else -1,
                                 rows=int(rows))
            return False
        self.registry.counter("fabric_units_done",
                              host=self.host_id).inc()
        if self.trace is not None:
            self.trace.lease("done", unit=unit.unit,
                             gen=gen if gen is not None else -1,
                             rows=int(rows))
        return True

    def sleep(self, seconds: float) -> None:
        """The injectable poll sleep (``next_unit`` returned
        :data:`WAIT`)."""
        self._sleep(seconds)


def run_units(ledger: WorkLedger, groups, n_steps: int, *,
              watch_s: float, record_every: int = 0, warm_start=None,
              faults=None, journal=None, tracer=None, trace=None,
              poll_s: float = 0.25):
    """One host's fabric executor: claim → stream-dispatch → finalize
    until every unit in the ledger is done.

    Each claimed unit's items run through
    :func:`~..ops.dispatch.stream_groups_chunked` at the manifest's
    fleet-wide chunk shape (``exact_chunk`` — the tail unit pads to
    the same ``[B, P, …]`` program every host compiles, so steals
    never recompile), with rows flowing straight into the layer-2
    row cache and this host's journal shard as the chunk drains.
    Heartbeats bracket the dispatch; a host that dies between them
    leaves an expiring lease another host steals.

    Returns ``(results, unit_log)``: ``results[group]`` maps item
    index → metric tuple (or ``None`` for a row whose recovery
    budget ran out) for every row THIS host computed or served from
    cache under its claims, and ``unit_log`` records one entry per
    claimed unit (ordinal, slice, finalize outcome, structured
    failures)."""
    from ..ops.dispatch import stream_groups_chunked
    if warm_start is None or not warm_start.rows_enabled:
        raise ValueError(
            "the fabric requires the layer-2 row cache (steals are "
            "safe precisely because both completions resolve to one "
            "content-addressed row)")
    if trace is None:
        # the ledger's recorder (if any) also carries the dispatch
        # events, so one shard tells a unit's whole story
        trace = ledger.trace
    results = {gi: {} for gi in range(len(groups))}
    unit_log = []
    while True:
        got = ledger.next_unit()
        if got is None:
            break
        if got == WAIT:
            ledger.sleep(poll_s)
            continue
        unit = got
        config, items, build = groups[unit.group]
        sub = list(items)[unit.start:unit.start + unit.count]
        ledger.heartbeat(unit)
        stats_out = []
        keys = []
        computed = {}
        # the unit context frame ties every dispatch span / fault
        # counter / row event inside to the claim that scheduled it
        # (each unit runs as its own single-group stream, so the
        # inner group/chunk coordinates alone would all read (0, 0))
        unit_ctx = (trace.context(unit=unit.unit)
                    if trace is not None else contextlib.nullcontext())
        with unit_ctx:
            for event in stream_groups_chunked(
                    [(config, sub, build)], n_steps, watch_s=watch_s,
                    chunk=ledger.chunk(unit.group),
                    record_every=record_every, tracer=tracer,
                    pipeline=False, warm_start=warm_start,
                    faults=faults, journal=journal,
                    stats_out=stats_out, exact_chunk=True,
                    trace=trace):
                computed[unit.start + event.index] = event.metric
                if event.key is not None and event.metric is not None:
                    keys.append(event.key)
        ledger.heartbeat(unit)
        won = ledger.finalize(unit, rows=len(keys))
        results[unit.group].update(computed)
        unit_log.append({
            "unit": unit.unit, "group": unit.group,
            "start": unit.start, "count": unit.count, "won": won,
            "failures": stats_out[0]["failures"] if stats_out else []})
    return results, unit_log


def fleet_report(fabric_dir: str) -> dict:
    """Post-hoc ground truth from the claim files alone (no registry
    needed — a SIGKILL'd host's counters died with it, its claim
    records did not): per-unit claim generations and completions,
    plus the fleet totals the gate and the merged artifact's meta
    record.  ``claims`` counts fresh claims, ``expires`` lease
    takeovers (generation > 0), ``steals`` takeovers that changed
    hosts, ``duplicates`` done records beyond each unit's first."""
    claims_dir = os.path.join(fabric_dir, "claims")
    totals = {"units": 0, "finished": 0, "claims": 0, "steals": 0,
              "expires": 0, "duplicates": 0, "claim_races": 0}
    per_host: dict = {}
    units = []
    names = (sorted(os.listdir(claims_dir))
             if os.path.isdir(claims_dir) else [])
    for name in names:
        if not name.endswith(".jsonl"):
            continue
        records = _read_records(os.path.join(claims_dir, name))
        gens = [r for r in records if r.get("kind") == "claim"]
        dones = [r for r in records if r.get("kind") == "done"]
        totals["units"] += 1
        totals["finished"] += 1 if dones else 0
        totals["claims"] += 1 if gens else 0
        totals["duplicates"] += max(len(dones) - 1, 0)
        for prev, cur in zip(gens, gens[1:]):
            if cur.get("gen") == prev.get("gen"):
                # an append RACE (two hosts claimed the same gen;
                # the later record holds the lease, the earlier
                # host backed off uncounted) — not a takeover, so
                # it must not inflate expires/steals or the
                # file-vs-registry cross-check would false-alarm
                totals["claim_races"] += 1
                continue
            totals["expires"] += 1
            if cur.get("host") != prev.get("host"):
                totals["steals"] += 1
        for r in gens:
            host = per_host.setdefault(r.get("host"),
                                       {"claims": 0, "wins": 0,
                                        "duplicates": 0, "rows": 0})
            host["claims"] += 1
        for pos, r in enumerate(dones):
            host = per_host.setdefault(r.get("host"),
                                       {"claims": 0, "wins": 0,
                                        "duplicates": 0, "rows": 0})
            if pos == 0:
                host["wins"] += 1
                host["rows"] += int(r.get("rows", 0))
            else:
                host["duplicates"] += 1
        units.append({"unit": name, "gens": [
            {"host": r.get("host"), "gen": r.get("gen")}
            for r in gens],
            "done": [{"host": r.get("host"),
                      "rows": r.get("rows")} for r in dones]})
    return {**totals, "per_host": per_host, "units_detail": units}


def barrier(fabric_dir: str, host_id: str, n_hosts: int, *,
            clock=time.time, sleep=time.sleep,
            timeout_s: float = 300.0) -> None:
    """Start-line barrier for spawn-local fleets: each host drops a
    ready file and polls until ``n_hosts`` are present.  Without it,
    a fast-starting host can drain a small grid before its peers
    finish importing, and a chaos schedule keyed to claim ordinals
    never fires.  Purely advisory — production shared-FS fleets skip
    it (a late host just finds less work)."""
    ready_dir = os.path.join(fabric_dir, "barrier")
    os.makedirs(ready_dir, exist_ok=True)
    with open(os.path.join(ready_dir, f"{host_id}.ready"), "w",
              encoding="utf-8") as fh:
        fh.write(host_id + "\n")
    deadline = clock() + timeout_s
    while True:
        ready = [name for name in os.listdir(ready_dir)
                 if name.endswith(".ready")]
        if len(ready) >= n_hosts:
            return
        if clock() > deadline:
            raise RuntimeError(
                f"fabric barrier timed out: {len(ready)}/{n_hosts} "
                f"hosts ready after {timeout_s}s")
        sleep(0.05)
