"""The scenario twin: the reference's ``testing/twin.py``
(``hlsjs_p2p_wrapper_tpu/testing/twin.py``), ONE seeded scenario through
BOTH planes.

A :class:`TwinScenario` is the one seeded scenario both planes consume.
What is here, with the reference's names:

- the REAL plane (:func:`run_real_plane`, :class:`TwinSampler`,
  :class:`TwinRunResult`): the port's copy of the full-protocol harness
  (``testing/swarm.py`` ``SwarmHarness``: agents, tracker, shaped CDN,
  one VirtualClock), a sampler closing one frame window per
  ``window_s`` of simulated time from the live registry and, with a
  flight recorder, a ``twin_window`` mark per boundary so the SAME
  frames reconstruct from the event shard alone.  It is host Python and
  launches nothing; it is imported only when it runs, so the sim half
  below never loads the harness;
- the parity mapping (:func:`parity_sim_config`): full neighbours,
  foreground + 2 prefetch slots (:data:`SIM_CONCURRENCY`), the
  ``"spread"`` holder policy, the stall digest on, and the CDN rate
  corrected for the mock origin's pacing (:func:`effective_cdn_bps`);
- :func:`run_sim_plane`: the scenario through the port's simulator,
  its ``record_every`` timeline folded into the canonical frame (one
  timeline row a frame window);
- :func:`scenario_from_observation` and :func:`forecast_group`: the
  controller's forecast, observed membership on the parity mapping's
  lanes and the knob lattice as one dispatch group;
- :func:`split_shard`, :func:`peer_host` and :func:`host_bump_filter`:
  one recorded shard re-sharded per sampler host.

``run_sim_plane`` and ``forecast_group`` run on ``device``, the card
when None, as every entry point of the port does.

**The card's audience limit.**  The parity mapping's topology is full:
each peer's neighbour list is the other ``P - 1`` peers.  On the card a
neighbour list is at most ``ops.swarm_kernels.MAX_OFFS`` = 32 wide (the
kernels' bit masks), so the card takes twin audiences
(``TwinScenario.total_peers``) of at most 33 peers; a larger audience
raises ``ValueError`` before any launch.  The CPU path takes any
audience, and nothing falls back to it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..engine.population import (PopulationSpec, fault_specs_from,
                                 materialize)
from ..engine.twinframe import (FrameBuilder, ObservationFrame,
                                TWIN_WINDOW_MARK, frames_from_events,
                                frames_from_timelines)

#: the parity mapping's transfer-slot count: foreground + the agent's
#: DEFAULT_MAX_CONCURRENT_PREFETCH (tests/test_sim_vs_harness_parity)
SIM_CONCURRENCY = 3

#: join clock assigned to a forecast lane whose peer has NOT been
#: observed yet: far past any horizon (zero watch time, zero demand)
#: while staying well under the kernel's NEVER_S leave sentinel
ABSENT_JOIN_S = 1e9

#: the mock origin's progress-reporting cadence while shaped
#: (``MockCdnTransport.CHUNK_MS`` of the reference's
#: ``testing/mock_cdn.py``): the real plane delivers a segment in whole
#: quanta of it
CDN_CHUNK_MS = 100.0

#: the widest twin audience the card takes: full neighbour lists of
#: ``P - 1`` entries, at most ``swarm_kernels.MAX_OFFS`` = 32 wide
MAX_CARD_AUDIENCE = 33

#: materialized-population memo (TwinScenario._population): specs
#: are frozen, so identity + lane count key the deterministic result
_POP_MEMO: dict = {}


def effective_cdn_bps(scenario: "TwinScenario") -> float:
    """The parity mapping's CDN-PACING correction: the real plane's
    mock origin delivers a segment in ``latency_ms`` time-to-first-byte
    plus whole :data:`CDN_CHUNK_MS` pacing quanta, while the kernel's
    CDN leg accrues ``cdn_bps`` from the first tick — so the raw rate
    overstates what a real fetch achieves by the latency +
    quantization share of its wall.  The corrected rate is the nominal
    segment's bits over its actual mock-CDN wall, which is what the
    sim's continuous accrual needs to finish a segment in the same
    time the harness does."""
    seg_bytes = max(1.0, float(int(
        scenario.level_bitrates[0] * scenario.seg_duration_s / 8)))
    bytes_per_chunk = scenario.cdn_bps / 8000.0 * CDN_CHUNK_MS
    chunks = max(1, int(-(-seg_bytes // bytes_per_chunk)))
    wall_ms = scenario.cdn_latency_ms + chunks * CDN_CHUNK_MS
    return seg_bytes * 8.0 * 1000.0 / wall_ms


def _is_twin_family(name: str) -> bool:
    """The twin recorder's counter scope: the provenance families
    (engine/twinframe.py TWIN_EVENT_FAMILIES all share the prefix)."""
    return name.startswith("twin.")


def peer_host(peer: str, n_hosts: int) -> int:
    """The fleet's peer → sampler-host assignment (``crc32 % n``) —
    ONE formula shared by :func:`split_shard`'s default placement
    and the live multi-process sampler hosts, so a re-shard of
    single-host traffic and a genuine per-host recording of the same
    swarm place every peer identically (and so produce mux-identical
    shard sets)."""
    import zlib
    return zlib.crc32(peer.encode()) % n_hosts


def host_bump_filter(host_index: int, n_hosts: int):
    """Label-aware recorder predicate
    (:class:`~..engine.tracer.FlightRecorder` ``bump_filter``) for
    ONE sampler host of an ``n_hosts`` fleet: keep a ``twin.*`` bump
    iff :func:`peer_host` assigns its peer here (peer-less twin
    bumps follow the meta onto host 0 — :func:`split_shard`'s rule).
    Every fleet-wide bump lands on exactly one host's shard — the
    invariant the mux merge (and its exactness proof) relies on."""
    def keep(_name: str, labels_str: str) -> bool:
        peer = None
        for part in labels_str.split(","):
            if part.startswith("peer="):
                peer = part[len("peer="):]
                break
        if not peer:
            return host_index == 0
        return peer_host(peer, n_hosts) == host_index
    return keep


@dataclass(frozen=True)
class TwinScenario:
    """One seeded scenario, expressible in both planes."""

    seed: int = 0
    #: staggered base audience: peer i joins at
    #: ``join_offset_s + i * join_spacing_s``
    n_peers: int = 8
    join_spacing_s: float = 6.0
    join_offset_s: float = 0.5
    #: the join wave: ``wave_peers`` more viewers land together at
    #: ``wave_at_s`` (keep it off a window boundary)
    wave_peers: int = 4
    wave_at_s: float = 52.5
    frag_count: int = 24
    seg_duration_s: float = 4.0
    level_bitrates: Tuple[float, ...] = (800_000.0,)
    cdn_bps: float = 8_000_000.0
    uplink_bps: float = 2_400_000.0
    #: scenario horizon and frame window; ``watch_s`` must be a
    #: multiple of ``window_s`` so both planes close the same windows
    watch_s: float = 160.0
    window_s: float = 8.0
    #: the mock origin's time-to-first-byte (the harness default);
    #: part of the parity mapping via :func:`effective_cdn_bps`
    cdn_latency_ms: float = 15.0
    #: real-plane chaos in the shared NetFaultPlan grammar
    #: (``loss@40-70,latency@90-110``); None = clean wire
    fault_specs: Optional[str] = None
    fault_kwargs: dict = field(default_factory=dict)
    #: heterogeneous population (engine/population.py): when set,
    #: the SAME materialized spec drives BOTH planes' join schedules
    #: and per-peer uplinks, and its regional-partition windows land
    #: as real-plane ``partition@T0-T1`` fault specs (the shared
    #: NetFaultPlan grammar) unless ``fault_specs`` overrides them.
    #: Connectivity classes and device ladder caps stay simulator
    #: features — the real-plane harness has no CDN-only transport
    #: mode — so a twin population should keep every cohort
    #: "open"/uncapped.
    population: Optional[PopulationSpec] = None

    def _population(self):
        """Materialized population arrays — memoized on the FULL
        materialization inputs (the spec is a frozen, hashable
        dataclass), so two scenarios sharing a spec but differing
        in lane count, ladder, or inherit defaults never alias."""
        key = (self.population, self.total_peers,
               len(self.level_bitrates), self.uplink_bps,
               self.cdn_bps)
        cached = _POP_MEMO.get(key)
        if cached is None:
            cached = _POP_MEMO[key] = materialize(
                self.population, self.total_peers,
                n_levels=len(self.level_bitrates),
                default_uplink_bps=self.uplink_bps,
                default_cdn_bps=self.cdn_bps)
        return cached

    def join_times_s(self, wave_shift_s: float = 0.0) -> List[float]:
        """Every peer's join clock (seconds): the staggered base
        audience then the wave cohort — or, with a ``population``,
        the spec's materialized arrival processes.  ``wave_shift_s``
        displaces the wave (the population's wave-arrival cohorts)
        only — the twin gate's injected sim-fidelity bug (a
        scenario-mapping error, localized in time)."""
        if self.population is not None and not \
                self.population.inherits_joins:
            pop = self._population()
            wave = {k for k, c in enumerate(self.population.cohorts)
                    if c.arrival.kind == "wave"}
            return [float(t) + (wave_shift_s if int(k) in wave
                                else 0.0)
                    for t, k in zip(pop.join_s, pop.cohort_id)]
        base = [self.join_offset_s + i * self.join_spacing_s
                for i in range(self.n_peers)]
        wave = [self.wave_at_s + wave_shift_s] * self.wave_peers
        return base + wave

    def uplinks_bps(self) -> List[float]:
        """Per-peer uplink rates: the population's materialized
        mixture, or the homogeneous default."""
        if (self.population is not None
                and self._population().uplink_bps is not None):
            return [float(u)
                    for u in self._population().uplink_bps]
        return [float(self.uplink_bps)] * self.total_peers

    def effective_fault_specs(self) -> Optional[str]:
        """Real-plane chaos: explicit ``fault_specs`` first, else
        the population's regional-partition windows rendered in the
        shared grammar (engine/population.py ``fault_specs_from``)."""
        if self.fault_specs is not None:
            return self.fault_specs
        if self.population is not None:
            return fault_specs_from(self.population)
        return None

    @property
    def total_peers(self) -> int:
        return self.n_peers + self.wave_peers

    @property
    def n_windows(self) -> int:
        return int(round(self.watch_s / self.window_s))


class TwinSampler:
    """The real plane's frame recorder: one VirtualClock timer per
    ``window_ms`` reads the live registry's ``twin.*`` provenance
    totals and the harness membership into the shared
    :class:`FrameBuilder`, closes the window, and — with a recorder —
    emits the ``twin_window`` mark (flushed, so a console tailing the
    shard sees calibration windows live and a SIGKILL costs at most
    the open window)."""

    def __init__(self, harness: "SwarmHarness", window_ms: float,
                 recorder=None, source: str = "real",
                 flush_every: int = 1, on_window=None):
        self.harness = harness
        self.window_ms = float(window_ms)
        self.recorder = recorder
        self.builder = FrameBuilder(source, window_ms / 1000.0)
        self.windows = 0
        #: ``on_window(index)`` fires after each window closed (and
        #: its mark flushed) — the fleet gate's sampler-death hook
        #: (a host SIGKILLing itself after window K dies with K+1
        #: durable windows, deterministically)
        self.on_window = on_window
        #: flush the recorder every Nth window instead of every one —
        #: the batch-extraction setting (run_real_plane), where nobody
        #: tails the shard live and per-window flush syscalls were a
        #: measured share of the armed cost (the reference's bench,
        #: ``detail.fleet_ingest.armed``).  Live consumers (the
        #: control/SLO gates' in-process tails) keep the default 1:
        #: a window marked is a window visible.  SIGKILL now costs at
        #: most the UNFLUSHED windows (≤ flush_every), not one.
        self.flush_every = max(int(flush_every), 1)
        self._arm()

    def _arm(self) -> None:
        self.harness.clock.call_later(self.window_ms, self._tick)

    def _tick(self) -> None:
        harness = self.harness
        t_ms = harness.clock.now()
        builder = self.builder
        for peer in harness.peers:
            builder.set_join(peer.peer_id, peer.joined_at_ms)
            if peer.left_at_ms is not None:
                builder.set_leave(peer.peer_id, peer.left_at_ms)
        for labels, value in harness.metrics.series("twin.fetch_bytes"):
            builder.set_bytes_total(labels["peer"], labels["src"],
                                    value)
        for labels, value in harness.metrics.series("twin.stall_ms"):
            builder.set_stall_total(labels["peer"], value)
        builder.close_window(t_ms)
        if self.recorder is not None:
            self.recorder.mark(TWIN_WINDOW_MARK, window=self.windows,
                               window_ms=self.window_ms)
            # OS-write durability is the per-batch contract: a
            # SIGKILL'd writer keeps every flushed window; per-window
            # fsyncs only guard host crashes and were a measured
            # double-digit share of the armed cost (tracer.flush)
            if (self.windows + 1) % self.flush_every == 0:
                self.recorder.flush(fsync=False)
        self.windows += 1
        if self.on_window is not None:
            self.on_window(self.windows - 1)
        self._arm()

    def frame(self) -> ObservationFrame:
        return self.builder.frame()


@dataclass
class TwinRunResult:
    """One real-plane run's outputs: the registry-derived frame, the
    event-reconstructed frame (None without a recorder), the shard
    path, the harness's final north-star pair, and the injected
    transport-fault counts by kind (``mesh.transport_faults`` — the
    population gate's proof that a spec's partition windows actually
    FIRED on the wire)."""

    registry_frames: ObservationFrame
    event_frames: Optional[ObservationFrame]
    shard_path: Optional[str]
    offload: float
    rebuffer: float
    transport_faults: dict = field(default_factory=dict)


def run_real_plane(scenario: TwinScenario,
                   trace_dir: Optional[str] = None,
                   host_id: str = "twin00",
                   extract_events: bool = True) -> TwinRunResult:
    """Run the scenario through the real-protocol swarm and extract
    frames both ways: sampled live from the registries, and — when
    ``trace_dir`` is given — reconstructed from the flight-recorder
    shard alone (the twin gate, ``tools/twin_gate.py``, asserts the
    two are exactly equal).  ``extract_events=False`` skips the post-run shard read +
    reconstruction (``event_frames`` stays None, the shard stays on
    disk): the overhead bench times the run with ONLY the recorder
    armed, so extraction cost cannot masquerade as arming cost."""
    from .swarm import SwarmHarness

    fault_specs = scenario.effective_fault_specs()
    harness = SwarmHarness(
        seg_duration=scenario.seg_duration_s,
        frag_count=scenario.frag_count,
        level_bitrates=tuple(int(b) for b in scenario.level_bitrates),
        cdn_bandwidth_bps=scenario.cdn_bps,
        cdn_latency_ms=scenario.cdn_latency_ms, seed=scenario.seed,
        fault_plan_specs=fault_specs,
        fault_plan_kwargs=({"seed": scenario.seed,
                            **scenario.fault_kwargs}
                           if fault_specs else None))
    recorder = None
    shard_path = None
    if trace_dir is not None:
        from ..engine.tracer import FlightRecorder
        # the twin recorder is scoped to the twin data plane: only
        # ``twin.*`` bumps become events (the families the frame
        # reconstruction and the Perfetto twin tracks consume) —
        # recording every unrelated family's bumps too was a
        # measured third of the armed event plane's cost for zero
        # calibration signal (the reference's bench,
        # ``detail.twin_overhead``)
        recorder = FlightRecorder(trace_dir, host_id,
                                  clock=harness.clock.now,
                                  registry=harness.metrics,
                                  counter_filter=_is_twin_family)
        shard_path = recorder.path
    # batch extraction: nobody tails this shard live, so flush every
    # 4th window (the recorder's close() lands the final partial
    # batch) — a SIGKILL'd run keeps every flushed window exactly
    sampler = TwinSampler(harness, scenario.window_s * 1000.0,
                          recorder=recorder, flush_every=4)
    # replay joins in TIME order, not list order: the wave cohort sits
    # after the base audience in join_times_s() but may land before
    # its tail (n_peers >= 10 at the default spacing), and the clamp
    # below would silently displace it — peer ids keep the list index
    # so p{i} still maps to the sim plane's joins[i]
    joins = scenario.join_times_s()
    uplinks = scenario.uplinks_bps()
    for i in sorted(range(len(joins)), key=lambda i: (joins[i], i)):
        harness.run(max(joins[i] * 1000.0 - harness.clock.now(), 0.0))
        harness.add_peer(f"p{i}", uplink_bps=uplinks[i])
    harness.run(scenario.watch_s * 1000.0 - harness.clock.now())
    event_frames = None
    if recorder is not None:
        recorder.close()
        if extract_events:
            from ..engine.tracer import read_shard
            _meta, events = read_shard(shard_path)
            event_frames = frames_from_events(events)
    return TwinRunResult(registry_frames=sampler.frame(),
                         event_frames=event_frames,
                         shard_path=shard_path,
                         offload=harness.offload_ratio,
                         rebuffer=harness.rebuffer_ratio,
                         transport_faults={
                             labels.get("kind", "?"): value
                             for labels, value in harness.metrics
                             .series("mesh.transport_faults")})


def parity_sim_config(scenario: TwinScenario,
                      n_peers: Optional[int] = None):
    """The calibrated parity mapping's STATIC half: the kernel config
    every sim-plane consumer (the frame extractor below, the control
    plane's forecast sweep) must share — tracker topology = full
    neighbors, foreground + 2 prefetch slots, the "spread" holder
    policy.  One definition, so a parity fix lands in every
    consumer at once."""
    from ..ops.swarm_sim import SwarmConfig

    return SwarmConfig(
        n_peers=n_peers or scenario.total_peers,
        n_segments=scenario.frag_count,
        n_levels=len(scenario.level_bitrates),
        seg_duration_s=scenario.seg_duration_s,
        max_concurrency=SIM_CONCURRENCY, holder_selection="spread",
        # the fleet-observability tail columns (engine/digest.py):
        # per-peer interval stall binned in-kernel with the shared
        # digest edges, so the sim frame carries the same
        # rebuffer_ms quantile trio the real plane's FrameBuilder
        # computes (not written where record_every=0, e.g. the
        # controller's forecast sweeps)
        stall_digest=True)


def run_sim_plane(scenario: TwinScenario, wave_shift_s: float = 0.0,
                  device=None) -> ObservationFrame:
    """Run the scenario through the port's simulator on the calibrated
    parity mapping, on ``device`` (the card when None), and fold its
    ``record_every`` timeline into the canonical frame (one timeline
    sample per window).  ``wave_shift_s`` displaces the wave cohort's
    joins in the SIM ONLY — the deliberately injected fidelity bug the
    gate's detectors must localize to the membership columns at the
    wave window.  On the card an audience over
    :data:`MAX_CARD_AUDIENCE` raises ``ValueError``."""
    from ..ops.swarm_sim import (full_neighbors, init_swarm, run_swarm,
                                 timeline_columns)

    dev = resolve_device(device)
    P = scenario.total_peers
    config = parity_sim_config(scenario)
    record_every = int(round(scenario.window_s * 1000.0
                             / config.dt_ms))
    n_steps = scenario.n_windows * record_every
    joins = scenario.join_times_s(wave_shift_s)
    _final, _series, timeline = run_swarm(
        config, [float(b) for b in scenario.level_bitrates],
        full_neighbors(P, device=dev),
        torch.full((P,), effective_cdn_bps(scenario),
                   dtype=torch.float32, device=dev),
        init_swarm(config, device=dev), n_steps, joins,
        uplink_bps=scenario.uplinks_bps(),
        record_every=record_every, device=dev)
    return frames_from_timelines(
        timeline_columns(config), timeline.cpu().numpy().tolist(),
        join_s=joins, leave_s=None)


def scenario_from_observation(spec: TwinScenario, join_ms,
                              leave_ms=None):
    """OBSERVED membership → the forecast kernel's join AND leave
    schedules.

    ``join_ms`` / ``leave_ms`` map peer id → observed clock (engine
    ms, ``FrameBuilder.membership()``); the result is a
    ``(join_s, leave_s)`` pair of ``[P_total]`` vectors in SECONDS on
    the parity mapping's lanes: observed joins in time order first
    (deterministic tie-break on peer id, each lane carrying its own
    peer's observed departure — ``NEVER_S`` while it stays), then
    :data:`ABSENT_JOIN_S` / ``NEVER_S`` for every not-yet-observed
    lane — keeping the lane count (and so the forecast program's
    shape) CONSTANT as membership changes.  A departed peer must
    NOT keep forecasting as an active uplink supplier — exactly the
    degraded-membership regimes the controller reacts to.
    Observation beyond the spec's audience is a hard error: the
    forecast program's shape is the spec's contract, and silently
    dropping observed peers would bias every forecast low."""
    from ..ops.swarm_sim import NEVER_S

    if len(join_ms) > spec.total_peers:
        raise ValueError(
            f"observed {len(join_ms)} peers exceeds the forecast "
            f"spec's audience of {spec.total_peers}")
    leave_ms = leave_ms or {}
    joins = sorted((float(t_ms) / 1000.0, peer)
                   for peer, t_ms in join_ms.items())
    join_out = [t for t, _peer in joins]
    leave_out = [float(leave_ms[peer]) / 1000.0
                 if peer in leave_ms else NEVER_S
                 for _t, peer in joins]
    pad = spec.total_peers - len(join_out)
    join_out += [ABSENT_JOIN_S] * pad
    leave_out += [NEVER_S] * pad
    return join_out, leave_out


def split_shard(shard_path: str, out_dir: str, n_shards: int,
                prefix: str = "mux", assign=None,
                binary: bool = False) -> List[str]:
    """Re-shard ONE recorded flight-recorder shard into ``n_shards``
    per-host-shaped shards: every peer's ``twin.*`` events land on
    the shard ``crc32(peer) % n_shards`` picks (a peer lives on
    exactly one host — the fleet invariant the mux merge relies on;
    pass ``assign(peer) -> index`` for an explicit placement, e.g.
    one shard per cohort), the ``twin_window`` marks are replicated
    into EVERY shard (each host's sampler closes its own windows on
    the shared virtual clock), and peer-less records follow the meta
    onto shard 0.

    Because the split preserves each peer's event order and window
    assignment exactly, a correct mux merge of the split MUST
    reproduce the single-shard frames bit-for-bit.

    ``binary=True`` re-frames each output shard through its own
    :class:`~.engine.recordio.ShardEncoder` (per-shard string
    tables, meta line still JSONL) — the fleet-shaped input for the
    columnar replay; the default keeps the splits as plain JSONL."""
    import json
    import os

    from ..engine.recordio import ShardEncoder
    from ..engine.tracer import read_shard
    from ..engine.twinframe import TWIN_WINDOW_MARK, parse_labels

    os.makedirs(out_dir, exist_ok=True)
    meta, events = read_shard(shard_path)
    paths = [os.path.join(out_dir, f"{prefix}{i:02d}.jsonl")
             for i in range(n_shards)]
    handles = [open(path, "wb") for path in paths]
    encoders = [ShardEncoder() if binary else None
                for _ in range(n_shards)]

    def write(i, event):
        if encoders[i] is not None:
            handles[i].write(encoders[i].encode(event))
        else:
            handles[i].write(
                (json.dumps(event)  # jsonl-ok: text-mode split
                 + "\n").encode("utf-8"))

    try:
        for i, fh in enumerate(handles):
            header = dict(meta or {"kind": "meta"})
            header["host"] = f"{prefix}{i:02d}"
            fh.write((json.dumps(header)  # jsonl-ok: meta header
                      + "\n").encode("utf-8"))
        for event in events:
            if event.get("kind") == "mark" \
                    and event.get("name") == TWIN_WINDOW_MARK:
                for i in range(n_shards):
                    write(i, event)
                continue
            peer = parse_labels(event.get("labels", "")).get("peer")
            if not peer:
                shard = 0
            elif assign is not None:
                shard = int(assign(peer)) % n_shards
            else:
                shard = peer_host(peer, n_shards)
            write(shard, event)
    finally:
        for fh in handles:
            fh.close()
    return paths


def forecast_group(spec: TwinScenario, join_s, knob_list,
                   leave_s=None, device=None):
    """One control-tick forecast sweep as the dispatch engine's unit
    of work: a ``(config, items, build)`` triple for
    ``ops.dispatch.stream_groups_chunked``, on the SAME parity mapping
    as :func:`run_sim_plane` — full neighbors, corrected CDN pacing,
    shared uplink — with every candidate's scheduler knobs landing
    as scenario scalars (one dispatch group for the whole lattice,
    every tick).  The scenarios are built on ``device`` (the card when
    None) and share one neighbour list, so its check and inverse are
    made once."""
    from ..ops.swarm_sim import full_neighbors, make_scenario

    dev = resolve_device(device)
    P = spec.total_peers
    config = parity_sim_config(spec)

    def f32(values):
        return torch.from_numpy(
            np.asarray(values, dtype=np.float32)).to(dev)

    bitrates = f32([float(b) for b in spec.level_bitrates])
    neighbors = full_neighbors(P, device=dev)
    cdn = f32(np.full((P,), effective_cdn_bps(spec)))
    uplink = f32(np.full((P,), float(spec.uplink_bps)))
    join = f32(list(join_s))
    leave = f32(list(leave_s)) if leave_s is not None else None

    def build(knobs):
        scenario = make_scenario(
            config, bitrates, neighbors, cdn, join,
            uplink_bps=uplink, leave_s=leave,
            urgent_margin_s=knobs.get("urgent_margin_s"),
            p2p_budget_fraction=knobs.get("p2p_budget_fraction"),
            p2p_budget_cap_ms=knobs.get("p2p_budget_cap_ms"),
            p2p_budget_floor_ms=knobs.get("p2p_budget_floor_ms"),
            device=dev)
        return scenario, join

    return config, list(knob_list), build
