"""Control-plane gate on the port: the forecast-driven controller closes
the observe → predict → actuate loop under chaos, measurably and
deterministically.

The reference's ``tools/control_gate.py`` (``gate_spec``,
``control_config``, ``run_plane``, ``decision_fingerprint``,
``part_a``, ``part_b``, ``part_c``, ``part_consumers`` and ``main``,
:116-605) on the port's ``engine/controller.py`` and ``tools.control``,
its real-protocol plane (``testing/swarm.py``, ``engine/net.py``,
``engine/netfaults.py``, ``engine/tracker.py``, ``engine/p2p_agent.py``)
and its trace consumers.  The controller's forecasts run on ``--device``
(the card by default; without one the gate exits 2 before any work
unless given ``--device cpu``); the committed twin bands
(``TWIN_r10.json``) are the error bar the do-no-harm rule inherits.
Three parts:

**A — the closed loop wins under chaos (deterministic plane).**  A
scarce-supply swarm scenario (uplink just above the bitrate, a slow
per-fetch CDN) with an injected regional degradation — a
``NetFaultPlan`` loss window over the P2P fabric — runs twice on the
loopback harness: once with a STATIC aggressive config, once with the
live controller closing the loop each observation window (tail-follow
ingest of the twin provenance shard, a candidate-knob-lattice forecast
dispatch on the warm engine, the banded do-no-harm decision, SET_KNOBS
actuation through the tracker).  Asserted: the controller actuates
(epochs strictly monotone, every live agent converges to the final
epoch), every recorded decision names the twin band it cleared or held
inside, and the controlled run BEATS the static run on the constrained
objective by more than the committed chaos-band envelope.  A same-seed
rerun (same cache) must reproduce the identical decision sequence and
identical frames, every forecast a row-cache hit.

**B — actuation survives the real wire.**  A real-TCP PSK swarm on the
loopback interface (socket tracker, ``concurrent=True``, full agents)
takes a knob epoch through SET_KNOBS → piggybacked KNOB_UPDATE; a stale
epoch is refused and counted; a late joiner converges on its FIRST
announce; and a blackhole window severing every link mid-epoch heals,
with the recovery counted in ``net.reconnects`` (or ``net.mac_drops``).

**C — SIGKILL mid-tick, resume, same decisions.**  ``python -m
hlsjs_p2p_wrapper_tpu_torch.tools.control ... --device <the gate's>``
replays part A's recorded shard offline twice: an uninterrupted
reference, and a run SIGKILLed after its first actuation lands in the
fsync'd actuation log, BEFORE the tick checkpoints.  The resumed run
must re-derive the IDENTICAL decision sequence (equal to the reference
AND to part A's live loop), with the actuation log holding each epoch
EXACTLY once.

Deviations from the reference gate, none of them in what is checked:
the parts run side by side in ``testing/tool_child.py`` processes that
:func:`prepare` starts waiting (``testing/tool_child.py control_gate
--prepare`` starts them beside its own start).  Part A's static run and
part B run in children of their own from the go; part C's three
``tools.control`` children run as a chain (reference, kill, resume)
beside part A's rerun, on a copy of part A's warm-start root taken
after the controlled run (rows and all), so that the rerun's checkpoint
writes cannot reach the killed run's.  Every check is printed in the
reference's order after the parts end.  The gate prints its stages'
walls and ends with ``# children's kernels: {...}``: the ``nvcc``
builds, captures and launches of its children (0 builds expected).

Gate-sized by default; ``CONTROL_GATE_SEED`` / ``CONTROL_GATE_PEERS``
/ ``CONTROL_GATE_WAVE`` resize it.  Run: ``python -m
hlsjs_p2p_wrapper_tpu_torch.tools.control_gate [--device cpu]`` (exit 1
on any violation).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import signal
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

from . import (WaitingTool, add_device_flag, add_kernels, child_report,
               kernels_reported, open_device, report_children)
from ..engine.artifact_cache import WarmStart, atomic_write_text
from ..engine.controller import (ControlConfig, ControlLoop,
                                 TransportActuator, band_halfwidth,
                                 control_checkpoint_path)
from ..engine.search import Constraint
from ..engine.tracer import FlightRecorder
from ..engine.tracker import swarm_id_for
from ..testing.swarm import SwarmHarness
from ..testing.twin import TwinSampler, TwinScenario, _is_twin_family

#: the checkout's root: the committed bands, the children's working
#: directory
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

BANDS_PATH = os.path.join(_ROOT, "TWIN_r10.json")

#: the injected regional degradation: a loss band over the P2P
#: fabric through the middle of the watch window (the wave cohort
#: lands inside it)
CHAOS_SPECS = "loss@40-120"
CHAOS_KWARGS = {"loss_rate": 0.4}

#: the static config under test: long P2P budgets — high offload on
#: a clean wire, heavy stalls when transfers crawl or die
STATIC_KNOBS = {"p2p_budget_cap_ms": 6000.0,
                "p2p_budget_fraction": 0.9}

#: the candidate lattice around it (the controller only ever
#: actuates lattice points; the static config is one of them)
KNOB_GRID = {"p2p_budget_cap_ms": [500.0, 6000.0],
             "p2p_budget_fraction": [0.5, 0.9]}

CONSTRAINT = "rebuffer<=0.05"
BAND_SET = "chaos"

CHECKS = []

#: the gate's children, by role: part A's static run, part B, and part
#: C's three ``tools.control`` runs
_CHILD_TOOLS = {"static": "control_gate", "part_b": "control_gate",
                "ref": "control", "kill": "control", "resume": "control"}
#: the children :func:`prepare` started, by role
_PREPARED: dict = {}


def check(ok, what):
    CHECKS.append((bool(ok), what))
    print(f"  [{'ok ' if ok else 'FAIL'}] {what}")


def gate_spec() -> TwinScenario:
    """The gate scenario: scarce supply (uplink just above the
    bitrate, per-fetch CDN barely real-time) where the P2P budget
    knobs genuinely trade offload against rebuffer — in BOTH
    planes — plus the chaos window on the real wire."""
    return TwinScenario(
        seed=int(os.environ.get("CONTROL_GATE_SEED", 0)),
        n_peers=int(os.environ.get("CONTROL_GATE_PEERS", 8)),
        wave_peers=int(os.environ.get("CONTROL_GATE_WAVE", 4)),
        uplink_bps=900_000.0, cdn_bps=1_200_000.0,
        fault_specs=CHAOS_SPECS, fault_kwargs=dict(CHAOS_KWARGS))


def control_config(spec: TwinScenario) -> ControlConfig:
    with open(BANDS_PATH, encoding="utf-8") as fh:
        artifact = json.load(fh)
    return ControlConfig(
        spec=spec, knob_grid={k: list(v)
                              for k, v in KNOB_GRID.items()},
        initial_knobs=dict(STATIC_KNOBS),
        constraint=Constraint.parse(CONSTRAINT),
        bands=artifact["scenarios"][BAND_SET]["bands"],
        band_set=BAND_SET,
        swarm_id=swarm_id_for(None, {"content_id": "swarm-content"}))


def run_plane(spec: TwinScenario, knobs: dict, trace_dir=None,
              cache_dir=None, controlled=False,
              checkpoint_path=None, device=None):
    """One harness run, window-locked: joins replayed in time order,
    one TwinSampler window per ``window_s``, and — when
    ``controlled`` — one ControlLoop poll after every closed window
    (the live service's cadence, driven synchronously so the run is
    deterministic), its forecasts on ``device``.  Every peer starts
    from ``knobs`` (the static config; the controller moves them from
    there)."""
    harness = SwarmHarness(
        seg_duration=spec.seg_duration_s, frag_count=spec.frag_count,
        level_bitrates=tuple(int(b) for b in spec.level_bitrates),
        cdn_bandwidth_bps=spec.cdn_bps,
        cdn_latency_ms=spec.cdn_latency_ms, seed=spec.seed,
        fault_plan_specs=spec.fault_specs,
        fault_plan_kwargs=({"seed": spec.seed, **spec.fault_kwargs}
                           if spec.fault_specs else None))
    recorder = None
    shard_path = None
    if trace_dir is not None:
        recorder = FlightRecorder(trace_dir, "twin00",
                                  clock=harness.clock.now,
                                  registry=harness.metrics,
                                  counter_filter=_is_twin_family)
        shard_path = recorder.path
    sampler = TwinSampler(harness, spec.window_s * 1000.0,
                          recorder=recorder)
    loop = None
    ctrl_recorder = None
    if controlled:
        config = control_config(spec)
        warm = WarmStart(cache_dir=cache_dir)
        ctrl_recorder = FlightRecorder(trace_dir, "ctrl00",
                                       clock=harness.clock.now,
                                       registry=warm.registry)
        endpoint = harness.network.register("controller")
        actuator = TransportActuator(endpoint, config.swarm_id,
                                     registry=warm.registry)
        loop = ControlLoop(
            config, shard_path, actuator, warm_start=warm,
            registry=warm.registry, recorder=ctrl_recorder,
            checkpoint_path=(checkpoint_path
                             or control_checkpoint_path(
                                 warm.cache_dir, config)),
            device=device)
    joins = spec.join_times_s()
    order = sorted(range(len(joins)), key=lambda i: (joins[i], i))
    next_join = 0
    try:
        for k in range(1, spec.n_windows + 1):
            target = k * spec.window_s * 1000.0
            while next_join < len(order) and \
                    joins[order[next_join]] * 1000.0 <= target:
                i = order[next_join]
                harness.run(max(joins[i] * 1000.0
                                - harness.clock.now(), 0.0))
                harness.add_peer(f"p{i}",
                                 uplink_bps=spec.uplink_bps,
                                 p2p_config=dict(knobs))
                next_join += 1
            harness.run(target - harness.clock.now())
            if loop is not None:
                loop.run_available()
    finally:
        if recorder is not None:
            recorder.close()
        if ctrl_recorder is not None:
            ctrl_recorder.close()
    return {
        "offload": harness.offload_ratio,
        "rebuffer": harness.rebuffer_ratio,
        "frames": sampler.frame(),
        "harness": harness,
        "loop": loop,
        "shard": shard_path,
        "ctrl_shard": (ctrl_recorder.path
                       if ctrl_recorder is not None else None),
    }


def decision_fingerprint(decisions):
    """The comparable view of a decision sequence (strips the
    per-run timing fields none of which exist in decisions — the
    decisions ARE pure — so this is just a stable JSON render)."""
    return json.dumps(decisions, sort_keys=True)


def static_child(out: str) -> int:
    """Child body: part A's static run, its ratios written to
    ``out``."""
    static = run_plane(gate_spec(), STATIC_KNOBS)
    atomic_write_text(out, json.dumps({"offload": static["offload"],
                                       "rebuffer": static["rebuffer"]}))
    return 0


def part_b_child(out: str) -> int:
    """Child body: part B, its checks written to ``out`` as ``[[ok,
    what], ...]``."""
    try:
        part_b()
    finally:
        atomic_write_text(out, json.dumps(CHECKS))
    return 0


def _child_result(name, child, walls, t_go):
    """Wait for a child; its exit code, standard output and error.  Its
    wall goes into ``walls[name]``: the run's own, from its go to its
    return, as the child reports it, else (a killed child) the host
    wall from its go to now."""
    rc, out, err = child.wait()
    walls[name] = child_report(out).get("wall_s",
                                        time.perf_counter() - t_go)
    return rc, out, err


def part_a(root, device, children, walls, t_static):
    """The closed loop beats the static config under chaos.  The static
    run is the ``static`` child's (sent its go at ``t_static``); part C's
    chain starts in a thread once the controlled run has recorded its
    shard, beside the rerun.  Returns part A's results and part C's
    future."""
    spec = gate_spec()
    config = control_config(spec)
    constraint = config.constraint
    cache_dir = os.path.join(root, "cache")

    print(f"control-gate A: static run ({spec.total_peers} peers, "
          f"chaos {spec.fault_specs})")
    print("control-gate A: controlled run")
    trace_dir = os.path.join(root, "controlled")
    t0 = time.perf_counter()
    controlled = run_plane(spec, STATIC_KNOBS, trace_dir=trace_dir,
                           cache_dir=cache_dir, controlled=True,
                           device=device)
    walls["a_controlled"] = time.perf_counter() - t0
    loop = controlled["loop"]
    a = {"spec": spec, "config": config, "loop": loop,
         "shard": controlled["shard"],
         "ctrl_shard": controlled["ctrl_shard"],
         "cache_dir": cache_dir}

    # part C from here, on a copy of this root, beside the rerun
    cache_c = os.path.join(root, "cache_c")
    shutil.copytree(cache_dir, cache_c)
    pool = ThreadPoolExecutor(1)
    part_c_future = pool.submit(run_part_c, dict(a, cache_dir=cache_c),
                                device, children, walls)
    pool.shutdown(wait=False)

    print("control-gate A: same-seed controlled rerun")
    t0 = time.perf_counter()
    rerun = run_plane(spec, STATIC_KNOBS,
                      trace_dir=os.path.join(root, "rerun"),
                      cache_dir=cache_dir, controlled=True, device=device)
    walls["a_rerun"] = time.perf_counter() - t0

    rc, out, err = _child_result("a_static", children["static"], walls,
                                 t_static)
    if rc != 0:
        raise SystemExit(f"control-gate: static-run child failed:\n"
                         f"{out}\n{err}")
    with open(os.path.join(root, "static.json"), encoding="utf-8") as fh:
        static = json.load(fh)
    print(f"  static: offload={static['offload']:.4f} "
          f"rebuffer={static['rebuffer']:.5f}")
    print(f"  controlled: offload={controlled['offload']:.4f} "
          f"rebuffer={controlled['rebuffer']:.5f}, "
          f"epoch={loop.epoch}, "
          f"{sum(1 for d in loop.decisions if d['action'] == 'actuate')}"
          f" actuations / {len(loop.decisions)} ticks")

    # the loop ran and actuated
    check(len(loop.decisions) == spec.n_windows,
          f"one control tick per window "
          f"({len(loop.decisions)}/{spec.n_windows})")
    actuations = [d for d in loop.decisions
                  if d["action"] == "actuate"]
    check(len(actuations) >= 1,
          f"controller actuated ({len(actuations)} actuations)")
    epochs = [d["epoch"] for d in actuations]
    check(epochs == list(range(1, len(epochs) + 1)),
          f"knob epochs strictly monotone from 1: {epochs}")

    # every decision names its band; in-band decisions are holds
    check(all("band" in d and d["band"]["set"] == BAND_SET
              for d in loop.decisions),
          "every decision names the TWIN_r10 band set it was "
          "measured against")
    for d in loop.decisions:
        if d["action"] == "actuate":
            if not (d["band"]["delta"] is not None
                    and d["band"]["delta"] > d["band"]["halfwidth"]):
                check(False, f"actuation at tick {d['tick']} did "
                             f"not clear its band: {d['band']}")
                break
    else:
        check(True, "every actuation cleared its named band "
                    "(delta > halfwidth)")
    check(all(d.get("reason") for d in loop.decisions
              if d["action"] in ("hold", "veto")),
          "every hold/veto carries its reason (band / warmup / "
          "hysteresis)")
    holds = loop.registry.series("control.holds")
    check(sum(v for _l, v in holds) ==
          sum(1 for d in loop.decisions if d["action"] == "hold"),
          "holds counted in control.holds exactly")
    check(int(loop.registry.counter("control.actuations").value)
          == len(actuations),
          "actuations counted in control.actuations exactly")

    # the swarm converged to the controller's final epoch
    agents = [p.agent for p in controlled["harness"].peers
              if p.agent is not None]
    final_knobs = loop.current_knobs
    converged = [ag for ag in agents
                 if ag.tracker_client.knob_epoch == loop.epoch
                 and all(getattr(ag.policy, k) == v
                         for k, v in final_knobs.items())]
    check(len(converged) == len(agents),
          f"every live agent converged to epoch {loop.epoch} "
          f"({len(converged)}/{len(agents)})")

    # the WIN: controlled beats static on the constrained objective
    # by more than the committed chaos-band envelope
    s_trial = {"offload": static["offload"],
               "rebuffer": static["rebuffer"]}
    c_trial = {"offload": controlled["offload"],
               "rebuffer": controlled["rebuffer"]}
    s_feas = constraint.feasible(s_trial)
    c_feas = constraint.feasible(c_trial)
    check(c_feas,
          f"controlled run satisfies {CONSTRAINT}: "
          f"rebuffer={c_trial['rebuffer']:.5f}")
    if c_feas and not s_feas:
        metric = constraint.metric
        delta = s_trial[metric] - c_trial[metric]
    else:
        metric = constraint.objective
        delta = c_trial[metric] - s_trial[metric]
    hw = band_halfwidth(config.bands, metric, s_trial[metric],
                        c_trial[metric])
    check(delta > hw,
          f"controlled beats static on {metric} beyond the "
          f"committed {BAND_SET} band: delta={delta:.5f} > "
          f"halfwidth={hw:.5f}")

    # determinism: same seed + same cache, identical decisions and
    # identical frames
    check(decision_fingerprint(rerun["loop"].decisions)
          == decision_fingerprint(loop.decisions),
          "same-seed rerun reproduced the identical decision "
          "sequence")
    check(rerun["frames"] == controlled["frames"],
          "same-seed rerun reproduced identical observation frames")
    cached_rows = sum(
        v for labels, v in
        rerun["loop"].registry.series("control.forecast_rows")
        if labels.get("source") == "cache")
    fresh_rows = sum(
        v for labels, v in
        rerun["loop"].registry.series("control.forecast_rows")
        if labels.get("source") == "dispatch")
    check(fresh_rows == 0 and cached_rows > 0,
          f"warm rerun forecast entirely from the row cache "
          f"({cached_rows} cached, {fresh_rows} fresh)")

    return dict(a, static=s_trial, controlled=c_trial), part_c_future


def part_b():
    """Actuation over the real TCP PSK wire, through a blackhole."""
    import gc

    from ..core.segment_view import SegmentView
    from ..engine.net import ReconnectPolicy, TcpNetwork
    from ..engine.netfaults import NetFaultPlan
    from ..engine.p2p_agent import P2PAgent
    from ..engine.telemetry import MetricsRegistry
    from ..engine.tracker import Tracker, TrackerEndpoint
    from ..testing.fixtures import wait_for
    from ..testing.seed_process import (InstantCdn, NullBridge,
                                        NullMediaMap)

    print("control-gate B: real-TCP PSK actuation")
    gc.collect()
    registry = MetricsRegistry()
    # the blackhole window opens shortly after the first epoch is
    # published and swallows every socket for a second — the heal
    # machinery must carry the epoch across it
    plan = NetFaultPlan.parse("blackhole@1.5-3.0", seed=11,
                              registry=registry)
    heal = ReconnectPolicy(max_retries=6, backoff_base_s=0.02,
                           backoff_cap_s=0.2, seed=11,
                           idle_probe_s=1.0, circuit_threshold=24,
                           circuit_cooldown_s=0.5)
    network = TcpNetwork(psk=b"control-gate", registry=registry,
                         fault_plan=plan, heal=heal)
    agents = []
    try:
        tracker_endpoint = network.register()
        tracker = Tracker(network.loop, registry=registry)
        TrackerEndpoint(tracker, tracker_endpoint, concurrent=True)

        def make_agent():
            return P2PAgent(
                NullBridge(), "http://cdn.example/master.m3u8",
                NullMediaMap(),
                {"network": network, "clock": network.loop,
                 "cdn_transport": InstantCdn(10_000),
                 "tracker_peer_id": tracker_endpoint.peer_id,
                 "content_id": "control-gate",
                 "announce_interval_ms": 250.0,
                 "metrics_registry": registry},
                SegmentView, "hls", "v2")

        agents.append(make_agent())
        agents.append(make_agent())
        swarm_id = agents[0].swarm_id
        ctrl_ep = network.register()
        actuator = TransportActuator(ctrl_ep, swarm_id,
                                     tracker_peer_id=tracker_endpoint
                                     .peer_id, registry=registry)

        # epoch 1: plain convergence through announce piggyback
        actuator.actuate(1, {"urgent_margin_s": 6.5})
        check(wait_for(lambda: actuator.acked_epoch >= 1, 10.0),
              "SET_KNOBS acked by KNOB_UPDATE (epoch 1)")
        check(wait_for(lambda: all(
            a.policy.urgent_margin_s == 6.5 and
            a.tracker_client.knob_epoch == 1 for a in agents), 10.0),
            "every agent applied epoch 1 via the announce piggyback")

        # stale epoch refused + counted, nothing re-applied
        actuator.actuate(1, {"urgent_margin_s": 0.25})
        check(wait_for(lambda: any(
            v >= 1 for labels, v in
            registry.series("tracker.knob_sets")
            if labels.get("result") == "stale"), 10.0),
            "stale epoch refused and counted "
            "(tracker.knob_sets{result=stale})")
        check(all(a.policy.urgent_margin_s == 6.5 for a in agents),
              "stale epoch did not move any agent's policy")

        # setup traffic on the faulted fabric already auto-armed the
        # plan — force the window epoch to NOW so the blackhole
        # actually overlaps the epoch-2 publish, and publish from
        # INSIDE the window (sends swallowed, idle probes forced)
        plan.rearm()
        time.sleep(1.6)  # clock-ok: real-socket window alignment
        # epoch 2 rides through the blackhole: the controller
        # republishes until acked, healed agents re-announce
        deadline = time.monotonic() + 20.0  # clock-ok: real sockets
        while actuator.acked_epoch < 2 \
                and time.monotonic() < deadline:  # clock-ok: ditto
            actuator.actuate(2, {"urgent_margin_s": 2.0})
            time.sleep(0.25)  # clock-ok: real-socket pacing
        check(actuator.acked_epoch >= 2,
              "epoch 2 publish survived the blackhole window "
              "(republish-until-acked)")
        check(wait_for(lambda: all(
            a.policy.urgent_margin_s == 2.0 and
            a.tracker_client.knob_epoch == 2 for a in agents), 15.0),
            "healed agents converged to epoch 2 (reconnect "
            "re-announce picked up the piggyback)")
        # the blackhole's counted recovery union: swallowed sends
        # surface as spliced frames the MAC integrity check drops,
        # held reads as probe reconnects — either way the defense
        # must have ACTED, not merely survived
        reconnects = sum(v for _l, v in
                         registry.series("net.reconnects"))
        mac_drops = sum(v for _l, v in
                        registry.series("net.mac_drops"))
        check(reconnects + mac_drops >= 1,
              f"the blackhole forced counted recovery actions "
              f"(net.reconnects={reconnects} + "
              f"net.mac_drops={mac_drops})")

        # a LATE joiner converges on its first announce
        agents.append(make_agent())
        check(wait_for(lambda:
                       agents[-1].policy.urgent_margin_s == 2.0
                       and agents[-1].tracker_client.knob_epoch == 2,
                       10.0),
              "late joiner converged to the current epoch on its "
              "first announce")
        applies = sum(v for labels, v in
                      registry.series("control.knob_applies")
                      if labels.get("result") == "applied")
        check(applies == 2 * len(agents[:2]) + 1,
              f"knob applies counted once per (agent, epoch): "
              f"{applies}")
    finally:
        for agent in agents:
            agent.dispose()
        network.close()


def run_part_c(a, device, children, walls):
    """Part C's chain: the reference replay, the kill run and the
    resume, each a ``tools.control`` child on ``a["cache_dir"]``.
    Returns what :func:`part_c` checks."""
    root = os.path.dirname(a["shard"])
    spec_path = os.path.join(root, "control_spec.json")
    with open(spec_path, "w", encoding="utf-8") as fh:
        json.dump({
            "scenario": dataclasses.asdict(a["spec"]),
            "knob_grid": KNOB_GRID,
            "initial_knobs": STATIC_KNOBS,
            "constraint": CONSTRAINT,
            "bands_path": BANDS_PATH,
            "band_set": BAND_SET,
            "swarm_id": a["config"].swarm_id,
        }, fh)

    runs = {}

    def replay(role, tag, *extra):
        out = os.path.join(root, f"{tag}.json")
        t0 = time.perf_counter()
        children[role].go(
            ["--spec", spec_path, "--shard", a["shard"],
             "--actuate-log", os.path.join(root, f"{tag}_acts.jsonl"),
             "--cache-dir", a["cache_dir"], "--out", out,
             "--device", device.type, *extra])
        runs[role] = _child_result(f"c_{role}", children[role], walls, t0)
        return runs[role], out

    (rc, _o, err), ref_out = replay("ref", "ref")
    ref = None
    if rc == 0:
        with open(ref_out, encoding="utf-8") as fh:
            ref = json.load(fh)
    kill_log = os.path.join(root, "kill_acts.jsonl")
    replay("kill", "kill", "--sigkill-at-actuation", "1")
    pre = []
    if os.path.exists(kill_log):
        with open(kill_log, encoding="utf-8") as fh:
            pre = [json.loads(line) for line in fh if line.strip()]
    (rc_res, _o, _e), res_out = replay("resume", "kill", "--resume")
    resumed = None
    if rc_res == 0:
        with open(res_out, encoding="utf-8") as fh:
            resumed = json.load(fh)
    post = []
    if os.path.exists(kill_log):
        with open(kill_log, encoding="utf-8") as fh:
            post = [json.loads(line)["epoch"] for line in fh
                    if line.strip()]
    return {"runs": runs, "ref": ref, "pre": pre, "resumed": resumed,
            "post": post}


def part_c(a, c):
    """SIGKILL mid-tick + resume: identical decisions, no duplicate
    actuations (checked on :func:`run_part_c`'s results)."""
    print("control-gate C: offline replay, SIGKILL + resume")
    rc, _out, err = c["runs"]["ref"]
    check(rc == 0,
          f"reference replay exited 0 (stderr: "
          f"{err.strip()[-200:]})")
    ref = c["ref"] or {"decisions": None}
    check(decision_fingerprint(ref["decisions"])
          == decision_fingerprint(a["loop"].decisions),
          "offline replay re-derived the live loop's decision "
          "sequence exactly")

    rc, _out, _err = c["runs"]["kill"]
    check(rc == -signal.SIGKILL,
          f"kill run died by SIGKILL (rc={rc})")
    pre = c["pre"]
    check([e["epoch"] for e in pre] == [1],
          f"the killed run actuated epoch 1 exactly once before "
          f"dying: {[e['epoch'] for e in pre]}")

    rc, _out, err = c["runs"]["resume"]
    check(rc == 0,
          f"resumed replay exited 0 (stderr: "
          f"{err.strip()[-200:]})")
    resumed = c["resumed"] or {"decisions": None}
    check(decision_fingerprint(resumed["decisions"])
          == decision_fingerprint(ref["decisions"]),
          "resume re-derived the identical decision sequence")
    post = c["post"]
    check(all(y > x for x, y in zip(post, post[1:])),
          f"actuation log epochs strictly monotone: {post}")
    check(len(post) == len(set(post)),
          f"no duplicate actuations across the SIGKILL "
          f"(epochs {post})")
    ref_epochs = [d["epoch"] for d in (ref["decisions"] or [])
                  if d["action"] == "actuate"]
    check(post == ref_epochs,
          f"resumed log holds exactly the reference's actuated "
          f"epochs: {post} == {ref_epochs}")


def part_consumers(a):
    """The satellite consumers hold on this run's artifacts."""
    from .fleet_console import render_frame
    from .trace_export import export_dir

    events = export_dir(os.path.dirname(a["ctrl_shard"]))["traceEvents"]
    ticks = [e for e in events if e.get("ph") == "i"
             and e.get("name") == "control_tick"]
    check(len(ticks) == len(a["loop"].decisions),
          f"Perfetto export renders one control_tick instant per "
          f"tick ({len(ticks)})")
    tracks = {e.get("name") for e in events if e.get("ph") == "C"}
    check("control actuations" in tracks,
          f"cumulative actuations counter track present "
          f"(tracks: {sorted(tracks)[:8]}...)")
    panel = render_frame(trace_dir=os.path.dirname(a["ctrl_shard"]),
                         control=True)
    check("control" in panel and "epoch" in panel,
          f"console --control panel renders (got: {panel[:160]!r})")


def prepare():
    """This gate's children, started now and waiting for their argv."""
    if not _PREPARED:
        _PREPARED.update({role: WaitingTool(tool, _ROOT)
                          for role, tool in _CHILD_TOOLS.items()})
    return _PREPARED


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--static-child", metavar="OUT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--part-b-child", metavar="OUT",
                    help=argparse.SUPPRESS)
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    dev = open_device(ap, args.device)
    if args.static_child:
        return static_child(args.static_child)
    if args.part_b_child:
        return part_b_child(args.part_b_child)

    CHECKS.clear()
    walls, total = {}, {}
    children = prepare()
    t_gate = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="control-gate-") as root:
            t_static = time.perf_counter()
            children["static"].go(["--static-child",
                                   os.path.join(root, "static.json"),
                                   "--device", args.device])
            t_b = time.perf_counter()
            children["part_b"].go(["--part-b-child",
                                   os.path.join(root, "part_b.json"),
                                   "--device", args.device])
            a, part_c_future = part_a(root, dev, children, walls,
                                      t_static)

            rc, out, err = _child_result("b", children["part_b"], walls,
                                         t_b)
            b_checks = None
            if rc == 0:
                with open(os.path.join(root, "part_b.json"),
                          encoding="utf-8") as fh:
                    b_checks = json.load(fh)
            print("control-gate B: real-TCP PSK actuation")
            if b_checks is None:
                check(False, f"part B's child failed (exit {rc}):\n"
                             f"{out[-2000:]}\n{err[-2000:]}")
            for ok, what in b_checks or []:
                check(ok, what)

            c = part_c_future.result()
            for role in ("ref", "kill", "resume"):
                counts = kernels_reported(c["runs"][role][2])
                if counts:   # none from the killed run
                    add_kernels(total, counts[-1])
            part_c(a, c)
            part_consumers(a)
    finally:
        for child in children.values():
            child.stop()
        _PREPARED.clear()
    walls["gate"] = time.perf_counter() - t_gate

    print(f"control-gate walls (s): "
          f"{json.dumps({k: round(v, 3) for k, v in walls.items()})}")
    report_children(total)
    failed = [what for ok, what in CHECKS if not ok]
    print(f"control-gate: {len(CHECKS) - len(failed)}/{len(CHECKS)} "
          f"checks passed")
    if failed:
        for what in failed:
            print(f"control-gate FAILED: {what}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
