"""Twin calibration gate on the port: the port's simulator and its
real-protocol swarm describe the SAME system, within committed, measured
error bars.

The reference's ``tools/twin_gate.py`` (``gate_scenarios``,
``default_sizes``, ``measure`` and ``main``, :94-330) on the port's
``testing/twin.py``: the real plane is the port's copy of the
full-protocol agent swarm (``engine/mesh.py``, ``engine/p2p_agent.py``,
``engine/tracker.py``, ``testing/swarm.py``), the sim plane is the port's
simulator on the gate's device.  Both are compared through ONE
calibration frame (``engine/twinframe.py``): the same seeded scenario
(audience, staggered joins + a join wave, uplinks, CDN rate, watch
horizon) runs through both planes and every agreement claim is checked
against the committed tolerance-band artifact ``TWIN_r10.json`` (the
reference's measurement; this gate never rewrites it).  What this gate
proves, at process granularity:

1. **event plane == registry plane, exactly** — observation frames
   reconstructed from the flight-recorder shard ALONE equal the frames
   sampled live from the registries, for the clean AND the chaos
   scenario;
2. **twin agreement within the committed bands** — per-window
   bounded-relative-error AND distributional (KS) agreement on offload,
   rebuffer, join convergence (presence/joins), the delivery rates and
   the stall-quantile tail columns, for a clean scenario and a chaos
   scenario (loss + latency windows via the shared ``NetFaultPlan``
   grammar on the real wire; the simulator deliberately does not model
   them — the chaos bands ARE the measured fidelity envelope);
3. **determinism** — a same-seed rerun of the real plane reproduces the
   frames exactly (here in another process than the first run);
4. **divergence triage localizes** — a deliberately injected sim
   fidelity bug (the wave cohort's joins shifted in the sim only) is
   flagged at the RIGHT metric (the membership columns) and the RIGHT
   window (the wave window), with the real plane named as the side that
   moved — and the unperturbed comparison stays clean;
5. **the consumers hold** — the port's ``tools.trace_export
   --twin-frames`` renders paired sim/real counter tracks and
   ``tools.fleet_console --twin`` renders the divergence panel from the
   frames this gate writes.

The port writes no file of the reference: the frames go to
``TWIN_FRAMES_torch_local.json`` (not ``TWIN_FRAMES_local.json``), and
``--write-bands`` writes new bands to ``TWIN_torch_local.json`` (never
``TWIN_r10.json``); both sit at the checkout's root and are listed in
``.gitignore``.

The real planes are host Python and launch nothing; they run in three
``testing/tool_child.py`` processes that :func:`prepare` starts waiting
(``testing/tool_child.py twin_gate --prepare`` starts them beside its
own start), side by side with the sim planes, which run in the gate's
process on ``--device`` (the card by default; without one the gate
exits 2 before any work unless given ``--device cpu``).  The gate prints
its stages' walls and ends with ``# children's kernels: {...}`` (its
children build, capture and launch nothing).

Gate-sized by default; ``TWIN_GATE_SEED`` / ``TWIN_GATE_PEERS`` /
``TWIN_GATE_WAVE`` / ``TWIN_GATE_WATCH_S`` / ``TWIN_GATE_WINDOW_S``
scale it (off-default sizes skip the committed-band comparison — bands
are calibrated at the committed shape).  On the card a twin audience is
at most 33 peers (``testing/twin.py``).

Run: ``python -m hlsjs_p2p_wrapper_tpu_torch.tools.twin_gate [--device
cpu]`` (exit 1 on any violation); ``--write-bands`` re-measures both
scenarios and writes head-roomed bands to ``TWIN_torch_local.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

from . import (WaitingTool, add_device_flag, add_kernels, child_report,
               open_device, report_children)
from ..engine.artifact_cache import atomic_write_text
from ..engine.twinframe import (ObservationFrame, calibrate_bands,
                                compare_frames, frame_errors)
from ..testing.control_fixture import scenario_from_dict
from ..testing.twin import (TwinRunResult, TwinScenario, run_real_plane,
                            run_sim_plane)

#: the checkout's root: the committed bands, the frames written, the
#: children's working directory
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

BANDS_PATH = os.path.join(_ROOT, "TWIN_r10.json")
FRAMES_OUT = os.path.join(_ROOT, "TWIN_FRAMES_torch_local.json")
#: where ``--write-bands`` writes (the committed bands stay the
#: reference's measurement)
BANDS_OUT = os.path.join(_ROOT, "TWIN_torch_local.json")

#: the chaos schedule (shared NetFaultPlan grammar, seconds on the
#: scenario clock): a loss band through the wave and a latency spike
#: late in the steady phase — both inside the watch horizon
CHAOS_SPECS = "loss@40-70,latency@90-110"

#: the injected sim-fidelity bug: the wave cohort's joins displaced
#: by two windows in the SIM ONLY (a scenario-mapping error)
PERTURB_SHIFT_WINDOWS = 2

#: metrics the gate REQUIRES bands for (the agreement trio + rates +
#: the stall-quantile tail columns); a band artifact missing one of
#: these is a gate failure, not a silently-skipped check
REQUIRED_METRICS = ("offload", "rebuffer", "present_peers", "joins",
                    "cdn_rate_bps", "p2p_rate_bps", "stalled_peers",
                    "rebuffer_ms_p50", "rebuffer_ms_p95",
                    "rebuffer_ms_p99")

#: the real-plane runs, each in a child of its own: the two scenarios
#: and the same-seed rerun of the clean one
REAL_RUNS = ("clean", "chaos", "det")
#: the children :func:`prepare` started, by run
_PREPARED: dict = {}


def gate_scenarios():
    """The (clean, chaos) scenario pair, env-scalable."""
    base = TwinScenario(
        seed=int(os.environ.get("TWIN_GATE_SEED", 0)),
        n_peers=int(os.environ.get("TWIN_GATE_PEERS", 8)),
        wave_peers=int(os.environ.get("TWIN_GATE_WAVE", 4)),
        watch_s=float(os.environ.get("TWIN_GATE_WATCH_S", 160.0)),
        window_s=float(os.environ.get("TWIN_GATE_WINDOW_S", 8.0)))
    chaos = dataclasses.replace(
        base, fault_specs=CHAOS_SPECS,
        fault_kwargs={"loss_rate": 0.15, "latency_ms": 120.0})
    return base, chaos


def default_sizes() -> bool:
    """True when the env didn't rescale the gate — the committed
    bands only claim the committed shape."""
    return all(os.environ.get(k) is None
               for k in ("TWIN_GATE_SEED", "TWIN_GATE_PEERS",
                         "TWIN_GATE_WAVE", "TWIN_GATE_WATCH_S",
                         "TWIN_GATE_WINDOW_S"))


def measure(scenario, trace_dir, device=None):
    """One scenario through both planes: (sim frame, real result)."""
    real = run_real_plane(scenario, trace_dir=trace_dir)
    sim = run_sim_plane(scenario, device=device)
    return sim, real


def real_child(scenario_json: str, trace_dir: str, out: str) -> int:
    """Child body: one real-plane run, its frames, ratios and fault
    counts written to ``out`` as JSON (floats round-trip exactly)."""
    real = run_real_plane(scenario_from_dict(json.loads(scenario_json)),
                          trace_dir=trace_dir)
    atomic_write_text(out, json.dumps({
        "registry_frames": real.registry_frames.as_dict(),
        "event_frames": (real.event_frames.as_dict()
                         if real.event_frames is not None else None),
        "shard_path": real.shard_path, "offload": real.offload,
        "rebuffer": real.rebuffer,
        "transport_faults": real.transport_faults}))
    return 0


def _read_real(out: str) -> TwinRunResult:
    with open(out, encoding="utf-8") as fh:
        d = json.load(fh)
    return TwinRunResult(
        registry_frames=ObservationFrame.from_dict(d["registry_frames"]),
        event_frames=(ObservationFrame.from_dict(d["event_frames"])
                      if d["event_frames"] is not None else None),
        shard_path=d["shard_path"], offload=d["offload"],
        rebuffer=d["rebuffer"], transport_faults=d["transport_faults"])


def prepare():
    """The three real-plane children, started now and waiting for their
    argv."""
    if not _PREPARED:
        _PREPARED.update({run: WaitingTool("twin_gate", _ROOT)
                          for run in REAL_RUNS})
    return _PREPARED


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write-bands", action="store_true",
                    help="re-measure both scenarios and write "
                         "calibrated tolerance bands to "
                         "TWIN_torch_local.json (the committed "
                         "TWIN_r10.json stays the reference's)")
    ap.add_argument("--real-child", nargs=3, help=argparse.SUPPRESS,
                    metavar=("SCENARIO_JSON", "TRACE_DIR", "OUT"))
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    dev = open_device(ap, args.device)
    if args.real_child:
        return real_child(*args.real_child)

    problems = []
    results = {}
    walls = {}
    total = {"builds": 0, "captures": 0, "launches": {}}
    clean, chaos = gate_scenarios()
    scenarios = {"clean": clean, "chaos": chaos, "det": clean}
    children = prepare()
    try:
        with tempfile.TemporaryDirectory(prefix="twin-gate-") as root:
            t_go = {}
            for run in REAL_RUNS:
                t_go[run] = time.perf_counter()
                children[run].go(["--real-child",
                                  json.dumps(dataclasses.asdict(
                                      scenarios[run])),
                                  os.path.join(root, run),
                                  os.path.join(root, f"{run}.json"),
                                  "--device", args.device])
            sims = {}
            for name in ("clean", "chaos"):
                t0 = time.perf_counter()
                sims[name] = run_sim_plane(scenarios[name], device=dev)
                walls[f"sim_{name}"] = time.perf_counter() - t0
            reals = {}
            for run in REAL_RUNS:
                rc, out, err = children[run].wait()
                report = child_report(out)
                walls[f"real_{run}"] = report.get(
                    "wall_s", time.perf_counter() - t_go[run])
                if rc != 0:
                    raise SystemExit(f"twin-gate: real-plane child "
                                     f"{run} failed:\n{out}\n{err}")
                add_kernels(total, report)
                reals[run] = _read_real(os.path.join(root, f"{run}.json"))
        for name, scenario in (("clean", clean), ("chaos", chaos)):
            sim, real = sims[name], reals[name]
            results[name] = (sim, real)
            # 1. the event stream alone IS the observation plane
            if real.event_frames != real.registry_frames:
                diff = next(
                    (w for w, (a, b) in enumerate(zip(
                        real.event_frames.samples,
                        real.registry_frames.samples)) if a != b),
                    min(real.event_frames.n_windows,
                        real.registry_frames.n_windows))
                problems.append(
                    f"{name}: event-reconstructed frames diverge "
                    f"from registry-derived frames (first at window "
                    f"{diff}) — the provenance event plane is "
                    f"incomplete")
            if real.registry_frames.n_windows != scenario.n_windows:
                problems.append(
                    f"{name}: sampler closed "
                    f"{real.registry_frames.n_windows} windows, "
                    f"expected {scenario.n_windows}")

        # 3. determinism: same seed, same frames
        if reals["det"].registry_frames != \
                results["clean"][1].registry_frames:
            problems.append("same-seed real-plane rerun produced "
                            "different frames — the twin scenario "
                            "is not deterministic")
    finally:
        for child in children.values():
            child.stop()
        _PREPARED.clear()

    # write the frames artifact (uncommitted, the _local pattern) —
    # the consumers' input and the debugging view of any failure
    frames_doc = {
        "scenarios": {
            name: {"sim": sim.as_dict(),
                   "real": real.registry_frames.as_dict(),
                   "errors": frame_errors(sim, real.registry_frames),
                   "real_offload": round(real.offload, 4),
                   "real_rebuffer": round(real.rebuffer, 5)}
            for name, (sim, real) in results.items()}}
    atomic_write_text(FRAMES_OUT,
                      json.dumps(frames_doc, indent=1) + "\n")

    if args.write_bands:
        # never calibrate off a broken measurement: an exactness or
        # determinism failure above means the frames are not ground
        # truth
        if problems:
            for problem in problems:
                print(f"twin-gate: {problem}", file=sys.stderr)
            print("# twin-gate: refusing --write-bands — fix the "
                  "failures above first", file=sys.stderr)
            return 1
        artifact = {
            "meta": {
                "what": "twin calibration tolerance bands: measured "
                        "sim-vs-real per-window error envelopes with "
                        "headroom (python -m "
                        "hlsjs_p2p_wrapper_tpu_torch.tools.twin_gate "
                        "--write-bands)",
                "scenario": {
                    "peers": clean.n_peers, "wave": clean.wave_peers,
                    "wave_at_s": clean.wave_at_s,
                    "watch_s": clean.watch_s,
                    "window_s": clean.window_s,
                    "uplink_bps": clean.uplink_bps,
                    "cdn_bps": clean.cdn_bps,
                    "chaos_specs": CHAOS_SPECS, "seed": clean.seed},
            },
            "scenarios": {
                name: {
                    "measured": frame_errors(
                        sim, real.registry_frames),
                    "bands": calibrate_bands(
                        sim, real.registry_frames),
                }
                for name, (sim, real) in results.items()}}
        atomic_write_text(BANDS_OUT,
                          json.dumps(artifact, indent=1) + "\n")
        print(f"# twin-gate: wrote calibrated bands to {BANDS_OUT}",
              file=sys.stderr)
        return 0

    # 2. agreement within the committed bands
    if not os.path.exists(BANDS_PATH):
        problems.append(f"missing committed band artifact "
                        f"{BANDS_PATH}")
    elif not default_sizes():
        print("# twin-gate: non-default sizes — committed bands "
              "skipped (calibrated at the committed shape)",
              file=sys.stderr)
    else:
        with open(BANDS_PATH, encoding="utf-8") as fh:
            artifact = json.load(fh)
        for name, (sim, real) in results.items():
            bands = artifact["scenarios"][name]["bands"]
            missing = [m for m in REQUIRED_METRICS
                       if m not in bands]
            if missing:
                problems.append(f"{name}: band artifact lacks "
                                f"required metrics {missing}")
                continue
            findings = compare_frames(sim, real.registry_frames,
                                      bands)
            for finding in findings:
                problems.append(f"{name}: {json.dumps(finding)}")

        # 4. the injected sim-fidelity bug is localized
        shift = PERTURB_SHIFT_WINDOWS * clean.window_s
        t0 = time.perf_counter()
        sim_bug = run_sim_plane(clean, wave_shift_s=shift, device=dev)
        walls["sim_perturbed"] = time.perf_counter() - t0
        real_clean = results["clean"][1].registry_frames
        bands = artifact["scenarios"]["clean"]["bands"]
        findings = compare_frames(sim_bug, real_clean, bands)
        wave_window = int(clean.wave_at_s // clean.window_s)
        joins_hits = [f for f in findings
                      if f["metric"] == "joins"
                      and f["reason"] == "band_divergence"]
        presence_hits = [f for f in findings
                         if f["metric"] == "present_peers"
                         and f["reason"] == "band_divergence"]
        if not findings:
            problems.append("perturbed sim raised NO findings — the "
                            "detectors cannot see a 2-window join "
                            "displacement")
        if not joins_hits or joins_hits[0]["first_window"] != \
                wave_window:
            problems.append(
                f"perturbation not localized to joins@window "
                f"{wave_window}: {joins_hits or findings}")
        elif joins_hits[0]["moved_first"] != "real":
            problems.append(
                f"mover misattributed: sim dropped the wave, so the "
                f"REAL plane moved first at the wave window — got "
                f"{joins_hits[0]['moved_first']}")
        if not presence_hits or presence_hits[0]["first_window"] != \
                wave_window:
            problems.append(
                f"presence divergence not anchored at the wave "
                f"window {wave_window}: {presence_hits}")
        earliest = min((f.get("first_window", 10**9)
                        for f in findings), default=10**9)
        localized = {f["metric"] for f in findings
                     if f.get("first_window") == earliest}
        # stalled_peers rides along legitimately: the displaced wave
        # cohort stalls on arrival, so its stall burst moves with it
        if not localized <= {"joins", "present_peers", "leaves",
                             "stalled_peers"}:
            problems.append(
                f"earliest divergence (window {earliest}) blames "
                f"{sorted(localized)} — the membership columns must "
                f"lead for a membership bug")
        if earliest != wave_window:
            problems.append(
                f"earliest divergence at window {earliest}, but the "
                f"injected bug lives at the wave window "
                f"{wave_window}")

    # 5. the consumers hold on this run's artifact
    from .fleet_console import render_frame
    from .trace_export import export_twin_frames
    t0 = time.perf_counter()
    twin_events = export_twin_frames(frames_doc)
    pids = {e["pid"] for e in twin_events if e.get("ph") == "C"}
    if len(pids) != len(results):
        problems.append(f"twin exporter produced {len(pids)} "
                        f"scenario tracks for {len(results)} "
                        f"scenarios")
    if not any(e.get("ph") == "C"
               and set(e.get("args", {})) == {"sim", "real"}
               for e in twin_events):
        problems.append("twin exporter produced no paired sim/real "
                        "counter samples")
    panel = render_frame(twin_path=FRAMES_OUT)
    if "twin clean" not in panel or "offload" not in panel:
        problems.append(f"console twin panel incomplete:\n{panel}")
    walls["consumers"] = time.perf_counter() - t0

    for name, (sim, real) in results.items():
        errs = frame_errors(sim, real.registry_frames)
        print(f"twin-gate {name}: {sim.n_windows} windows, real "
              f"offload {real.offload:.3f} / rebuffer "
              f"{real.rebuffer:.4f}; worst offload err "
              f"{errs['offload']['max_abs_err']:.4f} @ "
              f"w{errs['offload']['worst_window']}")
    print(f"twin-gate walls (s): "
          f"{json.dumps({k: round(v, 3) for k, v in walls.items()})}")
    report_children(total)
    for problem in problems:
        print(f"twin-gate: {problem}", file=sys.stderr)
    print(f"# twin-gate: {'PASS' if not problems else 'FAIL'} "
          f"(clean + chaos, {clean.total_peers} peers, "
          f"{clean.n_windows} windows of {clean.window_s:g}s; "
          f"event==registry, bands committed in TWIN_r10.json; "
          f"{args.device})", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
