"""Chrome-trace / Perfetto exporter for flight-recorder shards, on the
port: the reference's ``tools/trace_export.py`` (``export_trace``,
``export_twin_frames``, ``export_dir`` and ``main``, :82-371) on the
port's ``engine/tracer.py`` (``read_shard``, ``shard_paths``),
``engine/twinframe.py`` (``parse_labels``) and
``engine/artifact_cache.py`` (``atomic_write_text``).  The same shards
and frames give the same trace, key for key.

Converts a trace directory of per-host event shards
(engine/tracer.py ``FlightRecorder``; ``tools.sweep --trace-dir``)
into Chrome trace-event JSON openable directly in ``ui.perfetto.dev``
or ``chrome://tracing``:

- one PROCESS per host (``pid`` = host ordinal, named via
  ``process_name`` metadata), so a fleet renders as parallel tracks;
- the dispatch pipeline as complete (``ph="X"``) span events on the
  ``dispatch`` thread — build / dispatch / readback per chunk, with
  the trace context (group / chunk / attempt / unit) in ``args``;
- faults and recovery as instant events on the same thread (every
  ``dispatch_faults`` counter bump: retries, bisections, give-ups),
  plus lease protocol steps (claim / steal / beat / done /
  duplicate) on the ``lease`` thread;
- counter TRACKS (``ph="C"``) per host: cumulative retries,
  row-cache hits/misses, and rows completed, plus cumulative
  ``twin_cdn_bytes`` / ``twin_p2p_bytes`` tracks when a shard
  carries the swarm provenance events (engine/twinframe.py);
- with ``--twin-frames TWIN_FRAMES.json`` (a twin-frames artifact:
  per scenario a ``sim`` and a ``real`` frame), PAIRED twin
  calibration tracks: per scenario, one counter track per frame
  metric carrying BOTH planes' window values as two series (``sim``
  / ``real``).  The quantile frame columns
  (``rebuffer_ms_p50/p95/p99``, engine/digest.py) each get their OWN
  track;
- SLO events (engine/slo.py) on their own row and tracks:
  ``slo_alert`` marks as instants on the ``slo`` thread (worst
  shard/cohort attribution in ``args``), ``slo_window`` marks as
  per-objective burn-rate (fast+slow series) and budget-remaining
  counter tracks.

Timestamps are microseconds relative to the earliest event across
all shards; span events use their recorded start stamp + measured
duration, so overlap is visible rather than inferred.

Usage::

    python -m hlsjs_p2p_wrapper_tpu_torch.tools.sweep --trace-dir TRACE/ ...
    python -m hlsjs_p2p_wrapper_tpu_torch.tools.trace_export TRACE/ \\
        --out trace.json
    # then open trace.json in ui.perfetto.dev

Pure host-side work (no device, no ``--device`` flag): reads shards
torn-tail-tolerantly (``read_jsonl_tolerant``), so exporting a live
run's directory mid-write is safe.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..engine.artifact_cache import atomic_write_text
from ..engine.tracer import read_shard, shard_paths
from ..engine.twinframe import parse_labels

#: thread ids within each host's process (named via thread_name
#: metadata): spans + fault instants on DISPATCH, lease steps on
#: LEASE, control-tick marks on CONTROL, SLO alert instants on SLO
#: — their own Perfetto row, so a chaos window, the forecast
#: dispatch spans, the knob change, and the burn alert line up
#: visually on one timeline; counter tracks attach to the process,
#: not a thread
TID_DISPATCH = 1
TID_LEASE = 2
TID_CONTROL = 3
TID_SLO = 4


def _micros(t, t0) -> float:
    return round((t - t0) * 1e6, 3)


def _span_event(event, pid, t0) -> dict:
    args = dict(event.get("ctx", {}))
    for key in ("group", "chunk"):
        if key in event:
            args[key] = event[key]
    return {"ph": "X", "pid": pid, "tid": TID_DISPATCH,
            "name": event.get("name", "span"),
            "cat": "dispatch",
            "ts": _micros(event.get("t_start", event["t"]), t0),
            "dur": round(event.get("dur_s", 0.0) * 1e6, 3),
            "args": args}


def _counter_instant(event, pid, t0) -> dict:
    """A ``dispatch_faults`` bump as an instant marker on the
    dispatch thread: ``fault:transient|retry`` at the exact moment
    recovery acted, context attached."""
    return {"ph": "i", "s": "t", "pid": pid, "tid": TID_DISPATCH,
            "name": f"fault:{event.get('labels', '')}",
            "cat": "faults",
            "ts": _micros(event["t"], t0),
            "args": dict(event.get("ctx", {}))}


def _lease_instant(event, pid, t0) -> dict:
    args = {k: event[k] for k in ("unit", "gen", "rows", "prev_host",
                                  "expires_s") if k in event}
    return {"ph": "i", "s": "t", "pid": pid, "tid": TID_LEASE,
            "name": f"lease:{event.get('action', '?')}",
            "cat": "fabric",
            "ts": _micros(event["t"], t0), "args": args}


def export_trace(events, host_meta=None) -> dict:
    """The Chrome trace-event object for a merged event stream.

    ``host_meta`` optionally maps host id → its shard's meta record
    (run id surfacing in ``otherData``)."""
    hosts = sorted({e.get("host", "?") for e in events})
    pids = {host: i + 1 for i, host in enumerate(hosts)}
    t0 = min((e.get("t_start", e.get("t", 0.0)) for e in events),
             default=0.0)
    out = []
    for host in hosts:
        pid = pids[host]
        out.append({"ph": "M", "name": "process_name", "pid": pid,
                    "tid": 0, "args": {"name": f"host {host}"}})
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": TID_DISPATCH,
                    "args": {"name": "dispatch"}})
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": TID_LEASE, "args": {"name": "lease"}})
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": TID_CONTROL,
                    "args": {"name": "control"}})
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": TID_SLO, "args": {"name": "slo"}})
    # cumulative per-host counter tracks
    counts = {host: {"retries": 0, "cache_hits": 0, "cache_misses": 0,
                     "rows": 0, "twin_cdn_bytes": 0,
                     "twin_p2p_bytes": 0, "actuations": 0}
              for host in hosts}
    for event in events:
        host = event.get("host", "?")
        pid = pids[host]
        kind = event.get("kind")
        if kind == "span":
            out.append(_span_event(event, pid, t0))
        elif kind == "mark" and event.get("name") == "control_tick":
            # one instant per control tick on the CONTROL row, plus
            # the cumulative actuations track stepping exactly where
            # a knob change landed
            out.append({
                "ph": "i", "s": "t", "pid": pid, "tid": TID_CONTROL,
                "name": "control_tick", "cat": "control",
                "ts": _micros(event["t"], t0),
                "args": {k: event.get(k) for k in
                         ("tick", "action", "epoch", "headroom",
                          "t_s")}})
            if event.get("action") == "actuate":
                counts[host]["actuations"] += 1
            out.append({"ph": "C", "pid": pid,
                        "name": "control actuations",
                        "ts": _micros(event["t"], t0),
                        "args": {"actuations":
                                 counts[host]["actuations"]}})
        elif kind == "mark" and event.get("name") == "slo_window":
            # per-objective burn-rate + budget counter tracks (the
            # SLO layer's slo_window marks, engine/slo.py): the
            # budget draining and both burn windows as lines
            slo = event.get("slo", "?")
            args = {}
            if event.get("burn_fast") is not None:
                args["fast"] = event["burn_fast"]
                args["slow"] = event.get("burn_slow")
            if args:
                out.append({"ph": "C", "pid": pid,
                            "name": f"slo burn {slo}",
                            "ts": _micros(event["t"], t0),
                            "args": args})
            if event.get("budget_remaining") is not None:
                out.append({"ph": "C", "pid": pid,
                            "name": f"slo budget {slo}",
                            "ts": _micros(event["t"], t0),
                            "args": {"remaining":
                                     event["budget_remaining"]}})
        elif kind == "mark" and event.get("name") == "slo_alert":
            # the alert instant on its own SLO row, attribution in
            # args (worst shard/cohort, burn rates)
            out.append({
                "ph": "i", "s": "t", "pid": pid, "tid": TID_SLO,
                "name": f"slo:{event.get('slo', '?')}",
                "cat": "slo", "ts": _micros(event["t"], t0),
                "args": {k: event.get(k) for k in
                         ("metric", "quantile", "window",
                          "burn_fast", "burn_slow", "worst_shard",
                          "worst_cohort")}})
        elif kind == "lease":
            out.append(_lease_instant(event, pid, t0))
        elif kind == "row":
            counts[host]["rows"] += 1
            out.append({"ph": "C", "pid": pid, "name": "rows_done",
                        "ts": _micros(event["t"], t0),
                        "args": {"rows": counts[host]["rows"]}})
        elif kind == "counter":
            name = event.get("name")
            labels = event.get("labels", "")
            if name == "dispatch_faults":
                out.append(_counter_instant(event, pid, t0))
                if "action=retry" in labels:
                    counts[host]["retries"] += int(event.get("n", 1))
                    out.append({"ph": "C", "pid": pid,
                                "name": "retries",
                                "ts": _micros(event["t"], t0),
                                "args": {"retries":
                                         counts[host]["retries"]}})
            elif name == "aot_cache_events":
                bucket = ("cache_hits" if "result=hit" in labels
                          else "cache_misses"
                          if "result=miss" in labels else None)
                if bucket:
                    counts[host][bucket] += int(event.get("n", 1))
                    out.append({"ph": "C", "pid": pid,
                                "name": bucket,
                                "ts": _micros(event["t"], t0),
                                "args": {bucket:
                                         counts[host][bucket]}})
            elif name == "twin.fetch_bytes":
                # swarm data-plane provenance (engine/twinframe.py):
                # cumulative delivered bytes by source, one track per
                # host — the offload ramp as a picture
                # the canonical label inverse, not a substring test:
                # peer ids are arbitrary strings and may contain a
                # literal "src=..." that would mis-bucket the event
                src = parse_labels(labels).get("src")
                bucket = ("twin_cdn_bytes" if src == "cdn"
                          else "twin_p2p_bytes"
                          if src == "p2p" else None)
                if bucket:
                    counts[host][bucket] += int(event.get("n", 0))
                    out.append({"ph": "C", "pid": pid,
                                "name": bucket,
                                "ts": _micros(event["t"], t0),
                                "args": {bucket:
                                         counts[host][bucket]}})
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {
                "source": "hlsjs_p2p_wrapper_tpu flight recorder",
                "hosts": hosts,
                **({"runs": host_meta} if host_meta else {})}}


def export_twin_frames(doc: dict) -> list:
    """Chrome trace events for a twin-frames artifact
    (the reference's ``tools/twin_gate.py`` ``TWIN_FRAMES_local.json``,
    or the port's ``testing/reference_control/twin_frames.json``): one
    process per scenario, one counter track per frame metric, each track
    carrying BOTH planes' per-window values as two series (``sim`` /
    ``real``) — the paired-lines view of a calibration window.
    Timestamps are the frames' own window clocks (simulated
    seconds → trace microseconds)."""
    out = []
    scenarios = sorted(doc.get("scenarios", {}).items())
    for sc_i, (name, planes) in enumerate(scenarios):
        pid = 1000 + sc_i
        out.append({"ph": "M", "name": "process_name", "pid": pid,
                    "tid": 0,
                    "args": {"name": f"twin {name} (sim vs real)"}})
        if (not isinstance(planes, dict) or "sim" not in planes
                or "real" not in planes):
            # the bands artifact (TWIN_r10.json) lives right next to
            # the frames artifact and also has a "scenarios" key —
            # name the mix-up instead of dying on a KeyError
            raise ValueError(
                f"scenario {name!r} is not a sim/real frame pair — "
                f"pass the twin-frames artifact "
                f"(TWIN_FRAMES_local.json), not the bands file")
        sim = planes["sim"]
        real = planes["real"]
        t_col = sim["columns"].index("t_s")
        n = min(len(sim["samples"]), len(real["samples"]))
        for metric in sim["columns"]:
            if metric == "t_s":
                continue
            col = sim["columns"].index(metric)
            rcol = real["columns"].index(metric)
            for w in range(n):
                out.append({
                    "ph": "C", "pid": pid,
                    "name": f"twin:{name}:{metric}",
                    "ts": round(sim["samples"][w][t_col] * 1e6, 3),
                    "args": {"sim": sim["samples"][w][col],
                             "real": real["samples"][w][rcol]}})
    return out


def export_dir(trace_dir: str) -> dict:
    """Merge + export one trace directory — one read per shard
    (events and metas collected in the same pass, then merged in
    ``merge_trace``'s (clock, host, seq) order)."""
    metas = {}
    events = []
    for path in shard_paths(trace_dir):
        try:
            meta, shard_events = read_shard(path)
        except OSError:
            continue
        if meta:
            metas[meta.get("host", os.path.basename(path))] = \
                meta.get("run_id")
        events.extend(shard_events)
    events.sort(key=lambda e: (e.get("t", 0.0), str(e.get("host")),
                               e.get("seq", 0)))
    return export_trace(events, host_meta=metas)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace_dir", metavar="DIR", nargs="?",
                    help="flight-recorder trace directory "
                         "(per-host *.jsonl event shards)")
    ap.add_argument("--twin-frames", metavar="FILE",
                    help="twin calibration frames artifact "
                         "(the reference's tools/twin_gate.py "
                         "TWIN_FRAMES_local.json)"
                         " — adds paired sim/real counter tracks")
    ap.add_argument("--out", metavar="FILE",
                    help="output path (default: DIR/trace.json, or "
                         "twin_trace.json next to --twin-frames)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.trace_dir and not args.twin_frames:
        ap.error("nothing to export: pass DIR and/or --twin-frames")
    if args.trace_dir:
        trace = export_dir(args.trace_dir)
        out_path = args.out or os.path.join(args.trace_dir,
                                            "trace.json")
    else:
        trace = {"traceEvents": [], "displayTimeUnit": "ms",
                 "otherData": {"source": "hlsjs_p2p_wrapper_tpu "
                                         "twin frames",
                               "hosts": []}}
        out_path = args.out or os.path.join(
            os.path.dirname(os.path.abspath(args.twin_frames)),
            "twin_trace.json")
    if args.twin_frames:
        with open(args.twin_frames, encoding="utf-8") as fh:
            try:
                trace["traceEvents"].extend(
                    export_twin_frames(json.load(fh)))
            except ValueError as exc:
                print(f"trace_export: {args.twin_frames}: {exc}",
                      file=sys.stderr)
                return 1
    n = len(trace["traceEvents"])
    if not n:
        sources = [s for s in (args.trace_dir, args.twin_frames) if s]
        print(f"trace_export: no events in {', '.join(sources)}",
              file=sys.stderr)
        return 1
    atomic_write_text(out_path, json.dumps(trace) + "\n")
    print(f"# wrote {n} trace events for "
          f"{len(trace['otherData']['hosts'])} host(s) to {out_path} "
          f"— open in ui.perfetto.dev", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
