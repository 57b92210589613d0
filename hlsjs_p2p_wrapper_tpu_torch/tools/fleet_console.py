"""Live / post-mortem fleet console over claim files + event shards, on
the port: the reference's ``tools/fleet_console.py`` (every panel:
``read_units``, ``host_activity``, ``twin_panel``, ``control_panel``,
``slo_panel``, ``net_panel``, ``render_frame`` and ``main`` with
``--follow``, :77-574) on the port's ``engine/artifact_cache.py``
(``read_jsonl_tolerant``), ``engine/tracer.py`` (``merge_trace``) and
``engine/twinframe.py`` (``ObservationFrame``, ``frame_errors``,
``parse_labels``).  The same claim files, shards and frames render the
same frame, line for line.

``fleet_report()`` (engine/fabric.py) derives a fleet's ground truth
from the claim files once, after the fact; this console makes the
same derivation CONTINUOUS: it tails the fabric directory's claim
files and the flight recorder's per-host event shards
(``tools.sweep --fabric DIR --trace-dir TRACE``) and renders, per
refresh:

- **unit progress** — done / leased / unclaimed counts and the
  grid's completion fraction (claim files alone: a SIGKILL'd host's
  records survive it);
- **lease health** — which host holds which units, seconds of lease
  runway left, and holders already past expiry (steal candidates);
- **per-host activity** (event shards) — rows completed and row
  throughput over the trailing window, retry/backoff and bisection
  counts (``dispatch_faults``), row-cache hit rate
  (``aot_cache_events``), and the age of each host's last event
  (a heartbeat: a silent shard is a dead or wedged host);
- **twin calibration panel** (``--twin FILE``, a twin-frames
  artifact) — per scenario, each frame metric's max relative error
  between the sim and real planes with the worst window's index and
  clock (engine/twinframe.py ``frame_errors``);
- **net panel** (``--net``) — per host, the real-plane transport's
  self-heal counters (``net.reconnects``/``net.send_drops`` by
  reason, MAC drops, circuit-breaker transitions, handshake rejects)
  and selector-loop stalls from the ``--trace`` event stream;
- **control panel** (``--control``) — the last ``control_tick`` mark,
  the knob epoch, the headroom and the ``control.*`` counters
  (engine/controller.py);
- **SLO panel** (``--slo``, from the trace stream's
  ``slo_window``/``slo_alert`` marks, engine/slo.py) — per
  objective: current fast/slow burn rates, error budget remaining,
  alert count, and the last alert's worst shard/cohort attribution.

Every panel degrades to one line on artifacts without its events.
Both sources are append-only and torn-tail tolerant, so tailing a LIVE
fleet mid-write is safe.  One frame prints by default (the post-mortem
read); ``--follow`` refreshes every ``--interval`` seconds until
interrupted or — with ``--max-frames`` — a frame budget runs out.
Pure host-side work: no device, no ``--device`` flag.

Usage::

    python -m hlsjs_p2p_wrapper_tpu_torch.tools.sweep --fabric FAB \\
        --hosts 3 --trace-dir TR &
    python -m hlsjs_p2p_wrapper_tpu_torch.tools.fleet_console \\
        --fabric FAB --trace TR --follow
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..engine.artifact_cache import read_jsonl_tolerant
from ..engine.tracer import merge_trace
from ..engine.twinframe import ObservationFrame, frame_errors, parse_labels

#: the twin panel's headline metrics, in display order (the gate's
#: agreement trio plus the delivery rates)
TWIN_PANEL_METRICS = ("offload", "rebuffer", "present_peers",
                      "p2p_rate_bps", "cdn_rate_bps")

#: trailing window for the rows/s throughput read
RATE_WINDOW_S = 30.0


def read_units(fabric_dir):
    """Per-unit lease/completion state from the claim files (the
    ledger's ``_view`` rule: last claim holds the lease, first done
    wins): ``{unit: {"done", "holder", "gen", "expires_s",
    "claims", "dones"}}``."""
    claims_dir = os.path.join(fabric_dir, "claims")
    units = {}
    names = (sorted(os.listdir(claims_dir))
             if os.path.isdir(claims_dir) else [])
    for name in names:
        if not name.endswith(".jsonl"):
            continue
        try:
            records = list(read_jsonl_tolerant(
                os.path.join(claims_dir, name)))
        except OSError:
            continue  # fault-ok: a claim file vanishing mid-scan is
            # a racing cleanup; the next frame re-reads the directory
        done = next((r for r in records if r.get("kind") == "done"),
                    None)
        lease, expires = None, 0.0
        for r in records:
            if r.get("kind") == "claim":
                lease, expires = r, float(r.get("expires_s", 0.0))
            elif (r.get("kind") == "beat" and lease is not None
                  and r.get("host") == lease.get("host")
                  and r.get("gen") == lease.get("gen")):
                expires = max(expires, float(r.get("expires_s", 0.0)))
        units[name] = {
            "done": done is not None,
            "winner": done.get("host") if done else None,
            "holder": lease.get("host") if lease else None,
            "gen": lease.get("gen") if lease else None,
            "expires_s": expires,
            "claims": sum(1 for r in records
                          if r.get("kind") == "claim"),
            "dones": sum(1 for r in records
                         if r.get("kind") == "done"),
        }
    return units


def host_activity(events, now):
    """Per-host derived activity from a merged event stream:
    rows / rows-per-second (trailing window) / retries / bisections /
    cache hit rate / last-event age."""
    hosts = {}
    for event in events:
        host = hosts.setdefault(event.get("host", "?"), {
            "rows": 0, "recent_rows": [], "retries": 0,
            "bisections": 0, "giveups": 0, "cache_hits": 0,
            "cache_misses": 0, "leases": 0, "last_t": 0.0,
            "tracker": {}})
        host["last_t"] = max(host["last_t"], event.get("t", 0.0))
        kind = event.get("kind")
        if kind == "row":
            host["rows"] += 1
            host["recent_rows"].append(event.get("t", 0.0))
        elif kind == "lease":
            host["leases"] += 1
        elif kind == "counter":
            labels = event.get("labels", "")
            n = int(event.get("n", 1))
            if event.get("name") == "dispatch_faults":
                if "action=retry" in labels:
                    host["retries"] += n
                elif "action=bisect" in labels:
                    host["bisections"] += n
                elif "action=giveup" in labels:
                    host["giveups"] += n
            elif event.get("name") == "aot_cache_events":
                if "layer=row,result=hit" in labels:
                    host["cache_hits"] += n
                elif "layer=row,result=miss" in labels:
                    host["cache_misses"] += n
            elif str(event.get("name", "")).startswith("tracker."):
                # control-plane panel: a host running a
                # tracker with the flight recorder attached to its
                # registry exports every lease decision as counter
                # events — aggregate by family, labels folded
                family = event["name"][len("tracker."):]
                trk = host["tracker"]
                trk[family] = trk.get(family, 0) + n
    for host in hosts.values():
        recent = [t for t in host.pop("recent_rows")
                  if t >= now - RATE_WINDOW_S]
        host["rows_per_s"] = round(len(recent) / RATE_WINDOW_S, 3)
        looked = host["cache_hits"] + host["cache_misses"]
        host["hit_rate"] = (round(host["cache_hits"] / looked, 3)
                            if looked else None)
        host["age_s"] = round(max(now - host["last_t"], 0.0), 1)
    return hosts


def twin_panel(twin_path) -> list:
    """Twin-calibration panel lines from a twin-frames artifact:
    per scenario, each headline metric's max relative error and the
    worst window (engine/twinframe.py ``frame_errors``)."""
    try:
        with open(twin_path, encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError) as exc:
        return [f"twin {twin_path}: unreadable ({exc})"]
    lines = []
    scenarios = doc.get("scenarios", {})
    if not isinstance(scenarios, dict):
        return [f"twin {twin_path}: not a twin-frames artifact"]
    for name in sorted(scenarios):
        planes = scenarios[name]
        # a valid-JSON artifact of the wrong shape (the bands file
        # lives right next to the frames file) degrades to a line,
        # not a traceback killing a --follow console
        try:
            sim = ObservationFrame.from_dict(planes["sim"])
            real = ObservationFrame.from_dict(planes["real"])
            # frame_errors is inside the guard too: frames that
            # parse but carry foreign/mismatched columns raise from
            # tuple.index in there, not just in from_dict
            errors = frame_errors(sim, real)
        except (KeyError, TypeError, ValueError) as exc:
            lines.append(f"twin {name}: not a sim/real frame pair "
                         f"({exc.__class__.__name__}: {exc})")
            continue
        parts = []
        for metric in TWIN_PANEL_METRICS:
            err = errors.get(metric)
            if err is None:
                continue
            parts.append(
                f"{metric} {err['max_rel_err']:.1%} @ "
                f"w{err['worst_rel_window']} "
                f"(t={err['worst_rel_t_s']:g}s)")
        lines.append(f"twin {name}: {sim.n_windows} windows — "
                     + "; ".join(parts))
    if not lines:
        lines.append(f"twin {twin_path}: no scenarios in artifact")
    return lines


def control_panel(events) -> list:
    """Control-plane panel lines from a merged event stream: the last
    ``control_tick`` mark (tick / action / epoch / forecast-vs-
    constraint headroom / staleness against the stream head) plus the
    ``control.*`` counter families (actuations, holds and vetoes by
    reason, forecast-row provenance, republishes).  Degrades to one
    explanatory line on artifacts from runs without a controller —
    never a traceback."""
    ticks = [e for e in events if e.get("kind") == "mark"
             and e.get("name") == "control_tick"]
    counts = {}
    for event in events:
        if event.get("kind") != "counter":
            continue
        name = str(event.get("name", ""))
        if not name.startswith("control."):
            continue
        key = (name[len("control."):], event.get("labels", ""))
        counts[key] = counts.get(key, 0) + int(event.get("n", 1))
    if not ticks and not counts:
        return ["control: no controller events in trace (run "
                "without a controller — nothing to show)"]
    lines = ["control plane:"]
    if ticks:
        last = ticks[-1]
        newest = max(e.get("t", 0.0) for e in events)
        lag = newest - last.get("t", 0.0)
        headroom = last.get("headroom")
        lines.append(
            f"  last tick {last.get('tick')} "
            f"({last.get('action')}) at t={last.get('t'):g}, "
            f"lag {lag:g} behind stream head; "
            f"knob epoch {last.get('epoch')}, headroom "
            + (f"{headroom:+.4f}" if headroom is not None
               else "n/a (warmup)"))
    def total(family):
        return sum(v for (fam, _labels), v in counts.items()
                   if fam == family)
    def by_label(family, key):
        out = {}
        for (fam, labels), v in counts.items():
            if fam == family:
                label = parse_labels(labels).get(key, "?")
                out[label] = out.get(label, 0) + v
        return out
    holds = by_label("holds", "reason")
    vetoes = by_label("vetoes", "reason")
    rows = by_label("forecast_rows", "source")
    lines.append(
        f"  actuations {total('actuations')}, holds "
        + (", ".join(f"{r}={n}" for r, n in sorted(holds.items()))
           or "0")
        + ", vetoes "
        + (", ".join(f"{r}={n}" for r, n in sorted(vetoes.items()))
           or "0"))
    lines.append(
        f"  forecast rows: cache {rows.get('cache', 0)}, dispatch "
        f"{rows.get('dispatch', 0)}; ticks {total('ticks')}, "
        f"republishes {total('republishes')}")
    # HA pair sub-panel: tracker-arbitrated controller
    # lease plus fencing effects.  Pre-HA artifacts carry none of
    # these events, so the panel above renders unchanged for them.
    leases = [e for e in events if e.get("kind") == "lease"
              and e.get("scope") == "ctrl"]
    fenced = by_label("publish_fenced", "role")
    shadows = total("shadow_applies")
    if leases or fenced or shadows:
        if leases:
            last = leases[-1]
            lines.append(
                f"  lease: leader {last.get('leader')} at "
                f"generation {last.get('gen')} "
                f"(ttl {last.get('ttl_ms')} ms, acked knob epoch "
                f"{last.get('knob_epoch')})")
        # a hot standby re-derives the leader's decision prefix, so
        # its last tick trailing the fleet's newest IS the takeover
        # replay debt it would pay on a failover
        newest_tick = max((t.get("tick", 0) for t in ticks),
                          default=0)
        last_by_host = {}
        for t in ticks:
            last_by_host[t.get("host", "?")] = t
        if len(last_by_host) > 1:
            lines.append("  pair: " + ", ".join(
                f"{host} at tick {t.get('tick')} "
                f"(lag {newest_tick - t.get('tick', 0)})"
                for host, t in sorted(last_by_host.items())))
        if fenced or shadows:
            lines.append(
                "  fencing: publishes fenced "
                + (", ".join(f"{role}={n}"
                             for role, n in sorted(fenced.items()))
                   or "0")
                + f", shadow applies {shadows}")
    return lines


def slo_panel(events) -> list:
    """SLO panel lines from a merged event stream: per objective,
    the last ``slo_window`` mark's burn rates and budget remaining,
    the alert count, and the last alert's worst shard/cohort
    attribution (engine/slo.py emits the marks).  Degrades to one
    explanatory line on artifacts from runs without an SLO
    evaluator — the ``--control`` pattern."""
    windows = {}
    alerts = {}
    for event in events:
        if event.get("kind") != "mark":
            continue
        name = event.get("name")
        if name == "slo_window":
            windows[event.get("slo", "?")] = event
        elif name == "slo_alert":
            alerts.setdefault(event.get("slo", "?"),
                              []).append(event)
    if not windows and not alerts:
        return ["slo: no SLO events in trace (run without an SLO "
                "evaluator — nothing to judge)"]
    lines = ["slo objectives:"]
    for slo in sorted(set(windows) | set(alerts)):
        last = windows.get(slo)
        fired = alerts.get(slo, [])
        if last is not None:
            burn_fast = last.get("burn_fast")
            remaining = last.get("budget_remaining")
            lines.append(
                f"  {slo} ({last.get('metric')}/"
                f"{last.get('quantile')}): burn fast "
                + (f"{burn_fast:g}×" if burn_fast is not None
                   else "n/a")
                + f" / slow "
                + (f"{last.get('burn_slow'):g}×"
                   if last.get("burn_slow") is not None else "n/a")
                + f", budget remaining "
                + (f"{remaining:.0%}" if remaining is not None
                   else "n/a (warmup)")
                + f", {len(fired)} alert(s)"
                + ("  ** FIRING **" if last.get("firing") else ""))
        else:
            lines.append(f"  {slo}: {len(fired)} alert(s)")
        if fired:
            worst = fired[-1]
            shard = worst.get("worst_shard") or {}
            cohort = worst.get("worst_cohort") or {}
            lines.append(
                f"    last alert @ w{worst.get('window')} "
                f"(t={worst.get('t_s'):g}s): worst shard "
                f"{shard.get('shard', '-')}, worst cohort "
                f"{cohort.get('cohort', '-')}")
    return lines


def net_panel(events) -> list:
    """Real-plane transport panel from a merged event stream: per
    host, the ``net.*`` self-heal counters (reconnects and send drops
    by reason, MAC drops, circuit-breaker transitions, handshake
    rejects) plus the selector-loop health counters
    (``net.loop.stalls`` — a callback hogging the loop).  Agent packs
    (the reference's tools/c10k_pack.py) attach their registries to
    the flight recorder, so this is the post-mortem / live view of a
    C10K run.
    Degrades to one explanatory line on artifacts from runs without a
    real transport — the ``--control`` pattern."""
    hosts = {}
    for event in events:
        if event.get("kind") != "counter":
            continue
        name = str(event.get("name", ""))
        if not name.startswith("net."):
            continue
        host = hosts.setdefault(event.get("host", "?"), {})
        labels = parse_labels(event.get("labels", ""))
        n = int(event.get("n", 1))
        if name == "net.reconnects":
            key = ("reconnects", labels.get("reason", "?"))
        elif name == "net.send_drops":
            key = ("drops", labels.get("reason", "?"))
        elif name == "net.circuit":
            key = ("circuit", labels.get("state", "?"))
        elif name == "net.mac_drops":
            key = ("mac_drops", None)
        elif name == "net.handshake_rejects":
            key = ("rejects", labels.get("reason", "?"))
        elif name == "net.loop.stalls":
            key = ("loop_stalls", None)
        else:
            key = (name[len("net."):], None)
        host[key] = host.get(key, 0) + n
    if not hosts:
        return ["net: no net.* events in trace (run without a real "
                "transport — nothing to show)"]
    lines = ["net plane:"]

    def fold(host, family):
        pairs = sorted((reason, v) for (fam, reason), v
                       in host.items() if fam == family)
        if not pairs:
            return "0"
        if pairs == [(None, pairs[0][1])]:
            return str(pairs[0][1])
        return ",".join(f"{reason}={v}" for reason, v in pairs)

    for name in sorted(hosts):
        host = hosts[name]
        lines.append(
            f"  {name}: reconnects {fold(host, 'reconnects')}; "
            f"drops {fold(host, 'drops')}; "
            f"mac {fold(host, 'mac_drops')}; "
            f"circuit {fold(host, 'circuit')}; "
            f"rejects {fold(host, 'rejects')}; "
            f"loop stalls {fold(host, 'loop_stalls')}")
    return lines


def render_frame(fabric_dir=None, trace_dir=None, now=None,
                 twin_path=None, control=False, slo=False,
                 net=False) -> str:
    """One console frame as text (the testable surface)."""
    now = time.time() if now is None else now
    lines = []
    if fabric_dir:
        units = read_units(fabric_dir)
        done = sum(1 for u in units.values() if u["done"])
        leased = {}
        for unit in units.values():
            if unit["done"] or unit["holder"] is None:
                continue
            leased.setdefault(unit["holder"], []).append(
                unit["expires_s"] - now)
        total = len(units)
        frac = done / total if total else 0.0
        lines.append(f"fabric {fabric_dir}: {done}/{total} units "
                     f"done ({frac:.0%}), "
                     f"{sum(len(v) for v in leased.values())} "
                     f"leased, "
                     f"{total - done - sum(len(v) for v in leased.values())} "
                     f"unclaimed")
        for host in sorted(leased):
            runways = leased[host]
            lines.append(
                f"  lease {host}: {len(runways)} unit(s), min "
                f"runway {min(runways):+.1f}s"
                + ("  ** EXPIRED — steal candidate **"
                   if min(runways) <= 0 else ""))
        duplicates = sum(max(u["dones"] - 1, 0)
                         for u in units.values())
        takeovers = sum(max(u["claims"] - 1, 0)
                        for u in units.values())
        if takeovers or duplicates:
            lines.append(f"  takeovers {takeovers}, duplicate "
                         f"completions {duplicates}")
    trace_events = merge_trace(trace_dir) if trace_dir else []
    if trace_dir:
        hosts = host_activity(trace_events, now)
        if hosts:
            lines.append(f"trace {trace_dir}: "
                         f"{len(hosts)} host shard(s)")
            header = (f"  {'host':<10} {'rows':>6} {'rows/s':>7} "
                      f"{'retry':>6} {'bisect':>6} {'giveup':>6} "
                      f"{'hit%':>6} {'last evt':>9}")
            lines.append(header)
            for name in sorted(hosts):
                h = hosts[name]
                hit = (f"{h['hit_rate']:.0%}"
                       if h["hit_rate"] is not None else "-")
                lines.append(
                    f"  {name:<10} {h['rows']:>6} "
                    f"{h['rows_per_s']:>7} {h['retries']:>6} "
                    f"{h['bisections']:>6} {h['giveups']:>6} "
                    f"{hit:>6} {h['age_s']:>8.1f}s")
            tracked = {name: h["tracker"]
                       for name, h in hosts.items() if h["tracker"]}
            if tracked:
                lines.append("  tracker control plane:")
                for name in sorted(tracked):
                    t = tracked[name]
                    lines.append(
                        f"    {name}: announces "
                        f"{t.get('announces', 0)}, rejects "
                        f"{t.get('announce_rejects', 0)}, expiries "
                        f"{t.get('lease_expiries', 0)}, reclaims "
                        f"{t.get('lease_reclaims', 0)}, sweeps "
                        f"{t.get('shard_sweeps', 0)}")
        else:
            lines.append(f"trace {trace_dir}: no event shards yet")
    if twin_path:
        lines.extend(twin_panel(twin_path))
    if control:
        lines.extend(control_panel(trace_events))
    if slo:
        lines.extend(slo_panel(trace_events))
    if net:
        lines.extend(net_panel(trace_events))
    if not lines:
        lines.append("nothing to watch (pass --fabric, --trace "
                     "and/or --twin)")
    return "\n".join(lines)


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fabric", metavar="DIR",
                    help="fabric directory (claim files) to tail")
    ap.add_argument("--trace", metavar="DIR",
                    help="flight-recorder trace directory to tail")
    ap.add_argument("--twin", metavar="FILE",
                    help="twin calibration frames artifact "
                         "(the reference's tools/twin_gate.py "
                         "TWIN_FRAMES_local"
                         ".json) — adds the per-metric divergence "
                         "panel")
    ap.add_argument("--control", action="store_true",
                    help="add the live-control-plane panel (last "
                         "control_tick mark, knob epoch, headroom, "
                         "actuation/hold/veto counters) from the "
                         "--trace event stream")
    ap.add_argument("--slo", action="store_true",
                    help="add the SLO panel (per objective: burn "
                         "rates, budget remaining, alert count, "
                         "worst shard/cohort of the last alert) "
                         "from the --trace event stream's "
                         "slo_window/slo_alert marks")
    ap.add_argument("--net", action="store_true",
                    help="add the real-plane transport panel (per "
                         "host: net.* reconnect/drop/MAC/circuit "
                         "counters and selector-loop stalls) from "
                         "the --trace event stream — the C10K agent-"
                         "pack post-mortem view")
    ap.add_argument("--follow", action="store_true",
                    help="refresh continuously (default: one "
                         "post-mortem frame)")
    ap.add_argument("--interval", type=float, default=2.0,
                    metavar="S", help="refresh period under "
                    "--follow (default 2s)")
    ap.add_argument("--max-frames", type=int, default=0, metavar="N",
                    help="stop after N frames under --follow "
                         "(0 = until interrupted; test hook)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if not (args.fabric or args.trace or args.twin):
        ap.error("nothing to watch: pass --fabric DIR, --trace DIR "
                 "and/or --twin FILE")
    frames = 0
    while True:
        print(render_frame(args.fabric, args.trace,
                           twin_path=args.twin,
                           control=args.control, slo=args.slo,
                           net=args.net))
        frames += 1
        if not args.follow or (args.max_frames
                               and frames >= args.max_frames):
            return 0
        print(f"--- refresh in {args.interval:g}s "
              f"(ctrl-c to stop) ---")
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
