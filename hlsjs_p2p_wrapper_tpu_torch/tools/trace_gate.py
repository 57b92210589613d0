"""Trace gate on the port: the flight recorder's event stream is COMPLETE
ground truth, at process granularity.

The reference's ``tools/trace_gate.py`` (``spawn_worker``, ``run_merge``
and ``main``, :81-294) on the port's sweep tool.  A unified event plane
(engine/tracer.py) is only worth reading if nothing escapes it: a retry
that bumped a counter but left no event — or a journaled row with no
finalize event — would make every downstream consumer silently wrong.
This gate runs a 3-worker fleet of the port's sweep tool
(``tools.sweep.main(["--fabric", ..., "--trace-dir", ...])``, what
``python -m hlsjs_p2p_wrapper_tpu_torch.tools.sweep --fabric ...
--trace-dir ...`` runs) on the shipped VOD grid with one injected
SIGKILL and one injected transient burst, then asserts the stream IS
the registries:

1. **fleet** — three workers behind a start barrier (the kernel
   libraries loaded first, ``tools.sweep.fabric_host``, so chaos
   schedules fire deterministically):

   - ``host01`` carries ``kill@1``: SIGKILLed claiming its second unit
     (lease held, nothing flushed voluntarily — only what the per-chunk
     flush discipline already made durable survives);
   - ``host02`` carries ``--inject-faults transient@0:0x2``: its first
     unit's first two dispatch attempts fail and recover under bounded
     backoff — exactly 2 counted retries;
   - ``host00`` is clean; the dead host's unit is stolen on lease
     expiry so the grid completes.

2. **replay == registry**, exactly: for each SURVIVING worker, its
   partial artifact exports the live registry's ``dispatch_faults`` /
   ``fabric_claims`` / ``aot_cache_events`` families and replaying that
   host's event shard (``tracer.replay_counter_families``) must
   reproduce all three families EXACTLY.
3. **journal ↔ finalize**, per host (the killed host included): every
   row key in a host's journal shard maps to EXACTLY ONE
   ``journaled=True`` row event in that host's event shard.
4. **merge completes** (``tools.sweep --fabric --hosts 0``) and
   the burst shows up as exactly 2 transient retries in the replayed
   events and in the exported registry.
5. **the consumers hold**: the port's ``tools.trace_export`` produces
   structurally valid Chrome trace JSON for the run (per-host pids,
   ``X`` span events with durations, ``C`` counter tracks) and the
   port's ``tools.fleet_console`` renders a post-mortem frame.

Every child is a ``testing/tool_child.py`` process started by
:func:`prepare` (torch and the tool imported, no context on the card)
and sent its argv when its turn comes; ``testing/tool_child.py
trace_gate --prepare`` starts them beside its own start.

The gate makes no compile claim.  Its children's ``nvcc`` builds,
CUDA-graph captures and kernel launches (each child's ``# kernels:``
line) are summed and printed (``# children's kernels:``).

Gate-sized swarms by default; ``TRACE_GATE_PEERS``,
``TRACE_GATE_SEGMENTS``, ``TRACE_GATE_WATCH_S``, ``TRACE_GATE_CHUNK``
scale it up, ``TRACE_GATE_LEASE_S`` stretches the lease on slow hosts.

Run: ``python -m hlsjs_p2p_wrapper_tpu_torch.tools.trace_gate [--device
cpu]`` (exit 1 on any violation).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import sys
import tempfile
import time

from . import (WaitingTool, add_device_flag, add_kernels, kernels_reported,
               open_device, report_children)

#: the checkout's root, the children's working directory
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PACKAGE = __spec__.name.rsplit(".", 2)[0]

HOSTS = ("host00", "host01", "host02")
#: injected chaos: host01 dies claiming its SECOND unit; host02's
#: first unit absorbs a 2-transient burst (recovered, 2 retries)
KILL_CHAOS = {"host01": "kill@1"}
FAULT_BURST = {"host02": "transient@0:0x2"}

#: the children :func:`prepare` started, by host or role
_PREPARED: dict = {}


def _sizes_from_env():
    return {
        "peers": int(os.environ.get("TRACE_GATE_PEERS", 48)),
        "segments": int(os.environ.get("TRACE_GATE_SEGMENTS", 12)),
        "watch_s": float(os.environ.get("TRACE_GATE_WATCH_S", 8.0)),
        "chunk": int(os.environ.get("TRACE_GATE_CHUNK", 6)),
        "lease_s": float(os.environ.get("TRACE_GATE_LEASE_S", 2.0)),
    }


def spawn_worker(host, root, sizes, device, child):
    """Send the waiting ``child`` (a ``tools.sweep`` child) host
    ``host``'s worker argv."""
    argv = ["--fabric", os.path.join(root, "fabric"),
            "--host-id", host,
            "--fabric-lease-s", str(sizes["lease_s"]),
            "--fabric-barrier", str(len(HOSTS)),
            "--trace-dir", os.path.join(root, "trace"),
            "--peers", str(sizes["peers"]),
            "--segments", str(sizes["segments"]),
            "--watch-s", str(sizes["watch_s"]),
            "--chunk", str(sizes["chunk"]), "--device", device]
    if KILL_CHAOS.get(host):
        argv.extend(["--fabric-chaos", KILL_CHAOS[host]])
    if FAULT_BURST.get(host):
        argv.extend(["--inject-faults", FAULT_BURST[host]])
    child.go(argv, env={
        "HLSJS_P2P_TORCH_CACHE_DIR": os.path.join(root, "cache")})


def run_merge(root, sizes, device, child, counts):
    """The merge-only sweep (``--fabric DIR --hosts 0``) in ``child``, a
    waiting ``tools.sweep`` child."""
    out = os.path.join(root, "merged.json")
    rc, stdout, err = child.run(
        ["--fabric", os.path.join(root, "fabric"), "--hosts", "0",
         "--peers", str(sizes["peers"]),
         "--segments", str(sizes["segments"]),
         "--watch-s", str(sizes["watch_s"]),
         "--chunk", str(sizes["chunk"]),
         "--json", "--out", out, "--device", device],
        env={"HLSJS_P2P_TORCH_CACHE_DIR": os.path.join(root, "cache")})
    if rc != 0:
        raise SystemExit(f"trace-gate merge failed:\n{stdout}\n{err}")
    for run in kernels_reported(err):
        add_kernels(counts, run)
    with open(out, encoding="utf-8") as fh:
        return json.load(fh)


def prepare():
    """This gate's children, started now and waiting for their argv: the
    three workers and the merge."""
    if not _PREPARED:
        _PREPARED.update(merge=WaitingTool("sweep", _ROOT),
                         **{h: WaitingTool("sweep", _ROOT) for h in HOSTS})
    return _PREPARED


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    open_device(ap, args.device)
    counts = {}
    sizes = _sizes_from_env()
    root = tempfile.mkdtemp(prefix="trace-gate-")
    problems = []
    children = prepare()
    try:
        # 1. the fleet: one SIGKILL, one transient burst
        t0 = time.perf_counter()
        walls = {}
        for host in HOSTS:
            spawn_worker(host, root, sizes, args.device, children[host])
        rcs, logs = {}, {}
        for host in HOSTS:
            rcs[host], out, err = children[host].wait()
            logs[host] = out + err
        if rcs["host01"] != -signal.SIGKILL:
            problems.append(
                f"kill worker exited {rcs['host01']}, expected "
                f"SIGKILL ({-signal.SIGKILL})")
        for host in ("host00", "host02"):
            if rcs[host] != 0:
                problems.append(f"{host} exited {rcs[host]} — "
                                f"survivors must complete the grid")
        for host in HOSTS:
            text = logs[host]
            if "Traceback" in text:
                problems.append(f"{host} log carries an unhandled "
                                f"exception:\n{text[-2000:]}")
            for run in kernels_reported(text):
                add_kernels(counts, run)

        walls["fleet"] = time.perf_counter() - t0
        # 2. merge must complete (the steal finished the grid)
        merged = run_merge(root, sizes, args.device, children["merge"],
                           counts)
        walls["merge"] = time.perf_counter() - t0 - walls["fleet"]
        rows = merged["rows"]
        failed = [r for r in rows if r.get("failed")]
        if len(rows) != 48:  # the shipped VOD grid
            problems.append(f"merged artifact has {len(rows)} rows, "
                            f"expected the 48-point VOD grid")
        if failed:
            problems.append(f"{len(failed)} failed rows in a "
                            f"recoverable chaos schedule")

        # the analysis reads only files: the workers are done
        from .. import sweep_grid
        from ..engine.artifact_cache import journal_path, read_jsonl_tolerant
        from ..engine.tracer import (REPLAYED_FAMILIES, finalize_keys,
                                     read_shard, replay_counter_families)
        cache_dir = os.path.join(root, "cache")

        shards = {}
        for host in HOSTS:
            path = os.path.join(root, "trace", f"{host}.jsonl")
            if not os.path.exists(path):
                problems.append(f"{host} wrote no event shard")
                continue
            meta, events = read_shard(path)
            shards[host] = (meta, events)
        run_ids = {meta.get("run_id")
                   for meta, _ in shards.values() if meta}
        if len(run_ids) > 1:
            problems.append(f"hosts disagree on the run id: "
                            f"{sorted(run_ids)} — the trace context "
                            f"must be fleet-wide")

        # 3. replay == registry, exactly, per surviving worker
        exports = {}
        for host in ("host00", "host02"):
            partial_path = os.path.join(root, "fabric", "partial",
                                        f"{host}.json")
            if not os.path.exists(partial_path) or host not in shards:
                problems.append(f"{host}: missing partial or shard")
                continue
            with open(partial_path, encoding="utf-8") as fh:
                partial = json.load(fh)
            exported = exports[host] = partial.get("counters")
            if exported is None:
                problems.append(f"{host}: partial artifact exports "
                                f"no counter families")
                continue
            replayed = replay_counter_families(shards[host][1])
            for family in REPLAYED_FAMILIES:
                if replayed.get(family) != exported.get(family):
                    problems.append(
                        f"{host}: replayed {family} diverged from "
                        f"the exported registry —\n  replayed: "
                        f"{replayed.get(family)}\n  exported: "
                        f"{exported.get(family)}")

        # 4. the burst is visible and exact: 2 transient retries on
        # host02, in the events AND the registry export
        if "host02" in shards:
            replayed = replay_counter_families(shards["host02"][1])
            retries = replayed["dispatch_faults"].get(
                "action=retry,reason=transient", 0)
            if retries != 2:
                problems.append(
                    f"host02 replayed {retries} transient retries, "
                    f"expected exactly 2 (the injected burst)")
            exported = exports.get("host02") or {}
            counted = exported.get("dispatch_faults", {}).get(
                "action=retry,reason=transient", 0)
            if counted != 2:
                problems.append(
                    f"host02's registry counted {counted} transient "
                    f"retries, expected exactly 2 (the injected burst)")

        # 5. journal <-> finalize, per host, killed host included
        grid = sweep_grid.vod_grid()
        meta = sweep_grid.journal_meta(
            grid, peers=sizes["peers"], segments=sizes["segments"],
            watch_s=sizes["watch_s"], live=False, seed=0,
            record_every=0)
        for host in HOSTS:
            jpath = journal_path(cache_dir, meta, host)
            if not os.path.exists(jpath):
                problems.append(f"{host}: no journal shard "
                                f"({jpath})")
                continue
            journaled = [r["key"]
                         for r in read_jsonl_tolerant(jpath)
                         if r.get("kind") == "row"]
            if host not in shards:
                continue
            finals = finalize_keys(shards[host][1])
            missing = [k for k in journaled if finals.get(k, 0) != 1]
            if missing:
                problems.append(
                    f"{host}: {len(missing)}/{len(journaled)} "
                    f"journaled rows lack exactly one finalize "
                    f"event (first: {missing[0][:16]}…)")
            extra = [k for k in finals if k not in set(journaled)]
            if extra:
                problems.append(
                    f"{host}: {len(extra)} finalize events for "
                    f"rows the journal never recorded")

        # 6. the consumers hold on this run's artifacts
        from .fleet_console import render_frame
        from .fleet_gate import unit_dispatch_s
        from .trace_export import export_dir
        trace = export_dir(os.path.join(root, "trace"))
        events = trace["traceEvents"]
        pids = {e["pid"] for e in events if e.get("ph") != "M"}
        if len(pids) != len(shards):
            problems.append(f"exporter produced {len(pids)} host "
                            f"pids for {len(shards)} shards")
        if not any(e.get("ph") == "X" and e.get("dur", 0) >= 0
                   for e in events):
            problems.append("exporter produced no X span events")
        if not any(e.get("ph") == "C" and e.get("name") == "retries"
                   for e in events):
            problems.append("exporter produced no retry counter "
                            "track despite the injected burst")
        frame = render_frame(os.path.join(root, "fabric"),
                             os.path.join(root, "trace"))
        if "host02" not in frame or "units done" not in frame:
            problems.append(f"console frame incomplete:\n{frame}")

        walls["analysis"] = (time.perf_counter() - t0 - walls["fleet"]
                             - walls["merge"])
        n_events = sum(len(ev) for _m, ev in shards.values())
        print(f"trace-gate: {len(shards)} shards, {n_events} events"
              f" (1 SIGKILL, 1 transient burst) — replay == "
              f"registry, journal == finalize; children built "
              f"{counts.get('builds', 0)}, captured "
              f"{counts.get('captures', 0)}, launched "
              f"{sum(counts.get('launches', {}).values())} kernels"
              f"; walls (s) {json.dumps({k: round(v, 3) for k, v in walls.items()})}"
              f"; each unit's dispatch, beat to beat (s) "
              f"{json.dumps(unit_dispatch_s(os.path.join(root, 'fabric')))}"
              f" -> {'ok' if not problems else 'FAIL'}")
    finally:
        for child in children.values():
            child.stop()
        _PREPARED.clear()
        shutil.rmtree(root, ignore_errors=True)
    report_children(counts)
    for problem in problems:
        print(f"trace-gate: {problem}", file=sys.stderr)
    print(f"# trace-gate: {'PASS' if not problems else 'FAIL'} "
          f"(VOD grid, 3 workers, {sizes['peers']} peers, chunk "
          f"{sizes['chunk']}, lease {sizes['lease_s']}s, {args.device})",
          file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
