"""Fleet gate on the port: the multi-host fabric survives host death, at
process granularity.

The reference's ``tools/fleet_gate.py`` (``child``, ``run_role``,
``spawn_worker`` and ``main``, :86-297) on the port's sweep tool.  The
fabric's claims (engine/fabric.py, ``tools.sweep --fabric``) are only
worth shipping if an actual SIGKILL'd worker and an actual lease-expired
straggler leave the merged artifact bit-identical to a single-host
fault-free run, with every steal / expiry / duplicate observed.  This
gate runs the shipped VOD grid and asserts exactly that:

1. **reference** — one fault-free single-host child
   (``tools.sweep.run_grid_batched(raw=True)``, own cache dir): the
   ``float.hex`` bit-exactness reference.  It runs beside the fleet (it
   shares nothing with it but the card).
2. **fleet** — three worker processes of the port's sweep tool
   (``tools.sweep.main(["--fabric", ..., "--fabric-barrier", "3"])``,
   what ``python -m hlsjs_p2p_wrapper_tpu_torch.tools.sweep --fabric ...``
   runs) against one fabric dir + one (separate) cache dir, synchronized
   at a start barrier with the kernel libraries loaded first
   (``tools.sweep.fabric_host``), so the chaos schedule fires
   deterministically:

   - ``host01`` carries ``kill@1``: SIGKILLed the moment it claims its
     SECOND unit — it dies holding a fresh lease, with one finalized
     unit that never reached a partial artifact (the row-cache backfill
     path);
   - ``host02`` carries ``stall@1:3×lease``: stalls mid-lease on its
     second unit, gets that unit STOLEN while still alive, finishes
     anyway, and loses the finalize race — the counted-duplicate path;
   - ``host00`` is the survivor that steals both expired claims.

3. **merge** — a child merges the partial artifacts (plus the
   row-cache backfill) and reports the claim-file ground truth
   (``fleet_report``).

Every child is a ``testing/tool_child.py`` process started by
:func:`prepare` (torch and the tool imported, no context on the card)
and sent its argv when its turn comes, so that no child's start-up
stands in the gate's critical path; ``testing/tool_child.py
fleet_gate --prepare`` starts them beside its own start.

Asserted: the kill child died by SIGKILL and wrote no partial; the
survivors exited 0 with zero tracebacks in any worker log; the merged
rows are BIT-IDENTICAL (float.hex) to the reference; exactly 2 steals,
2 lease expiries, and 1 duplicate happened and were counted BOTH in the
surviving workers' ``fabric_claims`` registries and in the claim files;
no unit carries more completions than claim generations; and the killed
host's finalized rows were recovered from the row cache.

The gate makes no compile claim.  Its children's ``nvcc`` builds,
CUDA-graph captures and kernel launches (each child's ``# kernels:``
line) are summed and printed (``# children's kernels:``).

Gate-sized swarms by default; ``FLEET_GATE_PEERS``,
``FLEET_GATE_SEGMENTS``, ``FLEET_GATE_WATCH_S``, ``FLEET_GATE_CHUNK``
scale it.  The chunk is PINNED (the unit manifest must be identical
across children) and the lease short (``FLEET_GATE_LEASE_S``, default
2 s) so the steal path runs in seconds on a CPU; on the card at
1,048,576 peers give it at least 6 s.

Run: ``python -m hlsjs_p2p_wrapper_tpu_torch.tools.fleet_gate [--device
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

from . import (WaitingTool, add_device_flag, add_kernels, json_records,
               kernels_reported, launch_counts, open_device,
               report_children, report_kernels)

#: the checkout's root, the children's working directory
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PACKAGE = __spec__.name.rsplit(".", 2)[0]

HOSTS = ("host00", "host01", "host02")
#: per-host chaos: the kill and the stall both fire on that host's
#: SECOND successful claim (ordinal 1) — mid-grid, lease held
CHAOS = {"host01": "kill@1", "host02": None}  # host02 set in main()

#: the children :func:`prepare` started, by role or host
_PREPARED: dict = {}


def _sizes_from_env():
    return {
        "peers": int(os.environ.get("FLEET_GATE_PEERS", 48)),
        "segments": int(os.environ.get("FLEET_GATE_SEGMENTS", 12)),
        "watch_s": float(os.environ.get("FLEET_GATE_WATCH_S", 8.0)),
        "chunk": int(os.environ.get("FLEET_GATE_CHUNK", 6)),
        "lease_s": float(os.environ.get("FLEET_GATE_LEASE_S", 2.0)),
    }


def _hex_rows(rows):
    return [[None, None] if row.get("failed")
            else [row["offload"].hex(), row["rebuffer"].hex()]
            for row in rows]


def child(args):
    """The simulator-running roles, each in a process of its own (the
    parent reads worker logs and claim files without a device)."""
    from .. import sweep_grid
    from ..engine.artifact_cache import CompileCounter, WarmStart
    from ..engine.fabric import fleet_report
    from . import sweep as sweep_tool
    probe = CompileCounter().attach()
    launches = launch_counts()
    grid = sweep_grid.vod_grid()
    ws = WarmStart(cache_dir=args.cache_dir)
    common = dict(peers=args.peers, segments=args.segments,
                  watch_s=args.watch_s, live=False, seed=0,
                  device=args.device)
    if args.role == "ref":
        rows, _info = sweep_tool.run_grid_batched(
            grid, chunk=args.chunk, warm_start=ws, raw=True, **common)
        record = {"rows": _hex_rows(rows)}
    else:
        # role == "merge": overlay the partials + row-cache backfill and
        # report the claim-file ground truth
        rows, info = sweep_tool.merge_fabric(
            grid, fabric_dir=args.fabric_dir, warm_start=ws,
            chunk=args.chunk, raw=True, **common)
        record = {
            "rows": _hex_rows(rows),
            "fabric": info["fabric"],
            "failures": info["failures"],
            "detail": fleet_report(args.fabric_dir)["units_detail"],
        }
    probe.detach()
    report_kernels(probe, launches)
    print(json.dumps(record))
    return 0


def _role_argv(role, cache_dir, fabric_dir, sizes, device):
    return ["--child", "--role", role, "--cache-dir", cache_dir,
            "--fabric-dir", fabric_dir,
            "--peers", str(sizes["peers"]),
            "--segments", str(sizes["segments"]),
            "--watch-s", str(sizes["watch_s"]),
            "--chunk", str(sizes["chunk"]), "--device", device]


def end_role(role, child, counts):
    """The role child's record (the JSON line before its report); its
    kernel counts go into ``counts``."""
    rc, out, err = child.wait()
    records = json_records(out)
    if rc != 0 or len(records) < 3:
        raise SystemExit(f"fleet-gate {role} child failed:\n{out}\n{err}")
    for run in kernels_reported(err):
        add_kernels(counts, run)
    return records[-2]


def run_role(role, cache_dir, fabric_dir, sizes, device, child, counts):
    """Run ``role`` in ``child``, a waiting child."""
    child.go(_role_argv(role, cache_dir, fabric_dir, sizes, device))
    return end_role(role, child, counts)


def spawn_worker(host, cache_dir, fabric_dir, sizes, device, child):
    """Send the waiting ``child`` (a ``tools.sweep`` child) host
    ``host``'s worker argv."""
    argv = ["--fabric", fabric_dir, "--host-id", host,
            "--fabric-lease-s", str(sizes["lease_s"]),
            "--fabric-barrier", str(len(HOSTS)),
            "--peers", str(sizes["peers"]),
            "--segments", str(sizes["segments"]),
            "--watch-s", str(sizes["watch_s"]),
            "--chunk", str(sizes["chunk"]), "--device", device]
    if CHAOS.get(host):
        argv.extend(["--fabric-chaos", CHAOS[host]])
    child.go(argv, env={"HLSJS_P2P_TORCH_CACHE_DIR": cache_dir})


def unit_dispatch_s(fabric_dir) -> dict:
    """Each claim's dispatch, beat to beat (``run_units`` beats just
    before and just after it), from the claim files' ``expires_s``:
    ``{"<host> <unit>": seconds}``, to set beside the lease."""
    from ..engine.artifact_cache import read_jsonl_tolerant
    claims = os.path.join(fabric_dir, "claims")
    out = {}
    for name in sorted(os.listdir(claims)) if os.path.isdir(claims) else []:
        beats = {}
        for r in read_jsonl_tolerant(os.path.join(claims, name)):
            if r.get("kind") == "beat":
                beats.setdefault((r.get("host"), r.get("gen")),
                                 []).append(float(r["expires_s"]))
        for (host, _gen), ts in sorted(beats.items()):
            if len(ts) >= 2:
                out[f"{host} {name.split('.')[0]}"] = round(ts[-1] - ts[0], 3)
    return out


def prepare():
    """This gate's children, started now and waiting for their argv: the
    reference and merge roles and the three workers."""
    if not _PREPARED:
        _PREPARED.update(ref=WaitingTool("fleet_gate", _ROOT),
                         merge=WaitingTool("fleet_gate", _ROOT),
                         **{h: WaitingTool("sweep", _ROOT) for h in HOSTS})
    return _PREPARED


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--role", default="ref", choices=("ref", "merge"))
    ap.add_argument("--cache-dir")
    ap.add_argument("--fabric-dir")
    sizes_default = _sizes_from_env()
    ap.add_argument("--peers", type=int,
                    default=sizes_default["peers"])
    ap.add_argument("--segments", type=int,
                    default=sizes_default["segments"])
    ap.add_argument("--watch-s", type=float,
                    default=sizes_default["watch_s"])
    ap.add_argument("--chunk", type=int,
                    default=sizes_default["chunk"])
    add_device_flag(ap)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    open_device(ap, args.device)
    if args.child:
        return child(args)

    counts = {}
    sizes = _sizes_from_env()
    stall_s = 3.0 * sizes["lease_s"]
    CHAOS["host02"] = f"stall@1:{stall_s}"
    root = tempfile.mkdtemp(prefix="fleet-gate-")
    cache_ref = os.path.join(root, "cache-ref")
    cache_fleet = os.path.join(root, "cache-fleet")
    fabric_dir = os.path.join(root, "fabric")
    problems = []
    children = prepare()
    try:
        # 1. the single-host fault-free bit-exactness reference, beside
        # 2. the fleet: 3 workers, one killed, one stalled into lease
        # expiry
        t0 = time.perf_counter()
        walls = {}
        children["ref"].go(_role_argv("ref", cache_ref, fabric_dir, sizes,
                                      args.device))
        for host in HOSTS:
            spawn_worker(host, cache_fleet, fabric_dir, sizes, args.device,
                         children[host])
        rcs, logs = {}, {}
        for host in HOSTS:
            rcs[host], out, err = children[host].wait()
            logs[host] = out + err
        walls["fleet"] = time.perf_counter() - t0
        ref = end_role("ref", children["ref"], counts)
        walls["reference"] = time.perf_counter() - t0
        if rcs["host01"] != -signal.SIGKILL:
            problems.append(
                f"kill worker exited {rcs['host01']}, expected "
                f"SIGKILL ({-signal.SIGKILL}) — the chaos schedule "
                f"did not fire (did it claim a second unit?)")
        for host in ("host00", "host02"):
            if rcs[host] != 0:
                problems.append(f"{host} exited {rcs[host]} — "
                                f"survivors must complete the grid")
        for host in HOSTS:
            log_text = logs[host]
            if "Traceback" in log_text:
                problems.append(f"{host} log carries an unhandled "
                                f"exception:\n{log_text[-2000:]}")
            for run in kernels_reported(log_text):
                add_kernels(counts, run)
        killed_partial = os.path.join(fabric_dir, "partial",
                                      "host01.json")
        if os.path.exists(killed_partial):
            problems.append("the SIGKILLed worker wrote a partial "
                            "artifact — it did not die mid-grid")

        # 3. merge + the claim-file ground truth
        t_merge = time.perf_counter()
        merged = run_role("merge", cache_fleet, fabric_dir, sizes,
                          args.device, children["merge"], counts)
        walls["merge"] = time.perf_counter() - t_merge

        if merged["rows"] != ref["rows"]:
            diverged = sum(1 for a, b in zip(merged["rows"],
                                             ref["rows"]) if a != b)
            problems.append(
                f"merged rows diverged from the single-host "
                f"fault-free reference at {diverged}/"
                f"{len(ref['rows'])} points — steals must be "
                f"bit-exact by construction")
        if merged["failures"]:
            problems.append(f"structured failures in a fault-free "
                            f"dispatch schedule: {merged['failures']}")

        report = merged["fabric"]["report"]
        for key, want in (("steals", 2), ("expires", 2),
                          ("duplicates", 1)):
            if report[key] != want:
                problems.append(
                    f"claim files record {key}={report[key]}, "
                    f"expected {want} (one steal per dead/stalled "
                    f"host, one duplicate from the stalled "
                    f"survivor)")
        if report["finished"] != report["units"]:
            problems.append(f"{report['units'] - report['finished']} "
                            f"units never finished")
        # the registries must have COUNTED what the claim files
        # record (the kill victim's counters died with it; steals /
        # expiries / duplicates are all survivor-side events)
        counted = {"steal": 0, "expire": 0, "duplicate": 0}
        for host in merged["fabric"]["hosts"]:
            for action in counted:
                counted[action] += host["claims"].get(action, 0)
        for action, want in (("steal", 2), ("expire", 2),
                             ("duplicate", 1)):
            if counted[action] != want:
                problems.append(
                    f"fabric_claims{{action={action}}} summed to "
                    f"{counted[action]} across surviving workers, "
                    f"expected {want} — every recovery must be "
                    f"counted, not just survived")
        # no row dispatched more than once per surviving claim: a
        # unit's completions can never exceed its claim generations
        for unit in merged["detail"]:
            if len(unit["done"]) > len(unit["gens"]):
                problems.append(
                    f"{unit['unit']}: {len(unit['done'])} "
                    f"completions vs {len(unit['gens'])} claim "
                    f"generations")
        if merged["fabric"]["recovered_rows"] <= 0:
            problems.append(
                "no rows were recovered from the row cache — the "
                "killed host's finalized unit should only exist "
                "there (its partial was never written)")
        dispatch = unit_dispatch_s(fabric_dir)
        hosts_reported = {h["host"]
                          for h in merged["fabric"]["hosts"]}
        if hosts_reported != {"host00", "host02"}:
            problems.append(f"expected partials from the two "
                            f"survivors, got {sorted(hosts_reported)}")
        print(f"fleet-gate: fleet of {len(HOSTS)} "
              f"(1 SIGKILLed, 1 lease-expired) finished "
              f"{report['finished']}/{report['units']} units with "
              f"{report['steals']} steals, {report['expires']} "
              f"expiries, {report['duplicates']} duplicate, "
              f"{merged['fabric']['recovered_rows']} rows recovered "
              f"from the row cache; children built "
              f"{counts.get('builds', 0)}, captured "
              f"{counts.get('captures', 0)}, launched "
              f"{sum(counts.get('launches', {}).values())} kernels"
              f"; walls (s) {json.dumps({k: round(v, 3) for k, v in walls.items()})}"
              f"; each unit's dispatch, beat to beat (s) "
              f"{json.dumps(dispatch)}"
              f" -> {'ok' if not problems else 'FAIL'}")
    finally:
        for waiting in children.values():
            waiting.stop()
        _PREPARED.clear()
        shutil.rmtree(root, ignore_errors=True)
    report_children(counts)
    for problem in problems:
        print(f"fleet-gate: {problem}", file=sys.stderr)
    print(f"# fleet-gate: {'PASS' if not problems else 'FAIL'} "
          f"(VOD grid, 3 workers, {sizes['peers']} peers, chunk "
          f"{sizes['chunk']}, lease {sizes['lease_s']}s, {args.device})",
          file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
