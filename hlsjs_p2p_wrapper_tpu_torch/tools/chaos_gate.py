"""Chaos gate on the port: the dispatch survives the faults hosts throw.

The reference's ``tools/chaos_gate.py`` on the port's sweep tool.  It
runs the shipped VOD grid (``tools/sweep.py``'s ``run_grid_batched``)
in child processes against one throwaway cache root (the cold run
first, then the oom and transient runs beside the kill and resume
chain) and asserts:

1. **cold**: fault-free, row cache off: the bit-exactness reference
   (``float.hex`` of the full-precision rows), and the kernel libraries
   built where they were missing;
2. **oom**: injected out-of-memory faults, one of them on an already
   bisected half (recursive bisection): rows bit-identical to the
   reference, 0 ``nvcc`` builds, no failed point, every bisection
   counted in ``dispatch_faults{reason="oom",action="bisect"}``;
3. **transient**: a transient and a timeout burst, recovered within
   the retry budget: the same rows, 0 builds, every retry counted;
4. **kill**: a SIGKILL injected mid-grid: the process dies hard,
   leaving the crash-safe journal with the completed rows;
5. **resume**: the journal replayed against the row cache: 0 builds,
   none of the journaled rows dispatched again (row hits = journal
   length), the rest completed, the reference reproduced bit-exactly,
   the journal finalized.

Builds and captures are counted by ``CompileCounter``.  On the CPU no
run captures a graph; on the card a run that dispatches captures its
own graphs (PyTorch keeps none across processes), so captures are
reported there and held to 0 only where nothing dispatches.

Gate-sized swarms by default; ``CHAOS_GATE_PEERS``,
``CHAOS_GATE_SEGMENTS``, ``CHAOS_GATE_WATCH_S`` and ``CHAOS_GATE_CHUNK``
scale it.  The chunk is pinned, as the warm-start gate pins it.

Run: ``python -m hlsjs_p2p_wrapper_tpu_torch.tools.chaos_gate
[--device cpu]`` (exit 1 on any violation).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

from . import add_device_flag, open_device

#: the checkout's root, the children's working directory
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: injected fault schedules per gate mode (``engine/faults.py``
#: ``FaultPlan.parse`` syntax).  ``oom@0:2x2`` fires on chunk 2's first
#: dispatch and on its first bisected half: recursive bisection.
FAULT_SPECS = {
    "oom": "oom@0:1,oom@0:2x2",
    "transient": "transient@0:0x2,timeout@0:3",
    "kill": "kill@0:3",
}
#: expected dispatch_faults counters per mode (every recovery counted)
EXPECTED_FAULTS = {
    "oom": {"oom|bisect": 3},
    "transient": {"transient|retry": 2, "timeout|retry": 1},
}


def child(args):
    """One gate run in a fresh interpreter: the probe attached before
    the kernels are touched, then the sweep tool's engine under the
    mode's fault plan."""
    from ..engine.artifact_cache import (CompileCounter, SweepJournal,
                                         WarmStart, journal_path)
    from ..engine.faults import FaultPlan, FaultPolicy
    probe = CompileCounter().attach()
    ws = WarmStart(cache_dir=args.cache_dir,
                   row_cache=not args.no_row_cache)
    from .. import sweep_grid
    from . import sweep
    grid = sweep_grid.vod_grid()
    spec = FAULT_SPECS.get(args.mode)
    faults = FaultPolicy(plan=FaultPlan.parse(spec) if spec else None,
                         registry=ws.registry,
                         backoff_base_s=0.001)  # the gate asserts
    # counts, not wall time
    journal = None
    preloaded = 0
    if not args.no_row_cache:
        meta = sweep_grid.journal_meta(
            grid, peers=args.peers, segments=args.segments,
            watch_s=args.watch_s, live=False, seed=0, record_every=0)
        journal = SweepJournal(journal_path(args.cache_dir, meta),
                               meta, resume=args.resume)
        preloaded = len(journal.completed)
    rows, info = sweep.run_grid_batched(
        grid, peers=args.peers, segments=args.segments,
        watch_s=args.watch_s, live=False, seed=0, chunk=args.chunk,
        warm_start=ws, faults=faults, journal=journal, raw=True,
        device=args.device)
    failed = [row for row in rows if row.get("failed")]
    if journal is not None and not failed:
        journal.finalize()
    print(json.dumps({
        "mode": args.mode,
        "points": len(rows),
        "builds": probe.builds,
        "captures": probe.captures,
        "dispatched": len(rows) - info["row_hits"],
        "row_hits": info["row_hits"],
        "failed_points": len(failed),
        "failures": info["failures"],
        "faults": faults.fault_counts(),
        "journal_preloaded": preloaded,
        "rows": [[None, None] if row.get("failed")
                 else [row["offload"].hex(), row["rebuffer"].hex()]
                 for row in rows],
    }))
    return 0


def run_child(mode, cache_dir, sizes, device, *, no_row_cache=False,
              resume=False, expect_kill=False):
    cmd = [sys.executable, "-m", __spec__.name, "--child",
           "--mode", mode, "--cache-dir", cache_dir,
           "--peers", str(sizes["peers"]),
           "--segments", str(sizes["segments"]),
           "--watch-s", str(sizes["watch_s"]),
           "--chunk", str(sizes["chunk"]), "--device", device]
    if no_row_cache:
        cmd.append("--no-row-cache")
    if resume:
        cmd.append("--resume")
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          cwd=_ROOT)
    if expect_kill:
        if proc.returncode != -signal.SIGKILL:
            raise SystemExit(
                f"chaos-gate: kill child exited {proc.returncode}, "
                f"expected SIGKILL ({-signal.SIGKILL}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        return None
    if proc.returncode != 0:
        raise SystemExit(f"chaos-gate child failed ({mode}):\n"
                         f"{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.splitlines()[-1])


def check_recovered(mode, report, cold, problems):
    """The recovered run's contract: bit-identical rows, no build, no
    failed point, every recovery counted, and no capture where nothing
    dispatched."""
    if report["builds"] != 0:
        problems.append(f"{mode}: started {report['builds']} nvcc "
                        f"builds under recovery — expected 0 (the "
                        f"kernel libraries are cached on disk)")
    if report["dispatched"] == 0 and report["captures"] != 0:
        problems.append(f"{mode}: captured {report['captures']} graphs "
                        f"with nothing dispatched — expected 0")
    if report["failed_points"] != 0:
        problems.append(f"{mode}: {report['failed_points']} points "
                        f"failed ({report['failures']}) — the injected "
                        f"schedule is within budget, all must recover")
    if report["rows"] != cold["rows"]:
        diverged = sum(1 for a, b in zip(report["rows"], cold["rows"])
                       if a != b)
        problems.append(f"{mode}: recovered rows diverged from the "
                        f"fault-free reference at {diverged}/"
                        f"{len(cold['rows'])} points — recovery must be "
                        f"bit-exact")
    for key, want in EXPECTED_FAULTS.get(mode, {}).items():
        got = report["faults"].get(key, 0)
        if got != want:
            problems.append(f"{mode}: dispatch_faults[{key}] == {got}, "
                            f"expected {want} — every recovery must be "
                            f"counted")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--mode", default="cold",
                    choices=("cold", "oom", "transient", "kill",
                             "resume"))
    ap.add_argument("--cache-dir")
    ap.add_argument("--no-row-cache", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--peers", type=int, default=int(
        os.environ.get("CHAOS_GATE_PEERS", 48)))
    ap.add_argument("--segments", type=int, default=int(
        os.environ.get("CHAOS_GATE_SEGMENTS", 12)))
    ap.add_argument("--watch-s", type=float, default=float(
        os.environ.get("CHAOS_GATE_WATCH_S", 8.0)))
    ap.add_argument("--chunk", type=int, default=int(
        os.environ.get("CHAOS_GATE_CHUNK", 8)))
    add_device_flag(ap)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    open_device(ap, args.device)

    if args.child:
        return child(args)

    sizes = {"peers": args.peers, "segments": args.segments,
             "watch_s": args.watch_s, "chunk": args.chunk}
    cache_dir = args.cache_dir or tempfile.mkdtemp(prefix="chaos-gate-")
    problems = []
    try:
        # 1. the fault-free reference (row cache off so the faulted runs
        # below dispatch)
        cold = run_child("cold", cache_dir, sizes, args.device,
                         no_row_cache=True)

        # 2-5 side by side, once the cold run has built what was
        # missing: recovery under injected OOM (bisection), under a
        # transient / timeout burst (retry with backoff), and the
        # preemption chain: SIGKILL mid-grid with the journal and the
        # row cache armed, then the crash-safe resume (the journal
        # replayed against the row cache, no recompute of completed rows)
        def preempt_and_resume():
            run_child("kill", cache_dir, sizes, args.device,
                      expect_kill=True)
            return run_child("resume", cache_dir, sizes, args.device,
                             resume=True)

        with ThreadPoolExecutor(3) as pool:
            oom = pool.submit(run_child, "oom", cache_dir, sizes,
                              args.device, no_row_cache=True)
            transient = pool.submit(run_child, "transient", cache_dir,
                                    sizes, args.device, no_row_cache=True)
            resume = pool.submit(preempt_and_resume)
            oom, transient, resume = (oom.result(), transient.result(),
                                      resume.result())
        check_recovered("oom", oom, cold, problems)
        check_recovered("transient", transient, cold, problems)
        check_recovered("resume", resume, cold, problems)
        if resume["journal_preloaded"] == 0:
            problems.append("resume: the killed run journaled no rows — "
                            "the kill fired before any chunk drained, so "
                            "the gate proved nothing")
        elif resume["row_hits"] != resume["journal_preloaded"]:
            problems.append(
                f"resume: {resume['row_hits']} row-cache hits vs "
                f"{resume['journal_preloaded']} journaled rows — "
                f"completed rows must not re-dispatch (and "
                f"un-journaled ones must)")
        print(f"chaos-gate: cold built {cold['builds']} and captured "
              f"{cold['captures']}; oom recovered via {oom['faults']} "
              f"({oom['builds']} builds, {oom['captures']} captures); "
              f"transient via {transient['faults']} "
              f"({transient['builds']} builds, {transient['captures']} "
              f"captures); resume replayed "
              f"{resume['journal_preloaded']} journaled rows with "
              f"{resume['builds']} builds and {resume['captures']} "
              f"captures -> {'ok' if not problems else 'FAIL'}")
    finally:
        if args.cache_dir is None:
            shutil.rmtree(cache_dir, ignore_errors=True)
    for problem in problems:
        print(f"chaos-gate: {problem}", file=sys.stderr)
    print(f"# chaos-gate: {'PASS' if not problems else 'FAIL'} "
          f"(VOD grid, 5 processes, {sizes['peers']} peers, "
          f"chunk {sizes['chunk']}, {args.device})", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
