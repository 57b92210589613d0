"""Optimize gate on the port: the policy search plane earns its budget
claims.

The reference's ``tools/optimize_gate.py`` (``run_child`` and ``main``,
:70-291) on the port's search tool (``tools.optimize``).  The search
plane's pitch (engine/search.py) is three claims, each held at PROCESS
granularity on the shipped 144-point live scenario family:

1. **Budget**: with a budget under 50% of exhaustive evaluation, the
   discovered config's offload must be ≥ the best feasible uniform-grid
   point's, with the rebuffer constraint respected.
2. **Determinism**: a same-seed rerun must reproduce the identical
   frontier AND the identical trial values — against the warm row cache
   it must do so with ZERO fresh dispatches and zero compiles.
3. **Crash safety**: a search SIGKILLed mid-screen (the fault plane's
   ``kill`` injection) must leave a journal whose rows the ``--resume``
   run serves ENTIRELY from the row cache (round-0 cache hits ==
   journaled rows), build nothing, and converge to a frontier
   bit-identical to the uninterrupted run's.

"Zero compiles" on the port (``CompileCounter``, each child's ``#
kernels:`` line): 0 ``nvcc`` builds in the rerun and in the resume (the
kernel libraries are on disk), and 0 CUDA-graph captures in the rerun,
where nothing is dispatched.  The resume dispatches the rows the kill
left undone, so it captures its own graphs (PyTorch keeps none across
processes); the reference's ``meta.xla_compiles`` of the rerun is the
port's builds + captures.

The gate runs the port's search tool (``tools.optimize.main(argv)``,
what ``python -m hlsjs_p2p_wrapper_tpu_torch.tools.optimize`` runs) in
five child processes against throwaway cache roots, three chains side
by side.  Every child is a ``testing/tool_child.py`` process started
by :func:`prepare` (torch and the tool imported, no context on the
card) and sent its argv when its turn comes; ``testing/tool_child.py
optimize_gate --prepare`` starts them beside its own start:

- ``grid`` — exhaustive lattice evaluation (cache A): the uniform
  baseline.
- ``search`` — the budgeted halving search (cache B, fresh: it must not
  borrow the baseline's rows), then ``rerun`` — same seed against
  cache B: identical frontier, all cache hits, zero compiles.
- ``kill`` — cache C, SIGKILLed at screen chunk 5: must die hard (no
  artifact), journal holding the drained chunks, then ``resume`` —
  ``--resume`` against cache C: claim 3.  The reference seeds cache C
  with B's executable layers only (``aot/`` + ``xla/``: warm programs,
  cold rows); the port has no executable layer (its kernel libraries
  live in ``build/torch_kernels/``, which every root shares), so cache C
  is a fresh root, cold rows, and the kill chain need not wait for the
  search.

Values are compared at FULL precision modulo the ``cached`` provenance
flag.  Gate-sized swarms by default; ``OPTIMIZE_GATE_PEERS`` etc. scale
it up.

Run: ``python -m hlsjs_p2p_wrapper_tpu_torch.tools.optimize_gate
[--device cpu]`` (exit 1 on any violation).
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
from concurrent.futures import ThreadPoolExecutor

from . import (WaitingTool, add_device_flag, add_kernels, kernels_reported,
               open_device, report_children)
from ..engine.search import scrub_provenance as scrub

#: the checkout's root, the children's working directory
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PACKAGE = __spec__.name.rsplit(".", 2)[0]

#: the kill lands at screen chunk 5: with chunk 16 the 144-pt screen
#: is 9 chunks, so chunks 0-3 have drained + journaled (the pipelined
#: drain runs one chunk behind) and the rest have not — the resume
#: must replay exactly those
KILL_SPEC = "kill@0:5"

#: the children, in the order the gate runs them
MODES = ("grid", "search", "rerun", "kill", "resume")
#: the children :func:`prepare` started, by mode
_PREPARED: dict = {}


def _argv(cache_dir, sizes, out, device, extra):
    return ["--peers", str(sizes["peers"]),
            "--segments", str(sizes["segments"]),
            "--watch-s", str(sizes["watch_s"]),
            "--chunk", str(sizes["chunk"]),
            "--constraint", f"rebuffer<={sizes['bound']}",
            "--seed", str(sizes["seed"]),
            "--cache-dir", cache_dir, "--out", out, "--device", device,
            *extra]


def run_child(mode, cache_dir, sizes, out, device, child, total, walls, *,
              extra=(), expect_kill=False):
    """One ``tools.optimize`` run in ``child``, a waiting child.  Returns
    ``(artifact, counts)``: the ``--out`` artifact (None for the kill)
    and the run's builds, captures and launches, which also go into
    ``total``; its wall from the go goes into ``walls[mode]``."""
    t0 = time.perf_counter()
    rc, stdout, stderr = child.run(
        _argv(cache_dir, sizes, out, device, extra))
    walls[mode] = time.perf_counter() - t0
    if expect_kill:
        if rc != -signal.SIGKILL:
            raise SystemExit(
                f"optimize-gate: kill child exited "
                f"{rc}, expected SIGKILL "
                f"({-signal.SIGKILL}):\n{stdout}\n{stderr}")
        return None, None
    if rc != 0:
        raise SystemExit(f"optimize-gate child failed ({mode}):\n"
                         f"{stdout}\n{stderr}")
    counts = kernels_reported(stderr)[-1]
    add_kernels(total, counts)
    with open(out, encoding="utf-8") as fh:
        return json.load(fh), counts


def prepare():
    """This gate's five children, started now and waiting for their
    argv."""
    if not _PREPARED:
        _PREPARED.update({mode: WaitingTool("optimize", _ROOT)
                          for mode in MODES})
    return _PREPARED


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--peers", type=int, default=int(
        os.environ.get("OPTIMIZE_GATE_PEERS", 48)))
    ap.add_argument("--segments", type=int, default=int(
        os.environ.get("OPTIMIZE_GATE_SEGMENTS", 16)))
    ap.add_argument("--watch-s", type=float, default=float(
        os.environ.get("OPTIMIZE_GATE_WATCH_S", 60.0)))
    ap.add_argument("--chunk", type=int, default=int(
        os.environ.get("OPTIMIZE_GATE_CHUNK", 16)))
    ap.add_argument("--budget", type=float, default=float(
        os.environ.get("OPTIMIZE_GATE_BUDGET", 66.0)))
    ap.add_argument("--bound", type=float, default=float(
        os.environ.get("OPTIMIZE_GATE_BOUND", 0.02)))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keep-dirs", action="store_true",
                    help="keep the throwaway cache dirs for "
                         "post-mortem")
    add_device_flag(ap)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    open_device(ap, args.device)
    total, walls = {}, {}

    sizes = {"peers": args.peers, "segments": args.segments,
             "watch_s": args.watch_s, "chunk": args.chunk,
             "bound": args.bound, "seed": args.seed}
    work = tempfile.mkdtemp(prefix="optimize-gate-")
    cache_a = os.path.join(work, "cache_grid")
    cache_b = os.path.join(work, "cache_search")
    cache_c = os.path.join(work, "cache_kill")
    problems = []
    children = prepare()
    budget = ("--budget", str(args.budget))
    try:
        def baseline():
            # 1. the exhaustive uniform-grid baseline (its own cache: the
            # budgeted search must not borrow its rows)
            return run_child(
                "grid", cache_a, sizes, os.path.join(work, "grid.json"),
                args.device, children["grid"], total, walls,
                extra=("--driver", "grid", "--budget", "200"))

        def search_and_rerun():
            # 2. the budgeted search, then 3. its same-seed rerun against
            # the warm row cache
            search = run_child(
                "search", cache_b, sizes,
                os.path.join(work, "search.json"), args.device,
                children["search"], total, walls, extra=budget)
            rerun = run_child(
                "rerun", cache_b, sizes, os.path.join(work, "rerun.json"),
                args.device, children["rerun"], total, walls,
                extra=budget)
            return search, rerun

        def kill_and_resume():
            # 4. SIGKILL mid-screen on a fresh root (cold rows, so the
            # screen dispatches and the kill coordinate fires), then 5.
            # --resume on it
            killed_out = os.path.join(work, "killed.json")
            run_child("kill", cache_c, sizes, killed_out, args.device,
                      children["kill"], total, walls,
                      extra=(*budget, "--inject-faults", KILL_SPEC),
                      expect_kill=True)
            state = {"killed_artifact": os.path.exists(killed_out)}
            journal_dir = os.path.join(cache_c, "journals")
            state["journals"] = [
                name for name in (os.listdir(journal_dir)
                                  if os.path.isdir(journal_dir) else [])
                if name.endswith(".jsonl")]
            state["records"] = []
            if len(state["journals"]) == 1:
                with open(os.path.join(journal_dir, state["journals"][0]),
                          encoding="utf-8") as fh:
                    state["records"] = [json.loads(line) for line in fh
                                        if line.strip()]
            state["resume"] = run_child(
                "resume", cache_c, sizes,
                os.path.join(work, "resume.json"), args.device,
                children["resume"], total, walls,
                extra=(*budget, "--resume"))
            return state

        with ThreadPoolExecutor(3) as pool:
            futures = [pool.submit(fn) for fn in
                       (baseline, search_and_rerun, kill_and_resume)]
            (grid, _), ((search, _), (rerun, rerun_counts)), killed = \
                [f.result() for f in futures]

        exhaustive = grid["meta"]["lattice_points"]
        grid_best = grid["frontier"]["best"]
        if grid_best is None:
            problems.append(
                f"grid: no feasible lattice point under "
                f"rebuffer<={args.bound} — the gate bound is "
                f"miscalibrated for this size")

        # the budget claim: under half the exhaustive cost, constraint
        # respected, offload >= the grid's best feasible
        if search["spent"] >= exhaustive / 2:
            problems.append(
                f"search: spent {search['spent']} full-run "
                f"equivalents — the budget claim is < 50% of "
                f"exhaustive ({exhaustive})")
        best = search["frontier"]["best"]
        if best is None:
            problems.append("search: found no feasible point "
                            "although the grid has some")
        elif grid_best is not None:
            if best["rebuffer"] > args.bound:
                problems.append(
                    f"search: discovered config violates the "
                    f"constraint (rebuffer {best['rebuffer']} > "
                    f"{args.bound})")
            if best["offload"] < grid_best["offload"]:
                problems.append(
                    f"search: discovered offload {best['offload']} "
                    f"< best feasible uniform-grid point "
                    f"{grid_best['offload']} — the budgeted search "
                    f"must not lose to the grid it undercuts")

        # same-seed determinism against the warm cache: identical
        # frontier + trial values, zero fresh dispatches, zero builds and
        # captures
        if scrub(rerun["trials"]) != scrub(search["trials"]):
            problems.append("rerun: same-seed trial values diverged "
                            "from the first search — the proposal "
                            "sequence must be a pure function of "
                            "(seed, tells)")
        if scrub(rerun["frontier"]) != scrub(search["frontier"]):
            problems.append("rerun: same-seed frontier diverged")
        rerun_fresh = sum(r["fresh_dispatches"]
                          for r in rerun["rounds"])
        if rerun_fresh != 0:
            problems.append(f"rerun: {rerun_fresh} fresh dispatches "
                            f"against the warm row cache — every "
                            f"revisited point must be a row-cache hit")
        if rerun["meta"]["xla_compiles"] != 0 or rerun_counts["builds"]:
            problems.append(
                f"rerun: {rerun_counts['builds']} nvcc builds and "
                f"{rerun_counts['captures']} captures on the warm cache "
                f"— expected 0 (nothing dispatches)")

        # the kill: died hard, journal holding the drained chunks
        if killed["killed_artifact"]:
            problems.append("kill: the SIGKILLed child left an "
                            "artifact — it must die hard")
        journaled = 0
        if len(killed["journals"]) != 1:
            problems.append(f"kill: expected exactly one journal "
                            f"shard, found {killed['journals']}")
        else:
            records = killed["records"]
            journaled = sum(1 for r in records
                            if r.get("kind") == "row")
            if journaled == 0:
                problems.append("kill: the journal holds no rows — "
                                "the kill fired before any chunk "
                                "drained, so the gate proves "
                                "nothing")
            if any(r.get("kind") == "done" for r in records):
                problems.append("kill: the journal was finalized by "
                                "a killed run")

        # --resume: bit-identical frontier, journaled rows all served
        # from the row cache, no build
        resume, resume_counts = killed["resume"]
        if scrub(resume["trials"]) != scrub(search["trials"]):
            problems.append("resume: trial values diverged from the "
                            "uninterrupted search — resume must be "
                            "bit-identical")
        if scrub(resume["frontier"]) != scrub(search["frontier"]):
            problems.append("resume: frontier diverged from the "
                            "uninterrupted search")
        resume_fresh = sum(r["fresh_dispatches"] for r in resume["rounds"])
        if resume_counts["builds"] != 0 or (
                resume_fresh == 0 and resume_counts["captures"] != 0):
            problems.append(
                f"resume: {resume_counts['builds']} nvcc builds and "
                f"{resume_counts['captures']} captures with "
                f"{resume_fresh} fresh dispatches — the kernel libraries "
                f"on disk must cover every resumed dispatch")
        preloaded = resume["meta"]["journal_preloaded"]
        if preloaded != journaled:
            problems.append(
                f"resume: read {preloaded} journaled rows, the kill "
                f"left {journaled}")
        round0_hits = (resume["rounds"][0]["row_cache_hits"]
                       if resume["rounds"] else 0)
        if round0_hits != journaled:
            problems.append(
                f"resume: round-0 row-cache hits {round0_hits} != "
                f"journaled rows {journaled} — every journaled row "
                f"must be served from the cache, and nothing else "
                f"can be warm")

        spent = search["spent"]
        best_off = best["offload"] if best else None
        grid_off = grid_best["offload"] if grid_best else None
        print(f"optimize-gate: grid best {grid_off} over "
              f"{exhaustive} evals; search best {best_off} at "
              f"{spent} equivalents; rerun "
              f"{rerun_counts['builds']} builds + "
              f"{rerun_counts['captures']} captures / "
              f"{rerun_fresh} fresh; kill journaled {journaled}; "
              f"resume {resume_counts['builds']} builds "
              f"({resume_counts['captures']} captures for "
              f"{resume_fresh} fresh rows); children built "
              f"{total.get('builds', 0)}, captured "
              f"{total.get('captures', 0)}, launched "
              f"{sum(total.get('launches', {}).values())} kernels"
              f"; walls (s) {json.dumps({k: round(v, 3) for k, v in walls.items()})}"
              f" -> {'ok' if not problems else 'FAIL'}")
    finally:
        for child in children.values():
            child.stop()
        _PREPARED.clear()
        if not args.keep_dirs:
            shutil.rmtree(work, ignore_errors=True)
        else:
            print(f"optimize-gate: dirs kept under {work}",
                  file=sys.stderr)
    report_children(total)
    for problem in problems:
        print(f"optimize-gate: {problem}", file=sys.stderr)
    print(f"# optimize-gate: {'PASS' if not problems else 'FAIL'} "
          f"(144-pt live family, {sizes['peers']} peers, watch "
          f"{sizes['watch_s']}s, budget {args.budget} vs "
          f"exhaustive 144, 5 processes, {args.device})", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
