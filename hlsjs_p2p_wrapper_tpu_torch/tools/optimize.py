"""Closed-loop policy search: discover the offload/rebuffer frontier, on
the port's dispatch.  The reference's ``tools/optimize.py``
(``run_search`` :292, ``_frontier_table`` :376, ``build_parser`` :396,
``main`` :468) with its setup from ``search_eval.py``.

``tools/sweep.py`` answers "what happens at these 144 points"; this
tool answers which knobs maximize offload subject to rebuffer ≤ X, by
driving the ``engine/search.py`` ask/tell loop over the warm-started
dispatch: one proposal batch is one ``stream_groups_chunked`` call a
fidelity over the row cache's misses (revisited points are
bit-identical row hits), every completed row is journaled, and the
search state checkpoints atomically after every round, so a killed
search ``--resume``s to the same frontier, bit for bit, with no
recompute of journaled rows.

Drivers (``--driver``; seeded and deterministic): ``halving`` (the
default: screen the 144-point live lattice at ``--screen-fidelity``
of the watch window, promote the constraint-aware top ``1/eta`` to
full length), ``random``, ``cmaes`` (over the smooth knobs; ``--pin
supply=2`` pins a categorical axis), ``refine`` (densify around the
constraint's flip edges) and ``grid`` (the exhaustive lattice).
Infeasible points are kept and labeled; the budget counts full-run
equivalents of proposed work, cache hits included.

Usage::

    python -m hlsjs_p2p_wrapper_tpu_torch.tools.optimize
    python -m hlsjs_p2p_wrapper_tpu_torch.tools.optimize --resume
    python -m hlsjs_p2p_wrapper_tpu_torch.tools.optimize --device cpu \\
        --peers 16 --segments 8 --watch-s 8 --chunk 8 --budget 66

Output: the Pareto set on stdout, progress on stderr, and with
``--out`` the artifact with the reference's keys: meta, per-round
provenance, every trial, the frontier (and the refiner's edge map).
Its ``meta.xla_compiles`` is the port's ``CompileCounter``: ``nvcc``
builds started plus CUDA-graph captures.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import (COMPILES_MEANING, add_device_flag, device_identity,
               launch_counts, open_device, report_kernels)
from ..engine.artifact_cache import (CompileCounter, SweepJournal,
                                     WarmStart, atomic_write_json,
                                     journal_path)
from ..engine.faults import FaultPlan, FaultPolicy
from ..engine.search import (Constraint, PolicySearch,
                             search_checkpoint_path)
from ..engine.tracer import FlightRecorder, run_id_for
from ..search_eval import (TRIAL_METRICS, Evaluator, build_driver,
                           live_lattice, live_space, search_meta)


def run_search(args):
    """The whole tool as a callable: build the space, the driver and the
    loop on ``args.device``, run, and return the artifact dict.  ``args``
    is :func:`build_parser`'s namespace."""
    probe = CompileCounter().attach()
    try:
        return _run_search(args, probe)
    finally:
        probe.detach()


def _run_search(args, probe):
    dev = torch.device(args.device)
    space = live_space()
    constraint = Constraint.parse(args.constraint)
    warm_start = WarmStart(cache_dir=args.cache_dir)
    faults = FaultPolicy(
        plan=(FaultPlan.parse(args.inject_faults)
              if args.inject_faults else None),
        registry=warm_start.registry)
    meta = search_meta(args, space, constraint)
    jpath = journal_path(warm_start.cache_dir, meta)
    journal = SweepJournal(jpath, meta,
                           resume=args.resume and os.path.exists(jpath))
    preloaded = len(journal.completed)
    trace = None
    if args.trace_dir:
        trace = FlightRecorder(args.trace_dir, "host00",
                               run_id=run_id_for(meta),
                               registry=warm_start.registry)
    try:
        driver = build_driver(args, space, constraint)
    except ValueError as exc:
        journal.close()
        raise SystemExit(str(exc)) from None
    evaluator = Evaluator(
        space, peers=args.peers, segments=args.segments,
        watch_s=args.watch_s, seed=args.seed, chunk=args.chunk,
        warm_start=warm_start, faults=faults, journal=journal,
        trace=trace, device=dev)
    search = PolicySearch(
        driver, evaluator, constraint, budget=args.budget,
        batch=args.batch, registry=warm_start.registry, trace=trace,
        checkpoint_path=search_checkpoint_path(warm_start.cache_dir,
                                               meta),
        checkpoint_meta=meta)
    resumed = False
    if args.resume:
        resumed = search.resume()
        print(f"# resume: checkpoint holds {search.round} completed "
              f"rounds ({len(search.trials)} trials, "
              f"{search.spent:g} budget spent); journal lists "
              f"{preloaded} completed rows", file=sys.stderr)
    t0 = time.perf_counter()
    result = search.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    if not result["frontier"]["failed"]:
        journal.finalize()
    journal.close()
    if trace is not None:
        trace.close()
    platform, kind = device_identity(dev)
    artifact = {
        "meta": {
            "tool": "optimize",
            "peers": args.peers, "segments": args.segments,
            "watch_s": args.watch_s, "seed": args.seed,
            "driver": args.driver, "budget": args.budget,
            "batch": args.batch, "chunk": args.chunk,
            "constraint": {"metric": constraint.metric,
                           "bound": constraint.bound},
            "lattice_points": len(live_lattice()),
            "elapsed_s": round(elapsed, 2),
            "platform": platform,
            "device_kind": kind,
            "resume": bool(resumed),
            "journal_preloaded": preloaded,
            "xla_compiles": probe.compiles,
            "warm_start": warm_start.summary(),
            "dispatch_faults": faults.fault_counts(),
        },
        "rounds": result["rounds"],
        "spent": result["spent"],
        "trials": result["trials"],
        "frontier": result["frontier"],
    }
    for key in ("refined_edges", "interactions", "refine_rounds"):
        if key in result:
            artifact[key] = result[key]
    return artifact


def _frontier_table(artifact, constraint: Constraint):
    """The Pareto set as text, best feasible first, feasibility
    labeled."""
    lines = []
    best = artifact["frontier"]["best"]
    for trial in artifact["frontier"]["pareto"]:
        knobs = trial["knobs"]
        mark = ("*" if best is not None
                and trial["point"] == best["point"] else " ")
        feas = "feasible  " if trial["feasible"] else "INFEASIBLE"
        knob_str = " ".join(
            f"{k}={knobs[k]:g}" if isinstance(knobs[k], float)
            else f"{k}={knobs[k]}"
            for k in sorted(knobs) if k not in ("degree", "ladder"))
        lines.append(f"{mark} {feas} offload={trial['offload']:.4f} "
                     f"{constraint.metric}={trial[constraint.metric]:.5f}"
                     f"  {knob_str}")
    return lines


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--driver", default="halving",
                    choices=("halving", "random", "cmaes", "refine",
                             "grid"))
    ap.add_argument("--budget", type=float, default=64.0,
                    help="search budget in FULL-RUN EQUIVALENTS of "
                         "proposed work (a 1/4-fidelity screen costs "
                         "0.25; the 144-pt lattice costs 144 "
                         "exhaustively; default 64)")
    ap.add_argument("--batch", type=int, default=144,
                    help="max proposals per ask/tell round — one round "
                         "is one chunked dispatch of the misses "
                         "(default 144: a whole lattice cohort)")
    ap.add_argument("--constraint", default="rebuffer<=0.02",
                    help="explicit constraint, metric<=bound (default "
                         "rebuffer<=0.02); infeasible points are kept "
                         "and labeled, never dropped")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--peers", type=int, default=1024)
    ap.add_argument("--segments", type=int, default=128)
    ap.add_argument("--watch-s", type=float, default=240.0)
    ap.add_argument("--chunk", type=int, default=16,
                    help="scenarios per dispatch, pinned (not "
                         "autotuned) so every round dispatches chunks "
                         "of one width (default 16)")
    ap.add_argument("--rungs", type=int, default=2,
                    help="halving rungs (default 2: one screen, one "
                         "full-length run)")
    ap.add_argument("--eta", type=float, default=6.0,
                    help="halving promotion divisor: top 1/eta of a "
                         "rung survives (default 6)")
    ap.add_argument("--screen-fidelity", type=float, default=0.25,
                    help="lowest halving rung's fraction of the watch "
                         "window (default 0.25)")
    ap.add_argument("--popsize", type=int, default=None,
                    help="CMA-ES population (default 4+3ln(n))")
    ap.add_argument("--sigma0", type=float, default=0.3,
                    help="CMA-ES initial step size in the unit cube")
    ap.add_argument("--pin", action="append", metavar="AXIS=INDEX",
                    help="pin a categorical axis for CMA-ES "
                         "(repeatable; default index 0)")
    ap.add_argument("--resume", action="store_true",
                    help="resume a killed search: reload the atomic "
                         "checkpoint (digest-checked), re-ask the "
                         "in-flight round deterministically, and serve "
                         "its journaled rows from the row cache with "
                         "zero recompute")
    ap.add_argument("--trace-dir", metavar="DIR",
                    help="arm the flight recorder: dispatch spans + one "
                         "search_round mark per ask/tell round")
    ap.add_argument("--inject-faults", metavar="SPEC",
                    help="deterministic fault plane (chaos/test hook): "
                         "kind@group:chunk[xN], kind one of oom/"
                         "transient/timeout/kill (engine/faults.py "
                         "FaultPlan)")
    ap.add_argument("--out", metavar="FILE",
                    help="write the artifact (meta + per-round "
                         "provenance + trials + frontier + refined "
                         "edges) as JSON, atomically; its "
                         "meta.xla_compiles counts " + COMPILES_MEANING)
    ap.add_argument("--json", action="store_true",
                    help="one JSON line per Pareto-front trial")
    ap.add_argument("--cache-dir", help=argparse.SUPPRESS)  # gate /
    # test hook: pin the warm-start root (else $HLSJS_P2P_TORCH_CACHE_DIR
    # or the default root)
    add_device_flag(ap)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    open_device(ap, args.device)
    try:
        constraint = Constraint.parse(args.constraint)
    except ValueError as exc:
        ap.error(str(exc))
    if constraint.metric not in TRIAL_METRICS:
        ap.error(f"unknown constraint metric {constraint.metric!r} "
                 f"(trials carry: {', '.join(TRIAL_METRICS)})")
    launches = launch_counts()
    with CompileCounter() as probe:
        artifact = run_search(args)
    frontier = artifact["frontier"]
    if args.json:
        for trial in frontier["pareto"]:
            print(json.dumps(trial))
    else:
        for line in _frontier_table(artifact, constraint):
            print(line)
    best = frontier["best"]
    if best is None:
        least = frontier["least_violating"]
        print(f"# NO feasible point under "
              f"{constraint.metric}<={constraint.bound:g} "
              f"({frontier['infeasible']} infeasible trials kept); "
              f"least violating: offload={least['offload']:.4f} "
              f"{constraint.metric}={least[constraint.metric]:.5f}"
              if least is not None else
              "# no completed full-fidelity trials",
              file=sys.stderr)
    else:
        print(f"# best feasible: offload={best['offload']:.4f} "
              f"{constraint.metric}={best[constraint.metric]:.5f} "
              f"(round {best['round']})", file=sys.stderr)
    rounds = artifact["rounds"]
    fresh = sum(r["fresh_dispatches"] for r in rounds)
    cached = sum(r["row_cache_hits"] for r in rounds)
    print(f"# {args.driver} search: {len(artifact['trials'])} trials "
          f"in {len(rounds)} rounds, budget {artifact['spent']:g}/"
          f"{args.budget:g} full-run equivalents "
          f"(exhaustive lattice = {artifact['meta']['lattice_points']}"
          f"), {fresh} fresh dispatches + {cached} row-cache hits, "
          f"{artifact['meta']['xla_compiles']} builds + captures, "
          f"{artifact['meta']['elapsed_s']}s ({args.device})",
          file=sys.stderr)
    if artifact["meta"]["dispatch_faults"]:
        print(f"# dispatch faults: "
              f"{artifact['meta']['dispatch_faults']}",
              file=sys.stderr)
    if args.out:
        atomic_write_json(args.out, artifact)
        print(f"# wrote {args.out}", file=sys.stderr)
    report_kernels(probe, launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
