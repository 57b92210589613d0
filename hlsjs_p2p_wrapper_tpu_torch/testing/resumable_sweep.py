"""The 48-point VOD grid swept in a process of its own, with the row
cache and the crash-safe journal: the child process of the kill, resume
and warm-start checks (``chip_smoke.py`` phase 35,
``tests/test_torch_artifact_cache.py``).

    python -m hlsjs_p2p_wrapper_tpu_torch.testing.resumable_sweep \\
        --root DIR --out ROWS.npz [--peers N] [--segments S] \\
        [--watch-s W] [--stagger-s X] [--record-every R] [--chunk C] \\
        [--seed K] [--inject-faults PLAN] [--resume] [--wait] \\
        [--device cuda|cpu]

It attaches a ``CompileCounter`` before anything touches the kernels,
imports what it runs and prints ``{"ready": ...}``; with ``--wait`` it
then waits for a line on its standard input, so that a parent can start
it ahead of time without a context on the card while it waits.  It makes
the device ready (prints ``{"card_s": ...}``, inside the sweep's wall)
and sweeps ``sweep_grid.vod_grid()`` through
``run_groups_chunked`` with a ``WarmStart`` on ``--root`` and the
journal ``journal_path(root, journal_meta(...))`` (resumed with
``--resume``), under ``FaultPolicy(FaultPlan.parse(PLAN))`` with
``--inject-faults`` (``kill@0:2`` SIGKILLs it as chunk 2 dispatches).
It prints ``{"prefilter_s": ...}`` when the row cache's prefilter ends,
and at the end, once every row is written to ``--out`` (``offload`` and
``rebuffer`` float64, ``timeline`` stacked) and the journal finalized,
one JSON line: the row cache's and the libraries' events, the stats'
row hits and chunks, the builds, captures and kernel launches the sweep
made, the sweep's wall, the journal's rows when it opened and whether it
is finished, and the device's name.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time


def _emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--peers", type=int, default=1_048_576)
    ap.add_argument("--segments", type=int, default=128)
    ap.add_argument("--watch-s", type=float, default=240.0)
    ap.add_argument("--stagger-s", type=float, default=60.0)
    ap.add_argument("--record-every", type=int, default=40)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inject-faults", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--wait", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    from ..engine.artifact_cache import CompileCounter
    probe = CompileCounter().attach()

    import numpy as np
    import torch

    from .. import sweep_grid as sg
    from ..engine.artifact_cache import (SweepJournal, WarmStart,
                                         atomic_write_bytes, journal_path)
    from ..engine.faults import FaultPlan, FaultPolicy
    from ..ops import dispatch as dp
    from ..ops import swarm_kernels as sk

    class ReportingWarmStart(WarmStart):
        def note_prefilter(self, seconds: float) -> None:
            super().note_prefilter(seconds)
            _emit({"prefilter_s": seconds})

    dev = torch.device(args.device)
    _emit({"ready": True, "startup_s": time.perf_counter() - t_start})
    if args.wait:
        sys.stdin.readline()

    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    card_s = time.perf_counter() - t0
    _emit({"card_s": card_s})
    config = sg.build_config(args.peers, args.segments, False, 8)
    grid = sg.vod_grid()
    n_steps = int(args.watch_s * 1000.0 / config.dt_ms)

    def build(knobs):
        return sg.build_scenario(config, knobs, watch_s=args.watch_s,
                                 stagger_s=args.stagger_s, seed=args.seed,
                                 device=dev)

    meta = sg.journal_meta(grid, peers=args.peers, segments=args.segments,
                           watch_s=args.watch_s, live=False, seed=args.seed,
                           record_every=args.record_every)
    warm = ReportingWarmStart(args.root)
    faults = (FaultPolicy(FaultPlan.parse(args.inject_faults))
              if args.inject_faults else None)
    launches = dict(sk.LAUNCHES)
    with SweepJournal(journal_path(args.root, meta), meta,
                      resume=args.resume) as journal:
        at_open = len(journal.completed)
        results, stats = dp.run_groups_chunked(
            [(config, grid, build)], n_steps, watch_s=args.watch_s,
            chunk=args.chunk, record_every=args.record_every,
            warm_start=warm, journal=journal, faults=faults)
        rows = results[0]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        failed = sum(row is None for row in rows)
        if not failed:
            arrays = {"offload": np.array([r[0] for r in rows], np.float64),
                      "rebuffer": np.array([r[1] for r in rows],
                                           np.float64)}
            if args.record_every:
                arrays["timeline"] = np.stack([r[2] for r in rows])
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            atomic_write_bytes(args.out, buf.getvalue())
            journal.finalize()
        finished = journal.finished
    wall = time.perf_counter() - t0
    probe.detach()
    _emit({"rows": len(rows), "failed": failed,
           "row": warm.event_counts("row"),
           "executable": warm.event_counts("executable"),
           "row_hits": stats[0]["row_hits"], "chunks": stats[0]["chunks"],
           "builds": probe.builds, "captures": probe.captures,
           "launches": {k: sk.LAUNCHES[k] - launches[k] for k in launches},
           "journal_rows_at_open": at_open, "journal_finished": finished,
           "wall_s": wall, "card_s": card_s,
           "prefilter_s": warm.prefilter_seconds(),
           "device": name})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
