"""One host of the multi-host sweep fabric (``engine/fabric.py``) in a
process of its own: the port's counterpart of the reference's fabric
worker as its gates start it (``tools/fleet_gate.py:86-133``, ``child``
and ``run_role``; ``tools/trace_gate.py:81-104``, ``spawn_worker``).
A host's work is the port's sweep tool's, ``tools/sweep.py``
``fabric_host``, which the tool's ``--fabric --host-id`` worker runs
too.  ``chip_smoke.py`` phase 38 starts three of them on one card.

    python -m hlsjs_p2p_wrapper_tpu_torch.testing.fleet_worker \\
        --fabric DIR --root DIR --trace-dir DIR --host-id ID \\
        --out ROWS.npz [--lease-s L] [--chaos SPEC] [--barrier N] \\
        [--peers N] [--segments S] [--watch-s W] [--stagger-s X] \\
        [--record-every R] [--chunk C] [--wait] [--device cuda|cpu]

It attaches a ``CompileCounter`` before anything touches the kernels,
imports what it runs and prints ``{"ready": ...}``; with ``--wait`` it
then waits for a line on its standard input, so that a parent can start
it ahead of time without a context on the card.  It makes the device
ready (``{"card_s": ...}``), then joins the work ledger on ``--fabric``
for ``sweep_grid.vod_grid()`` (``WorkLedger`` with the lease
``--lease-s`` and the ``FleetChaos`` of ``--chaos``, ``kill@N`` or
``stall@N:SECONDS``), publishes or adopts the manifest of units of
``--chunk`` points, waits at the start-line ``barrier`` for ``--barrier``
hosts (the kernel libraries loaded first on the card), and runs
``run_units``: each claimed unit through the port's
``stream_groups_chunked`` at the manifest's chunk, with a ``WarmStart``
on ``--root`` (the row cache the hosts share), a ``FaultPolicy``, this
host's journal shard ``journal_path(root, meta, host)`` and this host's
``FlightRecorder`` shard in ``--trace-dir`` (attached to the registry
that the ledger, the fault policy and the warm start count into).

At the end it flushes its shard, writes its rows to ``--out`` (``index``,
``offload`` and ``rebuffer`` float64 and the stacked ``timeline``) and
prints one JSON line: its rows as ``float.hex`` by grid index, its
``fabric_claims`` (``claims``), its registry's replayed counter families
(``counters``, ``engine.tracer.counter_families``), the unit log, the
builds, captures and kernel launches it made, its wall from the go, and
the device's name.  It exits 1 when a row failed.
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
    ap.add_argument("--fabric", required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--host-id", required=True)
    ap.add_argument("--trace-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--lease-s", type=float, default=30.0)
    ap.add_argument("--chaos", default=None)
    ap.add_argument("--barrier", type=int, default=0)
    ap.add_argument("--peers", type=int, default=1_048_576)
    ap.add_argument("--segments", type=int, default=128)
    ap.add_argument("--watch-s", type=float, default=240.0)
    ap.add_argument("--stagger-s", type=float, default=60.0)
    ap.add_argument("--record-every", type=int, default=40)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--wait", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    from ..engine.artifact_cache import CompileCounter
    probe = CompileCounter().attach()

    import numpy as np
    import torch

    from .. import sweep_grid as sg
    from ..engine.artifact_cache import WarmStart, atomic_write_bytes
    from ..engine.faults import FaultPolicy
    from ..engine.tracer import FlightRecorder, counter_families, run_id_for
    from ..ops import swarm_kernels as sk
    from ..tools.sweep import fabric_host

    dev = torch.device(args.device)
    _emit({"ready": True, "host": args.host_id,
           "startup_s": time.perf_counter() - t_start})
    if args.wait:
        sys.stdin.readline()

    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    _emit({"card_s": time.perf_counter() - t0})
    grid = sg.vod_grid()
    meta = sg.journal_meta(grid, peers=args.peers, segments=args.segments,
                           watch_s=args.watch_s, live=False, seed=0,
                           record_every=args.record_every)
    warm = WarmStart(args.root)
    faults = FaultPolicy(registry=warm.registry)
    trace = FlightRecorder(args.trace_dir, args.host_id,
                           run_id=run_id_for(meta), registry=warm.registry)
    launches = dict(sk.LAUNCHES)
    # the tool's host work (tools/sweep.py ``fabric_host``): the ledger
    # with its chaos, the manifest of --chunk units (pinned by whoever
    # published it first), the barrier, this host's journal shard and
    # ``run_units``
    host = fabric_host(
        grid, peers=args.peers, segments=args.segments,
        watch_s=args.watch_s, live=False, seed=0, chunk=args.chunk,
        fabric_dir=args.fabric, host_id=args.host_id, lease_s=args.lease_s,
        warm_start=warm, faults=faults, chaos_spec=args.chaos,
        barrier_hosts=args.barrier, stagger_s=args.stagger_s,
        record_every=args.record_every, trace=trace, device=dev)
    ledger, unit_log, jpath = host["ledger"], host["unit_log"], host["journal"]
    units, chunks = host["units"], host["chunks"]
    results = host["results"]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = host["run_s"]
    # every buffered event durable before the counters are read out
    trace.flush()
    rows = dict(sorted(results[0].items()))
    failed = sum(metric is None for metric in rows.values())
    if rows and not failed:
        arrays = {"index": np.array(list(rows), np.int64),
                  "offload": np.array([m[0] for m in rows.values()],
                                      np.float64),
                  "rebuffer": np.array([m[1] for m in rows.values()],
                                       np.float64)}
        if args.record_every:
            arrays["timeline"] = np.stack([m[2] for m in rows.values()])
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        atomic_write_bytes(args.out, buf.getvalue())
    probe.detach()
    _emit({"host": args.host_id,
           "rows": {str(i): (None if m is None
                             else [m[0].hex(), m[1].hex()])
                    for i, m in rows.items()},
           "failed": failed, "claims": ledger.claim_counts(),
           "counters": counter_families(warm.registry),
           "faults": faults.fault_counts(), "units": unit_log,
           "manifest": {"units": len(units), "chunks": chunks},
           "journal": jpath,
           "row": warm.event_counts("row"),
           "builds": probe.builds, "captures": probe.captures,
           "launches": {k: sk.LAUNCHES[k] - launches[k] for k in launches},
           "wall_s": wall, "go_s": time.perf_counter() - t0,
           "device": name})
    trace.close()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
