"""Re-run cells of the JAX reference's policy A/B tables at full size and
hold them to its recorded run, ``POLICY_AB_r05.json``.

The record is ``tools/policy_ab.py``'s run: the ring topology at
262,144 peers and the random mesh (``random_neighbors(P, 8, seed)``, the
general ``[P, K]`` path) at 8,192 peers, each × 128 segments × 960 steps
(a 240 s watch window) with three transfer slots, each policy's offload
rounded to 4 digits and rebuffer to 5.  The port's spread, adaptive and
ranked columns are held to it on the card (``chip_smoke.py``), which is
only sound while today's reference still gives those rows.  This runs
the reference on the CPU through the tool's own functions
(``build_audience``, ``build_cell_scenario``, ``run_cells_batched``: the
same scenarios and rounding as the record) and prints each row beside
the recorded one with the run's wall time.

Run: ``JAX_PLATFORMS=cpu python tools/torch_port_policy_anchor.py
[--topology random] [--policy adaptive] [--cells 0 5 11 17]`` (a table,
a column of it, and indices into the tool's 20 cells; each cell is one
lane of one batched run, a few minutes on a CPU for the ring).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

RECORD = os.path.join(ROOT, "POLICY_AB_r05.json")
#: cell 5: uniform/crowd at 1.2 Mbit/s (a flash crowd that stalls);
#: cell 11: hetero/stagger at 1.6 Mbit/s
DEFAULT_CELLS = (5, 11)
#: the record's columns, in the tool's order
POLICIES = ("ranked", "spread", "adaptive")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, nargs="+",
                    default=list(DEFAULT_CELLS))
    ap.add_argument("--policy", choices=POLICIES, default="spread",
                    help="the column of the table to re-run")
    ap.add_argument("--topology", choices=("ring", "random"),
                    default="ring", help="the table to re-run")
    args = ap.parse_args(argv)
    policy = args.policy
    import policy_ab

    from hlsjs_p2p_wrapper_tpu.ops.swarm_sim import (SwarmConfig,
                                                     random_neighbors,
                                                     ring_offsets)

    with open(RECORD) as fh:
        record = json.load(fh)
    meta, table = record["meta"], record["topologies"][args.topology]
    peers = table["peers"]
    cells = [(p, w, u) for p in policy_ab.PATTERNS for w in policy_ab.WAVES
             for u in policy_ab.UPLINK_GRID_MBPS]
    recorded = {(r["pattern"], r["wave"], r["uplink_mbps"]): r
                for r in table["rows"]}
    neighbors, offsets = None, ring_offsets(meta["degree"])
    if args.topology == "random":
        neighbors = random_neighbors(peers, meta["degree"], meta["seed"])
        offsets = None
    config = SwarmConfig(n_peers=peers, n_segments=meta["segments"],
                         n_levels=1, max_concurrency=3,
                         holder_selection=policy, neighbor_offsets=offsets)
    audience = policy_ab.build_audience(peers, meta["seed"])
    chosen = [cells[i] for i in args.cells]
    t0 = time.perf_counter()
    rows, chunk = policy_ab.run_cells_batched(
        config, neighbors, audience, chosen, watch_s=meta["watch_s"],
        chunk=len(chosen))
    wall = time.perf_counter() - t0
    same = True
    for i, cell, (offload, rebuffer) in zip(args.cells, chosen, rows):
        want = recorded[cell]
        equal = (offload == want[f"{policy}_offload"]
                 and rebuffer == want[f"{policy}_rebuffer"])
        same = same and equal
        print(json.dumps({"cell": i, "topology": args.topology,
                          "policy": policy, "pattern": cell[0],
                          "wave": cell[1], "uplink_mbps": cell[2],
                          "offload": offload, "rebuffer": rebuffer,
                          "recorded_offload": want[f"{policy}_offload"],
                          "recorded_rebuffer": want[f"{policy}_rebuffer"],
                          "equal": equal}), flush=True)
    print(json.dumps({"topology": args.topology, "policy": policy,
                      "all_equal": same,
                      "cells": len(chosen), "chunk": chunk, "wall_s": wall}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
