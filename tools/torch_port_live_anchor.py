"""Re-run points of the JAX reference's live grid at full size and hold
them to its recorded sweep, ``SWEEP_LIVE_1M_r05.json``.

The record is the reference's 144-point live grid at 1,048,576 peers ×
128 segments × 960 steps (``tools/sweep.py --live``), with offload
rounded to 4 digits and rebuffer to 5.  The port's live grid is held to
it on the card (``chip_smoke.py``), which is only sound while today's
reference still gives those rows.  This runs the reference on the CPU
through ``tools/sweep.py``'s own ``run_grid_sequential`` (the same
scenarios and rounding as the record), one point at a time, and prints
each row beside the recorded one with the run's wall time.

Run: ``JAX_PLATFORMS=cpu python tools/torch_port_live_anchor.py
[--points 107 100]`` (indices into ``live_grid()``; about 1 GB of host
memory and a minute or two a point).
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

RECORD = os.path.join(ROOT, "SWEEP_LIVE_1M_r05.json")
#: point 107: a crowd wave that stalls; point 100: a steady point that
#: stalls at the record's rounding floor (1e-05)
DEFAULT_POINTS = (107, 100)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, nargs="+",
                    default=list(DEFAULT_POINTS))
    args = ap.parse_args(argv)
    import sweep

    with open(RECORD) as fh:
        record = json.load(fh)
    meta = record["meta"]
    grid = sweep.live_grid()
    recorded = {tuple(r[k] for k in grid[0]): r for r in record["rows"]}
    same = True
    for i in args.points:
        knobs = grid[i]
        t0 = time.perf_counter()
        (row,), _info = sweep.run_grid_sequential(
            [knobs], peers=meta["peers"], segments=meta["segments"],
            watch_s=meta["watch_s"], live=True, seed=0)
        wall = time.perf_counter() - t0
        want = recorded[tuple(knobs.values())]
        equal = (row["offload"] == want["offload"]
                 and row["rebuffer"] == want["rebuffer"])
        same = same and equal
        print(json.dumps({"point": i, "knobs": knobs,
                          "offload": row["offload"],
                          "rebuffer": row["rebuffer"],
                          "recorded_offload": want["offload"],
                          "recorded_rebuffer": want["rebuffer"],
                          "equal": equal, "wall_s": wall}), flush=True)
    print(json.dumps({"all_equal": same}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
