"""Re-run points of the JAX reference's population mixture grid at full
size, so that the port's run of that grid can be held to the reference at
HEAD.

The mixture grid is ``tools/sweep.py --population
examples/population_cellular_broadband.json``: the 48-point VOD grid
crossed with the spec's ``mix_fractions`` (144 points) at 1,048,576 peers
× 128 segments × 960 steps.  No record of its rows exists from a TPU, so
this runs the reference on the CPU through ``tools/sweep.py``'s own
``run_grid_sequential(population=)`` (the same scenarios and rounding as
a sweep: offload to 4 digits, rebuffer to 5), one point at a time, and
prints each row with its wall time.  ``chip_smoke.py``'s
``POPULATION_ANCHOR`` holds the numbers it printed.

Run: ``JAX_PLATFORMS=cpu python tools/torch_port_population_anchor.py
[--points 2 87 142]`` (indices into the mixture grid, point ``3 i + m``
being VOD point ``i`` at mix fraction ``m``; about 1 GB of host memory
and a minute or two a point).
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

SPEC = os.path.join(ROOT, "examples", "population_cellular_broadband.json")
PEERS, SEGMENTS, WATCH_S = 1_048_576, 128, 240.0
#: the population fixture's points (tools/torch_port_fixture.py
#: POPULATION_VOD_POINTS): point 2, VOD point 0 (SD, scarce supply, a late
#: rescue) with 50% cellular; point 87, VOD point 29 (HD, uplink 2.4 / CDN
#: 1.2 Mb/s) with none; point 142, VOD point 47 (HD, ample supply, where
#: the cellular level cap binds) with 25%
DEFAULT_POINTS = (2, 87, 142)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, nargs="+",
                    default=list(DEFAULT_POINTS))
    ap.add_argument("--peers", type=int, default=PEERS)
    args = ap.parse_args(argv)
    import sweep

    from hlsjs_p2p_wrapper_tpu.engine.population import load_spec

    spec = load_spec(SPEC)
    grid = sweep.population_grid(sweep.vod_grid(), spec)
    for i in args.points:
        knobs = grid[i]
        t0 = time.perf_counter()
        (row,), _info = sweep.run_grid_sequential(
            [knobs], peers=args.peers, segments=SEGMENTS, watch_s=WATCH_S,
            live=False, seed=0, population=spec)
        wall = time.perf_counter() - t0
        print(json.dumps({"point": i, "knobs": knobs, "peers": args.peers,
                          "offload": row["offload"],
                          "rebuffer": row["rebuffer"], "wall_s": wall}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
