"""Process-level warm-start gate on the port: a second run builds
nothing and, with the row cache, dispatches nothing.

The reference's ``tools/warmstart_gate.py`` on the port's sweep tool.
The warm start's claim (``engine/artifact_cache.py``) is process-level,
so this gate runs both shipped grids (the 48-point VOD grid, the
144-point live grid; ``tools/sweep.py``'s ``run_grid_batched``) as
separate child processes against one throwaway cache root (the two
grids' chains side by side):

1. **cold**: populates the row cache and the kernel libraries;
2. **warm, row cache off**: every point recomputes through the cached
   libraries: 0 ``nvcc`` builds (``CompileCounter``), the cold run's
   rows bit-exactly (``float.hex`` of the full-precision metrics), and
   no more CUDA-graph captures than the cold run made (PyTorch keeps no
   graph across processes, so a run that dispatches on the card
   captures its own graphs; on the CPU nothing captures);
3. **warm, row cache on**: 0 builds, 0 captures, every point a row
   hit, the same rows bit-exactly.

Gate-sized swarms by default; the env knobs ``WARMSTART_GATE_PEERS``,
``WARMSTART_GATE_SEGMENTS``, ``WARMSTART_GATE_WATCH_S`` and
``WARMSTART_GATE_CHUNK`` scale it.  The chunk is pinned: the autotuner
reads live device memory, and a chunk that drifted between processes
is not what this gate measures.

Run: ``python -m hlsjs_p2p_wrapper_tpu_torch.tools.warmstart_gate
[--device cpu]`` (exit 1 on any violation).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

from . import add_device_flag, open_device

#: the checkout's root, the children's working directory
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def child(args):
    """One gate run in a fresh interpreter: the build and capture probe
    attached before the kernels are touched, one shipped grid, a JSON
    line with the counts and the full-precision rows."""
    from ..engine.artifact_cache import CompileCounter, WarmStart
    probe = CompileCounter().attach()
    ws = WarmStart(cache_dir=args.cache_dir,
                   row_cache=not args.no_row_cache)
    from .. import sweep_grid
    from . import sweep
    grid = (sweep_grid.live_grid() if args.grid == "live"
            else sweep_grid.vod_grid())
    rows, info = sweep.run_grid_batched(
        grid, peers=args.peers, segments=args.segments,
        watch_s=args.watch_s, live=args.grid == "live", seed=0,
        chunk=args.chunk, warm_start=ws, raw=True, device=args.device)
    print(json.dumps({
        "grid": args.grid,
        "points": len(rows),
        "builds": probe.builds,
        "captures": probe.captures,
        "row_hits": info["row_hits"],
        "warm_start": ws.summary(),
        # float.hex round-trips exactly: bit-exactness on the
        # full-precision metrics, not the table rounding
        "rows": [[row["offload"].hex(), row["rebuffer"].hex()]
                 for row in rows],
    }))
    return 0


def run_child(grid, cache_dir, sizes, device, *, no_row_cache):
    cmd = [sys.executable, "-m", __spec__.name, "--child",
           "--grid", grid, "--cache-dir", cache_dir,
           "--peers", str(sizes["peers"]),
           "--segments", str(sizes["segments"]),
           "--watch-s", str(sizes["watch_s"]),
           "--chunk", str(sizes["chunk"]), "--device", device]
    if no_row_cache:
        cmd.append("--no-row-cache")
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          cwd=_ROOT)
    if proc.returncode != 0:
        raise SystemExit(f"gate child failed ({grid}):\n"
                         f"{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.splitlines()[-1])


def gate_grid(grid, cache_dir, sizes, device):
    """Three child processes for one shipped grid; returns the
    violation list (empty = pass)."""
    cold = run_child(grid, cache_dir, sizes, device, no_row_cache=False)
    warm = run_child(grid, cache_dir, sizes, device, no_row_cache=True)
    rows_on = run_child(grid, cache_dir, sizes, device,
                        no_row_cache=False)

    problems = []
    if warm["builds"] != 0:
        problems.append(f"{grid}: warm (no-row-cache) run started "
                        f"{warm['builds']} nvcc builds — expected 0")
    if warm["captures"] > cold["captures"]:
        problems.append(f"{grid}: warm (no-row-cache) run captured "
                        f"{warm['captures']} graphs, more than the cold "
                        f"run's {cold['captures']}")
    if warm["rows"] != cold["rows"]:
        diverged = sum(1 for a, b in zip(warm["rows"], cold["rows"])
                       if a != b)
        problems.append(f"{grid}: warm rows diverged from cold rows at "
                        f"{diverged}/{len(cold['rows'])} points — the "
                        f"cache must be bit-exact")
    if rows_on["builds"] != 0 or rows_on["captures"] != 0:
        problems.append(f"{grid}: row-cache run started "
                        f"{rows_on['builds']} builds and "
                        f"{rows_on['captures']} captures — expected 0")
    if rows_on["row_hits"] != cold["points"]:
        problems.append(f"{grid}: row-cache run reused "
                        f"{rows_on['row_hits']}/{cold['points']} "
                        f"rows — expected all")
    if rows_on["rows"] != cold["rows"]:
        problems.append(f"{grid}: row-cache rows diverged from cold "
                        f"rows")
    label = "ok" if not problems else "FAIL"
    print(f"warmstart-gate {grid}: cold built {cold['builds']} and "
          f"captured {cold['captures']}, warm run built "
          f"{warm['builds']} and captured {warm['captures']}, row run "
          f"reused {rows_on['row_hits']}/{cold['points']} rows with "
          f"{rows_on['builds']} builds and {rows_on['captures']} "
          f"captures -> {label}")
    return problems


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--grid", choices=("vod", "live"), default="vod")
    ap.add_argument("--cache-dir")
    ap.add_argument("--no-row-cache", action="store_true")
    ap.add_argument("--peers", type=int,
                    default=int(os.environ.get("WARMSTART_GATE_PEERS",
                                               64)))
    ap.add_argument("--segments", type=int, default=int(
        os.environ.get("WARMSTART_GATE_SEGMENTS", 16)))
    ap.add_argument("--watch-s", type=float, default=float(
        os.environ.get("WARMSTART_GATE_WATCH_S", 10.0)))
    ap.add_argument("--chunk", type=int, default=int(
        os.environ.get("WARMSTART_GATE_CHUNK", 24)))
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
    cache_dir = args.cache_dir or tempfile.mkdtemp(
        prefix="warmstart-gate-")
    problems = []
    try:
        # the grids' process chains are independent (their rows have
        # keys of their own): they run side by side
        with ThreadPoolExecutor(2) as pool:
            for found in pool.map(
                    lambda grid: gate_grid(grid, cache_dir, sizes,
                                           args.device), ("vod", "live")):
                problems.extend(found)
    finally:
        if args.cache_dir is None:
            shutil.rmtree(cache_dir, ignore_errors=True)
    for problem in problems:
        print(f"warmstart-gate: {problem}", file=sys.stderr)
    print(f"# warmstart-gate: {'PASS' if not problems else 'FAIL'} "
          f"(both shipped grids, 3 processes each, "
          f"{sizes['peers']} peers, {args.device})", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
