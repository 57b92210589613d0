"""Write the reference-tools fixture for the PyTorch port.

The card's machine has no JAX, and the port's tools
(``hlsjs_p2p_wrapper_tpu_torch/tools/``) are held on the CPU to what the
reference's tools write.  This tool runs the reference's
``tools/sweep.py`` (the VOD grid, the live grid and the mixture grid of
``examples/population_cellular_broadband.json``), ``tools/policy_ab.py``
and ``tools/optimize.py`` at the small sizes of
``hlsjs_p2p_wrapper_tpu_torch/testing/tools_fixture.py`` (``RUNS``), each
in a process of its own with ``JAX_PLATFORMS=cpu``, the sweep tools with
``--no-warm-start`` and the search on a throwaway ``--cache-dir``, and
writes their artifacts (``--out``, and ``--timelines-out`` where the
run records timelines) into
``hlsjs_p2p_wrapper_tpu_torch/testing/reference_tools/``.

Run it after a change to the reference's tools or simulator:

    JAX_PLATFORMS=cpu python tools/torch_port_tools_fixture.py [--only NAME]

(a few minutes on a CPU, most of it XLA compiles).
``tests/test_torch_tools.py`` re-runs the cheapest run and fails when the
committed files are stale.

Beside them it writes the reference's numbers that the port's gates are
held to (``tests/test_torch_gates.py``, ``tests/test_torch_gates_
process.py``): the optimize gate's grid and search children at its
defaults (``GATE_RUNS``, ~25 s) and the population gate's check 4 rows
and check 4b sim frames (``population_gate.json``, ~20 s).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from hlsjs_p2p_wrapper_tpu_torch.testing.tools_fixture import (  # noqa: E402
    FIXTURE_DIR, GATE_RUNS, NO_WARM_START, POPULATION_GATE, RUNS,
    output_args)


def reference_command(name: str, out_dir: str, cache_dir: str) -> list:
    """The reference tool's command line for run ``name``, writing into
    ``out_dir``."""
    tool, args, _timelines = RUNS[name]
    cmd = [sys.executable, os.path.join(_REPO, "tools", f"{tool}.py"),
           *args, *output_args(name, out_dir)]
    if tool in NO_WARM_START:
        cmd.append("--no-warm-start")
    else:
        cmd += ["--cache-dir", cache_dir]
    return cmd


def run_reference(name: str, out_dir: str, env=None) -> None:
    """Run the reference tool of ``name`` into ``out_dir``; raises with
    its output when it fails."""
    cache_dir = tempfile.mkdtemp(prefix="tools-fixture-")
    try:
        proc = subprocess.run(
            reference_command(name, out_dir, cache_dir),
            capture_output=True, text=True, cwd=_REPO,
            env=dict(os.environ if env is None else env,
                     JAX_PLATFORMS="cpu"))
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    if proc.returncode != 0:
        raise RuntimeError(f"reference {name} failed "
                           f"(exit {proc.returncode}):\n{proc.stderr}")


def run_gate_reference(name: str, out_dir: str) -> None:
    """Run the reference tool of :data:`GATE_RUNS` run ``name`` on a
    throwaway cache root, writing ``<name>.json`` into ``out_dir``."""
    tool, args = GATE_RUNS[name]
    cache_dir = tempfile.mkdtemp(prefix="tools-fixture-")
    try:
        proc = subprocess.run(
            [sys.executable, os.path.join(_REPO, "tools", f"{tool}.py"),
             *args, "--cache-dir", cache_dir,
             "--out", os.path.join(out_dir, f"{name}.json")],
            capture_output=True, text=True, cwd=_REPO,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    if proc.returncode != 0:
        raise RuntimeError(f"reference {name} failed "
                           f"(exit {proc.returncode}):\n{proc.stderr}")


def population_gate_doc() -> dict:
    """The reference population gate's check 4 rows at its defaults (64
    peers × 16 segments, the frontier's 20-s watch over an 8-s join
    stagger, chunk 24) and check 4b's scenario through the reference's
    sim plane (``testing/twin.py`` ``run_sim_plane``)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    import population_gate as ref_gate
    from hlsjs_p2p_wrapper_tpu.testing.twin import (TwinScenario,
                                                    run_sim_plane)
    sizes = {"peers": 64, "segments": 16, "watch_s": 20.0, "chunk": 24}
    grid = [dict(degree=8, ladder="hd", spread_s=0.0,
                 urgent_margin_s=u, budget_cap_ms=6_000.0,
                 uplink_mbps=2.2, cdn_mbps=1.2)
            for u in (0.5, 4.0)]
    frontier = {}
    for key, spec in (("mixture", ref_gate.mixture_spec()),
                      ("mean", ref_gate.homogeneous_mean_spec())):
        rows, _info = ref_gate.run_rows(grid, sizes, live=False,
                                        stagger_s=8.0, population=spec)
        frontier[key] = [[r["offload"], r["rebuffer"]] for r in rows]
    spec = ref_gate.crowd_partition_spec()
    scenario = TwinScenario(seed=spec.seed, n_peers=8, wave_peers=4,
                            frag_count=20, watch_s=64.0, window_s=8.0,
                            population=spec)
    return {"sizes": {**sizes, "stagger_s": 8.0}, "grid": grid,
            "frontier": frontier,
            "sim_frames": run_sim_plane(scenario).as_dict()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", action="append",
                    choices=sorted(RUNS) + sorted(GATE_RUNS)
                    + ["population_gate"],
                    help="write only these runs (repeatable)")
    args = ap.parse_args(argv)
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    for name in args.only or (sorted(RUNS) + sorted(GATE_RUNS)
                              + ["population_gate"]):
        if name in RUNS:
            run_reference(name, FIXTURE_DIR)
        elif name in GATE_RUNS:
            run_gate_reference(name, FIXTURE_DIR)
        else:
            with open(os.path.join(FIXTURE_DIR, POPULATION_GATE), "w",
                      encoding="utf-8") as fh:
                json.dump(population_gate_doc(), fh, indent=1)
                fh.write("\n")
        print(f"wrote {name} into {FIXTURE_DIR}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
