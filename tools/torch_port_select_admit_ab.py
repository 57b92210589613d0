"""Time ``select_admit`` as several checkouts build it, on the same states,
on the card.

Builds the step source (``csrc/swarm_step.cu``) of this checkout and of
each ``--other`` checkout into a library of its own, with this checkout's
``nvcc`` flags and macros (``ops/_build.py``, ``swarm_kernels.DEFINES``)
plus any ``--define``, all ``nvcc`` runs started together, and binds each
(``swarm_kernels.bind``: the argument structs must agree).  Then, on each
state, every build's ``select_admit`` is held to ``select_admit_plain``
(``chip_smoke.compare_select_admit``: integers and the state to the bit)
and timed with ``chip_smoke.back_to_back`` (200 launches between CUDA
events), the builds in turns, forward then backward.
The states: the final states of the lane batches that
``tools/torch_port_kernel_times.py`` times (the 48-point VOD grid, the live
grid's first 64 points, the ring's 20 cells under each holder policy),
reached as replayed CUDA graphs with this checkout's kernels, and the main
path's ring at 262,144 peers x 256 segments after MAIN_STEPS steps of
``run_swarm``.  One JSON line a state, after the card's name and power
limit; each build's registers and spills from ``ptxas`` first.

Run on the card from the root of a checkout:
``python3 tools/torch_port_select_admit_ab.py --other DIR [--other DIR ...]
[--define NAME=VALUE ...] [--only VOD,main]``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
#: ``run_swarm`` steps to the main path's state
MAIN_STEPS = 1200


def build_all(checkouts, defines, out_dir):
    """``{label: (library path, ptxas lines)}``, one ``nvcc`` each,
    started together."""
    from hlsjs_p2p_wrapper_tpu_torch.ops import _build
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for label, root in checkouts.items():
        out = os.path.join(out_dir, f"libswarm_step_ab{len(procs)}.so")
        src = os.path.join(root, "hlsjs_p2p_wrapper_tpu_torch", "csrc",
                           "swarm_step.cu")
        procs[label] = (out, subprocess.Popen(
            [_build.nvcc_path(), *_build.flags(defines), "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for label, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        built[label] = (out, log.splitlines())
    return built


def states(cs, sim, sk, sg, pg, kt, only):
    """``(label, config, scenario, state)`` of each state, built when its
    turn comes."""
    import numpy as np
    for label, make in kt.batches(cs, sim, sg, pg):
        if only and not any(o in label for o in only):
            continue
        config, scenario = make()
        B = scenario.join_s.shape[0]
        n_steps = int(cs.GRID_WATCH_S * 1000.0 / config.dt_ms)
        init = sim.init_swarm(config, device="cuda", batch=B)
        _wall, _cap, (final, _series) = cs.timed_run(
            sim, sk, config, scenario, init, n_steps, "graph")
        del init, _series
        yield label, config, scenario, final
    if only and "main" not in only:
        return
    P, S = cs.PEERS, cs.SEGMENTS
    config = sim.SwarmConfig(n_peers=P, n_segments=S, n_levels=3,
                             neighbor_offsets=sim.ring_offsets(cs.DEGREE))
    cdn = np.full((P,), 8e6, np.float32)
    join = sim.staggered_joins(P, 60.0, device="cuda")
    final, _series = sim.run_swarm(config, cs.BITRATES, None, cdn,
                                   sim.init_swarm(config, device="cuda"),
                                   MAIN_STEPS, join, device="cuda")
    scenario = sim.make_scenario(config, cs.BITRATES, None, cdn, join,
                                 device="cuda")
    yield f"main path, {MAIN_STEPS} steps", config, scenario, final


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another checkout's root (repeatable)")
    ap.add_argument("--define", action="append", default=[],
                    help="an extra NAME=VALUE macro for every build")
    ap.add_argument("--only", default="",
                    help="comma-separated substrings of the states to run "
                         "(VOD, live, spread, adaptive, ranked, main)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_port_select_admit_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import torch_port_kernel_times as kt
    from hlsjs_p2p_wrapper_tpu_torch import policy_grid as pg
    from hlsjs_p2p_wrapper_tpu_torch import sweep_grid as sg
    from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_kernels as sk
    from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as sim
    print(cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]), flush=True)
    defines = sk.DEFINES + tuple(
        (d.split("=")[0], d.split("=")[1]) for d in args.define)
    checkouts = {"this": ROOT}
    for root in args.other:
        checkouts[os.path.abspath(root)] = os.path.abspath(root)
    built = build_all(checkouts, defines,
                      os.path.join(ROOT, "build", "torch_kernels", "ab"))
    libs = {}
    for label, (path, log) in built.items():
        libs[label] = sk.bind(ctypes.CDLL(path))
        regs = cs.kernel_registers(ln for ln in log
                                   if "ptxas" in ln or "spill" in ln)
        print(json.dumps({"build": label, "select_admit": {
            k: v for k, v in regs.items() if "select_admit_kernel" in k}}),
            flush=True)
    sk.build_kernels()
    own = sk._lib
    current = {"label": "this"}

    def chosen(source):
        return libs[current["label"]] if source == sk.SOURCE else own(source)

    only = [o for o in args.only.split(",") if o]
    for label, config, scenario, final in states(cs, sim, sk, sg, pg, kt,
                                                 only):
        sk._lib = chosen
        try:
            for name in libs:
                current["label"] = name
                cs.compare_select_admit(sim, sk, config, scenario, final,
                                        f"{label}, {name}")
            ms = {name: [] for name in libs}
            order = list(libs) + list(libs)[::-1]
            st = sim.clone_state(final)
            for name in order:
                current["label"] = name
                ms[name].append(cs.back_to_back(
                    lambda x: sk.select_admit(config, scenario, x), st))
        finally:
            sk._lib = own
        lanes = final.t_s.shape[0] if final.t_s.dim() else 1
        print(json.dumps({"state": label, "lanes": lanes, "ms": ms}),
              flush=True)
        del final, st, scenario
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
