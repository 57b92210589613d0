"""One of the port's tools (``hlsjs_p2p_wrapper_tpu_torch/tools/``) in a
process of its own, started ahead of its run: the child process of
``chip_smoke.py`` phases 42 (the sweep, the A/B and the search), 43
(the fleet, trace, optimize and population gates) and 44 (the twin and
control gates), and every child of those gates (``tools.WaitingTool``:
their workers, roles, searches, digest interpreters, real planes, wire
parts and controller runs), which start with their gate and wait for
their turn.

    python -m hlsjs_p2p_wrapper_tpu_torch.testing.tool_child TOOL [--prepare]

It attaches a ``CompileCounter`` before anything touches the kernels,
imports torch and the tool (with ``--prepare``, a gate, it calls the
gate's ``prepare()``, which starts the gate's own children, waiting),
and prints ``{"ready": ...}``; then it waits,
without a context on the card, for one line on its standard input: a
JSON object with the tool's ``argv`` and the ``env`` entries to set
(the warm-start root, ``HLSJS_P2P_TORCH_CACHE_DIR``).  It runs the
tool's ``main(argv)``, exactly what ``python -m
hlsjs_p2p_wrapper_tpu_torch.tools.TOOL ARGV`` runs, and prints as the
last line of its standard output one JSON object: the tool, its exit
code, the wall from the go to the tool's return, the builds and
captures it made, and the kernel launches it counted (a gate prints its
children's, summed, on its standard error: ``# children's kernels:``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time


#: the tools a child can run
TOOLS = ("sweep", "policy_ab", "optimize", "fleet_gate", "trace_gate",
         "optimize_gate", "population_gate", "control", "twin_gate",
         "control_gate")


def _emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tool", choices=TOOLS)
    ap.add_argument("--prepare", action="store_true",
                    help="call the tool's prepare() before the ready line "
                         "(a gate starts its own children, waiting)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    from ..engine.artifact_cache import CompileCounter
    probe = CompileCounter().attach()

    import torch

    from ..ops import swarm_kernels as sk
    tool = importlib.import_module(f"..tools.{args.tool}", __package__)
    if args.prepare:
        tool.prepare()
    _emit({"ready": True, "tool": args.tool,
           "startup_s": time.perf_counter() - t_start})
    go = json.loads(sys.stdin.readline())
    os.environ.update(go.get("env", {}))

    launches = dict(sk.LAUNCHES)
    t0 = time.perf_counter()
    try:
        rc = tool.main(go["argv"])
    except SystemExit as exc:
        rc = exc.code if isinstance(exc.code, int) else 1
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    probe.detach()
    sys.stdout.flush()
    _emit({"tool": args.tool, "rc": rc, "wall_s": wall,
           "builds": probe.builds, "captures": probe.captures,
           "launches": {k: sk.LAUNCHES[k] - launches[k] for k in launches}})
    return 0 if rc == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
