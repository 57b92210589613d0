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
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from hlsjs_p2p_wrapper_tpu_torch.testing.tools_fixture import (  # noqa: E402
    FIXTURE_DIR, NO_WARM_START, RUNS, output_args)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=sorted(RUNS), action="append",
                    help="write only these runs (repeatable)")
    args = ap.parse_args(argv)
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    for name in args.only or sorted(RUNS):
        run_reference(name, FIXTURE_DIR)
        print(f"wrote {name} into {FIXTURE_DIR}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
