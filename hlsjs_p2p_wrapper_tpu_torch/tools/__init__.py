"""The port's command-line tools, the counterparts of the reference's
``tools/sweep.py``, ``tools/policy_ab.py``, ``tools/optimize.py``, the
controller service ``tools/control.py``, its gates
(``tools/warmstart_gate.py``, ``tools/chaos_gate.py``,
``tools/fleet_gate.py``, ``tools/trace_gate.py``,
``tools/optimize_gate.py``, ``tools/population_gate.py``,
``tools/twin_gate.py``, ``tools/control_gate.py``) and the trace
consumers (``tools/trace_export.py``, ``tools/fleet_console.py``) on the
port's dispatch (``ops/dispatch.py``) and real-protocol plane.  Each runs as ``python -m
hlsjs_p2p_wrapper_tpu_torch.tools.<name>`` with the reference tool's
flags and defaults, and writes artifacts with the reference's keys and
row order.

The tools that run the simulator add one flag, ``--device`` (``cuda``,
the default, or ``cpu``).  Without a card a tool run without ``--device
cpu`` exits with a message before any work; it never falls back to the
CPU.

What their numbers mean on the port: ``platform`` is ``"gpu"`` on the
card (``"cpu"`` on the CPU) and ``device_kind`` the card's name; the
reference's count of XLA compiles is the port's ``CompileCounter``
(``engine/artifact_cache.py``): ``nvcc`` builds started plus CUDA-graph
captures.  The warm-start root is ``$HLSJS_P2P_TORCH_CACHE_DIR`` (else
``~/.cache/hlsjs_p2p_wrapper_tpu_torch``).  The sweep, the search and
the controller service end with one standard-error line, ``# kernels: {...}``
(:func:`report_kernels`): the builds, captures and kernel launches the
run made, which a gate sums over its children (:func:`kernels_reported`)
and prints as ``# children's kernels: {...}`` (:func:`report_children`).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

#: what a tool's compile count is on the port (the help text and the
#: artifacts' ``compile_groups`` / ``xla_compiles`` say it)
COMPILES_MEANING = ("nvcc builds started plus CUDA-graph captures "
                    "(engine/artifact_cache.py CompileCounter): the "
                    "port's count where the reference counts XLA "
                    "compiles")


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the simulator runs: the card (default) "
                         "or, with 'cpu', the plain PyTorch path; "
                         "without a card, 'cuda' exits with a message "
                         "(no fallback)")


def open_device(ap: argparse.ArgumentParser, name: str) -> torch.device:
    """The tool's device; without a card a ``cuda`` request ends the tool
    through ``ap.error`` (exit 2) before any work."""
    if name == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: the port's tools run on the card by "
                 "default; pass --device cpu to run the plain PyTorch "
                 "path on the CPU")
    return torch.device(name)


def device_identity(dev: torch.device):
    """``(platform, device_kind)`` for an artifact's meta: ``("gpu",
    the card's name)`` or ``("cpu", "cpu")``."""
    if dev.type == "cuda":
        return "gpu", torch.cuda.get_device_name(dev)
    return "cpu", "cpu"


#: the standard-error line that ends a sweep or a search run
KERNELS_LINE = "# kernels: "
#: the standard-error line that ends a gate: its children's counts summed
CHILDREN_LINE = "# children's kernels: "


def launch_counts() -> dict:
    """The process's kernel launches so far (``swarm_kernels.LAUNCHES``,
    counted on the card only)."""
    from ..ops import swarm_kernels
    return dict(swarm_kernels.LAUNCHES)


def report_kernels(probe, launches_before: dict) -> None:
    """Print :data:`KERNELS_LINE` with the builds and captures ``probe``
    (a ``CompileCounter``) counted and the launches since
    ``launches_before``."""
    counts = {"builds": probe.builds, "captures": probe.captures,
              "launches": {k: v - launches_before.get(k, 0)
                           for k, v in launch_counts().items()}}
    print(KERNELS_LINE + json.dumps(counts), file=sys.stderr, flush=True)


def kernels_reported(text: str) -> list:
    """Every :data:`KERNELS_LINE` record in a child's output."""
    return [json.loads(line[len(KERNELS_LINE):])
            for line in text.splitlines() if line.startswith(KERNELS_LINE)]


def report_children(total: dict) -> None:
    """Print :data:`CHILDREN_LINE` with a gate's summed child counts."""
    print(CHILDREN_LINE + json.dumps(total), file=sys.stderr, flush=True)


def add_kernels(total: dict, counts: dict) -> None:
    """Fold one run's counts into ``total``, in place."""
    total["builds"] = total.get("builds", 0) + counts["builds"]
    total["captures"] = total.get("captures", 0) + counts["captures"]
    launches = total.setdefault("launches", {})
    for name, n in counts["launches"].items():
        launches[name] = launches.get(name, 0) + n


class WaitingTool:
    """A port tool in a process of its own, started before its run is
    known (``testing/tool_child.py``: torch and the tool imported, no
    context on the card) and sent its argv later (:meth:`go`), so that a
    gate's children are ready when the gate runs them."""

    def __init__(self, tool: str, cwd: str):
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             f"{__package__.rsplit('.', 1)[0]}.testing.tool_child", tool],
            cwd=cwd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def go(self, argv, env=None) -> None:
        """Send the tool its ``main(argv)`` and the ``env`` entries to
        set first."""
        try:
            self.proc.stdin.write(json.dumps({
                "argv": [str(a) for a in argv], "env": env or {}}) + "\n")
            self.proc.stdin.flush()
        except BrokenPipeError:
            pass

    def wait(self):
        """``(rc, stdout, stderr)`` once the child exits: the tool's exit
        code (the process's where it died before its report, e.g.
        ``-SIGKILL``) and the child's output."""
        out, err = self.proc.communicate()
        report = {}
        lines = out.splitlines()
        if lines and lines[-1].startswith("{"):
            report = json.loads(lines[-1])
        return report.get("rc", self.proc.returncode), out, err

    def run(self, argv, env=None):
        """:meth:`go`, then :meth:`wait`."""
        self.go(argv, env)
        return self.wait()

    def stop(self) -> None:
        """Kill the child if it still runs or waits (its gate failed
        first)."""
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.communicate()


def json_records(text: str) -> list:
    """The JSON-object lines of a child's standard output."""
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def child_report(text: str) -> dict:
    """The report a ``testing/tool_child.py`` child ends its standard
    output with (its tool, exit code, ``wall_s``, builds, captures and
    launches), or ``{}`` when it died before it (a SIGKILL)."""
    records = json_records(text)
    return records[-1] if records and "rc" in records[-1] else {}
