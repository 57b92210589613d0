"""The committed reference-tools fixture: the reference's sweep tools run
at a small size on a CPU, their artifacts kept in
``testing/reference_tools/`` (written by ``tools/torch_port_tools_
fixture.py``), so the port's tools are held to them without JAX.

:data:`RUNS` names each run: the tool (a module name under both
``tools/`` and ``hlsjs_p2p_wrapper_tpu_torch/tools/``), its arguments
(the same for the reference and the port; the reference adds
``--no-warm-start`` where it takes it, the port ``--device cpu``), and
whether it writes timelines.  A run writes ``<name>.json`` (``--out``)
and, with timelines, ``<name>.timelines.jsonl`` (``--timelines-out``).
"""

from __future__ import annotations

import json
import os

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "reference_tools")

#: the population spec the mixture sweep reads, from the checkout's root
POPULATION_SPEC = os.path.join("examples",
                               "population_cellular_broadband.json")

_SWEEP = ["--peers", "64", "--segments", "16", "--watch-s", "20",
          "--chunk", "24", "--record-every", "20"]

#: name → (tool, arguments, timelines written)
RUNS = {
    "sweep_vod": ("sweep", _SWEEP, True),
    "sweep_live": ("sweep", _SWEEP + ["--live"], True),
    "sweep_population": ("sweep",
                         _SWEEP + ["--population", POPULATION_SPEC], True),
    "policy_ab": ("policy_ab",
                  ["--peers", "64", "--ring-peers", "64", "--segments",
                   "16", "--watch-s", "16", "--chunk", "20",
                   "--record-every", "16"], True),
    "optimize": ("optimize",
                 ["--peers", "64", "--segments", "16", "--watch-s", "60",
                  "--chunk", "48", "--budget", "66", "--seed", "0"],
                 False),
}

#: the tools that take ``--no-warm-start`` (the reference's executable
#: layer is off for them; its optimize tool has no such flag and gets a
#: throwaway ``--cache-dir``)
NO_WARM_START = ("sweep", "policy_ab")


def output_args(name: str, out_dir: str) -> list:
    """``--out`` (and ``--timelines-out``) for run ``name`` in
    ``out_dir``."""
    _tool, _args, timelines = RUNS[name]
    argv = ["--out", os.path.join(out_dir, f"{name}.json")]
    if timelines:
        argv += ["--timelines-out",
                 os.path.join(out_dir, f"{name}.timelines.jsonl")]
    return argv


def load(name: str, directory: str = FIXTURE_DIR):
    """``(artifact, timelines)`` of run ``name`` in ``directory``:
    the ``--out`` JSON and the timeline records (None without)."""
    with open(os.path.join(directory, f"{name}.json"),
              encoding="utf-8") as fh:
        artifact = json.load(fh)
    timelines = None
    path = os.path.join(directory, f"{name}.timelines.jsonl")
    if RUNS[name][2]:
        with open(path, encoding="utf-8") as fh:
            timelines = [json.loads(line) for line in fh if line.strip()]
    return artifact, timelines
