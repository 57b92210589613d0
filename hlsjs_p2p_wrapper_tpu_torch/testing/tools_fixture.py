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

#: the port's gates' runs that are held to the reference's: the optimize
#: gate's grid and search children at the gate's defaults (48 peers ×
#: 16 segments × 60 s, chunk 16, ``rebuffer<=0.02``, seed 0; the
#: reference's ``tools/optimize_gate.py`` :128-140), name → (tool,
#: arguments); each writes ``<name>.json``
GATE_RUNS = {
    "optimize_gate_grid": (
        "optimize", ["--peers", "48", "--segments", "16", "--watch-s",
                     "60.0", "--chunk", "16", "--constraint",
                     "rebuffer<=0.02", "--seed", "0", "--driver", "grid",
                     "--budget", "200"]),
    "optimize_gate_search": (
        "optimize", ["--peers", "48", "--segments", "16", "--watch-s",
                     "60.0", "--chunk", "16", "--constraint",
                     "rebuffer<=0.02", "--seed", "0", "--budget",
                     "66.0"]),
}

#: the population gate's reference numbers
#: (``tools/torch_port_tools_fixture.py`` ``population_gate_doc``):
#: check 4's rows at the gate shape (``frontier``: ``mixture`` and
#: ``mean``, each two points' full-precision offload and rebuffer) and
#: check 4b's scenario through the reference's ``run_sim_plane``
#: (``sim_frames``, ``ObservationFrame.as_dict``)
POPULATION_GATE = "population_gate.json"

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


def load_gate(name: str, directory: str = FIXTURE_DIR):
    """The reference's artifact of :data:`GATE_RUNS` run ``name``, or
    the :data:`POPULATION_GATE` document for ``"population_gate"``."""
    file = POPULATION_GATE if name == "population_gate" else f"{name}.json"
    with open(os.path.join(directory, file), encoding="utf-8") as fh:
        return json.load(fh)
