"""The control plane's committed reference fixture
(``testing/reference_control/``, written by
``tools/torch_port_twin_fixture.py`` from the JAX reference on a CPU)
and what the port is held to it with, on a machine without JAX:

- ``twin_frames.json``: the twin gate's clean and chaos scenarios
  (``tools/twin_gate.py``), each with the reference's real-plane and
  sim-plane frames, and the clean sim with the wave shifted;
- ``control_shard.jsonl.gz``: the control gate's recorded chaos shard
  (``tools/control_gate.py``);
- ``control_decisions.json``: two controller configs, (a) the control
  gate's and (b) the SLO-armed one of ``tools/fleet_control_gate.py``,
  with the reference's decisions on that shard (:func:`decision_sig`),
  every tick's forecast rows and the windows an SLO burn fired at.

:func:`recording` keeps a loop's forecast trials; :func:`frames_agree`
holds one sim frame to another; :func:`decision_margins` measures how
far a tick's forecasts sit from changing its decision.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import List

from ..engine.search import Constraint, rank_key

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "reference_control")
TWIN_FRAMES = os.path.join(DIR, "twin_frames.json")
CONTROL_SHARD = os.path.join(DIR, "control_shard.jsonl.gz")
CONTROL_DECISIONS = os.path.join(DIR, "control_decisions.json")

#: a port forecast against the reference's: the whole-run tolerance of
#: the simulator's parity tests (tests/test_torch_swarm_sim.py RUN_TOL)
FORECAST_TOL = 1e-4
#: frame columns that count peers: equal between two sim planes
INT_COLUMNS = ("present_peers", "joins", "leaves", "stalled_peers")
#: every other frame column between two sim planes: float32 sums in
#: another order (the timeline's tolerance)
FRAME_RTOL, FRAME_ATOL = 1e-5, 1e-6


def load_json(path: str):
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def unpack_shard(out_path: str, gz_path: str = CONTROL_SHARD) -> str:
    """The committed shard, unpacked to ``out_path``."""
    with gzip.open(gz_path, "rb") as src, open(out_path, "wb") as dst:
        dst.write(src.read())
    return out_path


def scenario_from_dict(d: dict):
    from .twin import TwinScenario
    d = dict(d)
    d["level_bitrates"] = tuple(d["level_bitrates"])
    return TwinScenario(**d)


def config_from_dict(d: dict):
    """A ``ControlConfig`` of the port from the fixture's JSON."""
    from ..engine.controller import ControlConfig
    return ControlConfig(
        spec=scenario_from_dict(d["spec"]),
        knob_grid={k: list(v) for k, v in d["knob_grid"].items()},
        initial_knobs=dict(d["initial_knobs"]),
        constraint=Constraint(*d["constraint"]), bands=d["bands"],
        band_set=d["band_set"], swarm_id=d["swarm_id"],
        warmup_windows=d["warmup_windows"],
        hysteresis_ticks=d["hysteresis_ticks"],
        forecast_chunk=d["forecast_chunk"], slo_specs=d["slo_specs"],
        cohorts=d["cohorts"], slo_warmup_windows=d["slo_warmup_windows"])


def decision_sig(decisions):
    """The bit-exactness surface two controllers agree on: tick,
    action, trigger, knobs by ``float.hex`` (as lists, so that it
    survives JSON)."""
    return [[d["tick"], d["action"], d.get("trigger"),
             [[k, float(v).hex()] for k, v in sorted(d["knobs"].items())]]
            for d in decisions]


def recording(loop_cls):
    """``loop_cls`` (the port's ``ControlLoop`` or the reference's) with
    each tick's forecast trials kept in ``.forecasts`` as ``{"tick",
    "trials"}``: the tick is the decision count, which is the window on
    a loop that did not resume a prefix."""
    class Recording(loop_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.forecasts = []

        def _forecast(self, group):
            trials = super()._forecast(group)
            self.forecasts.append({"tick": len(self.decisions),
                                   "trials": trials})
            return trials
    return Recording


def forecast_rows(forecasts):
    """Each tick's trials as ``[tick, [[offload, rebuffer], ...]]``, in
    lattice order."""
    return [[f["tick"], [[t["offload"], t["rebuffer"]]
                         for t in f["trials"]]]
            for f in forecasts]


def forecast_error(rows, ref_rows) -> float:
    """The largest difference between two :func:`forecast_rows` lists;
    infinite when their ticks differ."""
    if [r[0] for r in rows] != [r[0] for r in ref_rows]:
        return float("inf")
    return max((abs(a - b) for (_t, got), (_u, ref) in zip(rows, ref_rows)
                for pa, pb in zip(got, ref) for a, b in zip(pa, pb)),
               default=0.0)


def frames_agree(frame, ref) -> List[str]:
    """Where a sim frame departs from another: its columns and windows,
    its peer counts (:data:`INT_COLUMNS`) unequal, any other column out
    of ``FRAME_RTOL * |ref| + FRAME_ATOL``.  Empty when they agree."""
    if frame.columns != ref.columns or frame.n_windows != ref.n_windows:
        return [f"shape {frame.columns} x {frame.n_windows} against "
                f"{ref.columns} x {ref.n_windows}"]
    out = []
    for j, name in enumerate(ref.columns):
        for w, (row, ref_row) in enumerate(zip(frame.samples,
                                               ref.samples)):
            a, b = float(row[j]), float(ref_row[j])
            if name in INT_COLUMNS:
                bad = a != b
            else:
                bad = abs(a - b) > FRAME_RTOL * abs(b) + FRAME_ATOL
            if bad:
                out.append(f"{name} at window {w}: {a!r} against {b!r}")
                break
    return out


def decision_margins(trials, current_knobs, constraint, bands) -> dict:
    """How far one tick's forecasts sit from changing its decision:
    ``feasible``, the least distance of a candidate's constrained
    metric from the bound; ``rank``, the gap between the best candidate
    and the runner-up on the first component of the rank key that tells
    them apart; ``band``, when the best candidate is not the current
    config, the gap between the deciding delta and its band half-width
    (``decide_tick``'s rule).  A forecast error under half the least of
    them cannot change the decision."""
    ok = [t for t in trials if not t.get("failed")]
    ranked = sorted(ok, key=lambda t: rank_key(t, constraint))
    best = ranked[0]
    current = next(t for t in trials if t["knobs"] == current_knobs)
    out = {"feasible": min(abs(t[constraint.metric] - constraint.bound)
                           for t in ok)}
    if len(ranked) > 1:
        a = rank_key(ranked[0], constraint)
        b = rank_key(ranked[1], constraint)
        out["rank"] = (out["feasible"] if a[0] != b[0] else
                       next((abs(x - y) for x, y in zip(a[1:], b[1:])
                             if x != y), 0.0))
    if best["knobs"] != current_knobs:
        if constraint.feasible(best) and constraint.feasible(current):
            metric = constraint.objective
            delta = best[metric] - current[metric]
        else:
            metric = constraint.metric
            delta = (constraint.violation(current)
                     - constraint.violation(best))
        band = bands.get(metric, {})
        half = (float(band.get("atol", 0.0)) + float(band.get("rtol", 0.0))
                * max(abs(best[metric]), abs(current[metric])))
        out["band"] = abs(delta - half)
    return out


def run_margins(config: dict, run: dict) -> List[dict]:
    """:func:`decision_margins` of every forecast tick of a fixture run
    (``control_decisions.json``'s ``configs[k]`` and ``runs[k]``), the
    current knobs at each tick read from the decision before it."""
    constraint = Constraint(*config["constraint"])
    points = config_from_dict(config).lattice()
    decisions = run["decisions"]
    out = []
    for tick, rows in run["forecasts"]:
        current = (dict(config["initial_knobs"]) if tick == 0 else
                   {k: float.fromhex(v) for k, v in decisions[tick - 1][3]})
        trials = [{"knobs": knobs, "offload": r[0], "rebuffer": r[1]}
                  for knobs, r in zip(points, rows)]
        out.append(dict(decision_margins(trials, current, constraint,
                                         config["bands"]), tick=tick))
    return out
