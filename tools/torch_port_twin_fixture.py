"""Write the control plane's reference fixture for the PyTorch port.

The card's machine has no JAX and no reference package, so the twin's
real plane cannot be recorded there, and the reference's decisions
cannot be re-derived there.  This tool runs the JAX reference on the
CPU and writes ``hlsjs_p2p_wrapper_tpu_torch/testing/reference_control/``:

- ``twin_frames.json``: the twin gate's scenario pair
  (``tools/twin_gate.py`` ``gate_scenarios``: 8 + 4 peers, 160 s, the
  chaos one with ``loss@40-70,latency@90-110``), each with its
  real-plane frames (the registry's), the reference's sim-plane frames,
  and the clean scenario's sim frames with the wave shifted by
  ``PERTURB_SHIFT_WINDOWS`` windows;
- ``control_shard.jsonl.gz``: the control gate's recorded chaos shard
  (``tools/control_gate.py`` ``gate_spec``: ``loss@40-120`` at 0.4), as
  ``run_real_plane(gate_spec(), trace_dir=..., extract_events=False)``
  writes it, gzip-compressed with a zero mtime;
- ``control_decisions.json``: two controller configs over that shard
  and the reference's ``ControlLoop`` run of each (no warm start):
  (a) the control gate's (``control_gate.control_config``), (b) the
  SLO-armed one of ``tools/fleet_control_gate.py`` (``controller_spec``
  through ``tools/control.py`` ``load_config``).  Each run keeps its
  decisions as ``decision_sig`` rows (tick, action, trigger, knobs by
  ``float.hex``; ``hlsjs_p2p_wrapper_tpu_torch/testing/
  control_fixture.py``), every tick's forecast rows (offload and rebuffer for
  each lattice point, in lattice order) and the windows at which an
  SLO burn alert fired.

Run it after a change to the reference's twin, controller or simulator:

    JAX_PLATFORMS=cpu python tools/torch_port_twin_fixture.py

(about 30 s on a CPU).  ``tests/test_torch_control_fixture.py`` fails
when the committed files are stale.  The functions below are memoized,
so the port's CPU tests share one recording of each real plane.
"""

from __future__ import annotations

import argparse
import functools
import gzip
import json
import os
import shutil
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tools"))

import control  # noqa: E402
import control_gate  # noqa: E402
import fleet_control_gate  # noqa: E402
import twin_gate  # noqa: E402
from hlsjs_p2p_wrapper_tpu.engine.controller import (  # noqa: E402
    ControlLoop, LogActuator)
from hlsjs_p2p_wrapper_tpu.testing.twin import (  # noqa: E402
    run_real_plane, run_sim_plane)
from hlsjs_p2p_wrapper_tpu_torch.testing.control_fixture import (  # noqa: E402,E501
    decision_sig, forecast_rows, recording, unpack_shard)

OUT_DIR = os.path.join(_REPO, "hlsjs_p2p_wrapper_tpu_torch", "testing",
                       "reference_control")
TWIN_FRAMES = "twin_frames.json"
CONTROL_SHARD = "control_shard.jsonl.gz"
CONTROL_DECISIONS = "control_decisions.json"

#: the scenario fields a fixture records (every field of TwinScenario
#: except the population, which no gate scenario sets)
SPEC_FIELDS = ("seed", "n_peers", "join_spacing_s", "join_offset_s",
               "wave_peers", "wave_at_s", "frag_count", "seg_duration_s",
               "level_bitrates", "cdn_bps", "uplink_bps", "watch_s",
               "window_s", "cdn_latency_ms", "fault_specs",
               "fault_kwargs")


def spec_dict(spec) -> dict:
    out = {f: getattr(spec, f) for f in SPEC_FIELDS}
    out["level_bitrates"] = list(out["level_bitrates"])
    out["fault_kwargs"] = dict(out["fault_kwargs"])
    return out


def config_dict(config) -> dict:
    """A ``ControlConfig`` as JSON: what the port rebuilds it from."""
    c = config.constraint
    return {"spec": spec_dict(config.spec),
            "knob_grid": {k: list(v) for k, v in config.knob_grid.items()},
            "initial_knobs": dict(config.initial_knobs),
            "constraint": [c.metric, c.bound, c.objective],
            "bands": config.bands, "band_set": config.band_set,
            "swarm_id": config.swarm_id,
            "warmup_windows": config.warmup_windows,
            "hysteresis_ticks": config.hysteresis_ticks,
            "forecast_chunk": config.forecast_chunk,
            "slo_specs": config.slo_specs, "cohorts": config.cohorts,
            "slo_warmup_windows": config.slo_warmup_windows}


def run_loop(config, shard_paths, root, tag):
    """The reference's ``ControlLoop`` over ``shard_paths`` with a
    ``LogActuator`` and no warm start, its forecasts recorded
    (``control_fixture.recording``)."""
    loop = recording(ControlLoop)(
        config, shard_paths,
        LogActuator(os.path.join(root, f"actuate-{tag}.jsonl")))
    loop.run_available()
    loop.logged_epochs = loop.actuator.epochs()
    return loop


def loop_record(loop) -> dict:
    burn = [a["window"] for a in (loop.slo.alerts if loop.slo else [])]
    return {"decisions": decision_sig(loop.decisions),
            "forecasts": forecast_rows(loop.forecasts),
            "burn_windows": burn,
            "epochs": loop.logged_epochs}


@functools.lru_cache(maxsize=None)
def twin_planes():
    """The twin gate's clean and chaos scenarios through the reference:
    ``{name: (scenario, real TwinRunResult, sim frame)}``, plus
    ``"perturbed"``: the clean scenario's sim frame with the wave
    shifted by ``twin_gate.PERTURB_SHIFT_WINDOWS`` windows."""
    clean, chaos = twin_gate.gate_scenarios()
    root = tempfile.mkdtemp(prefix="twin-fixture-")
    try:
        out = {}
        for name, scenario in (("clean", clean), ("chaos", chaos)):
            real = run_real_plane(scenario,
                                  trace_dir=os.path.join(root, name))
            if real.event_frames != real.registry_frames:
                raise AssertionError(f"{name}: event frames differ from "
                                     f"the registry's")
            out[name] = (scenario, real, run_sim_plane(scenario))
        shift = twin_gate.PERTURB_SHIFT_WINDOWS * clean.window_s
        out["perturbed"] = run_sim_plane(clean, wave_shift_s=shift)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def twin_frames_doc() -> dict:
    planes = twin_planes()
    return {
        "shift_windows": twin_gate.PERTURB_SHIFT_WINDOWS,
        "scenarios": {
            name: {"scenario": spec_dict(scenario),
                   "real": real.registry_frames.as_dict(),
                   "sim": sim.as_dict()}
            for name, (scenario, real, sim) in (
                (n, planes[n]) for n in ("clean", "chaos"))},
        "perturbed_sim": planes["perturbed"].as_dict()}


def control_configs():
    """Configs (a) and (b), keyed ``"a"`` and ``"b"``."""
    spec = control_gate.gate_spec()
    root = tempfile.mkdtemp(prefix="control-fixture-")
    try:
        fleet = control.load_config(
            fleet_control_gate.controller_spec(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"a": control_gate.control_config(spec), "b": fleet}


def record_control_shard(path: str) -> None:
    """Record the control gate's chaos shard and write it gzipped."""
    root = tempfile.mkdtemp(prefix="control-shard-")
    try:
        observed = run_real_plane(control_gate.gate_spec(),
                                  trace_dir=os.path.join(root, "trace"),
                                  extract_events=False)
        with open(observed.shard_path, "rb") as src:
            data = src.read()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    with open(path, "wb") as raw, gzip.GzipFile(
            fileobj=raw, mode="wb", mtime=0, filename="") as fh:
        fh.write(data)


@functools.lru_cache(maxsize=None)
def control_runs(gz_path: str):
    """The reference's loops over the shard at ``gz_path``: config (a)
    on the one shard, config (b) on the one shard and on its four-way
    split (``split_shard``).  ``{"a": loop, "b": loop, "b4": loop}``."""
    from hlsjs_p2p_wrapper_tpu.testing.twin import split_shard

    configs = control_configs()
    root = tempfile.mkdtemp(prefix="control-runs-")
    try:
        shard = unpack_shard(os.path.join(root, "shard.jsonl"), gz_path)
        quarters = split_shard(shard, os.path.join(root, "mux"), 4)
        return {"a": run_loop(configs["a"], shard, root, "a"),
                "b": run_loop(configs["b"], shard, root, "b"),
                "b4": run_loop(configs["b"], quarters, root, "b4")}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def control_decisions_doc(gz_path: str) -> dict:
    configs = control_configs()
    runs = control_runs(gz_path)
    return {"configs": {k: config_dict(c) for k, c in configs.items()},
            "runs": {k: loop_record(runs[k]) for k in ("a", "b")}}


def write_json(path: str, doc) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--keep-shard", action="store_true",
                    help="re-derive the decisions on the committed shard "
                         "instead of recording a new one")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    write_json(os.path.join(args.out, TWIN_FRAMES), twin_frames_doc())
    gz_path = os.path.join(args.out, CONTROL_SHARD)
    if not (args.keep_shard and os.path.exists(gz_path)):
        record_control_shard(gz_path)
    doc = control_decisions_doc(gz_path)
    b, b4 = control_runs(gz_path)["b"], control_runs(gz_path)["b4"]
    if decision_sig(b.decisions) != decision_sig(b4.decisions):
        raise AssertionError("config (b): four shards and one disagree")
    write_json(os.path.join(args.out, CONTROL_DECISIONS), doc)
    for k, run in doc["runs"].items():
        acts = [d for d in run["decisions"] if d[1] == "actuate"]
        print(f"config ({k}): {len(run['decisions'])} decisions, "
              f"{len(acts)} actuations {[(d[0], d[2]) for d in acts]}, "
              f"burn windows {run['burn_windows']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
