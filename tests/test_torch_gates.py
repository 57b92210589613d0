"""The port's gates and trace consumers (``hlsjs_p2p_wrapper_tpu_torch/
tools/{fleet_gate,trace_gate,optimize_gate,population_gate,trace_export,
fleet_console}.py``) against the reference's, in this process, on the
CPU.

- Entry points: every flag of the reference's parser, with its default
  and choices, and every ``*_GATE_*`` environment knob with its default,
  is the port's; the gates add ``--device`` (default ``cuda``) and
  nothing else; where the reference reads ``HLSJS_P2P_TPU_CACHE_DIR``
  the port reads ``HLSJS_P2P_TORCH_CACHE_DIR``.  Without a card and
  without ``--device cpu`` a gate exits 2 before any work: no process
  started, no directory made.
- The consumers: the reference's and the port's ``export_dir``,
  ``export_twin_frames``, ``render_frame`` and each console panel give
  equal output (JSON as parsed, frames as text, a fixed ``now``) on the
  control fixture's recorded twin shard, on a hand-written shard with
  every panel's events, and on the twin-frames fixture.
- The population gate: its four specs equal the reference's, the
  example spec's ``population_digest`` at 4,096 peers equals the
  reference's, check 4's rows at the gate shape lie within ``ROW_TOL``
  (1e-4) of the reference's (the committed ``population_gate.json`` of
  ``testing/reference_tools/``; the two specs' offloads sit 0.1699 and
  0.1278 apart, so the bar of 0.05 is nowhere near flipping), and check
  4b's sim-plane frames equal the reference's sim plane on the same
  scenario (peer counts equal, the rest within 1e-5 relative + 1e-6).
"""

import argparse
import ast
import importlib
import importlib.util
import json
import os
import subprocess
import tempfile

import pytest

from hlsjs_p2p_wrapper_tpu_torch.testing import control_fixture as cf
from hlsjs_p2p_wrapper_tpu_torch.testing import tools_fixture as tf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "hlsjs_p2p_wrapper_tpu_torch.tools"
GATES = ("fleet_gate", "trace_gate", "optimize_gate", "population_gate")
CONSUMERS = ("trace_export", "fleet_console")
ROW_TOL = 1e-4
NOW = 1.0e9 + 123.0


def _reference(name):
    """The reference's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _port(name):
    return importlib.import_module(f"{PKG}.{name}")


class _Parsed(Exception):
    pass


def _reference_parser(name, monkeypatch):
    """The parser the reference tool's ``main`` builds (caught at its
    ``parse_args``), or None where the tool takes no flag."""
    with open(os.path.join(ROOT, "tools", f"{name}.py")) as fh:
        if "add_argument" not in fh.read():
            return None
    module = _reference(name)
    grabbed = {}

    def grab(self, args=None, namespace=None):
        grabbed["ap"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        module.main([])
    monkeypatch.undo()
    return grabbed["ap"]


def _actions(ap):
    return {(a.option_strings[0] if a.option_strings else a.dest):
            (a.dest, a.default, a.choices, a.nargs, a.type, a.const)
            for a in ap._actions if a.dest != "help"}


def _env_knobs(path):
    """``{NAME: default}`` of every ``os.environ.get(NAME, default)``."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    knobs = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "get"
                and isinstance(node.func.value, ast.Attribute)
                and node.func.value.attr == "environ"
                and len(node.args) == 2):
            knobs[ast.literal_eval(node.args[0])] = \
                ast.literal_eval(node.args[1])
    return knobs


@pytest.mark.parametrize("name", GATES + CONSUMERS)
def test_keeps_every_reference_flag_knob_and_default(name, monkeypatch):
    ref_ap = _reference_parser(name, monkeypatch)
    want = _actions(ref_ap) if ref_ap is not None else {}
    got = _actions(_port(name).build_parser())
    extra = set(got) - set(want)
    assert extra == ({"--device"} if name in GATES else set())
    for flag, spec in want.items():
        assert got[flag] == spec, flag
    if name in GATES:
        assert got["--device"][1] == "cuda"
    ref_path = os.path.join(ROOT, "tools", f"{name}.py")
    port_path = os.path.join(ROOT, *PKG.split("."), f"{name}.py")
    assert _env_knobs(port_path) == _env_knobs(ref_path)
    with open(ref_path) as fh:
        ref_src = fh.read()
    with open(port_path) as fh:
        port_src = fh.read()
    assert ("HLSJS_P2P_TPU_CACHE_DIR" in ref_src) == \
        ("HLSJS_P2P_TORCH_CACHE_DIR" in port_src)
    assert "HLSJS_P2P_TPU_CACHE_DIR" not in port_src


@pytest.mark.parametrize("gate", GATES)
def test_gate_without_a_card_exits_before_any_work(gate, tmp_path,
                                                   monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))

    def no_process(*_a, **_k):
        raise AssertionError("a child process was started")
    monkeypatch.setattr(subprocess, "Popen", no_process)
    monkeypatch.setattr(subprocess, "run", no_process)
    with pytest.raises(SystemExit) as exc:
        _port(gate).main([])
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


# -- the consumers ------------------------------------------------------------

#: one host's events that reach every panel and track: lease steps (the
#: fabric's and the controller's), a row, fault and cache counters,
#: tracker, control and net counters, control ticks and SLO marks
PANEL_EVENTS = [
    {"kind": "lease", "action": "claim", "unit": 0, "gen": 0,
     "expires_s": NOW + 5.0},
    {"kind": "span", "name": "dispatch", "t_start": NOW - 40.0,
     "dur_s": 0.25, "group": 0, "chunk": 1, "ctx": {"unit": 0}},
    {"kind": "row", "key": "k0", "journaled": True},
    {"kind": "counter", "name": "dispatch_faults",
     "labels": "action=retry,reason=transient", "n": 2},
    {"kind": "counter", "name": "dispatch_faults",
     "labels": "action=bisect,reason=oom", "n": 1},
    {"kind": "counter", "name": "dispatch_faults",
     "labels": "action=giveup,reason=oom", "n": 1},
    {"kind": "counter", "name": "aot_cache_events",
     "labels": "layer=row,result=hit", "n": 3},
    {"kind": "counter", "name": "aot_cache_events",
     "labels": "layer=row,result=miss", "n": 1},
    {"kind": "counter", "name": "twin.fetch_bytes",
     "labels": "peer=p1,src=cdn", "n": 1000},
    {"kind": "counter", "name": "twin.fetch_bytes",
     "labels": "peer=src=p2p,src=p2p", "n": 500},
    {"kind": "counter", "name": "tracker.announces", "labels": "", "n": 4},
    {"kind": "counter", "name": "tracker.lease_expiries", "labels": "",
     "n": 1},
    {"kind": "counter", "name": "net.reconnects",
     "labels": "reason=reset", "n": 2},
    {"kind": "counter", "name": "net.send_drops",
     "labels": "reason=queue_full", "n": 1},
    {"kind": "counter", "name": "net.circuit", "labels": "state=open",
     "n": 1},
    {"kind": "counter", "name": "net.mac_drops", "labels": "", "n": 3},
    {"kind": "counter", "name": "net.handshake_rejects",
     "labels": "reason=psk", "n": 1},
    {"kind": "counter", "name": "net.loop.stalls", "labels": "", "n": 2},
    {"kind": "counter", "name": "control.actuations", "labels": "",
     "n": 1},
    {"kind": "counter", "name": "control.holds",
     "labels": "reason=hysteresis", "n": 2},
    {"kind": "counter", "name": "control.vetoes", "labels": "reason=band",
     "n": 1},
    {"kind": "counter", "name": "control.forecast_rows",
     "labels": "source=cache", "n": 5},
    {"kind": "counter", "name": "control.ticks", "labels": "", "n": 3},
    {"kind": "counter", "name": "control.publish_fenced",
     "labels": "role=standby", "n": 1},
    {"kind": "counter", "name": "control.shadow_applies", "labels": "",
     "n": 2},
    {"kind": "mark", "name": "control_tick", "tick": 2,
     "action": "actuate", "epoch": 1, "headroom": 0.0125, "t_s": 16.0},
    {"kind": "lease", "scope": "ctrl", "action": "claim", "leader": "c0",
     "gen": 3, "ttl_ms": 4000, "knob_epoch": 1},
    {"kind": "mark", "name": "slo_window", "slo": "rebuffer_p95",
     "metric": "rebuffer_ms", "quantile": 0.95, "burn_fast": 2.5,
     "burn_slow": 1.25, "budget_remaining": 0.4, "firing": True},
    {"kind": "mark", "name": "slo_alert", "slo": "rebuffer_p95",
     "metric": "rebuffer_ms", "quantile": 0.95, "window": 4, "t_s": 32.0,
     "burn_fast": 2.5, "burn_slow": 1.25,
     "worst_shard": {"shard": "twin01"}, "worst_cohort": {"cohort": "c1"}},
    {"kind": "mark", "name": "control_tick", "tick": 3, "action": "hold",
     "epoch": 1, "headroom": None, "t_s": 24.0},
]


def _write_panel_shard(trace_dir, host, t_shift):
    os.makedirs(trace_dir, exist_ok=True)
    lines = [{"kind": "meta", "host": host, "run_id": "r0"}]
    for seq, event in enumerate(PANEL_EVENTS):
        lines.append({**event, "host": host, "seq": seq,
                      "t": NOW - 50.0 + t_shift + seq})
    with open(os.path.join(trace_dir, f"{host}.jsonl"), "w") as fh:
        fh.write("".join(json.dumps(line) + "\n" for line in lines))


def _write_claims(fabric_dir):
    """Claim files of four units: done, leased, expired and stolen
    twice over with a duplicate done."""
    claims = os.path.join(fabric_dir, "claims")
    os.makedirs(claims)
    units = {
        "u0000.jsonl": [{"kind": "claim", "host": "h0", "gen": 0,
                         "expires_s": NOW - 10.0},
                        {"kind": "done", "host": "h0", "gen": 0,
                         "rows": 6}],
        "u0001.jsonl": [{"kind": "claim", "host": "h1", "gen": 0,
                         "expires_s": NOW + 1.0},
                        {"kind": "beat", "host": "h1", "gen": 0,
                         "expires_s": NOW + 3.5}],
        "u0002.jsonl": [{"kind": "claim", "host": "h2", "gen": 0,
                         "expires_s": NOW - 2.0}],
        "u0003.jsonl": [{"kind": "claim", "host": "h1", "gen": 0,
                         "expires_s": NOW - 9.0},
                        {"kind": "claim", "host": "h0", "gen": 1,
                         "expires_s": NOW - 3.0},
                        {"kind": "done", "host": "h0", "gen": 1,
                         "rows": 6},
                        {"kind": "done", "host": "h1", "gen": 0,
                         "rows": 6}],
    }
    for name, records in units.items():
        with open(os.path.join(claims, name), "w") as fh:
            fh.write("".join(json.dumps(r) + "\n" for r in records))


@pytest.fixture(scope="module")
def consumer_inputs(tmp_path_factory):
    """A trace dir of two hand-written shards, a fabric dir of claim
    files, and the control fixture's recorded twin shard in a dir."""
    tmp = tmp_path_factory.mktemp("consumers")
    panels = str(tmp / "panels")
    _write_panel_shard(panels, "host00", 0.0)
    _write_panel_shard(panels, "host01", 0.5)
    fabric = str(tmp / "fabric")
    _write_claims(fabric)
    twin = str(tmp / "twin")
    os.makedirs(twin)
    cf.unpack_shard(os.path.join(twin, "twin00.jsonl"))
    return {"panels": panels, "fabric": fabric, "twin": twin}


@pytest.mark.parametrize("source", ["panels", "twin"])
def test_trace_export_equals_the_reference(consumer_inputs, source):
    ref = _reference("trace_export").export_dir(consumer_inputs[source])
    mine = _port("trace_export").export_dir(consumer_inputs[source])
    assert json.loads(json.dumps(mine)) == json.loads(json.dumps(ref))
    assert mine["traceEvents"]


def test_twin_frames_export_equals_the_reference():
    doc = cf.load_json(cf.TWIN_FRAMES)
    ref = _reference("trace_export").export_twin_frames(doc)
    mine = _port("trace_export").export_twin_frames(doc)
    assert mine == ref and len(mine) > 100


def test_trace_export_main_writes_the_reference_file(consumer_inputs,
                                                     tmp_path):
    argv = [consumer_inputs["panels"], "--twin-frames", cf.TWIN_FRAMES]
    assert _reference("trace_export").main(
        argv + ["--out", str(tmp_path / "ref.json")]) == 0
    assert _port("trace_export").main(
        argv + ["--out", str(tmp_path / "port.json")]) == 0
    with open(tmp_path / "ref.json") as a, open(tmp_path / "port.json") as b:
        assert json.load(a) == json.load(b)


PANELS = ("read_units", "host_activity", "twin_panel", "control_panel",
          "slo_panel", "net_panel")


@pytest.mark.parametrize("panel", PANELS)
def test_console_panel_equals_the_reference(consumer_inputs, panel):
    from hlsjs_p2p_wrapper_tpu_torch.engine.tracer import merge_trace
    events = merge_trace(consumer_inputs["panels"])
    args = {"read_units": (consumer_inputs["fabric"],),
            "host_activity": (events, NOW),
            "twin_panel": (cf.TWIN_FRAMES,)}.get(panel, (events,))
    ref = getattr(_reference("fleet_console"), panel)(*args)
    mine = getattr(_port("fleet_console"), panel)(*args)
    assert mine == ref and mine


@pytest.mark.parametrize("trace", ["panels", "twin"])
def test_console_frame_equals_the_reference(consumer_inputs, trace):
    kw = dict(fabric_dir=consumer_inputs["fabric"],
              trace_dir=consumer_inputs[trace], now=NOW,
              twin_path=cf.TWIN_FRAMES, control=True, slo=True, net=True)
    ref = _reference("fleet_console").render_frame(**kw)
    mine = _port("fleet_console").render_frame(**kw)
    assert mine == ref
    assert "units done" in mine and "twin clean" in mine


# -- the population gate -------------------------------------------------------

SPECS = ("degenerate_spec", "mixture_spec", "homogeneous_mean_spec",
         "crowd_partition_spec")


def test_population_specs_equal_the_reference():
    ref, mine = _reference("population_gate"), _port("population_gate")
    for name in SPECS:
        assert getattr(mine, name)().to_json() == \
            getattr(ref, name)().to_json(), name
    assert mine.FRONTIER_BAR == ref.FRONTIER_BAR == 0.05


def test_population_digest_equals_the_reference():
    from hlsjs_p2p_wrapper_tpu.engine import population as ref_pop
    from hlsjs_p2p_wrapper_tpu_torch.engine import population as pop
    kw = dict(n_levels=3, default_uplink_bps=2.4e6, default_cdn_bps=1.2e6)
    mine = pop.materialize(pop.load_spec(_port("population_gate")
                                         .EXAMPLE_SPEC), 4096, **kw)
    ref = ref_pop.materialize(ref_pop.load_spec(_reference("population_gate")
                                                .EXAMPLE_SPEC), 4096, **kw)
    assert pop.population_digest(mine) == ref_pop.population_digest(ref)
    assert mine.cohort_counts() == ref.cohort_counts()


def test_population_frontier_rows_within_tolerance_of_the_reference():
    gate = _port("population_gate")
    doc = tf.load_gate("population_gate")
    args = gate.build_parser().parse_args(["--device", "cpu"])
    sizes = gate.gate_sizes(args)
    assert doc["grid"] == gate.frontier_grid()
    assert (doc["sizes"]["peers"], doc["sizes"]["segments"],
            doc["sizes"]["watch_s"], doc["sizes"]["chunk"],
            doc["sizes"]["stagger_s"]) == (
        sizes["peers"], sizes["segments"], sizes["frontier_watch_s"],
        sizes["chunk"], sizes["frontier_stagger_s"])
    rows_mix, rows_mean = gate.frontier_rows(sizes, "cpu")
    for key, rows in (("mixture", rows_mix), ("mean", rows_mean)):
        for (off, reb), row in zip(doc["frontier"][key], rows):
            assert abs(row["offload"] - off) <= ROW_TOL, key
            assert abs(row["rebuffer"] - reb) <= ROW_TOL, key
    deltas = [abs(m["offload"] - h["offload"])
              for m, h in zip(rows_mix, rows_mean)]
    assert max(deltas) >= gate.FRONTIER_BAR + 2 * ROW_TOL


def test_population_sim_plane_frames_equal_the_reference():
    from hlsjs_p2p_wrapper_tpu_torch.engine.twinframe import ObservationFrame
    from hlsjs_p2p_wrapper_tpu_torch.testing.twin import run_sim_plane
    gate = _port("population_gate")
    ref = ObservationFrame.from_dict(
        tf.load_gate("population_gate")["sim_frames"])
    frames = run_sim_plane(gate.crowd_scenario(), device="cpu")
    assert cf.frames_agree(frames, ref) == []
    assert frames.n_windows == gate.crowd_scenario().n_windows
    assert max(frames.column("present_peers")) == \
        gate.crowd_scenario().total_peers
