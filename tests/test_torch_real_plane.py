"""The port's copy of the real-protocol plane (the P2P agent, the tracker,
the loopback and TCP wires, the sim player, ``SwarmHarness``), its
widened ``core/abr.py`` and ``engine/telemetry.py``, and the twin's real
half (``testing/twin.py`` ``run_real_plane``) against the reference, in
this process, on the CPU.

- Source equality, one case per copied module: the port's file is the
  reference's after the port's header comment, apart from the lines
  :data:`ALLOWED` lists, each with its reason (:data:`HISTORY`: comments
  that cite the reference's history, reworded).  This stands in for
  copying the reference's unit tests of these modules.
- The widened modules: ``AbrController`` and ``compute_frag_last_kbps``
  give the reference's estimates on a numpy-seeded stream of fragment
  stats, and the hls.js contract numbers hold (128,000 B in 1 s: an
  estimate of 1,024,000 ± 4,000 bps and 1,024 ± 8 kbps); ``Histogram``,
  ``Digest``, the snapshots and deltas and ``JsonlExporter`` give equal
  reads and equal exported lines for the same bumps.
- The real plane against the reference's, exactly (``==`` on the
  frames, floats equal, the fault counts equal), each with a flight
  recorder: ``tests/test_twinframe.py``'s ``SMALL`` (3 + 1 peers, 48
  s), ``SMALL`` with the twin gate's chaos specs, and the population
  gate's crowd + partition scenario, run by the port's population gate
  check 4b itself, which must pass with the partition fired on the wire
  (``mesh.transport_faults{kind=partition}`` ≥ 1).
- The new tools' entry points: every flag of the reference's
  ``tools/control.py`` and ``tools/twin_gate.py`` parsers with its
  default, every ``TWIN_GATE_*`` and ``CONTROL_GATE_*`` knob with its
  default; the port adds ``--device`` (default ``cuda``) and hidden
  child flags only.
"""

import argparse
import ast
import contextlib
import dataclasses
import importlib
import importlib.util
import io
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PKG = os.path.join(ROOT, "hlsjs_p2p_wrapper_tpu")
PORT_PKG = os.path.join(ROOT, "hlsjs_p2p_wrapper_tpu_torch")

#: the copied modules, by their path in either package
COPIED = ("version.py",
          "core/clock.py", "core/errors.py", "core/events.py",
          "core/media_map.py", "core/request_setup.py",
          "core/player_interface.py", "core/loader.py", "core/session.py",
          "core/wrapper.py",
          "engine/cache.py", "engine/cdn.py", "engine/stats.py",
          "engine/cdn_agent.py", "engine/scheduler.py",
          "engine/transport.py", "engine/mesh.py", "engine/p2p_agent.py",
          "engine/tracker.py", "engine/netfaults.py", "engine/net.py",
          "player/manifest.py", "player/sim.py",
          "testing/mock_cdn.py", "testing/fixtures.py",
          "testing/seed_process.py", "testing/swarm.py",
          # widened to the reference's whole module
          "engine/telemetry.py")

#: the lines that may differ, by module: ``(reference line, port line,
#: reason)``
ALLOWED = {
    "core/wrapper.py": [
        ("            from ..engine import default_agent_class",
         "            from ..engine.p2p_agent import P2PAgent",
         "the port's engine/__init__.py re-exports nothing, so that "
         "importing the package stays light"),
        ("            peer_agent_constructor = default_agent_class()",
         "            peer_agent_constructor = P2PAgent",
         "the same: the agent class the reference's default_agent_class "
         "returns")],
    "testing/seed_process.py": [
        ("Run: ``python -m hlsjs_p2p_wrapper_tpu.testing.seed_process",
         "Run: ``python -m hlsjs_p2p_wrapper_tpu_torch.testing.seed_process",
         "the docstring names the module path python -m runs")],
}

#: the reason for the lines of :data:`HISTORY`
HISTORY_REASON = ("the port's copies cite none of the reference's history "
                  "(its rounds, PRs and reviews)")
#: comment lines reworded for :data:`HISTORY_REASON`, by module:
#: ``(reference line, port line)``
HISTORY = {
    'engine/mesh.py': [
        ('        - "spread" (default since round 5): least-loaded + rendezvous',
         '        - "spread" (the default): least-loaded + rendezvous'),
        ('          hash over (my id, holder id, key).  Round 5 re-measured the',
         '          hash over (my id, holder id, key).  A re-measurement of the'),
        ('          round-4 "adaptive" default against the full model (the sim',
         '          earlier "adaptive" default against the full model (the sim'),
        ('        - "ranked": announce order (the round-2 herding behavior,',
         '        - "ranked": announce order (the original herding behavior,')],
    'engine/p2p_agent.py': [
        ('  retries across holders; False restores the round-2 head-holder',
         '  retries across holders; False restores the original head-holder'),
        ('                # "spread" by default (round 5): least-loaded +',
         '                # "spread" by default: least-loaded +'),
        ('                # rendezvous hash + retry rotation.  The round-4',
         '                # rendezvous hash + retry rotation.  The earlier'),
        ('            # round-2 retry behavior (always the head holder) for',
         '            # original retry behavior (always the head holder) for')],
    'engine/tracker.py': [
        ('**Scale (round 9).**  The seed store was one dict-of-dicts behind one',
         '**Scale.**  The seed store was one dict-of-dicts behind one'),
        ('    #: per-SOURCE quotas (round-4 verdict weak #6: the global caps',
         "    #: per-SOURCE quotas (a review's finding #6: the global caps"),
        ('        # live control plane (round 13): per-swarm policy-knob state',
         '        # live control plane: per-swarm policy-knob state'),
        ('        # HA controller pair (round 18): tracker-arbitrated control',
         '        # HA controller pair: tracker-arbitrated control')],
    'engine/netfaults.py': [
        ('The dispatch plane got its chaos reflex in round 5 (engine/faults.py:',
         'The dispatch plane got its chaos reflex first (engine/faults.py:'),
        ('generator in round 9.  The wire had neither: every chaos knob lived in',
         'generator next.  The wire had neither: every chaos knob lived in')],
    'engine/net.py': [
        ("  registered peer's id (previously it could — round-3 VERDICT",
         "  registered peer's id (previously it could — a review's finding"),
        ('  missing #3).  Residual, by the nature of a shared symmetric key: a',
         '  #3).  Residual, by the nature of a shared symmetric key: a'),
        ('- **Every post-handshake frame is MACed** on a PSK fabric (round-4',
         "- **Every post-handshake frame is MACed** on a PSK fabric (a review's"),
        ('  VERDICT missing #1 — DTLS protects every *record*, not just the',
         '  finding #1 — DTLS protects every *record*, not just the'),
        ('    """Self-healing knobs for the TCP fabric (round 10): how a dead',
         '    """Self-healing knobs for the TCP fabric: how a dead'),
        ('        # the self-healing families (round 10): reconnect attempts by',
         '        # the self-healing families: reconnect attempts by'),
        ('        #: self-healing policy (round 10): ``None`` = the default',
         '        #: self-healing policy: ``None`` = the default')],
    'engine/telemetry.py': [
        ('pipelining PR 1 asserted on HLO becomes a measured runtime quantity.',
         'pipelining the dispatch was built for becomes a measured runtime quantity.')],
    'player/sim.py': [
        ('        #: round-4 harness instrumentation: 1-level swarms ran',
         '        #: harness instrumentation: 1-level swarms ran')],
}
for _rel, _pairs in HISTORY.items():
    ALLOWED.setdefault(_rel, []).extend(
        (old, new, HISTORY_REASON) for old, new in _pairs)


def _body(path):
    """The file's lines after its leading header comment."""
    with open(path, encoding="utf-8") as fh:
        lines = fh.read().splitlines()
    n = 0
    while n < len(lines) and lines[n].startswith("#"):
        n += 1
    return lines[n:]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_the_reference(rel):
    with open(os.path.join(PORT_PKG, rel), encoding="utf-8") as fh:
        head = fh.read().splitlines()[0]
    assert head.startswith("# A copy of the reference's "), head
    ref = _body(os.path.join(REF_PKG, rel))
    mine = _body(os.path.join(PORT_PKG, rel))
    assert len(mine) == len(ref)
    diff = [(a, b) for a, b in zip(ref, mine) if a != b]
    assert diff == [(a, b) for a, b, _why in ALLOWED.get(rel, [])]


# -- the widened modules -------------------------------------------------------

def _fragment_stats(rng, n):
    """``n`` fragments' loader stats, one stream made from ``rng``."""
    t = 10_000.0
    out = []
    for _ in range(n):
        wait = float(rng.uniform(0.0, 200.0))
        dur = float(rng.uniform(20.0, 4_000.0))
        loaded = int(rng.integers(1_000, 2_000_000))
        t += wait
        out.append({"trequest": t, "tfirst": t + 5.0, "tload": t + dur,
                    "tbuffered": t + dur + float(rng.uniform(0.0, 50.0)),
                    "loaded": loaded,
                    "length": loaded if rng.random() < 0.5 else None,
                    "level": int(rng.integers(0, 4))})
        t += dur
    return out


def test_abr_controller_equals_the_reference():
    from hlsjs_p2p_wrapper_tpu.core import abr as ref
    from hlsjs_p2p_wrapper_tpu_torch.core import abr as mine
    for name in ("DEFAULT_FAST_HALF_LIFE_S", "DEFAULT_SLOW_HALF_LIFE_S",
                 "DEFAULT_ESTIMATE_BPS", "MIN_SAMPLE_DURATION_MS"):
        assert getattr(mine, name) == getattr(ref, name)
    assert mine.BANDWIDTH_SAFETY == mine.AbrController.BANDWIDTH_SAFETY \
        == ref.AbrController.BANDWIDTH_SAFETY
    levels = [{"bitrate": b} for b in (400_000, 800_000, 1_600_000,
                                       3_200_000)]
    a, b = ref.AbrController(), mine.AbrController()
    assert a.bw_estimator.get_estimate() == b.bw_estimator.get_estimate()
    for stats in _fragment_stats(np.random.default_rng(19), 200):
        frag = {"url": "http://cdn.example/s.ts", "level": stats["level"]}
        for abr in (a, b):
            abr.on_frag_loading({"frag": frag})
            abr.on_frag_loaded({"frag": frag, "stats": stats})
        assert b.bw_estimator.get_estimate() == \
            a.bw_estimator.get_estimate()
        assert b.last_loaded_frag_level == a.last_loaded_frag_level
        assert b.next_level(levels) == a.next_level(levels)
        st = {k: v for k, v in stats.items() if v is not None}
        assert mine.compute_frag_last_kbps(st) == \
            ref.compute_frag_last_kbps(st)


def test_abr_contract_numbers():
    from hlsjs_p2p_wrapper_tpu_torch.core.abr import (AbrController,
                                                      compute_frag_last_kbps)
    abr = AbrController()
    now = 10_000.0
    frag = {"url": "http://foo.bar/foo", "level": 1}
    stats = {"trequest": now - 1000.0, "tload": now, "loaded": 128_000}
    abr.on_frag_loading({"frag": frag})
    abr.on_frag_loaded({"frag": frag, "stats": stats})
    assert abr.bw_estimator.get_estimate() == pytest.approx(1_024_000,
                                                            abs=4_000)
    stats = {"trequest": now - 1000.0, "tfirst": now - 1000.0,
             "tbuffered": now, "loaded": 128_000, "length": 128_000}
    assert compute_frag_last_kbps(stats) == pytest.approx(1024, abs=8)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def now(self):
        return self.t


def _bumps(telemetry, rng):
    """One registry of ``telemetry`` fed a numpy-seeded stream of bumps
    on every instrument kind; its reads and exported lines."""
    reg = telemetry.MetricsRegistry()
    clock = _Clock()
    reads = []
    prev = {}
    for step in range(60):
        clock.t += float(rng.uniform(1.0, 500.0))
        peer = f"p{int(rng.integers(0, 4))}"
        reg.counter("agent.cdn_bytes", peer=peer).inc(
            int(rng.integers(0, 10_000)))
        reg.counter("net.rejects", reason="psk").inc()
        reg.gauge("swarm.peers").set(int(rng.integers(0, 12)))
        reg.histogram("fetch_ms", src="cdn").observe(
            float(rng.exponential(200.0)))
        reg.histogram("rtt_ms", buckets=(1.0, 10.0, 100.0)).observe(
            float(rng.exponential(20.0)))
        reg.digest("slo.fetch_ms", src="p2p").observe(
            float(rng.exponential(300.0)))
        if step % 10 == 9:
            snap = reg.snapshot()
            reads.append((snap, reg.delta(prev),
                          reg.series("agent.cdn_bytes"),
                          reg.histogram("fetch_ms", src="cdn").read(),
                          reg.digest("slo.fetch_ms", src="p2p").read()))
            prev = snap
    reads.append(reg.prune(peer="p1"))
    return reg, clock, reads


def test_telemetry_instruments_equal_the_reference(tmp_path):
    from hlsjs_p2p_wrapper_tpu.engine import telemetry as ref
    from hlsjs_p2p_wrapper_tpu_torch.engine import telemetry as mine
    out = {}
    for name, module in (("ref", ref), ("mine", mine)):
        reg, clock, reads = _bumps(module, np.random.default_rng(7))
        path = tmp_path / f"{name}.jsonl"
        with module.JsonlExporter(reg, clock, str(path)) as exporter:
            exporter.export(round=1)
            clock.t += 10.0
            exporter.export(round=2)
        digest = reg.digest("slo.fetch_ms", src="p2p")
        out[name] = (reads, path.read_text(), digest.count,
                     digest.snapshot().counts, digest.edges,
                     module.overlap_efficiency(1.0, 1.5, 0.75))
    assert out["mine"] == out["ref"]
    assert out["mine"][1].count("\n") == 2


# -- the real plane against the reference's ------------------------------------

def _small(module):
    return module.TwinScenario(n_peers=3, wave_peers=1, wave_at_s=20.5,
                               watch_s=48.0, window_s=8.0)


def _chaos(scenario):
    gate = _tool("twin_gate")
    return dataclasses.replace(
        scenario, fault_specs=gate.CHAOS_SPECS,
        fault_kwargs={"loss_rate": 0.15, "latency_ms": 120.0})


def _tool(name):
    return importlib.import_module(f"hlsjs_p2p_wrapper_tpu_torch.tools.{name}")


def _assert_runs_equal(mine, ref):
    assert mine.registry_frames.as_dict() == ref.registry_frames.as_dict()
    assert mine.event_frames.as_dict() == ref.event_frames.as_dict()
    assert mine.event_frames == mine.registry_frames
    assert mine.offload == ref.offload and mine.rebuffer == ref.rebuffer
    assert mine.transport_faults == ref.transport_faults


@pytest.mark.parametrize("case", ["small", "small_chaos"])
def test_real_plane_equals_the_reference(case, tmp_path):
    from hlsjs_p2p_wrapper_tpu.testing import twin as ref_twin
    from hlsjs_p2p_wrapper_tpu_torch.testing import twin
    runs = {}
    for name, module in (("ref", ref_twin), ("mine", twin)):
        scenario = _small(module)
        if case == "small_chaos":
            scenario = _chaos(scenario)
        runs[name] = module.run_real_plane(
            scenario, trace_dir=str(tmp_path / name))
    _assert_runs_equal(runs["mine"], runs["ref"])
    assert runs["mine"].registry_frames.n_windows == 6
    if case == "small_chaos":
        assert runs["mine"].transport_faults.get("loss", 0) >= 1


def test_population_check_4b_runs_the_real_plane(tmp_path, monkeypatch):
    """The port's population gate check 4b on the crowd + partition
    scenario: its run equals the reference's real plane on the same
    scenario, and it passes with the partition fired on the wire."""
    from hlsjs_p2p_wrapper_tpu.engine.population import (Arrival, Cohort,
                                                         PopulationSpec)
    from hlsjs_p2p_wrapper_tpu.testing import twin as ref_twin
    from hlsjs_p2p_wrapper_tpu_torch.testing import twin
    gate = _tool("population_gate")
    runs = []
    real = twin.run_real_plane

    def recorded(scenario, **kw):
        kw.setdefault("trace_dir", str(tmp_path / "mine"))
        runs.append(real(scenario, **kw))
        return runs[-1]
    monkeypatch.setattr(twin, "run_real_plane", recorded)
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        assert gate.check_real_plane() == []
    assert len(runs) == 1
    fired = runs[0].transport_faults.get("partition", 0)
    assert fired >= 1
    assert f"partition faults {fired}" in stdout.getvalue()

    mine = gate.crowd_scenario()
    spec = mine.population
    ref_spec = PopulationSpec(
        name=spec.name, seed=spec.seed, partitions=spec.partitions,
        cohorts=tuple(Cohort(name=c.name, fraction=c.fraction,
                             arrival=Arrival(kind=c.arrival.kind,
                                             at_s=c.arrival.at_s,
                                             window_s=c.arrival.window_s))
                      for c in spec.cohorts))
    assert ref_spec.to_json() == spec.to_json()
    ref = ref_twin.run_real_plane(
        ref_twin.TwinScenario(seed=mine.seed, n_peers=mine.n_peers,
                              wave_peers=mine.wave_peers,
                              frag_count=mine.frag_count,
                              watch_s=mine.watch_s,
                              window_s=mine.window_s, population=ref_spec),
        trace_dir=str(tmp_path / "ref"))
    _assert_runs_equal(runs[0], ref)


def test_twin_keeps_the_mock_origin_pacing():
    """The sim half's CDN pacing constant is the copied origin's."""
    from hlsjs_p2p_wrapper_tpu_torch.testing import twin
    from hlsjs_p2p_wrapper_tpu_torch.testing.mock_cdn import MockCdnTransport
    assert twin.CDN_CHUNK_MS == MockCdnTransport.CHUNK_MS


# -- the new tools' entry points -----------------------------------------------

class _Parsed(Exception):
    pass


def _reference_parser(name, monkeypatch):
    """The parser the reference tool's ``main()`` builds (caught at its
    ``parse_args``)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    grabbed = {}

    def grab(self, args=None, namespace=None):
        grabbed["ap"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        module.main()
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


#: the hidden flags each port tool adds for its children
HIDDEN = {"control": set(), "twin_gate": {"--real-child"},
          "control_gate": {"--static-child", "--part-b-child"}}


@pytest.mark.parametrize("name", ["control", "twin_gate", "control_gate"])
def test_keeps_every_reference_flag_knob_and_default(name, monkeypatch):
    ref_path = os.path.join(ROOT, "tools", f"{name}.py")
    with open(ref_path) as fh:
        ref_src = fh.read()
    want = (_actions(_reference_parser(name, monkeypatch))
            if "add_argument" in ref_src else {})
    got = _actions(_tool(name).build_parser())
    assert set(got) - set(want) == {"--device"} | HIDDEN[name]
    for flag, spec in want.items():
        assert got[flag] == spec, flag
    assert got["--device"][1] == "cuda"
    for flag in HIDDEN[name]:
        action = next(a for a in _tool(name).build_parser()._actions
                      if flag in a.option_strings)
        assert action.help == argparse.SUPPRESS
    port_path = os.path.join(PORT_PKG, "tools", f"{name}.py")
    assert _env_knobs(port_path) == _env_knobs(ref_path)
    with open(port_path) as fh:
        assert "HLSJS_P2P_TPU_CACHE_DIR" not in fh.read()


def _reference_module(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,constants", [
    ("twin_gate", ("CHAOS_SPECS", "PERTURB_SHIFT_WINDOWS",
                   "REQUIRED_METRICS")),
    ("control_gate", ("CHAOS_SPECS", "CHAOS_KWARGS", "STATIC_KNOBS",
                      "KNOB_GRID", "CONSTRAINT", "BAND_SET"))])
def test_gates_keep_the_reference_constants(name, constants):
    ref, mine = _reference_module(name), _tool(name)
    for constant in constants:
        assert getattr(mine, constant) == getattr(ref, constant), constant
    assert os.path.basename(mine.BANDS_PATH) == "TWIN_r10.json"
    if name == "twin_gate":
        assert dataclasses.asdict(mine.gate_scenarios()[1]) == \
            dataclasses.asdict(ref.gate_scenarios()[1])
        # the port writes none of the reference's files
        assert os.path.basename(mine.FRAMES_OUT) == \
            "TWIN_FRAMES_torch_local.json"
        assert os.path.basename(mine.BANDS_OUT) == "TWIN_torch_local.json"
    else:
        assert dataclasses.asdict(mine.gate_spec()) == \
            dataclasses.asdict(ref.gate_spec())
        mine_cfg = mine.control_config(mine.gate_spec())
        ref_cfg = ref.control_config(ref.gate_spec())
        assert mine_cfg.identity() == ref_cfg.identity()
