"""The port's tools (``hlsjs_p2p_wrapper_tpu_torch/tools/``) against the
reference's, and against the port's own library path, on the CPU.

The reference side is the committed fixture
(``hlsjs_p2p_wrapper_tpu_torch/testing/reference_tools/``, written by
``tools/torch_port_tools_fixture.py``): the reference's ``tools/sweep.py``
(VOD, live, mixture), ``tools/policy_ab.py`` and ``tools/optimize.py``
at the small sizes of ``testing/tools_fixture.RUNS``.  The port's tools
run those same arguments with ``--device cpu``, each in a process of its
own, side by side.

- Against the fixture: the knobs, the row order and the ``meta`` key
  sets are equal; offload and rebuffer within ``ROW_TOL`` (1e-4);
  timelines within ``TIMELINE_RTOL`` (1e-5) relative; the search's trials
  (points, fidelities, knobs, feasibility) and its frontier equal.  The
  search's closest decision is ≥ 3.80e-4 from flipping (the halving
  promotion's boundary; the feasibility bound is 1.87e-3 away, the best
  trial 4.00e-2 ahead, the Pareto set's closest pair 4.24e-4 apart),
  more than twice ``ROW_TOL``; its ties are between points whose knobs
  do not bind, whose rows are the same bits.
- Against the library path: each tool's rows equal, to the bit, what
  ``ops/dispatch.py`` gives for the same grid, seed and chunk
  (``sweep_grid``, ``policy_grid``, ``search_eval`` with
  ``engine.search.PolicySearch``), and ``--sequential`` equals the
  batched engine.
- The cost models ``step_flops``, ``step_hbm_breakdown`` and
  ``step_hbm_bytes`` equal the reference's.
- Staleness: the cheapest reference run (the VOD sweep) re-run equals
  the fixture.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import hlsjs_p2p_wrapper_tpu.ops.swarm_sim as ref_sim
import hlsjs_p2p_wrapper_tpu_torch.ops.swarm_sim as sim
from hlsjs_p2p_wrapper_tpu_torch import policy_grid as pg
from hlsjs_p2p_wrapper_tpu_torch import search_eval as se
from hlsjs_p2p_wrapper_tpu_torch import sweep_grid as sg
from hlsjs_p2p_wrapper_tpu_torch.engine.artifact_cache import WarmStart
from hlsjs_p2p_wrapper_tpu_torch.engine.faults import FaultPolicy
from hlsjs_p2p_wrapper_tpu_torch.engine.population import load_spec
from hlsjs_p2p_wrapper_tpu_torch.engine.search import (
    Constraint, PolicySearch, rank_key, scrub_provenance)
from hlsjs_p2p_wrapper_tpu_torch.ops import dispatch as dp
from hlsjs_p2p_wrapper_tpu_torch.testing import tools_fixture as tf
from hlsjs_p2p_wrapper_tpu_torch.tools import sweep as sweep_tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_TOL = 1e-4
TIMELINE_RTOL = 1e-5
#: the fixture's sweep size (``tools_fixture._SWEEP``)
SWEEP = dict(peers=64, segments=16, watch_s=20.0, seed=0)
SWEEP_CHUNK, SWEEP_RECORD = 24, 20


def _flag(args, name):
    return args[args.index(name) + 1]


def _port_command(name, out):
    """The port tool's command line for fixture run ``name``."""
    tool, args, _timelines = tf.RUNS[name]
    cmd = [sys.executable, "-m", f"hlsjs_p2p_wrapper_tpu_torch.tools.{tool}",
           *args, *tf.output_args(name, out), "--device", "cpu"]
    if tool in tf.NO_WARM_START:
        return cmd + ["--no-warm-start"]
    return cmd + ["--cache-dir", os.path.join(out, f"{name}.cache")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every fixture run through the port's tool, and the cheapest
    reference run again (the staleness check), each in a process of its
    own, side by side: ``{"port": dir, "fresh": dir}``."""
    port = str(tmp_path_factory.mktemp("port_tools"))
    fresh = str(tmp_path_factory.mktemp("fresh_reference"))
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import torch_port_tools_fixture as fixture_tool
    finally:
        sys.path.pop(0)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    procs = {name: subprocess.Popen(_port_command(name, port), cwd=ROOT,
                                    env=env, stdout=subprocess.DEVNULL,
                                    stderr=subprocess.PIPE, text=True)
             for name in tf.RUNS}
    with ThreadPoolExecutor(1) as pool:
        reference = pool.submit(fixture_tool.run_reference, "sweep_vod",
                                fresh, env)
        for name, proc in procs.items():
            _out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"{name}: {err}"
        reference.result()
    return {"port": port, "fresh": fresh}


@pytest.fixture(scope="module")
def port_dir(runs):
    return runs["port"]


def _knobs(row):
    return {k: v for k, v in row.items() if k not in ("offload", "rebuffer")}


def _hex(value):
    if isinstance(value, float):
        return value.hex()
    if isinstance(value, dict):
        return {k: _hex(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_hex(v) for v in value]
    return value


# -- against the committed reference fixture --------------------------------

@pytest.mark.parametrize("name", sorted(tf.RUNS))
def test_meta_keys_and_row_order_equal_the_reference(port_dir, name):
    ref, _ = tf.load(name)
    mine, _ = tf.load(name, port_dir)
    assert set(mine) == set(ref)
    assert set(mine["meta"]) == set(ref["meta"])
    for key, value in ref["meta"].items():
        if isinstance(value, dict):
            assert set(mine["meta"][key]) == set(value), key
    assert mine["meta"]["platform"] == "cpu"
    if "rows" in ref:
        assert [_knobs(r) for r in mine["rows"]] == \
            [_knobs(r) for r in ref["rows"]]
    if "topologies" in ref:
        for topology, table in ref["topologies"].items():
            mine_t = mine["topologies"][topology]
            assert mine_t["peers"] == table["peers"]
            assert [(r["pattern"], r["wave"], r["uplink_mbps"])
                    for r in mine_t["rows"]] == \
                [(r["pattern"], r["wave"], r["uplink_mbps"])
                 for r in table["rows"]]
            assert [set(r) for r in mine_t["rows"]] == \
                [set(r) for r in table["rows"]]


@pytest.mark.parametrize("name", sorted(tf.RUNS))
def test_rows_within_tolerance_of_the_reference(port_dir, name):
    ref, _ = tf.load(name)
    mine, _ = tf.load(name, port_dir)
    pairs = []
    if "rows" in ref:
        pairs = [(a[k], b[k]) for a, b in zip(ref["rows"], mine["rows"])
                 for k in ("offload", "rebuffer")]
    elif "topologies" in ref:
        pairs = [(a[k], b[k]) for t in ref["topologies"]
                 for a, b in zip(ref["topologies"][t]["rows"],
                                 mine["topologies"][t]["rows"])
                 for k in a if k.endswith(("_offload", "_rebuffer",
                                           "_margin", "_vs_spread"))]
        for key in ("worst_default_margin", "best_adaptive_vs_spread",
                    "max_rebuffer_spread"):
            pairs.append((ref["meta"][key], mine["meta"][key]))
        assert mine["meta"]["worst_cell"] == ref["meta"]["worst_cell"]
        assert mine["meta"]["sim_acceptance_pass"] == \
            ref["meta"]["sim_acceptance_pass"]
    else:
        pairs = [(a[k], b[k]) for a, b in zip(ref["trials"], mine["trials"])
                 for k in ("offload", "rebuffer")]
    assert pairs
    worst = max(abs(a - b) for a, b in pairs)
    assert worst <= ROW_TOL, worst


@pytest.mark.parametrize("name", sorted(n for n, r in tf.RUNS.items()
                                        if r[2]))
def test_timelines_within_tolerance_of_the_reference(port_dir, name):
    _, ref = tf.load(name)
    _, mine = tf.load(name, port_dir)
    assert len(mine) == len(ref)
    for a, b in zip(ref, mine):
        assert {k: v for k, v in b.items()
                if k not in ("samples", "offload", "rebuffer")} == \
            {k: v for k, v in a.items()
             if k not in ("samples", "offload", "rebuffer")}
        np.testing.assert_allclose(np.array(b["samples"]),
                                   np.array(a["samples"]),
                                   rtol=TIMELINE_RTOL, atol=1e-12)


def _decision_margin(trials, constraint):
    """How far the search's closest decision was from flipping: the
    feasibility bound, the halving promotion's boundary, the best trial
    and the Pareto set's closest pair of distinct values."""
    margins = [min(abs(t[constraint.metric] - constraint.bound)
                   for t in trials)]
    screens = [t for t in trials if t["fidelity"] < 1.0]
    keep = -(-len(screens) // 6)
    objs = sorted({-rank_key(t, constraint)[1] for t in screens
                   if constraint.feasible(t)}, reverse=True)
    keys = sorted((rank_key(t, constraint), i)
                  for i, t in enumerate(screens))
    at = objs.index(-keys[keep - 1][0][1])
    margins += [objs[at - 1] - objs[at]] if at else []
    margins += [objs[at] - objs[at + 1]] if at + 1 < len(objs) else []
    full = [t for t in trials if t["fidelity"] >= 1.0]
    best = sorted({t["offload"] for t in full if constraint.feasible(t)},
                  reverse=True)
    margins.append(best[0] - best[1])
    for metric in ("offload", "rebuffer"):
        values = sorted({t[metric] for t in full})
        margins.append(min(b - a for a, b in zip(values, values[1:])))
    return min(margins)


def test_optimize_trials_and_frontier_equal_the_reference(port_dir):
    ref, _ = tf.load("optimize")
    mine, _ = tf.load("optimize", port_dir)
    constraint = Constraint.parse(ref["meta"]["constraint"]["metric"] + "<="
                                  + str(ref["meta"]["constraint"]["bound"]))

    def decisions(trials):
        return [(t["point"], t["fidelity"], t["knobs"], t["feasible"],
                 t["failed"], t["round"]) for t in trials]
    assert decisions(mine["trials"]) == decisions(ref["trials"])
    assert [(r["proposals"], r["cost"], r["infeasible"])
            for r in mine["rounds"]] == \
        [(r["proposals"], r["cost"], r["infeasible"]) for r in ref["rounds"]]
    assert mine["spent"] == ref["spent"]
    front, ref_front = mine["frontier"], ref["frontier"]
    for key in ("feasible", "infeasible", "failed", "constraint"):
        assert front[key] == ref_front[key], key
    assert front["best"]["point"] == ref_front["best"]["point"]
    assert [t["point"] for t in front["pareto"]] == \
        [t["point"] for t in ref_front["pareto"]]
    for a, b in zip(ref_front["pareto"] + [ref_front["best"]],
                    front["pareto"] + [front["best"]]):
        assert abs(a["offload"] - b["offload"]) <= ROW_TOL
        assert abs(a["rebuffer"] - b["rebuffer"]) <= ROW_TOL
    # a port within ROW_TOL of every row cannot flip a decision
    assert _decision_margin(ref["trials"], constraint) >= 2 * ROW_TOL


# -- against the port's library path ----------------------------------------

def _sweep_library(grid, live=False, population=None):
    """``dispatch.run_batch_chunked`` over ``grid`` at the fixture's
    sweep size, scenarios from ``sweep_grid``."""
    config = sg.build_config(
        SWEEP["peers"], SWEEP["segments"], live, 8,
        n_cohorts=len(population.cohorts) if population else 0)
    n_steps = int(SWEEP["watch_s"] * 1000.0 / config.dt_ms)

    def build(knobs):
        return sg.build_scenario(config, knobs, watch_s=SWEEP["watch_s"],
                                 stagger_s=60.0, seed=SWEEP["seed"],
                                 population=population, device="cpu")
    return dp.run_batch_chunked(config, grid, build, n_steps,
                                watch_s=SWEEP["watch_s"], chunk=SWEEP_CHUNK,
                                record_every=SWEEP_RECORD)


def _assert_timelines_are_rows(timelines, rows):
    """Each timeline record's samples and its last sample's ratios
    equal the library row to the bit."""
    assert len(timelines) == len(rows)
    for record, (off, reb, tl) in zip(timelines, rows):
        cols = record["columns"]
        last = record["samples"][-1]
        assert last[cols.index("offload")].hex() == off.hex()
        assert last[cols.index("rebuffer")].hex() == reb.hex()
        assert record["samples"] == [[float(v) for v in s] for s in tl]


@pytest.mark.parametrize("name", ["sweep_vod", "sweep_live",
                                  "sweep_population"])
def test_sweep_tool_rows_equal_the_library_path(port_dir, name):
    """The VOD grid whole; the live and mixture grids at the 24 points
    of ``sample_grid`` (lanes are independent of their chunk)."""
    population = None
    grid = sg.vod_grid()
    if name == "sweep_live":
        grid = sg.live_grid()
    if name == "sweep_population":
        population = load_spec(os.path.join(ROOT, tf.POPULATION_SPEC))
        grid = sg.population_grid(grid, population)
    _, timelines = tf.load(name, port_dir)
    picked = sg.sample_grid(list(range(len(grid))), 24)
    rows = _sweep_library([grid[i] for i in picked],
                          live=name == "sweep_live", population=population)
    _assert_timelines_are_rows([timelines[i] for i in picked], rows)
    if name == "sweep_vod":
        # the tool's engine function gives the same bits
        tool_rows, info = sweep_tool.run_grid_batched(
            grid, live=False, chunk=SWEEP_CHUNK, raw=True, device="cpu",
            **SWEEP)
        assert info["compile_groups"] == 1 and info["chunk"] == SWEEP_CHUNK
        assert [(tool_rows[i]["offload"].hex(),
                 tool_rows[i]["rebuffer"].hex()) for i in picked] == \
            [(o.hex(), r.hex()) for o, r, _tl in rows]


@pytest.mark.parametrize("grid_name", ["vod", "live"])
def test_sequential_equals_batched_to_the_bit(grid_name):
    live = grid_name == "live"
    grid = sg.sample_grid(sg.live_grid() if live else sg.vod_grid(), 4)
    kw = dict(live=live, raw=True, device="cpu", **SWEEP)
    batched, _ = sweep_tool.run_grid_batched(grid, chunk=3, **kw)
    sequential, info = sweep_tool.run_grid_sequential(grid, **kw)
    assert info["compile_groups"] == 1
    assert [(r["offload"].hex(), r["rebuffer"].hex()) for r in sequential] \
        == [(r["offload"].hex(), r["rebuffer"].hex()) for r in batched]
    assert [_knobs(r) for r in sequential] == grid


def test_policy_ab_rows_equal_the_library_path(port_dir):
    _tool, args, _ = tf.RUNS["policy_ab"]
    peers = {"random": int(_flag(args, "--peers")),
             "ring": int(_flag(args, "--ring-peers"))}
    segments, watch_s = int(_flag(args, "--segments")), \
        float(_flag(args, "--watch-s"))
    chunk, record = int(_flag(args, "--chunk")), \
        int(_flag(args, "--record-every"))
    cells = pg.cells()
    _, timelines = tf.load("policy_ab", port_dir)
    artifact, _ = tf.load("policy_ab", port_dir)
    by_label = {(t["topology"], t["policy"]): [] for t in timelines}
    for t in timelines:
        by_label[(t["topology"], t["policy"])].append(t)
    for topology in ("random", "ring"):
        audience = pg.build_audience(peers[topology], pg.SEED, device="cpu")
        for policy in pg.POLICIES:
            if topology == "ring":
                config = pg.ring_config(peers[topology], segments, policy)
                mesh = None
            else:
                config = pg.random_config(peers[topology], segments, policy)
                mesh = pg.random_topology(peers[topology], pg.SEED,
                                          device="cpu")
            rows = dp.run_batch_chunked(
                config, cells,
                lambda c, cfg=config, m=mesh: pg.build_cell_scenario(
                    cfg, audience, uplink_bps=c[2] * 1e6, pattern=c[0],
                    wave=c[1], watch_s=watch_s, neighbors=m),
                int(watch_s * 1000.0 / config.dt_ms), watch_s=watch_s,
                chunk=chunk, record_every=record)
            records = by_label[(topology, policy)]
            assert [(r["pattern"], r["wave"], r["uplink_mbps"])
                    for r in records] == cells
            _assert_timelines_are_rows(records, rows)
            table = artifact["topologies"][topology]["rows"]
            assert [(r[f"{policy}_offload"], r[f"{policy}_rebuffer"])
                    for r in table] == \
                [(round(o, 4), round(b, 5)) for o, b, _tl in rows]


def test_optimize_tool_equals_the_library_path(port_dir, tmp_path):
    _tool, args, _ = tf.RUNS["optimize"]
    search = se.search_args(
        peers=int(_flag(args, "--peers")),
        segments=int(_flag(args, "--segments")),
        watch_s=float(_flag(args, "--watch-s")),
        chunk=int(_flag(args, "--chunk")),
        budget=float(_flag(args, "--budget")))
    space, constraint = se.live_space(), Constraint.parse(search.constraint)
    warm = WarmStart(str(tmp_path / "root"))
    evaluator = se.Evaluator(
        space, peers=search.peers, segments=search.segments,
        watch_s=search.watch_s, seed=search.seed, chunk=search.chunk,
        warm_start=warm, faults=FaultPolicy(registry=warm.registry),
        device="cpu")
    result = PolicySearch(se.build_driver(search, space, constraint),
                          evaluator, constraint, budget=search.budget,
                          batch=search.batch, registry=warm.registry).run()
    mine, _ = tf.load("optimize", port_dir)
    assert _hex(scrub_provenance(mine["trials"])) == \
        _hex(scrub_provenance(json.loads(json.dumps(result["trials"]))))
    assert _hex(scrub_provenance(mine["frontier"])) == \
        _hex(scrub_provenance(json.loads(json.dumps(result["frontier"]))))


# -- the entry points -----------------------------------------------------------

TOOL_NAMES = ("sweep", "policy_ab", "optimize", "warmstart_gate",
              "chaos_gate")


def _reference_flags(tool):
    """``{flag: default}`` of every ``add_argument`` in the reference
    tool's source, the default evaluated where it is a literal or an
    ``os.environ.get(NAME, literal)`` knob (None when absent, False for
    a ``store_true`` flag)."""
    import ast
    with open(os.path.join(ROOT, "tools", f"{tool}.py")) as fh:
        tree = ast.parse(fh.read())
    flags = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"
                and node.args and isinstance(node.args[0], ast.Constant)
                and str(node.args[0].value).startswith("--")):
            continue
        kws = {kw.arg: kw.value for kw in node.keywords}
        action = kws.get("action")
        default = (False if isinstance(action, ast.Constant)
                   and action.value == "store_true" else None)
        for kw in node.keywords:
            if kw.arg != "default":
                continue
            value = kw.value
            if isinstance(value, ast.Call) and value.args:
                value = value.args[0]   # int(...) / float(...)
            if isinstance(value, ast.Call) and len(value.args) == 2:
                value = value.args[1]   # os.environ.get(NAME, literal)
            default = ast.literal_eval(value)
        flags[node.args[0].value] = default
    return flags


@pytest.mark.parametrize("tool", TOOL_NAMES)
def test_tool_keeps_every_reference_flag_and_default(tool):
    import importlib
    module = importlib.import_module(f"hlsjs_p2p_wrapper_tpu_torch.tools.{tool}")
    actions = {opt: a for a in module.build_parser()._actions
               for opt in a.option_strings}
    want = _reference_flags(tool)
    assert want and set(want) <= set(actions), set(want) - set(actions)
    for flag, default in want.items():
        assert actions[flag].default == default, flag
    assert set(actions) - set(want) == {"-h", "--help", "--device"}
    assert actions["--device"].default == "cuda"


@pytest.mark.parametrize("tool", TOOL_NAMES)
def test_tool_without_a_card_exits_before_any_work(tool, tmp_path,
                                                   monkeypatch, capsys):
    """No card and no ``--device cpu``: exit 2 with the message, nothing
    written (this host has no card)."""
    import importlib
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("HLSJS_P2P_TORCH_CACHE_DIR", str(tmp_path / "root"))
    module = importlib.import_module(f"hlsjs_p2p_wrapper_tpu_torch.tools.{tool}")
    argv = ["--out", str(tmp_path / "out.json")] \
        if tool in ("sweep", "policy_ab", "optimize") else []
    with pytest.raises(SystemExit) as exc:
        module.main(argv)
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


# -- the step cost models -----------------------------------------------------

def _cost_configs():
    """(label, kwargs for both SwarmConfigs, n_neighbors)."""
    ring = ref_sim.ring_offsets(8)
    return [
        ("main path", dict(n_peers=262_144, n_segments=256, n_levels=3,
                           neighbor_offsets=ring), 8),
        ("VOD grid", dict(n_peers=1_048_576, n_segments=128,
                          n_levels=sg.N_LEVELS, neighbor_offsets=ring), 8),
        ("live", dict(n_peers=1_048_576, n_segments=128,
                      n_levels=sg.N_LEVELS, live=True,
                      neighbor_offsets=ring), 8),
        ("C = 3", dict(n_peers=262_144, n_segments=128, n_levels=1,
                       max_concurrency=3, neighbor_offsets=ring), 8),
        ("C = 3 adaptive", dict(n_peers=262_144, n_segments=128, n_levels=1,
                                max_concurrency=3,
                                holder_selection="adaptive",
                                neighbor_offsets=ring), 8),
        ("kpass", dict(n_peers=262_144, n_segments=256, n_levels=3,
                       eligibility="kpass", neighbor_offsets=ring), 8),
        ("stencil", dict(n_peers=262_144, n_segments=256, n_levels=3,
                         eligibility="stencil", neighbor_offsets=ring), 8),
        ("general K = 8", dict(n_peers=8_192, n_segments=128, n_levels=1,
                               max_concurrency=3), 8),
        ("general K = 8 adaptive",
         dict(n_peers=8_192, n_segments=128, n_levels=1, max_concurrency=3,
              holder_selection="adaptive"), 8),
    ]


@pytest.mark.parametrize("model", ["step_flops", "step_hbm_breakdown",
                                   "step_hbm_bytes"])
@pytest.mark.parametrize("label,kwargs,k", _cost_configs(),
                         ids=[c[0] for c in _cost_configs()])
def test_cost_models_equal_the_reference(model, label, kwargs, k):
    want = getattr(ref_sim, model)(ref_sim.SwarmConfig(**kwargs), k)
    got = getattr(sim, model)(sim.SwarmConfig(**kwargs), k, device="cpu")
    assert got == want, (label, got, want)


def test_cost_models_carry_is_the_port_state():
    """``carry_rw`` is twice the bytes of the port's own ``init_swarm``
    (on the meta device): a field added to the state counts itself."""
    config = sg.build_config(1024, 128, False, 8)
    state = sim.init_swarm(config, device="cpu")
    nbytes = sum(t.numel() * t.element_size() for t in sim.tree_leaves(state))
    assert sim.step_hbm_breakdown(config, device="cpu")["carry_rw"] == \
        2.0 * nbytes


@pytest.mark.parametrize("model", ["step_flops", "step_hbm_breakdown",
                                   "step_hbm_bytes"])
def test_cost_models_count_the_card_formulation(model):
    """The caller names the device: on the card ``"auto"`` is the
    stencil, whose cost differs from the CPU's K-pass, and no default
    lets a card's bound be counted with the CPU's formulation."""
    config = sg.build_config(1024, 128, False, 8)
    stencil = getattr(ref_sim, model)(ref_sim.SwarmConfig(
        n_peers=1024, n_segments=128, n_levels=sg.N_LEVELS,
        neighbor_offsets=ref_sim.ring_offsets(8), eligibility="stencil"))
    kpass = getattr(ref_sim, model)(ref_sim.SwarmConfig(
        n_peers=1024, n_segments=128, n_levels=sg.N_LEVELS,
        neighbor_offsets=ref_sim.ring_offsets(8), eligibility="kpass"))
    assert stencil != kpass
    assert getattr(sim, model)(config, device="cuda") == stencil
    assert getattr(sim, model)(config, device="cpu") == kpass
    with pytest.raises(TypeError):
        getattr(sim, model)(config)


# -- the fixture is current ------------------------------------------------

def test_fixture_is_current(runs):
    """The cheapest reference run, re-run, writes the committed fixture's
    rows and timelines (its meta differs only in wall times)."""
    fresh, fresh_tl = tf.load("sweep_vod", runs["fresh"])
    ref, ref_tl = tf.load("sweep_vod")
    assert fresh["rows"] == ref["rows"]
    assert fresh_tl == ref_tl
    skip = ("elapsed_s", "points_per_sec")
    assert {k: v for k, v in fresh["meta"].items() if k not in skip} == \
        {k: v for k, v in ref["meta"].items() if k not in skip}
