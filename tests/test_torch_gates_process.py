"""The port's four sweep-side gates at process level on the CPU, and the
trace consumers on a traced two-host fabric run of the port.

- ``tools.fleet_gate`` and ``tools.trace_gate`` PASS with their kill,
  stall and transient schedules (``kill@1``; ``stall@1:3×lease``;
  ``transient@0:0x2``) at 16 peers × 8 segments × 4 s (their
  ``*_GATE_*`` knobs; lease and chunk at their defaults);
  ``tools.optimize_gate`` and ``tools.population_gate`` PASS at their
  defaults (48 and 64 peers).
- The optimize gate's grid and search children equal the reference's
  at the gate size (the committed ``optimize_gate_grid.json`` and
  ``optimize_gate_search.json`` of ``testing/reference_tools/``):
  trials (points, fidelities, knobs, feasibility, rounds), rounds and
  spend equal, the best point and the Pareto set's points equal, every
  value within ``ROW_TOL`` (1e-4).  The closest decisions: the grid's
  feasibility bound 1.25e-3 away, its best feasible trial 1.71e-2
  ahead, its Pareto set's closest pair of distinct values 1.34e-5 apart
  (rebuffer; offload 3.31e-5); the search's promotion boundary 1.09e-2,
  feasibility 1.53e-3, best 1.71e-2, Pareto pair 5.34e-4.  The port's
  grid values lie within 2.3e-8 of the reference's on this host, so
  the Pareto pair is held by the points' equality, not by ``ROW_TOL``.
- Two ``tools.sweep --fabric DIR --host-id H --fabric-barrier 2
  --fabric-lease-s 2 --trace-dir TR`` workers (16 peers; a host that
  finds the other's lease waits it out before it reads the claim file
  again, so the lease bounds the run): the
  reference's and the port's ``export_dir`` give equal traces and
  ``render_frame`` (``now`` fixed) equal frames on its shards and claim
  files.

All children start at once, each on one CPU thread (a module fixture),
so the file's wall is the slowest chain's.
"""

import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from hlsjs_p2p_wrapper_tpu_torch.engine.search import (
    scrub_provenance as scrub)
from hlsjs_p2p_wrapper_tpu_torch.testing import tools_fixture as tf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "hlsjs_p2p_wrapper_tpu_torch.tools"
TIMEOUT_S = 600
ROW_TOL = 1e-4
NOW = 1.0e9
SMALL = {"PEERS": "16", "SEGMENTS": "8", "WATCH_S": "4"}
#: the scheduling priority the chains beside the optimize gate's run at
NICE = 5


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env.pop("PYTHONPATH", None)
    return env


def _run(tool, *args, env=None, nice=0):
    return subprocess.run(
        [sys.executable, "-m", f"{PKG}.{tool}", *args, "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, env=env or _env(),
        timeout=TIMEOUT_S, preexec_fn=(lambda: os.nice(nice)) if nice
        else None)


def _gate(name, tmp):
    prefix = name.split("_")[0].upper() + "_GATE_"
    env = _env(TMPDIR=tmp, **({prefix + k: v for k, v in SMALL.items()}
                              if name in ("fleet_gate", "trace_gate")
                              else {}))
    if name == "optimize_gate":
        # the longest chain (its grid child alone ~16 s here) keeps the
        # CPU first; the others are done well before it
        return _run(name, "--keep-dirs", env=env)
    return _run(name, env=env, nice=NICE)


def _traced_fabric(tmp):
    """Two ``tools.sweep --fabric --host-id`` workers behind a start
    barrier, each with its shard in one trace dir."""
    fabric, trace = os.path.join(tmp, "fab"), os.path.join(tmp, "trace")
    env = _env(HLSJS_P2P_TORCH_CACHE_DIR=os.path.join(tmp, "c"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.sweep", "--peers", "16",
         "--segments", "8", "--watch-s", "4", "--chunk", "8", "--fabric",
         fabric, "--host-id", host, "--fabric-barrier", "2",
         "--fabric-lease-s", "2", "--trace-dir", trace, "--device", "cpu"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, env=env, preexec_fn=lambda: os.nice(NICE))
        for host in ("host00", "host01")]
    errs = [proc.communicate(timeout=TIMEOUT_S)[1] for proc in procs]
    return {"rcs": [proc.returncode for proc in procs], "errs": errs,
            "fabric": fabric, "trace": trace}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every gate and the traced fabric, started at once."""
    names = ("fleet_gate", "trace_gate", "optimize_gate", "population_gate")
    tmp = {name: str(tmp_path_factory.mktemp(name))
           for name in names + ("fabric",)}
    pool = ThreadPoolExecutor(len(tmp))
    futures = {name: pool.submit(_gate, name, tmp[name]) for name in names}
    futures["fabric"] = pool.submit(_traced_fabric, tmp["fabric"])
    yield futures
    pool.shutdown(wait=True)


@pytest.mark.parametrize("gate", ["fleet_gate", "trace_gate",
                                  "optimize_gate", "population_gate"])
def test_gate_passes_at_gate_size(runs, gate):
    proc = runs[gate].result()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"# {gate.replace('_', '-')}: PASS" in proc.stderr
    assert "Traceback" not in proc.stderr


def _kept(runs, name):
    proc = runs["optimize_gate"].result()
    work = re.search(r"dirs kept under (\S+)", proc.stderr).group(1)
    with open(os.path.join(work, f"{name}.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("child,name", [("grid", "optimize_gate_grid"),
                                        ("search", "optimize_gate_search")])
def test_optimize_gate_child_equals_the_reference(runs, child, name):
    mine, ref = _kept(runs, child), tf.load_gate(name)

    def decisions(trials):
        return [(t["point"], t["fidelity"], t["knobs"], t["feasible"],
                 t["failed"], t["round"]) for t in trials]
    assert decisions(mine["trials"]) == decisions(ref["trials"])
    assert [(r["proposals"], r["cost"], r["infeasible"])
            for r in mine["rounds"]] == \
        [(r["proposals"], r["cost"], r["infeasible"]) for r in ref["rounds"]]
    assert mine["spent"] == ref["spent"]
    for a, b in zip(mine["trials"], ref["trials"]):
        assert abs(a["offload"] - b["offload"]) <= ROW_TOL
        assert abs(a["rebuffer"] - b["rebuffer"]) <= ROW_TOL
    front, ref_front = mine["frontier"], ref["frontier"]
    for key in ("feasible", "infeasible", "failed", "constraint"):
        assert front[key] == ref_front[key], key
    assert front["best"]["point"] == ref_front["best"]["point"]
    assert [t["point"] for t in front["pareto"]] == \
        [t["point"] for t in ref_front["pareto"]]
    assert set(mine["meta"]) == set(ref["meta"])
    assert (mine["meta"]["platform"], mine["meta"]["device_kind"]) == \
        ("cpu", "cpu")


def test_optimize_gate_rerun_and_resume_equal_the_search(runs):
    search = _kept(runs, "search")
    for name in ("rerun", "resume"):
        other = _kept(runs, name)
        assert scrub(other["trials"]) == scrub(search["trials"])
        assert scrub(other["frontier"]) == scrub(search["frontier"])


@pytest.mark.parametrize("consumer", ["trace_export", "fleet_console"])
def test_consumer_equals_the_reference_on_a_traced_fabric(runs, consumer):
    import importlib
    import importlib.util
    run = runs["fabric"].result()
    assert run["rcs"] == [0, 0], run["errs"]
    spec = importlib.util.spec_from_file_location(
        f"reference_tool_{consumer}",
        os.path.join(ROOT, "tools", f"{consumer}.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    mine = importlib.import_module(f"{PKG}.{consumer}")
    if consumer == "trace_export":
        a, b = ref.export_dir(run["trace"]), mine.export_dir(run["trace"])
        assert json.loads(json.dumps(b)) == json.loads(json.dumps(a))
        assert {e["pid"] for e in b["traceEvents"]} == {1, 2}
        assert any(e["ph"] == "X" for e in b["traceEvents"])
    else:
        kw = dict(fabric_dir=run["fabric"], trace_dir=run["trace"], now=NOW)
        frame = mine.render_frame(**kw)
        assert frame == ref.render_frame(**kw)
        assert "6/6 units done" in frame and "host01" in frame
