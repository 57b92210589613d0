"""Process-level proofs of the port's tools on the CPU: the counterparts
of ``tests/test_resume_process.py`` and ``tests/test_optimize_process.py``
with the same arguments, the port's warm-start and chaos gates at gate
size, and a two-host fabric sweep.  None of it goes through the
reference's executable layer.

- A SIGKILLed ``tools.sweep`` (``kill@0:3``, chunks of 8 on the 48-point
  VOD grid at 16 peers × 8 segments × 4 s) leaves no artifact and a
  journal of the 16 rows drained before it died; ``--resume`` writes the
  uninterrupted run's artifact, its journaled rows served as row-cache
  hits and the other 32 stored, and finalizes the journal.
- A SIGKILLed ``tools.optimize`` (``kill@0:5``, the live lattice at 16
  peers, chunks of 8, budget 66) leaves no artifact, no checkpoint and
  32 journaled rows; ``--resume`` gives the uninterrupted frontier and
  trials bit for bit, round 0 counting the 32 rows as row-cache hits; a
  same-seed rerun on the uninterrupted run's root dispatches nothing and
  builds and captures nothing.
- ``tools.warmstart_gate`` and ``tools.chaos_gate`` pass at their
  defaults.
- ``tools.sweep --fabric DIR --hosts 2`` merges to the single-process
  rows to the bit.

The process chains run side by side (one thread each, started by the
module's fixture), each child on one CPU thread.
"""

import json
import os
import signal
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from hlsjs_p2p_wrapper_tpu_torch import sweep_grid as sg
from hlsjs_p2p_wrapper_tpu_torch.engine.artifact_cache import WarmStart
from hlsjs_p2p_wrapper_tpu_torch.engine.search import (
    scrub_provenance as scrub)
from hlsjs_p2p_wrapper_tpu_torch.tools import sweep as sweep_tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "hlsjs_p2p_wrapper_tpu_torch.tools"

#: tests/test_resume_process.py's sweep: 6 chunks of 8, killed at chunk 3
SWEEP_ARGS = ["--peers", "16", "--segments", "8", "--watch-s", "4",
              "--chunk", "8"]
#: tests/test_optimize_process.py's search: an 18-chunk screen, killed
#: at chunk 5
OPT_ARGS = ["--peers", "16", "--segments", "8", "--watch-s", "8",
            "--chunk", "8", "--budget", "66", "--seed", "0"]
TIMEOUT_S = 600


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env.pop("PYTHONPATH", None)
    return env


def _run(tool, *args, env=None):
    return subprocess.run(
        [sys.executable, "-m", f"{PKG}.{tool}", *args, "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, env=env or _env(),
        timeout=TIMEOUT_S)


def _journal(cache):
    names = [n for n in os.listdir(os.path.join(cache, "journals"))
             if n.endswith(".jsonl")]
    assert len(names) == 1, names
    path = os.path.join(cache, "journals", names[0])
    with open(path, encoding="utf-8") as fh:
        return path, [json.loads(line) for line in fh if line.strip()]


def _sweep(cache, out, *extra):
    return _run("sweep", *SWEEP_ARGS, "--out", out, *extra,
                env=_env(HLSJS_P2P_TORCH_CACHE_DIR=cache))


def _optimize(cache, out, *extra):
    return _run("optimize", *OPT_ARGS, "--cache-dir", cache, "--out", out,
                *extra)


def chain_sweep(tmp):
    """The uninterrupted sweep beside the killed one, then the resume."""
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_sweep, os.path.join(tmp, "cache_ref"),
                          os.path.join(tmp, "ref.json"))
        killed = pool.submit(_sweep, os.path.join(tmp, "cache_run"),
                             os.path.join(tmp, "out.json"),
                             "--inject-faults", "kill@0:3")
        ref, killed = ref.result(), killed.result()
    existed = os.path.exists(os.path.join(tmp, "out.json"))
    path, lines = _journal(os.path.join(tmp, "cache_run"))
    resumed = _sweep(os.path.join(tmp, "cache_run"),
                     os.path.join(tmp, "out.json"), "--resume")
    return {"ref": ref, "killed": killed, "out_after_kill": existed,
            "journal_after_kill": lines, "journal": path,
            "resumed": resumed}


def chain_optimize(tmp):
    """The uninterrupted search and then its warm rerun, beside the
    killed search and then its resume."""
    def uninterrupted():
        ref = _optimize(os.path.join(tmp, "cache_ref"),
                        os.path.join(tmp, "ref.json"))
        warm = _optimize(os.path.join(tmp, "cache_ref"),
                         os.path.join(tmp, "warm.json"))
        return ref, warm

    def interrupted():
        cache = os.path.join(tmp, "cache_run")
        killed = _optimize(cache, os.path.join(tmp, "out.json"),
                           "--inject-faults", "kill@0:5")
        state = {"killed": killed,
                 "out_after_kill": os.path.exists(
                     os.path.join(tmp, "out.json")),
                 "journal_after_kill": _journal(cache)[1],
                 "searches": (os.listdir(os.path.join(cache, "searches"))
                              if os.path.isdir(os.path.join(cache,
                                                            "searches"))
                              else [])}
        state["resumed"] = _optimize(cache, os.path.join(tmp, "out.json"),
                                     "--resume")
        state["journal"] = _journal(cache)[0]
        return state

    with ThreadPoolExecutor(2) as pool:
        a, b = pool.submit(uninterrupted), pool.submit(interrupted)
        (ref, warm), state = a.result(), b.result()
    return {"ref": ref, "warm": warm, **state}


def chain_fabric(tmp):
    """Two spawned fabric hosts, merged by the launcher."""
    cache = os.path.join(tmp, "cache")
    proc = _run("sweep", *SWEEP_ARGS, "--fabric", os.path.join(tmp, "fab"),
                "--hosts", "2", "--out", os.path.join(tmp, "fleet.json"),
                env=_env(HLSJS_P2P_TORCH_CACHE_DIR=cache))
    return {"proc": proc, "cache": cache, "fabric": os.path.join(tmp, "fab"),
            "out": os.path.join(tmp, "fleet.json")}


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """Every process chain started at once; a test waits for its own."""
    tmp = {name: str(tmp_path_factory.mktemp(name))
           for name in ("sweep", "optimize", "fabric")}
    pool = ThreadPoolExecutor(5)
    futures = {
        "sweep": pool.submit(chain_sweep, tmp["sweep"]),
        "optimize": pool.submit(chain_optimize, tmp["optimize"]),
        "fabric": pool.submit(chain_fabric, tmp["fabric"]),
        "warmstart_gate": pool.submit(_run, "warmstart_gate"),
        "chaos_gate": pool.submit(_run, "chaos_gate"),
    }
    yield {name: (future, tmp.get(name)) for name, future in futures.items()}
    pool.shutdown(wait=True)


def test_sigkilled_sweep_resumes_bit_exact(chains):
    future, tmp = chains["sweep"]
    c = future.result()
    assert c["ref"].returncode == 0, c["ref"].stderr
    ref = json.loads(open(os.path.join(tmp, "ref.json")).read())

    # killed at chunk 3: no artifact, chunks 0-1 journaled, no done line
    assert c["killed"].returncode == -signal.SIGKILL, c["killed"].stderr
    assert not c["out_after_kill"]
    journaled = [r for r in c["journal_after_kill"] if r.get("kind") == "row"]
    assert len(journaled) == 16
    assert not any(r.get("kind") == "done" for r in c["journal_after_kill"])

    resumed = c["resumed"]
    assert resumed.returncode == 0, resumed.stderr
    assert "journal lists 16 completed rows" in resumed.stderr
    out = json.loads(open(os.path.join(tmp, "out.json")).read())
    assert out["rows"] == ref["rows"]
    assert out["meta"]["failed_points"] == 0
    assert out["meta"]["platform"] == "cpu"
    row_events = out["meta"]["warm_start"]["row"]
    assert row_events.get("hit") == len(journaled)
    assert row_events.get("store") == len(ref["rows"]) - len(journaled)
    assert '"done"' in open(c["journal"]).read()


def test_sigkilled_search_resumes_bit_exact(chains):
    future, tmp = chains["optimize"]
    c = future.result()
    assert c["ref"].returncode == 0, c["ref"].stderr
    ref = json.loads(open(os.path.join(tmp, "ref.json")).read())
    assert ref["spent"] < 72  # under half of the exhaustive lattice

    assert c["killed"].returncode == -signal.SIGKILL, c["killed"].stderr
    assert not c["out_after_kill"]
    journaled = [r for r in c["journal_after_kill"] if r.get("kind") == "row"]
    assert len(journaled) == 32  # four 8-point screen chunks drained
    assert not any(r.get("kind") == "done" for r in c["journal_after_kill"])
    assert c["searches"] == []  # killed before its first checkpoint

    resumed = c["resumed"]
    assert resumed.returncode == 0, resumed.stderr
    assert "journal lists 32 completed rows" in resumed.stderr
    out = json.loads(open(os.path.join(tmp, "out.json")).read())
    assert scrub(out["frontier"]) == scrub(ref["frontier"])
    assert scrub(out["trials"]) == scrub(ref["trials"])
    assert out["rounds"][-1]["best_offload"] == \
        ref["rounds"][-1]["best_offload"]
    assert out["meta"]["journal_preloaded"] == len(journaled)
    assert out["rounds"][0]["row_cache_hits"] == len(journaled)
    assert out["rounds"][0]["fresh_dispatches"] == \
        ref["rounds"][0]["fresh_dispatches"] - len(journaled)
    assert '"done"' in open(c["journal"]).read()


def test_same_seed_search_reruns_from_the_row_cache(chains):
    future, tmp = chains["optimize"]
    c = future.result()
    assert c["warm"].returncode == 0, c["warm"].stderr
    a = json.loads(open(os.path.join(tmp, "ref.json")).read())
    b = json.loads(open(os.path.join(tmp, "warm.json")).read())
    assert scrub(a["frontier"]) == scrub(b["frontier"])
    assert scrub(a["trials"]) == scrub(b["trials"])
    assert sum(r["fresh_dispatches"] for r in b["rounds"]) == 0
    assert sum(r["row_cache_hits"] for r in b["rounds"]) == len(b["trials"])
    assert b["meta"]["xla_compiles"] == 0


@pytest.mark.parametrize("gate", ["warmstart_gate", "chaos_gate"])
def test_gate_passes_at_gate_size(chains, gate):
    proc = chains[gate][0].result()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"# {gate.replace('_', '-')}: PASS" in proc.stderr


def test_two_host_fabric_merges_to_the_single_process_rows(chains):
    future, _tmp = chains["fabric"]
    c = future.result()
    assert c["proc"].returncode == 0, c["proc"].stderr
    fleet = json.loads(open(c["out"]).read())
    hosts = fleet["meta"]["fabric"]["hosts"]
    assert sorted(h["host"] for h in hosts) == ["host00", "host01"]
    assert sum(h["rows"] for h in hosts) >= 48
    assert fleet["meta"]["fabric"]["report"]["finished"] == 6
    kw = dict(peers=16, segments=8, watch_s=4.0, live=False, seed=0)
    grid = sg.vod_grid()
    single, _ = sweep_tool.run_grid_batched(grid, chunk=8, raw=True,
                                            device="cpu", **kw)
    merged, info = sweep_tool.merge_fabric(
        grid, fabric_dir=c["fabric"], warm_start=WarmStart(c["cache"]),
        raw=True, device="cpu", **kw)
    assert info["fabric"]["recovered_rows"] == 0
    assert [(r["offload"].hex(), r["rebuffer"].hex()) for r in merged] == \
        [(r["offload"].hex(), r["rebuffer"].hex()) for r in single]
    by_knobs = {json.dumps({k: v for k, v in r.items()
                            if k not in ("offload", "rebuffer")},
                           sort_keys=True): r for r in fleet["rows"]}
    for row in single:
        knobs = {k: v for k, v in row.items()
                 if k not in ("offload", "rebuffer")}
        got = by_knobs[json.dumps(knobs, sort_keys=True)]
        assert (got["offload"], got["rebuffer"]) == \
            (round(row["offload"], 4), round(row["rebuffer"], 5))
