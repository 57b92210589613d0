"""The port's twin gate, control gate and control service at process level
on the CPU (``python -m hlsjs_p2p_wrapper_tpu_torch.tools.{twin_gate,
control_gate,control} --device cpu``).

- ``tools.twin_gate`` and ``tools.control_gate`` PASS at their defaults
  (8 peers plus a wave of 4, 160 s in 8-s windows; the twin gate's
  bands are ``TWIN_r10.json``'s), their children building nothing.
- The twin gate's real-plane frames of its two scenarios (each run in a
  child process of its own) equal the reference's committed ones
  (``testing/reference_control/twin_frames.json``), exactly.
- ``tools.control`` replaying the committed control shard
  (``control_shard.jsonl.gz``) under config (a) of
  ``control_decisions.json`` gives the reference's ``decision_sig``
  sequence; SIGKILLed after its first actuation (before the tick
  checkpoints) and ``--resume``d it gives the same sequence, each epoch
  once in its actuation log.
- Without a card and without ``--device cpu`` each of the three exits 2
  before any work.

Every run starts at once (a module fixture), each child on one CPU
thread, the control gate's chain at the normal priority and the others
niced, so the file's wall is close to the control gate's.
"""

import json
import os
import signal
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

from hlsjs_p2p_wrapper_tpu_torch.testing import control_fixture as cf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "hlsjs_p2p_wrapper_tpu_torch.tools"
TIMEOUT_S = 600
#: the scheduling priority of the runs beside the control gate's
NICE = 5


def _env(tmp):
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=tmp,
               HLSJS_P2P_TORCH_CACHE_DIR=os.path.join(tmp, "cache"))
    env.pop("PYTHONPATH", None)
    return env


def _run(tool, *args, tmp, nice=0):
    return subprocess.run(
        [sys.executable, "-m", f"{PKG}.{tool}", *args, "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, env=_env(tmp),
        timeout=TIMEOUT_S,
        preexec_fn=(lambda: os.nice(nice)) if nice else None)


def _spec(tmp):
    """Config (a) of the committed decisions as a ``tools.control``
    spec file, and the committed shard unpacked beside it."""
    a = cf.load_json(cf.CONTROL_DECISIONS)["configs"]["a"]
    metric, bound, _objective = a["constraint"]
    spec = os.path.join(tmp, "spec.json")
    with open(spec, "w") as fh:
        json.dump({"scenario": a["spec"], "knob_grid": a["knob_grid"],
                   "initial_knobs": a["initial_knobs"],
                   "constraint": f"{metric}<={bound}",
                   "bands_path": os.path.join(ROOT, "TWIN_r10.json"),
                   "band_set": a["band_set"], "swarm_id": a["swarm_id"],
                   "warmup_windows": a["warmup_windows"],
                   "hysteresis_ticks": a["hysteresis_ticks"],
                   "forecast_chunk": a["forecast_chunk"]}, fh)
    return spec, cf.unpack_shard(os.path.join(tmp, "shard.jsonl"))


def _replay(tmp, spec, shard, tag, cache, *extra):
    out = os.path.join(tmp, f"{tag}.json")
    proc = _run("control", "--spec", spec, "--shard", shard,
                "--actuate-log", os.path.join(tmp, f"{tag}_acts.jsonl"),
                "--cache-dir", os.path.join(tmp, cache), "--out", out,
                *extra, tmp=tmp, nice=NICE)
    doc = None
    if proc.returncode == 0:
        with open(out) as fh:
            doc = json.load(fh)
    return proc, doc


def _epochs(path):
    with open(path) as fh:
        return [json.loads(line)["epoch"] for line in fh if line.strip()]


def _control_reference(tmp):
    spec, shard = _spec(tmp)
    return _replay(tmp, spec, shard, "ref", "cache_ref")


def _control_kill_resume(tmp):
    """The kill run on a root of its own, then its ``--resume``."""
    spec, shard = _spec(tmp)
    kill, _ = _replay(tmp, spec, shard, "kill", "cache_kill",
                      "--sigkill-at-actuation", "1")
    log = os.path.join(tmp, "kill_acts.jsonl")
    pre = _epochs(log) if os.path.exists(log) else None
    resume, doc = _replay(tmp, spec, shard, "kill", "cache_kill",
                          "--resume")
    return {"kill": kill, "pre": pre, "resume": resume, "doc": doc,
            "post": _epochs(log) if os.path.exists(log) else None}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two gates and the control service's runs, started at once."""
    jobs = {
        "twin_gate": lambda tmp: _run("twin_gate", tmp=tmp, nice=NICE),
        "control_gate": lambda tmp: _run("control_gate", tmp=tmp),
        "control_ref": _control_reference,
        "control_kill": _control_kill_resume}
    pool = ThreadPoolExecutor(len(jobs))
    futures = {name: pool.submit(job, str(tmp_path_factory.mktemp(name)))
               for name, job in jobs.items()}
    yield futures
    pool.shutdown(wait=True)


def _children(stderr):
    line = [ln for ln in stderr.splitlines()
            if ln.startswith("# children's kernels: ")][-1]
    return json.loads(line.split(": ", 1)[1])


def test_twin_gate_passes_at_defaults(runs):
    proc = runs["twin_gate"].result()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "# twin-gate: PASS " in proc.stderr
    assert "Traceback" not in proc.stderr
    assert _children(proc.stderr)["builds"] == 0


def test_control_gate_passes_at_defaults(runs):
    proc = runs["control_gate"].result()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("control-gate: ")][-1]
    passed, total = line.split()[1].split("/")
    assert passed == total and int(total) >= 35, line
    assert "  [FAIL]" not in proc.stdout
    assert _children(proc.stderr)["builds"] == 0


@pytest.mark.parametrize("scenario", ["clean", "chaos"])
def test_twin_gate_real_frames_equal_the_committed_fixture(runs, scenario):
    proc = runs["twin_gate"].result()
    assert proc.returncode == 0, proc.stderr
    gate = __import__(f"{PKG}.twin_gate", fromlist=["FRAMES_OUT"])
    with open(gate.FRAMES_OUT) as fh:
        frames = json.load(fh)
    ref = cf.load_json(cf.TWIN_FRAMES)["scenarios"][scenario]
    assert frames["scenarios"][scenario]["real"] == ref["real"]


def test_control_replay_gives_the_reference_decisions(runs):
    proc, doc = runs["control_ref"].result()
    assert proc.returncode == 0, proc.stderr
    ref = cf.load_json(cf.CONTROL_DECISIONS)["runs"]["a"]
    assert cf.decision_sig(doc["decisions"]) == ref["decisions"]
    assert [d["epoch"] for d in doc["decisions"]
            if d["action"] == "actuate"] == ref["epochs"]
    assert doc["ticks"] == len(ref["decisions"]) and not doc["meta"]["resumed"]


def test_control_resumes_after_sigkill_with_the_same_decisions(runs):
    r = runs["control_kill"].result()
    ref = cf.load_json(cf.CONTROL_DECISIONS)["runs"]["a"]
    assert r["kill"].returncode == -signal.SIGKILL, r["kill"].stderr
    assert r["pre"] == ref["epochs"][:1]
    assert r["resume"].returncode == 0, r["resume"].stderr
    assert r["doc"]["meta"]["resumed"]
    assert cf.decision_sig(r["doc"]["decisions"]) == ref["decisions"]
    assert r["post"] == ref["epochs"]
    assert len(r["post"]) == len(set(r["post"]))


@pytest.mark.parametrize("tool,argv", [
    ("twin_gate", []), ("control_gate", []),
    ("control", ["--spec", "s.json", "--shard", "x.jsonl",
                 "--actuate-log", "a.jsonl"])])
def test_without_a_card_exits_before_any_work(tool, argv, tmp_path,
                                              monkeypatch, capsys):
    import importlib

    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)

    def no_process(*_a, **_k):
        raise AssertionError("a child process was started")
    monkeypatch.setattr(subprocess, "Popen", no_process)
    module = importlib.import_module(f"{PKG}.{tool}")
    with pytest.raises(SystemExit) as exc:
        module.main(argv)
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []
