"""Warm starts of the PyTorch port, on the CPU: the crash-safe journal
and the row cache (``engine/artifact_cache.py``), the kernel libraries'
sidecars and events (``ops/_build.py``), and the dispatch's
``warm_start=`` and ``journal=`` (``ops/dispatch.py``).  The journal is
held to the reference's ``engine/artifact_cache.py`` byte for byte; the
reference's executable layer (``WarmStart.batch_runner``) and
``tools/sweep.py`` are not called."""

import json
import os
import shutil
import signal
import stat
import subprocess
import sys

import numpy as np
import pytest
import torch

from hlsjs_p2p_wrapper_tpu.engine import artifact_cache as ref_ac
from hlsjs_p2p_wrapper_tpu_torch import sweep_grid as sg
from hlsjs_p2p_wrapper_tpu_torch.engine import artifact_cache as ac
from hlsjs_p2p_wrapper_tpu_torch.engine.faults import FaultPlan, FaultPolicy
from hlsjs_p2p_wrapper_tpu_torch.ops import _build
from hlsjs_p2p_wrapper_tpu_torch.ops import dispatch as dp
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_kernels as sk
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

P, S, T, EVERY = 32, 8, 20, 5
WATCH_S = T * 0.25
META = {"tool": "sweep", "peers": 16, "segments": 8, "watch_s": 4.0,
        "live": False, "seed": 0, "record_every": 0,
        "grid": [{"degree": 8, "ladder": "sd"}]}
KEYS = [f"{i:064x}" for i in range(5)]


def _group(n_items=6):
    config = sg.build_config(P, S, False, 8)
    items = sg.vod_grid()[:n_items]

    def build(knobs):
        return sg.build_scenario(config, knobs, watch_s=WATCH_S,
                                 stagger_s=2.0, seed=0, device="cpu")
    return config, items, build


def _rows_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        assert [v.hex() for v in x[:2]] == [v.hex() for v in y[:2]]
        if len(x) > 2:
            assert x[2].dtype == y[2].dtype
            assert x[2].tobytes() == y[2].tobytes()


# ---- the journal, against the reference --------------------------------------

@pytest.mark.parametrize("host_id", [None, "host-1"])
def test_digest_and_journal_paths_equal_the_reference(tmp_path, host_id):
    assert ac._digest(META) == ref_ac._digest(META)
    assert (ac.journal_path(str(tmp_path), META, host_id)
            == ref_ac.journal_path(str(tmp_path), META, host_id))
    ac.SweepJournal(ac.journal_path(str(tmp_path), META), META).close()
    ac.SweepJournal(ac.journal_path(str(tmp_path), META, "b"), META).close()
    ac.SweepJournal(ac.journal_path(str(tmp_path), META, "a"), META).close()
    shards = ac.journal_shards(str(tmp_path), META)
    assert shards == ref_ac.journal_shards(str(tmp_path), META)
    assert [os.path.basename(p) for p in shards][1:] == ["a.jsonl",
                                                         "b.jsonl"]


def _write(module, path):
    with module.SweepJournal(path, META) as journal:
        journal.record_rows(KEYS[:3])
        journal.record_rows(KEYS[1:4])   # the repeats are not written
        journal.record_row(KEYS[4])
        journal.finalize()
        journal.finalize()


def test_same_calls_write_the_same_journal_bytes(tmp_path):
    ours, theirs = str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl")
    _write(ac, ours)
    _write(ref_ac, theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        data = a.read()
        assert data == b.read()
    assert data.count(b'"row"') == 5 and data.endswith(b'{"kind": "done"}\n')


@pytest.mark.parametrize("writer,reader", [(ref_ac, ac), (ac, ref_ac)])
def test_each_side_resumes_the_others_torn_journal(tmp_path, writer,
                                                   reader):
    """A journal cut mid-line (a SIGKILL mid-append) resumes on the
    other side: the torn record is skipped, appends start on a fresh
    line, and both sides then write the same bytes."""
    paths = [str(tmp_path / f"{n}.jsonl") for n in ("a", "b")]
    for path in paths:
        with writer.SweepJournal(path, META) as journal:
            journal.record_rows(KEYS[:2])
        with open(path, "a") as fh:
            fh.write('{"kind": "row", "key": "' + KEYS[2][:20])
    for module, path in zip((reader, writer), paths):
        with module.SweepJournal(path, META, resume=True) as journal:
            assert journal.completed == set(KEYS[:2])
            assert not journal.finished
            journal.record_rows(KEYS[2:4])
            journal.finalize()
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    with reader.SweepJournal(paths[0], META, resume=True) as again:
        assert again.completed == set(KEYS[:4]) and again.finished


@pytest.mark.parametrize("module", [ac, ref_ac])
def test_a_mismatched_digest_is_refused(tmp_path, module):
    path = str(tmp_path / "j.jsonl")
    other = dict(META, seed=1)
    ac.SweepJournal(path, other).close()
    with pytest.raises(ValueError, match="different sweep"):
        module.SweepJournal(path, META, resume=True)
    with pytest.raises(ValueError, match="different sweep"):
        module.SweepJournal(str(tmp_path / "own.jsonl"), META,
                            merge=[path])


def test_merge_folds_other_shards_read_only(tmp_path):
    shard = ac.journal_path(str(tmp_path), META, "h1")
    with ref_ac.SweepJournal(shard, META) as journal:
        journal.record_rows(KEYS[:2])
    own = ac.journal_path(str(tmp_path), META, "h2")
    with ac.SweepJournal(own, META, merge=ac.journal_shards(
            str(tmp_path), META)) as journal:
        assert journal.completed == set(KEYS[:2])
        journal.record_rows(KEYS[1:3])
    with open(own) as fh:
        assert [json.loads(ln).get("key") for ln in fh] == [None, KEYS[2]]


def test_read_jsonl_tolerant_skips_the_same_fragments(tmp_path):
    path = tmp_path / "x.jsonl"
    path.write_text('{"a": 1}\n\n   \nnot json\n{"b": [1, 2]}\n'
                    '{"c": "unterminated\n[3]\n{"d": 4')
    ours = list(ac.read_jsonl_tolerant(str(path)))
    assert ours == list(ref_ac.read_jsonl_tolerant(str(path)))
    assert ours == [{"a": 1}, {"b": [1, 2]}, [3]]
    assert ac.read_jsonl_records is ac.read_jsonl_tolerant


@pytest.mark.parametrize("writer,payload", [
    (ac.atomic_write_bytes, b"new"), (ac.atomic_write_text, "new"),
    (ac.atomic_write_json, {"new": 1})])
def test_atomic_write_that_raises_keeps_the_old_content(tmp_path,
                                                         monkeypatch,
                                                         writer, payload):
    path = tmp_path / "artifact"
    path.write_bytes(b"old")

    def boom(_fd):
        raise OSError("disk gone mid-write")
    monkeypatch.setattr(ac.os, "fsync", boom)
    with pytest.raises(OSError, match="mid-write"):
        writer(str(path), payload)
    assert path.read_bytes() == b"old"
    assert os.listdir(tmp_path) == ["artifact"]   # no temp file left
    monkeypatch.undo()
    writer(str(path), payload)
    assert path.read_bytes() != b"old"


# ---- the row layer --------------------------------------------------------------

def _metric(timeline=True):
    tl = np.arange(12, dtype=np.float32).reshape(4, 3) / np.float32(7.0)
    base = (0.1 + 0.2, 1.0 / 3.0)
    return base + (tl,) if timeline else base


@pytest.mark.parametrize("timeline", [True, False])
def test_row_survives_store_and_load_to_the_bit(tmp_path, timeline):
    ws = ac.WarmStart(str(tmp_path / "root"))
    ws.row_store("k", _metric(timeline))
    got = ws.row_load("k")
    _rows_equal([got], [_metric(timeline)])
    assert ws.event_counts("row") == {"store": 1, "hit": 1}
    assert ws.populate_seconds() > 0.0


def test_missing_and_corrupted_rows(tmp_path):
    ws = ac.WarmStart(str(tmp_path))
    assert ws.row_load("absent") is None
    ws.row_store("k", _metric())
    path = ws._row_path("k")
    with open(path, "rb") as fh:
        data = fh.read()
    with open(path, "wb") as fh:
        fh.write(data[:len(data) // 2])
    assert ws.row_load("k") is None
    assert ws.event_counts("row") == {"miss": 1, "store": 1, "corrupt": 1}


def test_row_cache_off_stores_and_serves_nothing(tmp_path):
    ws = ac.WarmStart(str(tmp_path / "root"), row_cache=False)
    ws.row_store("k", _metric())
    assert ws.row_load("k") is None
    assert not os.path.exists(os.path.join(ws.cache_dir, "rows"))
    assert ws.event_counts("row") == {}


def test_summary_keys_and_the_roots(tmp_path, monkeypatch):
    ours = ac.WarmStart(str(tmp_path / "a"))
    theirs = ref_ac.WarmStart(str(tmp_path / "b"))
    assert set(ours.summary()) == set(theirs.summary())
    assert stat.S_IMODE(os.stat(tmp_path / "a").st_mode) == 0o700
    monkeypatch.setenv(ac.CACHE_DIR_ENV, str(tmp_path / "env"))
    assert ac.default_cache_dir() == str(tmp_path / "env")
    monkeypatch.delenv(ac.CACHE_DIR_ENV)
    assert ac.default_cache_dir().endswith(
        os.path.join(".cache", "hlsjs_p2p_wrapper_tpu_torch"))
    assert ac.CACHE_DIR_ENV != ref_ac.CACHE_DIR_ENV
    assert ac.default_cache_dir() != ref_ac.default_cache_dir()


# ---- keys -------------------------------------------------------------------------

def _key(config=None, scenario=None, join=None, n_steps=T,
         watch_s=WATCH_S, record_every=EVERY):
    base_config, items, build = _group(1)
    sc, j = build(items[0])
    return ac.row_key(config or base_config, sc if scenario is None
                      else scenario, j if join is None else join, n_steps,
                      watch_s=watch_s, record_every=record_every)


def test_two_builds_of_one_scenario_give_one_key():
    config, items, build = _group(2)
    keys = {ac.row_key(config, *build(items[0]), T, watch_s=WATCH_S,
                       record_every=EVERY) for _ in range(2)}
    assert len(keys) == 1
    assert ac.row_key(config, *build(items[1]), T, watch_s=WATCH_S,
                      record_every=EVERY) not in keys


@pytest.mark.parametrize("field", port.SwarmScenario._fields)
def test_a_byte_of_any_scenario_field_changes_the_key(field):
    config, items, build = _group(1)
    sc, join = build(items[0])
    t = getattr(sc, field)
    if t.numel() == 0:        # the circulant path's empty neighbour lists
        changed = torch.zeros((t.shape[0], 1), dtype=t.dtype)
    else:
        changed = t.clone().reshape(-1)
        raw = changed.view(torch.uint8)
        raw[-1] ^= 1
        changed = changed.reshape(t.shape)
    assert _key() != _key(scenario=sc._replace(**{field: changed}))


@pytest.mark.parametrize("change", [
    {"join": "join"}, {"n_steps": T + 1}, {"watch_s": WATCH_S + 0.25},
    {"record_every": EVERY + 1}, {"config": "n_segments"},
    {"config": "max_concurrency"}, {"config": "holder_selection"}])
def test_the_run_and_config_change_the_key(change):
    config, items, build = _group(1)
    sc, join = build(items[0])
    if change.get("join"):
        change = {"join": join.clone().index_fill_(0, torch.tensor([3]),
                                                   99.0)}
    elif change.get("config") == "n_segments":
        change = {"config": config._replace(n_segments=S + 1)}
    elif change.get("config") == "max_concurrency":
        change = {"config": config._replace(max_concurrency=3)}
    elif change.get("config") == "holder_selection":
        change = {"config": config._replace(holder_selection="ranked")}
    assert _key() != _key(**change)


def test_device_and_code_change_the_key(monkeypatch, tmp_path):
    base = _key()
    monkeypatch.setattr(ac, "device_signature",
                        lambda device: ("cuda", "NVIDIA H100 80GB HBM3"))
    assert _key() != base
    monkeypatch.undo()
    monkeypatch.setattr(ac, "code_fingerprint", lambda: "edited")
    assert _key() != base
    monkeypatch.undo()
    assert _key() == base
    # an edit to any kernel source changes the fingerprint
    pkg = tmp_path / "pkg"
    shutil.copytree(os.path.dirname(os.path.dirname(ac.__file__)), pkg,
                    ignore=shutil.ignore_patterns("testing", "__pycache__"))
    files = ac._fingerprint_files(str(pkg))
    assert {f for f in files if f.startswith("csrc")} == {
        os.path.join("csrc", n) for n in os.listdir(pkg / "csrc")}
    assert ac._fingerprint(str(pkg)) == ac.code_fingerprint()
    for rel in files:
        edited = tmp_path / "edit"
        shutil.rmtree(edited, ignore_errors=True)
        shutil.copytree(pkg, edited)
        with open(edited / rel, "a") as fh:
            fh.write("\n")
        assert ac._fingerprint(str(edited)) != ac.code_fingerprint()


def test_an_nvcc_flag_edit_changes_the_key(tmp_path):
    """The kernels' nvcc flags change their float bits, so a flag edit
    must key every row anew."""
    assert "ops/_build.py" in ac._fingerprint_files(
        os.path.dirname(os.path.dirname(ac.__file__)))
    pkg = tmp_path / "pkg"
    shutil.copytree(os.path.dirname(os.path.dirname(ac.__file__)), pkg,
                    ignore=shutil.ignore_patterns("testing", "__pycache__"))
    build = pkg / "ops" / "_build.py"
    src = build.read_text()
    assert src.count('"--fmad=false"') == 1
    build.write_text(src.replace('"--fmad=false"', '"--fmad=true"'))
    assert ac._fingerprint(str(pkg)) != ac.code_fingerprint()


def test_cpu_signature_and_toolchain():
    assert ac.device_signature("cpu") == ("cpu", "cpu")
    versions = ac.toolchain_versions("cpu")
    assert versions == {"torch": torch.__version__,
                        "cuda": torch.version.cuda, "nvcc": None}


# ---- the dispatch, on the CPU path -------------------------------------------------

def _no_dispatch(*_a, **_k):
    raise AssertionError("dispatched")


def test_second_run_serves_every_row_from_the_cache(tmp_path, monkeypatch):
    config, items, build = _group()
    ws = ac.WarmStart(str(tmp_path))
    stats = []
    first = list(dp.stream_groups_chunked(
        [(config, items, build)], T, watch_s=WATCH_S, chunk=4,
        record_every=EVERY, warm_start=ws, stats_out=stats))
    assert ws.event_counts("row") == {"miss": 6, "store": 6}
    assert all(ev.key and not ev.cached for ev in first)
    assert stats[0]["row_hits"] == 0 and stats[0]["chunks"] == 2
    plain = dp.run_batch_chunked(config, items, build, T, watch_s=WATCH_S,
                                 chunk=4, record_every=EVERY)
    _rows_equal([ev.metric for ev in sorted(first, key=lambda e: e.index)],
                plain)

    monkeypatch.setattr(dp, "run_swarm_batch", _no_dispatch)
    monkeypatch.setattr(dp, "autotune_chunk", _no_dispatch)
    again = ac.WarmStart(str(tmp_path))
    stats = []
    second = list(dp.stream_groups_chunked(
        [(config, items, build)], T, watch_s=WATCH_S, chunk=None,
        record_every=EVERY, warm_start=again, stats_out=stats))
    assert [ev.index for ev in second] == list(range(6))
    assert all(ev.cached for ev in second)
    assert [ev.key for ev in second] == [
        ev.key for ev in sorted(first, key=lambda e: e.index)]
    _rows_equal([ev.metric for ev in second], plain)
    assert again.event_counts("row") == {"hit": 6}
    assert stats[0] == {"items": 6, "chunk": None, "chunks": 0,
                        "row_hits": 6, "first_dispatch_s": None,
                        "failures": []}
    assert again.prefilter_seconds() > 0.0


def test_partial_hits_dispatch_only_the_misses(tmp_path, monkeypatch):
    """Four rows cached: the two misses dispatch as one chunk sized from
    the six items (the autotuner sees 6), and every row equals the
    uncached run's."""
    config, items, build = _group()
    ws = ac.WarmStart(str(tmp_path))
    dp.run_batch_chunked(config, items[:4], build, T, watch_s=WATCH_S,
                         chunk=4, record_every=EVERY, warm_start=ws)
    seen = []
    tune = dp.autotune_chunk

    def spy(config, n_items, *a, **k):
        seen.append(n_items)
        return tune(config, n_items, *a, **k)
    monkeypatch.setattr(dp, "autotune_chunk", spy)
    stats = []
    events = list(dp.stream_groups_chunked(
        [(config, items, build)], T, watch_s=WATCH_S, record_every=EVERY,
        warm_start=ws, stats_out=stats))
    assert seen == [6]
    assert [(ev.index, ev.cached) for ev in events] == [
        (0, True), (1, True), (2, True), (3, True), (4, False), (5, False)]
    assert stats[0]["row_hits"] == 4 and stats[0]["chunks"] == 1
    _rows_equal([ev.metric for ev in events], dp.run_batch_chunked(
        config, items, build, T, watch_s=WATCH_S, record_every=EVERY))


def test_rows_without_a_timeline_are_not_served_to_a_timeline_run(
        tmp_path):
    config, items, build = _group(2)
    ws = ac.WarmStart(str(tmp_path))
    rows = dp.run_batch_chunked(config, items, build, T, watch_s=WATCH_S,
                                record_every=0, warm_start=ws)
    assert all(len(r) == 2 for r in rows)
    for idx in range(2):   # a timeline run's keys, holding bare rows
        ws.row_store(ws.row_key(config, *build(items[idx]), T,
                                watch_s=WATCH_S, record_every=EVERY),
                     rows[idx])
    stats = []
    events = list(dp.stream_groups_chunked(
        [(config, items, build)], T, watch_s=WATCH_S, record_every=EVERY,
        warm_start=ws, stats_out=stats))
    assert stats[0]["row_hits"] == 0
    assert all(not ev.cached and len(ev.metric) == 3 for ev in events)
    served = dp.run_batch_chunked(config, items, build, T, watch_s=WATCH_S,
                                  record_every=EVERY, warm_start=ws)
    _rows_equal(served, [ev.metric for ev in events])


def test_given_up_rows_are_neither_stored_nor_journaled(tmp_path):
    config, items, build = _group(4)
    ws = ac.WarmStart(str(tmp_path))
    path = ac.journal_path(str(tmp_path), META)
    policy = FaultPolicy(FaultPlan.parse("transient@0:0x9"), max_retries=1,
                         sleep=lambda s: None)
    with ac.SweepJournal(path, META) as journal:
        rows = dp.run_batch_chunked(config, items, build, T,
                                    watch_s=WATCH_S, chunk=2,
                                    record_every=EVERY, warm_start=ws,
                                    journal=journal, faults=policy)
        assert rows[0] is None and rows[1] is None
        assert rows[2] is not None and rows[3] is not None
        assert len(journal.completed) == 2
    keys = [ws.row_key(config, *build(k), T, watch_s=WATCH_S,
                       record_every=EVERY) for k in items]
    assert ws.event_counts("row")["store"] == 2
    assert [os.path.exists(ws._row_path(k)) for k in keys] == [
        False, False, True, True]
    lines = list(ac.read_jsonl_tolerant(path))
    assert [r.get("key") for r in lines if r["kind"] == "row"] == keys[2:]


def test_journal_without_the_row_cache_records_nothing(tmp_path):
    config, items, build = _group(2)
    path = ac.journal_path(str(tmp_path), META)
    with ac.SweepJournal(path, META) as journal:
        rows = dp.run_batch_chunked(
            config, items, build, T, watch_s=WATCH_S, record_every=EVERY,
            warm_start=ac.WarmStart(str(tmp_path), row_cache=False),
            journal=journal)
    assert len(rows) == 2 and journal.completed == set()
    assert [r["kind"] for r in ac.read_jsonl_tolerant(path)] == ["meta"]


def test_the_warm_start_hears_library_events_while_the_stream_runs(
        tmp_path, monkeypatch):
    config, items, build = _group(2)
    ws = ac.WarmStart(str(tmp_path))
    run = dp.run_swarm_batch

    def loading(*a, **k):
        _build.emit("hit")
        return run(*a, **k)
    monkeypatch.setattr(dp, "run_swarm_batch", loading)
    dp.run_batch_chunked(config, items, build, T, watch_s=WATCH_S,
                         chunk=1, warm_start=ws)
    _build.emit("store", 2.5)
    assert ws.event_counts("executable") == {"hit": 2}
    off = ac.WarmStart(str(tmp_path), aot_cache=False)
    dp.run_batch_chunked(config, items, build, T, watch_s=WATCH_S,
                         chunk=1, warm_start=off)
    assert off.event_counts("executable") == {}
    ws.record("store", 2.5)
    assert ws.summary()["executable"] == {"hit": 2, "store": 1}
    populate = {labels["layer"]: value for labels, value in
                ws.registry.series("aot_cache_populate_seconds")}
    assert populate["executable"] == 2.5 and populate["row"] > 0.0


def test_the_journal_meta_is_the_reference_tools(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import sweep as ref_sweep
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    from hlsjs_p2p_wrapper_tpu.engine.population import load_spec as ref_load
    from hlsjs_p2p_wrapper_tpu_torch.engine.population import load_spec
    spec = os.path.join(ROOT, "examples",
                        "population_cellular_broadband.json")
    kw = dict(peers=16, segments=8, watch_s=4.0, live=False, seed=0,
              record_every=0)
    grid = sg.vod_grid()
    for ours, theirs in ((None, None), (load_spec(spec), ref_load(spec))):
        assert (sg.journal_meta(grid, population=ours, **kw)
                == ref_sweep.journal_meta(grid, population=theirs, **kw))
        assert (ac.journal_path(str(tmp_path), sg.journal_meta(
            grid, population=ours, **kw)) == ref_ac.journal_path(
            str(tmp_path), ref_sweep.journal_meta(
                grid, population=theirs, **kw)))


# ---- a killed and resumed process ---------------------------------------------------

#: the reference's process test's sweep (tests/test_resume_process.py):
#: the 48-point VOD grid at 16 peers × 8 segments, chunks of 8, killed
#: as chunk 3 dispatches (chunks 0 and 1 drained and journaled by then:
#: the drain runs one chunk behind)
CHILD_ARGS = ["--peers", "16", "--segments", "8", "--watch-s", "4",
              "--record-every", "4", "--chunk", "8", "--device", "cpu"]


def _child(root, out, *extra):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m",
         "hlsjs_p2p_wrapper_tpu_torch.testing.resumable_sweep",
         "--root", str(root), "--out", str(out), *CHILD_ARGS, *extra],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)


def test_sigkilled_sweep_resumes_bit_exact(tmp_path):
    killed = _child(tmp_path / "run", tmp_path / "out.npz",
                    "--inject-faults", "kill@0:3")
    assert killed.returncode == -signal.SIGKILL, killed.stderr
    assert not (tmp_path / "out.npz").exists()
    meta = sg.journal_meta(sg.vod_grid(), peers=16, segments=8, watch_s=4.0,
                           live=False, seed=0, record_every=4)
    path = ac.journal_path(str(tmp_path / "run"), meta)
    lines = list(ac.read_jsonl_tolerant(path))
    assert sum(r["kind"] == "row" for r in lines) == 16
    assert not any(r["kind"] == "done" for r in lines)

    resumed = _child(tmp_path / "run", tmp_path / "out.npz", "--resume")
    assert resumed.returncode == 0, resumed.stderr
    report = json.loads(resumed.stdout.splitlines()[-1])
    assert report["journal_rows_at_open"] == 16
    assert report["row"] == {"hit": 16, "miss": 32, "store": 32}
    assert report["row_hits"] == 16 and report["chunks"] == 4
    assert report["journal_finished"]
    assert any(r["kind"] == "done" for r in ac.read_jsonl_tolerant(path))

    # the uninterrupted sweep, in this process, against its own root
    config = sg.build_config(16, 8, False, 8)
    grid = sg.vod_grid()

    def build(knobs):
        return sg.build_scenario(config, knobs, watch_s=4.0, stagger_s=60.0,
                                 seed=0, device="cpu")
    want = dp.run_batch_chunked(config, grid, build, 16, watch_s=4.0,
                                chunk=8, record_every=4,
                                warm_start=ac.WarmStart(str(tmp_path / "u")))
    with np.load(tmp_path / "out.npz") as data:
        got = [(float(o), float(r), tl) for o, r, tl in zip(
            data["offload"], data["rebuffer"], data["timeline"])]
    _rows_equal(got, want)


# ---- builds and captures -------------------------------------------------------------

class _FakeNvcc:
    """Stands in for an ``nvcc`` process: writes ``content`` as the
    library."""

    returncode = 0

    def __init__(self, tmp, content):
        self.tmp, self.content = tmp, content

    def communicate(self):
        with open(self.tmp, "wb") as fh:
            fh.write(self.content)
        return "ptxas info    : Used 8 registers", None


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})

    def start(source, defines):
        out = _build.library_path(source, defines)
        tmp = out + ".tmp"
        return _FakeNvcc(tmp, b"\x7fELF a good library"), tmp, out
    monkeypatch.setattr(_build, "_start", start)
    loaded = []

    def cdll(path):
        with open(path, "rb") as fh:
            loaded.append(fh.read())
        return object()
    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    return loaded


class _Events:
    def __init__(self):
        self.events = []

    def record(self, event, seconds=0.0):
        self.events.append(event)


def test_a_flipped_library_is_rebuilt_before_it_loads(fake_build):
    events = _Events()
    _build.listen(events)
    try:
        _build.load("k.cu")
        path = _build.library_path("k.cu")
        assert _build.check(path) == "hit"
        _build._libs.clear()
        _build.load("k.cu")
        with open(path, "r+b") as fh:
            fh.seek(3)
            fh.write(b"X")
        assert _build.check(path) == "corrupt"
        _build._libs.clear()
        _build.load("k.cu")
        os.remove(_build._sidecar(path))
        assert _build.check(path) == "corrupt"
    finally:
        _build.unlisten(events)
    assert events.events == ["miss", "build", "store", "hit", "corrupt",
                             "build", "store"]
    assert fake_build == [b"\x7fELF a good library"] * 3


def test_compile_counter_counts_only_while_attached(fake_build,
                                                    monkeypatch):
    class _Graph:
        def pool(self):
            return None
    monkeypatch.setattr(sk, "_prepare_capture", lambda *a: None)
    monkeypatch.setattr(sk, "_record", lambda fn, dev, pool: _Graph())

    def one_of_each():
        _build.build({"k.cu": ()}, force=True)
        sk.capture(lambda: None, torch.device("cpu"), 1, 16)
    one_of_each()
    with ac.CompileCounter() as probe:
        one_of_each()
        one_of_each()
        assert (probe.builds, probe.captures, probe.compiles) == (2, 2, 4)
    one_of_each()
    assert (probe.builds, probe.captures) == (2, 2)
    attached = ac.CompileCounter().attach()
    _build.load("k.cu")      # loaded from disk: nothing counted
    attached.detach()
    assert attached.compiles == 0
