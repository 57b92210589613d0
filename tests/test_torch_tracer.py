"""The port's flight recorder (``engine/tracer.py``, ``engine/telemetry.py``'s
bump listeners and ``SpanRecorder``) and its dispatch's ``trace=`` and
``tracer=`` (``ops/dispatch.py``) against the reference: the same calls
under one injected clock give byte-equal shards, binary and JSON; the
run id, the merge and the counter replay agree; the port's traced
dispatch emits the reference's sequence of events on the same groups
(without a warm start, whose reference layer this host cannot run); and
with the port's own warm start and journal, every journaled row has one
finalize event and the counters replay exactly."""

import os
import sys
import time

import pytest

from hlsjs_p2p_wrapper_tpu.engine import faults as ref_faults
from hlsjs_p2p_wrapper_tpu.engine import telemetry as ref_telemetry
from hlsjs_p2p_wrapper_tpu.engine import tracer as ref_tracer
from hlsjs_p2p_wrapper_tpu.ops import swarm_sim as ref_sim
from hlsjs_p2p_wrapper_tpu_torch import sweep_grid as sg
from hlsjs_p2p_wrapper_tpu_torch.engine import faults as port_faults
from hlsjs_p2p_wrapper_tpu_torch.engine import telemetry as port_telemetry
from hlsjs_p2p_wrapper_tpu_torch.engine import tracer as port_tracer
from hlsjs_p2p_wrapper_tpu_torch.engine.artifact_cache import (
    SweepJournal, WarmStart, journal_path, read_jsonl_tolerant)
from hlsjs_p2p_wrapper_tpu_torch.ops import dispatch as dp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import sweep as ref_sweep  # noqa: E402

P, S, T = 48, 16, 30
WATCH_S = T * 0.25
PLAN = "transient@0:1x2"


class _Clock:
    """An injected clock: each read advances a quarter second."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        self.now += 0.25
        return self.now


def _record(tracer, telemetry, trace_dir, binary, monkeypatch):
    """One fixed sequence of recorder calls: context frames, counter
    bumps through an attached registry (inside and outside a context),
    a span, rows, a lease, a mark, a gauge write (no event), flushes."""
    ticks = iter(range(1000))
    monkeypatch.setattr(time, "perf_counter",
                        lambda: 0.125 * next(ticks))
    registry = telemetry.MetricsRegistry()
    rec = tracer.FlightRecorder(str(trace_dir), "host07", run_id="run-x",
                                clock=_Clock(), registry=registry,
                                binary=binary)
    registry.counter("dispatch_faults", reason="oom",
                     action="bisect").inc()
    with rec.context(group=0, chunk=2):
        with rec.context(attempt=1):
            registry.counter("dispatch_faults", reason="transient",
                             action="retry").inc(2)
        with rec.span("dispatch", group=0, chunk=2):
            registry.counter("aot_cache_events", layer="row",
                             result="miss").inc()
        rec.row("k" * 64, group=0, index=3, journaled=True)
    rec.row(None, group=1, index=0, cached=True)
    rec.lease("steal", unit=4, gen=1, prev_host="host01")
    registry.gauge("fabric_heartbeat_s", host="host07").set(5.0)
    registry.counter("fabric_claims", action="steal").inc()
    rec.mark("search_round", round=0, best_offload=0.5)
    rec.flush()
    rec.close()
    registry.counter("fabric_claims", action="claim").inc()   # detached
    return registry, rec.path


@pytest.mark.parametrize("binary", [True, False])
def test_shards_are_byte_equal(tmp_path, monkeypatch, binary):
    reg_r, path_r = _record(ref_tracer, ref_telemetry, tmp_path / "ref",
                            binary, monkeypatch)
    reg_p, path_p = _record(port_tracer, port_telemetry, tmp_path / "port",
                            binary, monkeypatch)
    with open(path_r, "rb") as fh_r, open(path_p, "rb") as fh_p:
        data = fh_p.read()
        assert data == fh_r.read() and len(data) > 200
    meta_r, events_r = ref_tracer.read_shard(path_r)
    meta_p, events_p = port_tracer.read_shard(path_p)
    assert (meta_p, events_p) == (meta_r, events_r)
    assert port_tracer.read_shard(path_r) == (meta_r, events_r)
    merged = port_tracer.merge_trace(str(tmp_path / "port"))
    assert merged == ref_tracer.merge_trace(str(tmp_path / "ref"))
    assert merged == ref_tracer.merge_trace([path_p])
    # the detached bump is in the registry, not in the stream
    replay = port_tracer.replay_counter_families(merged)
    families = port_tracer.counter_families(reg_p)
    assert replay == ref_tracer.replay_counter_families(merged)
    assert families == ref_tracer.counter_families(reg_r)
    assert families["fabric_claims"] == {"action=claim": 1,
                                         "action=steal": 1}
    assert replay["fabric_claims"] == {"action=steal": 1}
    assert replay["dispatch_faults"] == families["dispatch_faults"]
    assert port_tracer.finalize_keys(merged) == {"k" * 64: 1}
    ctx = [e.get("ctx") for e in merged if e["kind"] == "counter"]
    assert ctx[1] == {"group": 0, "chunk": 2, "attempt": 1}


def test_run_id_and_span_recorder_agree():
    for meta in ({}, {"tool": "sweep", "peers": 16, "grid": [{"a": 1.5}]}):
        assert port_tracer.run_id_for(meta) == ref_tracer.run_id_for(meta)
    spans = port_telemetry.SpanRecorder()
    with spans.span("build", chunk=0):
        pass
    with spans.span("build", chunk=1):
        pass
    assert [s["chunk"] for s in spans.by_name()["build"]] == [0, 1]
    assert spans.total("build") >= 0.0 and spans.total("none") == 0


def _groups(n_items=5):
    items = sg.vod_grid()[:n_items]
    config = sg.build_config(P, S, False, 8)
    ref_config = ref_sweep.build_config(P, S, False, 8)

    def build(knobs):
        return sg.build_scenario(config, knobs, watch_s=WATCH_S,
                                 stagger_s=5.0, seed=0, device="cpu")

    def ref_build(knobs):
        return ref_sweep.build_scenario(ref_config, knobs, watch_s=WATCH_S,
                                        stagger_s=5.0, seed=0)
    return (config, items, build), (ref_config, items, ref_build)


def _sequence(events):
    """What the two dispatches must agree on: each event's kind, name,
    context, journaled flag and coordinates (keys and durations
    differ by design)."""
    return [(e["kind"], e.get("name"), e.get("ctx"), e.get("journaled"),
             e.get("labels"), e.get("group"), e.get("chunk"),
             e.get("index"), e.get("cached")) for e in events]


def test_dispatch_events_match_the_reference(tmp_path):
    """The same groups, chunk 2 (the reference pads the tail chunk, the
    port runs it as it is), a transient fault twice on chunk 1: the
    reference's ``stream_groups_chunked`` and the port's emit the same
    event sequence and the same spans, and the port's rows equal its
    untraced rows to the bit."""
    group, ref_group = _groups()
    streams = {}
    for side, mod, tel, flt, trc, grp in (
            ("ref", ref_sim, ref_telemetry, ref_faults, ref_tracer,
             ref_group),
            ("port", dp, port_telemetry, port_faults, port_tracer, group)):
        policy = flt.FaultPolicy(plan=flt.FaultPlan.parse(PLAN),
                                 sleep=lambda s: None)
        rec = trc.FlightRecorder(str(tmp_path / side), "h0",
                                 registry=policy.registry)
        spans = tel.SpanRecorder()
        events = list(mod.stream_groups_chunked(
            [grp], T, watch_s=WATCH_S, chunk=2, faults=policy,
            tracer=spans, trace=rec))
        rec.close()
        streams[side] = (events, port_tracer.merge_trace(
            str(tmp_path / side)), spans, policy)
    ref_events, ref_trace, ref_spans, ref_policy = streams["ref"]
    events, trace, spans, policy = streams["port"]
    assert _sequence(trace) == _sequence(ref_trace)
    assert [(s["name"], s["group"], s["chunk"]) for s in spans.spans] == \
        [(s["name"], s["group"], s["chunk"]) for s in ref_spans.spans]
    assert policy.fault_counts() == ref_policy.fault_counts() == {
        "transient|retry": 2}
    assert [(e.group, e.index) for e in events] == \
        [(e.group, e.index) for e in ref_events]
    for e, r in zip(events, ref_events):
        assert abs(e.metric[0] - r.metric[0]) <= 1e-4
        assert abs(e.metric[1] - r.metric[1]) <= 1e-4
    retries = [e for e in trace if e["kind"] == "counter"]
    assert [e["ctx"] for e in retries] == [
        {"group": 0, "chunk": 1, "attempt": 0},
        {"group": 0, "chunk": 1, "attempt": 1}]
    untraced = dp.run_batch_chunked(*group, T, watch_s=WATCH_S, chunk=2)
    assert [e.metric for e in sorted(events, key=lambda e: e.index)] == \
        untraced


def test_journaled_rows_have_one_finalize_event(tmp_path):
    """The port's warm start and journal under the recorder, with the
    fault plan: every journaled key has exactly one finalize event, the
    counters replay to the registry exactly, and a warm rerun streams
    cached row events and no dispatch span."""
    config, items, build = _groups()[0]
    warm = WarmStart(str(tmp_path / "cache"))
    meta = {"t": "trace-test"}
    jpath = journal_path(warm.cache_dir, meta)
    policy = port_faults.FaultPolicy(
        plan=port_faults.FaultPlan.parse(PLAN), registry=warm.registry,
        sleep=lambda s: None)
    rec = port_tracer.FlightRecorder(str(tmp_path / "trace"), "h0",
                                     registry=warm.registry)
    with SweepJournal(jpath, meta) as journal:
        rows = dp.run_batch_chunked(config, items, build, T,
                                    watch_s=WATCH_S, chunk=2,
                                    warm_start=warm, faults=policy,
                                    journal=journal, trace=rec)
    rec.close()
    assert rows == dp.run_batch_chunked(config, items, build, T,
                                        watch_s=WATCH_S, chunk=2)
    events = port_tracer.merge_trace(str(tmp_path / "trace"))
    journaled = [r["key"] for r in read_jsonl_tolerant(jpath)
                 if r.get("kind") == "row"]
    finals = port_tracer.finalize_keys(events)
    assert len(journaled) == len(items)
    assert sorted(finals) == sorted(journaled)
    assert set(finals.values()) == {1}
    assert port_tracer.replay_counter_families(events) == \
        port_tracer.counter_families(warm.registry)
    assert port_tracer.counter_families(warm.registry)[
        "aot_cache_events"]["layer=row,result=store"] == len(items)

    rec = port_tracer.FlightRecorder(str(tmp_path / "warm"), "h0",
                                     registry=warm.registry)
    spans = port_telemetry.SpanRecorder()
    again = dp.run_batch_chunked(config, items, build, T, watch_s=WATCH_S,
                                 chunk=2, warm_start=warm, trace=rec,
                                 tracer=spans)
    rec.close()
    assert again == rows
    events = port_tracer.merge_trace(str(tmp_path / "warm"))
    assert [e["cached"] for e in events if e["kind"] == "row"] == \
        [True] * len(items)
    assert not any(e["kind"] == "span" for e in events) and not spans.spans
    assert port_tracer.finalize_keys(events) == {}
