"""The port's multi-host sweep fabric (``engine/fabric.py``) on the CPU:
two ``WorkLedger`` hosts in one process share a small VOD grid through
``run_units`` on the port's dispatch, under one injected clock, with a
``FleetChaos`` stall that lets the second host steal the first one's
unit; their merged rows equal the port's single-host dispatch to the
bit, and their journals and traces agree.  The same protocol steps
through the reference's ``WorkLedger`` and the port's write byte-equal
manifests, claim files and lease traces, and ``fleet_report`` reads
them alike."""

import os

import numpy as np

from hlsjs_p2p_wrapper_tpu.engine import fabric as ref_fabric
from hlsjs_p2p_wrapper_tpu.engine import telemetry as ref_telemetry
from hlsjs_p2p_wrapper_tpu.engine import tracer as ref_tracer
from hlsjs_p2p_wrapper_tpu_torch import sweep_grid as sg
from hlsjs_p2p_wrapper_tpu_torch.engine import fabric as port_fabric
from hlsjs_p2p_wrapper_tpu_torch.engine import telemetry as port_telemetry
from hlsjs_p2p_wrapper_tpu_torch.engine import tracer as port_tracer
from hlsjs_p2p_wrapper_tpu_torch.engine.artifact_cache import (
    SweepJournal, WarmStart, journal_path, read_jsonl_tolerant)
from hlsjs_p2p_wrapper_tpu_torch.ops import dispatch as dp

P, S, T, EVERY = 48, 16, 30, 10
WATCH_S = T * 0.25
LEASE_S = 10.0
META = {"tool": "sweep", "peers": P, "segments": S, "watch_s": WATCH_S}


class _Clock:
    """An injected clock and sleep: time moves only when slept."""

    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now

    def sleep(self, seconds):
        self.now += seconds


def _group(n_items=6):
    config = sg.build_config(P, S, False, 8)

    def build(knobs):
        return sg.build_scenario(config, knobs, watch_s=WATCH_S,
                                 stagger_s=5.0, seed=0, device="cpu")
    return config, sg.vod_grid()[:n_items], build


def test_two_hosts_steal_and_equal_the_single_host_rows(tmp_path):
    """host00 finishes its first unit, then stalls past its lease on its
    second claim; while it sleeps, host01 runs: it steals the stalled
    unit (an expiry and a steal) and claims the rest; host00 wakes,
    computes its unit from the row cache and loses the finalize (a
    duplicate).  Every row equals the single-host dispatch's to the
    bit, each journaled row has one finalize event in its host's trace,
    and each host's counters replay from its shard."""
    config, items, build = _group()
    groups = [(config, items, build)]
    want = dp.run_batch_chunked(config, items, build, T, watch_s=WATCH_S,
                                chunk=2, record_every=EVERY)
    clock = _Clock()
    fabric_dir, root = str(tmp_path / "fabric"), str(tmp_path / "cache")
    hosts = {}
    for host in ("host00", "host01"):
        warm = WarmStart(root)
        rec = port_tracer.FlightRecorder(str(tmp_path / "trace"), host,
                                         clock=clock,
                                         registry=warm.registry)
        hosts[host] = {"warm": warm, "trace": rec,
                       "journal": SweepJournal(journal_path(root, META,
                                                            host), META)}
    out = {}

    def run(host):
        h = hosts[host]
        out[host] = port_fabric.run_units(
            h["ledger"], groups, T, watch_s=WATCH_S, record_every=EVERY,
            warm_start=h["warm"], journal=h["journal"], poll_s=0.5)

    def stall(seconds):
        clock.sleep(seconds)
        if "host01" not in out:
            run("host01")

    for host, chaos, sleep in (
            ("host00", port_fabric.FleetChaos.parse("stall@1:30"), stall),
            ("host01", None, clock.sleep)):
        h = hosts[host]
        h["ledger"] = port_fabric.WorkLedger(
            fabric_dir, META, host, lease_s=LEASE_S, clock=clock,
            sleep=sleep, registry=h["warm"].registry, chaos=chaos,
            trace=h["trace"])
        assert h["ledger"].ensure_manifest([len(items)], [2])[1] == [2]
    run("host00")
    for h in hosts.values():
        h["journal"].close()
        h["trace"].close()

    merged = {}
    for host in ("host01", "host00"):
        for index, metric in out[host][0][0].items():
            if index in merged:   # the duplicate unit: the same bits
                assert metric[:2] == merged[index][:2]
                np.testing.assert_array_equal(metric[2], merged[index][2])
            merged[index] = metric
    assert sorted(merged) == list(range(len(items)))
    for index, row in enumerate(want):
        assert merged[index][:2] == row[:2]
        np.testing.assert_array_equal(merged[index][2], row[2])

    claims = {host: h["ledger"].claim_counts()
              for host, h in hosts.items()}
    assert claims == {"host00": {"claim": 2, "duplicate": 1},
                      "host01": {"claim": 1, "expire": 1, "steal": 1}}
    assert [u["won"] for u in out["host00"][1]] == [True, False]
    report = port_fabric.fleet_report(fabric_dir)
    assert (report["steals"], report["expires"], report["duplicates"],
            report["finished"]) == (1, 1, 1, 3)
    assert report == ref_fabric.fleet_report(fabric_dir)
    for host, h in hosts.items():
        _meta, events = port_tracer.read_shard(h["trace"].path)
        journaled = [r["key"] for r in read_jsonl_tolerant(
            journal_path(root, META, host)) if r.get("kind") == "row"]
        finals = port_tracer.finalize_keys(events)
        assert sorted(finals) == sorted(journaled) and journaled
        assert set(finals.values()) == {1}
        assert port_tracer.replay_counter_families(events) == \
            port_tracer.counter_families(h["warm"].registry)
    # the duplicate unit came from the row cache, with no finalize event
    assert hosts["host00"]["warm"].event_counts("row")["hit"] == 2


def _protocol(fabric, tracer, telemetry, root):
    """One fixed sequence of ledger calls under an injected clock: two
    hosts, seven items in units of three, a stall past the lease, a
    steal, a duplicate, the start-line barrier; returns what each call
    gave and the registries' claim counts."""
    clock = _Clock()
    steps, ledgers = [], {}
    for host, chaos in (("host00", "stall@1:25"), ("host01", None)):
        registry = telemetry.MetricsRegistry()
        rec = tracer.FlightRecorder(os.path.join(root, "trace"), host,
                                    run_id="run-f", clock=clock,
                                    registry=registry)
        ledgers[host] = (fabric.WorkLedger(
            os.path.join(root, "fabric"), META, host, lease_s=LEASE_S,
            clock=clock, sleep=clock.sleep, registry=registry,
            chaos=fabric.FleetChaos.parse(chaos) if chaos else None,
            trace=rec), rec)
        steps.append(ledgers[host][0].ensure_manifest([7], [3]))
        fabric.barrier(os.path.join(root, "fabric"), host, 1,
                       clock=clock, sleep=clock.sleep)
    a, b = ledgers["host00"][0], ledgers["host01"][0]
    u = a.next_unit()
    a.heartbeat(u)
    clock.sleep(2.0)
    steps += [u, a.finalize(u, rows=3)]
    u2 = a.next_unit()            # stalls 25 s holding a 10-s lease
    steps.append(u2)
    while True:
        v = b.next_unit()
        steps.append(v)
        if v is None:
            break
        b.heartbeat(v)
        clock.sleep(1.0)
        steps.append(b.finalize(v, rows=v.count))
    steps += [a.finalize(u2, rows=u2.count), a.next_unit()]
    counts = {}
    for host, (ledger, rec) in ledgers.items():
        rec.close()
        counts[host] = ledger.claim_counts()
    return steps, counts


def _files(root):
    out = {}
    for base, _dirs, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_claim_files_equal_the_reference(tmp_path):
    ref_steps, ref_counts = _protocol(ref_fabric, ref_tracer,
                                      ref_telemetry, str(tmp_path / "ref"))
    steps, counts = _protocol(port_fabric, port_tracer, port_telemetry,
                              str(tmp_path / "port"))
    assert [tuple(s) if isinstance(s, tuple) else s for s in steps] == \
        [tuple(s) if isinstance(s, tuple) else s for s in ref_steps]
    assert counts == ref_counts
    assert counts["host01"]["steal"] == 1
    assert counts["host00"]["duplicate"] == 1
    got, want = _files(str(tmp_path / "port")), _files(str(tmp_path / "ref"))
    assert sorted(got) == sorted(want)
    assert any(name.startswith(os.path.join("fabric", "claims"))
               for name in got)
    for name in want:
        assert got[name] == want[name], name
    for report in (port_fabric.fleet_report, ref_fabric.fleet_report):
        assert report(str(tmp_path / "port" / "fabric")) == \
            ref_fabric.fleet_report(str(tmp_path / "ref" / "fabric"))
    assert port_fabric.plan_units([7, 2], [3, 4]) == \
        ref_fabric.plan_units([7, 2], [3, 4])
