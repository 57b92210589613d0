"""The port's observation plane and the twin's sim half against the JAX
reference on the CPU: the quantile digest, the segment and track views,
the frame reducers on a recorded shard (one shard, and four split
ways), the SLO evaluator, the forecast's membership mapping and CDN
pacing, and the sim plane on the twin gate's scenarios (the reference's
sim frames, and the committed ``TWIN_r10.json`` bands against its real
plane)."""

import json
import os
import sys

import numpy as np
import pytest

from hlsjs_p2p_wrapper_tpu.core import segment_view as r_segment_view
from hlsjs_p2p_wrapper_tpu.core import track_view as r_track_view
from hlsjs_p2p_wrapper_tpu.engine import digest as r_digest
from hlsjs_p2p_wrapper_tpu.engine import slo as r_slo
from hlsjs_p2p_wrapper_tpu.engine import twinframe as r_twinframe
from hlsjs_p2p_wrapper_tpu.engine.tracer import read_shard as r_read_shard
from hlsjs_p2p_wrapper_tpu.testing import twin as r_twin
from hlsjs_p2p_wrapper_tpu_torch.core import segment_view, track_view
from hlsjs_p2p_wrapper_tpu_torch.engine import digest, slo, twinframe
from hlsjs_p2p_wrapper_tpu_torch.engine.tracer import read_shard
from hlsjs_p2p_wrapper_tpu_torch.testing import control_fixture as cf
from hlsjs_p2p_wrapper_tpu_torch.testing import twin

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import torch_port_twin_fixture as fixture_tool  # noqa: E402

BANDS = os.path.join(ROOT, "TWIN_r10.json")


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    """The committed control-gate shard (a recorded real plane)."""
    return cf.unpack_shard(str(tmp_path_factory.mktemp("shard")
                               / "shard.jsonl"))


@pytest.fixture(scope="module")
def splits(shard, tmp_path_factory):
    """The shard split four ways by each package's ``split_shard``."""
    root = tmp_path_factory.mktemp("splits")
    return (twin.split_shard(shard, str(root / "port"), 4),
            r_twin.split_shard(shard, str(root / "ref"), 4))


@pytest.fixture(scope="module")
def sim_planes():
    """The reference's clean and chaos real and sim planes (recorded
    once a process, shared with the fixture's staleness test) and the
    port's sim plane of the clean scenario on the CPU.  The sim plane
    does not model the wire faults, so the chaos scenario's sim input
    is the clean one's."""
    planes = fixture_tool.twin_planes()
    clean = planes["clean"][0]
    port_spec = cf.scenario_from_dict(fixture_tool.spec_dict(clean))
    return planes, twin.run_sim_plane(port_spec, device="cpu")


# ---- digest ------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantile_digest_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    values = np.concatenate([np.zeros(20), rng.lognormal(5.0, 2.5, 500),
                             [2e5, 1.0, digest.DEFAULT_EDGES[3]]])
    ours, theirs = digest.QuantileDigest(), r_digest.QuantileDigest()
    for v in values.tolist():
        ours.add(v)
        theirs.add(v)
    assert ours.counts == theirs.counts
    assert ours.read() == theirs.read()
    qs = (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0)
    assert ours.quantiles(qs) == theirs.quantiles(qs)
    assert ours.as_dict() == theirs.as_dict()
    counts = rng.integers(0, 7, len(digest.DEFAULT_EDGES) + 1).tolist()
    assert (digest.quantiles_from_counts(digest.DEFAULT_EDGES, counts, qs)
            == r_digest.quantiles_from_counts(r_digest.DEFAULT_EDGES,
                                              counts, qs))
    assert digest.REPORTED_QUANTILES == r_digest.REPORTED_QUANTILES
    assert ([digest.bin_index(digest.DEFAULT_EDGES, v) for v in values]
            == [r_digest.bin_index(r_digest.DEFAULT_EDGES, v)
                for v in values])


def test_segment_views_match_the_reference_wire_bytes():
    for level, url_id, sn in ((0, 0, 0), (3, 1, 0x01020304), (7, 2, 99)):
        ours = segment_view.SegmentView(
            sn=sn, track_view=track_view.TrackView(level=level,
                                                   url_id=url_id))
        theirs = r_segment_view.SegmentView(
            sn=sn, track_view=r_track_view.TrackView(level=level,
                                                     url_id=url_id))
        assert ours.to_bytes() == theirs.to_bytes()
        assert str(ours.track_view) == str(theirs.track_view)
        back = segment_view.SegmentView.from_bytes(theirs.to_bytes())
        assert back.is_equal(ours)


# ---- frames from a recorded shard -------------------------------------


def test_frames_from_events_match_the_reference(shard):
    _meta, events = read_shard(shard)
    _rmeta, r_events = r_read_shard(shard)
    ours = twinframe.frames_from_events(events)
    theirs = r_twinframe.frames_from_events(r_events)
    assert ours.n_windows == 20
    assert ours.as_dict() == theirs.as_dict()


def test_frames_from_shards_match_the_reference_one_and_four(shard,
                                                             splits):
    port_paths, ref_paths = splits
    for a, b in zip(port_paths, ref_paths):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    one = twinframe.frames_from_shards([shard])
    assert one.as_dict() == r_twinframe.frames_from_shards(
        [shard]).as_dict()
    four = twinframe.frames_from_shards(port_paths)
    assert four.as_dict() == r_twinframe.frames_from_shards(
        ref_paths).as_dict()
    assert four.as_dict() == one.as_dict()   # the mux merge is exact


def test_slo_alerts_match_the_reference(splits):
    port_paths, ref_paths = splits
    config = cf.load_json(cf.CONTROL_DECISIONS)["configs"]["b"]
    cohorts = config["cohorts"]
    out = []
    for mod, tf, paths in ((slo, twinframe, port_paths),
                           (r_slo, r_twinframe, ref_paths)):
        mux = tf.ShardMuxFollower(paths, per_shard=True)
        mux.poll()
        specs = [mod.SLOSpec.from_dict(d) for d in config["slo_specs"]]
        evaluator = mod.evaluate_mux(
            mux, specs, cohort_of=lambda p: cohorts.get(p, "all"),
            warmup_windows=config["slo_warmup_windows"])
        out.append((evaluator.alerts, evaluator.summary(),
                    mod.worst_shard(specs[0], {s: rows[-1] for s, rows
                                               in mux.shard_rows.items()})))
    assert out[0] == out[1]
    assert len(out[0][0]) == 1   # the loss window burns the budget


# ---- the forecast's inputs ---------------------------------------------


def test_scenario_from_observation_matches_the_reference(shard):
    spec = cf.scenario_from_dict(
        cf.load_json(cf.CONTROL_DECISIONS)["configs"]["a"]["spec"])
    r_spec = r_twin.TwinScenario(**fixture_tool.spec_dict(spec))
    mux = twinframe.ShardMuxFollower([shard])
    mux.poll()
    assert len(mux.rows) == 20
    for window in range(len(mux.rows)):
        join_ms, leave_ms = mux.membership_at(window)
        assert (twin.scenario_from_observation(spec, join_ms, leave_ms)
                == r_twin.scenario_from_observation(r_spec, join_ms,
                                                    leave_ms))
    departed = {"p3": 30_000.0, "p0": 45_500.0}
    joined = {f"p{i}": 500.0 + 6_000.0 * i for i in range(6)}
    assert (twin.scenario_from_observation(spec, joined, departed)
            == r_twin.scenario_from_observation(r_spec, joined, departed))
    with pytest.raises(ValueError, match="exceeds"):
        twin.scenario_from_observation(
            spec, {f"p{i}": 0.0 for i in range(spec.total_peers + 1)})


@pytest.mark.parametrize("fields", [
    {}, {"cdn_bps": 1_200_000.0, "uplink_bps": 900_000.0},
    {"cdn_bps": 3_300_000.0, "cdn_latency_ms": 40.0,
     "level_bitrates": (2_000_000.0, 800_000.0), "seg_duration_s": 2.0}])
def test_effective_cdn_bps_and_sim_config_match_the_reference(fields):
    ours = twin.TwinScenario(**fields)
    theirs = r_twin.TwinScenario(**fields)
    assert twin.effective_cdn_bps(ours) == r_twin.effective_cdn_bps(theirs)
    assert (tuple(twin.parity_sim_config(ours))
            == tuple(r_twin.parity_sim_config(theirs)))
    assert ours.join_times_s(16.0) == theirs.join_times_s(16.0)
    assert ours.uplinks_bps() == theirs.uplinks_bps()
    assert twin.SIM_CONCURRENCY == r_twin.SIM_CONCURRENCY
    assert twin.ABSENT_JOIN_S == r_twin.ABSENT_JOIN_S
    from hlsjs_p2p_wrapper_tpu.testing.mock_cdn import MockCdnTransport
    assert twin.CDN_CHUNK_MS == MockCdnTransport.CHUNK_MS


# ---- the sim plane -----------------------------------------------------


@pytest.mark.parametrize("name", ["clean", "chaos"])
def test_sim_plane_matches_the_reference_sim(sim_planes, name):
    planes, ours = sim_planes
    _scenario, _real, theirs = planes[name]
    assert ours.columns == theirs.columns
    assert cf.frames_agree(ours, theirs) == []


@pytest.mark.parametrize("name", ["clean", "chaos"])
def test_sim_plane_inside_the_committed_bands(sim_planes, name):
    """``tools/twin_gate.py``'s agreement check on the port's sim
    plane: ``compare_frames`` against the reference's real plane finds
    nothing under the committed bands."""
    planes, ours = sim_planes
    _scenario, real, _sim = planes[name]
    with open(BANDS, encoding="utf-8") as fh:
        bands = json.load(fh)["scenarios"][name]["bands"]
    real_frame = twinframe.ObservationFrame.from_dict(
        real.registry_frames.as_dict())
    assert twinframe.compare_frames(ours, real_frame, bands) == []


def test_frame_agreement_catches_a_peer_count():
    """The tolerance helper the card's checks use: a peer count one off
    or a float column past its tolerance is reported."""
    frame = twinframe.ObservationFrame(
        "sim", 8.0, twinframe.FRAME_COLUMNS,
        tuple(tuple(float(i + j)
                    for j in range(len(twinframe.FRAME_COLUMNS)))
              for i in range(3)))
    assert cf.frames_agree(frame, frame) == []
    rows = [list(r) for r in frame.samples]
    rows[1][twinframe.FRAME_COLUMNS.index("joins")] += 1.0
    rows[2][twinframe.FRAME_COLUMNS.index("offload")] *= 1.0 + 1e-4
    bad = cf.frames_agree(
        frame._replace(samples=tuple(tuple(r) for r in rows)), frame)
    assert [b.split(" ")[0] for b in bad] == ["offload", "joins"]
