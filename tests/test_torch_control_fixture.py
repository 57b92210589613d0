"""The committed control fixture (``testing/reference_control/``) that
``chip_smoke.py`` phases 39-41 hold the port to on the card, where there
is no JAX: it must still be what the reference gives (regenerate with
``JAX_PLATFORMS=cpu python tools/torch_port_twin_fixture.py``), and the
decisions it records must sit farther than twice the forecast tolerance
from changing."""

import os
import sys

import pytest

from hlsjs_p2p_wrapper_tpu_torch.testing import control_fixture as cf

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import torch_port_twin_fixture as fixture_tool  # noqa: E402


def test_twin_frames_are_the_reference_s():
    """The real planes (recorded again: the twin scenario is
    deterministic per seed), the sim planes and the shifted wave."""
    assert cf.load_json(cf.TWIN_FRAMES) == fixture_tool.twin_frames_doc()


def test_decisions_are_the_reference_s_on_the_committed_shard():
    doc = cf.load_json(cf.CONTROL_DECISIONS)
    fresh = fixture_tool.control_decisions_doc(cf.CONTROL_SHARD)
    assert doc == fresh
    runs = fixture_tool.control_runs(cf.CONTROL_SHARD)
    # the fleet form: four shards give the one shard's decisions
    assert (cf.decision_sig(runs["b4"].decisions)
            == doc["runs"]["b"]["decisions"])


@pytest.mark.parametrize("key", ["a", "b"])
def test_fixture_decisions_are_not_lucky(key):
    doc = cf.load_json(cf.CONTROL_DECISIONS)
    run = doc["runs"][key]
    margins = cf.run_margins(doc["configs"][key], run)
    assert [m["tick"] for m in margins] == [r[0] for r in run["forecasts"]]
    assert len(margins) == len(run["decisions"]) - doc["configs"][key][
        "warmup_windows"]
    assert min(v for m in margins for k, v in m.items()
               if k != "tick") > 2 * cf.FORECAST_TOL
    # the runs the card is held to actuate, and (b) burns its budget
    assert any(d[1] == "actuate" for d in run["decisions"])
    if key == "b":
        assert run["burn_windows"]


def test_fixture_shard_is_the_control_gate_s_scenario():
    """The shard's windows and membership are the control gate's
    scenario: 20 frame windows, every peer of its audience seen."""
    from hlsjs_p2p_wrapper_tpu_torch.engine.twinframe import (
        ShardMuxFollower)
    import tempfile
    with tempfile.TemporaryDirectory() as root:
        shard = cf.unpack_shard(os.path.join(root, "shard.jsonl"))
        mux = ShardMuxFollower([shard])
        mux.poll()
        spec = cf.scenario_from_dict(
            cf.load_json(cf.CONTROL_DECISIONS)["configs"]["a"]["spec"])
        assert len(mux.rows) == spec.n_windows == 20
        join_ms, _leave_ms = mux.membership_at(len(mux.rows) - 1)
        assert len(join_ms) == spec.total_peers
