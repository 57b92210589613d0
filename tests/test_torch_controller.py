"""The port's control plane against the JAX reference on the CPU: the
wire grammar the actuators speak (``engine/protocol.py``), the decision
function, the controller identity, and ``ControlLoop`` replaying a
recorded real-plane shard (``tests/test_controller.py``'s HA chaos
scenario) with its forecasts on the port's dispatch: the reference's
decisions tick for tick, forecasts within ``FORECAST_TOL``, every
decision farther than twice that from changing, a warm rerun with
nothing dispatched, a resume from the checkpoint, and the HA standby's
takeover.  The reference's loop runs without a warm start."""

import dataclasses
import itertools
import random

import pytest

from hlsjs_p2p_wrapper_tpu.core.segment_view import \
    SegmentView as RSegmentView
from hlsjs_p2p_wrapper_tpu.core.track_view import TrackView as RTrackView
from hlsjs_p2p_wrapper_tpu.engine import controller as r_controller
from hlsjs_p2p_wrapper_tpu.engine import protocol as r_protocol
from hlsjs_p2p_wrapper_tpu.engine import search as r_search
from hlsjs_p2p_wrapper_tpu.testing import twin as r_twin
from hlsjs_p2p_wrapper_tpu_torch.engine import controller, protocol, search
from hlsjs_p2p_wrapper_tpu_torch.engine.artifact_cache import (WarmStart,
                                                               _digest)
from hlsjs_p2p_wrapper_tpu_torch.testing import control_fixture as cf
from hlsjs_p2p_wrapper_tpu_torch.testing import twin

KEY = RSegmentView(sn=42, track_view=RTrackView(level=1, url_id=0)
                   ).to_bytes()
DIGEST = bytes(range(32))

#: every message type, as (class name, arguments)
MESSAGES = [
    ("Hello", ("swarm-abc", "peer-1")),
    ("Have", (KEY, 3, DIGEST)),
    ("Bitfield", (((KEY, 10, DIGEST), (KEY[:8] + b"\x07\0\0\0", 0,
                                       DIGEST[::-1])),)),
    ("Bitfield", ((),)),
    ("Request", (77, KEY)),
    ("Cancel", (77,)),
    ("Chunk", (77, 0, 1000, b"\x00\x01payload")),
    ("Deny", (77, 1)),
    ("Lost", (KEY,)),
    ("Bye", ()),
    ("Announce", ("swarm-abc", "peer-1")),
    ("Peers", ("swarm-abc", ("a", "b", "c"))),
    ("Leave", ("swarm-abc", "peer-1")),
    ("SetKnobs", ("swarm-abc", 3, (("p2p_budget_cap_ms", 500.0),
                                   ("p2p_budget_fraction", 0.9)))),
    ("SetKnobs", ("swarm-abc", 4, (("urgent_margin_s", 2.5),), 7)),
    ("KnobUpdate", ("swarm-abc", 3, (("p2p_budget_cap_ms", 6000.0),))),
    ("KnobUpdate", ("swarm-abc", 9, (), 2)),
    ("CtrlLease", ("swarm-abc", "ctrl-a", 0, 1500)),
    ("CtrlLeaseAck", ("swarm-abc", "ctrl-a", 2, 1200, True, 5)),
    ("CtrlLeaseAck", ("swarm-abc", "", 0, 0, False, 0)),
]


@pytest.mark.parametrize("name,args", MESSAGES,
                         ids=[f"{n}{i}" for i, (n, _a) in
                              enumerate(MESSAGES)])
def test_protocol_bytes_match_and_cross_decode(name, args):
    ours = getattr(protocol, name)(*args)
    theirs = getattr(r_protocol, name)(*args)
    frame = protocol.encode(ours)
    assert frame == r_protocol.encode(theirs)
    assert protocol.decode(frame) == ours
    back = protocol.decode(r_protocol.encode(theirs))
    assert dataclasses.astuple(back) == dataclasses.astuple(theirs)
    there = r_protocol.decode(frame)
    assert dataclasses.astuple(there) == dataclasses.astuple(ours)


def test_protocol_refusals_match():
    frame = bytearray(protocol.encode(protocol.Bye()))
    frame[0] ^= 0xFF
    for mod in (protocol, r_protocol):
        with pytest.raises(mod.ProtocolError):
            mod.decode(bytes(frame))


# ---- decide_tick ---------------------------------------------------------


def _trial_sets(seed):
    rng = random.Random(seed)
    points = [{"p2p_budget_cap_ms": cap, "p2p_budget_fraction": fraction}
              for cap in (500.0, 2000.0, 6000.0) for fraction in (0.5, 0.9)]
    for _ in range(40):
        trials = [{"knobs": knobs,
                   "offload": rng.choice([rng.random(), 0.0]),
                   "rebuffer": rng.choice([rng.random() * 0.1, 0.0]),
                   "failed": rng.random() < 0.1}
                  for knobs in points]
        current = rng.choice(points)
        bands = {"offload": {"rtol": rng.choice([0.0, 0.1]),
                             "atol": rng.choice([0.0, 0.02])},
                 "rebuffer": {"rtol": 0.0, "atol": rng.random() * 0.02}}
        alert = (None if rng.random() < 0.5 else
                 {"slo": "delivery-offload", "burn_fast": 3.0,
                  "burn_slow": 2.5, "worst_shard": {"shard": "mux01"},
                  "worst_cohort": {"cohort": "cellular"}})
        bound = rng.choice([0.02, 0.05])
        yield trials, current, bands, bound, alert


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_decide_tick_matches_the_reference(seed):
    actions = set()
    for trials, current, bands, bound, alert in _trial_sets(seed):
        ours = controller.decide_tick(
            trials, current, search.Constraint("rebuffer", bound,
                                               "offload"),
            bands, "chaos", burn_alert=alert)
        theirs = r_controller.decide_tick(
            trials, current, r_search.Constraint("rebuffer", bound,
                                                 "offload"),
            bands, "chaos", burn_alert=alert)
        assert ours == theirs
        actions.add((ours["action"], ours["reason"], ours["trigger"]))
    assert ("actuate", None, "forecast_band") in actions


def test_control_identity_and_checkpoint_path_match(tmp_path):
    doc = cf.load_json(cf.CONTROL_DECISIONS)
    for key in ("a", "b"):
        ours = cf.config_from_dict(doc["configs"][key])
        theirs = _reference_config(doc["configs"][key])
        assert _digest(ours.identity()) == r_controller._digest(
            theirs.identity())
        assert ours.lattice() == theirs.lattice()
        assert (controller.control_checkpoint_path(str(tmp_path), ours)
                == r_controller.control_checkpoint_path(str(tmp_path),
                                                        theirs))


def _reference_config(d):
    spec = dict(d["spec"])
    spec["level_bitrates"] = tuple(spec["level_bitrates"])
    return r_controller.ControlConfig(
        spec=r_twin.TwinScenario(**spec), knob_grid=d["knob_grid"],
        initial_knobs=d["initial_knobs"],
        constraint=r_search.Constraint(*d["constraint"]),
        bands=d["bands"], band_set=d["band_set"], swarm_id=d["swarm_id"],
        warmup_windows=d["warmup_windows"],
        hysteresis_ticks=d["hysteresis_ticks"],
        forecast_chunk=d["forecast_chunk"], slo_specs=d["slo_specs"],
        cohorts=d["cohorts"], slo_warmup_windows=d["slo_warmup_windows"])


# ---- the loop on a recorded shard ---------------------------------------

#: tests/test_controller.py's ha_scenario(chaos=True) and ha_config:
#: scarce supply, a loss window through the wave, uncalibrated bands so
#: that the forecasts actuate several epochs
SCENARIO = dict(seed=0, n_peers=8, wave_peers=4, watch_s=96.0,
                uplink_bps=900_000.0, cdn_bps=1_200_000.0,
                fault_specs="loss@24-56", fault_kwargs={"loss_rate": 0.4})
CONFIG = dict(knob_grid={"p2p_budget_cap_ms": [500.0, 6000.0]},
              initial_knobs={"p2p_budget_cap_ms": 6000.0},
              bands={}, warmup_windows=1)


def _config(mod, scenario_cls, constraint_cls):
    return mod.ControlConfig(
        spec=scenario_cls(**SCENARIO),
        constraint=constraint_cls.parse("rebuffer<=0.25"), **CONFIG)


class StubLease:
    """The lease surface ``HAActuator`` reads (tests/test_controller.py)."""

    def __init__(self, is_leader=False, generation=0, knob_epoch=0):
        self.is_leader = is_leader
        self.generation = generation
        self.knob_epoch = knob_epoch


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    """The chaos real plane recorded once; the reference's loop over it
    (no warm start) and the port's (a row cache on a fresh root)."""
    root = tmp_path_factory.mktemp("control")
    observed = r_twin.run_real_plane(
        r_twin.TwinScenario(**SCENARIO), trace_dir=str(root / "trace"),
        extract_events=False)
    shard = observed.shard_path
    ref = cf.recording(r_controller.ControlLoop)(
        _config(r_controller, r_twin.TwinScenario, r_search.Constraint),
        shard, r_controller.LogActuator(str(root / "ref.jsonl")))
    ref.run_available()
    config = _config(controller, twin.TwinScenario, search.Constraint)
    warm_root = str(root / "rows")
    port = cf.recording(controller.ControlLoop)(
        config, shard, controller.LogActuator(str(root / "port.jsonl")),
        warm_start=WarmStart(warm_root), device="cpu",
        checkpoint_path=controller.control_checkpoint_path(
            str(root / "cache"), config))
    port.run_available()
    return dict(root=root, shard=shard, ref=ref, port=port,
                config=config, warm_root=warm_root)


def _sig(loop):
    return cf.decision_sig(loop.decisions)


def test_loop_decisions_match_the_reference(plane):
    ref, port = plane["ref"], plane["port"]
    assert len(ref.decisions) == 12
    acted = [d["epoch"] for d in ref.decisions if d["action"] == "actuate"]
    assert len(acted) >= 2
    assert _sig(port) == _sig(ref)
    assert [d["action"] for d in port.decisions] == [
        d["action"] for d in ref.decisions]
    err = cf.forecast_error(cf.forecast_rows(port.forecasts),
                            cf.forecast_rows(ref.forecasts))
    assert err <= cf.FORECAST_TOL
    assert port.actuator.epochs() == ref.actuator.epochs() == acted


def test_loop_decisions_are_not_lucky(plane):
    """Every forecast tick's decision sits farther than twice the
    forecast tolerance from flipping: a forecast error within it cannot
    change a ranking, a feasibility or a band verdict."""
    ref = plane["ref"]
    current = dict(ref.config.initial_knobs)
    margins = []
    for f in ref.forecasts:
        if f["tick"] > 0:
            current = dict(ref.decisions[f["tick"] - 1]["knobs"])
        margins.append(cf.decision_margins(
            f["trials"], current, ref.config.constraint, ref.config.bands))
    assert len(margins) == len(ref.forecasts) == 11
    assert min(min(m.values()) for m in margins) > 2 * cf.FORECAST_TOL


def test_warm_rerun_dispatches_nothing(plane):
    again = controller.ControlLoop(
        plane["config"], plane["shard"],
        controller.LogActuator(str(plane["root"] / "port.jsonl")),
        warm_start=WarmStart(plane["warm_root"]), device="cpu")
    again.run_available()
    assert _sig(again) == _sig(plane["ref"])
    rows = {labels["source"]: value for labels, value
            in again.registry.series("control.forecast_rows")}
    assert rows == {"cache": 2 * 11}
    # the log is idempotent by epoch: each epoch once
    assert again.actuator.epochs() == plane["ref"].actuator.epochs()


def test_resume_rederives_the_same_decisions(plane, tmp_path):
    config = plane["config"]
    ckpt = controller.control_checkpoint_path(str(tmp_path / "cache"),
                                              config)
    log = str(tmp_path / "resume.jsonl")
    stopped = controller.ControlLoop(
        config, plane["shard"], controller.LogActuator(log),
        warm_start=WarmStart(plane["warm_root"]), device="cpu",
        checkpoint_path=ckpt, tick_gate=lambda _w: stopped.epoch == 0)
    stopped.run_available()
    assert stopped.epoch == 1 and stopped.pending_windows > 0
    resumed = controller.ControlLoop(
        config, plane["shard"], controller.LogActuator(log),
        warm_start=WarmStart(plane["warm_root"]), device="cpu",
        checkpoint_path=ckpt)
    assert resumed.resume()
    assert resumed.decisions == stopped.decisions
    resumed.run_available()
    assert _sig(resumed) == _sig(plane["ref"])
    assert resumed.actuator.epochs() == plane["ref"].actuator.epochs()
    # the uninterrupted port loop's checkpoint holds the same decisions
    assert plane["port"].decisions == resumed.decisions


def test_standby_takeover_replays_the_same_decisions(plane, tmp_path):
    """``test_standby_takeover_replays_bit_identical_prefix`` on the
    port: a standby gated at the dead leader's watermark shadow-applies
    its prefix, takes over, and ends with the sole loop's decisions,
    publishing only the epochs beyond the watermark."""
    ref = plane["ref"]
    acted = [d["epoch"] for d in ref.decisions if d["action"] == "actuate"]
    inner = controller.LogActuator(str(tmp_path / "standby.jsonl"))
    lease = StubLease(is_leader=False, generation=0, knob_epoch=acted[0])
    loop = controller.ControlLoop(
        plane["config"], plane["shard"],
        controller.HAActuator(inner, lease),
        warm_start=WarmStart(plane["warm_root"]), device="cpu",
        tick_gate=lambda _w: lease.is_leader
        or loop.epoch < lease.knob_epoch)
    loop.run_available()
    assert loop.epoch == lease.knob_epoch
    assert inner.epochs() == []
    assert 0 < len(loop.decisions) < len(ref.decisions)
    assert loop.pending_windows > 0
    lease.is_leader, lease.generation = True, 2
    loop.run_available()
    assert loop.pending_windows == 0
    assert _sig(loop) == _sig(ref)
    assert inner.epochs() == acted[1:]


def test_lattice_order_matches_the_reference():
    grid = {"p2p_budget_fraction": [0.5, 0.9],
            "p2p_budget_cap_ms": [500.0, 6000.0], "urgent_margin_s": [2.0]}
    config = controller.ControlConfig(
        spec=twin.TwinScenario(), knob_grid=grid,
        initial_knobs={"p2p_budget_cap_ms": 500.0,
                       "p2p_budget_fraction": 0.5, "urgent_margin_s": 2.0},
        constraint=search.Constraint.parse("rebuffer<=0.05"), bands={})
    expected = [dict(zip(sorted(grid), v)) for v in itertools.product(
        *(grid[k] for k in sorted(grid)))]
    assert config.lattice() == expected
