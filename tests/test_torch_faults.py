"""The fault plane of the PyTorch port, on the CPU: ``engine/faults.py``
and the recovery in ``ops/dispatch.py``, mirroring tests/test_faults.py
on the port's dispatch, and held to the reference's dispatch
(``ops/swarm_sim.py run_batch_chunked``) on the same plan and items:
the same rows within the parity tolerance, the same ``fault_counts()``,
the same backoff sleeps and the same failure lists.  The port's rows
under recovery equal its unfaulted rows to the bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hlsjs_p2p_wrapper_tpu.engine import faults as ref_faults
from hlsjs_p2p_wrapper_tpu.ops import swarm_sim as ref
from hlsjs_p2p_wrapper_tpu_torch.engine import faults as port_faults
from hlsjs_p2p_wrapper_tpu_torch.engine.faults import (
    FaultPlan, FaultPolicy, InjectedFault, classify_error)
from hlsjs_p2p_wrapper_tpu_torch.engine.telemetry import MetricsRegistry
from hlsjs_p2p_wrapper_tpu_torch.ops import dispatch as dp
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as port

PEERS = 16
BITRATES = (300_000.0, 800_000.0)
N_STEPS = 40
WATCH_S = 10.0
ITEMS = [0.5, 2.0, 4.0, 8.0, 16.0]
#: final offload and rebuffer, port vs reference
#: (tests/test_torch_swarm_sim.py RUN_TOL)
RUN_TOL = 1e-4


def _config():
    return port.SwarmConfig(n_peers=PEERS, n_segments=8, n_levels=2,
                            neighbor_offsets=port.ring_offsets(4))


def _build(margin):
    config = _config()
    return (port.make_scenario(config, BITRATES, None,
                               np.full(PEERS, 8e6, np.float32),
                               urgent_margin_s=margin, device="cpu"),
            torch.zeros(PEERS))


def _ref_build(margin):
    config = ref.SwarmConfig(*_config())
    return (ref.make_scenario(config, jnp.array(BITRATES), None,
                              jnp.full((PEERS,), 8_000_000.0),
                              urgent_margin_s=margin),
            jnp.zeros((PEERS,)))


def _policy(module, spec=None, **kwargs):
    sleeps = []
    plan = module.FaultPlan.parse(spec) if spec else None
    return module.FaultPolicy(plan=plan, sleep=sleeps.append,
                              **kwargs), sleeps


def _port_run(chunk, faults=None):
    results, stats = dp.run_groups_chunked(
        [(_config(), ITEMS, _build)], N_STEPS, watch_s=WATCH_S,
        chunk=chunk, faults=faults)
    return results[0], stats[0]


@pytest.fixture(autouse=True)
def _fresh_feedback():
    port.reset_oom_feedback()
    yield
    port.reset_oom_feedback()


# ---- the plan and the classifier ---------------------------------------------

def test_fault_plan_parse_and_pop():
    plan = FaultPlan.parse("oom@0:1,transient@1:2x3, timeout@0:4")
    assert plan.remaining() == 5
    assert plan.pop(0, 0) is None
    assert plan.pop(0, 1) == "oom"
    assert plan.pop(0, 1) is None
    assert [plan.pop(1, 2) for _ in range(4)] == ["transient"] * 3 + [None]
    assert plan.pop(0, 4) == "timeout"
    assert plan.remaining() == 0


@pytest.mark.parametrize("spec", ["explode@0:1", "oom@nowhere"])
def test_fault_plan_rejects_bad_specs(spec):
    with pytest.raises(ValueError):
        FaultPlan.parse(spec)
    with pytest.raises(ValueError):
        ref_faults.FaultPlan.parse(spec)
    with pytest.raises(ValueError):
        FaultPlan([{"kind": "nope", "group": 0, "chunk": 0}])


@pytest.mark.parametrize("exc,reason", [
    (InjectedFault("oom", "whatever"), "oom"),
    (RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to "
                  "allocate 123 bytes"), "oom"),
    (torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
        "capacity of 79.19 GiB of which 1.25 GiB is free."), "oom"),
    (RuntimeError("DEADLINE_EXCEEDED: dispatch timed out"), "timeout"),
    (RuntimeError("UNAVAILABLE: connection reset"), "transient"),
    (RuntimeError("INTERNAL: generated function failed"), "transient"),
    # the port's own kernel launch failure stays unclassified: re-raise
    (RuntimeError("peer_update launch failed: CUDA error 2"), None),
    (ValueError("RESOURCE_EXHAUSTED lookalike"), None),
    (RuntimeError("something else"), None)])
def test_classify_error_mapping(exc, reason):
    assert classify_error(exc) == reason
    if isinstance(exc, InjectedFault):
        exc = ref_faults.InjectedFault(exc.kind, str(exc))
    assert ref_faults.classify_error(exc) == reason
    assert ref_faults._FAULT_MESSAGES == port_faults._FAULT_MESSAGES


def test_backoff_is_deterministic_and_bounded():
    a, b = FaultPolicy(seed=7), ref_faults.FaultPolicy(seed=7)
    seq = [a.backoff_s(i) for i in range(6)]
    assert seq == [b.backoff_s(i) for i in range(6)]
    assert FaultPolicy(seed=1).backoff_s(0) != FaultPolicy(seed=2).backoff_s(0)
    for attempt, delay in enumerate(seq):
        assert delay <= a.backoff_cap_s * (1.0 + a.jitter)
        assert delay >= min(a.backoff_cap_s,
                            a.backoff_base_s * 2.0 ** attempt)


# ---- recovery, against the reference's -------------------------------------------

#: (plan, chunk): a transient retried twice and a timeout; an OOM that
#: bisects its chunk and then its first half; an exhausted budget; a
#: single lane's OOM that outlives every budget; one that clears on the
#: third attempt
PLANS = [("transient@0:1x2,timeout@0:2", 2), ("oom@0:0x2", 4),
         ("transient@0:0x9", 2), ("oom@0:0x99", 2), ("oom@0:0x3", 2)]


@pytest.mark.parametrize("spec,chunk", PLANS)
def test_recovery_matches_the_reference(spec, chunk):
    """The same plan on the same items through the port's dispatch and
    the reference's: the same counts, sleeps and failure lists, rows
    within RUN_TOL, and the port's rows its unfaulted rows to the bit."""
    clean, _ = _port_run(chunk)
    policy, sleeps = _policy(port_faults, spec)
    rows, stats = _port_run(chunk, policy)
    rpolicy, rsleeps = _policy(ref_faults, spec)
    rresults, rstats = ref.run_groups_chunked(
        [(ref.SwarmConfig(*_config()), ITEMS, _ref_build)], N_STEPS,
        watch_s=WATCH_S, chunk=chunk, faults=rpolicy)
    assert policy.fault_counts() == rpolicy.fault_counts()
    assert sleeps == rsleeps
    assert stats["failures"] == rstats[0]["failures"]
    for got, want, base in zip(rows, rresults[0], clean):
        assert (got is None) == (want is None)
        if got is not None:
            assert got == base
            np.testing.assert_allclose(got, want, atol=RUN_TOL)


def test_transient_retry_recovers_bit_exact():
    clean, _ = _port_run(2)
    policy, sleeps = _policy(port_faults, "transient@0:1x2,timeout@0:2")
    rows, _stats = _port_run(2, policy)
    assert rows == clean
    assert policy.fault_counts() == {"transient|retry": 2,
                                     "timeout|retry": 1}
    probe = FaultPolicy(seed=0)
    assert sleeps[:2] == [probe.backoff_s(0), probe.backoff_s(1)]


def test_oom_bisection_bit_exact_and_feeds_the_autotuner():
    """Chunk 0 (4 lanes) bisects, then its first half: rows equal the
    unfaulted run's, and each bisection halves the memory fraction the
    autotuner commits until the feedback is reset."""
    clean, _ = _port_run(4)
    policy, _sleeps = _policy(port_faults, "oom@0:0x2")
    rows, _stats = _port_run(4, policy)
    assert rows == clean
    assert policy.fault_counts() == {"oom|bisect": 2}
    assert port.oom_bisections() == 2
    assert port.autotune_memory_fraction() == (
        port.AUTOTUNE_MEMORY_FRACTION / 4)


@pytest.mark.parametrize("n,fraction", [(0, 0.5), (1, 0.25), (3, 0.0625),
                                        (4, 0.03125), (9, 0.03125)])
def test_autotune_memory_fraction_halves_per_bisection(n, fraction):
    for _ in range(n):
        port.note_oom_bisection()
    assert port.oom_bisections() == n
    assert port.autotune_memory_fraction() == fraction
    port.reset_oom_feedback()
    assert port.autotune_memory_fraction() == port.AUTOTUNE_MEMORY_FRACTION


def test_exhausted_budget_is_a_structured_partial_failure():
    policy, sleeps = _policy(port_faults, "transient@0:0x9", max_retries=3)
    rows, stats = _port_run(2, policy)
    assert rows[0] is None and rows[1] is None
    assert all(isinstance(m, tuple) for m in rows[2:])
    (failure,) = stats["failures"]
    assert failure["items"] == [0, 1] and failure["reason"] == "transient"
    assert "injected fault" in failure["error"]
    assert policy.fault_counts() == {"transient|retry": 3,
                                     "transient|giveup": 1}
    assert len(sleeps) == 3
    events = list(dp.stream_groups_chunked(
        [(_config(), ITEMS, _build)], N_STEPS, watch_s=WATCH_S, chunk=2,
        faults=_policy(port_faults, "transient@0:0x9")[0]))
    failed = [ev for ev in events if ev.metric is None]
    assert [(ev.index, ev.reason) for ev in failed] == [(0, "transient"),
                                                        (1, "transient")]
    assert all("injected fault" in ev.error for ev in failed)


def test_single_lane_oom_retries_then_gives_up_structured():
    policy, sleeps = _policy(port_faults, "oom@0:0x99", max_retries=3)
    rows, stats = _port_run(2, policy)
    assert rows[0] is None and rows[1] is None
    assert [f["items"] for f in stats["failures"]] == [[0], [1]]
    counts = policy.fault_counts()
    assert counts == {"oom|bisect": 1, "oom|retry": 6, "oom|giveup": 2}
    assert len(sleeps) == 6


def test_single_lane_oom_recovers_on_a_transient_burst():
    clean, _ = _port_run(2)
    policy, _sleeps = _policy(port_faults, "oom@0:0x3")
    rows, stats = _port_run(2, policy)
    assert rows == clean and not stats["failures"]
    assert policy.fault_counts() == {"oom|bisect": 1, "oom|retry": 2}


def test_a_real_out_of_memory_error_bisects(monkeypatch):
    """A ``torch.OutOfMemoryError`` raised by the dispatch itself (here
    by the batch runner, for chunks wider than two lanes) bisects like an
    injected one, and the halves return the unfaulted rows."""
    clean, _ = _port_run(4)
    run = dp.run_swarm_batch

    def tight(config, scenarios, states, *args, **kw):
        if states.t_s.shape[0] > 2:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 20.00 MiB.")
        return run(config, scenarios, states, *args, **kw)
    monkeypatch.setattr(dp, "run_swarm_batch", tight)
    policy, _sleeps = _policy(port_faults)
    rows, stats = _port_run(4, policy)
    assert rows == clean and not stats["failures"]
    assert policy.fault_counts() == {"oom|bisect": 1}


def test_a_fault_at_readback_redispatches_the_segment(monkeypatch):
    """A classified fault that surfaces only when a chunk's results are
    read back (as an asynchronous card error would) is counted as a
    retry and the segment re-dispatched, blocking: the rows are the
    unfaulted run's."""
    clean, _ = _port_run(2)
    ratios = dp.offload_ratio_batch
    failed = []

    class _Late:
        def __init__(self, t):
            self.t = t

        def cpu(self):
            if not failed:
                failed.append(True)
                raise RuntimeError("UNAVAILABLE: the card went away")
            return self.t.cpu()
    monkeypatch.setattr(dp, "offload_ratio_batch",
                        lambda states: _Late(ratios(states)))
    policy, sleeps = _policy(port_faults)
    rows, stats = _port_run(2, policy)
    assert rows == clean and not stats["failures"] and failed
    assert policy.fault_counts() == {"transient|retry": 1}
    assert sleeps == []


def test_unclassified_errors_propagate():
    class _Boom(FaultPolicy):
        fired = False

        def before_dispatch(self, *, group, chunk):
            if not _Boom.fired:
                _Boom.fired = True
                raise ValueError("a shape bug, not weather")

    with pytest.raises(ValueError, match="shape bug"):
        dp.run_batch_chunked(_config(), ITEMS, _build, N_STEPS,
                             watch_s=WATCH_S, chunk=2, faults=_Boom())
    with pytest.raises(RuntimeError, match="launch failed"):
        class _Launch(FaultPolicy):
            def before_dispatch(self, *, group, chunk):
                raise RuntimeError("select_admit launch failed: CUDA error 2")
        dp.run_batch_chunked(_config(), ITEMS, _build, N_STEPS,
                             watch_s=WATCH_S, chunk=2, faults=_Launch())


def test_faults_land_in_injected_registry():
    registry = MetricsRegistry()
    policy = FaultPolicy(FaultPlan.parse("transient@0:0"),
                         registry=registry, sleep=lambda _s: None)
    dp.run_batch_chunked(_config(), ITEMS, _build, N_STEPS, watch_s=WATCH_S,
                         chunk=2, faults=policy)
    assert registry.series("dispatch_faults") == [
        ({"action": "retry", "reason": "transient"}, 1)]
    assert registry.counter("dispatch_faults", reason="transient",
                            action="retry").value == 1


def test_the_smoke_plans_are_the_references_counts():
    """``chip_smoke.py``'s injected plans on the ring grid (20 cells in
    chunks of FAULT_CHUNK) count what the reference counts for them: the
    counts depend on the chunking alone, so 20 small items stand in for
    the cells."""
    cells = list(range(20))

    def build(_cell):
        return _ref_build(4.0)
    for spec, want in chip_smoke.FAULT_PLANS.items():
        rpolicy, _sleeps = _policy(ref_faults, spec)
        ref.run_groups_chunked(
            [(ref.SwarmConfig(*_config()), cells, build)], N_STEPS,
            watch_s=WATCH_S, chunk=chip_smoke.FAULT_CHUNK, faults=rpolicy)
        assert rpolicy.fault_counts() == want, spec
