"""The "adaptive" and "ranked" holder policies in the PyTorch port, on the
CPU: one step and a whole run of the prefetch fixture's four cells
(``tools/policy_ab.py``'s ring) against the JAX reference for each policy
at three slots and at one, VOD, and at three slots live; ranked across
the ring's wrap at 16 peers; adaptive without a penalty window equal to
spread; lanes batched, alone and through the chunked dispatch with the
penalty field stacked; ``policy_grid`` and the slice's limits; the
penalty field through ``testing.convert``; and the committed policies
fixture binding every re-arm and every skip of ranked.  On the card
(marker ``gpu``): the policies' kernels against their plain versions.

The cells are ``tools/torch_port_fixture.py``'s ``PREFETCH_CELLS`` at
256 peers × 64 segments with a 25 s watch window, so the crowd joins at
6.25 s and the departure wave (lane 1) leaves at 12.5 s.  A case's
one-step state is its run's midpoint: 50 steps in for VOD (the
departure), 70 for live, where the penalty windows open later."""

import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hlsjs_p2p_wrapper_tpu.ops import swarm_sim as ref
from hlsjs_p2p_wrapper_tpu_torch import policy_grid as pg
from hlsjs_p2p_wrapper_tpu_torch.ops import dispatch as dp
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_kernels as sk
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as port
from hlsjs_p2p_wrapper_tpu_torch.testing import (REFERENCE_POLICIES,
                                                 REFERENCE_PREFETCH,
                                                 prefetch_lanes)
from hlsjs_p2p_wrapper_tpu_torch.testing.convert import (
    scenario_from_numpy, state_from_numpy, state_to_numpy)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import policy_ab as ref_ab  # noqa: E402
import torch_port_fixture  # noqa: E402

CELLS = torch_port_fixture.PREFETCH_CELLS
LEAVE_LANE = torch_port_fixture.PREFETCH_LEAVE_LANE
LEAVE_FRACTION = torch_port_fixture.PREFETCH_LEAVE_FRACTION
P, S = 256, 64
WATCH_S = 25.0
#: (policy, slots, live): each policy at three slots and one, VOD, and at
#: three slots live
CASES = [(policy, slots, live) for policy in ("adaptive", "ranked")
         for slots, live in ((3, False), (1, False), (3, True))]
#: final offload and rebuffer and the offload series, port vs reference
#: (tests/test_torch_swarm_sim.py RUN_TOL)
RUN_TOL = 1e-4
#: EWMA fields (``pow`` may round the last ulp apart between XLA and
#: PyTorch) and the other float fields (XLA's CPU backend may contract a
#: multiply and an add), as tests/test_torch_prefetch.py states them
EWMA_RTOL = FLOAT_RTOL = 1e-6
#: integer, index and packed fields, and the penalty window, whose
#: drain and re-arm round as the reference's: bit-identical
EXACT_FIELDS = ("level", "avail", "dl_flags", "dl_seg", "dl_level",
                "dl_holder_off", "dl_attempts", "t_s", "holder_penalty_ms")


def _tree_np(tree):
    out = {}
    for k, v in tree._asdict().items():
        out[k] = ({f: np.array(x) for f, x in v._asdict().items()}
                  if hasattr(v, "_asdict") else np.array(v))
    return out


def _assert_state_close(got, want):
    for k, v in want.items():
        if k == "ewma":
            for f in v:
                np.testing.assert_allclose(got[k][f], v[f], rtol=EWMA_RTOL,
                                           err_msg=f"ewma.{f}")
            continue
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if k in EXACT_FIELDS:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=FLOAT_RTOL, err_msg=k)


def _ref_config(policy, slots=3, live=False, peers=P):
    return ref.SwarmConfig(n_peers=peers, n_segments=S, n_levels=1,
                           max_concurrency=slots, holder_selection=policy,
                           neighbor_offsets=ref.ring_offsets(8), live=live)


@functools.lru_cache(maxsize=None)
def _reference(policy, slots, live, peers=P):
    """The reference's four fixture lanes under ``policy``: its stacked
    scenarios, joins and leaves, its batched state at the run's midpoint
    and one step later, and the whole run (final states, offload series,
    ratios), as numpy.  The run is one-step calls of ``run_swarm_batch``,
    so that one compiled program serves every state."""
    rconfig = _ref_config(policy, slots, live, peers)
    step_at = 70 if live else 50
    aud = ref_ab.build_audience(peers, 0)
    built = []
    for b, (pattern, wave, up) in enumerate(CELLS):
        scen, join = ref_ab.build_cell_scenario(
            rconfig, None, aud, uplink_bps=up * 1e6, pattern=pattern,
            wave=wave, watch_s=WATCH_S)
        if b == LEAVE_LANE:
            scen = scen._replace(leave_s=jnp.where(
                aud["wave_ranks"] < LEAVE_FRACTION, WATCH_S / 2.0,
                ref.NEVER_S))
        built.append((scen, join))
    scens = ref.stack_pytrees([sc for sc, _ in built])
    joins = jnp.stack([j for _, j in built])
    leaves = scens.leave_s
    state = ref.stack_pytrees([ref.init_swarm(rconfig)] * len(CELLS))
    series = []
    for s in range(2 * step_at):
        if s == step_at:
            mid = _tree_np(state)
        state, column = ref.run_swarm_batch(rconfig, scens, state, 1)
        series.append(np.array(column))
        if s == step_at:
            stepped = _tree_np(state)
    watch_s = 2 * step_at * rconfig.dt_ms / 1000.0
    return {"config": port.SwarmConfig(*rconfig), "steps": 2 * step_at,
            "scenario": _tree_np(scens), "join": np.asarray(joins),
            "leave": np.asarray(leaves), "mid": mid,
            "stepped": stepped, "final": _tree_np(state),
            "series": np.concatenate(series, axis=1),
            "offload": np.asarray(ref.offload_ratio_batch(state)),
            "rebuffer": np.asarray(ref.rebuffer_ratio_batch(
                state, watch_s, joins, leaves)),
            "watch_s": watch_s}


def _case_id(case):
    policy, slots, live = case
    return f"{policy}-C{slots}{'-live' if live else ''}"


# ---- against the reference -------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_one_step_matches_reference(case):
    """One step of the four lanes from the reference's midpoint state,
    where transfers are in flight (prefetches too, with three slots) and
    adaptive's penalty windows are open: integer, index and packed
    fields and the penalty window bit-identical, floats within their
    tolerances."""
    r = _reference(*case)
    mid = r["mid"]
    assert (mid["dl_flags"] & 1).any()
    if case[1] > 1:
        assert ((mid["dl_flags"] >> 2) & 1).any()   # a prefetch in flight
    if case[0] == "adaptive":
        assert (mid["holder_penalty_ms"] > 0).any()
        assert (r["stepped"]["holder_penalty_ms"]
                != np.maximum(mid["holder_penalty_ms"] - 250.0, 0.0)).any()
    else:
        assert mid["holder_penalty_ms"].shape[-1] == 0
    scen = scenario_from_numpy(r["scenario"], "cpu")
    got = state_to_numpy(port.swarm_step(r["config"], scen,
                                         state_from_numpy(mid, "cpu")))
    _assert_state_close(got, r["stepped"])


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_whole_run_matches_reference(case):
    """The whole run of the four lanes (``run_swarm_batch``): the final
    state as one step's, the offload series and each lane's final ratios
    within RUN_TOL."""
    r = _reference(*case)
    cp = r["config"]
    scen = scenario_from_numpy(r["scenario"], "cpu")
    final, series = port.run_swarm_batch(
        cp, scen, port.init_swarm(cp, device="cpu", batch=len(CELLS)),
        r["steps"])
    _assert_state_close(state_to_numpy(final), r["final"])
    np.testing.assert_allclose(series.numpy(), r["series"], atol=RUN_TOL)
    np.testing.assert_allclose(port.offload_ratio_batch(final).numpy(),
                               r["offload"], atol=RUN_TOL)
    np.testing.assert_allclose(
        port.rebuffer_ratio_batch(final, r["watch_s"], r["join"],
                                  r["leave"]).numpy(),
        r["rebuffer"], atol=RUN_TOL)


def test_ranked_picks_by_id_across_the_wrap():
    """Ranked at 16 peers on the ring of 8, three slots: the whole run
    against the reference (integer and packed fields bit-identical), and
    at every step the requesters at both ends of the ring, and only
    there, pick another holder than an order by signed offset would:
    near the wrap the lowest id is not the lowest offset."""
    r = _reference("ranked", 3, False, peers=16)
    cp = r["config"]
    scen = scenario_from_numpy(r["scenario"], "cpu")
    state = port.init_swarm(cp, device="cpu", batch=len(CELLS))
    wrapped = torch.zeros(16, dtype=torch.bool)
    for _ in range(r["steps"]):
        elig = chip_smoke.eligible_bits(port, sk, cp, scen, state)
        _flags, req = sk.elig_select_plain(cp, scen,
                                           port.clone_state(state))
        for c, bits in enumerate(elig):
            alt = chip_smoke.signed_offset_picks(cp, bits,
                                                 2 if c == 0 else c - 1)
            placed = req[..., c] >= 0
            wrapped |= (placed & (alt != req[..., c])).any(0)
        sk.plain_step(cp, scen, state)
    ends = torch.tensor([i < 4 or i >= 12 for i in range(16)])
    assert not bool((wrapped & ~ends).any())
    assert bool(wrapped[:4].any()) and bool(wrapped[12:].any())
    _assert_state_close(state_to_numpy(state), r["final"])


# ---- inside the port -------------------------------------------------------------

def test_adaptive_without_a_penalty_window_is_spread():
    """At one slot with the scenario's ``holder_penalty_ms = 0`` no
    window opens and no other slot loads an offset, so adaptive's tier
    is every eligible holder: its run equals spread's to the bit, and
    its penalty field stays zero."""
    fixture = np.load(REFERENCE_PREFETCH)
    runs = {}
    for policy in ("adaptive", "spread"):
        cp, scen, _j, _l = prefetch_lanes(fixture, "cpu", peers=P,
                                          segments=S, watch_s=WATCH_S,
                                          slots=1, policy=policy)
        scen = scen._replace(holder_penalty_ms=torch.zeros_like(
            scen.holder_penalty_ms))
        runs[policy] = port.run_swarm_batch(
            cp, scen, port.init_swarm(cp, device="cpu", batch=len(CELLS)),
            100)
    (a, sa), (b, sb) = runs["adaptive"], runs["spread"]
    assert a.holder_penalty_ms.shape[-1] == 8
    assert not bool(a.holder_penalty_ms.any())
    assert torch.equal(sa, sb)
    for name in port.SwarmState._fields:
        if name != "holder_penalty_ms":
            for x, y in zip(port.tree_leaves(getattr(a, name)),
                            port.tree_leaves(getattr(b, name))):
                assert torch.equal(x, y), name


@pytest.mark.parametrize("policy", ["adaptive", "ranked"])
def test_lanes_batched_alone_and_chunked_agree(policy):
    """The fixture's cells as four lanes at 64 peers: lane 2 run alone
    equals its lane of the batch to the bit, the penalty field ``[B, P,
    K]`` under adaptive included; the chunked dispatch in chunks of 3
    gives the direct batch's rows to the bit."""
    fixture = np.load(REFERENCE_PREFETCH)
    cp, scen, joins, _leaves = prefetch_lanes(
        fixture, "cpu", peers=64, segments=S, watch_s=10.0, policy=policy)
    n, B = 40, len(CELLS)
    final, series = port.run_swarm_batch(
        cp, scen, port.init_swarm(cp, device="cpu", batch=B), n)
    assert tuple(final.holder_penalty_ms.shape) == (
        B, 64, 8 if policy == "adaptive" else 0)
    alone, alone_series = port.run_swarm_scenario(
        cp, port.lane(scen, 2), port.init_swarm(cp, device="cpu"), n)
    assert torch.equal(alone_series, series[2])
    for x, y in zip(port.tree_leaves(alone),
                    port.tree_leaves(port.lane(final, 2))):
        assert torch.equal(x, y)

    def build(b):
        one = port.lane(scen, b)
        return one, one.join_s
    results, stats = dp.run_groups_chunked([(cp, list(range(B)), build)], n,
                                           watch_s=10.0, chunk=3)
    assert stats[0]["chunks"] == 2
    offs = port.offload_ratio_batch(final)
    rebs = port.rebuffer_ratio_batch(final, 10.0, joins)
    assert results[0] == list(zip(offs.tolist(), rebs.tolist()))


def test_policy_grid_and_the_slice_take_every_policy():
    """``ring_config`` gives the tool's ring config for each policy; the
    slice takes adaptive and ranked at 1 to 16 slots, VOD and live, and
    on the general path and with the uncapped fair share, which are
    ported; ``random_config`` gives the tool's random-mesh config."""
    for policy in pg.POLICIES:
        cfg = pg.ring_config(P, S, policy)
        assert tuple(cfg) == tuple(_ref_config(policy))
        for slots in (1, 3, 16):
            for live in (False, True):
                port.check_slice(cfg._replace(max_concurrency=slots,
                                              live=live))
        for change in ({"neighbor_offsets": None},
                       {"max_total_serves": 0}):
            port.check_slice(cfg._replace(**change))
        assert tuple(pg.random_config(P, S, policy)) == tuple(
            _ref_config(policy)._replace(neighbor_offsets=None))


def test_the_penalty_width_is_checked_and_carried():
    """A step checks the penalty field's width as the reference does (K
    under adaptive, else 0); ``init_swarm`` sizes it, batched too, and
    ``testing.convert`` carries the reference's ``[P, K]`` and ``[B, P,
    K]`` fields to the port and back at their width and bits."""
    cfg = pg.ring_config(16, S, "adaptive")
    assert tuple(port.init_swarm(cfg, device="cpu").holder_penalty_ms
                 .shape) == (16, 8)
    assert tuple(port.init_swarm(cfg, device="cpu", batch=3)
                 .holder_penalty_ms.shape) == (3, 16, 8)
    fixture = np.load(REFERENCE_PREFETCH)
    _cp, scen, _j, _l = prefetch_lanes(fixture, "cpu", peers=16, segments=S,
                                       watch_s=WATCH_S, policy="adaptive")
    for policy, width in (("adaptive", 0), ("spread", 8), ("ranked", 8)):
        state = port.init_swarm(pg.ring_config(16, S, "spread"),
                                device="cpu", batch=len(CELLS))
        state = state._replace(holder_penalty_ms=torch.ones(
            len(CELLS), 16, width))
        with pytest.raises(ValueError, match="holder_penalty_ms is sized"):
            port.swarm_step(pg.ring_config(16, S, policy), scen, state)
    rng = np.random.default_rng(0)
    rcfg = _ref_config("adaptive", peers=16)
    single = _tree_np(ref.init_swarm(rcfg))
    assert single["holder_penalty_ms"].shape == (16, 8)
    single["holder_penalty_ms"] = rng.uniform(
        0, 3000, (16, 8)).astype(np.float32)
    batched = _tree_np(ref.stack_pytrees([ref.init_swarm(rcfg)] * 3))
    batched["holder_penalty_ms"] = rng.uniform(
        0, 3000, (3, 16, 8)).astype(np.float32)
    for fields in (single, batched):
        state = state_from_numpy(fields, "cpu")
        assert state.holder_penalty_ms.dtype == torch.float32
        back = state_to_numpy(state)["holder_penalty_ms"]
        assert back.shape == fields["holder_penalty_ms"].shape
        np.testing.assert_array_equal(back, fields["holder_penalty_ms"])


def test_the_fixture_binds_every_rearm_and_skip():
    """The committed policies fixture (the prefetch fixture's lanes,
    shape and departure wave under each policy): at its own shape, at
    four states of its first 101 steps (the departure wave leaves at
    step 100), adaptive's penalty window re-arms at a foreground deny
    and at each prefetch abort kind, and its tier, own load and penalty
    keys each move a pick; ranked's skip binds at each of its values
    (``chip_smoke.py``'s count, which the card's check uses too)."""
    fixture = np.load(REFERENCE_POLICIES)
    prefetch = np.load(REFERENCE_PREFETCH)
    assert tuple(fixture["policies"]) == torch_port_fixture.POLICIES
    for name in ("cells", "shape", "join_s", "leave_s", "leave_lane",
                 "seed"):
        np.testing.assert_array_equal(fixture[name], prefetch[name])
    for policy in torch_port_fixture.POLICIES:
        cp, scen, _joins, _leaves = prefetch_lanes(fixture, "cpu",
                                                   policy=policy)
        state = port.init_swarm(cp, device="cpu", batch=len(CELLS))
        total = {}
        for s in range(101):
            if s in (55, 75, 95, 100):
                for name, n in chip_smoke.policy_branch_counts(
                        port, sk, cp, scen, state).items():
                    total[name] = total.get(name, 0) + n
            sk.plain_step(cp, scen, state)
        want = ({"tier", "own_used", "penalty", "rearm_deny", "rearm_lost",
                 "rearm_timeout", "rearm_busy"} if policy == "adaptive"
                else {"skip_0", "skip_1", "skip_2", "wrap"})
        assert set(total) == want
        binds = want - {"wrap"}
        assert all(total[name] > 0 for name in binds), (policy, total)


# ---- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("policy,slots,offsets", [
    ("adaptive", 3, None), ("adaptive", 1, None), ("ranked", 3, None),
    ("ranked", 1, None), ("adaptive", 3, (1, -1, 2, -2, 97, -97, 300, -300)),
    ("ranked", 16, None)])
def test_policy_kernels_match_plain_on_the_card(cuda_device, policy, slots,
                                                offsets):
    """The fixture's cells as lanes at 4,096 peers under ``policy``, 50
    plain steps in, stepped 40 times by the kernels (the fused route, or
    TK1 + TK2 for a wide offset tuple) beside the plain step: integer
    fields and the penalty window equal, floats within 1e-6."""
    fixture = np.load(REFERENCE_PREFETCH)
    config, scen, _j, _l = prefetch_lanes(fixture, cuda_device, peers=4096,
                                          segments=S, watch_s=WATCH_S,
                                          slots=slots, policy=policy)
    if offsets is not None:
        config = config._replace(neighbor_offsets=offsets)
    state = port.init_swarm(config, device=cuda_device, batch=len(CELLS))
    for _ in range(50):
        state = sk.plain_step(config, scen, state)
    a, b = port.clone_state(state), port.clone_state(state)
    for _ in range(40):
        a = port.swarm_step(config, scen, a)
        b = sk.plain_step(config, scen, b)
    torch.cuda.synchronize()
    assert torch.equal(a.holder_penalty_ms, b.holder_penalty_ms)
    for u, v in zip(port.tree_leaves(a), port.tree_leaves(b)):
        if u.is_floating_point() and not torch.equal(u, v):
            torch.testing.assert_close(u, v, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(u, v)
