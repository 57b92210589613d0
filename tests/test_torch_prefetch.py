"""Prefetch slots (``max_concurrency > 1``) in the PyTorch port, on the
CPU: one step and a whole ``run_swarm_scenario`` of the prefetch
fixture's four cells (``tools/policy_ab.py``'s ring, three slots,
``"spread"``) against the JAX reference, the four cells as batched lanes
with a timeline, ``policy_grid`` against ``tools/policy_ab.py``, the
chunked dispatch of the lanes, two slots and live mode against the
reference, and the fixture binding every prefetch branch.  On the card
(marker ``gpu``): the slot kernels against their plain versions.

The cells are ``tools/torch_port_fixture.py``'s ``PREFETCH_CELLS`` at
256 peers × 64 segments; the watch window is the run's 25 s, so the
crowd joins at 6.25 s and the fixture's departure wave (lane 1) leaves
at 12.5 s, the one-step state's clock."""

import functools
import json
import os
import sys

import jax
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
from hlsjs_p2p_wrapper_tpu_torch.testing import (REFERENCE_PREFETCH,
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
P, S, T, EVERY = 256, 64, 100, 10
WATCH_S = T * 0.25
#: the one-step state: 50 steps in, t = 12.5 s, the departure
STEP_AT = 50
#: final offload and rebuffer and the offload series, port vs reference
#: (tests/test_torch_swarm_sim.py RUN_TOL)
RUN_TOL = 1e-4
#: EWMA fields (``pow`` may round the last ulp apart between XLA and
#: PyTorch) and the other float fields (XLA's CPU backend may contract a
#: multiply and an add), as tests/test_torch_swarm_sim.py states them
EWMA_RTOL = FLOAT_RTOL = 1e-6
#: integer, index and packed fields: bit-identical
EXACT_FIELDS = ("level", "avail", "dl_flags", "dl_seg", "dl_level",
                "dl_holder_off", "dl_attempts", "t_s")


def _tree_np(tree):
    out = {}
    for k, v in tree._asdict().items():
        out[k] = ({f: np.asarray(x) for f, x in v._asdict().items()}
                  if hasattr(v, "_asdict") else np.asarray(v))
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


def _ref_config(slots=3, live=False):
    return ref.SwarmConfig(n_peers=P, n_segments=S, n_levels=1,
                           max_concurrency=slots, holder_selection="spread",
                           neighbor_offsets=ref.ring_offsets(8), live=live)


@functools.lru_cache(maxsize=None)
def _ref_audience():
    return ref_ab.build_audience(P, 0)


def _ref_lane(b, rconfig):
    """The reference's scenario of fixture lane ``b`` (the departure wave
    on its leave lane), its joins and leaves."""
    aud = _ref_audience()
    pattern, wave, up = CELLS[b]
    scen, join = ref_ab.build_cell_scenario(
        rconfig, None, aud, uplink_bps=up * 1e6, pattern=pattern,
        wave=wave, watch_s=WATCH_S)
    if b == LEAVE_LANE:
        scen = scen._replace(leave_s=jnp.where(
            aud["wave_ranks"] < LEAVE_FRACTION, WATCH_S / 2.0, ref.NEVER_S))
    return scen, join


@functools.lru_cache(maxsize=None)
def _reference(b, slots=3, live=False):
    """The reference's lane ``b`` with ``slots`` slots: its scenario,
    joins and leaves, its state at STEP_AT steps and one step later, and
    its T-step run (final state, offload series, ratios), as numpy."""
    rconfig = _ref_config(slots, live)
    scen, join = _ref_lane(b, rconfig)
    # the run as two scans of STEP_AT steps, so that one program serves
    # both halves
    mid, head = ref.run_swarm_scenario(rconfig, scen,
                                       ref.init_swarm(rconfig), STEP_AT)
    stepped = jax.jit(ref.swarm_step, static_argnums=0)(rconfig, scen, mid)
    final, tail = ref.run_swarm_scenario(rconfig, scen, mid, T - STEP_AT)
    series = jnp.concatenate([head, tail])
    return {"config": port.SwarmConfig(*rconfig),
            "scenario": _tree_np(scen), "join": np.asarray(join),
            "leave": np.asarray(scen.leave_s), "mid": _tree_np(mid),
            "stepped": _tree_np(stepped), "final": _tree_np(final),
            "series": np.asarray(series),
            "offload": float(ref.offload_ratio(final)),
            "rebuffer": float(ref.rebuffer_ratio(final, WATCH_S, join,
                                                 scen.leave_s))}


def _assert_run_matches(r):
    cp = r["config"]
    scen = scenario_from_numpy(r["scenario"], "cpu")
    final, series = port.run_swarm_scenario(
        cp, scen, port.init_swarm(cp, device="cpu"), T)
    _assert_state_close(state_to_numpy(final), r["final"])
    np.testing.assert_allclose(series.numpy(), r["series"], atol=RUN_TOL)
    assert abs(float(port.offload_ratio(final)) - r["offload"]) <= RUN_TOL
    assert abs(float(port.rebuffer_ratio(final, WATCH_S, r["join"],
                                         r["leave"]))
               - r["rebuffer"]) <= RUN_TOL
    return final


# ---- the grid --------------------------------------------------------------------

def test_policy_grid_is_the_tools():
    """The cells, the ring config, the audience and every cell's
    scenario and joins equal ``tools/policy_ab.py``'s to the bit, for
    each of the three policies; the random topology's config is the
    tool's (the general path is ported), and an unknown policy
    raises."""
    assert pg.cells() == [(p, w, u) for p in ref_ab.PATTERNS
                          for w in ref_ab.WAVES
                          for u in ref_ab.UPLINK_GRID_MBPS]
    assert (pg.BITRATE, pg.PATTERNS, pg.WAVES, pg.UPLINK_GRID_MBPS) == (
        ref_ab.BITRATE, ref_ab.PATTERNS, ref_ab.WAVES,
        ref_ab.UPLINK_GRID_MBPS)
    config = pg.ring_config(P, S)
    assert tuple(config) == tuple(_ref_config())
    aud = pg.build_audience(P, 0, device="cpu")
    for k, v in _ref_audience().items():
        np.testing.assert_array_equal(aud[k].numpy(), np.asarray(v))
    for pattern, wave, up in pg.cells():
        kw = dict(uplink_bps=up * 1e6, pattern=pattern, wave=wave,
                  watch_s=240.0)
        scen, join = pg.build_cell_scenario(config, aud, **kw)
        rscen, rjoin = ref_ab.build_cell_scenario(_ref_config(), None,
                                                  _ref_audience(), **kw)
        np.testing.assert_array_equal(join.numpy(), np.asarray(rjoin))
        for name in port.SwarmScenario._fields:
            got = getattr(scen, name).numpy()
            want = np.asarray(getattr(rscen, name))
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=name)
    for policy in pg.POLICIES:
        assert tuple(pg.ring_config(P, S, policy)) == tuple(
            _ref_config()._replace(holder_selection=policy))
    with pytest.raises(ValueError, match="unknown holder policy"):
        pg.ring_config(P, S, "nearest")
    assert tuple(pg.random_config(P, S)) == tuple(
        _ref_config()._replace(neighbor_offsets=None))


@pytest.mark.parametrize("record_every", [0, 40])
def test_batch_lane_bytes_match_reference_with_slots(record_every):
    """A three-slot lane at the ring's size pins what the reference
    counts (its ``[P, C]`` slot fields included), so the autotuner sizes
    the ring grid's chunks as the reference does."""
    config = pg.ring_config()
    got = port.batch_lane_bytes(config, 960, record_every=record_every)
    want = ref.batch_lane_bytes(ref.SwarmConfig(*config), 960,
                                record_every=record_every)
    assert got == want


def test_check_slice_takes_up_to_sixteen_slots():
    for slots in (2, 3, 16):
        for live in (False, True):
            port.check_slice(pg.ring_config(P, S)._replace(
                max_concurrency=slots, live=live))
    with pytest.raises(ValueError, match="max_concurrency=17"):
        port.check_slice(pg.ring_config(P, S)._replace(max_concurrency=17))


# ---- against the reference -------------------------------------------------------

@pytest.mark.parametrize("b", range(len(CELLS)))
def test_one_step_matches_reference(b):
    """One step from the reference's state at t = 12.5 s (the departure
    wave leaves on lane 1): integer and packed fields bit-identical,
    floats within their tolerances."""
    r = _reference(b)
    scen = scenario_from_numpy(r["scenario"], "cpu")
    got = state_to_numpy(port.swarm_step(r["config"], scen,
                                         state_from_numpy(r["mid"], "cpu")))
    _assert_state_close(got, r["stepped"])


@pytest.mark.parametrize("b", range(len(CELLS)))
def test_whole_run_matches_reference(b):
    """A T-step ``run_swarm_scenario``: the final state as one step's,
    the offload series and the final ratios within RUN_TOL."""
    final = _assert_run_matches(_reference(b))
    # every slot carried a transfer at some point of the run
    assert int(final.dl_attempts.max()) >= 0
    assert bool((final.avail != 0).any())


@pytest.mark.parametrize("slots,live", [(2, False), (3, True)])
def test_other_slots_and_live_match_reference(slots, live):
    """Two slots (the generic instantiation on the card), and three slots
    in live mode, on the hetero crowd cell: a whole run against the
    reference's."""
    _assert_run_matches(_reference(2, slots, live))


def test_batch_with_timeline_matches_reference():
    """The four cells as lanes of ``run_swarm_batch`` with a row every
    EVERY steps, against the reference's: final ratios and series within
    RUN_TOL, the timeline's clock and count columns equal, the integer
    and packed fields of the final lanes bit-identical."""
    rconfig = _ref_config()
    rbuilt = [_ref_lane(b, rconfig) for b in range(len(CELLS))]
    rfinal, rseries, rtl = ref.run_swarm_batch(
        rconfig, ref.stack_pytrees([sc for sc, _ in rbuilt]),
        ref.stack_pytrees([ref.init_swarm(rconfig)] * len(CELLS)), T,
        record_every=EVERY)
    rjoins = jnp.stack([j for _, j in rbuilt])
    rleaves = jnp.stack([sc.leave_s for sc, _ in rbuilt])
    fixture = np.load(REFERENCE_PREFETCH)
    cp, scen, joins, leaves = prefetch_lanes(fixture, "cpu", peers=P,
                                             segments=S, watch_s=WATCH_S)
    assert cp == port.SwarmConfig(*rconfig)
    np.testing.assert_array_equal(joins.numpy(), np.asarray(rjoins))
    np.testing.assert_array_equal(leaves.numpy(), np.asarray(rleaves))
    final, series, tl = port.run_swarm_batch(
        cp, scen, port.init_swarm(cp, device="cpu", batch=len(CELLS)), T,
        record_every=EVERY)
    got, want = state_to_numpy(final), _tree_np(rfinal)
    for name in EXACT_FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_allclose(series.numpy(), np.asarray(rseries),
                               atol=RUN_TOL)
    np.testing.assert_allclose(
        port.offload_ratio_batch(final).numpy(),
        np.asarray(ref.offload_ratio_batch(rfinal)), atol=RUN_TOL)
    np.testing.assert_allclose(
        port.rebuffer_ratio_batch(final, WATCH_S, joins, leaves).numpy(),
        np.asarray(ref.rebuffer_ratio_batch(rfinal, WATCH_S, rjoins,
                                            rleaves)),
        atol=RUN_TOL)
    cols = port.timeline_columns(cp)
    exact = [i for i, c in enumerate(cols)
             if c in ("t_s", "stalled_peers") or c.startswith("level_")]
    np.testing.assert_array_equal(tl.numpy()[..., exact],
                                  np.asarray(rtl)[..., exact])


# ---- inside the port -------------------------------------------------------------

def test_chunked_lanes_equal_the_direct_batch():
    """The four cells through ``run_groups_chunked`` in chunks of 3 (a
    tail of 1): rows equal to one direct batch's to the bit."""
    fixture = np.load(REFERENCE_PREFETCH)
    cp, scen, joins, leaves = prefetch_lanes(fixture, "cpu", peers=64,
                                             segments=S, watch_s=10.0)
    n, every = 40, 10
    lanes = list(range(len(CELLS)))

    def build(b):
        one = port.lane(scen, b)
        return one, one.join_s
    results, stats = dp.run_groups_chunked([(cp, lanes, build)], n,
                                           watch_s=10.0, chunk=3,
                                           record_every=every)
    assert stats[0]["chunks"] == 2
    final, _series, tl = port.run_swarm_batch(
        cp, scen, port.init_swarm(cp, device="cpu", batch=len(lanes)), n,
        record_every=every)
    offs = port.offload_ratio_batch(final)
    rebs = port.rebuffer_ratio_batch(final, 10.0, joins)
    for b, (off, reb, row_tl) in enumerate(results[0]):
        assert off == float(offs[b]) and reb == float(rebs[b])
        np.testing.assert_array_equal(row_tl, tl[b].numpy())


def test_the_fixture_binds_every_prefetch_branch():
    """The committed fixture's lanes at its own shape bind absorb, the
    dedup guard and the attempt rotation within its first 30 steps; at
    this file's size, over the run, every prefetch branch binds
    (``chip_smoke.py``'s count, which the card's check uses too)."""
    fixture = np.load(REFERENCE_PREFETCH)
    assert json.loads(str(fixture["cells"])) == [list(c) for c in CELLS]
    assert tuple(fixture["shape"]) == torch_port_fixture.BATCH_SHAPE
    cp, scen, _joins, _leaves = prefetch_lanes(fixture, "cpu")
    state = port.init_swarm(cp, device="cpu", batch=len(CELLS))
    for _ in range(30):
        sk.plain_step(cp, scen, state)
    counts = chip_smoke.prefetch_branch_counts(port, sk, cp, scen, state)
    assert min(counts["absorb"], counts["conflict"], counts["rotation"]) > 0
    cp, scen, _joins, _leaves = prefetch_lanes(fixture, "cpu", peers=P,
                                               segments=S, watch_s=WATCH_S)
    state = port.init_swarm(cp, device="cpu", batch=len(CELLS))
    total = dict.fromkeys(counts, 0)
    for s in range(T):
        if s % 5 == 0 or s == STEP_AT:
            for name, n in chip_smoke.prefetch_branch_counts(
                    port, sk, cp, scen, state).items():
                total[name] += n
        sk.plain_step(cp, scen, state)
    assert all(n > 0 for n in total.values()), total


# ---- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("slots,offsets", [
    (3, None), (3, (1, -1, 2, -2, 97, -97, 300, -300)), (2, None),
    (16, None)])
def test_slot_kernels_match_plain_on_the_card(cuda_device, slots, offsets):
    """The fixture's cells as lanes at 4,096 peers, 50 plain steps in,
    stepped 40 times by the kernels (the fused route, or TK1 + TK2 for a
    wide offset tuple; C = 3 compiled for its C, the others the generic
    instantiation) beside the plain step: integer fields equal, floats
    within 1e-6."""
    fixture = np.load(REFERENCE_PREFETCH)
    config, scen, _j, _l = prefetch_lanes(fixture, cuda_device, peers=4096,
                                          segments=S, watch_s=WATCH_S,
                                          slots=slots)
    if offsets is not None:
        config = config._replace(neighbor_offsets=offsets)
    state = port.init_swarm(config, device=cuda_device, batch=len(CELLS))
    for _ in range(STEP_AT):
        state = sk.plain_step(config, scen, state)
    a, b = port.clone_state(state), port.clone_state(state)
    for _ in range(40):
        a = port.swarm_step(config, scen, a)
        b = sk.plain_step(config, scen, b)
    torch.cuda.synchronize()
    for u, v in zip(port.tree_leaves(a), port.tree_leaves(b)):
        if u.is_floating_point() and not torch.equal(u, v):
            torch.testing.assert_close(u, v, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(u, v)
