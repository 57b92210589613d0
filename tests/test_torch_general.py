"""The general ``[P, K]`` neighbour path and the uncapped fair share in the
PyTorch port, on the CPU, against the JAX reference: the topology helpers
and ``invert_neighbors`` to the bit; one step from a shared mid-run state
and a whole run of ``tools/policy_ab.py``'s random mesh for every policy
at three slots and at one, VOD, and at three slots live; the full, ring,
isolated and padded lists (the ring's duplicate offsets collapsing to
self-padding shows in the helpers' bits); the uncapped fair share on the
random mesh and on the ring; the reference's own cross-check (ranked,
uncapped: the general path on ``ring_neighbors`` equals the circulant
path on ``ring_offsets``) run on the port; lanes alone, batched and
chunked; the policy grid's random half; the refusals that stay; and the
committed general fixture.  On the card (marker ``gpu``): the gather
kernels against their plain versions.

The lanes are the prefetch fixture's four cells (``tools/policy_ab.py``'s
regime cells, the departure wave on lane 1) at 256 peers × 64 segments
with a 25 s watch window: 100 steps, whose midpoint (step 50, when the
departure wave leaves) is the one-step state."""

import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlsjs_p2p_wrapper_tpu.ops import swarm_sim as ref
from hlsjs_p2p_wrapper_tpu_torch import policy_grid as pg
from hlsjs_p2p_wrapper_tpu_torch.ops import dispatch as dp
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_kernels as sk
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as port
from hlsjs_p2p_wrapper_tpu_torch.testing import (REFERENCE_GENERAL,
                                                 REFERENCE_PREFETCH,
                                                 general_runs,
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
STEPS = 100
#: topologies by name: (peers, the reference's neighbour list, or None
#: for the circulant ring of 8)
TOPOLOGIES = {
    "random": lambda: (P, ref.random_neighbors(P, 8, 0)),
    "full8": lambda: (8, ref.full_neighbors(8)),
    "ring16": lambda: (16, ref.ring_neighbors(16, 8)),
    "isolated": lambda: (32, ref.isolated_neighbors(32, 3)),
    # a degree-6 mesh padded to 8 columns with self entries
    "kpad": lambda: (64, ref.random_neighbors(64, 6, 1, k_pad=8)),
    "offsets": lambda: (P, None),
}
#: (topology, policy, slots, live, max_total_serves)
CASES = ([("random", policy, slots, live, 2)
          for policy in ("spread", "adaptive", "ranked")
          for slots, live in ((3, False), (1, False), (3, True))]
         + [("full8", "ranked", 3, False, 2),
            ("ring16", "spread", 3, False, 2),
            ("isolated", "spread", 3, False, 2),
            ("kpad", "adaptive", 3, False, 2),
            # the uncapped fair share, on the mesh and on the ring
            ("random", "adaptive", 3, True, 0),
            ("offsets", "ranked", 3, False, 0)])
#: final offload and rebuffer and the offload series, port vs reference
#: (tests/test_torch_swarm_sim.py RUN_TOL)
RUN_TOL = 1e-4
#: EWMA fields and the other float fields, as tests/test_torch_policies.py
#: states them
EWMA_RTOL = FLOAT_RTOL = 1e-6
#: integer, index and packed fields, the clock and the penalty window:
#: bit-identical
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


def _case_id(case):
    topo, policy, slots, live, cap = case
    return (f"{topo}-{policy}-C{slots}{'-live' if live else ''}"
            f"{'-uncapped' if cap == 0 else ''}")


@functools.lru_cache(maxsize=None)
def _reference(topo, policy, slots, live, cap):
    """The reference's four lanes of ``CELLS`` on ``topo``: the stacked
    scenarios, joins and leaves, the state at step 50 and one step later,
    and the whole run of STEPS steps (final states, offload series,
    ratios), as numpy.  The run is one-step calls of ``run_swarm_batch``,
    so that one compiled program serves every state."""
    peers, nbr = TOPOLOGIES[topo]()
    rconfig = ref.SwarmConfig(
        n_peers=peers, n_segments=S, n_levels=1, max_concurrency=slots,
        holder_selection=policy, live=live, max_total_serves=cap,
        neighbor_offsets=ref.ring_offsets(8) if nbr is None else None)
    aud = ref_ab.build_audience(peers, 0)
    built = []
    for b, (pattern, wave, up) in enumerate(CELLS):
        scen, join = ref_ab.build_cell_scenario(
            rconfig, nbr, aud, uplink_bps=up * 1e6, pattern=pattern,
            wave=wave, watch_s=WATCH_S)
        if b == LEAVE_LANE:
            scen = scen._replace(leave_s=jnp.where(
                aud["wave_ranks"] < LEAVE_FRACTION, WATCH_S / 2.0,
                ref.NEVER_S))
        built.append((scen, join))
    scens = ref.stack_pytrees([sc for sc, _ in built])
    joins = jnp.stack([j for _, j in built])
    n_nbr = None if nbr is None else nbr.shape[1]
    state = ref.stack_pytrees([ref.init_swarm(rconfig, n_nbr)] * len(CELLS))
    series = []
    for s in range(STEPS):
        if s == STEPS // 2:
            mid = _tree_np(state)
        state, column = ref.run_swarm_batch(rconfig, scens, state, 1)
        series.append(np.array(column))
        if s == STEPS // 2:
            stepped = _tree_np(state)
    watch_s = STEPS * rconfig.dt_ms / 1000.0
    return {"config": port.SwarmConfig(*rconfig), "n_nbr": n_nbr,
            "scenario": _tree_np(scens), "join": np.asarray(joins),
            "leave": np.asarray(scens.leave_s), "mid": mid,
            "stepped": stepped, "final": _tree_np(state),
            "series": np.concatenate(series, axis=1),
            "offload": np.asarray(ref.offload_ratio_batch(state)),
            "rebuffer": np.asarray(ref.rebuffer_ratio_batch(
                state, watch_s, joins, scens.leave_s)),
            "watch_s": watch_s}


# ---- the topology helpers ---------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("random_neighbors", (256, 8, 0)), ("random_neighbors", (256, 8, 7)),
    ("random_neighbors", (50, 8, 3, 10)), ("random_neighbors", (5, 8, 1)),
    ("random_neighbors", (1000, 8, 0)),
    ("ring_neighbors", (16, 8)), ("ring_neighbors", (6, 8)),
    ("ring_neighbors", (64, 6, 8)), ("full_neighbors", (8,)),
    ("full_neighbors", (8, 9)), ("isolated_neighbors", (7, 3))])
def test_topology_helpers_match_reference_to_the_bit(name, args):
    """Each helper gives the reference's array (the same seeded draws for
    the random mesh) as an int32 tensor on the asked device, and
    ``invert_neighbors`` of it the reference's inverse."""
    want = np.asarray(getattr(ref, name)(*args))
    got = getattr(port, name)(*args, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    inv = port.invert_neighbors(got, device="cpu")
    assert inv.dtype == torch.int32
    np.testing.assert_array_equal(inv.numpy(),
                                  np.asarray(ref.invert_neighbors(want)))


def test_adjacency_and_full_offsets_match_reference():
    rng = np.random.default_rng(3)
    adj = rng.random((40, 40)) < 0.2
    for k_pad in (None, 20):
        np.testing.assert_array_equal(
            port.neighbors_from_adjacency(adj, k_pad, device="cpu").numpy(),
            np.asarray(ref.neighbors_from_adjacency(adj, k_pad)))
    assert port.full_offsets(9) == ref.full_offsets(9)
    empty = port.invert_neighbors(np.zeros((5, 0), np.int32), device="cpu")
    assert tuple(empty.shape) == (5, 0)


# ---- against the reference --------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_one_step_matches_reference(case):
    """One step of the four lanes from the reference's state at step 50
    (transfers in flight, the departure wave leaving): integer, index and
    packed fields, the clock and the penalty window bit-identical, floats
    within their tolerances."""
    r = _reference(*case)
    assert (r["mid"]["dl_flags"] & 1).any()
    scen = scenario_from_numpy(r["scenario"], "cpu")
    got = state_to_numpy(port.swarm_step(r["config"], scen,
                                         state_from_numpy(r["mid"], "cpu")))
    _assert_state_close(got, r["stepped"])


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_whole_run_matches_reference(case):
    """The whole run of the four lanes (``run_swarm_batch`` from a fresh
    state): the final state as one step's, the offload series and each
    lane's final ratios within RUN_TOL."""
    r = _reference(*case)
    cp = r["config"]
    scen = scenario_from_numpy(r["scenario"], "cpu")
    final, series = port.run_swarm_batch(
        cp, scen, port.init_swarm(cp, r["n_nbr"], device="cpu",
                                  batch=len(CELLS)), STEPS)
    _assert_state_close(state_to_numpy(final), r["final"])
    np.testing.assert_allclose(series.numpy(), r["series"], atol=RUN_TOL)
    np.testing.assert_allclose(port.offload_ratio_batch(final).numpy(),
                               r["offload"], atol=RUN_TOL)
    np.testing.assert_allclose(
        port.rebuffer_ratio_batch(final, r["watch_s"], r["join"],
                                  r["leave"]).numpy(),
        r["rebuffer"], atol=RUN_TOL)
    if case[0] == "isolated":
        assert not bool(final.p2p_bytes.any())   # the all-CDN control


def test_ranked_uncapped_general_equals_circulant():
    """The reference's own cross-check (tests/test_swarm_sim.py
    test_ranked_circulant_matches_general_path), run on the port: with
    admission uncapped, ranked on ``ring_neighbors`` (the general path)
    traces the circulant path's trajectories on ``ring_offsets`` over
    90 s at 32 peers, within the reference's tolerance; capped, the two
    admit in different orders and agree in aggregate."""
    config = port.SwarmConfig(n_peers=32, n_segments=64, n_levels=3,
                              holder_selection="ranked", max_total_serves=0)
    bitrates = [300_000.0, 800_000.0, 2_000_000.0]
    nbr = port.ring_neighbors(32, 8, device="cpu")
    cdn = np.full(32, 8_000_000.0, np.float32)
    join = np.linspace(0.0, 60.0, 32).astype(np.float32)
    n = int(90.0 * 1000.0 / config.dt_ms)
    state = port.init_swarm(config, device="cpu")
    circ_cfg = config._replace(neighbor_offsets=port.ring_offsets(8))
    general, _ = port.run_swarm(config, bitrates, nbr, cdn, state, n, join,
                                device="cpu")
    circ, _ = port.run_swarm(circ_cfg, bitrates, None, cdn, state, n, join,
                             device="cpu")
    assert float(port.offload_ratio(general)) > 0.0
    for x, y in zip(port.tree_leaves(general), port.tree_leaves(circ)):
        torch.testing.assert_close(x.to(torch.float32), y.to(torch.float32),
                                   atol=1e-3, rtol=1e-5)
    capped = config._replace(max_total_serves=2)
    cap_gen, _ = port.run_swarm(capped, bitrates, nbr, cdn, state, n, join,
                                device="cpu")
    cap_circ, _ = port.run_swarm(
        capped._replace(neighbor_offsets=port.ring_offsets(8)), bitrates,
        None, cdn, state, n, join, device="cpu")
    assert abs(float(port.offload_ratio(cap_gen))
               - float(port.offload_ratio(cap_circ))) < 0.05


def test_admission_walks_inbound_edges_in_order():
    """``admit_gather``'s plain version against a loop over holders: each
    walks its inbound edge row in order, slot by slot, admitting under
    the cap, and the flags land on the requesters; uncapped, every demand
    is admitted and the load is the demand count."""
    rng = np.random.default_rng(5)
    peers, K, C = 40, 6, 3
    nbr = port.random_neighbors(peers, K, 2, device="cpu")
    inv = port.invert_neighbors(nbr, device="cpu").numpy()
    req = torch.from_numpy(rng.integers(-2, K, (1, peers, C)).astype(
        np.int32)).clamp_min(-1)
    for cap in (2, 0):
        config = port.SwarmConfig(n_peers=peers, n_segments=8, n_levels=1,
                                  max_concurrency=C, max_total_serves=cap)
        scen = port.as_lanes(port.make_scenario(
            config, [1e6], nbr, np.full(peers, 8e6), device="cpu"))
        service, adm = sk.admit_service_plain(config, scen, req)
        load = np.zeros(peers)
        want = np.zeros((peers, C), np.int32)
        for j in range(peers):
            for c in range(C):
                for f in inv[j]:
                    if f < 0:
                        break
                    i, k = divmod(int(f), K)
                    if int(req[0, i, c]) == k:
                        if cap == 0 or load[j] < cap:
                            load[j] += 1
                            want[i, c] = 1
        np.testing.assert_array_equal(adm[0].numpy(), want)
        np.testing.assert_allclose(
            service[0].numpy(),
            (config.p2p_bps * np.float32(config.uplink_efficiency)
             / np.maximum(load, 1.0)).astype(np.float32), rtol=1e-6)
        if cap == 0:
            assert load.max() > 2   # the cap would bind: a real check


# ---- inside the port --------------------------------------------------------

@pytest.mark.parametrize("policy", ["adaptive", "ranked"])
def test_lanes_batched_alone_and_chunked_agree(policy):
    """The fixture's cells as four lanes of the random mesh at 64 peers
    (``policy_grid``'s random config and memoized topology): lane 2 run
    alone equals its lane of the batch to the bit, the ``[B, P, K]``
    penalty field included; the chunked dispatch in chunks of 3 gives
    the direct batch's rows to the bit."""
    fixture = np.load(REFERENCE_PREFETCH)
    cp, scen, joins, _leaves = prefetch_lanes(
        fixture, "cpu", peers=64, segments=S, watch_s=10.0, policy=policy,
        topology="random")
    n, B = 40, len(CELLS)
    assert tuple(scen.neighbors.shape) == (B, 64, 8)
    final, series = port.run_swarm_batch(
        cp, scen, port.init_swarm(cp, 8, device="cpu", batch=B), n)
    assert tuple(final.holder_penalty_ms.shape) == (
        B, 64, 8 if policy == "adaptive" else 0)
    alone, alone_series = port.run_swarm_scenario(
        cp, port.lane(scen, 2), port.init_swarm(cp, 8, device="cpu"), n)
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


def test_policy_grid_random_half_matches_the_tool():
    """``random_config`` is the tool's random-mesh config for each
    policy; ``random_topology`` draws the mesh once per (peers, seed,
    device); a cell's scenario is the tool's, the
    neighbour list and inbound edges included; the per-lane footprint
    the autotuner sizes chunks by is the reference's."""
    peers = 64
    aud_r = ref_ab.build_audience(peers, 0)
    nbr_r = ref.random_neighbors(peers, 8, 0)
    aud = pg.build_audience(peers, 0, device="cpu")
    topo = pg.random_topology(peers, 0, device="cpu")
    assert pg.random_topology(peers, 0, device="cpu") is topo
    for policy in pg.POLICIES:
        cfg = pg.random_config(peers, S, policy)
        rcfg = ref.SwarmConfig(n_peers=peers, n_segments=S, n_levels=1,
                               max_concurrency=3, holder_selection=policy)
        assert tuple(cfg) == tuple(rcfg)
    for pattern, wave, up in CELLS:
        scen, join = pg.build_cell_scenario(
            cfg, aud, uplink_bps=up * 1e6, pattern=pattern, wave=wave,
            watch_s=WATCH_S, neighbors=topo)
        rscen, rjoin = ref_ab.build_cell_scenario(
            rcfg, nbr_r, aud_r, uplink_bps=up * 1e6, pattern=pattern,
            wave=wave, watch_s=WATCH_S)
        np.testing.assert_array_equal(join.numpy(), np.asarray(rjoin))
        for name in port.SwarmScenario._fields:
            got = getattr(scen, name).numpy()
            want = np.asarray(getattr(rscen, name))
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=name)
    for record_every in (0, 40):
        assert port.batch_lane_bytes(cfg, 960, record_every=record_every,
                                     scenario=scen) == ref.batch_lane_bytes(
            rcfg, 960, record_every=record_every, scenario=rscen)
        assert port.batch_lane_bytes(cfg, 960, n_neighbors=8) == \
            ref.batch_lane_bytes(rcfg, 960, n_neighbors=8)


def test_refusals_that_stay():
    """Offsets together with a real list, an unknown policy and more than
    16 slots still raise, as in the reference; the port also refuses ids
    outside the swarm and, under ranked, a row naming one peer twice."""
    cfg = port.SwarmConfig(n_peers=16, n_segments=8, n_levels=1)
    nbr = port.random_neighbors(16, 4, 0, device="cpu")
    cdn = np.full(16, 8e6)
    with pytest.raises(ValueError, match="both"):
        port.make_scenario(cfg._replace(neighbor_offsets=(1, -1)), [1e6],
                           nbr, cdn, device="cpu")
    with pytest.raises(ValueError, match="neighbors=None requires"):
        port.make_scenario(cfg, [1e6], None, cdn, device="cpu")
    with pytest.raises(ValueError, match="unknown holder_selection"):
        port.check_slice(cfg._replace(holder_selection="nearest"))
    with pytest.raises(ValueError, match="max_concurrency"):
        port.check_slice(cfg._replace(max_concurrency=17))
    with pytest.raises(ValueError, match="outside"):
        port.make_scenario(cfg, [1e6], nbr + 16, cdn, device="cpu")
    twice = nbr.clone()
    twice[3, 1] = twice[3, 0]
    port.make_scenario(cfg, [1e6], twice, cdn, device="cpu")   # spread
    with pytest.raises(ValueError, match="twice"):
        port.make_scenario(cfg._replace(holder_selection="ranked"), [1e6],
                           twice, cdn, device="cpu")
    # the placeholder round-trips in circulant mode, as in the reference
    scen = port.make_scenario(cfg._replace(neighbor_offsets=(1, -1)), [1e6],
                              np.zeros((16, 0), np.int32), cdn, device="cpu")
    assert tuple(scen.in_edges.shape) == (16, 0)
    for name in ("elig_select_gather", "admit_gather", "peer_update_gather"):
        assert sk.KERNEL_OF[name] == name and name in sk.GATHER_PATH


def test_a_shared_list_is_checked_and_inverted_once():
    """Cells that share one neighbour list share its inverse, the
    reference's; a list written in place after its first use is checked
    and inverted again, and a list first used under spread is checked
    for ranked's duplicates when a ranked scenario takes it."""
    cfg = port.SwarmConfig(n_peers=16, n_segments=8, n_levels=1)
    nbr = port.random_neighbors(16, 4, 0, device="cpu")
    cdn = np.full(16, 8e6)
    one = port.make_scenario(cfg, [1e6], nbr, cdn, device="cpu")
    two = port.make_scenario(cfg, [2e6], nbr, cdn, device="cpu")
    assert two.in_edges is one.in_edges
    np.testing.assert_array_equal(
        one.in_edges.numpy(), np.asarray(ref.invert_neighbors(nbr.numpy())))
    nbr[3, 1] = nbr[3, 0]
    spread = port.make_scenario(cfg, [1e6], nbr, cdn, device="cpu")
    assert spread.in_edges is not one.in_edges
    np.testing.assert_array_equal(
        spread.in_edges.numpy(),
        np.asarray(ref.invert_neighbors(nbr.numpy())))
    with pytest.raises(ValueError, match="twice"):
        port.make_scenario(cfg._replace(holder_selection="ranked"), [1e6],
                           nbr, cdn, device="cpu")
    nbr[5, 0] = 16
    with pytest.raises(ValueError, match="outside"):
        port.make_scenario(cfg, [1e6], nbr, cdn, device="cpu")


def test_convert_carries_the_topology():
    """``testing.convert`` carries the reference's neighbour list and
    inbound edges, ``[P, K]`` and ``[B, P, K]``, to the port and back
    to the bit."""
    nbr = ref.random_neighbors(32, 8, 4)
    cfg = ref.SwarmConfig(n_peers=32, n_segments=8, n_levels=1)
    one = _tree_np(ref.make_scenario(cfg, jnp.array([1e6]), nbr,
                                     jnp.full((32,), 8e6)))
    many = _tree_np(ref.stack_pytrees([ref.make_scenario(
        cfg, jnp.array([1e6]), nbr, jnp.full((32,), 8e6))] * 3))
    for fields in (one, many):
        scen = scenario_from_numpy(fields, "cpu")
        for name in ("neighbors", "in_edges"):
            got = getattr(scen, name)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), fields[name])


# ---- the committed fixture --------------------------------------------------

def test_general_fixture_matches_the_reference():
    """The committed general fixture (``chip_smoke.py`` holds the port to
    it on the card): its runs are :data:`GENERAL_RUNS`, they share the
    prefetch fixture's shape, cells and departure wave, and its first run
    (spread on the random mesh) is what the reference gives today
    (regenerate with ``python tools/torch_port_fixture.py
    --only-general``).  The port's runs of it take minutes on a CPU; the
    cases above hold the port to the reference on the same path."""
    d = np.load(REFERENCE_GENERAL)
    assert general_runs(d) == [tuple(r) for r in
                               torch_port_fixture.GENERAL_RUNS]
    prefetch = np.load(REFERENCE_PREFETCH)
    for name in ("cells", "shape", "join_s", "leave_s", "leave_lane",
                 "seed"):
        np.testing.assert_array_equal(d[name], prefetch[name])
    name, policy, cap = general_runs(d)[0]
    fresh = torch_port_fixture.reference_prefetch(
        torch_port_fixture.BATCH_SHAPE, policy, "random", cap)
    for key in ("offload", "rebuffer", "series", "timeline"):
        np.testing.assert_allclose(d[f"{name}_{key}"], fresh[key],
                                   rtol=1e-6, err_msg=key)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("policy,slots,live,cap,mesh", [
    ("spread", 3, False, 2, None), ("adaptive", 3, False, 2, None),
    ("ranked", 3, False, 2, None), ("adaptive", 1, True, 2, None),
    ("ranked", 3, True, 0, None), ("spread", 16, False, 0, None),
    ("spread", 3, False, 2, (48, 32)), ("adaptive", 3, False, 1, (48, 32)),
    ("ranked", 5, True, 2, (48, 32))])
def test_gather_kernels_match_plain_on_the_card(cuda_device, policy, slots,
                                                live, cap, mesh):
    """The fixture's cells as lanes of the random mesh at 4,096 peers (or,
    with ``mesh``, of ``random_neighbors(peers, degree)`` at 48 peers and
    degree 32, whose inbound rows pass 32 edges: ``admit_gather``'s
    second mask word), 50 plain steps in, stepped 40 times by the gather
    kernels beside the plain step: integer fields and the penalty window
    equal, floats within 1e-6."""
    fixture = np.load(REFERENCE_PREFETCH)
    peers, degree = mesh or (4096, 8)
    config, scen, _j, _l = prefetch_lanes(
        fixture, cuda_device, peers=peers, segments=S, watch_s=WATCH_S,
        slots=slots, policy=policy, topology="random",
        max_total_serves=cap)
    config = config._replace(live=live)
    if mesh:
        nbr = port.random_neighbors(peers, degree, 0, device=cuda_device)
        inv = port.invert_neighbors(nbr, device=cuda_device)
        assert inv.shape[-1] > 32
        B = len(CELLS)
        scen = scen._replace(
            neighbors=nbr.expand(B, *nbr.shape).contiguous(),
            in_edges=inv.expand(B, *inv.shape).contiguous())
    state = port.init_swarm(config, degree, device=cuda_device,
                            batch=len(CELLS))
    for _ in range(50):
        state = sk.plain_step(config, scen, state)
    a, b = port.clone_state(state), port.clone_state(state)
    sk.reset_launch_counts()
    for _ in range(40):
        a = port.swarm_step(config, scen, a)
        b = sk.plain_step(config, scen, b)
    torch.cuda.synchronize()
    assert all(sk.LAUNCHES[k] == 40 for k in sk.GATHER_PATH)
    assert torch.equal(a.holder_penalty_ms, b.holder_penalty_ms)
    for u, v in zip(port.tree_leaves(a), port.tree_leaves(b)):
        if u.is_floating_point() and not torch.equal(u, v):
            torch.testing.assert_close(u, v, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(u, v)
