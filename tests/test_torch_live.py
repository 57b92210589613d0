"""Live mode in the PyTorch port, on the CPU: one step and a whole run
of ``run_swarm_scenario`` on live grid points against the JAX
reference, four live lanes batched with a timeline, the live grid and
its scenarios against ``tools/sweep.py``, the chunked dispatch of live
lanes, and VOD's untouched stagger clock.  On the card (marker ``gpu``):
the live kernels against their plain versions.

The points are 15, 43, 107 and 136 of ``live_grid()``, the live
fixture's (``tools/torch_port_fixture.py`` ``LIVE_POINTS``): between
them stagger windows of 2 and 8 s, announce lags of 0 and 4 s, both
join waves, all three supply points, both cushions and both urgency
margins.  The watch window that places the crowd wave is 50 s, so the
crowd joins at 12.5 s, inside a 100-step run."""

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
from hlsjs_p2p_wrapper_tpu_torch import sweep_grid as sg
from hlsjs_p2p_wrapper_tpu_torch.ops import dispatch as dp
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_kernels as sk
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as port
from hlsjs_p2p_wrapper_tpu_torch.testing import REFERENCE_LIVE
from hlsjs_p2p_wrapper_tpu_torch.testing.convert import (
    scenario_from_numpy, state_from_numpy, state_to_numpy)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import sweep as ref_sweep  # noqa: E402
import torch_port_fixture  # noqa: E402

POINTS = torch_port_fixture.LIVE_POINTS
P, S, T, EVERY = 256, 64, 100, 10
WATCH_S = 50.0
#: the one-step state: 50 steps in, t = 12.5 s, the step at which the
#: crowd joins (its playhead floor binds)
STEP_AT = 50
#: final offload and rebuffer and the offload series, port vs reference
#: (tests/test_torch_swarm_sim.py RUN_TOL)
RUN_TOL = 1e-4
#: EWMA fields (``pow`` may round the last ulp apart between XLA and
#: PyTorch) and the other float fields (XLA's CPU backend may contract
#: a multiply and an add), as tests/test_torch_swarm_sim.py states them
EWMA_RTOL = FLOAT_RTOL = 1e-6
#: integer, index and packed fields, and the stagger's wait clock, a sum
#: of whole dt_ms steps that float32 holds exactly: bit-identical
EXACT_FIELDS = ("level", "avail", "dl_flags", "dl_seg", "dl_level",
                "dl_holder_off", "dl_attempts", "fg_wait_ms", "t_s")


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
            np.testing.assert_allclose(got[k], v, rtol=FLOAT_RTOL,
                                       err_msg=k)


def _config():
    return sg.build_config(P, S, True, 8)


@functools.lru_cache(maxsize=None)
def _reference(point):
    """The reference's scenario of ``live_grid()[point]``, its joins,
    its state at STEP_AT steps and after one more step, and its T-step
    run (final state, offload series), as numpy."""
    rconfig = ref.SwarmConfig(*_config())
    knobs = ref_sweep.live_grid()[point]
    scen, join = ref_sweep.build_scenario(rconfig, knobs, watch_s=WATCH_S,
                                          stagger_s=60.0, seed=0)
    mid, _ = ref.run_swarm_scenario(rconfig, scen, ref.init_swarm(rconfig),
                                    STEP_AT)
    stepped = jax.jit(ref.swarm_step, static_argnums=0)(rconfig, scen, mid)
    final, series = ref.run_swarm_scenario(rconfig, scen,
                                           ref.init_swarm(rconfig), T)
    return {"scenario": _tree_np(scen), "join": np.asarray(join),
            "mid": _tree_np(mid), "stepped": _tree_np(stepped),
            "final": _tree_np(final), "series": np.asarray(series),
            "offload": float(ref.offload_ratio(final)),
            "rebuffer": float(ref.rebuffer_ratio(final, T * 0.25, join))}


# ---- the slice and the grid ------------------------------------------------------

def test_check_slice_accepts_live():
    port.check_slice(_config())


def test_live_grid_is_the_references():
    assert sg.live_grid() == ref_sweep.live_grid()
    assert len(sg.live_grid()) == 144


@pytest.mark.parametrize("point", [0, 1, 107, 136])
def test_build_scenario_joins_and_ranks_are_the_references(point):
    """Steady (0, 136) and crowd (1, 107) points: every scenario field,
    the joins and the ranks equal ``tools/sweep.py``'s to the bit."""
    knobs = sg.live_grid()[point]
    scen, join = sg.build_scenario(_config(), knobs, watch_s=WATCH_S,
                                   stagger_s=60.0, seed=0, device="cpu")
    rscen, rjoin = ref_sweep.build_scenario(ref.SwarmConfig(*_config()),
                                            knobs, watch_s=WATCH_S,
                                            stagger_s=60.0, seed=0)
    assert join.dtype == torch.float32
    np.testing.assert_array_equal(join.numpy(), np.asarray(rjoin))
    for name in port.SwarmScenario._fields:
        got, want = getattr(scen, name).numpy(), np.asarray(
            getattr(rscen, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=name)
    crowd = knobs["join_wave"] == "crowd"
    assert float(join.max()) == (WATCH_S / 4.0 if crowd else 0.0)


def test_fixture_points_bind_the_live_branches():
    """No fixture point is idle in live mode (no stagger, no announce
    lag and the steady wave at once), and between them the points span
    both values of every knob that a live branch reads, and every
    supply point."""
    grid = sg.live_grid()
    points = [grid[i] for i in POINTS]
    for i, knobs in zip(POINTS, points):
        assert not (knobs["spread_s"] == 0.0
                    and knobs["announce_delay_s"] == 0.0
                    and knobs["join_wave"] == "steady"), i
    spans = {k: {p[k] for p in points} for k in points[0]}
    assert {0.0, 4.0} <= spans["announce_delay_s"]
    assert {2.0, 8.0} <= spans["spread_s"]
    assert spans["join_wave"] == {"steady", "crowd"}
    assert spans["live_sync_s"] == {6.0, 12.0}
    assert spans["urgent_margin_s"] == {0.5, 4.0}
    assert len({(p["uplink_mbps"], p["cdn_mbps"]) for p in points}) == 3
    d = np.load(REFERENCE_LIVE)
    assert json.loads(str(d["grid"])) == points


# ---- against the reference ------------------------------------------------------

@pytest.mark.parametrize("point", POINTS)
def test_one_step_matches_reference(point):
    """One step from the reference's state at t = 12.5 s, when the crowd
    joins: integer fields and the wait clock bit-identical, floats
    within their tolerances."""
    r = _reference(point)
    cp = _config()
    scen = scenario_from_numpy(r["scenario"], "cpu")
    got = state_to_numpy(port.swarm_step(cp, scen,
                                         state_from_numpy(r["mid"], "cpu")))
    _assert_state_close(got, r["stepped"])


def test_the_states_bind_every_live_branch():
    """Over the four points' one-step states (t = 12.5 s: the crowd
    joins) and final states (t = 25 s: fresh segments announced late),
    every live branch binds some peers (``chip_smoke.py``'s count, which
    the card's check uses too), and a step's blocked foregrounds are
    exactly the peers whose wait clock runs after it."""
    cp = _config()
    total = dict(floored=0, gated=0, blocked=0, hidden=0)
    for point in POINTS:
        r = _reference(point)
        scen = scenario_from_numpy(r["scenario"], "cpu")
        for key in ("mid", "final"):
            st = state_from_numpy(r[key], "cpu")
            for name, n in chip_smoke.live_branch_counts(
                    port, sk, cp, port.as_lanes(scen),
                    port.as_lanes(st)).items():
                total[name] += n
        flags, _req = sk.elig_select_plain(
            cp, scen, state_from_numpy(r["mid"], "cpu"))
        np.testing.assert_array_equal(r["stepped"]["fg_wait_ms"] > 0,
                                      ((flags[..., 0] & 16) != 0).numpy())
    assert all(n > 0 for n in total.values()), total


@pytest.mark.parametrize("point", POINTS)
def test_whole_run_matches_reference(point):
    """A T-step ``run_swarm_scenario``: the final state as one step's,
    the offload series and the final ratios within RUN_TOL."""
    r = _reference(point)
    cp = _config()
    scen = scenario_from_numpy(r["scenario"], "cpu")
    final, series = port.run_swarm_scenario(
        cp, scen, port.init_swarm(cp, device="cpu"), T)
    _assert_state_close(state_to_numpy(final), r["final"])
    np.testing.assert_allclose(series.numpy(), r["series"], atol=RUN_TOL)
    assert abs(float(port.offload_ratio(final)) - r["offload"]) <= RUN_TOL
    assert abs(float(port.rebuffer_ratio(final, T * 0.25, r["join"]))
               - r["rebuffer"]) <= RUN_TOL


def test_batch_with_timeline_matches_reference():
    """The four points as lanes of ``run_swarm_batch`` with a row every
    EVERY steps, against the reference's: final ratios and series within
    RUN_TOL, the timeline's clock and count columns equal, the lanes'
    wait clocks bit-identical."""
    cp = _config()
    rconfig = ref.SwarmConfig(*cp)
    grid = [sg.live_grid()[i] for i in POINTS]
    rbuilt = [ref_sweep.build_scenario(rconfig, k, watch_s=WATCH_S,
                                       stagger_s=60.0, seed=0)
              for k in grid]
    rfinal, rseries, rtl = ref.run_swarm_batch(
        rconfig, ref.stack_pytrees([sc for sc, _ in rbuilt]),
        ref.stack_pytrees([ref.init_swarm(rconfig)] * len(grid)), T,
        record_every=EVERY)
    rjoins = jnp.stack([j for _, j in rbuilt])
    built = [sg.build_scenario(cp, k, watch_s=WATCH_S, stagger_s=60.0,
                               seed=0, device="cpu") for k in grid]
    final, series, tl = port.run_swarm_batch(
        cp, port.stack_pytrees([sc for sc, _ in built]),
        port.init_swarm(cp, device="cpu", batch=len(grid)), T,
        record_every=EVERY)
    joins = torch.stack([j for _, j in built])
    np.testing.assert_array_equal(joins.numpy(), np.asarray(rjoins))
    np.testing.assert_array_equal(final.fg_wait_ms.numpy(),
                                  np.asarray(rfinal.fg_wait_ms))
    np.testing.assert_allclose(series.numpy(), np.asarray(rseries),
                               atol=RUN_TOL)
    np.testing.assert_allclose(
        port.offload_ratio_batch(final).numpy(),
        np.asarray(ref.offload_ratio_batch(rfinal)), atol=RUN_TOL)
    np.testing.assert_allclose(
        port.rebuffer_ratio_batch(final, T * 0.25, joins).numpy(),
        np.asarray(ref.rebuffer_ratio_batch(rfinal, T * 0.25, rjoins)),
        atol=RUN_TOL)
    cols = port.timeline_columns(cp)
    assert cols == ref.timeline_columns(rconfig)
    exact = [i for i, c in enumerate(cols)
             if c in ("t_s", "stalled_peers") or c.startswith("level_")]
    np.testing.assert_array_equal(tl.numpy()[..., exact],
                                  np.asarray(rtl)[..., exact])
    assert bool((final.fg_wait_ms > 0).any())


# ---- inside the port ---------------------------------------------------------------

def test_chunked_live_rows_equal_the_direct_batch():
    """Five live lanes through ``run_batch_chunked`` at chunk 2 (chunks
    of 2, 2 and 1): rows equal to one direct batch's to the bit."""
    cp = sg.build_config(64, 16, True, 8)
    items = [sg.live_grid()[i] for i in (15, 43, 107, 136, 1)]
    n, every, watch = 40, 10, 10.0

    def build(knobs):
        return sg.build_scenario(cp, knobs, watch_s=watch, stagger_s=5.0,
                                 seed=0, device="cpu")
    stats = []
    groups = [(cp, items, build)]
    rows = [None] * len(items)
    for event in dp.stream_groups_chunked(groups, n, watch_s=watch,
                                          chunk=2, record_every=every,
                                          stats_out=stats):
        rows[event.index] = event.metric
    assert stats[0]["chunks"] == 3
    built = [build(k) for k in items]
    final, _series, tl = port.run_swarm_batch(
        cp, port.stack_pytrees([sc for sc, _ in built]),
        port.init_swarm(cp, device="cpu", batch=len(items)), n,
        record_every=every)
    offs = port.offload_ratio_batch(final)
    rebs = port.rebuffer_ratio_batch(final, watch,
                                     torch.stack([j for _, j in built]))
    for b, (off, reb, row_tl) in enumerate(rows):
        assert off == float(offs[b]) and reb == float(rebs[b])
        np.testing.assert_array_equal(row_tl, tl[b].numpy())


def test_vod_step_leaves_the_stagger_clock_alone():
    """A VOD step neither reads nor writes ``fg_wait_ms``: a state
    holding arbitrary clocks steps to the same state as one holding
    zeros, clocks aside, and keeps its clocks."""
    cp = sg.build_config(64, 16, False, 8)
    scen, _join = sg.build_scenario(cp, sg.vod_grid()[0], watch_s=10.0,
                                    stagger_s=5.0, seed=0, device="cpu")
    state = port.init_swarm(cp, device="cpu")
    for _ in range(20):
        state = port.swarm_step(cp, scen, state)
    clocks = torch.from_numpy(np.random.default_rng(0).uniform(
        0.0, 5e3, 64).astype(np.float32))
    a = port.clone_state(state)._replace(fg_wait_ms=clocks.clone())
    b = port.clone_state(state)
    flags, _req = sk.elig_select_plain(cp, scen, port.clone_state(a))
    assert not bool(((flags & 16) != 0).any())
    a = port.swarm_step(cp, scen, a)
    b = port.swarm_step(cp, scen, b)
    assert torch.equal(a.fg_wait_ms, clocks)
    assert bool((b.fg_wait_ms == 0).all())
    for name in port.SwarmState._fields:
        if name != "fg_wait_ms":
            for x, y in zip(port.tree_leaves(getattr(a, name)),
                            port.tree_leaves(getattr(b, name))):
                assert torch.equal(x, y), name


# ---- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("offsets", [None, (1, -1, 2, -2, 97, -97, 300,
                                            -300)])
def test_live_kernels_match_plain_on_the_card(cuda_device, offsets):
    """The four points as lanes at 4,096 peers, 60 plain steps in (the
    crowd joins at 12.5 s), stepped 40 times by the kernels (the fused
    route, or TK1 + TK2 for a wide offset tuple) beside the plain step:
    integer fields and the wait clock equal, floats within 1e-6."""
    Pc = 4096
    config = sg.build_config(Pc, S, True, 8)
    if offsets is not None:
        config = config._replace(neighbor_offsets=offsets)
    grid = [sg.live_grid()[i] for i in POINTS]
    scen = port.stack_pytrees(
        [sg.build_scenario(config, k, watch_s=WATCH_S, stagger_s=60.0,
                           seed=0, device=cuda_device)[0] for k in grid])
    state = port.init_swarm(config, device=cuda_device, batch=len(grid))
    for _ in range(STEP_AT - 10):
        state = sk.plain_step(config, scen, state)
    a, b = port.clone_state(state), port.clone_state(state)
    for _ in range(40):
        a = port.swarm_step(config, scen, a)
        b = sk.plain_step(config, scen, b)
    torch.cuda.synchronize()
    assert bool((b.fg_wait_ms > 0).any())
    for u, v in zip(port.tree_leaves(a), port.tree_leaves(b)):
        if u.is_floating_point() and not torch.equal(u, v):
            torch.testing.assert_close(u, v, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(u, v)
    assert torch.equal(a.fg_wait_ms, b.fg_wait_ms)
