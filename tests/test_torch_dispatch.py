"""Slice 3 of the PyTorch port, on the CPU: the chunked dispatch
(``ops/dispatch.py``), the chunk autotuner and the VOD grid builders
(``sweep_grid.py``), inside the port and against the JAX reference's
``ops/swarm_sim.py`` and ``tools/sweep.py``."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlsjs_p2p_wrapper_tpu.ops import swarm_sim as ref
from hlsjs_p2p_wrapper_tpu_torch import sweep_grid as sg
from hlsjs_p2p_wrapper_tpu_torch.engine.faults import FaultPolicy
from hlsjs_p2p_wrapper_tpu_torch.ops import dispatch as dp
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as port

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import sweep as ref_sweep  # noqa: E402

P, S, T, EVERY = 48, 16, 30, 10
WATCH_S = T * 0.25
JOIN = np.linspace(0.0, 5.0, P, dtype=np.float32)[::-1].copy()


def _group(n_items=7, degree=8):
    config = sg.build_config(P, S, False, degree)
    items = sg.vod_grid()[:n_items]

    def build(knobs):
        return sg.build_scenario(config, knobs, watch_s=WATCH_S,
                                 stagger_s=5.0, seed=0, join_s=JOIN,
                                 device="cpu")
    return config, items, build


def _direct(config, items, build, record_every=EVERY):
    """The rows of one batch of every item, as the dispatch computes
    them."""
    built = [build(k) for k in items]
    final, _series, tl = port.run_swarm_batch(
        config, port.stack_pytrees([sc for sc, _ in built]),
        port.init_swarm(config, device="cpu", batch=len(items)), T,
        record_every=record_every)
    offs = port.offload_ratio_batch(final)
    rebs = port.rebuffer_ratio_batch(final, WATCH_S,
                                     torch.stack([j for _, j in built]))
    return [(float(o), float(r), tl[b].numpy())
            for b, (o, r) in enumerate(zip(offs, rebs))]


def _rows_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[:2] == y[:2]
        np.testing.assert_array_equal(x[2], y[2])


# ---- chunking ------------------------------------------------------------------

def test_chunked_rows_equal_autotuned_and_direct_batch():
    """7 items in chunks of 3 (a tail of 1, not padded), autotuned
    (one chunk of 7) and as one direct batch: the same rows."""
    config, items, build = _group()
    want = _direct(config, items, build)
    for chunk in (3, None):
        rows = dp.run_batch_chunked(config, items, build, T,
                                    watch_s=WATCH_S, chunk=chunk,
                                    record_every=EVERY)
        _rows_equal(rows, want)
    assert any(r[1] > 0.0 for r in want)   # the scarce points stall


def test_chunked_pipeline_off_is_pure_reordering():
    config, items, build = _group()
    runs = [dp.run_batch_chunked(config, items, build, T, watch_s=WATCH_S,
                                 chunk=2, record_every=EVERY,
                                 pipeline=pipeline)
            for pipeline in (True, False)]
    _rows_equal(*runs)


def test_interleave_across_two_groups():
    """Two groups (ring degrees 8 and 4): chunks round-robin across the
    groups, and each group's rows equal the group run alone."""
    groups = [_group(5, 8), _group(4, 4)]
    results, stats = dp.run_groups_chunked(groups, T, watch_s=WATCH_S,
                                           chunk=2, record_every=EVERY)
    order = [ev.group for ev in dp.stream_groups_chunked(
        groups, T, watch_s=WATCH_S, chunk=2, pipeline=False)]
    assert order == [0, 0, 1, 1, 0, 0, 1, 1, 0]
    for (config, items, build), res, st in zip(groups, results, stats):
        _rows_equal(res, _direct(config, items, build))
        assert st["chunk"] == 2 and st["chunks"] == -(-len(items) // 2)
    seq, _ = dp.run_groups_chunked(groups, T, watch_s=WATCH_S, chunk=2,
                                   record_every=EVERY, interleave=False)
    for a, b in zip(results, seq):
        _rows_equal(a, b)


def test_stream_stats_and_rows_without_timeline():
    config, items, build = _group(3)
    stats = []
    events = list(dp.stream_groups_chunked(
        [(config, items, build)], T, watch_s=WATCH_S, chunk=5,
        exact_chunk=True, stats_out=stats))
    assert sorted(ev.index for ev in events) == [0, 1, 2]
    assert all(len(ev.metric) == 2 and ev.key is None for ev in events)
    assert stats == [{"items": 3, "chunk": 5, "chunks": 1, "row_hits": 0,
                      "first_dispatch_s": stats[0]["first_dispatch_s"],
                      "failures": []}]
    assert dp.run_batch_chunked(config, [], build, T, watch_s=WATCH_S) == []


@pytest.mark.parametrize("option,item", [
    ("faults", None), ("trace", "item 8"), ("tracer", "item 8")])
def test_unported_dispatch_options_raise(option, item):
    """The options the port does not take yet raise, naming their
    ROADMAP item.  ``faults`` is ported (item 6): a ``FaultPolicy``
    without a plan returns the unarmed rows and counts nothing.
    ``warm_start`` and ``journal`` are ported (item 7;
    tests/test_torch_artifact_cache.py)."""
    config, items, build = _group(2)
    if item is None:
        policy = FaultPolicy()
        rows = dp.run_batch_chunked(config, items, build, T,
                                    watch_s=WATCH_S, chunk=1,
                                    record_every=EVERY, **{option: policy})
        _rows_equal(rows, dp.run_batch_chunked(
            config, items, build, T, watch_s=WATCH_S, chunk=1,
            record_every=EVERY))
        assert policy.fault_counts() == {}
        return
    with pytest.raises(NotImplementedError, match=item):
        dp.stream_groups_chunked([(config, items, build)], T,
                                 watch_s=WATCH_S, **{option: object()})
    with pytest.raises(NotImplementedError, match=item):
        dp.run_batch_chunked(config, items, build, T, watch_s=WATCH_S,
                             **{option: object()})


# ---- lane bytes and the autotuner ------------------------------------------

@pytest.mark.parametrize("peers,segments,record_every,digest", [
    (1_048_576, 128, 40, False), (256, 64, 0, False), (96, 45, 10, True)])
def test_batch_lane_bytes_match_reference(peers, segments, record_every,
                                          digest):
    config = sg.build_config(peers, segments, False, 8)._replace(
        stall_digest=digest)
    n_steps = 960
    got = port.batch_lane_bytes(config, n_steps, record_every=record_every)
    want = ref.batch_lane_bytes(ref.SwarmConfig(*config), n_steps,
                                record_every=record_every)
    assert got == want


def test_batch_lane_bytes_with_a_scenario_match_reference():
    config = sg.build_config(P, S, False, 8)
    knobs = sg.vod_grid()[0]
    scen, _ = sg.build_scenario(config, knobs, watch_s=WATCH_S,
                                stagger_s=5.0, seed=0, device="cpu")
    rconfig = ref.SwarmConfig(*config)
    rscen, _ = ref_sweep.build_scenario(rconfig, knobs, watch_s=WATCH_S,
                                        stagger_s=5.0, seed=0)
    assert (port.batch_lane_bytes(config, T, record_every=EVERY,
                                  scenario=scen)
            == ref.batch_lane_bytes(rconfig, T, record_every=EVERY,
                                    scenario=rscen))


def test_autotune_chunk_clamps_on_the_cpu(monkeypatch):
    # the reference shrinks its memory fraction after OOM bisections
    # that other tests of this process provoke; the port has no OOM
    # feedback yet, so compare at the reference's base fraction
    monkeypatch.setattr(ref, "_OOM_BISECTIONS", 0)
    small = sg.build_config(64, 16, False, 8)
    huge = sg.build_config(1 << 26, 4096, False, 8)
    mid = sg.build_config(1_048_576, 128, False, 8)
    assert port.autotune_chunk(small, 0, T, device="cpu") == 1
    assert port.autotune_chunk(huge, 10, 960, device="cpu") == 1
    assert port.autotune_chunk(small, 5, T, device="cpu") == 5
    assert port.autotune_chunk(small, 1000, T,
                               device="cpu") == port.MAX_AUTOTUNE_CHUNK == 64
    lane = port.batch_lane_bytes(mid, 960, record_every=40)
    fit = int(port.AUTOTUNE_FALLBACK_BYTES * port.AUTOTUNE_MEMORY_FRACTION
              // lane)
    assert port.AUTOTUNE_FALLBACK_BYTES == 4 << 30
    assert port.autotune_chunk(mid, 48, 960, record_every=40,
                               device="cpu") == fit
    for config, n in ((small, 1000), (huge, 10), (mid, 48)):
        assert (port.autotune_chunk(config, n, 960, record_every=40,
                                    device="cpu")
                == ref.autotune_chunk(ref.SwarmConfig(*config), n, 960,
                                      record_every=40))


# ---- the VOD grid -------------------------------------------------------------

def test_vod_grid_and_builders_match_the_sweep_tool():
    assert sg.vod_grid() == ref_sweep.vod_grid()
    assert len(sg.vod_grid()) == 48
    for n in (1, 4, 7, 48, 60):
        assert (sg.sample_grid(sg.vod_grid(), n)
                == ref_sweep.sample_grid(ref_sweep.vod_grid(), n))
    assert sg.LADDERS == ref_sweep.LADDERS
    assert sg.N_LEVELS == ref_sweep.N_LEVELS
    for name in sg.LADDERS:
        np.testing.assert_array_equal(
            np.asarray(sg.padded_ladder(name), np.float32),
            np.asarray(ref_sweep.padded_ladder(name)))
    for args in ((1_048_576, 128, False, 8), (256, 64, True, 4, 6.0)):
        assert tuple(sg.build_config(*args)) == tuple(
            ref_sweep.build_config(*args))


def test_build_scenario_matches_the_sweep_tool(monkeypatch):
    """Given the reference's joins and ranks, every scenario array of
    each VOD point is the reference's."""
    config = sg.build_config(P, S, False, 8)
    rconfig = ref.SwarmConfig(*config)
    ranks = np.array(ref.stable_ranks(P, 3))
    monkeypatch.setattr(sg, "_ARRAY_CACHE", {})
    monkeypatch.setattr(sg, "stable_ranks",
                        lambda n, seed, device=None: torch.from_numpy(ranks))
    for knobs in sg.sample_grid(sg.vod_grid(), 6):
        rscen, rjoin = ref_sweep.build_scenario(
            rconfig, knobs, watch_s=WATCH_S, stagger_s=12.0, seed=3)
        scen, join = sg.build_scenario(
            config, knobs, watch_s=WATCH_S, stagger_s=12.0, seed=3,
            join_s=np.asarray(rjoin), device="cpu")
        np.testing.assert_array_equal(join.numpy(), np.asarray(rjoin))
        for name in port.SwarmScenario._fields:
            got, want = getattr(scen, name).numpy(), np.asarray(
                getattr(rscen, name))
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=name)


def test_build_scenario_without_joins_is_the_sweep_tools():
    """Drawing its own joins and ranks (the reference's threefry draws),
    the port builds every scenario array of each VOD point, and the
    joins, as ``tools/sweep.py`` does at the same seed: to the bit."""
    config = sg.build_config(P, S, False, 8)
    rconfig = ref.SwarmConfig(*config)
    for knobs in sg.sample_grid(sg.vod_grid(), 6):
        rscen, rjoin = ref_sweep.build_scenario(
            rconfig, knobs, watch_s=WATCH_S, stagger_s=12.0, seed=3)
        scen, join = sg.build_scenario(
            config, knobs, watch_s=WATCH_S, stagger_s=12.0, seed=3,
            device="cpu")
        np.testing.assert_array_equal(join.numpy(), np.asarray(rjoin))
        for name in port.SwarmScenario._fields:
            got, want = getattr(scen, name).numpy(), np.asarray(
                getattr(rscen, name))
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=name)


def test_build_scenario_draws_its_joins_once():
    config = sg.build_config(P, S, False, 8)
    a, ja = sg.build_scenario(config, sg.vod_grid()[0], watch_s=WATCH_S,
                              stagger_s=7.0, seed=1, device="cpu")
    b, jb = sg.build_scenario(config, sg.vod_grid()[5], watch_s=WATCH_S,
                              stagger_s=7.0, seed=1, device="cpu")
    assert torch.equal(ja, jb)
    np.testing.assert_allclose(np.sort(ja.numpy()),
                               np.linspace(0.0, 7.0, P), rtol=1e-6)
    assert torch.equal(a.edge_rank, b.edge_rank)
    assert float(a.edge_rank.min()) >= 0.0 and float(
        a.edge_rank.max()) < 1.0


@pytest.mark.parametrize("live,population,item", [
    (True, "sessions_inherit_joins", "session departures"),
    (False, "sessions_inherit_joins", "session departures")])
def test_build_scenario_outside_vod_raises(live, population, item):
    """Population overlays are ported on both grids (once refused); what
    still raises is the reference's own refusal: a spec whose cohorts
    have sessions but inherit the grid's joins."""
    from hlsjs_p2p_wrapper_tpu_torch.engine.population import (
        Cohort, PopulationSpec)
    assert population == "sessions_inherit_joins"
    spec = PopulationSpec(cohorts=(Cohort("all", 1.0,
                                          session_mean_s=60.0),))
    config = sg.build_config(P, S, live, 8, n_cohorts=1)
    knobs = (sg.live_grid() if live else sg.vod_grid())[0]
    with pytest.raises(ValueError, match=item):
        sg.build_scenario(config, knobs, watch_s=WATCH_S, stagger_s=5.0,
                          seed=0, population=spec, device="cpu")


def test_ratio_batch_defaults_match_reference():
    """``rebuffer_ratio_batch`` without joins or leaves, and with a
    ``[B, P]`` leave array, against the reference's."""
    config = sg.build_config(P, S, False, 8)
    rng = np.random.default_rng(5)
    reb = rng.random((3, P), dtype=np.float32)
    leave = rng.uniform(0.0, 10.0, (3, P)).astype(np.float32)
    states = port.init_swarm(config, device="cpu", batch=3)._replace(
        rebuffer_s=torch.from_numpy(reb))
    rstates = ref.stack_pytrees([ref.init_swarm(ref.SwarmConfig(*config))]
                                * 3)._replace(rebuffer_s=jnp.asarray(reb))
    for kw in ({}, {"join_s": np.stack([JOIN] * 3), "leave_s": leave}):
        np.testing.assert_allclose(
            port.rebuffer_ratio_batch(states, 7.5, **kw).numpy(),
            np.asarray(ref.rebuffer_ratio_batch(rstates, 7.5, **kw)),
            rtol=1e-6)
