"""The population plane of the PyTorch port on the CPU, against the JAX
reference: ``engine/population.py`` (its materializations, mix
re-weights, scenario keyword arguments and digests to the byte, its
telemetry), the sweep's population overlay and mixture axis
(``sweep_grid``), and the per-cohort timeline columns (plain TK5); then
the step with the example population's fields (``p2p_ok``,
``abr_cap_level``, ``urgent_margin_off_s``, ``cohort_id``, per-peer rates
from distributions, joins and session leaves): one step bit-identical and
whole runs within their tolerances on the ring (VOD, live, three slots
under each holder policy) and on the random mesh; the degenerate
population equal to the homogeneous path to the bit; the mixture grid
through the chunked dispatch; and the committed population fixture.  On
the card (marker ``gpu``): TK5's cohort instantiation against its plain
version.

The runs are 256 peers × 64 segments × 280 steps (70 s): the example
spec's cellular cohort arrives in one wave at 60 s, so its peers are
present, gated, capped and urgent early for the last 8 s."""

import functools
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlsjs_p2p_wrapper_tpu.engine import population as ref_pop
from hlsjs_p2p_wrapper_tpu.ops import swarm_sim as ref
from hlsjs_p2p_wrapper_tpu_torch import policy_grid as pg
from hlsjs_p2p_wrapper_tpu_torch import sweep_grid as sg
from hlsjs_p2p_wrapper_tpu_torch.engine import population as pop
from hlsjs_p2p_wrapper_tpu_torch.engine.telemetry import MetricsRegistry
from hlsjs_p2p_wrapper_tpu_torch.ops import dispatch as dp
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_kernels as sk
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as port
from hlsjs_p2p_wrapper_tpu_torch.testing import (EXAMPLE_SPEC,
                                                 REFERENCE_POPULATION,
                                                 population_binding,
                                                 population_lanes,
                                                 run_population_fixture)
from hlsjs_p2p_wrapper_tpu_torch.testing.convert import (
    scenario_from_numpy, state_from_numpy, state_to_numpy)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import population_gate  # noqa: E402
import sweep as ref_sweep  # noqa: E402
import torch_port_fixture  # noqa: E402

P, S, T, EVERY = 256, 64, 280, 20
WATCH_S = T * 0.25
STAGGER_S, SEED = 20.0, 0
HD = (300_000.0, 800_000.0, 2_000_000.0)
#: the mix fractions of the lanes built from the spec directly (four
#: lanes, as the policy and general tests' programs take)
MIXES = (0.0, 0.25, 0.5, 0.75)
#: the supply defaults of those lanes: tools/policy_ab.py's CDN rate
LANE_CDN_BPS, LANE_UPLINK_BPS = 8e6, 2.4e6
#: the step at which the card's cohort row is checked (t = 65 s)
MID = 260
#: final offload and rebuffer and the offload series, port vs reference
#: (tests/test_torch_swarm_sim.py RUN_TOL)
RUN_TOL = 1e-4
#: the timeline's cohort offloads, port vs reference: the same masked sums
#: in another order
COHORT_OFFLOAD_TOL = 1e-6
#: EWMA and other float state fields, as tests/test_torch_general.py
FLOAT_RTOL = 1e-6
EXACT_FIELDS = ("level", "avail", "dl_flags", "dl_seg", "dl_level",
                "dl_holder_off", "dl_attempts", "t_s", "holder_penalty_ms")


def _example():
    return ref_pop.load_spec(EXAMPLE_SPEC)


def _port_spec(rspec):
    return pop.PopulationSpec.from_json(json.loads(json.dumps(
        rspec.to_json())))


# ---- engine/population.py ---------------------------------------------------

#: the specs the materializations are compared on: the example, a mix
#: re-weight of it, the population gate's specs
SPECS = {
    "example": _example,
    "example_mix_0.25": lambda: _example().with_mix(0.25),
    "example_mix_1.0": lambda: _example().with_mix(1.0),
    "gate_mixture": population_gate.mixture_spec,
    "gate_homogeneous_mean": population_gate.homogeneous_mean_spec,
    "gate_crowd_partition": population_gate.crowd_partition_spec,
    "gate_degenerate": population_gate.degenerate_spec,
}


@pytest.mark.parametrize("name", list(SPECS))
def test_materialize_equals_the_reference_to_the_byte(name):
    """The port's spec round-trips the reference's JSON, and its
    materialization, scenario keyword arguments, digest and fault specs
    equal the reference's to the byte, at two sizes and ladders."""
    rspec = SPECS[name]()
    spec = _port_spec(rspec)
    assert spec.to_json() == rspec.to_json()
    assert spec.cohort_names == rspec.cohort_names
    if rspec.mix_cohort is not None:
        assert (spec.with_mix(0.5).to_json()
                == rspec.with_mix(0.5).to_json())
    for n, kw in ((1000, dict(n_levels=3, default_uplink_bps=2.4e6,
                              default_cdn_bps=1.2e6)),
                  (4099, dict(n_levels=5))):
        got, want = pop.materialize(spec, n, **kw), ref_pop.materialize(
            rspec, n, **kw)
        assert pop.population_digest(got) == ref_pop.population_digest(want)
        assert got.cohort_names == want.cohort_names
        assert got.cohort_counts() == want.cohort_counts()
        for field, g, w in zip(got._fields[1:], got[1:], want[1:]):
            assert (g is None) == (w is None), field
            if w is not None:
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), \
                    field
        gk, wk = pop.to_scenario_kwargs(got), ref_pop.to_scenario_kwargs(
            want)
        assert sorted(gk) == sorted(wk)
        for key in wk:
            assert gk[key].tobytes() == wk[key].tobytes(), key
    assert pop.fault_specs_from(spec) == ref_pop.fault_specs_from(rspec)
    assert pop.cohort_counts([0.6, 0.4, 0.0], 1001) == \
        ref_pop.cohort_counts([0.6, 0.4, 0.0], 1001)


def test_materialize_trace_and_constants_equal_the_reference():
    """The trace-driven variant on an event log (repeats, a cohort label,
    a connectivity class, caps above the ladder and uncapped, rates some
    peers omit), and the shared constants."""
    records = [
        {"peer": "a", "join_s": 0.0, "uplink_bps": 1e6},
        {"peer": "b", "join_s": 1.5, "cohort": "cell",
         "connectivity": "cdn_only", "abr_cap": 1,
         "urgent_margin_off_s": 2.0},
        {"peer": "a", "leave_s": 30.0},
        {"peer": "c", "join_s": 2.0, "abr_cap": 9, "cdn_bps": 2e6},
        {"join_s": 3.0, "abr_cap": -1},
    ]
    for kw in ({}, dict(n_levels=3, default_uplink_bps=5e5,
                        default_cdn_bps=7e5)):
        got = pop.materialize_trace(records, **kw)
        want = ref_pop.materialize_trace(records, **kw)
        assert pop.population_digest(got) == ref_pop.population_digest(want)
    assert pop.NEVER_S == port.NEVER_S == ref_pop.NEVER_S == ref.NEVER_S
    assert pop.UNCAPPED == ref_pop.UNCAPPED
    assert pop.CONNECTIVITY_CLASSES == ref_pop.CONNECTIVITY_CLASSES


def test_materialization_telemetry():
    """A materialization bumps ``population.materializations{source}`` and
    sets one ``population.cohort_peers{cohort}`` gauge a cohort, as the
    reference's; a gauge is not a counter."""
    reg = MetricsRegistry()
    spec = _port_spec(_example())
    p = pop.materialize(spec.with_mix(0.25), 1000, n_levels=3, registry=reg)
    pop.materialize(spec, 1000, n_levels=3, registry=reg)
    pop.materialize_trace([{"peer": 1, "join_s": 0.0}], registry=reg)
    assert dict((lb["source"], v) for lb, v in reg.series(
        "population.materializations")) == {"parametric": 2, "trace": 1}
    gauges = {lb["cohort"]: v
              for lb, v in reg.series("population.cohort_peers")}
    assert gauges == {"broadband": 600, "cellular": 400, "trace": 1}
    assert p.cohort_counts() == {"broadband": 750, "cellular": 250}
    g = reg.gauge("population.cohort_peers", cohort="broadband")
    g.inc(5)
    g.dec(2)
    assert g.value == 603 and g.kind == "gauge"
    with pytest.raises(ValueError, match="gauge"):
        reg.counter("population.cohort_peers", cohort="broadband")


# ---- the sweep overlay -------------------------------------------------------

@pytest.mark.parametrize("live", [False, True])
def test_overlay_and_mixture_axis_are_the_sweep_tools(live):
    """``population_grid`` is ``tools/sweep.py``'s, and every scenario
    array of sampled mixture points, with the joins, is the reference's
    overlay to the bit (rates from distributions, the population's joins
    and leaves in place of the grid's, the four population fields)."""
    rspec = _example()
    spec = _port_spec(rspec)
    base = sg.live_grid() if live else sg.vod_grid()
    grid = sg.population_grid(base, spec)
    assert grid == ref_sweep.population_grid(base, rspec)
    assert len(grid) == 3 * len(base)
    assert sg.population_grid(base, pop.PopulationSpec(
        cohorts=(pop.Cohort("all", 1.0),))) == base
    config = sg.build_config(P, S, live, 8, n_cohorts=2)
    rconfig = ref.SwarmConfig(*config)
    for knobs in sg.sample_grid(grid, 5):
        rscen, rjoin = ref_sweep.build_scenario(
            rconfig, knobs, watch_s=WATCH_S, stagger_s=STAGGER_S, seed=SEED,
            population=rspec)
        scen, join = sg.build_scenario(
            config, knobs, watch_s=WATCH_S, stagger_s=STAGGER_S, seed=SEED,
            population=spec, device="cpu")
        np.testing.assert_array_equal(join.numpy(), np.asarray(rjoin))
        for name in port.SwarmScenario._fields:
            got = getattr(scen, name).numpy()
            want = np.asarray(getattr(rscen, name)).astype(got.dtype)
            np.testing.assert_array_equal(got, want, err_msg=name)


# ---- the step and whole runs -------------------------------------------------

def _bitrates(config):
    return HD if config.n_levels == len(HD) else (pg.BITRATE,)


def _ref_lanes(rconfig, nbr):
    """The reference's lanes of :func:`population_lanes`: the example
    spec at each of MIXES."""
    rspec = _example()
    built = []
    for mix in MIXES:
        kw = ref_pop.to_scenario_kwargs(ref_pop.materialize(
            rspec.with_mix(mix), P, n_levels=rconfig.n_levels,
            default_uplink_bps=LANE_UPLINK_BPS,
            default_cdn_bps=LANE_CDN_BPS))
        cdn = kw.pop("cdn_bps", np.full((P,), LANE_CDN_BPS, np.float32))
        built.append(ref.make_scenario(
            rconfig, jnp.asarray(_bitrates(rconfig)), nbr, jnp.asarray(cdn),
            kw.pop("join_s"), **kw))
    return built


def _ref_sweep_lanes(rconfig, live):
    """The reference's sweep lanes: the population fixture's VOD points,
    or two live mixture points."""
    rspec = _example()
    if live:
        points = (torch_port_fixture.POPULATION_LIVE_POINT, 3 * 136 + 1)
        grid = ref_sweep.population_grid(ref_sweep.live_grid(), rspec)
    else:
        points = torch_port_fixture.POPULATION_VOD_POINTS
        grid = ref_sweep.population_grid(ref_sweep.vod_grid(), rspec)
    return [ref_sweep.build_scenario(rconfig, grid[i], watch_s=WATCH_S,
                                     stagger_s=STAGGER_S, seed=SEED,
                                     population=rspec)[0] for i in points]


#: run cases: name -> (policy, slots, live, topology).  "vod" and "live"
#: are the sweep's lanes (its config, three and two mixture points), the
#: rest the example spec at MIXES with tools/policy_ab.py's configs, the
#: ring of 8 or the random mesh, whose step programs other port tests
#: compile for the same shapes (one level, four lanes)
CASES = {
    "vod": ("spread", 1, False, "ring"),
    "live": ("spread", 1, True, "ring"),
    "ring-spread-C3": ("spread", 3, False, "ring"),
    "ring-adaptive-C3": ("adaptive", 3, False, "ring"),
    "ring-ranked-C3": ("ranked", 3, False, "ring"),
    "random-adaptive-C3": ("adaptive", 3, False, "random"),
}
#: the one-step cases: the step they start from, and the population
#: fields that bind in it (``population_binding``; the live lanes' ladder
#: and the one-level ladder are never capped, and urgency by the offset
#: binds at a few steps only)
STEP_CASES = {
    "vod": (260, ("gate_requesters", "gate_holders", "abr_capped",
                  "departed")),
    "live": (248, ("gate_requesters", "gate_holders", "urgent_by_offset")),
    "random-adaptive-C3": (260, ("gate_requesters", "gate_holders",
                                 "departed")),
}


def _config(name):
    """The port's config of case ``name`` (two cohorts), and the
    reference's neighbour list (None on the ring)."""
    policy, _slots, live, topology = CASES[name]
    if name in ("vod", "live"):
        return sg.build_config(P, S, live, 8, n_cohorts=2), None
    if topology == "random":
        return (pg.random_config(P, S, policy)._replace(n_cohorts=2),
                ref.random_neighbors(P, 8, SEED))
    return pg.ring_config(P, S, policy)._replace(n_cohorts=2), None


def _tree_np(tree):
    out = {}
    for k, v in tree._asdict().items():
        out[k] = ({f: np.array(x) for f, x in v._asdict().items()}
                  if hasattr(v, "_asdict") else np.array(v))
    return out


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's whole run of case ``name``, as numpy, and the
    inputs it ran on: one-step calls of ``run_swarm_batch`` (its config
    without the cohort count, which only the timeline reads), so that the
    one-step case and the whole run share one compiled program, and the
    timeline's rows from its ``_timeline_row`` on the states at the
    record steps (with the cohort count), as its scan takes them."""
    import jax

    config, nbr = _config(name)
    rconfig = ref.SwarmConfig(*config)
    rstep = ref.SwarmConfig(*config._replace(n_cohorts=0))
    if name in ("vod", "live"):
        scens = _ref_sweep_lanes(rconfig, name == "live")
    else:
        scens = _ref_lanes(rconfig, nbr)
    B = len(scens)
    stacked = ref.stack_pytrees(scens)
    n_nbr = None if nbr is None else nbr.shape[1]
    state = ref.stack_pytrees([ref.init_swarm(rstep, n_nbr)] * B)
    row = jax.jit(jax.vmap(lambda sc, st, c, p, pc, pp, pr: ref._timeline_row(
        rconfig, sc, st, c, p, pc, pp, pr, EVERY)))

    def sums(st):
        return jnp.sum(st.cdn_bytes, axis=-1), jnp.sum(st.p2p_bytes, axis=-1)

    prev = sums(state) + (state.rebuffer_s,)
    start = STEP_CASES.get(name, (None,))[0]
    series, rows, mid, stepped = [], [], None, None
    for s in range(T):
        if s == start:
            mid = _tree_np(state)
        state, column = ref.run_swarm_batch(rstep, stacked, state, 1)
        series.append(np.array(column))
        if s == start:
            stepped = _tree_np(state)
        if (s + 1) % EVERY == 0:
            now = sums(state)
            rows.append(np.asarray(row(stacked, state, *now, *prev)))
            prev = now + (state.rebuffer_s,)
    return {"config": config, "n_nbr": n_nbr, "B": B,
            "scenario": _tree_np(stacked), "final": _tree_np(state),
            "mid": mid, "stepped": stepped,
            "series": np.concatenate(series, axis=1),
            "timeline": np.stack(rows, axis=1),
            "columns": ref.timeline_columns(rconfig),
            "offload": np.asarray(ref.offload_ratio_batch(state)),
            "rebuffer": np.asarray(ref.rebuffer_ratio_batch(
                state, WATCH_S, stacked.join_s, stacked.leave_s))}


def _assert_state_close(got, want):
    """Integer, index and packed fields, the clock and the penalty window
    equal; float fields within FLOAT_RTOL."""
    for k, v in want.items():
        if k == "ewma":
            for f in v:
                np.testing.assert_allclose(got[k][f], v[f], rtol=FLOAT_RTOL,
                                           err_msg=f"ewma.{f}")
        elif k in EXACT_FIELDS:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=FLOAT_RTOL,
                                       err_msg=k)


def _assert_timelines(got, want, columns):
    """Counts (the clock, stalls, level and cohort counts) equal; the
    cohort offloads within COHORT_OFFLOAD_TOL; the rest within RUN_TOL
    (the rates relative)."""
    assert tuple(columns[-6:]) == ("cohort_0_peers", "cohort_0_stalled",
                                   "cohort_0_offload", "cohort_1_peers",
                                   "cohort_1_stalled", "cohort_1_offload")
    for i, col in enumerate(columns):
        g, w = got[..., i], want[..., i]
        if col.endswith("_offload") and col.startswith("cohort_"):
            np.testing.assert_allclose(g, w, atol=COHORT_OFFLOAD_TOL,
                                       err_msg=col)
        elif col.endswith("_rate_bps"):
            np.testing.assert_allclose(g, w, rtol=RUN_TOL, err_msg=col)
        elif col in ("offload", "rebuffer"):
            np.testing.assert_allclose(g, w, atol=RUN_TOL, err_msg=col)
        else:
            np.testing.assert_array_equal(g, w, err_msg=col)


@pytest.mark.parametrize("name", list(CASES))
def test_whole_run_matches_the_reference(name):
    """A whole run with the example population: offload, rebuffer (over
    joins and session leaves) and the series within RUN_TOL, and the
    timeline with its cohort columns; the cdn_only cohort moves no P2P
    byte and its offload column is 0; every row's cohort peers sum to its
    level counts."""
    r = _reference(name)
    config = r["config"]
    scen = scenario_from_numpy(r["scenario"], "cpu")
    final, series, tl = port.run_swarm_batch(
        config, scen, port.init_swarm(config, r["n_nbr"], device="cpu",
                                      batch=r["B"]), T, record_every=EVERY)
    _assert_state_close(state_to_numpy(final), r["final"])
    np.testing.assert_allclose(series.numpy(), r["series"], atol=RUN_TOL)
    np.testing.assert_allclose(port.offload_ratio_batch(final).numpy(),
                               r["offload"], atol=RUN_TOL)
    np.testing.assert_allclose(
        port.rebuffer_ratio_batch(final, WATCH_S, scen.join_s,
                                  scen.leave_s).numpy(),
        r["rebuffer"], atol=RUN_TOL)
    cols = port.timeline_columns(config)
    assert cols == r["columns"] and tl.shape[-1] == len(cols)
    _assert_timelines(tl.numpy(), r["timeline"], cols)
    cell = scen.cohort_id == 1
    assert bool((scen.p2p_ok[cell] == 0.0).all())
    assert float(final.p2p_bytes[cell].sum()) == 0.0
    assert bool((tl[..., cols.index("cohort_1_offload")] == 0.0).all())
    levels = [cols.index(f"level_{i}_peers") for i in range(config.n_levels)]
    assert torch.equal(tl[..., -6] + tl[..., -3], tl[..., levels].sum(-1))
    assert float(tl[..., -3].max()) > 0.0   # the cellular wave is in
    if name == "vod":
        # the cap binds per peer: on the ample HD point's lane, present
        # cellular peers end at level 1 (their cap), broadband ones at
        # the top rung
        b = torch_port_fixture.POPULATION_VOD_POINTS.index(142)
        t = final.t_s[b]
        present = (scen.join_s[b] <= t) & (t < scen.leave_s[b])
        lane_cell = cell[b]
        assert bool((scen.abr_cap_level[b][lane_cell] == 1).all())
        assert int(final.level[b][present & lane_cell].max()) == 1
        assert int(final.level[b][present & ~lane_cell].max()) == 2


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_one_step_matches_the_reference(name):
    """One step from the port's state at the case's step (t = 62-65 s,
    the cellular wave in): integer, index and packed fields, the clock
    and the penalty window bit-identical, floats within FLOAT_RTOL; the
    population fields the case names bind in that step (gated requesters
    and holders, capped picks, urgency by the offset, departed peers)."""
    r = _reference(name)
    config = r["config"]
    _start, binding = STEP_CASES[name]
    scen = scenario_from_numpy(r["scenario"], "cpu")
    mid = state_from_numpy(r["mid"], "cpu")
    binds = population_binding(config, scen, mid)
    assert all(binds[k] > 0 for k in binding), binds
    got = state_to_numpy(port.swarm_step(config, scen, mid))
    _assert_state_close(got, r["stepped"])


# ---- degenerate populations, the mixture grid, the fixture ------------------

DEGENERATE_STEPS = 60


@pytest.mark.parametrize("live", [False, True])
def test_degenerate_population_is_the_homogeneous_path(live):
    """One cohort, everything inherited (the population gate's promise 1):
    at sampled points of the VOD and the live grid, every scenario array,
    the final state, the series and the timeline's shared columns equal
    the homogeneous run's to the bit, and the one cohort's columns are the
    whole audience's."""
    spec = _port_spec(population_gate.degenerate_spec())
    base = sg.sample_grid(sg.live_grid() if live else sg.vod_grid(), 4)
    hom = sg.build_config(P, S, live, 8)
    deg = hom._replace(n_cohorts=1)
    runs = []
    for config, population in ((hom, None), (deg, spec)):
        built = [sg.build_scenario(config, k, watch_s=WATCH_S,
                                   stagger_s=STAGGER_S, seed=SEED,
                                   population=population, device="cpu")
                 for k in sg.population_grid(base, spec)]
        runs.append(([sc for sc, _ in built],) + port.run_swarm_batch(
            config, port.stack_pytrees([sc for sc, _ in built]),
            port.init_swarm(config, device="cpu", batch=len(base)),
            DEGENERATE_STEPS, record_every=EVERY))
    (sa, fa, sera, tla), (sb, fb, serb, tlb) = runs
    for x, y in zip(sa, sb):
        for u, v in zip(x, y):
            assert torch.equal(u, v)
    for u, v in zip(port.tree_leaves(fa), port.tree_leaves(fb)):
        assert torch.equal(u, v)
    assert torch.equal(sera, serb)
    n = tla.shape[-1]
    assert torch.equal(tla, tlb[..., :n])
    cols = port.timeline_columns(deg)
    assert cols[n:] == ("cohort_0_peers", "cohort_0_stalled",
                        "cohort_0_offload")
    levels = [cols.index(f"level_{i}_peers") for i in range(deg.n_levels)]
    assert torch.equal(tlb[..., n], tlb[..., levels].sum(-1))
    assert torch.equal(tlb[..., n + 1], tlb[..., cols.index("stalled_peers")])
    assert torch.equal(tlb[..., n + 2], tlb[..., cols.index("offload")])


MIX_PEERS, MIX_STEPS, MIX_EVERY = 64, 20, 10


def test_mixture_grid_through_the_dispatch():
    """The 144-point mixture grid through ``run_batch_chunked`` at a small
    size: one group, rows with the column count ``timeline_columns``
    gives, the same bits in chunks of 7 and of the autotuned size, and
    lanes alone equal to their batched rows."""
    rspec = _example()
    spec = _port_spec(rspec)
    grid = sg.population_grid(sg.vod_grid(), spec)
    assert len(grid) == 144
    config = sg.build_config(MIX_PEERS, 16, False, 8,
                             n_cohorts=len(spec.cohorts))
    watch_s = MIX_STEPS * config.dt_ms / 1000.0

    def build(knobs):
        return sg.build_scenario(config, knobs, watch_s=watch_s,
                                 stagger_s=STAGGER_S, seed=SEED,
                                 population=spec, device="cpu")

    stats = []
    rows = list(dp.stream_groups_chunked(
        [(config, grid, build)], MIX_STEPS, watch_s=watch_s,
        record_every=MIX_EVERY, stats_out=stats))
    assert len(stats) == 1 and len(rows) == 144
    rows = sorted(rows, key=lambda e: e.index)
    M = len(port.timeline_columns(config))
    assert all(e.metric[2].shape == (MIX_STEPS // MIX_EVERY, M)
               for e in rows)
    chunked = dp.run_batch_chunked(config, grid, build, MIX_STEPS,
                                   watch_s=watch_s, chunk=7,
                                   record_every=MIX_EVERY)
    for e, c in zip(rows, chunked):
        assert e.metric[:2] == c[:2]
        np.testing.assert_array_equal(e.metric[2], c[2])
    for i in (2, 71, 142):
        alone = dp.run_batch_chunked(config, [grid[i]], build, MIX_STEPS,
                                     watch_s=watch_s, chunk=1,
                                     record_every=MIX_EVERY)[0]
        assert alone[:2] == chunked[i][:2]
        np.testing.assert_array_equal(alone[2], chunked[i][2])
    mixes = {g["population_mix"] for g in grid}
    assert mixes == set(rspec.mix_fractions)


def test_port_matches_the_population_fixture_on_cpu():
    """The committed reference run of the example population (three VOD
    mixture points and a live one): offload, rebuffer and the series
    within RUN_TOL, the timeline as the whole runs hold it, the final P2P
    bytes of the cdn_only cohort 0."""
    d = np.load(REFERENCE_POPULATION)
    runs = run_population_fixture(d, "cpu")
    for key, (offload, rebuffer, series, tl, p2p) in runs.items():
        np.testing.assert_allclose(offload.numpy(), d[f"{key}_offload"],
                                   atol=RUN_TOL)
        np.testing.assert_allclose(rebuffer.numpy(), d[f"{key}_rebuffer"],
                                   atol=RUN_TOL)
        np.testing.assert_allclose(series.numpy(), d[f"{key}_series"],
                                   atol=RUN_TOL)
        _assert_timelines(tl.numpy(), d[f"{key}_timeline"],
                          tuple(str(c) for c in d[f"{key}_columns"]))
        np.testing.assert_allclose(p2p.numpy(), d[f"{key}_p2p_bytes"],
                                   rtol=1e-5, atol=1.0)


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (TK5's cohort instantiation is a "
                    "CUDA kernel with no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_timeline_row_cohorts_matches_plain_on_the_card(cuda_device):
    """TK5's cohort instantiation against its plain version on the
    ring-spread lanes' state at step MID: counts equal, the cohort
    offloads and sums within 1e-5 relative, each lane alone the same bits
    as batched."""
    config, _nbr = _config("ring-spread-C3")
    scen, _joins = population_lanes(
        config, _port_spec(_example()), MIXES, _bitrates(config),
        cdn_bps=LANE_CDN_BPS,
        uplink_bps=LANE_UPLINK_BPS, device=cuda_device)
    state, _s = port.run_swarm_batch(
        config, scen, port.init_swarm(config, device=cuda_device,
                                      batch=len(MIXES)), MID)
    prev = port.clone_state(state)
    for _ in range(EVERY):
        state = port.swarm_step(config, scen, state)
    sums = sk.lane_sums(state)
    M = len(port.timeline_columns(config))
    outs = []
    for fn in (sk.timeline_row, sk.timeline_row_plain):
        out = torch.zeros((len(MIXES), 1, M), device=cuda_device)
        fn(config, scen, state, sums, sk.lane_sums(prev),
           prev.rebuffer_s.clone(), out, 0, EVERY)
        outs.append(out.cpu())
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=0.0)
