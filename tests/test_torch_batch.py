"""Slice 3 of the PyTorch port, on the CPU: the stacked scenario axis
(``run_swarm_batch``), the ``record_every`` metrics timeline and the
per-lane reductions, inside the port and against the JAX reference.

The reference runs as its own tests run it on this host (jit on the
CPU).  The reference's joins are handed to both sides (the port's own
draws are the same bits: tests/test_torch_prng.py)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlsjs_p2p_wrapper_tpu.engine import digest as ref_digest
from hlsjs_p2p_wrapper_tpu.ops import swarm_sim as ref
from hlsjs_p2p_wrapper_tpu_torch import sweep_grid as sg
from hlsjs_p2p_wrapper_tpu_torch.engine import digest as port_digest
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_kernels as sk
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as port
from hlsjs_p2p_wrapper_tpu_torch.testing.convert import state_to_numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import sweep as ref_sweep  # noqa: E402

#: the parity shape: 4 points of the VOD grid at 256 peers × 64
#: segments × 100 steps, a row every 10 steps, the stall digest on
P, S, T, EVERY = 256, 64, 100, 10
STAGGER_S, SEED = 20.0, 0
WATCH_S = T * 0.25
#: final ratios and the offload series, port vs reference (the
#: whole-run tolerance of tests/test_torch_swarm_sim.py)
RUN_TOL = 1e-4
#: EWMA fields and other float fields, port vs reference
#: (tests/test_torch_swarm_sim.py EWMA_RTOL, FLOAT_RTOL)
EWMA_RTOL = FLOAT_RTOL = 1e-6
#: the timeline's interval byte rates (bit/s), port vs reference:
#: float32 sums over 256 peers taken in another order, differenced and
#: scaled (measured at this shape: 1.4e-6 relative, 304 b/s of 2.3e8),
#: plus 1 b/s for a rate near zero
RATE_RTOL, RATE_ATOL = 1e-5, 1.0
INT_FIELDS = ("level", "avail", "dl_flags", "dl_seg", "dl_level",
              "dl_holder_off", "dl_attempts")


def _config(**kw):
    return sg.build_config(P, S, False, 8)._replace(**kw)


def _tree_np(tree):
    out = {}
    for k, v in tree._asdict().items():
        out[k] = ({f: np.asarray(x) for f, x in v._asdict().items()}
                  if hasattr(v, "_asdict") else np.asarray(v))
    return out


def _lanes_equal(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(port.tree_leaves(a), port.tree_leaves(b)))


@pytest.fixture(scope="module")
def parity():
    """The reference's and the port's batched runs of
    ``sample_grid(vod_grid(), 4)``, from the reference's joins."""
    config = _config(stall_digest=True)
    grid = sg.sample_grid(sg.vod_grid(), 4)
    assert grid == ref_sweep.sample_grid(ref_sweep.vod_grid(), 4)
    rconfig = ref.SwarmConfig(*config)
    built = [ref_sweep.build_scenario(rconfig, k, watch_s=WATCH_S,
                                      stagger_s=STAGGER_S, seed=SEED)
             for k in grid]
    rscen = ref.stack_pytrees([sc for sc, _ in built])
    rstates = ref.stack_pytrees([ref.init_swarm(rconfig)] * len(grid))
    rfinal, rseries, rtl = ref.run_swarm_batch(rconfig, rscen, rstates, T,
                                               record_every=EVERY)
    join = np.asarray(built[0][1])
    rjoins = jnp.stack([j for _, j in built])
    ref_out = {"final": _tree_np(rfinal), "series": np.asarray(rseries),
               "timeline": np.asarray(rtl),
               "offload": np.asarray(ref.offload_ratio_batch(rfinal)),
               "rebuffer": np.asarray(ref.rebuffer_ratio_batch(
                   rfinal, WATCH_S, rjoins))}
    pbuilt = [sg.build_scenario(config, k, watch_s=WATCH_S,
                                stagger_s=STAGGER_S, seed=SEED,
                                join_s=join, device="cpu") for k in grid]
    pscen = port.stack_pytrees([sc for sc, _ in pbuilt])
    final, series, tl = port.run_swarm_batch(
        config, pscen, port.init_swarm(config, device="cpu",
                                       batch=len(grid)), T,
        record_every=EVERY)
    joins = torch.stack([j for _, j in pbuilt])
    port_out = {"final": state_to_numpy(final), "series": series.numpy(),
                "timeline": tl.numpy(),
                "offload": port.offload_ratio_batch(final).numpy(),
                "rebuffer": port.rebuffer_ratio_batch(final, WATCH_S,
                                                      joins).numpy()}
    return config, grid, pbuilt, ref_out, port_out


# ---- inside the port ---------------------------------------------------------

def _small(n_lanes=4, P_=64, S_=16, ample=False, **kw):
    """``n_lanes`` VOD grid points at a small size, with shared joins:
    the sampled points (all at the scarce supply point) or, with
    ``ample``, points at the ample supply point, where peers serve."""
    config = sg.build_config(P_, S_, False, 8)._replace(**kw)
    grid = (sg.vod_grid()[3::4] if ample
            else sg.sample_grid(sg.vod_grid(), n_lanes))[:n_lanes]
    join = port.staggered_joins(P_, 10.0, device="cpu")
    built = [sg.build_scenario(config, k, watch_s=10.0, stagger_s=10.0,
                               seed=0, join_s=join, device="cpu")
             for k in grid]
    return config, [sc for sc, _ in built], join


def test_batched_equals_sequential_per_lane():
    """Every state field, the series and the timeline of each lane are
    the bits of that scenario run alone."""
    config, scens, _join = _small(stall_digest=True)
    final, series, tl = port.run_swarm_batch(
        config, port.stack_pytrees(scens),
        port.init_swarm(config, device="cpu", batch=len(scens)), 60,
        record_every=7)
    assert tuple(series.shape) == (len(scens), 60)
    assert tuple(tl.shape) == (len(scens), 8,
                               len(port.timeline_columns(config)))
    for b, sc in enumerate(scens):
        f1, s1, t1 = port.run_swarm_scenario(
            config, sc, port.init_swarm(config, device="cpu"), 60,
            record_every=7)
        assert _lanes_equal(port.lane(final, b), f1), f"lane {b} state"
        assert torch.equal(series[b], s1) and torch.equal(tl[b], t1)


def test_lanes_are_independent():
    """Perturb one lane's scenario: the other lanes keep their bits.  A
    roll over the flattened lanes would leak lane 1's last peers into
    lane 2's first neighbours."""
    config, scens, _join = _small(P_=48, ample=True)

    def run(scenarios):
        return port.run_swarm_batch(
            config, port.stack_pytrees(scenarios),
            port.init_swarm(config, device="cpu", batch=len(scenarios)),
            50)
    base_final, base_series = run(scens)
    changed = list(scens)
    changed[1] = changed[1]._replace(
        cdn_bps=changed[1].cdn_bps * 3.0,
        uplink_bps=torch.zeros_like(changed[1].uplink_bps))
    final, series = run(changed)
    assert float(base_series[1, -1]) > 0.0
    assert not torch.equal(series[1], base_series[1])
    for b in (0, 2, 3):
        assert _lanes_equal(port.lane(final, b), port.lane(base_final, b))
        assert torch.equal(series[b], base_series[b])


def test_last_timeline_row_equals_final_ratios_bit_exact():
    config, scens, join = _small()
    final, series, tl = port.run_swarm_batch(
        config, port.stack_pytrees(scens),
        port.init_swarm(config, device="cpu", batch=len(scens)), 40,
        record_every=8)
    cols = port.timeline_columns(config)
    offs = port.offload_ratio_batch(final)
    rebs = port.rebuffer_ratio_batch(final, 10.0, join)
    assert torch.equal(tl[:, -1, cols.index("t_s")], torch.full((4,), 10.0))
    assert torch.equal(tl[:, -1, cols.index("offload")], offs)
    assert torch.equal(tl[:, -1, cols.index("rebuffer")], rebs)
    assert torch.equal(series[:, -1], offs)
    for b in range(len(scens)):
        one = port.lane(final, b)
        assert float(port.offload_ratio(one)) == float(offs[b])
        assert float(port.rebuffer_ratio(one, 10.0, join)) == float(rebs[b])


def test_trailing_remainder_steps_still_run():
    """45 steps at a row every 20: two rows, and the final state and
    the series cover all 45 steps, as without a timeline."""
    config, scens, _join = _small(n_lanes=2)
    stacked = port.stack_pytrees(scens)
    final, series, tl = port.run_swarm_batch(
        config, stacked, port.init_swarm(config, device="cpu", batch=2),
        45, record_every=20)
    plain, plain_series = port.run_swarm_batch(
        config, stacked, port.init_swarm(config, device="cpu", batch=2),
        45)
    assert tl.shape[1] == 2 and series.shape[1] == 45
    assert _lanes_equal(final, plain) and torch.equal(series, plain_series)
    assert torch.equal(final.t_s, torch.full((2,), 45 * 0.25))
    cols = port.timeline_columns(config)
    assert torch.equal(tl[:, 1, cols.index("t_s")], torch.full((2,), 10.0))


def test_level_counts_account_every_present_peer():
    config, scens, join = _small()
    _f, _s, tl = port.run_swarm_batch(
        config, port.stack_pytrees(scens),
        port.init_swarm(config, device="cpu", batch=len(scens)), 40,
        record_every=10)
    cols = port.timeline_columns(config)
    lv = [cols.index(f"level_{i}_peers") for i in range(config.n_levels)]
    t = tl[0, :, cols.index("t_s")]
    present = (join[None, :] <= t[:, None]).sum(dim=1).to(torch.float32)
    for b in range(len(scens)):
        assert torch.equal(tl[b][:, lv].sum(dim=1), present)


@pytest.mark.parametrize("record_every,change,err,match", [
    (-1, {}, ValueError, "record_every"),
    (5, {"n_cohorts": sk.MAX_COHORTS + 1}, ValueError,
     f"at most {sk.MAX_COHORTS} cohorts")])
def test_timeline_limits_raise(record_every, change, err, match):
    """A negative interval raises.  The cohort columns are ported: the
    CPU path takes any number of cohorts, and the card's argument check
    (which runs before any device work) refuses more than the kernel's
    ``MAX_COHORTS``."""
    config, scens, _join = _small(n_lanes=2, **change)
    args = (config, port.stack_pytrees(scens),
            port.init_swarm(config, device="cpu", batch=2), 10)
    if change:
        _f, _s, tl = port.run_swarm_batch(*args, record_every=record_every)
        assert tl.shape[-1] == len(port.timeline_columns(config))
        scenario, state = args[1], args[2]
        with pytest.raises(err, match=match):
            sk._row_args(config, scenario, state, None, None, None, tl, 0,
                         record_every)
        return
    with pytest.raises(err, match=match):
        port.run_swarm_batch(*args, record_every=record_every)


def test_lane_helpers():
    config, scens, _join = _small(n_lanes=3)
    stacked = port.stack_pytrees(scens)
    assert tuple(stacked.urgent_margin_s.shape) == (3,)
    assert tuple(stacked.bitrates.shape) == (3, config.n_levels)
    for b, sc in enumerate(scens):
        assert _lanes_equal(port.lane(stacked, b), sc)
    states = port.init_swarm(config, device="cpu", batch=3)
    one = port.init_swarm(config, device="cpu")
    assert _lanes_equal(states, port.stack_pytrees([one] * 3))
    view = port.as_lanes(one)
    view.playhead_s.add_(1.0)   # views: the single state moves too
    assert float(one.playhead_s.sum()) == config.n_peers
    with pytest.raises(ValueError, match="empty"):
        port.stack_pytrees([])
    with pytest.raises(ValueError, match="stacked"):
        port.run_swarm_batch(config, scens[0], one, 1)


def test_reductions_plain_match_their_definitions():
    """``lane_sums`` and ``timeline_row`` on the CPU are their plain
    versions: the sums are ``torch.sum`` per lane, and the counts are
    whole numbers."""
    config, scens, _join = _small(stall_digest=True)
    stacked = port.stack_pytrees(scens)
    states = port.init_swarm(config, device="cpu", batch=len(scens))
    for _ in range(30):
        states = port.swarm_step(config, stacked, states)
    series = torch.zeros((len(scens), 3))
    sums = sk.lane_sums(states, series, 2)
    np.testing.assert_array_equal(
        sums.numpy(), torch.stack([states.cdn_bytes.sum(1),
                                   states.p2p_bytes.sum(1)], 1).numpy())
    p2p, cdn = sums[:, 1], sums[:, 0]
    assert torch.equal(series[:, 2], p2p / torch.clamp_min(p2p + cdn, 1.0))
    M = len(port.timeline_columns(config))
    out = torch.full((len(scens), 2, M), -1.0)
    prev = torch.zeros((len(scens), 2))
    prev_reb = torch.zeros_like(states.rebuffer_s)
    sk.timeline_row(config, stacked, states, sums, prev, prev_reb, out, 1,
                    10)
    assert bool((out[:, 0] == -1.0).all()) and bool((out[:, 1] >= 0).all())
    counts = out[:, 1, 5:]
    assert torch.equal(counts, counts.round())
    assert torch.equal(prev, sums) and torch.equal(prev_reb,
                                                   states.rebuffer_s)
    assert sk.LAUNCHES["lane_sums"] == sk.LAUNCHES["timeline_row"] == 0


# ---- against the reference ---------------------------------------------------

def test_timeline_columns_match_reference():
    for digest in (False, True):
        config = _config(stall_digest=digest)
        assert (port.timeline_columns(config)
                == ref.timeline_columns(ref.SwarmConfig(*config)))


def test_digest_edges_match_reference():
    assert port_digest.DEFAULT_EDGES == ref_digest.DEFAULT_EDGES
    assert port_digest.log_edges(2.0, 50.0, 7) == ref_digest.log_edges(
        2.0, 50.0, 7)


def test_rate_factor_is_the_compiled_constant():
    """The reference's row scales an interval's bytes by ``8.0 /
    interval_s``; XLA folds it into one float32 multiplier, which the
    port uses as it is (10 steps of 250 ms: 3.2)."""
    config = _config()
    assert sk.rate_factor(config, 10) == float(np.float32(3.2))
    assert sk.rate_factor(config, 40) == float(np.float32(0.8))


def test_batch_state_matches_reference(parity):
    _config_, _grid, _built, r, p = parity
    for k, v in r["final"].items():
        got = p["final"][k]
        if k == "ewma":
            for f in v:
                np.testing.assert_allclose(got[f], v[f], rtol=EWMA_RTOL,
                                           err_msg=f"ewma.{f}")
            continue
        assert got.shape == v.shape, k
        if k in INT_FIELDS:
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            np.testing.assert_allclose(got, v, rtol=FLOAT_RTOL, err_msg=k)


def test_batch_series_and_ratios_match_reference(parity):
    _config_, _grid, _built, r, p = parity
    np.testing.assert_allclose(p["series"], r["series"], atol=RUN_TOL)
    np.testing.assert_allclose(p["offload"], r["offload"], atol=RUN_TOL)
    np.testing.assert_allclose(p["rebuffer"], r["rebuffer"], atol=RUN_TOL)
    assert float(np.max(r["rebuffer"])) > 0.0   # the stall columns count


def test_batch_timeline_matches_reference(parity):
    config, _grid, _built, r, p = parity
    cols = port.timeline_columns(config)
    got, want = p["timeline"], r["timeline"]
    assert got.shape == want.shape
    exact = [i for i, c in enumerate(cols)
             if c in ("t_s", "stalled_peers") or c.startswith(
                 ("level_", "stall_ms_bin"))]
    np.testing.assert_array_equal(got[..., exact], want[..., exact])
    for name in ("offload", "rebuffer"):
        i = cols.index(name)
        np.testing.assert_allclose(got[..., i], want[..., i], atol=RUN_TOL)
    for name in ("cdn_rate_bps", "p2p_rate_bps"):
        i = cols.index(name)
        np.testing.assert_allclose(got[..., i], want[..., i],
                                   rtol=RATE_RTOL, atol=RATE_ATOL)
    assert float(want[..., cols.index("stalled_peers")].max()) > 0.0
    assert float(want[..., cols.index("stall_ms_bin0") + 1:].sum()) > 0.0
