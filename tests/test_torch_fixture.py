"""The committed reference fixtures (``testing/reference_run.npz``,
``testing/reference_batch.npz`` and ``testing/reference_live.npz``) that
``chip_smoke.py`` holds the port to on the card, where there is no JAX:
each must still match the JAX reference, and the port on the CPU must
match each."""

import os
import sys

import numpy as np

from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as port
from hlsjs_p2p_wrapper_tpu_torch.testing import (REFERENCE_BATCH,
                                                 REFERENCE_LIVE,
                                                 REFERENCE_RUN,
                                                 run_batch_fixture,
                                                 run_live_fixture)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import torch_port_fixture  # noqa: E402

#: the port against the fixture: the whole-run tolerance of
#: tests/test_torch_swarm_sim.py (RUN_TOL)
RUN_TOL = 1e-4


def test_fixture_matches_the_reference():
    """Re-run the JAX reference at the fixture's shape: the committed
    numbers must be what it gives today (regenerate with
    ``python tools/torch_port_fixture.py`` if the reference changed).
    Same program, same host: equal to float32 rounding."""
    d = np.load(REFERENCE_RUN)
    assert tuple(d["shape"]) == torch_port_fixture.SHAPE
    fresh = torch_port_fixture.reference_run()
    np.testing.assert_array_equal(d["join_s"], fresh["join_s"])
    np.testing.assert_allclose(float(d["offload"]), float(fresh["offload"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(d["rebuffer"]),
                               float(fresh["rebuffer"]), rtol=1e-6)
    assert float(d["rebuffer"]) > 0.0   # the run stalls: a real check


def test_port_matches_the_fixture_on_cpu():
    d = np.load(REFERENCE_RUN)
    P, S, L, K, T = (int(x) for x in d["shape"])
    config = port.SwarmConfig(n_peers=P, n_segments=S, n_levels=L,
                              neighbor_offsets=port.ring_offsets(K))
    final, _ = port.run_swarm(
        config, d["bitrates"], None,
        np.full((P,), float(d["cdn_bps"]), np.float32),
        port.init_swarm(config, device="cpu"), T, d["join_s"], device="cpu")
    elapsed = T * config.dt_ms / 1000.0
    assert abs(float(port.offload_ratio(final))
               - float(d["offload"])) <= RUN_TOL
    assert abs(float(port.rebuffer_ratio(final, elapsed, d["join_s"]))
               - float(d["rebuffer"])) <= RUN_TOL


def test_batch_fixture_matches_the_reference():
    """Re-run the reference's batched sweep path at the batch fixture's
    shape: the committed arrays must be what it gives today."""
    d = np.load(REFERENCE_BATCH)
    assert tuple(d["shape"]) == torch_port_fixture.BATCH_SHAPE
    fresh = torch_port_fixture.reference_batch()
    for name in ("join_s", "grid", "columns"):
        np.testing.assert_array_equal(d[name], fresh[name])
    for name in ("offload", "rebuffer", "series", "timeline"):
        np.testing.assert_allclose(d[name], fresh[name], rtol=1e-6,
                                   err_msg=name)
    assert float(np.max(d["rebuffer"])) > 0.0   # the lanes stall


def test_port_matches_the_batch_fixture_on_cpu():
    """Offload, rebuffer and the series within RUN_TOL; the timeline's
    clock and count columns equal."""
    d = np.load(REFERENCE_BATCH)
    offload, rebuffer, series, timeline = run_batch_fixture(d, "cpu")
    np.testing.assert_allclose(offload.numpy(), d["offload"], atol=RUN_TOL)
    np.testing.assert_allclose(rebuffer.numpy(), d["rebuffer"],
                               atol=RUN_TOL)
    np.testing.assert_allclose(series.numpy(), d["series"], atol=RUN_TOL)
    cols = list(d["columns"])
    exact = [i for i, c in enumerate(cols)
             if c in ("t_s", "stalled_peers") or c.startswith("level_")]
    np.testing.assert_array_equal(timeline.numpy()[..., exact],
                                  d["timeline"][..., exact])


def test_live_fixture_matches_the_reference():
    """Re-run the reference's batched sweep path over the live fixture's
    points: the committed arrays must be what it gives today."""
    d = np.load(REFERENCE_LIVE)
    assert tuple(d["shape"]) == torch_port_fixture.BATCH_SHAPE
    assert tuple(d["points"]) == torch_port_fixture.LIVE_POINTS
    fresh = torch_port_fixture.reference_live()
    for name in ("join_s", "points", "grid", "columns", "fg_wait_ms"):
        np.testing.assert_array_equal(d[name], fresh[name], err_msg=name)
    for name in ("offload", "rebuffer", "series", "timeline"):
        np.testing.assert_allclose(d[name], fresh[name], rtol=1e-6,
                                   err_msg=name)
    assert float(np.max(d["rebuffer"])) > 0.0   # a lane stalls
    assert bool((d["fg_wait_ms"] > 0.0).any())  # the stagger binds


def test_port_matches_the_live_fixture_on_cpu():
    """The port's joins and final stagger clocks equal the fixture's;
    offload, rebuffer and the series within RUN_TOL; the timeline's
    clock and count columns equal."""
    d = np.load(REFERENCE_LIVE)
    (offload, rebuffer, series, timeline, joins,
     fg_wait) = run_live_fixture(d, "cpu")
    np.testing.assert_array_equal(joins.numpy(), d["join_s"])
    np.testing.assert_array_equal(fg_wait.numpy(), d["fg_wait_ms"])
    np.testing.assert_allclose(offload.numpy(), d["offload"], atol=RUN_TOL)
    np.testing.assert_allclose(rebuffer.numpy(), d["rebuffer"],
                               atol=RUN_TOL)
    np.testing.assert_allclose(series.numpy(), d["series"], atol=RUN_TOL)
    cols = list(d["columns"])
    exact = [i for i, c in enumerate(cols)
             if c in ("t_s", "stalled_peers") or c.startswith("level_")]
    np.testing.assert_array_equal(timeline.numpy()[..., exact],
                                  d["timeline"][..., exact])
