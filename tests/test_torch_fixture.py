"""The committed reference fixture (``testing/reference_run.npz``)
that ``chip_smoke.py`` holds the port to on the card, where there is no
JAX: it must still match the JAX reference, and the port on the CPU
must match it."""

import os
import sys

import numpy as np

from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as port
from hlsjs_p2p_wrapper_tpu_torch.testing import REFERENCE_RUN

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
