"""Write the PyTorch port's reference fixture from the JAX simulator.

The machine with the card has no JAX, so the port is held to the
reference there through a committed fixture: one run of the JAX
reference at a fixed shape, with its join times, final offload and
final rebuffer ratio.  ``chip_smoke.py`` runs the port on the card
with the same joins and compares; ``tests/test_torch_fixture.py``
re-runs the reference here and fails if the fixture went stale.

This is the only code of the port's tree that imports JAX.

Run: ``JAX_PLATFORMS=cpu python tools/torch_port_fixture.py``
(writes ``hlsjs_p2p_wrapper_tpu_torch/testing/reference_run.npz``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: peers, segments, levels, ring degree, steps
SHAPE = (2048, 64, 3, 8, 200)
BITRATES = (300_000.0, 800_000.0, 2_000_000.0)
#: a CDN rate just above the top rung, so that the run stalls at
#: start-up and the rebuffer ratio has something to compare
CDN_BPS = 2_500_000.0
JOIN_WINDOW_S = 60.0
OUT = os.path.join(ROOT, "hlsjs_p2p_wrapper_tpu_torch", "testing",
                   "reference_run.npz")


def reference_run(shape=SHAPE) -> dict:
    """Run the JAX reference at ``shape``; returns the fixture's
    arrays."""
    import jax.numpy as jnp

    from hlsjs_p2p_wrapper_tpu.ops.swarm_sim import (
        SwarmConfig, init_swarm, offload_ratio, rebuffer_ratio,
        ring_offsets, run_swarm, staggered_joins)

    P, S, L, K, T = shape
    config = SwarmConfig(n_peers=P, n_segments=S, n_levels=L,
                         neighbor_offsets=ring_offsets(K))
    join = staggered_joins(P, JOIN_WINDOW_S)
    final, _ = run_swarm(config, jnp.array(BITRATES), None,
                         jnp.full((P,), CDN_BPS), init_swarm(config), T,
                         join)
    elapsed_s = T * config.dt_ms / 1000.0
    return {
        "join_s": np.asarray(join, np.float32),
        "offload": np.float64(offload_ratio(final)),
        "rebuffer": np.float64(rebuffer_ratio(final, elapsed_s, join)),
        "shape": np.asarray(shape, np.int64),
        "bitrates": np.asarray(BITRATES, np.float64),
        "cdn_bps": np.float64(CDN_BPS),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    run = reference_run()
    np.savez(args.out, **run)
    print(f"wrote {args.out}: offload {float(run['offload'])!r}, "
          f"rebuffer {float(run['rebuffer'])!r}, "
          f"shape {run['shape'].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
