"""Write the PyTorch port's reference fixtures from the JAX simulator.

The machine with the card has no JAX, so the port is held to the
reference there through committed fixtures, each a run of the JAX
reference at a fixed shape with the join times it used:

- ``reference_run.npz``: ``run_swarm`` of one scenario, its final
  offload and rebuffer ratio;
- ``reference_batch.npz``: ``run_swarm_batch`` over four points of the
  VOD grid (``tools/sweep.py``'s ``sample_grid(vod_grid(), 4)``) with a
  metrics timeline, each lane's final offload and rebuffer, offload
  series and timeline.

``chip_smoke.py`` runs the port on the card with the same joins and
compares; ``tests/test_torch_fixture.py`` re-runs the reference here
and fails if a fixture went stale.

This is the only code of the port's tree that imports JAX.

Run: ``JAX_PLATFORMS=cpu python tools/torch_port_fixture.py``
(writes both files under ``hlsjs_p2p_wrapper_tpu_torch/testing/``).
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
TESTING = os.path.join(ROOT, "hlsjs_p2p_wrapper_tpu_torch", "testing")
OUT = os.path.join(TESTING, "reference_run.npz")

#: the batch fixture: peers, segments, steps, record_every, lanes
BATCH_SHAPE = (2048, 64, 200, 20, 4)
BATCH_STAGGER_S = 20.0
BATCH_SEED = 0
BATCH_OUT = os.path.join(TESTING, "reference_batch.npz")


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


def reference_batch(shape=BATCH_SHAPE) -> dict:
    """Run the JAX reference's batched sweep path at ``shape`` over
    ``sample_grid(vod_grid(), lanes)``; returns the fixture's arrays
    (the grid points as a JSON string)."""
    import json

    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import sweep

    from hlsjs_p2p_wrapper_tpu.ops.swarm_sim import (
        init_swarm, offload_ratio_batch, rebuffer_ratio_batch,
        run_swarm_batch, stack_pytrees, timeline_columns)

    P, S, T, every, lanes = shape
    grid = sweep.sample_grid(sweep.vod_grid(), lanes)
    config = sweep.build_config(P, S, False, 8)
    watch_s = T * config.dt_ms / 1000.0
    built = [sweep.build_scenario(config, k, watch_s=watch_s,
                                  stagger_s=BATCH_STAGGER_S,
                                  seed=BATCH_SEED) for k in grid]
    final, series, timeline = run_swarm_batch(
        config, stack_pytrees([sc for sc, _ in built]),
        stack_pytrees([init_swarm(config)] * len(grid)), T,
        record_every=every)
    joins = jnp.stack([j for _, j in built])
    return {
        "join_s": np.asarray(built[0][1], np.float32),
        "grid": np.asarray(json.dumps(grid)),
        "columns": np.asarray(timeline_columns(config)),
        "offload": np.asarray(offload_ratio_batch(final), np.float64),
        "rebuffer": np.asarray(rebuffer_ratio_batch(final, watch_s, joins),
                               np.float64),
        "series": np.asarray(series, np.float32),
        "timeline": np.asarray(timeline, np.float32),
        "shape": np.asarray(shape, np.int64),
        "stagger_s": np.float64(BATCH_STAGGER_S),
        "seed": np.int64(BATCH_SEED),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--batch-out", default=BATCH_OUT)
    args = ap.parse_args(argv)
    run = reference_run()
    np.savez(args.out, **run)
    print(f"wrote {args.out}: offload {float(run['offload'])!r}, "
          f"rebuffer {float(run['rebuffer'])!r}, "
          f"shape {run['shape'].tolist()}")
    batch = reference_batch()
    np.savez(args.batch_out, **batch)
    print(f"wrote {args.batch_out}: offload {batch['offload'].tolist()}, "
          f"rebuffer {batch['rebuffer'].tolist()}, "
          f"shape {batch['shape'].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
