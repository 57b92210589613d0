"""Write the PyTorch port's reference fixtures from the JAX simulator.

The machine with the card has no JAX, so the port is held to the
reference there through committed fixtures, each a run of the JAX
reference at a fixed shape with the join times it used:

- ``reference_run.npz``: ``run_swarm`` of one scenario, its final
  offload and rebuffer ratio;
- ``reference_batch.npz``: ``run_swarm_batch`` over four points of the
  VOD grid (``tools/sweep.py``'s ``sample_grid(vod_grid(), 4)``) with a
  metrics timeline, each lane's final offload and rebuffer, offload
  series and timeline;
- ``reference_live.npz``: the same over four points of the live grid
  (:data:`LIVE_POINTS`), chosen so that every live branch binds;
- ``reference_prefetch.npz``: the same over four cells of
  ``tools/policy_ab.py``'s ring table (:data:`PREFETCH_CELLS`, three
  transfer slots, ``"spread"``), one lane with a departure wave, chosen so
  that every prefetch branch binds;
- ``reference_policies.npz``: the same lanes under the ``"adaptive"`` and
  ``"ranked"`` holder policies (:data:`POLICIES`), each policy's arrays
  keyed ``<policy>_<name>``;
- ``reference_general.npz``: the same lanes on ``tools/policy_ab.py``'s
  random mesh (``random_neighbors(P, 8, seed)``, the general ``[P, K]``
  path), one run per entry of :data:`GENERAL_RUNS` (a policy and its
  admission cap, 0 the uncapped fair share), each run's arrays keyed
  ``<run>_<name>``;
- ``reference_population.npz``: the sweep path with the example
  population (``examples/population_cellular_broadband.json``) over three
  points of its VOD mixture grid, one per mix fraction
  (:data:`POPULATION_VOD_POINTS`), and one point of its live mixture grid
  (:data:`POPULATION_LIVE_POINT`), with the per-cohort timeline columns,
  arrays keyed ``vod_<name>`` and ``live_<name>``.

``chip_smoke.py`` runs the port on the card with the same joins and
compares; ``tests/test_torch_fixture.py`` re-runs the reference here
and fails if a fixture went stale.

This is the only code of the port's tree that imports JAX.

Run: ``JAX_PLATFORMS=cpu python tools/torch_port_fixture.py``
(writes the seven files under ``hlsjs_p2p_wrapper_tpu_torch/testing/``;
``--only-prefetch``, ``--only-policies``, ``--only-general`` and
``--only-population`` write one of them).
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

#: the live fixture's points of ``live_grid()``, at BATCH_SHAPE: between
#: them, stagger windows of 2 and 8 s, announce lags of 0 and 4 s, both
#: join waves, all three supply points, both cushions and both urgency
#: margins.  ``sample_grid(live_grid(), 4)`` (points 0, 36, 72, 108) has
#: no stagger, no announce lag and no crowd, so it would bind no live
#: branch.  The watch window is the run's 50 s, so the crowd joins at
#: 12.5 s, inside it.
LIVE_POINTS = (15, 43, 107, 136)
LIVE_OUT = os.path.join(TESTING, "reference_live.npz")

#: the prefetch fixture's cells of tools/policy_ab.py's ring table
#: ``(pattern, wave, uplink Mbit/s)``, at BATCH_SHAPE with the tool's
#: ring config (three slots, "spread").  The watch window is the run's
#: 50 s, so the crowd joins at 12.5 s.  The tool's cells have no
#: departures, so an active prefetch never loses its holders; lane
#: PREFETCH_LEAVE_LANE adds a departure wave (the peers whose wave rank is
#: below PREFETCH_LEAVE_FRACTION leave at half the watch window) so that
#: the lost-holder abort binds.  Between the four lanes every prefetch
#: branch binds: absorb, the dedup guard, each abort kind, the cooldown
#: and the attempt rotation (tests/test_torch_prefetch.py counts them).
PREFETCH_CELLS = (("uniform", "crowd", 1.2), ("hetero", "stagger", 1.6),
                  ("hetero", "crowd", 2.4), ("uniform", "stagger", 10.0))
PREFETCH_LEAVE_LANE = 1
PREFETCH_LEAVE_FRACTION = 0.25
PREFETCH_OUT = os.path.join(TESTING, "reference_prefetch.npz")
#: the policies fixture: the prefetch fixture's lanes under these holder
#: policies (the spread column is the prefetch fixture)
POLICIES = ("adaptive", "ranked")
POLICIES_OUT = os.path.join(TESTING, "reference_policies.npz")
#: the general fixture: the prefetch fixture's lanes on the random mesh,
#: runs ``(name, policy, max_total_serves)``: spread and adaptive capped as
#: the tool runs them, ranked uncapped
GENERAL_RUNS = (("spread", "spread", 2), ("adaptive", "adaptive", 2),
                ("ranked_uncapped", "ranked", 0))
GENERAL_OUT = os.path.join(TESTING, "reference_general.npz")
#: the population fixture: peers, segments, steps, record_every.  The
#: batch fixture's shape but for its steps: the example spec's cellular
#: cohort arrives in one wave at 60 s, so the run lasts 70 s (280 steps)
#: for that cohort to be present, served only by the CDN and capped.
POPULATION_SHAPE = (2048, 64, 280, 20)
POPULATION_SPEC = os.path.join(ROOT, "examples",
                               "population_cellular_broadband.json")
#: points of ``population_grid(vod_grid(), spec)`` (point 3 i + m is VOD
#: point i at the m-th mix fraction): VOD point 0 (SD, scarce supply) with
#: 50% cellular, point 29 (HD, uplink 2.4 / CDN 1.2 Mb/s) with none, point
#: 47 (HD, ample supply, where the cellular level cap binds) with 25%;
#: the points tools/torch_port_population_anchor.py re-runs at full size
POPULATION_VOD_POINTS = (2, 87, 142)
#: a point of ``population_grid(live_grid(), spec)``: live point 15 (a 2 s
#: stagger, a 4 s announce lag, scarce supply) with 50% cellular
POPULATION_LIVE_POINT = 47
POPULATION_OUT = os.path.join(TESTING, "reference_population.npz")


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


def reference_live(shape=BATCH_SHAPE, points=LIVE_POINTS) -> dict:
    """Run the JAX reference's batched sweep path at ``shape`` over
    ``points`` of ``live_grid()``; returns the fixture's arrays, each
    lane's joins ``[B, P]`` included (the grid points as a JSON
    string)."""
    import json

    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import sweep

    from hlsjs_p2p_wrapper_tpu.ops.swarm_sim import (
        init_swarm, offload_ratio_batch, rebuffer_ratio_batch,
        run_swarm_batch, stack_pytrees, timeline_columns)

    P, S, T, every, lanes = shape
    grid = [sweep.live_grid()[i] for i in points]
    assert len(grid) == lanes
    config = sweep.build_config(P, S, True, 8)
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
        "join_s": np.asarray(joins, np.float32),
        "points": np.asarray(points, np.int64),
        "grid": np.asarray(json.dumps(grid)),
        "columns": np.asarray(timeline_columns(config)),
        "offload": np.asarray(offload_ratio_batch(final), np.float64),
        "rebuffer": np.asarray(rebuffer_ratio_batch(final, watch_s, joins),
                               np.float64),
        "fg_wait_ms": np.asarray(final.fg_wait_ms, np.float32),
        "series": np.asarray(series, np.float32),
        "timeline": np.asarray(timeline, np.float32),
        "shape": np.asarray(shape, np.int64),
        "stagger_s": np.float64(BATCH_STAGGER_S),
        "seed": np.int64(BATCH_SEED),
    }


def reference_prefetch(shape=BATCH_SHAPE, policy="spread", topology="ring",
                       max_total_serves=2) -> dict:
    """Run the JAX reference's batched sweep path at ``shape`` over
    :data:`PREFETCH_CELLS` with ``tools/policy_ab.py``'s config for
    holder policy ``policy`` on ``topology`` (``"ring"``, or ``"random"``:
    the tool's random mesh at the fixture's seed) with admission cap
    ``max_total_serves``, and its scenarios (the departure wave on lane
    :data:`PREFETCH_LEAVE_LANE`); returns the fixture's arrays, each
    lane's joins and leaves ``[B, P]`` included (the cells as a JSON
    string)."""
    import json

    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import policy_ab

    from hlsjs_p2p_wrapper_tpu.ops.swarm_sim import (
        NEVER_S, SwarmConfig, init_swarm, offload_ratio_batch,
        random_neighbors, rebuffer_ratio_batch, ring_offsets,
        run_swarm_batch, stack_pytrees, timeline_columns)

    P, S, T, every, lanes = shape
    assert len(PREFETCH_CELLS) == lanes
    neighbors, n_nbr = None, None
    offsets = ring_offsets(8)
    if topology == "random":
        neighbors, offsets = random_neighbors(P, 8, BATCH_SEED), None
        n_nbr = neighbors.shape[1]
    config = SwarmConfig(n_peers=P, n_segments=S, n_levels=1,
                         max_concurrency=3, holder_selection=policy,
                         neighbor_offsets=offsets,
                         max_total_serves=max_total_serves)
    watch_s = T * config.dt_ms / 1000.0
    audience = policy_ab.build_audience(P, BATCH_SEED)
    built = [policy_ab.build_cell_scenario(
        config, neighbors, audience, uplink_bps=up * 1e6, pattern=pattern,
        wave=wave, watch_s=watch_s) for pattern, wave, up in PREFETCH_CELLS]
    leave = jnp.where(audience["wave_ranks"] < PREFETCH_LEAVE_FRACTION,
                      watch_s / 2.0, NEVER_S)
    scenarios = [sc._replace(leave_s=leave) if b == PREFETCH_LEAVE_LANE
                 else sc for b, (sc, _join) in enumerate(built)]
    final, series, timeline = run_swarm_batch(
        config, stack_pytrees(scenarios),
        stack_pytrees([init_swarm(config, n_nbr)] * lanes), T,
        record_every=every)
    joins = jnp.stack([j for _, j in built])
    leaves = jnp.stack([sc.leave_s for sc in scenarios])
    return {
        "join_s": np.asarray(joins, np.float32),
        "leave_s": np.asarray(leaves, np.float32),
        "cells": np.asarray(json.dumps(PREFETCH_CELLS)),
        "leave_lane": np.int64(PREFETCH_LEAVE_LANE),
        "leave_fraction": np.float64(PREFETCH_LEAVE_FRACTION),
        "columns": np.asarray(timeline_columns(config)),
        "offload": np.asarray(offload_ratio_batch(final), np.float64),
        "rebuffer": np.asarray(rebuffer_ratio_batch(final, watch_s, joins,
                                                    leaves), np.float64),
        "series": np.asarray(series, np.float32),
        "timeline": np.asarray(timeline, np.float32),
        "shape": np.asarray(shape, np.int64),
        "seed": np.int64(BATCH_SEED),
    }


#: the arrays of a run that differ by policy; the rest the runs share
_PER_POLICY = ("offload", "rebuffer", "series", "timeline")


def reference_policies(shape=BATCH_SHAPE) -> dict:
    """:func:`reference_prefetch` under each of :data:`POLICIES`: the
    shared arrays once, and each policy's ``_PER_POLICY`` arrays keyed
    ``<policy>_<name>``."""
    out = {"policies": np.asarray(POLICIES)}
    for policy in POLICIES:
        run = reference_prefetch(shape, policy)
        for name, value in run.items():
            if name in _PER_POLICY:
                out[f"{policy}_{name}"] = value
            else:
                out[name] = value
    return out


def reference_general(shape=BATCH_SHAPE) -> dict:
    """:func:`reference_prefetch` on the random mesh for each run of
    :data:`GENERAL_RUNS`: the shared arrays once, and each run's
    ``_PER_POLICY`` arrays keyed ``<run>_<name>``."""
    import json
    out = {"runs": np.asarray(json.dumps(GENERAL_RUNS))}
    for name, policy, cap in GENERAL_RUNS:
        run = reference_prefetch(shape, policy, "random", cap)
        for key, value in run.items():
            out[f"{name}_{key}" if key in _PER_POLICY else key] = value
    return out


def reference_population(shape=POPULATION_SHAPE) -> dict:
    """Run the JAX reference's batched sweep path with the example
    population at ``shape``: the VOD points of
    :data:`POPULATION_VOD_POINTS` as one batch, the live point of
    :data:`POPULATION_LIVE_POINT` as another, both through
    ``tools/sweep.py``'s ``build_config(n_cohorts=...)`` and
    ``build_scenario(population=...)``; returns the fixture's arrays (the
    spec and the grid points as JSON strings; rebuffer as the sweep's rows
    take it, over joins)."""
    import json

    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import sweep

    from hlsjs_p2p_wrapper_tpu.engine.population import load_spec
    from hlsjs_p2p_wrapper_tpu.ops.swarm_sim import (
        init_swarm, offload_ratio_batch, rebuffer_ratio_batch,
        run_swarm_batch, stack_pytrees, timeline_columns)

    P, S, T, every = shape
    spec = load_spec(POPULATION_SPEC)
    out = {"spec": np.asarray(json.dumps(spec.to_json())),
           "shape": np.asarray(shape, np.int64),
           "stagger_s": np.float64(BATCH_STAGGER_S),
           "seed": np.int64(BATCH_SEED)}
    for key, live, base, points in (
            ("vod", False, sweep.vod_grid(), POPULATION_VOD_POINTS),
            ("live", True, sweep.live_grid(), (POPULATION_LIVE_POINT,))):
        grid = [sweep.population_grid(base, spec)[i] for i in points]
        config = sweep.build_config(P, S, live, 8,
                                    n_cohorts=len(spec.cohorts))
        watch_s = T * config.dt_ms / 1000.0
        built = [sweep.build_scenario(config, k, watch_s=watch_s,
                                      stagger_s=BATCH_STAGGER_S,
                                      seed=BATCH_SEED, population=spec)
                 for k in grid]
        final, series, timeline = run_swarm_batch(
            config, stack_pytrees([sc for sc, _ in built]),
            stack_pytrees([init_swarm(config)] * len(grid)), T,
            record_every=every)
        joins = jnp.stack([j for _, j in built])
        out.update({
            f"{key}_points": np.asarray(points, np.int64),
            f"{key}_grid": np.asarray(json.dumps(grid)),
            f"{key}_columns": np.asarray(timeline_columns(config)),
            f"{key}_offload": np.asarray(offload_ratio_batch(final),
                                         np.float64),
            f"{key}_rebuffer": np.asarray(
                rebuffer_ratio_batch(final, watch_s, joins), np.float64),
            f"{key}_series": np.asarray(series, np.float32),
            f"{key}_timeline": np.asarray(timeline, np.float32),
            f"{key}_p2p_bytes": np.asarray(final.p2p_bytes, np.float32),
        })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--batch-out", default=BATCH_OUT)
    ap.add_argument("--live-out", default=LIVE_OUT)
    ap.add_argument("--prefetch-out", default=PREFETCH_OUT)
    ap.add_argument("--policies-out", default=POLICIES_OUT)
    ap.add_argument("--general-out", default=GENERAL_OUT)
    ap.add_argument("--only-prefetch", action="store_true",
                    help="write the prefetch fixture alone")
    ap.add_argument("--only-policies", action="store_true",
                    help="write the policies fixture alone")
    ap.add_argument("--only-general", action="store_true",
                    help="write the general fixture alone")
    ap.add_argument("--population-out", default=POPULATION_OUT)
    ap.add_argument("--only-population", action="store_true",
                    help="write the population fixture alone")
    args = ap.parse_args(argv)
    if args.only_population:
        return _write_population(args.population_out)
    if args.only_general:
        return _write_general(args.general_out)
    if args.only_prefetch:
        return _write_prefetch(args.prefetch_out)
    if args.only_policies:
        return _write_policies(args.policies_out)
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
    live = reference_live()
    np.savez(args.live_out, **live)
    print(f"wrote {args.live_out}: offload {live['offload'].tolist()}, "
          f"rebuffer {live['rebuffer'].tolist()}, "
          f"shape {live['shape'].tolist()}")
    _write_prefetch(args.prefetch_out)
    _write_policies(args.policies_out)
    _write_general(args.general_out)
    return _write_population(args.population_out)


def _write_population(path) -> int:
    population = reference_population()
    np.savez(path, **population)
    for key in ("vod", "live"):
        print(f"wrote {path} ({key}): offload "
              f"{population[f'{key}_offload'].tolist()}, rebuffer "
              f"{population[f'{key}_rebuffer'].tolist()}")
    return 0


def _write_general(path) -> int:
    general = reference_general()
    np.savez(path, **general)
    for name, _policy, _cap in GENERAL_RUNS:
        print(f"wrote {path} ({name}): offload "
              f"{general[f'{name}_offload'].tolist()}, rebuffer "
              f"{general[f'{name}_rebuffer'].tolist()}")
    return 0


def _write_policies(path) -> int:
    policies = reference_policies()
    np.savez(path, **policies)
    for policy in POLICIES:
        print(f"wrote {path} ({policy}): offload "
              f"{policies[f'{policy}_offload'].tolist()}, rebuffer "
              f"{policies[f'{policy}_rebuffer'].tolist()}")
    return 0


def _write_prefetch(path) -> int:
    prefetch = reference_prefetch()
    np.savez(path, **prefetch)
    print(f"wrote {path}: offload {prefetch['offload'].tolist()}, "
          f"rebuffer {prefetch['rebuffer'].tolist()}, "
          f"shape {prefetch['shape'].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
