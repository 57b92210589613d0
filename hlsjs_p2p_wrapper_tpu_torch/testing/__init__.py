"""Test infrastructure of the port: moving state between the reference
and the port (``convert``) and the committed reference runs
(``reference_run.npz``, ``reference_batch.npz``, ``reference_live.npz``,
written by ``tools/torch_port_fixture.py``), with the port's runs of
the two batch fixtures."""

import json
import os

_HERE = os.path.dirname(os.path.abspath(__file__))
#: the reference's final offload and rebuffer ratio at a fixed shape,
#: for holding the port on a machine without JAX
REFERENCE_RUN = os.path.join(_HERE, "reference_run.npz")
#: the reference's batched sweep path over four VOD grid points, with
#: each lane's final ratios, offload series and metrics timeline
REFERENCE_BATCH = os.path.join(_HERE, "reference_batch.npz")
#: the same over four live grid points, with each lane's joins and final
#: stagger wait clock
REFERENCE_LIVE = os.path.join(_HERE, "reference_live.npz")


def run_batch_fixture(fixture, device):
    """The port's ``run_swarm_batch`` at the batch fixture's shape,
    grid points and joins (``fixture``: the loaded npz) on ``device``;
    returns ``(offload [B], rebuffer [B], series [B, T], timeline)`` as
    tensors."""
    return _run(fixture, device, live=False)[:4]


def run_live_fixture(fixture, device):
    """The port's ``run_swarm_batch`` at the live fixture's shape and
    grid points, with the joins the port builds for them, on
    ``device``; returns ``(offload [B], rebuffer [B], series [B, T],
    timeline, joins [B, P], final fg_wait_ms [B, P])`` as tensors."""
    return _run(fixture, device, live=True)


def _run(fixture, device, live):
    import torch

    from .. import sweep_grid as sg
    from ..ops import swarm_sim as sim

    P, S, T, every, lanes = (int(x) for x in fixture["shape"])
    grid = json.loads(str(fixture["grid"]))
    config = sg.build_config(P, S, live, 8)
    watch_s = T * config.dt_ms / 1000.0
    built = [sg.build_scenario(config, k, watch_s=watch_s,
                               stagger_s=float(fixture["stagger_s"]),
                               seed=int(fixture["seed"]),
                               join_s=None if live else fixture["join_s"],
                               device=device)
             for k in grid]
    final, series, timeline = sim.run_swarm_batch(
        config, sim.stack_pytrees([sc for sc, _ in built]),
        sim.init_swarm(config, device=device, batch=lanes), T,
        record_every=every)
    joins = torch.stack([j for _, j in built])
    return (sim.offload_ratio_batch(final),
            sim.rebuffer_ratio_batch(final, watch_s, joins), series,
            timeline, joins, final.fg_wait_ms)
