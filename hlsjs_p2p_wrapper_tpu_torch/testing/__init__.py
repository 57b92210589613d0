"""Test infrastructure of the port: moving state between the reference
and the port (``convert``) and the committed reference runs
(``reference_run.npz``, ``reference_batch.npz``, ``reference_live.npz``,
``reference_prefetch.npz``, ``reference_policies.npz``,
``reference_general.npz``, ``reference_population.npz``, written by
``tools/torch_port_fixture.py``), with the port's runs of the batch
fixtures, and the population plane's lanes and binding counts."""

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
#: the same over four cells of the policy A/B ring table (three transfer
#: slots), with each lane's joins and leaves
REFERENCE_PREFETCH = os.path.join(_HERE, "reference_prefetch.npz")
#: the same cells under the "adaptive" and "ranked" holder policies, each
#: array keyed ``<policy>_<name>`` (the cells, shape, joins and leaves
#: shared)
REFERENCE_POLICIES = os.path.join(_HERE, "reference_policies.npz")
#: the same cells on the random mesh (the general [P, K] path), one run
#: per entry of its ``runs`` (a policy and its ``max_total_serves``, 0
#: the uncapped fair share), each array keyed ``<run>_<name>``
REFERENCE_GENERAL = os.path.join(_HERE, "reference_general.npz")
#: the reference's batched sweep path with the example population over
#: three VOD points of its mixture grid (one a mix fraction) and one live
#: point, arrays keyed ``vod_<name>`` and ``live_<name>``
REFERENCE_POPULATION = os.path.join(_HERE, "reference_population.npz")
#: the population spec that ``tools/sweep.py --population`` documents: 60%
#: broadband, 40% cdn_only cellular capped at level 1 (mixture axis
#: 0, 0.25, 0.5 cellular)
EXAMPLE_SPEC = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                            "examples", "population_cellular_broadband.json")


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


def prefetch_lanes(fixture, device, *, peers=None, segments=None,
                   watch_s=None, slots=None, policy="spread",
                   topology="ring", max_total_serves=None):
    """The prefetch fixture's lanes on ``device``: ``policy_grid``'s
    config for ``policy`` on ``topology`` (``"ring"``, or ``"random"``:
    the random mesh of ``random_topology`` at the fixture's seed) and
    its cell scenarios, with the fixture's departure wave on its leave
    lane, at the fixture's shape unless ``peers``, ``segments``,
    ``watch_s`` (the crowd's and the wave's clock), ``slots``
    (``max_concurrency``) or ``max_total_serves`` say otherwise.  Returns
    ``(config, stacked scenarios, joins [B, P], leaves [B, P])``."""
    import torch

    from .. import policy_grid as pg
    from ..ops import swarm_sim as sim

    P, S, T, _every, _lanes = (int(x) for x in fixture["shape"])
    P, S = peers or P, segments or S
    seed = int(fixture["seed"])
    mesh = None
    if topology == "random":
        config = pg.random_config(P, S, policy)
        mesh = pg.random_topology(P, seed, device=device)
    else:
        config = pg.ring_config(P, S, policy)
    if slots is not None:
        config = config._replace(max_concurrency=slots)
    if max_total_serves is not None:
        config = config._replace(max_total_serves=max_total_serves)
    if watch_s is None:
        watch_s = T * config.dt_ms / 1000.0
    audience = pg.build_audience(P, seed, device=device)
    built = [pg.build_cell_scenario(config, audience, uplink_bps=up * 1e6,
                                    pattern=pattern, wave=wave,
                                    watch_s=watch_s, neighbors=mesh)
             for pattern, wave, up in json.loads(str(fixture["cells"]))]
    leave = torch.where(
        audience["wave_ranks"] < float(fixture["leave_fraction"]),
        watch_s / 2.0, sim.NEVER_S)
    scenarios = [sc._replace(leave_s=leave)
                 if b == int(fixture["leave_lane"]) else sc
                 for b, (sc, _join) in enumerate(built)]
    return (config, sim.stack_pytrees(scenarios),
            torch.stack([j for _, j in built]),
            torch.stack([sc.leave_s for sc in scenarios]))


def run_prefetch_fixture(fixture, device, policy="spread", **lanes_kw):
    """The port's ``run_swarm_batch`` at the prefetch fixture's shape and
    lanes (:func:`prefetch_lanes`, built by the port, with ``lanes_kw``:
    the general fixture's ``topology="random"`` and its
    ``max_total_serves``) under ``policy`` on ``device`` (the policies
    and general fixtures share the prefetch fixture's shape, cells and
    departure wave); returns ``(offload [B], rebuffer [B], series [B,
    T], timeline, joins [B, P], leaves [B, P])`` as tensors."""
    from ..ops import swarm_sim as sim

    _P, _S, T, every, lanes = (int(x) for x in fixture["shape"])
    config, scenarios, joins, leaves = prefetch_lanes(
        fixture, device, policy=policy, **lanes_kw)
    watch_s = T * config.dt_ms / 1000.0
    final, series, timeline = sim.run_swarm_batch(
        config, scenarios, sim.init_swarm(config, device=device,
                                          batch=lanes),
        T, record_every=every)
    return (sim.offload_ratio_batch(final),
            sim.rebuffer_ratio_batch(final, watch_s, joins, leaves), series,
            timeline, joins, leaves)


def general_runs(fixture):
    """The general fixture's runs: ``[(name, policy, max_total_serves)]``
    in its order."""
    return [(str(name), str(policy), int(cap))
            for name, policy, cap in json.loads(str(fixture["runs"]))]


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


def population_lanes(config, spec, mixes, bitrates, *, cdn_bps, uplink_bps,
                     device, neighbors=None, **scalars):
    """One scenario per mix fraction of ``spec`` (``spec.with_mix``),
    stacked as lanes on ``device``: the materialized population at
    ``config.n_peers`` and ``config.n_levels``, with ``cdn_bps`` and
    ``uplink_bps`` the defaults of the cohorts that inherit them, passed
    to ``make_scenario`` as ``to_scenario_kwargs`` gives it (the joins
    and leaves too: the spec must own its joins), with ``neighbors``
    (the general path) and the policy scalars ``scalars``.  Returns
    ``(stacked scenarios, joins [B, P])``."""
    import numpy as np
    import torch

    from ..engine.population import materialize, to_scenario_kwargs
    from ..ops import swarm_sim as sim

    P = config.n_peers
    built = []
    for mix in mixes:
        pop = materialize(spec.with_mix(mix), P, n_levels=config.n_levels,
                          default_uplink_bps=uplink_bps,
                          default_cdn_bps=cdn_bps)
        kw = to_scenario_kwargs(pop)
        cdn = kw.pop("cdn_bps", np.full((P,), cdn_bps, np.float32))
        uplink = kw.pop("uplink_bps", np.full((P,), uplink_bps, np.float32))
        built.append(sim.make_scenario(
            config, bitrates, neighbors, cdn, kw.pop("join_s"),
            uplink_bps=uplink, device=device, **kw, **scalars))
    return (sim.stack_pytrees(built),
            torch.stack([sc.join_s for sc in built]))


def population_binding(config, scenario, state):
    """What of the population fields binds in the next step, as the
    plain selection sees it, summed over lanes: ``gate_requesters``,
    requesters of cohorts without P2P (``p2p_ok`` 0) whose foreground
    wants a segment that a present P2P peer among their neighbours holds
    (the gate zeroes that eligibility); ``gate_holders``, (requester,
    slot) pairs whose target a present neighbour holds that the gate
    keeps from serving; ``abr_capped``, present peers whose ABR pick is
    above their ``abr_cap_level``; ``urgent_by_offset``, foreground
    wishes urgent only because of their ``urgent_margin_off_s``;
    ``departed``, peers whose session ended (``leave_s <= t``)."""
    import torch

    from ..ops import swarm_kernels as sk
    from ..ops import swarm_sim as sim
    from ..ops.ewma import get_estimate

    if not sim.is_lanes(state):
        scenario, state = sim.as_lanes(scenario), sim.as_lanes(state)
    g = sk.geometry(config)
    (present, _want, next_seg, fg_wants, playhead, _act, _p2p, _segs,
     flats) = sk._slot_targets(config, scenario, state)
    targets = [flats[..., c] for c in range(config.max_concurrency)]

    def holders(serve):
        if g.general:
            elig = sim.gather_eligibility(state.avail, serve,
                                          scenario.neighbors, targets)
        else:
            elig = sim.circulant_eligibility(
                state.avail, serve, list(g.offs), targets,
                impl=sim.resolve_eligibility(config, state.avail.device))
        return torch.stack([n for _e, n, _own in elig], dim=-1)

    ok = scenario.p2p_ok > 0.0
    n_open, n_gated = holders(present), holders(present & ok)
    estimate = get_estimate(state.ewma, config.fast_half_life_s,
                            config.slow_half_life_s)
    pick = sim._abr_pick(estimate, scenario.bitrates)
    margin = next_seg.to(torch.float32) * g.seg - playhead
    base = scenario.urgent_margin_s.reshape(-1, 1)
    t = state.t_s.reshape(-1, 1)
    return {
        "gate_requesters": int((fg_wants & ~ok & (n_gated[..., 0] > 0))
                               .sum()),
        "gate_holders": int((present.unsqueeze(-1)
                             & (n_open > n_gated)).sum()),
        "abr_capped": int((present & (pick > scenario.abr_cap_level))
                          .sum()),
        "urgent_by_offset": int(
            (fg_wants & (margin >= base)
             & (margin < base + scenario.urgent_margin_off_s)).sum()),
        "departed": int(((scenario.leave_s <= t)
                         & (scenario.join_s <= t)).sum()),
    }


def run_population_fixture(fixture, device):
    """The port's ``run_swarm_batch`` at the population fixture's shape
    and points, each scenario built by ``sweep_grid.build_scenario`` with
    the fixture's spec, on ``device``; returns ``{"vod": ..., "live":
    ...}``, each ``(offload [B], rebuffer [B], series [B, T], timeline
    [B, R, M], final p2p_bytes [B, P])`` as tensors."""
    import torch

    from .. import sweep_grid as sg
    from ..engine.population import PopulationSpec
    from ..ops import swarm_sim as sim

    P, S, T, every = (int(x) for x in fixture["shape"])
    spec = PopulationSpec.from_json(json.loads(str(fixture["spec"])))
    out = {}
    for key, live in (("vod", False), ("live", True)):
        grid = json.loads(str(fixture[f"{key}_grid"]))
        config = sg.build_config(P, S, live, 8, n_cohorts=len(spec.cohorts))
        watch_s = T * config.dt_ms / 1000.0
        built = [sg.build_scenario(config, k, watch_s=watch_s,
                                   stagger_s=float(fixture["stagger_s"]),
                                   seed=int(fixture["seed"]),
                                   population=spec, device=device)
                 for k in grid]
        final, series, timeline = sim.run_swarm_batch(
            config, sim.stack_pytrees([sc for sc, _ in built]),
            sim.init_swarm(config, device=device, batch=len(grid)), T,
            record_every=every)
        joins = torch.stack([j for _, j in built])
        out[key] = (sim.offload_ratio_batch(final),
                    sim.rebuffer_ratio_batch(final, watch_s, joins), series,
                    timeline, final.p2p_bytes)
    return out
