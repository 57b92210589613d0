"""The VOD and live policy grids that users sweep, and how one grid
point becomes a scenario: copied from the reference's ``tools/sweep.py``
(``LADDERS`` … ``padded_ladder`` :142-170, ``vod_grid`` :184-199,
``live_grid`` :203-224, ``population_grid`` and its memo :230-255,
``build_config`` and ``build_scenario`` :258-335, ``sample_grid``
:339-350, ``journal_meta`` :404-417).

A grid point is a dict of knobs.  Every point of a grid shares one
static ``SwarmConfig`` (the ring degree is the only static knob, and
``live`` is fixed per grid), so a whole grid runs as one group of the
chunked dispatch (``ops/dispatch.py``); everything else is scenario
data, one lane per point, the live cushion ``live_sync_s`` included.
Ladders of different lengths share the config's level count, padded
with ``UNREACHABLE_BITRATE``, a rung the ABR rule never picks.

A population sweep (``tools/sweep.py --population SPEC.json``) overlays
every point with a cohort mixture (``engine/population.py``):
:func:`population_grid` crosses the grid with the spec's mixture axis,
:func:`build_scenario` takes the per-peer rates, joins, leaves and the
four population fields from the materialized spec, and the config
carries ``n_cohorts=len(spec.cohorts)``, which sizes the timeline's
per-cohort columns.  All of it is scenario data, so the mixture grid is
still one dispatch group.
"""

from __future__ import annotations

import itertools
import json

import numpy as np
import torch

from .core.device import resolve_device
from .engine.population import materialize, to_scenario_kwargs
from .ops.swarm_sim import (UNREACHABLE_BITRATE, SwarmConfig,
                            make_scenario, ring_offsets, stable_ranks,
                            staggered_joins)

LADDERS = {
    "sd": (300_000.0, 800_000.0),
    "hd": (300_000.0, 800_000.0, 2_000_000.0),
    "fhd": (500_000.0, 1_500_000.0, 4_000_000.0),
}
#: common static shape across the grid: every ladder is padded to
#: this many levels with UNREACHABLE_BITRATE (never chosen)
N_LEVELS = max(len(v) for v in LADDERS.values())


def padded_ladder(name):
    rates = list(LADDERS[name])
    return tuple(rates + [UNREACHABLE_BITRATE] * (N_LEVELS - len(rates)))


#: host-side memo for the per-peer arrays drawn from a seed: every VOD
#: grid point shares one (join, rank) pair, so the grid draws them once
#: per (kind, peers, window or seed, device)
_ARRAY_CACHE = {}


def _cached(kind, fn, *key, device=None):
    memo_key = (kind, str(device)) + key
    if memo_key not in _ARRAY_CACHE:
        _ARRAY_CACHE[memo_key] = fn(*key, device=device)
    return _ARRAY_CACHE[memo_key]


def vod_grid():
    """The 48-point VOD grid: two ladders × three urgency margins × two
    P2P budget caps × four (uplink, CDN) supply points, from scarcity
    (uplink at or below the top rung, a constrained CDN) to the ample
    point (10 / 8 Mb/s).  One topology degree, so one static config."""
    urgents = (0.5, 4.0, 8.0)
    caps = (3_000.0, 12_000.0)
    supply = ((1.2, 1.2), (2.4, 1.2), (2.4, 4.0), (10.0, 8.0))
    return [dict(degree=8, ladder=lad, spread_s=0.0,
                 urgent_margin_s=u, budget_cap_ms=cap,
                 uplink_mbps=up, cdn_mbps=cd)
            for lad, u, cap, (up, cd) in itertools.product(
                ("sd", "hd"), urgents, caps, supply)]


def live_grid():
    """The 144-point live grid: two live cushions × two urgency margins
    × three edge-stagger windows × three (uplink, CDN) supply points ×
    two announce lags × two join waves (``"steady"``: everyone at t = 0;
    ``"crowd"``: a quarter seeds at t = 0, the rest a quarter into the
    watch window), on the HD ladder with a 6 s P2P budget cap.  One
    topology degree, so one static config."""
    spreads = (0.0, 2.0, 8.0)
    supply = ((1.2, 1.2), (2.4, 2.4), (10.0, 8.0))
    announces = (0.0, 4.0)
    waves = ("steady", "crowd")
    syncs = (6.0, 12.0)
    urgents = (0.5, 4.0)
    return [dict(degree=8, ladder="hd", spread_s=sp,
                 live_sync_s=sync, urgent_margin_s=u,
                 budget_cap_ms=6_000.0,
                 announce_delay_s=ann, join_wave=wave,
                 uplink_mbps=up, cdn_mbps=cd)
            for sync, u, sp, (up, cd), ann, wave in
            itertools.product(syncs, urgents, spreads, supply,
                              announces, waves)]


def population_grid(grid, spec):
    """Cross a grid with the population spec's mixture axis: one copy of
    every point per ``spec.mix_fractions`` entry, carrying the fraction
    as the ``population_mix`` knob (scenario data, so the whole mixture
    grid is one dispatch group).  A spec without a mixture axis applies
    uniformly and adds no knob."""
    if spec.mix_cohort is None or not spec.mix_fractions:
        return [dict(knobs) for knobs in grid]
    return [dict(knobs, population_mix=mix)
            for knobs in grid for mix in spec.mix_fractions]


def _cached_population(spec, mix, peers, n_levels, uplink_bps, cdn_bps,
                       device=None):
    """The keyword arguments of ``make_scenario`` that the population
    owns (:func:`~engine.population.to_scenario_kwargs`), as tensors on
    ``device``: materialized on the host and moved to the device once per
    (spec, mix, peers, levels, default rates, device), as the joins and
    ranks are."""
    key = ("population", str(device),
           json.dumps(spec.to_json(), sort_keys=True), mix, peers,
           n_levels, uplink_bps, cdn_bps)
    if key not in _ARRAY_CACHE:
        mixed = spec if mix is None else spec.with_mix(mix)
        pop = materialize(mixed, peers, n_levels=n_levels,
                          default_uplink_bps=uplink_bps,
                          default_cdn_bps=cdn_bps)
        dev = resolve_device(device)
        _ARRAY_CACHE[key] = {
            name: torch.from_numpy(np.ascontiguousarray(value)).to(dev)
            for name, value in to_scenario_kwargs(pop).items()}
    return dict(_ARRAY_CACHE[key])


def sample_grid(grid, n):
    """An ``n``-point slice spanning a grid's knob regimes (evenly
    strided through the itertools.product order), the whole grid when
    it holds ≤ ``n`` points."""
    if len(grid) <= n:
        return list(grid)
    return grid[::len(grid) // n][:n]


def journal_meta(grid, *, peers, segments, watch_s, live, seed,
                 record_every, population=None):
    """The sweep identity the crash-safe journal is content-addressed by
    (``engine.artifact_cache.journal_path``): everything that changes
    what a row is, the population spec's JSON included, so a resumed
    sweep never replays another sweep's progress."""
    meta = {"tool": "sweep", "peers": peers, "segments": segments,
            "watch_s": watch_s, "live": bool(live), "seed": seed,
            "record_every": record_every, "grid": grid}
    if population is not None:
        meta["population"] = population.to_json()
    return meta


def build_config(peers, segments, live, degree, live_sync_s=None,
                 eligibility="auto", n_cohorts=0):
    """The static scenario description: the topology degree is the only
    compile-time knob of the reference, and the only config knob of a
    grid point here.  ``live_sync_s`` re-pins the live cushion as a
    config field, as the reference's legacy path does."""
    kwargs = {} if live_sync_s is None else {"live_sync_s": live_sync_s}
    return SwarmConfig(n_peers=peers, n_segments=segments,
                       n_levels=N_LEVELS, live=live,
                       neighbor_offsets=ring_offsets(degree),
                       eligibility=eligibility, n_cohorts=n_cohorts,
                       **kwargs)


def build_scenario(config, knobs, *, watch_s, stagger_s, seed,
                   population=None, join_s=None, device=None):
    """One grid point's scenario on ``device`` (the card when None),
    and its join times ``[P]``, which the rebuffer denominator needs.
    Unless ``join_s`` gives them, a VOD point's joins are
    ``staggered_joins(P, stagger_s, seed)`` and a live point's its join
    wave's (:func:`_live_joins`); ranks are ``stable_ranks(P, seed)``.
    The draws are the reference's threefry draws, so the scenario is
    ``tools/sweep.py``'s at the same seed.

    ``population`` (a ``PopulationSpec``) overlays the point with its
    materialization at ``knobs["population_mix"]`` (when the grid has a
    mixture axis), with the point's supply knobs as the defaults of the
    cohorts that inherit them: the CDN and uplink rates, joins and
    leaves come from the population where it owns them (its joins win
    over ``join_s`` and the live join wave), and ``p2p_ok``,
    ``abr_cap_level``, ``urgent_margin_off_s`` and ``cohort_id`` always.
    A degenerate spec that inherits everything gives the homogeneous
    point's arrays to the bit."""
    peers = config.n_peers
    pop = {}
    if population is not None:
        pop = _cached_population(
            population, knobs.get("population_mix"), peers,
            config.n_levels, knobs["uplink_mbps"] * 1e6,
            knobs["cdn_mbps"] * 1e6, device)
    if "join_s" in pop:
        join_s = pop.pop("join_s")
    elif join_s is None and config.live:
        join_s = _live_joins(peers, knobs.get("join_wave", "steady"),
                            watch_s, device)
    elif join_s is None:
        join_s = _cached("join", staggered_joins, peers, stagger_s, seed,
                         device=device)
    cdn = pop.pop("cdn_bps", None)
    uplink = pop.pop("uplink_bps", None)
    scenario = make_scenario(
        config, padded_ladder(knobs["ladder"]), None,
        _full(peers, knobs["cdn_mbps"] * 1e6, device) if cdn is None
        else cdn, join_s,
        uplink_bps=(_full(peers, knobs["uplink_mbps"] * 1e6, device)
                    if uplink is None else uplink),
        edge_rank=_cached("rank", stable_ranks, peers, seed, device=device),
        urgent_margin_s=knobs["urgent_margin_s"],
        p2p_budget_cap_ms=knobs["budget_cap_ms"],
        live_spread_s=knobs["spread_s"],
        announce_delay_s=knobs.get("announce_delay_s", 0.0),
        live_sync_s=knobs.get("live_sync_s"), device=device, **pop)
    return scenario, scenario.join_s


def _live_joins(peers, wave, watch_s, device=None):
    """A live grid point's joins ``[P]`` (``tools/sweep.py:306-322``):
    ``"steady"`` joins everyone at t = 0; ``"crowd"`` keeps every 4th
    ring index as a seed at t = 0 (interleaved, so every crowd peer has
    seed neighbours) and joins the rest at ``watch_s / 4``, in float32
    as the reference rounds it."""
    if wave != "crowd":
        return _full(peers, 0.0, device)
    is_seed = torch.arange(peers, device=resolve_device(device)) % 4 == 0
    return torch.where(is_seed, _full(peers, 0.0, device),
                       _full(peers, np.float32(watch_s / 4.0), device))


def _full(peers, value, device):
    """A per-peer float32 array of one value, made on the device."""
    return torch.full((peers,), value, dtype=torch.float32,
                      device=resolve_device(device))
