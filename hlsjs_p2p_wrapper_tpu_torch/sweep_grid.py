"""The VOD policy grid that users sweep, and how one grid point becomes
a scenario: copied from the reference's ``tools/sweep.py`` (``LADDERS``
… ``padded_ladder`` :142-170, ``vod_grid`` :184-199, ``build_config``
and ``build_scenario`` :258-333, ``sample_grid`` :339-350), VOD only.

A grid point is a dict of knobs.  Every point of the VOD grid shares
one static ``SwarmConfig`` (the ring degree is the only static knob),
so the whole grid runs as one group of the chunked dispatch
(``ops/dispatch.py``); everything else is scenario data, one lane per
point.  Ladders of different lengths share the config's level count,
padded with ``UNREACHABLE_BITRATE``, a rung the ABR rule never picks.
"""

from __future__ import annotations

import itertools

import torch

from .core.device import resolve_device
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


def sample_grid(grid, n):
    """An ``n``-point slice spanning a grid's knob regimes (evenly
    strided through the itertools.product order), the whole grid when
    it holds ≤ ``n`` points."""
    if len(grid) <= n:
        return list(grid)
    return grid[::len(grid) // n][:n]


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
    """One VOD grid point's scenario on ``device`` (the card when None),
    and its join times ``[P]``, which the rebuffer denominator needs.
    Joins are ``staggered_joins(P, stagger_s, seed)`` unless ``join_s``
    gives them, and ranks ``stable_ranks(P, seed)``: both are the
    reference's threefry draws, so the scenario is ``tools/sweep.py``'s
    at the same seed.  ``watch_s`` is the
    reference's signature; only the live crowd wave reads it."""
    if population is not None:
        raise NotImplementedError(
            "population overlays need the population fields, which are "
            "not ported yet (ROADMAP queue 1 item 9d)")
    if config.live:
        raise NotImplementedError(
            "live grid points are not ported yet (ROADMAP queue 1 item 9c)")
    peers = config.n_peers
    if join_s is None:
        join_s = _cached("join", staggered_joins, peers, stagger_s, seed,
                         device=device)
    scenario = make_scenario(
        config, padded_ladder(knobs["ladder"]), None,
        _full(peers, knobs["cdn_mbps"] * 1e6, device), join_s,
        uplink_bps=_full(peers, knobs["uplink_mbps"] * 1e6, device),
        edge_rank=_cached("rank", stable_ranks, peers, seed, device=device),
        urgent_margin_s=knobs["urgent_margin_s"],
        p2p_budget_cap_ms=knobs["budget_cap_ms"],
        live_spread_s=knobs["spread_s"],
        announce_delay_s=knobs.get("announce_delay_s", 0.0),
        live_sync_s=knobs.get("live_sync_s"), device=device)
    return scenario, scenario.join_s


def _full(peers, value, device):
    """A per-peer float32 array of one value, made on the device."""
    return torch.full((peers,), value, dtype=torch.float32,
                      device=resolve_device(device))
