"""The holder-policy A/B grid of the reference's ``tools/policy_ab.py``,
both halves: its constants (``BITRATE`` … ``WAVES`` :64-76), the
topology memo (``_TOPOLOGY_CACHE`` :78-79), ``build_audience``
(:82-94), ``build_cell_scenario`` (:97-126), the 20 regime cells in the
tool's order (:219-220) and the two topologies' configs (:274-294).

A cell is ``(pattern, wave, uplink_mbps)``: uniform or heterogeneous
uplinks, a staggered audience or a flash crowd, and the mean uplink.
Every cell of one policy shares one static config (262,144 peers on the
degree-8 ring with three transfer slots in the tool), so the 20 cells
run as one group of the chunked dispatch (``ops/dispatch.py``).  The
per-peer draws are the reference's threefry draws (``core/prng.py``),
so a cell's scenario is ``tools/policy_ab.py``'s at the same seed.

Two topologies, each with the three policy columns (``"ranked"``,
``"spread"`` and ``"adaptive"``): the degree-8 ring (circulant offsets,
262,144 peers in the tool) and the random tracker-fed mesh, degree 8
(the general ``[P, K]`` path, :func:`random_config` and
:func:`random_topology`; 8,192 peers in the tool), whose globally
overlapping neighbourhoods make the holder policy matter.
"""

from __future__ import annotations

import torch

from .core.device import resolve_device
from .ops.swarm_sim import (SwarmConfig, make_scenario, random_neighbors,
                            ring_offsets, stable_ranks, staggered_joins)

BITRATE = 800_000.0
UPLINK_GRID_MBPS = (1.2, 1.6, 2.4, 4.0, 10.0)
POLICIES = ("ranked", "spread", "adaptive")
#: "uniform" gives every peer the mean uplink; "hetero" a 10x speed
#: ratio with the arithmetic mean preserved, by a seeded permutation
#: independent of ring position and of the join wave
PATTERNS = ("uniform", "hetero")
#: "stagger": arrivals over 60 s; "crowd": 25% seeds at t = 0 and a 75%
#: flash wave at watch_s / 4
WAVES = ("stagger", "crowd")
#: the tool's ring topology: degree-8 ring, three transfer slots
RING_DEGREE = 8
RING_CONCURRENCY = 3
#: the tool's random mesh: degree 8, and its default peers (--peers)
RANDOM_DEGREE = 8
RANDOM_PEERS = 8_192
#: the tool's defaults: ring peers, segments, watch window, seed
RING_PEERS = 262_144
SEGMENTS = 128
WATCH_S = 240.0
SEED = 0
#: the CDN rate every peer gets
CDN_BPS = 8_000_000.0


def cells():
    """The 20 regime cells ``(pattern, wave, uplink_mbps)`` in the
    tool's order."""
    return [(pattern, wave, up) for pattern in PATTERNS
            for wave in WAVES for up in UPLINK_GRID_MBPS]


def ring_config(peers: int = RING_PEERS, segments: int = SEGMENTS,
                policy: str = "spread") -> SwarmConfig:
    """The tool's ring config for ``policy``, one of :data:`POLICIES`
    (``tools/policy_ab.py:280-284``)."""
    if policy not in POLICIES:
        raise ValueError(f"unknown holder policy {policy!r}")
    return SwarmConfig(n_peers=peers, n_segments=segments, n_levels=1,
                       max_concurrency=RING_CONCURRENCY,
                       holder_selection=policy,
                       neighbor_offsets=ring_offsets(RING_DEGREE))


def random_config(peers: int = RANDOM_PEERS, segments: int = SEGMENTS,
                  policy: str = "spread") -> SwarmConfig:
    """The tool's random-mesh config for ``policy``: the general ``[P,
    K]`` path (no offsets), three slots (``tools/policy_ab.py:286-294``);
    its topology is :func:`random_topology`."""
    if policy not in POLICIES:
        raise ValueError(f"unknown holder policy {policy!r}")
    return SwarmConfig(n_peers=peers, n_segments=segments, n_levels=1,
                       max_concurrency=RING_CONCURRENCY,
                       holder_selection=policy)


#: host-side memo: one random mesh per (peers, seed, device), as the tool
#: keeps one per (peers, seed)
_TOPOLOGY_CACHE = {}


def random_topology(peers: int, seed: int = SEED,
                    device=None) -> torch.Tensor:
    """The tool's random mesh, ``random_neighbors(peers, 8, seed)``, drawn
    once per (peers, seed, device) and shared by every cell and policy
    (``make_scenario`` checks and inverts it on its device once for the
    cells that share it)."""
    dev = resolve_device(device)
    key = (peers, seed, str(dev))
    if key not in _TOPOLOGY_CACHE:
        _TOPOLOGY_CACHE[key] = random_neighbors(peers, RANDOM_DEGREE, seed,
                                                device=dev)
    return _TOPOLOGY_CACHE[key]


def build_audience(peers: int, seed: int = SEED, device=None) -> dict:
    """The seed-only per-peer arrays every cell shares: two independent
    rank draws (the wave split and the speed split) and the staggered
    joins, on ``device`` (the card when None)."""
    return {"wave_ranks": stable_ranks(peers, seed, device=device),
            "speed_ranks": stable_ranks(peers, seed + 1, device=device),
            "stagger_join": staggered_joins(peers, 60.0, seed,
                                            device=device)}


def build_cell_scenario(config: SwarmConfig, audience: dict, *,
                        uplink_bps: float, pattern: str, wave: str,
                        watch_s: float, neighbors=None):
    """One cell's scenario and its join times ``[P]`` (the rebuffer
    denominator), on the audience's device: the wave places the joins,
    the pattern the uplinks, both in float32 as the reference rounds
    them.  ``neighbors`` is the general path's neighbour list
    (:func:`random_topology`); None on the ring."""
    peers = config.n_peers
    ranks = audience["speed_ranks"]
    dev = ranks.device
    if wave == "crowd":
        join = torch.where(audience["wave_ranks"] < 0.25, 0.0,
                           watch_s / 4.0)
    else:
        join = audience["stagger_join"]
    if pattern == "hetero":
        root = 10.0 ** 0.5
        f = 2.0 / (root + 1.0 / root)
        uplink = torch.where(ranks < 0.5, uplink_bps * f / root,
                             uplink_bps * f * root)
    else:
        uplink = torch.full((peers,), uplink_bps, dtype=torch.float32,
                            device=dev)
    scenario = make_scenario(
        config, [BITRATE], neighbors,
        torch.full((peers,), CDN_BPS, dtype=torch.float32, device=dev),
        join, uplink_bps=uplink, device=resolve_device(dev))
    return scenario, join
