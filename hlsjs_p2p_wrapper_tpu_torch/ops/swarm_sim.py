"""Batched swarm+ABR simulator on tensors.

Port of the reference's ``ops/swarm_sim.py`` for its main path: the
circulant step that ``bench.py``'s headline and ``tools/sweep.py``'s
VOD and live grids run.  Per peer: playhead, buffer, quality level, a
dual-EWMA estimator, one foreground transfer slot and a bit-packed
``[P, ceil(L·S/32)]`` per-(level, segment) cache map, stepped every
``dt_ms`` on a degree-K circulant overlay (peer i's neighbours are
``(i + o) mod P``).  A step is two passes (``ops/swarm_kernels.py``):
eligibility, holder selection and admission with uplink share
(``select_admit``), then the per-peer update; on the general ``[P, K]``
topology neighbour k of peer i is ``neighbors[i, k]`` instead.  On the
card each pass is hand-written kernels (one launch each on the main
path); on the CPU each is its plain PyTorch version.

Scenario lanes.  The reference ``vmap``s its scan over a stacked
scenario axis (:func:`run_swarm_batch`); the port writes that axis out.
A stacked state has ``t_s`` of shape ``[B]``, ``[B, P]`` and
``[B, P, C]`` fields and ``avail`` of shape ``[B, P, W]``; a stacked
scenario has its policy scalars as ``[B]`` and ``bitrates`` as
``[B, L]`` (:func:`stack_pytrees`, :func:`lane`).  The step runs on
lanes only: a single scenario is one lane (:func:`as_lanes`, views
that share its storage), so ``swarm_step`` and ``run_swarm`` go through
the batched path at ``B = 1``.  The offload series is written per lane
by the per-peer update's epilogue, the metrics timeline
(``record_every``) by a reduction kernel.

The scan.  On the card :func:`_scan_swarm` captures runs of steps as
CUDA graphs and replays them, the counterpart of the reference's
``jax.lax.scan`` compiled whole; on the CPU it loops eagerly.

What this port covers, and what raises instead:

- both topologies: circulant offsets (``config.neighbor_offsets``) and
  the general ``[P, K]`` neighbour lists (``neighbor_offsets=None`` and
  a ``neighbors`` array, :func:`random_neighbors` and the other topology
  helpers), whose step is TK1, TK2 and TK3 in their gather forms;
- up to 16 transfer slots (``max_concurrency``): slot 0 the foreground
  download, slots 1.. P2P-only prefetches with absorb, the dedup guard,
  abort, cooldown and attempt rotation;
- VOD and live mode (``config.live``: the playhead floor at join, the
  published-only gate, P2P visibility after the announce lag, the edge
  stagger's wait clock ``fg_wait_ms`` and the playback cushion);
- the three holder policies: ``"spread"``, ``"adaptive"`` (its tiers
  by the requester's own load and the per-edge penalty window
  ``holder_penalty_ms``, ``[P, K]``, zero-width under the other two) and
  ``"ranked"`` (announce order, by peer id);
- an admission cap (``max_total_serves > 0``) and the uncapped fair
  share (``max_total_serves <= 0``: every demand is admitted, so no BUSY
  deny and no admission abort);
- the population fields of a scenario (``p2p_ok``, ``abr_cap_level``,
  ``urgent_margin_off_s``, ``cohort_id``; ``engine/population.py``
  materializes them) and, with ``config.n_cohorts > 0``, the timeline's
  three per-cohort columns (present peers, interval stalls, cumulative
  offload).

Bit-packed words (``avail``, ``dl_flags``) are stored as ``int32``
tensors holding the u32 bit pattern: PyTorch's ``uint32`` has no
shift, add or ``%``.  AND, OR and equality are pattern-exact on int32;
shifts and the hash run in int64 masked to 32 bits.

Entry points run on the card unless the caller passes
``device="cpu"``; with no card and no device they raise.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import prng
from ..core.abr import (BANDWIDTH_SAFETY, DEFAULT_FAST_HALF_LIFE_S,
                        DEFAULT_SLOW_HALF_LIFE_S)
from ..core.device import resolve_device
from ..engine.digest import DEFAULT_EDGES
from .ewma import EwmaState

NEVER_S = 1e18  # "leave" time of a peer that never departs

#: ladder pad value for one-compile multi-ladder sweeps: a level that
#: never fits under any estimate is never chosen by the ABR rule
UNREACHABLE_BITRATE = 1e18

U32_MASK = 0xFFFFFFFF

#: fraction of the device's free memory the chunk autotuner commits
#: to one dispatch's ``[B, P, …]`` lanes (the reference's value)
AUTOTUNE_MEMORY_FRACTION = 0.5
#: budget where the device reports no free memory (the CPU): a
#: conservative host-RAM allowance
AUTOTUNE_FALLBACK_BYTES = 4 << 30
#: autotuner ceiling: lanes beyond this stop amortizing per-dispatch
#: overhead but keep growing the time to the first row
MAX_AUTOTUNE_CHUNK = 64

#: bisected OOMs this process has seen (the dispatch's recovery calls
#: :func:`note_oom_bisection`): each halves the memory fraction later
#: :func:`autotune_chunk` calls commit, down to 1/16 of the base
_OOM_BISECTIONS = 0


def note_oom_bisection() -> None:
    """Record one OOM-triggered chunk bisection."""
    global _OOM_BISECTIONS
    _OOM_BISECTIONS += 1


def oom_bisections() -> int:
    return _OOM_BISECTIONS


def reset_oom_feedback() -> None:
    """Forget recorded OOM bisections."""
    global _OOM_BISECTIONS
    _OOM_BISECTIONS = 0


def autotune_memory_fraction() -> float:
    """The memory fraction :func:`autotune_chunk` commits, halved per
    bisected OOM of this process (at most four times): a bisected OOM
    means the footprint model under-counted, so trust it less."""
    return AUTOTUNE_MEMORY_FRACTION * (0.5 ** min(_OOM_BISECTIONS, 4))


class SwarmConfig(NamedTuple):
    """Static scenario description; the fields, their order and their
    defaults are the reference's (pinned by a test).  The policy values
    are defaults that :func:`make_scenario` copies into scenario
    scalars.  See the reference's ``SwarmConfig`` for each field."""

    n_peers: int
    n_segments: int
    n_levels: int
    neighbor_offsets: Optional[Tuple[int, ...]] = None
    max_concurrency: int = 1
    holder_selection: str = "spread"
    max_total_serves: int = 2
    seg_duration_s: float = 4.0
    dt_ms: float = 250.0
    max_buffer_s: float = 30.0
    p2p_bps: float = 20_000_000.0
    fast_half_life_s: float = DEFAULT_FAST_HALF_LIFE_S
    slow_half_life_s: float = DEFAULT_SLOW_HALF_LIFE_S
    live: bool = False
    live_sync_s: float = 12.0
    live_spread_s: float = 0.0
    urgent_margin_s: float = 4.0
    p2p_budget_fraction: float = 0.5
    p2p_budget_cap_ms: float = 6_000.0
    p2p_budget_floor_ms: float = 500.0
    request_timeout_ms: float = 8_000.0
    announce_delay_s: float = 0.0
    p2p_setup_ms: float = 16.0
    uplink_efficiency: float = 0.97
    retry_dead_ms: float = 200.0
    holder_penalty_ms: float = 3_000.0
    eligibility: str = "auto"
    n_cohorts: int = 0
    stall_digest: bool = False


class SwarmScenario(NamedTuple):
    """Per-peer scenario arrays (``[P]`` except as noted) plus the
    dynamic policy scalars (0-dim float32 tensors on the device, read
    by the kernels through pointers).  Same fields and order as the
    reference."""

    bitrates: torch.Tensor      # [L] bits/s ladder
    neighbors: torch.Tensor     # [P, K] i32; row i = whom i downloads
    #                             from (self entries are padding); [P, 0]
    #                             in circulant mode
    in_edges: torch.Tensor      # [P, K_in] i32; row j = the flat slots
    #                             i·K + k pointing at j (-1 = padding),
    #                             :func:`invert_neighbors`; [P, 0] in
    #                             circulant mode
    cdn_bps: torch.Tensor       # [P] per-peer CDN rate
    uplink_bps: torch.Tensor    # [P] per-peer serving capacity
    join_s: torch.Tensor        # [P] arrival time
    leave_s: torch.Tensor       # [P] departure time (NEVER_S = stays)
    edge_rank: torch.Tensor     # [P] in [0,1): live CDN stagger rank
    urgent_margin_s: torch.Tensor
    p2p_budget_fraction: torch.Tensor
    p2p_budget_cap_ms: torch.Tensor
    p2p_budget_floor_ms: torch.Tensor
    live_spread_s: torch.Tensor
    request_timeout_ms: torch.Tensor
    announce_delay_s: torch.Tensor
    p2p_setup_ms: torch.Tensor
    uplink_efficiency: torch.Tensor
    retry_dead_ms: torch.Tensor
    holder_penalty_ms: torch.Tensor
    live_sync_s: torch.Tensor
    p2p_ok: torch.Tensor             # [P] f32 0/1 connectivity class
    abr_cap_level: torch.Tensor      # [P] i32 device ladder cap
    urgent_margin_off_s: torch.Tensor  # [P] f32 urgency offset
    cohort_id: torch.Tensor          # [P] i32 (observability only)


class SwarmState(NamedTuple):
    """Swarm state; the leading axis of every per-peer field is
    ``[P]``.  Same fields and order as the reference.  ``avail`` is the
    ``[P, W]`` bit-packed cache map and ``dl_flags`` the ``[P]`` packed
    slot-flag word (bit ``2c`` active, ``2c + 1`` is_p2p), both int32
    tensors holding u32 bit patterns."""

    t_s: torch.Tensor             # [] f32 scenario clock
    playhead_s: torch.Tensor      # [P] f32
    buffer_s: torch.Tensor        # [P] f32
    rebuffer_s: torch.Tensor      # [P] f32
    level: torch.Tensor           # [P] i32 current ABR choice
    ewma: EwmaState               # fields [P] f32
    avail: torch.Tensor           # [P, W] u32 bits in int32
    cdn_bytes: torch.Tensor       # [P] f32
    p2p_bytes: torch.Tensor       # [P] f32
    dl_flags: torch.Tensor        # [P] u32 bits in int32
    dl_seg: torch.Tensor          # [P, C] i32
    dl_level: torch.Tensor        # [P, C] i32
    dl_done_bytes: torch.Tensor   # [P, C] f32
    dl_total_bytes: torch.Tensor  # [P, C] f32
    dl_elapsed_ms: torch.Tensor   # [P, C] f32
    dl_budget_ms: torch.Tensor    # [P, C] f32
    dl_cooldown_ms: torch.Tensor  # [P, C] f32
    dl_attempts: torch.Tensor     # [P, C] i32
    fg_wait_ms: torch.Tensor      # [P] f32
    holder_penalty_ms: torch.Tensor  # [P, K] f32 (K = 0 unless adaptive)
    dl_holder_off: torch.Tensor   # [P, C] i32


# ---- int32 storage of u32 bit patterns ------------------------------------

def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 tensors with the same bits."""
    x = x & U32_MASK
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → their u32 values, as int64."""
    return x.to(torch.int64) & U32_MASK


@functools.lru_cache(maxsize=None)
def _bit_table(device: torch.device) -> torch.Tensor:
    """``[32]`` int32 table of ``1 << b`` bit patterns (made once per
    device)."""
    return torch.from_numpy(
        (np.uint32(1) << np.arange(32, dtype=np.uint32)).view(np.int32)
    ).to(device)


# ---- lanes: the stacked scenario axis --------------------------------------

def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of one or more like-shaped state or
    scenario tuples (the ``ewma`` field nested), rebuilt as the first
    one's type."""
    if isinstance(tree, tuple):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    return fn(tree, *rest)


def stack_pytrees(items):
    """Stack same-shaped states or scenarios along a new leading lane
    axis (copies), the host-side assembly step for
    :func:`run_swarm_batch`."""
    items = list(items)
    if not items:
        raise ValueError("cannot stack an empty scenario batch")
    return tree_map(lambda *xs: torch.stack(xs), *items)


def lane(tree, b: int):
    """Lane ``b`` of a stacked state or scenario, as views."""
    return tree_map(lambda x: x[b], tree)


def as_lanes(tree):
    """A single state or scenario as one lane: views with a leading
    axis of 1 that share its storage, so an in-place step of the lanes
    updates it."""
    return tree_map(lambda x: x.unsqueeze(0), tree)


def is_lanes(state: SwarmState) -> bool:
    """Whether ``state`` is stacked (``t_s`` of shape ``[B]``) rather
    than a single scenario's (``t_s`` 0-dim)."""
    return state.t_s.dim() == 1


# ---- scenario and state -------------------------------------------------

def make_scenario(config: SwarmConfig, bitrates, neighbors, cdn_bps,
                  join_s=None, *, uplink_bps=None, leave_s=None,
                  edge_rank=None, urgent_margin_s=None,
                  p2p_budget_fraction=None, p2p_budget_cap_ms=None,
                  p2p_budget_floor_ms=None, live_spread_s=None,
                  request_timeout_ms=None,
                  announce_delay_s=None, p2p_setup_ms=None,
                  uplink_efficiency=None,
                  retry_dead_ms=None,
                  holder_penalty_ms=None,
                  live_sync_s=None, p2p_ok=None, abr_cap_level=None,
                  urgent_margin_off_s=None,
                  cohort_id=None, device=None) -> SwarmScenario:
    """Normalize optional arrays to their defaults (everyone joins at
    t=0, never leaves, serves at the downlink cap, rank 0) and policy
    scalars to the config's values, as 0-dim float32 tensors on
    ``device``.  With ``config.neighbor_offsets`` set (circulant mode)
    ``neighbors`` is None (or a ``[P, 0]`` placeholder); without, it is
    the ``[P, K]`` neighbour list, checked and inverted into the inbound
    edge lists (:func:`invert_neighbors`) on ``device``.  Refused,
    besides the reference's refusals: entries outside ``[0, P)``, and
    under ``"ranked"`` a row that names one peer twice (the reference's
    pick then rides both edges and stores the sum of their indices as
    its holder)."""
    dev = resolve_device(device)
    P = config.n_peers
    if neighbors is None:
        if config.neighbor_offsets is None:
            raise ValueError("neighbors=None requires "
                             "config.neighbor_offsets (circulant mode)")
        neighbors = torch.zeros((P, 0), dtype=torch.int32)
    elif not torch.is_tensor(neighbors):
        neighbors = np.asarray(neighbors)
    if config.neighbor_offsets is not None and neighbors.shape[-1] > 0:
        raise ValueError(
            "both config.neighbor_offsets and a neighbors array were "
            "given; pass neighbors=None for circulant mode, or unset "
            "neighbor_offsets to use the [P, K] topology")
    if len(neighbors.shape) != 2 or neighbors.shape[0] != P:
        raise ValueError(f"neighbors of shape {tuple(neighbors.shape)}, "
                         f"expected ({P}, K)")
    neighbors = (neighbors.to(device=dev, dtype=torch.int32)
                 if torch.is_tensor(neighbors)
                 else torch.from_numpy(neighbors.astype(np.int32)).to(dev))
    if neighbors.shape[-1] == 0:
        # no edges: the inverse is [P, 0] too (circulant mode)
        in_edges = torch.zeros((P, 0), dtype=torch.int32, device=dev)
    else:
        in_edges = _checked_inverse(config, neighbors)

    def f32(value):
        return torch.from_numpy(np.array(value, np.float32)).to(dev)

    def i32(value):
        return torch.from_numpy(np.array(value, np.int32)).to(dev)

    def scalar(value, default):
        return f32(_np(default if value is None else value)).reshape(())

    def per_peer(value, fill, conv=f32):
        if value is None:
            return conv(np.full((P,), fill))
        if torch.is_tensor(value):   # no round trip through the host
            out = value.to(device=dev, dtype=(torch.int32 if conv is i32
                                              else torch.float32))
        else:
            out = conv(_np(value))
        if tuple(out.shape) != (P,):
            raise ValueError(f"per-peer array of shape {tuple(out.shape)},"
                             f" expected ({P},)")
        return out

    scen = SwarmScenario(
        bitrates=f32(_np(bitrates)),
        neighbors=neighbors,
        in_edges=in_edges,
        cdn_bps=per_peer(cdn_bps, 0.0),
        uplink_bps=per_peer(uplink_bps, config.p2p_bps),
        join_s=per_peer(join_s, 0.0),
        leave_s=per_peer(leave_s, NEVER_S),
        edge_rank=per_peer(edge_rank, 0.0),
        urgent_margin_s=scalar(urgent_margin_s, config.urgent_margin_s),
        p2p_budget_fraction=scalar(p2p_budget_fraction,
                                   config.p2p_budget_fraction),
        p2p_budget_cap_ms=scalar(p2p_budget_cap_ms,
                                 config.p2p_budget_cap_ms),
        p2p_budget_floor_ms=scalar(p2p_budget_floor_ms,
                                   config.p2p_budget_floor_ms),
        live_spread_s=scalar(live_spread_s, config.live_spread_s),
        request_timeout_ms=scalar(request_timeout_ms,
                                  config.request_timeout_ms),
        announce_delay_s=scalar(announce_delay_s,
                                config.announce_delay_s),
        p2p_setup_ms=scalar(p2p_setup_ms, config.p2p_setup_ms),
        uplink_efficiency=scalar(uplink_efficiency,
                                 config.uplink_efficiency),
        retry_dead_ms=scalar(retry_dead_ms, config.retry_dead_ms),
        holder_penalty_ms=scalar(holder_penalty_ms,
                                 config.holder_penalty_ms),
        live_sync_s=scalar(live_sync_s, config.live_sync_s),
        p2p_ok=per_peer(p2p_ok, 1.0),
        abr_cap_level=per_peer(abr_cap_level, config.n_levels - 1,
                               i32),
        urgent_margin_off_s=per_peer(urgent_margin_off_s, 0.0),
        cohort_id=per_peer(cohort_id, 0, i32))
    ok = scen.p2p_ok
    if not bool(torch.all((ok == 0.0) | (ok == 1.0))):
        raise ValueError("p2p_ok must be a 0/1 mask")
    return scen


def _np(value):
    """A host copy of an array-like (tensors included), or None."""
    if value is None:
        return None
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def packed_words(config: SwarmConfig) -> int:
    """u32 words per peer in the bit-packed cache map."""
    return -(-(config.n_levels * config.n_segments) // 32)


def pack_dl_flags(active_cols, is_p2p_cols) -> torch.Tensor:
    """Pack per-slot ``[P]`` bool columns into the ``[P]`` transfer-flag
    word (bit ``2c`` = slot c active, ``2c + 1`` = slot c is_p2p), as
    an int32 tensor holding the u32 pattern."""
    flags = None
    for c, (act, p2p) in enumerate(zip(active_cols, is_p2p_cols)):
        word = ((act.to(torch.int64) << (2 * c))
                | (p2p.to(torch.int64) << (2 * c + 1)))
        flags = word if flags is None else flags | word
    if flags is None:
        raise ValueError("cannot pack zero transfer slots")
    return u32_to_i32(flags)


def unpack_dl_flags(flags: torch.Tensor, n_slots: int):
    """Expand the packed flag word into (``active``, ``is_p2p``) lists
    of per-slot ``[P]`` bool columns."""
    word = i32_to_u32(flags)
    active = [((word >> (2 * c)) & 1) != 0 for c in range(n_slots)]
    is_p2p = [((word >> (2 * c + 1)) & 1) != 0 for c in range(n_slots)]
    return active, is_p2p


def unpack_avail(state: SwarmState, config: SwarmConfig) -> torch.Tensor:
    """Expand the bit-packed cache map to a ``[P, L, S]`` uint8 0/1
    tensor (analysis and tests; the step never builds it)."""
    P, L, S = config.n_peers, config.n_levels, config.n_segments
    words = i32_to_u32(state.avail)
    bit = torch.arange(L * S, device=words.device)
    cells = ((words[:, bit >> 5] >> (bit & 31)) & 1) != 0
    return cells.to(torch.uint8).reshape(P, L, S)


def init_swarm(config: SwarmConfig, n_neighbors: Optional[int] = None,
               device=None, batch: Optional[int] = None) -> SwarmState:
    """Zero state on ``device``; with ``batch``, ``batch`` stacked lanes
    of it (``[B, …]`` zeros, built directly).  Only ``"adaptive"``
    carries a non-empty per-edge penalty field, ``[P, K]`` (``[B, P,
    K]`` batched) with K the normalized offsets, or on the general
    ``[P, K]`` path ``n_neighbors`` (pass ``neighbors.shape[-1]``; without
    it the field is empty, and ``run_swarm`` resizes it)."""
    dev = resolve_device(device)
    P = config.n_peers
    C = config.max_concurrency
    lead = () if batch is None else (batch,)
    if config.holder_selection != "adaptive":
        n_neighbors = 0
    elif n_neighbors is None:
        n_neighbors = (len(_normalized_offsets(config.neighbor_offsets, P))
                       if config.neighbor_offsets is not None else 0)
    if C > 16:
        raise ValueError(f"max_concurrency={C} exceeds the 16 slots "
                         f"the packed dl_flags word carries (2 bits "
                         f"per slot in one u32)")

    def f(*shape):
        return torch.zeros(lead + shape, dtype=torch.float32, device=dev)

    def i(*shape):
        return torch.zeros(lead + shape, dtype=torch.int32, device=dev)

    return SwarmState(
        t_s=f(), playhead_s=f(P), buffer_s=f(P), rebuffer_s=f(P),
        level=i(P), ewma=EwmaState(f(P), f(P), f(P), f(P)),
        avail=i(P, packed_words(config)), cdn_bytes=f(P), p2p_bytes=f(P),
        dl_flags=i(P), dl_seg=i(P, C), dl_level=i(P, C),
        dl_done_bytes=f(P, C), dl_total_bytes=f(P, C),
        dl_elapsed_ms=f(P, C), dl_budget_ms=f(P, C),
        dl_cooldown_ms=f(P, C), dl_attempts=i(P, C), fg_wait_ms=f(P),
        holder_penalty_ms=f(P, n_neighbors), dl_holder_off=i(P, C))


def clone_state(state: SwarmState) -> SwarmState:
    """A deep copy (the step updates its state in place)."""
    return tree_map(torch.clone, state)


# ---- eligibility helpers ----------------------------------------------------

def _abr_pick(estimate_bps: torch.Tensor,
              bitrates: torch.Tensor) -> torch.Tensor:
    """Highest level whose bitrate fits under the safety-scaled
    estimate, else 0 (core/abr.py next_level).  ``estimate_bps`` is
    ``[..., P]`` and ``bitrates`` the matching ``[..., L]`` ladder."""
    fits = (bitrates.unsqueeze(-2)
            <= (estimate_bps * BANDWIDTH_SAFETY).unsqueeze(-1))
    idx = torch.arange(bitrates.shape[-1], dtype=torch.int32,
                       device=bitrates.device)
    zero = torch.zeros((), dtype=torch.int32, device=bitrates.device)
    return torch.amax(torch.where(fits, idx, zero), dim=-1)


def resolve_eligibility(config: SwarmConfig,
                        device: Optional[torch.device] = None) -> str:
    """The concrete circulant formulation: ``config.eligibility``, with
    ``"auto"`` resolved by the tensors' device — ``"stencil"`` on the
    card, ``"kpass"`` on the CPU.  Both are bit-identical, so the
    choice never changes a result.  Unknown values raise."""
    if config.eligibility in ("stencil", "kpass"):
        return config.eligibility
    if config.eligibility != "auto":
        raise ValueError(f"unknown eligibility {config.eligibility!r}")
    dev = torch.device("cpu") if device is None else torch.device(device)
    return "stencil" if dev.type == "cuda" else "kpass"


def bit_mask_words(gi_flat: torch.Tensor, n_words: int) -> torch.Tensor:
    """One-hot ``[..., P, W]`` mask (int32 bit patterns) selecting each
    peer's flat (level, seg) bit in the packed map — the cache-insert
    position and the "kpass" AND operand."""
    wcol = torch.arange(n_words, dtype=torch.int32, device=gi_flat.device)
    word_idx = gi_flat >> 5
    bitmask = _bit_table(gi_flat.device)[(gi_flat & 31).long()]
    zero = torch.zeros((), dtype=torch.int32, device=gi_flat.device)
    return torch.where(wcol == word_idx.unsqueeze(-1),
                       bitmask.unsqueeze(-1), zero)


def circulant_eligibility(avail_p: torch.Tensor, present: torch.Tensor,
                          offs, gi_flats, *, impl: str = "stencil"):
    """Circulant-path eligibility for every transfer slot at once, on
    one scenario (``avail_p`` ``[P, W]``) or on lanes (``[B, P, W]``):
    every roll is along the peer axis, so a lane never sees another's
    peers.

    ``gi_flats`` lists each slot's ``[P]`` flat (level·S + seg) target
    bit; returns one ``(elig, n_holders, own)`` triple per slot:
    ``elig`` = K × ``[P]`` 0/1 float32 per-offset eligibility ("my
    k-th neighbour ``(i + o_k) mod P`` holds my bit and is present"),
    ``n_holders`` their sum, ``own`` the peer's own-cache bit test.

    ``impl="stencil"`` extracts every wanted word with one shared
    gather over the map, then finishes with ``[P]``-vector rolls and
    bit tests; ``impl="kpass"`` rolls the presence-masked map once per
    offset.  Bit-identical by construction; both are held to the
    reference's NumPy oracle by the tests."""
    dev = avail_p.device
    zeros = torch.zeros(present.shape, dtype=torch.float32, device=dev)
    table = _bit_table(dev)
    bitmasks = [table[(gf & 31).long()] for gf in gi_flats]
    if impl == "kpass":
        AP = torch.where(present.unsqueeze(-1), avail_p,
                         torch.zeros((), dtype=avail_p.dtype, device=dev))
        out = []
        for gf in gi_flats:
            Wm = bit_mask_words(gf, avail_p.shape[-1])
            elig = [torch.sum((torch.roll(AP, -o, -2) & Wm) != 0, dim=-1,
                              dtype=torch.int32).to(torch.float32)
                    for o in offs]
            n = sum(elig) if elig else zeros
            own = torch.any((avail_p & Wm) != 0, dim=-1)
            out.append((elig, n, own))
        return out
    if impl != "stencil":
        raise ValueError(f"unknown eligibility {impl!r}")
    cols = []
    for gf in gi_flats:
        wi = gf >> 5
        cols.append(wi)
        cols.extend(torch.roll(wi, o, -1) for o in offs)
    wanted = torch.stack(cols, dim=-1).long()            # [..., P, M]
    ext = torch.gather(avail_p, -1, wanted)              # [..., P, M] words
    pres_ro = {o: torch.roll(present, -o, -1) for o in dict.fromkeys(offs)}
    stride = 1 + len(offs)
    out = []
    for c, bm in enumerate(bitmasks):
        base = c * stride
        own = (ext[..., base] & bm) != 0
        elig = []
        for k, o in enumerate(offs):
            word = torch.roll(ext[..., base + 1 + k], -o, -1)
            have = (word & bm) != 0
            elig.append((have & pres_ro[o]).to(torch.float32))
        n = sum(elig) if elig else zeros
        out.append((elig, n, own))
    return out


def gather_eligibility(avail_p: torch.Tensor, present: torch.Tensor,
                       neighbors: torch.Tensor, gi_flats):
    """General-path eligibility (reference :859-866, :907-917) for
    every transfer slot, on one scenario (``avail_p`` ``[P, W]``,
    ``neighbors`` ``[P, K]``) or on lanes (a leading ``[B]``): neighbour
    k of peer i is ``neighbors[..., i, k]``, a lane-local id, and a self
    entry is padding.  Returns what :func:`circulant_eligibility`
    returns, one ``(elig, n_holders, own)`` triple per slot with ``elig``
    a list of K ``[..., P]`` 0/1 float32 columns (``nbr_valid · have ·
    present_nbr``) and ``n_holders`` their sum."""
    dev = avail_p.device
    P, W = avail_p.shape[-2:]
    K = neighbors.shape[-1]
    lead = tuple(avail_p.shape[:-2])
    peer = torch.arange(P, dtype=neighbors.dtype, device=dev)
    valid = (neighbors != peer[:, None]).to(torch.float32)
    nbr = neighbors.long().reshape(lead + (P * K,))
    present_nbr = torch.gather(present.to(torch.float32), -1, nbr).reshape(
        neighbors.shape)
    words = avail_p.reshape(lead + (P * W,))
    table = _bit_table(dev)
    zeros = torch.zeros(present.shape, dtype=torch.float32, device=dev)
    out = []
    for gf in gi_flats:
        wi = (gf >> 5).long()
        bitmask = table[(gf & 31).long()]
        got = torch.gather(words, -1, (nbr.reshape(neighbors.shape) * W
                                       + wi.unsqueeze(-1)).reshape(
                                           lead + (P * K,)))
        have = ((got.reshape(neighbors.shape) & bitmask.unsqueeze(-1)) != 0)
        elig = valid * have.to(torch.float32) * present_nbr
        own = (torch.gather(avail_p, -1, wi.unsqueeze(-1))[..., 0]
               & bitmask) != 0
        cols = list(elig.unbind(-1))
        out.append((cols, torch.sum(elig, dim=-1) if K else zeros, own))
    return out


# ---- the step -------------------------------------------------------------

def check_slice(config: SwarmConfig) -> None:
    """Raise for a configuration the port does not run: an unknown
    holder policy or eligibility formulation, or more transfer slots
    than the packed flag word carries."""
    if config.holder_selection not in ("adaptive", "spread", "ranked"):
        raise ValueError(f"unknown holder_selection "
                         f"{config.holder_selection!r}")
    if config.eligibility not in ("auto", "stencil", "kpass"):
        raise ValueError(f"unknown eligibility {config.eligibility!r}")
    if not 1 <= config.max_concurrency <= 16:
        raise ValueError(f"max_concurrency={config.max_concurrency} is "
                         f"outside 1..16, the slots the packed dl_flags "
                         f"word carries (2 bits per slot in one u32)")


def _check_step(config: SwarmConfig, scenario: SwarmScenario,
                state: SwarmState) -> None:
    """:func:`check_slice`, and the reference's width check of the
    penalty field (:868-876): K wide under ``"adaptive"``, else 0, with
    K from the offsets or, on the general path, the scenario."""
    check_slice(config)
    width = _penalty_width(config, scenario)
    if state.holder_penalty_ms.shape[-1] != width:
        raise ValueError(
            f"state.holder_penalty_ms is sized for "
            f"{state.holder_penalty_ms.shape[-1]} neighbors but this "
            f"config needs {width} (non-adaptive policies carry a "
            f"zero-width field): on the [P, K] path build the state with "
            f"init_swarm(config, n_neighbors=K), or let run_swarm resize "
            f"a pristine state")


def _step(config: SwarmConfig, scenario: SwarmScenario, state: SwarmState,
          series=None, column: int = 0) -> torch.Tensor:
    """One step in place: ``select_admit``, then ``peer_update``, which
    also sums the byte counters, with ``series`` writes the offload
    ratio into ``series[:, column]``, and advances the clock.  Returns
    the step's ``[B, 2]`` (cdn, p2p) sums."""
    from . import swarm_kernels as sk
    flags, req, service, adm = sk.select_admit(config, scenario, state)
    return sk.peer_update(config, scenario, state, flags, req, service, adm,
                          series=series, column=column)


def swarm_step(config: SwarmConfig, scenario: SwarmScenario,
               state: SwarmState) -> SwarmState:
    """One ``dt_ms`` tick for every peer, of one scenario or of every
    lane of a stacked one.  Two passes: eligibility, holder selection,
    admission and service (``select_admit``), then the per-peer update
    (``ops/swarm_kernels.py``; on the general ``[P, K]`` path three
    launches: TK1, TK2 and TK3 in their gather forms).  On a CUDA state
    each pass launches its kernel over all lanes at once; on a CPU state
    the plain PyTorch versions run.

    The state's tensors, the clock ``t_s`` included, are updated IN
    PLACE (the clock's float32 add is the reference's), and the state
    is returned: clone a state (:func:`clone_state`) to keep it."""
    _check_step(config, scenario, state)
    _step(config, scenario, state)
    return state


#: steps per CUDA graph of a scan without a timeline; with one, a graph
#: is one interval of ``record_every`` steps and its row.  40 steps keep
#: a replay's host work (the replay and one copy of the series) small
#: beside its device time, and a capture (one host pass over the steps)
#: short
GRAPH_STEPS = 40


def _scan_swarm(config: SwarmConfig, scenario: SwarmScenario,
                state: SwarmState, n_steps: int, record_every: int = 0):
    """``n_steps`` steps: the shared body of every entry point, the
    reference's scanned step.  Returns ``(final state, offload series
    [..., n_steps])``; ``record_every=N > 0`` appends the metrics
    timeline ``[..., n_steps // N, M]`` (:func:`timeline_columns`), one
    row at the end of each N-step interval, and trailing steps past the
    last full interval still run.  Updates ``state`` in place.  A single
    scenario runs as one lane and gets its outputs back without the
    lane axis.

    On the card the steps run as CUDA graphs, the port's counterpart of
    the reference's compiled scan: a run of steps (one interval with a
    timeline, else :data:`GRAPH_STEPS`; the trailing steps a graph of
    their own) is captured once and replayed, so the host does no work
    per step.  A failed capture or replay raises; nothing falls back to
    the eager loop.  On the CPU it is the eager loop
    (:func:`_scan_eager`)."""
    from . import swarm_kernels as sk
    graph = sk.graph_path(state.t_s.device)
    return _scan(config, scenario, state, n_steps, record_every, graph)


def _scan_eager(config: SwarmConfig, scenario: SwarmScenario,
                state: SwarmState, n_steps: int, record_every: int = 0):
    """:func:`_scan_swarm` as a Python loop of eager steps on any
    device: the CPU path, and on the card the run the graphs are held
    against (the same kernels, launched one by one)."""
    return _scan(config, scenario, state, n_steps, record_every, False)


def _scan(config, scenario, state, n_steps, record_every, graph):
    from . import swarm_kernels as sk
    if record_every < 0:
        raise ValueError(f"record_every must be >= 0, got {record_every}")
    _check_step(config, scenario, state)
    single = not is_lanes(state)
    if single:
        scenario, state = as_lanes(scenario), as_lanes(state)
    B, dev = state.t_s.shape[0], state.t_s.device
    series = torch.empty((B, n_steps), dtype=torch.float32, device=dev)
    timeline = ()
    row = None
    if record_every:
        M = len(timeline_columns(config))
        timeline = (torch.empty((B, n_steps // record_every, M),
                                dtype=torch.float32, device=dev),)
        prev_sums = sk.lane_sums(state)
        prev_reb = state.rebuffer_s.clone()

        def row(sums, out, sample):
            sk.timeline_row(config, scenario, state, sums, prev_sums,
                            prev_reb, out, sample, record_every)
    if graph:
        _replay_steps(config, scenario, state, n_steps, record_every, row,
                      series, timeline)
    else:
        for s in range(n_steps):
            sums = _step(config, scenario, state, series, s)
            if record_every and (s + 1) % record_every == 0:
                row(sums, timeline[0], (s + 1) // record_every - 1)
    out = (state, series) + timeline
    return tuple(lane(x, 0) for x in out) if single else out


def _replay_steps(config, scenario, state, n_steps, record_every, row,
                  series, timeline):
    """The steps of :func:`_scan` as replayed CUDA graphs.  A graph
    bakes its launches' arguments, so every step of one graph writes its
    series column, and the interval its row, into fixed scratch
    (``[B, G]``, ``[B, 1, M]``), which a copy after each replay moves
    into place; the state, the clock and the timeline's carried sums are
    updated in place at fixed addresses."""
    from . import swarm_kernels as sk
    B, dev = state.t_s.shape[0], state.t_s.device
    G = record_every or GRAPH_STEPS
    series_g = torch.empty((B, G), dtype=torch.float32, device=dev)
    row_g = (torch.empty((B, 1, timeline[0].shape[-1]), dtype=torch.float32,
                         device=dev) if record_every else None)
    graphs = {}
    done = 0
    while done < n_steps:
        n = min(G, n_steps - done)
        if n not in graphs:
            def steps(n=n):
                for s in range(n):
                    sums = _step(config, scenario, state, series_g, s)
                if n == record_every:
                    row(sums, row_g, 0)
            pool = next(iter(graphs.values())).pool if graphs else None
            graphs[n] = sk.capture(steps, dev, B, config.n_peers, pool)
        graphs[n].replay()
        series[:, done:done + n].copy_(series_g[:, :n])
        if n == record_every:
            timeline[0][:, done // record_every].copy_(row_g[:, 0])
        done += n


def run_swarm(config: SwarmConfig, bitrates, neighbors, cdn_bps,
              state: SwarmState, n_steps: int, join_s=None, *,
              uplink_bps=None, leave_s=None, edge_rank=None,
              urgent_margin_s=None, p2p_budget_fraction=None,
              p2p_budget_cap_ms=None, p2p_budget_floor_ms=None,
              live_spread_s=None, request_timeout_ms=None,
              announce_delay_s=None, p2p_setup_ms=None,
              uplink_efficiency=None, retry_dead_ms=None,
              holder_penalty_ms=None, live_sync_s=None,
              p2p_ok=None, abr_cap_level=None,
              urgent_margin_off_s=None, cohort_id=None,
              record_every: int = 0, device=None):
    """Step ``n_steps`` ticks; returns (final state, offload-over-time
    ``[n_steps]``), plus the ``[n_steps // record_every, M]`` metrics
    timeline when ``record_every > 0`` (see :func:`_scan_swarm`).  Runs
    on ``device`` — the card when None — and leaves the caller's
    ``state`` untouched (it steps a copy)."""
    dev = resolve_device(device)
    check_slice(config)
    scenario = make_scenario(
        config, bitrates, neighbors, cdn_bps, join_s,
        uplink_bps=uplink_bps, leave_s=leave_s, edge_rank=edge_rank,
        urgent_margin_s=urgent_margin_s,
        p2p_budget_fraction=p2p_budget_fraction,
        p2p_budget_cap_ms=p2p_budget_cap_ms,
        p2p_budget_floor_ms=p2p_budget_floor_ms,
        live_spread_s=live_spread_s,
        request_timeout_ms=request_timeout_ms,
        announce_delay_s=announce_delay_s, p2p_setup_ms=p2p_setup_ms,
        uplink_efficiency=uplink_efficiency, retry_dead_ms=retry_dead_ms,
        holder_penalty_ms=holder_penalty_ms, live_sync_s=live_sync_s,
        p2p_ok=p2p_ok, abr_cap_level=abr_cap_level,
        urgent_margin_off_s=urgent_margin_off_s, cohort_id=cohort_id,
        device=dev)
    state = tree_map(lambda t: t.to(dev, copy=True), state)
    state = ensure_penalty_width(config, scenario, state)
    return _scan_swarm(config, scenario, state, n_steps,
                       record_every=record_every)


def run_swarm_scenario(config: SwarmConfig, scenario: SwarmScenario,
                       state: SwarmState, n_steps: int,
                       record_every: int = 0):
    """Step one pre-built scenario (the :func:`make_scenario` output):
    the sequential path the batched one is held against.  Returns what
    :func:`run_swarm` returns.  Unlike :func:`run_swarm`, it steps
    ``state`` itself, in place."""
    state = ensure_penalty_width(config, scenario, state)
    return _scan_swarm(config, scenario, state, n_steps,
                       record_every=record_every)


def run_swarm_batch(config: SwarmConfig, scenarios: SwarmScenario,
                    states: SwarmState, n_steps: int,
                    record_every: int = 0):
    """Step a whole scenario batch: ``scenarios`` and ``states`` are
    stacked along a leading ``[B]`` lane axis (:func:`stack_pytrees`,
    ``init_swarm(..., batch=B)``), and every launch of a step covers
    all lanes.  Returns ``(final states [B, …], offload-over-time
    [B, n_steps])``, plus the per-lane ``[B, n_steps // N, M]``
    timeline with ``record_every=N``; each lane is bit-identical to
    :func:`run_swarm_scenario` on that lane alone.

    The reference donates the state buffers to its compiled program;
    PyTorch has no donation, so the port steps the stacked ``states``
    IN PLACE: the returned final states are the passed buffers."""
    if not is_lanes(states):
        raise ValueError("run_swarm_batch takes stacked lanes; use "
                         "run_swarm_scenario for one scenario")
    states = ensure_penalty_width_batch(config, scenarios, states)
    return _scan_swarm(config, scenarios, states, n_steps,
                       record_every=record_every)


def _penalty_width(config: SwarmConfig, scenario: SwarmScenario) -> int:
    if config.holder_selection != "adaptive":
        return 0
    if config.neighbor_offsets is not None:
        return len(_normalized_offsets(config.neighbor_offsets,
                                       config.n_peers))
    return scenario.neighbors.shape[-1]


def ensure_penalty_width(config: SwarmConfig, scenario: SwarmScenario,
                         state: SwarmState) -> SwarmState:
    """Resize a pristine (all-zero) penalty field of the wrong width;
    only ``"adaptive"`` carries a non-empty one."""
    k_topo = _penalty_width(config, scenario)
    pen = state.holder_penalty_ms
    if pen.shape[-1] != k_topo and not bool(torch.any(pen > 0.0)):
        state = state._replace(holder_penalty_ms=torch.zeros(
            tuple(pen.shape[:-1]) + (k_topo,), dtype=torch.float32,
            device=pen.device))
    return state


def ensure_penalty_width_batch(config: SwarmConfig,
                               scenarios: SwarmScenario,
                               states: SwarmState) -> SwarmState:
    """Batched :func:`ensure_penalty_width`, for a ``[B, P, K]``
    penalty field."""
    return ensure_penalty_width(config, scenarios, states)


def timeline_columns(config: SwarmConfig) -> Tuple[str, ...]:
    """Column names of one metrics-timeline row (the ``[M]`` axis of
    the ``record_every`` output), as the reference names them and in its
    order: sample clock, the cumulative offload and rebuffer, interval
    byte rates, the interval stall count, per-level present-peer counts,
    with ``config.n_cohorts > 0`` three columns per cohort k (its present
    peers, its interval stalls and its cumulative offload, sliced by the
    scenario's ``cohort_id``) and, with ``config.stall_digest``, the
    stall-digest bins."""
    base = (("t_s", "offload", "rebuffer", "cdn_rate_bps",
             "p2p_rate_bps", "stalled_peers")
            + tuple(f"level_{i}_peers" for i in range(config.n_levels)))
    for k in range(config.n_cohorts):
        base += (f"cohort_{k}_peers", f"cohort_{k}_stalled",
                 f"cohort_{k}_offload")
    if config.stall_digest:
        base += tuple(f"stall_ms_bin{i}"
                      for i in range(len(DEFAULT_EDGES) + 1))
    return base


def offload_ratio(state: SwarmState) -> torch.Tensor:
    """P2P bytes over all bytes, of one scenario."""
    return offload_ratio_batch(as_lanes(state))[0]


def offload_ratio_batch(states: SwarmState) -> torch.Tensor:
    """Per-lane offload ratios ``[B]``, by the reduction that writes the
    offload series (``lane_sums``), so a run's last series entry, its
    last timeline row and this agree to the bit on each device."""
    from . import swarm_kernels as sk
    out = torch.empty((states.t_s.shape[0], 1), dtype=torch.float32,
                      device=states.t_s.device)
    sk.lane_sums(states, out, 0)
    return out[:, 0]


def rebuffer_ratio(state: SwarmState, elapsed_s: float,
                   join_s=None, leave_s=None) -> torch.Tensor:
    """Stall time over per-peer watch time (present time on both
    ends), as the reference and the discrete harness define it."""
    def one(x):
        return None if x is None else _f32_on(x, state.t_s.device)[None]
    return rebuffer_ratio_batch(as_lanes(state), elapsed_s, one(join_s),
                                one(leave_s))[0]


def rebuffer_ratio_batch(states: SwarmState, elapsed_s: float,
                         join_s=None, leave_s=None) -> torch.Tensor:
    """Per-lane rebuffer ratios ``[B]``; ``join_s`` and ``leave_s`` are
    ``[B, P]`` (or ``[P]`` for every lane) when given.  The watched time
    is ``Σ clip(min(leave, elapsed) - join, 0)``, summed by the
    reduction that writes the timeline's rebuffer column
    (``timeline_row``), so the last row of a run that ends on a sample
    equals this to the bit.  Without joins and leaves the reference
    takes ``P · elapsed``; the port sums ``elapsed`` over the peers,
    which is the same number wherever float32 holds the partial sums
    exactly."""
    from . import swarm_kernels as sk
    reb = states.rebuffer_s
    B, P = reb.shape
    dev = reb.device

    def lanes(x, fill):
        if x is None:
            return torch.full((B, P), fill, dtype=torch.float32, device=dev)
        return _f32_on(x, dev).expand(B, P).contiguous()
    t = torch.full((B,), elapsed_s, dtype=torch.float32, device=dev)
    return sk.rebuffer_ratio_lanes(reb, lanes(join_s, 0.0),
                                   lanes(leave_s, NEVER_S), t)


def _f32_on(x, device) -> torch.Tensor:
    """An array-like as a float32 tensor on ``device``."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a state or scenario, the ``ewma`` field's
    included."""
    if isinstance(tree, tuple):
        return [x for f in tree for x in tree_leaves(f)]
    return [tree]


def batch_lane_bytes(config: SwarmConfig, n_steps: int, *,
                     record_every: int = 0, n_neighbors: int = 0,
                     scenario: Optional[SwarmScenario] = None) -> int:
    """Device bytes ONE lane of a batched dispatch pins, counted as the
    reference counts them: the state twice (its carry and the update in
    flight), the per-peer scenario arrays, the ``[n_steps]`` offload
    series and the timeline when recording.  The state's shapes are the
    port's own (an :func:`init_swarm` on the ``meta`` device, which
    allocates nothing).  ``scenario`` (one lane) sizes the scenario term
    from its tensors; without it, nine ``[P]`` 4-byte arrays."""
    if scenario is not None and config.neighbor_offsets is None:
        n_neighbors = int(scenario.neighbors.shape[-1])
    state = init_swarm(config, n_neighbors if n_neighbors else None,
                       device="meta")
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(state))
    P = config.n_peers
    if scenario is not None:
        scenario_bytes = sum(t.numel() * t.element_size()
                             for t in tree_leaves(scenario))
    else:
        scenario_bytes = 9 * 4 * P
        if config.neighbor_offsets is None and n_neighbors:
            scenario_bytes += 2 * 4 * P * n_neighbors  # nbrs + in_edges
    out_bytes = 4 * n_steps
    if record_every:
        out_bytes += 4 * (n_steps // record_every) * len(
            timeline_columns(config))
    return 2 * state_bytes + scenario_bytes + out_bytes


def autotune_chunk(config: SwarmConfig, n_items: int, n_steps: int, *,
                   record_every: int = 0, n_neighbors: int = 0,
                   scenario: Optional[SwarmScenario] = None,
                   device=None) -> int:
    """Memory-derived lanes per dispatch: how many lanes of
    :func:`batch_lane_bytes` fit in :func:`autotune_memory_fraction` of
    the card's free memory (``torch.cuda.mem_get_info``, plus what
    PyTorch's allocator holds reserved and unused), or of
    :data:`AUTOTUNE_FALLBACK_BYTES` on the CPU.  Clamps: floor 1 (a
    lane that does not fit still has to run), cap ``n_items``, ceiling
    :data:`MAX_AUTOTUNE_CHUNK`.  ``device`` is the card when None."""
    if n_items <= 0:
        return 1
    dev = resolve_device(device)
    if dev.type == "cuda":
        free = (torch.cuda.mem_get_info(dev)[0]
                + torch.cuda.memory_reserved(dev)
                - torch.cuda.memory_allocated(dev))
    else:
        free = AUTOTUNE_FALLBACK_BYTES
    lane_bytes = batch_lane_bytes(config, n_steps,
                                  record_every=record_every,
                                  n_neighbors=n_neighbors,
                                  scenario=scenario)
    fit = int(free * autotune_memory_fraction() // max(lane_bytes, 1))
    return max(1, min(fit, n_items, MAX_AUTOTUNE_CHUNK))


# ---- step cost models ----------------------------------------------------

def step_flops(config: SwarmConfig, n_neighbors: int = 8, *,
               device) -> float:
    """Analytic arithmetic per step, the reference's model
    (``swarm_sim.py:2634-2668``): the eligibility term, the cache map's
    insert (2·P·W), ~60 elementwise ops a peer and the ABR fit (2·P·L).
    On the circulant path the eligibility term follows the formulation
    (:func:`resolve_eligibility` on ``device``, which the caller names:
    ``"auto"`` is ``"stencil"`` on the card and ``"kpass"`` on the CPU,
    and their costs differ several times over): ``"kpass"`` ANDs and
    tests the packed map K·C times (2·P·W·K·C), ``"stencil"`` extracts
    M = C·(K+1)
    word columns once (2·P·W·M + 4·P·M); on the general path ~7 ops an
    edge and slot (7·P·K·C, K = ``n_neighbors``)."""
    P, L = config.n_peers, config.n_levels
    W = packed_words(config)
    C = config.max_concurrency
    K = n_neighbors
    if config.neighbor_offsets is not None:
        K = len(_normalized_offsets(config.neighbor_offsets, P))
        if resolve_eligibility(config, device) == "kpass":
            elig = 2.0 * P * W * K * C
        else:
            M = C * (K + 1.0)
            elig = 2.0 * P * W * M + 4.0 * P * M
    else:
        elig = 7.0 * P * K * C
    return elig + 2.0 * P * W + 60.0 * P + 2.0 * P * L


def step_hbm_breakdown(config: SwarmConfig, n_neighbors: int = 8, *,
                       device) -> dict:
    """Per-term analytic main-memory bytes of one step, the reference's
    model (``swarm_sim.py:2671-2731``):

    - ``carry_rw``: the state read and written once a step, from the
      port's own layout (:func:`init_swarm` on the ``meta`` device, each
      field at its dtype's width; the u32 words held in int32 are as
      wide as the reference's u32), so a new or re-packed field counts
      itself;
    - ``scenario_reads``: eight 4-byte per-peer scenario arrays;
    - ``eligibility``: ``"kpass"`` re-streams the map and its bit mask
      K·C times (8·P·W·K·C), ``"stencil"`` streams it once plus three
      4-byte vectors a word column (4·P·W + 12·P·M); the general path
      gathers a word an edge and slot (4·P·K·C);
    - ``edge_gathers``: the general path's contention gathers (20·P·K·C;
      0 on the circulant path).

    ``device`` resolves ``"auto"`` as in :func:`step_flops`."""
    P = config.n_peers
    W = packed_words(config)
    C = config.max_concurrency
    circulant = config.neighbor_offsets is not None
    if circulant:
        K = len(_normalized_offsets(config.neighbor_offsets, P))
    else:
        K = n_neighbors
    state = init_swarm(config, None if circulant else K, device="meta")
    carry_rw = 2.0 * sum(float(t.numel() * t.element_size())
                         for t in tree_leaves(state))
    scenario_reads = 8.0 * 4.0 * P
    if circulant:
        if resolve_eligibility(config, device) == "kpass":
            elig = 2.0 * 4.0 * P * W * K * C
        else:
            M = C * (K + 1.0)
            elig = 4.0 * P * W + 3.0 * 4.0 * P * M
        edges = 0.0
    else:
        elig = 4.0 * P * K * C
        edges = (2.0 * 4.0 * P * K + 3.0 * 4.0 * P * K) * C
    return {"carry_rw": carry_rw, "scenario_reads": scenario_reads,
            "eligibility": elig, "edge_gathers": edges}


def step_hbm_bytes(config: SwarmConfig, n_neighbors: int = 8, *,
                   device) -> float:
    """Analytic main-memory bytes a step: the sum of
    :func:`step_hbm_breakdown`'s terms."""
    return float(sum(step_hbm_breakdown(config, n_neighbors,
                                        device=device).values()))


# ---- topology and inputs --------------------------------------------------

def staggered_joins(n_peers: int, window_s: float = 60.0, seed: int = 0,
                    device=None) -> torch.Tensor:
    """Deterministic shuffled join times over ``window_s``: the evenly
    spaced float32 times of ``jnp.linspace(0, window_s, n_peers)`` in
    the order of ``jax.random.permutation(PRNGKey(seed), ...)``, drawn
    on the host by the port's threefry twin (``core/prng.py``), so they
    are the reference's joins to the bit.  Shuffling matters for
    ring-ish topologies (ring-adjacent peers should not arrive
    together)."""
    base = prng.linspace_f32(0.0, window_s, n_peers)
    joins = prng.permutation(prng.PRNGKey(seed), base)
    return torch.from_numpy(joins).to(resolve_device(device))


def stable_ranks(n_peers: int, seed: int = 0, device=None) -> torch.Tensor:
    """Deterministic per-peer ranks in [0, 1) for the live-edge CDN
    stagger: ``jax.random.uniform(PRNGKey(seed), (n_peers,))``, drawn on
    the host by the port's threefry twin (``core/prng.py``), to the
    bit."""
    ranks = prng.uniform(prng.PRNGKey(seed), n_peers)
    return torch.from_numpy(ranks).to(resolve_device(device))


def _normalized_offsets(offsets: Tuple[int, ...], n_peers: int) -> List[int]:
    """Drop padding (0 mod P) and duplicates (mod P) from a circulant
    offset tuple, preserving order."""
    seen = set()
    out = []
    for off in offsets:
        r = off % n_peers
        if r == 0 or r in seen:
            continue
        seen.add(r)
        out.append(off)
    return out


def ring_offsets(degree: int = 8,
                 k_pad: Optional[int] = None) -> Tuple[int, ...]:
    """Circulant offsets for the symmetric degree-``degree`` ring
    (``degree//2`` neighbours in each direction); ``k_pad`` pads with
    0 (= no edge)."""
    half = max(degree // 2, 1)
    offs = tuple(range(1, half + 1)) + tuple(-o for o in range(1, half + 1))
    if k_pad is not None and k_pad > len(offs):
        offs = offs + (0,) * (k_pad - len(offs))
    return offs


def full_offsets(n_peers: int) -> Tuple[int, ...]:
    """Everyone-sees-everyone as circulant offsets 1..P-1: the tracker
    topology (:func:`full_neighbors`) in offset form."""
    return tuple(range(1, n_peers))


# ---- the general [P, K] topology -------------------------------------------
# Copies of the reference's host-side helpers (reference
# swarm_sim.py:2741-2769, :2821-2915): the same arrays, returned as int32
# tensors on ``device`` (the card when None).  The lists are drawn with
# NumPy; the inversion and the checks run where the list lies.

def _check_neighbors(config: SwarmConfig, nbr: torch.Tensor) -> None:
    """The neighbour list's range, and under ``"ranked"`` no row naming
    one peer twice (:func:`make_scenario`), checked where ``nbr``
    lies."""
    P = config.n_peers
    if nbr.numel() and bool((nbr.min() < 0) | (nbr.max() >= P)):
        raise ValueError(f"neighbors holds peer ids outside [0, {P})")
    if config.holder_selection == "ranked" and nbr.shape[1] > 1:
        srt = torch.sort(nbr, dim=1).values
        self_id = torch.arange(P, device=nbr.device)[:, None]
        if bool(((srt[:, 1:] == srt[:, :-1])
                 & (srt[:, 1:] != self_id)).any()):
            raise ValueError(
                "a neighbour row names one peer twice: \"ranked\" would "
                "ride both edges; give each row distinct peers (self "
                "entries pad)")


#: the last neighbour lists :func:`make_scenario` checked and inverted:
#: ``[list, its version, inverse, its version, checked for "ranked"]``.
#: A policy grid's cells share one list, which is then checked and
#: inverted once (each costs host syncs).  An entry holds its list, so
#: the identity it is found by is never reused while it lives; the
#: versions catch in-place writes.
_INVERTED: list = []


def _checked_inverse(config: SwarmConfig,
                     neighbors: torch.Tensor) -> torch.Tensor:
    """:func:`_check_neighbors` and :func:`invert_neighbors` of
    ``neighbors``, or the inverse of this same unchanged list from a
    recent call (checked again under ``"ranked"`` if it was not
    then)."""
    ranked = config.holder_selection == "ranked"
    for entry in _INVERTED:
        nbr, version, inv, inv_version, ranked_ok = entry
        if (nbr is neighbors and version == neighbors._version
                and inv_version == inv._version):
            if ranked and not ranked_ok:
                _check_neighbors(config, neighbors)
                entry[4] = True
            return inv
    _check_neighbors(config, neighbors)
    inv = invert_neighbors(neighbors, device=neighbors.device)
    _INVERTED[:] = _INVERTED[-3:] + [
        [neighbors, neighbors._version, inv, inv._version, ranked]]
    return inv


def invert_neighbors(neighbors, device=None) -> torch.Tensor:
    """The inverse of a ``[P, K]`` neighbour matrix: row j lists the
    flat outbound slots ``i·K + k`` with ``nbr[i, k] == j`` (and ``i !=
    j``) in ascending order, padded with -1 to ``K_in = max(max
    in-degree, K)``.  Holder j's admission walks its row in this order.
    The reference's NumPy steps as PyTorch ops on ``device`` (a stable
    sort by holder), so a list on the card is inverted there."""
    nbr = (neighbors if torch.is_tensor(neighbors)
           else torch.from_numpy(np.asarray(neighbors)))
    nbr = nbr.to(device=resolve_device(device), dtype=torch.int64)
    P, K = nbr.shape
    dev = nbr.device
    src = torch.arange(P, device=dev).repeat_interleave(K)
    dst = nbr.reshape(-1)
    real = dst != src
    dst_s, order = torch.sort(dst[real], stable=True)
    flat_s = torch.nonzero(real).reshape(-1)[order]
    counts = torch.bincount(dst_s, minlength=P)
    k_in = max(int(counts.max()) if P else 0, K)
    in_edges = torch.full((P, k_in), -1, dtype=torch.int32, device=dev)
    pos = (torch.arange(dst_s.numel(), device=dev)
           - (torch.cumsum(counts, 0) - counts)[dst_s])
    in_edges[dst_s, pos] = flat_s.to(torch.int32)
    return in_edges


def _pad_neighbors(nbr: np.ndarray, n_peers: int, k_pad: Optional[int],
                   device=None) -> torch.Tensor:
    """Pad a ``[P, K]`` neighbour matrix to ``k_pad`` columns with
    self-indices (= no edge)."""
    if k_pad is not None:
        if k_pad < nbr.shape[1]:
            raise ValueError(f"k_pad={k_pad} < degree {nbr.shape[1]}")
        pad = np.repeat(np.arange(n_peers)[:, None],
                        k_pad - nbr.shape[1], axis=1)
        nbr = np.concatenate([nbr, pad], axis=1)
    return torch.from_numpy(np.asarray(nbr).astype(np.int32)).to(
        resolve_device(device))


def ring_neighbors(n_peers: int, degree: int = 8,
                   k_pad: Optional[int] = None, device=None) -> torch.Tensor:
    """Symmetric ring neighbour lists ``[P, degree]`` (``degree//2``
    each way), in :func:`ring_offsets`' order; duplicates (degree >= P)
    and self-hits collapse to self-padding."""
    half = max(degree // 2, 1)
    offsets = np.concatenate([np.arange(1, half + 1),
                              -np.arange(1, half + 1)])
    idx = np.arange(n_peers)
    nbr = (idx[:, None] + offsets[None, :]) % n_peers
    dup = np.zeros_like(nbr, dtype=bool)
    for a in range(nbr.shape[1]):
        for b in range(a):
            dup[:, a] |= nbr[:, a] == nbr[:, b]
    nbr = np.where(dup, idx[:, None], nbr)
    return _pad_neighbors(nbr, n_peers, k_pad, device)


def random_neighbors(n_peers: int, degree: int = 8, seed: int = 0,
                     k_pad: Optional[int] = None,
                     device=None) -> torch.Tensor:
    """Uniform-random ``[P, degree]`` neighbour lists (distinct,
    non-self): the tracker-fed mesh, where peer neighbourhoods overlap
    globally.  The reference's draws to the bit: the same
    ``np.random.default_rng(seed)`` calls in the same order.  Degree >=
    P collapses to everyone else plus self-padding."""
    rng = np.random.default_rng(seed)
    real = min(degree, n_peers - 1)
    nbr = np.repeat(np.arange(n_peers)[:, None], degree, axis=1)
    for i in range(n_peers):
        picks = rng.choice(n_peers - 1, size=real, replace=False)
        picks[picks >= i] += 1  # skip self, stay uniform
        nbr[i, :real] = picks
    return _pad_neighbors(nbr, n_peers, k_pad, device)


def full_neighbors(n_peers: int, k_pad: Optional[int] = None,
                   device=None) -> torch.Tensor:
    """Everyone sees everyone (minus self) as ``[P, P-1]`` lists."""
    idx = np.arange(n_peers)
    nbr = (idx[:, None] + np.arange(1, n_peers)[None, :]) % n_peers
    return _pad_neighbors(nbr, n_peers, k_pad, device)


def isolated_neighbors(n_peers: int, k: int = 1,
                       device=None) -> torch.Tensor:
    """No edges at all (every entry is self-padding): the all-CDN
    control topology."""
    return _pad_neighbors(np.repeat(np.arange(n_peers)[:, None], k, axis=1),
                          n_peers, None, device)


def neighbors_from_adjacency(adjacency, k_pad: Optional[int] = None,
                             device=None) -> torch.Tensor:
    """A dense 0/1 ``[P, P]`` adjacency (row i = whom i downloads from)
    as padded ``[P, K]`` neighbour lists, K = the largest row degree
    (or ``k_pad``)."""
    adj = np.array(_np(adjacency)) > 0
    n_peers = adj.shape[0]
    np.fill_diagonal(adj, False)  # self-edges are meaningless
    degree = max(int(adj.sum(axis=1).max()), 1)
    nbr = np.repeat(np.arange(n_peers)[:, None], degree, axis=1)
    for i in range(n_peers):
        cols = np.flatnonzero(adj[i])
        nbr[i, :len(cols)] = cols
    return _pad_neighbors(nbr, n_peers, k_pad, device)
