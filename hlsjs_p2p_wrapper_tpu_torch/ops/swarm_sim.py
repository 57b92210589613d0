"""Batched swarm+ABR simulator on tensors — slice 1 of the port.

Port of the reference's ``ops/swarm_sim.py`` for its main path: the
circulant VOD step that ``bench.py``'s headline and ``tools/sweep.py``'s
VOD grid run.  Per peer: playhead, buffer, quality level, a dual-EWMA
estimator, one foreground transfer slot and a bit-packed
``[P, ceil(L·S/32)]`` per-(level, segment) cache map, stepped every
``dt_ms`` on a degree-K circulant overlay (peer i's neighbours are
``(i + o) mod P``).  A step is two passes (``ops/swarm_kernels.py``):
eligibility, holder selection and admission with uplink share
(``select_admit``), then the per-peer update.  On the card each pass is
hand-written kernels (one launch each on the main path); on the CPU
each is its plain PyTorch version.

What this slice covers, and what raises instead:

- circulant offsets only (``neighbors=None``); the general ``[P, K]``
  path is queue 1 item 9a;
- ``max_concurrency == 1``; prefetch slots are item 9b;
- VOD; live mode is item 9c;
- ``"spread"`` holder selection; ``"adaptive"`` and ``"ranked"`` are
  item 9e;
- ``max_total_serves > 0``; the uncapped fair share (``cap == 0``) is
  item 9a's admission work;
- ``record_every == 0``; timelines are item 5.

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

from ..core.abr import (BANDWIDTH_SAFETY, DEFAULT_FAST_HALF_LIFE_S,
                        DEFAULT_SLOW_HALF_LIFE_S)
from ..core.device import resolve_device
from .ewma import EwmaState, init_state

NEVER_S = 1e18  # "leave" time of a peer that never departs

#: ladder pad value for one-compile multi-ladder sweeps: a level that
#: never fits under any estimate is never chosen by the ABR rule
UNREACHABLE_BITRATE = 1e18

U32_MASK = 0xFFFFFFFF


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
    neighbors: torch.Tensor     # [P, 0] i32 placeholder (circulant mode)
    in_edges: torch.Tensor      # [P, 0] i32 placeholder (circulant mode)
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
    ``device``.  Circulant mode only: ``neighbors`` must be None."""
    dev = resolve_device(device)
    P = config.n_peers
    if neighbors is not None:
        raise NotImplementedError(
            "the general [P, K] neighbor path is not ported yet "
            "(ROADMAP queue 1 item 9a); set config.neighbor_offsets and "
            "pass neighbors=None")
    if config.neighbor_offsets is None:
        raise ValueError("neighbors=None requires "
                         "config.neighbor_offsets (circulant mode)")

    def f32(value):
        return torch.from_numpy(np.array(value, np.float32)).to(dev)

    def i32(value):
        return torch.from_numpy(np.array(value, np.int32)).to(dev)

    def scalar(value, default):
        return f32(_np(default if value is None else value)).reshape(())

    def per_peer(value, fill, conv=f32):
        if value is None:
            return conv(np.full((P,), fill))
        out = conv(_np(value))
        if tuple(out.shape) != (P,):
            raise ValueError(f"per-peer array of shape {tuple(out.shape)},"
                             f" expected ({P},)")
        return out

    scen = SwarmScenario(
        bitrates=f32(_np(bitrates)),
        neighbors=torch.zeros((P, 0), dtype=torch.int32, device=dev),
        in_edges=torch.zeros((P, 0), dtype=torch.int32, device=dev),
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
               device=None) -> SwarmState:
    """Zero state on ``device``.  Only ``"adaptive"`` carries a
    non-empty per-edge penalty field, and this slice does not run it."""
    dev = resolve_device(device)
    P = config.n_peers
    C = config.max_concurrency
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
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def i(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    return SwarmState(
        t_s=f(), playhead_s=f(P), buffer_s=f(P), rebuffer_s=f(P),
        level=i(P), ewma=init_state(P, device=dev),
        avail=i(P, packed_words(config)), cdn_bytes=f(P), p2p_bytes=f(P),
        dl_flags=i(P), dl_seg=i(P, C), dl_level=i(P, C),
        dl_done_bytes=f(P, C), dl_total_bytes=f(P, C),
        dl_elapsed_ms=f(P, C), dl_budget_ms=f(P, C),
        dl_cooldown_ms=f(P, C), dl_attempts=i(P, C), fg_wait_ms=f(P),
        holder_penalty_ms=f(P, n_neighbors), dl_holder_off=i(P, C))


def clone_state(state: SwarmState) -> SwarmState:
    """A deep copy (the step updates its state in place)."""
    return SwarmState(*(EwmaState(*(t.clone() for t in f))
                        if isinstance(f, EwmaState) else f.clone()
                        for f in state))


# ---- eligibility helpers ----------------------------------------------------

def _abr_pick(estimate_bps: torch.Tensor,
              bitrates: torch.Tensor) -> torch.Tensor:
    """Highest level whose bitrate fits under the safety-scaled
    estimate, else 0 (core/abr.py next_level)."""
    fits = bitrates[None, :] <= (estimate_bps * BANDWIDTH_SAFETY)[:, None]
    idx = torch.arange(bitrates.shape[0], dtype=torch.int32,
                       device=bitrates.device)
    zero = torch.zeros((), dtype=torch.int32, device=bitrates.device)
    return torch.amax(torch.where(fits, idx[None, :], zero), dim=1)


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
    """One-hot ``[P, W]`` mask (int32 bit patterns) selecting each
    peer's flat (level, seg) bit in the packed map — the cache-insert
    position and the "kpass" AND operand."""
    wcol = torch.arange(n_words, dtype=torch.int32, device=gi_flat.device)
    word_idx = gi_flat >> 5
    bitmask = _bit_table(gi_flat.device)[(gi_flat & 31).long()]
    zero = torch.zeros((), dtype=torch.int32, device=gi_flat.device)
    return torch.where(wcol[None, :] == word_idx[:, None],
                       bitmask[:, None], zero)


def circulant_eligibility(avail_p: torch.Tensor, present: torch.Tensor,
                          offs, gi_flats, *, impl: str = "stencil"):
    """Circulant-path eligibility for every transfer slot at once.

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
    P, W = avail_p.shape
    dev = avail_p.device
    zeros = torch.zeros((P,), dtype=torch.float32, device=dev)
    table = _bit_table(dev)
    bitmasks = [table[(gf & 31).long()] for gf in gi_flats]
    if impl == "kpass":
        AP = torch.where(present[:, None], avail_p,
                         torch.zeros((), dtype=avail_p.dtype, device=dev))
        out = []
        for gf in gi_flats:
            Wm = bit_mask_words(gf, W)
            elig = [torch.sum((torch.roll(AP, -o, 0) & Wm) != 0, dim=1,
                              dtype=torch.int32).to(torch.float32)
                    for o in offs]
            n = sum(elig) if elig else zeros
            own = torch.any((avail_p & Wm) != 0, dim=1)
            out.append((elig, n, own))
        return out
    if impl != "stencil":
        raise ValueError(f"unknown eligibility {impl!r}")
    cols = []
    for gf in gi_flats:
        wi = gf >> 5
        cols.append(wi)
        cols.extend(torch.roll(wi, o) for o in offs)
    wanted = torch.stack(cols, dim=1).long()             # [P, M]
    ext = torch.gather(avail_p, 1, wanted)               # [P, M] words
    pres_ro = {o: torch.roll(present, -o) for o in dict.fromkeys(offs)}
    stride = 1 + len(offs)
    out = []
    for c, bm in enumerate(bitmasks):
        base = c * stride
        own = (ext[:, base] & bm) != 0
        elig = []
        for k, o in enumerate(offs):
            word = torch.roll(ext[:, base + 1 + k], -o)
            have = (word & bm) != 0
            elig.append((have & pres_ro[o]).to(torch.float32))
        n = sum(elig) if elig else zeros
        out.append((elig, n, own))
    return out


# ---- the step -------------------------------------------------------------

def check_slice(config: SwarmConfig) -> None:
    """Raise for a configuration outside slice 1, naming the ROADMAP
    item that brings it."""
    if config.holder_selection not in ("adaptive", "spread", "ranked"):
        raise ValueError(f"unknown holder_selection "
                         f"{config.holder_selection!r}")
    if config.eligibility not in ("auto", "stencil", "kpass"):
        raise ValueError(f"unknown eligibility {config.eligibility!r}")
    if config.neighbor_offsets is None:
        raise NotImplementedError(
            "the general [P, K] neighbor path is not ported yet "
            "(ROADMAP queue 1 item 9a)")
    if config.max_concurrency != 1:
        raise NotImplementedError(
            "prefetch slots (max_concurrency > 1) are not ported yet "
            "(ROADMAP queue 1 item 9b)")
    if config.live:
        raise NotImplementedError(
            "live mode is not ported yet (ROADMAP queue 1 item 9c)")
    if config.holder_selection != "spread":
        raise NotImplementedError(
            f"holder_selection={config.holder_selection!r} is not "
            f"ported yet (ROADMAP queue 1 item 9e)")
    if config.max_total_serves <= 0:
        raise NotImplementedError(
            "the uncapped fair share (max_total_serves == 0) is not "
            "ported yet (ROADMAP queue 1 item 9a)")


def swarm_step(config: SwarmConfig, scenario: SwarmScenario,
               state: SwarmState) -> SwarmState:
    """One ``dt_ms`` tick for every peer.  Two passes: eligibility,
    holder selection, admission and service (``select_admit``), then
    the per-peer update (``ops/swarm_kernels.py``).  On a CUDA state
    each pass launches its kernels; on a CPU state the plain PyTorch
    versions run.

    The state's tensors are updated IN PLACE and the returned state
    carries them with the clock advanced: clone a state
    (:func:`clone_state`) to keep it."""
    from . import swarm_kernels as sk
    check_slice(config)
    if state.holder_penalty_ms.shape[1] != 0:
        raise ValueError(
            f"state.holder_penalty_ms is sized for "
            f"{state.holder_penalty_ms.shape[1]} neighbors but "
            f"\"spread\" carries a zero-width field")
    flags, req, service, adm = sk.select_admit(config, scenario, state)
    sk.peer_update(config, scenario, state, flags, req, service, adm)
    return state._replace(t_s=state.t_s + config.dt_ms / 1000.0)


def _scan_swarm(config: SwarmConfig, scenario: SwarmScenario,
                state: SwarmState, n_steps: int, record_every: int = 0):
    """``n_steps`` steps as a Python loop; returns ``(final state,
    offload series [n_steps])``.  The series is filled on the device,
    so the loop never waits on the host.  Updates ``state`` in place."""
    if record_every:
        raise NotImplementedError(
            "record_every > 0 (metrics timelines) is not ported yet "
            "(ROADMAP queue 1 item 5)")
    series = torch.empty((n_steps,), dtype=torch.float32,
                         device=state.t_s.device)
    for s in range(n_steps):
        state = swarm_step(config, scenario, state)
        series[s] = offload_ratio(state)
    return state, series


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
    ``[n_steps]``).  Runs on ``device`` — the card when None — and
    leaves the caller's ``state`` untouched (it steps a copy)."""
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
    state = SwarmState(*(EwmaState(*(t.to(dev, copy=True) for t in f))
                         if isinstance(f, EwmaState)
                         else f.to(dev, copy=True) for f in state))
    state = ensure_penalty_width(config, scenario, state)
    return _scan_swarm(config, scenario, state, n_steps,
                       record_every=record_every)


def ensure_penalty_width(config: SwarmConfig, scenario: SwarmScenario,
                         state: SwarmState) -> SwarmState:
    """Resize a pristine (all-zero) penalty field of the wrong width;
    under ``"spread"`` the field has zero width."""
    if config.holder_selection != "adaptive":
        k_topo = 0
    elif config.neighbor_offsets is not None:
        k_topo = len(_normalized_offsets(config.neighbor_offsets,
                                         config.n_peers))
    else:
        k_topo = scenario.neighbors.shape[1]
    pen = state.holder_penalty_ms
    if pen.shape[1] != k_topo and not bool(torch.any(pen > 0.0)):
        state = state._replace(holder_penalty_ms=torch.zeros(
            (config.n_peers, k_topo), dtype=torch.float32,
            device=pen.device))
    return state


def offload_ratio(state: SwarmState) -> torch.Tensor:
    p2p = torch.sum(state.p2p_bytes)
    total = p2p + torch.sum(state.cdn_bytes)
    return p2p / torch.clamp_min(total, 1.0)


def rebuffer_ratio(state: SwarmState, elapsed_s: float,
                   join_s=None, leave_s=None) -> torch.Tensor:
    """Stall time over per-peer watch time (present time on both
    ends), as the reference and the discrete harness define it."""
    reb = state.rebuffer_s
    if join_s is None and leave_s is None:
        watched = torch.tensor(reb.shape[0] * elapsed_s,
                               dtype=torch.float32, device=reb.device)
    else:
        P = reb.shape[0]

        def f32(x):
            return torch.from_numpy(_np(x).astype(np.float32)).to(
                reb.device)
        join = (torch.zeros((P,), dtype=torch.float32, device=reb.device)
                if join_s is None else f32(join_s))
        end = (torch.full((P,), elapsed_s, dtype=torch.float32,
                          device=reb.device) if leave_s is None
               else torch.clamp_max(f32(leave_s), elapsed_s))
        watched = torch.sum(torch.clamp_min(end - join, 0.0))
    return torch.sum(reb) / torch.clamp_min(watched, 1e-9)


# ---- topology and inputs --------------------------------------------------

def staggered_joins(n_peers: int, window_s: float = 60.0, seed: int = 0,
                    device=None) -> torch.Tensor:
    """Deterministic shuffled join times over ``window_s``: the evenly
    spaced times of ``linspace(0, window_s, n_peers)`` in an order drawn
    from ``numpy.random.default_rng(seed)``.  Shuffling matters for
    ring-ish topologies (ring-adjacent peers should not arrive
    together).  The draws differ from the reference's ``jax.random``
    permutation: parity tests pass the reference's materialized joins
    to both sides."""
    base = np.linspace(0.0, window_s, n_peers, dtype=np.float32)
    perm = np.random.default_rng(seed).permutation(n_peers)
    return torch.as_tensor(base[perm], device=resolve_device(device))


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
