"""The kernels of the swarm step (VOD and live, circulant and general
``[P, K]`` topology) and of its per-lane reductions, with their plain
PyTorch versions and the wrappers that choose between them.

=====================  ==========================================
kernel                 replaces (reference ``ops/swarm_sim.py``)
=====================  ==========================================
TK1 ``elig_select``    ``circulant_eligibility`` :681-772, the
                       holder policies :919-1051, each slot's
                       start decision :1053-1205, pinning
                       :1207-1228
TK2 ``admit_service``  circulant admission in (slot, offset) order
                       and service, :1259-1303 (the uncapped fair
                       share :1291-1297 as an infinite cap)
``select_admit``       TK1 then TK2 in one launch, over tiles of
                       peers with a halo of requesters
TK3 ``peer_update``    the service readback and each slot's update
                       :1351-1525 with ``ewma.update``, and in its
                       epilogue TK4's sums for the step's offload
                       series :1643-1647 and the clock's advance
TK1 gather form        the general path's eligibility by gather
``elig_select_gather`` :859-866, :907-917, its policies and
                       pinning (:948-957, :981-991, :1021-1040,
                       :1199-1228), the rest as TK1
TK2 ``admit_gather``   the general path's admission over the
                       inbound edge lists and service :1304-1349
TK3 gather form        TK3 with the general path's readback
``peer_update_gather`` :1347-1349
TK4 ``lane_sums``      the same sums outside the step: a timeline's
                       first interval, ``offload_ratio`` :2607-2611
TK5 ``timeline_row``   ``_timeline_row`` :1559-1627, and the sums
                       of ``rebuffer_ratio``; its instantiation
                       ``timeline_row_cohorts`` also the per-cohort
                       columns :1594-1611
=====================  ==========================================

A step is :func:`select_admit` then :func:`peer_update`, which also
sums each lane's byte counters, writes the step's column of the
offload series and advances the lane's clock; every ``record_every``
steps :func:`timeline_row` writes a row.  The route of
``select_admit`` is chosen from the config before launch
(:func:`fused_route`): the fused kernel where the halo fits its tile
(the main path), else TK1 then TK2; on the general ``[P, K]`` path
(``config.neighbor_offsets`` None, the neighbour list
``scenario.neighbors``) TK1 then TK2 in their gather forms, and
:func:`peer_update` takes its gather form too.  The uncapped fair share
(``max_total_serves <= 0``) is the capped kernels with an infinite cap:
every demand is admitted, so no BUSY deny or admission abort fires, as
in the reference's uncapped branch.

Lanes.  Every function here works on stacked scenario lanes (``t_s``
of shape ``[B]``, see ``swarm_sim``); the step's functions also take a
single scenario, which they run as one lane.  On the card the lane is
a grid dimension of every kernel, so one launch covers all lanes.

The sources are ``csrc/swarm_step.cu`` (TK1–TK3, ``select_admit``) and
``csrc/swarm_reduce.cu`` (TK4, TK5), CUDA C++ for ``sm_90a`` built by
``ops/_build.py`` and bound with ``ctypes``.  Each wrapper checks
device, dtype, shape and contiguity; for CUDA tensors it launches its
kernel or raises, for CPU tensors it runs the plain version.  There is
no fallback from a failed build or launch to the plain version.

Data flow of a step: TK1 decides every requester's transfer and
selected holder; TK2 needs every requester's demand to admit per
holder; TK3 needs every holder's service.  ``select_admit`` does TK1
and TK2 in one launch by recomputing, in each block, the selection of
the requesters its holders serve.  Between the passes travel four
scratch words: per (peer, slot), ``[B, P, C]``, ``slot_flags`` (bit 0
may, bit 1 active, bit 2 is_p2p, bit 3 have_n; on slot 0 only, bit 4
blocked on the live stagger and bit 5 absorbed from the own cache),
``req`` (the offset index of the slot's selected holder where the slot
places demand, else -1) and ``adm`` (per holder and slot, a bit mask of
the admitted offset indices; on the general path per requester and
slot the admitted flag, written where ``req >= 0`` and read only
there); per holder, ``[B, P]``, ``service``.

Transfer slots.  ``C = config.max_concurrency`` slots (at most 16):
slot 0 the foreground, slots 1.. P2P-only prefetches.  Every kernel
walks them in the reference's order (the selection slot by slot, the
admission over (slot, offset), the update slot by slot), so that each
float add and EWMA update rounds as the reference's do; ``C`` is a
template parameter of the kernels (``csrc/swarm_step.cu``).

Live mode.  The selection reads the stagger's wait clock
``fg_wait_ms`` and reports a foreground blocked on it in bit 4; only
``peer_update`` writes the clock, from that bit.  So no kernel writes a
field that another thread of its launch reads: ``select_admit``'s halo
requesters read ``fg_wait_ms`` of rows that other blocks own.  Both
passes floor the playhead from the same inputs in the same order
(``_live_playhead``), since only ``peer_update`` writes it back.  A VOD
config runs kernels compiled without the live code.

Holder policies.  ``config.holder_selection`` picks the kernels'
instantiation (:data:`POLICY_CODES`).  ``"adaptive"`` scores each
eligible holder by the requester's own load on it and by the per-edge
penalty window ``holder_penalty_ms`` (``[B, P, K]``), which the
selection reads and only ``peer_update`` writes (it drains the window
and re-arms it on the holders of BUSY denies and prefetch aborts), as
with ``fg_wait_ms``; ``"ranked"`` takes holders by peer id and
recomputes its pick every step.

In place: TK1 (and ``select_admit``) writes the slot record into its
own row of the state and TK3 updates its own row of every field.  Each
peer's row has one writer, and the selection has finished reading
neighbours' rows before TK3 writes them.  Inside ``select_admit`` a
block reads requester fields of halo peers that another block writes;
that is sound because each such field is read only when its slot is
active and written only when it is not (``csrc/swarm_step.cu``), and
the prefetch dedup guard reads the slots already processed from the
requester's registers, not from memory.  The
plain versions update the state in place too.  Callers that compare two
steps clone the state first.

Reductions.  The offload sums (TK3's epilogue, TK4) and TK5 sum in a
fixed order with no float atomics, finished by the last block of a
lane to arrive, and the order depends on ``P`` alone: a lane's sums are
the same bits batched or alone, run after run.  TK3's epilogue and TK4
sum by the same code (``csrc/lane_sums.cuh``: partials of
:data:`SUMS_BLOCK` peers, super-partials of :data:`SUMS_FAN` partials,
then the lane), so a run's last series entry, its final offload ratio
and its last timeline row agree to the bit; :func:`lane_sums_in_order`
is that order in PyTorch.  On the CPU the plain versions take
``torch.sum``; between the card and the CPU sums agree to a tolerance,
not to the bit.

Every launch adds one to :data:`LAUNCHES`, under the kernel that
:data:`KERNEL_OF` names for the launching wrapper; plain calls add
nothing.  A CUDA graph (:func:`capture`) counts the launches it
recorded once per replay (:meth:`Graph.replay`), not at its capture.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..core.abr import DEFAULT_ESTIMATE_BPS, MIN_SAMPLE_DURATION_MS
from ..engine.digest import DEFAULT_EDGES
from .ewma import _div, get_estimate, update
from .swarm_sim import (BANDWIDTH_SAFETY, SwarmConfig, SwarmScenario,
                        SwarmState, _abr_pick, _normalized_offsets,
                        as_lanes, bit_mask_words, circulant_eligibility,
                        gather_eligibility, pack_dl_flags, packed_words,
                        resolve_eligibility, unpack_dl_flags)

SOURCE = "swarm_step.cu"
REDUCE_SOURCE = "swarm_reduce.cu"
MAX_OFFS = 32

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES = {"select_admit": 0, "elig_select": 0, "admit_service": 0,
            "peer_update": 0, "lane_sums": 0, "timeline_row": 0,
            "elig_select_gather": 0, "admit_gather": 0,
            "peer_update_gather": 0, "timeline_row_cohorts": 0}
#: the kernel each launching wrapper launches, once a call, on the card;
#: :func:`select_admit` launches through ``select_admit_fused`` or
#: through ``elig_select`` then ``admit_service`` (:func:`fused_route`),
#: or on the general path ``elig_select_gather`` then ``admit_gather``
KERNEL_OF = {"select_admit_fused": "select_admit",
             "elig_select": "elig_select", "admit_service": "admit_service",
             "peer_update": "peer_update", "lane_sums": "lane_sums",
             "timeline_row": "timeline_row",
             "rebuffer_ratio_lanes": "timeline_row",
             "elig_select_gather": "elig_select_gather",
             "admit_gather": "admit_gather",
             "peer_update_gather": "peer_update_gather",
             "timeline_row_cohorts": "timeline_row_cohorts"}
#: the step kernels of the general [P, K] path, a launch each a step
GATHER_PATH = ("elig_select_gather", "admit_gather", "peer_update_gather")


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class Geometry(NamedTuple):
    """The static numbers a step needs, derived once per config."""

    P: int
    S: int
    L: int
    W: int
    offs: Tuple[int, ...]       # normalized offsets, as given (signed)
    offs_mod: Tuple[int, ...]   # the same reduced mod P, in [0, P)
    o_hi: int                   # max(offs, 0)
    o_lo: int                   # min(offs, 0)
    rank_order: Tuple[int, ...]  # offset indices by offs_mod, ascending
    seg: float
    end_s: float
    dt_ms: float
    dt_s: float
    fast_alpha: float
    slow_alpha: float
    cap: float                  # max_total_serves, +inf when uncapped
    general: bool               # the [P, K] path (no offsets)


@functools.lru_cache(maxsize=64)
def geometry(config: SwarmConfig) -> Geometry:
    """The config's geometry; on the general path (no offsets) the
    offset fields are empty and K comes from the scenario's neighbour
    list."""
    P = config.n_peers
    general = config.neighbor_offsets is None
    offs = () if general else tuple(
        _normalized_offsets(config.neighbor_offsets, P))
    return Geometry(
        P=P, S=config.n_segments, L=config.n_levels,
        W=packed_words(config), offs=offs,
        offs_mod=tuple(o % P for o in offs),
        o_hi=max((0, *offs)), o_lo=min((0, *offs)),
        rank_order=tuple(sorted(range(len(offs)),
                                key=lambda k: offs[k] % P)),
        seg=config.seg_duration_s,
        end_s=config.n_segments * config.seg_duration_s,
        dt_ms=config.dt_ms, dt_s=config.dt_ms / 1000.0,
        fast_alpha=math.exp(math.log(0.5) / config.fast_half_life_s),
        slow_alpha=math.exp(math.log(0.5) / config.slow_half_life_s),
        cap=(float(config.max_total_serves) if config.max_total_serves > 0
             else math.inf),
        general=general)


#: peers per block of ``select_admit``
SELECT_ADMIT_TILE = 128
#: the widest halo, ``o_hi - o_lo``, that ``select_admit`` takes; a
#: wider one goes to TK1 + TK2.  Each block recomputes the selection of
#: ``span`` requesters beyond its tile, one thread each, so the limit
#: trades that recompute against TK2's separate launch.  Timed on an
#: H100 at 262,144 peers (``chip_smoke.py`` phase 4; readings in
#: PERF.md), the fused kernel beats TK1 + TK2 at halos of 8, 16, 24 and
#: 32, by a margin that shrinks as the halo grows; at 32 the block has
#: 160 threads and 48 registers each.  A wider limit raises the
#: kernel's thread bound, which lowers the register budget of every
#: launch, the main path's too, for a margin heading to zero; untried.
MAX_FUSED_SPAN = 32
#: the CUDA source's tile and limit (``SA_TILE``, ``SA_MAX_SPAN``), set
#: by the build from the two numbers above
DEFINES = (("SA_TILE", SELECT_ADMIT_TILE), ("SA_MAX_SPAN", MAX_FUSED_SPAN))

#: peers per block of ``timeline_row``, and the most blocks a lane
#: takes; the block count depends on P alone, so that a lane sums in
#: the same order whatever the batch
REDUCE_TILE = 4096
REDUCE_MAX_BLOCKS = 1024
#: the offload sums' order (``csrc/lane_sums.cuh``): peers per partial,
#: which is ``peer_update``'s thread block (``LS_THREADS``), and partials
#: per super-partial, a warp's lanes (``LS_FAN``); ``lane_sums`` sums one
#: super-partial a thread block
SUMS_BLOCK = 256
SUMS_FAN = 32
#: the reduction kernels' limits on the timeline row (``MAX_LEVELS``
#: levels, ``MAX_EDGES`` digest edges, ``MAX_COHORTS`` cohorts), checked
#: before launch
MAX_LEVELS = 16
MAX_EDGES = 32
MAX_COHORTS = 8


def fused_route(config: SwarmConfig) -> bool:
    """Whether :func:`select_admit` runs its fused kernel for
    ``config`` (else TK1 then TK2, in their gather forms on the general
    path): decided from the offsets alone."""
    g = geometry(config)
    return not g.general and g.o_hi - g.o_lo <= MAX_FUSED_SPAN


def reduce_blocks(n_peers: int) -> int:
    """Blocks per lane of ``timeline_row``."""
    return max(1, min(-(-n_peers // REDUCE_TILE), REDUCE_MAX_BLOCKS))


def _lane_api(fn):
    """Let ``fn(config, scenario, *args, **kw)``, written for stacked
    lanes, take a single scenario too: its positional arguments become
    one lane (views of its storage, so in-place writes land in it) and
    the tensors ``fn`` returns lose the lane axis again.  Keyword
    arguments pass as they are."""
    @functools.wraps(fn)
    def wrapped(config, scenario, *args, **kw):
        if scenario.bitrates.dim() == 2:
            return fn(config, scenario, *args, **kw)
        out = fn(config, as_lanes(scenario), *(as_lanes(x) for x in args),
                 **kw)
        if out is None:
            return None
        if torch.is_tensor(out):
            return out[0]
        return tuple(x[0] for x in out)
    return wrapped


def _col(x: torch.Tensor) -> torch.Tensor:
    """A ``[B]`` per-lane scalar against ``[B, P]`` per-peer arrays."""
    return x[:, None]


# ---- plain versions -------------------------------------------------------

def _present(scenario: SwarmScenario, t: torch.Tensor) -> torch.Tensor:
    return (_col(t) >= scenario.join_s) & (_col(t) < scenario.leave_s)


def _live_playhead(scenario: SwarmScenario, state: SwarmState):
    """Live mode's playhead floor (reference :814-822): a joiner starts
    ``live_sync_s`` behind the edge, its join time, so once ``t >=
    join_s`` the playhead is at least ``max(join_s - live_sync_s, 0)``.
    Selection and playback both step from the floored playhead."""
    t = _col(state.t_s)
    live_start = torch.clamp_min(
        scenario.join_s - _col(scenario.live_sync_s), 0.0)
    return torch.maximum(state.playhead_s,
                         torch.where(t >= scenario.join_s, live_start, 0.0))


@_lane_api
def _slot_targets(config: SwarmConfig, scenario: SwarmScenario,
                  state: SwarmState) -> Tuple[torch.Tensor, ...]:
    g = geometry(config)
    C = config.max_concurrency
    present = _present(scenario, state.t_s)
    dl_active, dl_is_p2p = unpack_dl_flags(state.dl_flags, C)
    playhead = (_live_playhead(scenario, state) if config.live
                else state.playhead_s)
    estimate = get_estimate(state.ewma, config.fast_half_life_s,
                            config.slow_half_life_s)
    want_level = torch.minimum(_abr_pick(estimate, scenario.bitrates),
                               scenario.abr_cap_level)
    pb = playhead + state.buffer_s
    next_seg = torch.clamp_max(_div(pb, g.seg).to(torch.int32), g.S - 1)
    timeline_left = pb < g.end_s
    fg_wants = (present & ~dl_active[0] & timeline_left
                & (state.buffer_s < config.max_buffer_s))
    if config.live:
        # only fully published segments are downloadable (:837-840)
        fg_wants = fg_wants & ((next_seg.to(torch.float32) + 1.0) * g.seg
                               <= _col(state.t_s))
    # each slot's gather target (:882-894): its stored (level, seg) while
    # active, else (want_level, next_seg + c capped)
    gi_segs, gi_flats = [], []
    for c in range(C):
        t_seg = (next_seg if c == 0
                 else torch.clamp_max(next_seg + c, g.S - 1))
        gi_seg = torch.where(dl_active[c], state.dl_seg[..., c], t_seg)
        gi_level = torch.where(dl_active[c], state.dl_level[..., c],
                               want_level)
        gi_segs.append(gi_seg)
        gi_flats.append(gi_level * g.S + gi_seg)
    return (present, want_level, next_seg, fg_wants, playhead,
            torch.stack(dl_active, -1), torch.stack(dl_is_p2p, -1),
            torch.stack(gi_segs, -1), torch.stack(gi_flats, -1))


_TARGETS = ("present", "want_level", "next_seg", "fg_wants", "playhead",
            "active", "is_p2p", "gi_seg", "gi_flat")


def slot_targets(config: SwarmConfig, scenario: SwarmScenario,
                 state: SwarmState) -> dict:
    """What each peer wants next (reference :796-894), by name:
    presence, the ABR level, the next segment, the foreground's wish,
    the playhead the step starts from (live mode's floor applied), and
    per slot (a trailing ``[C]`` axis) the active and is_p2p bits and
    the gather target: its segment ``gi_seg`` and flat (level·S + seg)
    bit ``gi_flat``."""
    return dict(zip(_TARGETS, _slot_targets(config, scenario, state)))


def _spread_holder_only(elig, n_holders, gi_seg, rot, c):
    """Reference :959-991 for slot ``c``: ONE eligible holder by a u32
    hash of (peer, segment, slot salt ``(c · 2246822519 + 97) mod
    2^32``), its rank advanced by the slot's failed attempts ``rot``.
    The peer is its index within its lane.  The u32 products wrap:
    int64, masked after each multiply and add."""
    P = gi_seg.shape[-1]
    peer = torch.arange(P, dtype=torch.int64, device=gi_seg.device)
    salt = (c * 2246822519 + 97) % (1 << 32)
    h = (peer * 2654435761) & 0xFFFFFFFF
    h = (h + ((gi_seg.to(torch.int64) & 0xFFFFFFFF) * 40503
              & 0xFFFFFFFF)) & 0xFFFFFFFF
    h = (h + salt) & 0xFFFFFFFF
    n = torch.clamp_min(n_holders, 1.0).to(torch.int64)
    rot_u = rot.to(torch.int64) & 0xFFFFFFFF
    rank = ((((h % n) + rot_u) & 0xFFFFFFFF) % n).to(torch.int32)
    cum = torch.zeros_like(gi_seg)
    out = []
    for e in elig:
        is_e = e > 0
        out.append((is_e & (cum == rank)).to(torch.float32))
        cum = cum + is_e.to(torch.int32)
    return out


def _adaptive_holder_only(elig, own_used, pen, gi_seg, rot, c):
    """Reference :1019-1041 for slot ``c``: each eligible offset k scores
    ``own_used[k] · 2 + (holder_penalty_ms[k] > 0)`` (an ineligible one
    4), and :func:`_spread_holder_only` picks among the offsets of the
    lowest score, their count in place of the holder count."""
    scores = [torch.where(e > 0, u.to(torch.int32) * 2
                          + (pen[..., k] > 0.0).to(torch.int32),
                          torch.full_like(gi_seg, 4))
              for k, (e, u) in enumerate(zip(elig, own_used))]
    best = scores[0]
    for s_k in scores[1:]:
        best = torch.minimum(best, s_k)
    sel_elig = [e * (s_k == best) for e, s_k in zip(elig, scores)]
    n_sel = sum(sel_elig, torch.zeros_like(elig[0]))
    return _spread_holder_only(sel_elig, n_sel, gi_seg, rot, c)


def _nth_holder_only(elig, ids, skip: int):
    """Reference ``nth_holder_only`` (:919-957): keep the eligible
    holder of the (``skip`` + 1)-th lowest peer id (the last one found
    where fewer exist).  ``ids`` lists each neighbour column's peer ids:
    on the ring ``(i + o) mod P``, where near the wrap the lowest id is
    not the lowest offset; on the general path the neighbour list's
    columns."""
    if not elig:
        return []
    P = elig[0].shape[-1]
    big = torch.full(elig[0].shape, P, dtype=torch.int32,
                     device=elig[0].device)
    masked = [torch.where(e > 0, i, big) for e, i in zip(elig, ids)]
    prev = torch.full_like(big, -1)
    for _ in range(skip + 1):
        nxt = big
        for m in masked:
            nxt = torch.minimum(nxt, torch.where(m > prev, m, big))
        prev = torch.where(nxt < big, nxt, prev)
    return [((e > 0) & (i == prev)).to(torch.float32)
            for e, i in zip(elig, ids)]


def _holder_ids(g: Geometry, scenario: SwarmScenario, like: torch.Tensor):
    """Each neighbour column's peer ids, ``[..., P]`` int32 each: on the
    ring ``(i + o) mod P`` per offset, on the general path the neighbour
    list's columns."""
    if g.general:
        return list(scenario.neighbors.unbind(-1))
    peer = torch.arange(g.P, dtype=torch.int32, device=like.device)
    return [(peer + om) % g.P for om in g.offs_mod]


@_lane_api
def elig_select_plain(config: SwarmConfig, scenario: SwarmScenario,
                      state: SwarmState):
    """Plain TK1: eligibility, holder selection, each slot's start
    decision and pinning (reference :796-1246 for the slice), slot by
    slot in the reference's order.  Slot 0 is the foreground: with
    prefetch slots (C > 1) a wish its own cache holds is absorbed
    (:1133-1141).  A prefetch slot starts P2P only, in the prefetch
    window, uncached, with holders and not already in flight on another
    slot (the dedup guard :1110-1118 against the processed slots' new
    records and the later slots' old ones; :1176-1183).  The holder by
    ``config.holder_selection`` (:993-1051): ``"spread"`` a hash over the
    eligible holders, ``"adaptive"`` the same over the lowest tier of
    the requester's own load on each offset (its other slots' P2P
    transfers, read by the same rule as the guard, :1185-1205) and the
    penalty window, ``"ranked"`` the holder of the (C-1)-th (foreground)
    or (c-1)-th (prefetch slot c) lowest peer id.  An active transfer
    keeps its stored holder under spread and adaptive; ranked picks
    anew every step (:1207-1228).  On the general path the eligibility
    gathers the neighbour list's entries (:859-866, :907-917; a self
    entry is padding) and offset index k is the list's column k.  Writes
    each slot record into ``state`` in place; returns ``(slot_flags,
    req)``,
    each ``[..., P, C]``: per slot bit 0 may, 1 active, 2 is_p2p, 3
    have_n, and on slot 0 bit 4 blocked on the live stagger, bit 5
    absorbed; ``req`` the offset index of the slot's selected holder
    where the slot places demand, else -1."""
    g = geometry(config)
    C = config.max_concurrency
    (present, want_level, next_seg, fg_wants, playhead, act, p2p_bits,
     gi_segs, gi_flats) = _slot_targets(config, scenario, state)
    p2p_req = scenario.p2p_ok
    serve_ok = present & (scenario.p2p_ok > 0.0)
    targets = [gi_flats[..., c] for c in range(C)]
    if g.general:
        elig_slots = gather_eligibility(state.avail, serve_ok,
                                        scenario.neighbors, targets)
        n_nbr = scenario.neighbors.shape[-1]
    else:
        elig_slots = circulant_eligibility(
            state.avail, serve_ok, list(g.offs), targets,
            impl=resolve_eligibility(config, state.avail.device))
        n_nbr = len(g.offs)
    ids = _holder_ids(g, scenario, next_seg) if (
        config.holder_selection == "ranked") else None

    margin_s = next_seg.to(torch.float32) * g.seg - playhead
    urgent = margin_s < (_col(scenario.urgent_margin_s)
                         + scenario.urgent_margin_off_s)
    budget_ms = torch.minimum(
        torch.maximum(margin_s * 1000.0 * _col(scenario.p2p_budget_fraction),
                      _col(scenario.p2p_budget_floor_ms)),
        _col(scenario.p2p_budget_cap_ms))
    lvl_iota = torch.arange(g.L, dtype=torch.int32, device=p2p_req.device)
    zero = torch.zeros((), dtype=torch.float32, device=p2p_req.device)
    want_bytes = torch.sum(
        torch.where(want_level.unsqueeze(-1) == lvl_iota,
                    scenario.bitrates.unsqueeze(-2), zero),
        dim=-1) * (g.seg / 8.0)
    t = _col(state.t_s)
    never = torch.zeros_like(present)
    # each slot's (active, flat target, holder offset, is_p2p) in flight:
    # the old record until the slot is processed, then its new one
    flight = [(act[..., c],
               state.dl_level[..., c] * g.S + state.dl_seg[..., c],
               state.dl_holder_off[..., c].clone(), p2p_bits[..., c])
              for c in range(C)]
    policy = config.holder_selection
    flags, reqs = [], []
    for c in range(C):
        a_c = act[..., c]
        if c == 0:
            target_seg, wants_c = next_seg, fg_wants
        else:
            raw = next_seg + c
            target_seg = torch.clamp_max(raw, g.S - 1)
            # the prefetch window (:1099-1108): in the timeline, within
            # max_buffer_s of the playhead, the slot's retry cooldown out
            in_window = (raw.to(torch.float32) * g.seg
                         < playhead + config.max_buffer_s)
            wants_c = (present & ~a_c & (raw <= g.S - 1) & in_window
                       & (state.dl_cooldown_ms[..., c] <= 0.0))
            if config.live:
                wants_c = wants_c & ((raw.to(torch.float32) + 1.0) * g.seg
                                     <= t)
        elig, n, own = elig_slots[c]
        elig = [e * p2p_req for e in elig]
        n = n * p2p_req
        have_n = n > 0.0
        if config.live:
            # P2P visibility (:1121-1128): the target is announced
            # announce_delay_s after it is published
            visible = t >= ((target_seg.to(torch.float32) + 1.0) * g.seg
                            + _col(scenario.announce_delay_s))
        if c == 0:
            absorb = fg_wants & own if C > 1 else never
            wants_dl = fg_wants & ~absorb
            start_p2p = wants_dl & have_n & ~urgent
            start_cdn = wants_dl & ~start_p2p
            if config.live:
                # the edge stagger (:1143-1168): with no start yet, the
                # CDN waits for the peer's stable share of the spread,
                # unless the fetch is urgent
                waited = state.fg_wait_ms + g.dt_ms
                cdn_allowed = waited >= (scenario.edge_rank
                                         * _col(scenario.live_spread_s)
                                         * 1000.0)
                start_p2p = start_p2p & visible
                start_cdn = wants_dl & ~start_p2p & (cdn_allowed | urgent)
            may = start_p2p | start_cdn
            is_p2p = torch.where(may, start_p2p, p2p_bits[..., c]) & have_n
            # bit 4, blocked on the stagger, from which peer_update runs
            # the wait clock (never set in VOD, where every wish starts)
            extra = absorb.to(torch.int32) << 5
            if config.live:
                extra = extra | ((wants_dl & ~may).to(torch.int32) << 4)
        else:
            target_flat = want_level * g.S + target_seg
            conflict = never
            for a_o, f_o, _o, _p in flight[:c] + flight[c + 1:]:
                conflict = conflict | (a_o & (f_o == target_flat))
            may = wants_c & have_n & ~conflict & ~own
            if config.live:
                may = may & visible
            is_p2p = p2p_bits[..., c] | may
            extra = 0
        active = a_c | may

        rot = state.dl_attempts[..., c]
        if policy == "ranked":
            sel = _nth_holder_only(elig, ids, C - 1 if c == 0 else c - 1)
        elif policy == "adaptive":
            # the offsets my other slots' P2P transfers ride
            own_used = []
            for k in range(n_nbr):
                used = never
                for a_o, _f, o_o, p_o in flight[:c] + flight[c + 1:]:
                    used = used | (a_o & p_o & (o_o == k))
                own_used.append(used)
            sel = _adaptive_holder_only(elig, own_used,
                                        state.holder_penalty_ms,
                                        gi_segs[..., c], rot, c)
        else:
            sel = _spread_holder_only(elig, n, gi_segs[..., c], rot, c)
        new_off = sum(((s_k > 0).to(torch.int32) * k
                       for k, s_k in enumerate(sel)),
                      torch.zeros_like(next_seg))
        off = torch.where(a_c, state.dl_holder_off[..., c], new_off)
        if policy != "ranked":
            sel = [torch.where(a_c, e * (off == k), s_k)
                   for k, (e, s_k) in enumerate(zip(elig, sel))]
        demand = (active & is_p2p & present).to(torch.float32)
        req = torch.full_like(next_seg, -1)
        for k, s_k in enumerate(sel):
            req = torch.where(s_k * demand > 0.0, torch.full_like(req, k),
                              req)

        seg_new = torch.where(may, target_seg, state.dl_seg[..., c])
        level_new = torch.where(may, want_level, state.dl_level[..., c])
        flight[c] = (active, level_new * g.S + seg_new, off, is_p2p)
        if c == 0:
            state.level.copy_(torch.where(may, want_level, state.level))
        state.dl_seg[..., c].copy_(seg_new)
        state.dl_level[..., c].copy_(level_new)
        for name, value in (("dl_total_bytes", want_bytes),
                            ("dl_done_bytes", zero), ("dl_elapsed_ms", zero),
                            ("dl_budget_ms", budget_ms)):
            col = getattr(state, name)[..., c]
            col.copy_(torch.where(may, value, col))
        state.dl_holder_off[..., c].copy_(off)
        flags.append(may.to(torch.int32) | (active.to(torch.int32) << 1)
                     | (is_p2p.to(torch.int32) << 2)
                     | (have_n.to(torch.int32) << 3) | extra)
        reqs.append(req)
    return torch.stack(flags, -1), torch.stack(reqs, -1)


@_lane_api
def admit_service_plain(config: SwarmConfig, scenario: SwarmScenario,
                        req: torch.Tensor):
    """Plain TK2 (reference :1259-1303): each holder admits its
    requesters in (slot, offset) order up to the cap (none when
    uncapped), one load count across the slots, then serves at uplink ·
    efficiency / load.  ``req`` is ``[..., P, C]``; returns ``(service
    [..., P] f32, adm [..., P, C] i32)``, ``adm`` per slot a bit mask of
    the admitted offset indices.  On the general path the plain TK2 of
    :func:`admit_gather`."""
    g = geometry(config)
    if g.general:
        return _admit_gather_plain(g, scenario, req)
    shape = req.shape[:-1]
    zeros = torch.zeros(shape, dtype=torch.float32, device=req.device)
    cum_j = zeros
    adms = []
    for c in range(req.shape[-1]):
        adm = torch.zeros(shape, dtype=torch.int32, device=req.device)
        for k, o in enumerate(g.offs):
            contrib_at_j = torch.roll((req[..., c] == k).to(torch.float32),
                                      o, -1)
            adm_at_j = torch.where((contrib_at_j > 0.0) & (cum_j < g.cap),
                                   contrib_at_j, zeros)
            cum_j = cum_j + adm_at_j
            adm = adm | ((adm_at_j > 0.0).to(torch.int32) << k)
        adms.append(adm)
    service = (scenario.uplink_bps * _col(scenario.uplink_efficiency)
               / torch.clamp_min(cum_j, 1.0))
    return service, torch.stack(adms, -1)


def _admit_gather_plain(g: Geometry, scenario: SwarmScenario,
                        req: torch.Tensor):
    """Plain ``admit_gather`` on lanes (reference :1304-1349): per slot,
    holder j gathers the contributions of its inbound edges
    ``in_edges[j]`` (flat ``i·K + k``, where requester i's slot selected
    column k), admits them in row order while its count plus those
    before them stays below the cap, and the admitted flags go back to
    the requesters.  Returns ``(service [B, P], adm [B, P, C])``, ``adm``
    the requester's admitted flag (0 where it placed no demand)."""
    in_e = scenario.in_edges
    B, P, _k_in = in_e.shape
    K = scenario.neighbors.shape[-1]
    dev = req.device
    ok = in_e >= 0
    flat = torch.clamp_min(in_e, 0).long()
    src = (flat // max(K, 1)).reshape(B, -1)
    col = (flat % max(K, 1)).to(torch.int32)
    cum_j = torch.zeros((B, P), dtype=torch.float32, device=dev)
    # scatter target of each inbound edge: its requester's flat slot, or
    # the spare entry past the end for padding
    target = torch.where(ok, flat, P * K).reshape(B, -1)
    adms = []
    for c in range(req.shape[-1]):
        r_c = req[..., c]
        contrib = ok & (torch.gather(r_c, -1, src).reshape(in_e.shape) == col)
        got = contrib.to(torch.float32)
        prior = torch.cumsum(got, dim=-1) - got
        adm = torch.where(contrib & (cum_j.unsqueeze(-1) + prior < g.cap),
                          got, 0.0)
        cum_j = cum_j + torch.sum(adm, dim=-1)
        adm_flat = torch.zeros((B, P * K + 1), dtype=torch.float32,
                               device=dev).scatter_reduce(
                                   -1, target, adm.reshape(B, -1), "amax")
        placed = r_c >= 0
        at = torch.where(placed, torch.arange(P, device=dev) * K
                         + r_c.long(), P * K)
        adms.append((torch.gather(adm_flat, -1, at) > 0.0).to(torch.int32))
    service = (scenario.uplink_bps * _col(scenario.uplink_efficiency)
               / torch.clamp_min(cum_j, 1.0))
    return service, torch.stack(adms, -1)


def select_admit_plain(config: SwarmConfig, scenario: SwarmScenario,
                       state: SwarmState):
    """Plain ``select_admit``: :func:`elig_select_plain` then
    :func:`admit_service_plain`.  Writes the slot records into
    ``state`` in place; returns ``(slot_flags, req, service, adm)``."""
    flags, req = elig_select_plain(config, scenario, state)
    return (flags, req) + admit_service_plain(config, scenario, req)


@_lane_api
def peer_update_plain(config: SwarmConfig, scenario: SwarmScenario,
                      state: SwarmState, slot_flags: torch.Tensor,
                      req: torch.Tensor, service: torch.Tensor,
                      adm: torch.Tensor) -> None:
    """Plain TK3: per slot in order, the service readback (reference
    :1297-1303) and the update (:1351-1493): slot 0's progress, BUSY
    fast-fail and budget failover; a prefetch slot's abort on lost
    holders, the request timeout or a BUSY deny, its ``retry_dead_ms``
    cooldown and its attempt rotation (:1436-1466); each slot's cache
    insert and EWMA sample, in slot order.  Then playback (an absorbed
    foreground adds a segment to the buffer, :1355) and the repack
    (:1495-1525), then the step's clock advance (``_scan_swarm``'s ``t_s
    + dt``, a float32 add).  In live mode playback steps from the
    floored playhead and starts ``live_sync_s`` after the join
    (:1500-1507), and the stagger's wait clock ``fg_wait_ms`` runs on
    where the selection reported the foreground blocked (slot 0's flag
    bit 4; :1165-1166), else resets; in VOD it is left alone.  Under
    ``"adaptive"`` the penalty window drains by ``dt_ms`` on every edge
    and re-arms to the scenario's ``holder_penalty_ms`` on the holder
    offset of a foreground BUSY deny and of every prefetch abort, in
    slot order (:1356-1358, :1405-1417, :1459-1466).  On the general
    path a slot's holder is its neighbour list's ``req``-th entry and its
    admitted flag its own (``adm``, as :func:`admit_gather` gives it).
    Uncapped, every demand was admitted, so no deny or admission abort
    fires (:1398, :1445).  Updates ``state`` in place."""
    g = geometry(config)
    C = config.max_concurrency
    dev = req.device
    zeros = torch.zeros(req.shape[:-1], dtype=torch.float32, device=dev)
    present = _present(scenario, state.t_s)
    pen = state.holder_penalty_ms
    if pen.shape[-1]:
        pen = torch.clamp_min(pen - g.dt_ms, 0.0)
        k_iota = torch.arange(pen.shape[-1], dtype=torch.int32, device=dev)
        rearm = scenario.holder_penalty_ms[:, None, None]

        def penalize(hit, c):
            off = state.dl_holder_off[..., c]
            return torch.where(hit[..., None] & (off[..., None] == k_iota),
                               rearm, pen)
    flags0 = slot_flags[..., 0]
    absorb = (flags0 & 32) != 0
    cdn_bytes, p2p_bytes = state.cdn_bytes, state.p2p_bytes
    buffer_add = torch.where(absorb, g.seg, 0.0)
    ewma = state.ewma
    insert = torch.zeros_like(state.avail)
    actives, p2ps = [], []
    for c in range(C):
        fl = slot_flags[..., c]
        may = (fl & 1) != 0
        s_active = (fl & 2) != 0
        s_is_p2p = (fl & 4) != 0
        have_n = (fl & 8) != 0

        # service readback: the admitted edge of the slot's requester
        if g.general:
            # its holder is the list's req-th neighbour (:1347-1349)
            placed = req[..., c] >= 0
            holder = torch.gather(scenario.neighbors, -1, torch.clamp_min(
                req[..., c], 0).long().unsqueeze(-1))[..., 0]
            admitted = placed & (adm[..., c] != 0)
            svc = torch.where(admitted, torch.gather(service, -1,
                                                     holder.long()), zeros)
        else:
            svc = zeros
            admitted = torch.zeros(zeros.shape, dtype=torch.bool,
                                   device=dev)
        for k, o in enumerate(g.offs):
            adm_k = (req[..., c] == k) & (
                ((torch.roll(adm[..., c], -o, -1) >> k) & 1) != 0)
            admitted = admitted | adm_k
            svc = svc + adm_k.to(torch.float32) * torch.roll(service, -o,
                                                              -1)
        demand = (s_active & s_is_p2p & present).to(torch.float32)

        total = state.dl_total_bytes[..., c]
        s_done = state.dl_done_bytes[..., c]
        p2p_rate = torch.clamp_max(demand * svc, config.p2p_bps)
        progressing = s_active & present
        elapsed = state.dl_elapsed_ms[..., c] + torch.where(
            progressing, g.dt_ms, 0.0)
        p2p_live_ms = torch.clamp(elapsed - _col(scenario.p2p_setup_ms), 0.0,
                                  g.dt_ms)
        p2p_step = _div(p2p_rate * p2p_live_ms, 8000.0)
        if c == 0:
            step_bytes = torch.where(s_is_p2p, p2p_step,
                                     _div(scenario.cdn_bps * g.dt_s, 8.0))
            cdn_accrue = torch.where(
                progressing & ~s_is_p2p,
                torch.minimum(step_bytes, torch.clamp_min(total - s_done,
                                                          0.0)),
                zeros)
        else:
            step_bytes = p2p_step
        done = s_done + torch.where(progressing, step_bytes, zeros)
        completed = progressing & (done >= total)
        active = s_active & ~completed
        is_p2p = s_is_p2p
        cooled = torch.clamp_min(state.dl_cooldown_ms[..., c] - g.dt_ms, 0.0)
        if c == 0:
            # BUSY fast-fail: a start the holder did not admit flips to
            # the CDN
            denied = may & is_p2p & have_n & ~admitted
            is_p2p = is_p2p & ~denied
            if pen.shape[-1]:
                pen = penalize(denied, c)
            done = torch.where(denied, zeros, done)
            elapsed = torch.where(denied, zeros, elapsed)
            # budget failover to the CDN, discarding partial bytes
            expired = active & is_p2p & (elapsed >= state.dl_budget_ms[..., 0])
            is_p2p = is_p2p & ~expired
            done = torch.where(expired, zeros, done)
            elapsed = torch.where(expired, zeros, elapsed)
            cdn_bytes = cdn_bytes + cdn_accrue
            p2p_bytes = p2p_bytes + torch.where(completed & is_p2p, total,
                                                zeros)
            buffer_add = buffer_add + torch.where(completed, g.seg, 0.0)
            cooldown = cooled
        else:
            # a prefetch whose holders vanished, whose request timed out
            # or whose start the holder denied is dropped, and the slot
            # cools down before asking again; its attempts rotate the
            # holder rank, and reset once one completes
            aborted = ((active & ~have_n)
                       | (active & (elapsed
                                    >= _col(scenario.request_timeout_ms)))
                       | (may & active & have_n & ~admitted))
            active = active & ~aborted
            if pen.shape[-1]:
                pen = penalize(aborted, c)
            done = torch.where(aborted, zeros, done)
            elapsed = torch.where(aborted, zeros, elapsed)
            p2p_bytes = p2p_bytes + torch.where(completed, total, zeros)
            cooldown = torch.where(aborted, _col(scenario.retry_dead_ms),
                                   cooled)
            attempts = state.dl_attempts[..., c]
            attempts.copy_(torch.where(completed, torch.zeros_like(attempts),
                                       attempts + aborted.to(torch.int32)))

        # cache insert: the slot's own (level, seg) bit
        Wm = bit_mask_words(state.dl_level[..., c] * g.S
                            + state.dl_seg[..., c], g.W)
        insert = insert | torch.where(
            completed.unsqueeze(-1), Wm,
            torch.zeros((), dtype=torch.int32, device=dev))
        sample_ms = torch.clamp_min(elapsed, MIN_SAMPLE_DURATION_MS)
        ewma = update(ewma, torch.where(completed, sample_ms, zeros),
                      torch.where(completed, total, zeros),
                      config.fast_half_life_s, config.slow_half_life_s)
        state.dl_done_bytes[..., c].copy_(done)
        state.dl_elapsed_ms[..., c].copy_(elapsed)
        state.dl_cooldown_ms[..., c].copy_(cooldown)
        actives.append(active)
        p2ps.append(is_p2p)

    # playback
    buffer_s = state.buffer_s + buffer_add
    if config.live:
        playhead = _live_playhead(scenario, state)
        can_play = present & (playhead < g.end_s) & (
            _col(state.t_s) >= scenario.join_s + _col(scenario.live_sync_s))
        blocked = (flags0 & 16) != 0
        state.fg_wait_ms.copy_(torch.where(blocked,
                                           state.fg_wait_ms + g.dt_ms, zeros))
    else:
        playhead = state.playhead_s
        can_play = present & (playhead < g.end_s)
    advance = torch.clamp_max(buffer_s, g.dt_s) * can_play
    rebuffer = state.rebuffer_s + torch.where(can_play, g.dt_s - advance,
                                              zeros)

    state.playhead_s.copy_(playhead + advance)
    state.buffer_s.copy_(buffer_s - advance)
    state.rebuffer_s.copy_(rebuffer)
    for dst, src in zip(state.ewma, ewma):
        dst.copy_(src)
    state.avail.bitwise_or_(insert)
    state.cdn_bytes.copy_(cdn_bytes)
    state.p2p_bytes.copy_(p2p_bytes)
    state.dl_flags.copy_(pack_dl_flags(actives, p2ps))
    state.holder_penalty_ms.copy_(pen)
    state.t_s.add_(g.dt_s)


def plain_step(config: SwarmConfig, scenario: SwarmScenario,
               state: SwarmState) -> SwarmState:
    """One step through the plain versions on any device, of one
    scenario or of lanes: the oracle a kernel step is held against.
    Updates ``state`` in place, the clock too (in
    :func:`peer_update_plain`), and returns it, as ``swarm_step``
    does."""
    flags, req, service, adm = select_admit_plain(config, scenario, state)
    peer_update_plain(config, scenario, state, flags, req, service, adm)
    return state


def lane_sums_plain(state: SwarmState, series=None, column: int = 0):
    """Plain TK4 on lanes: each lane's ``cdn_bytes`` and ``p2p_bytes``
    sums, returned as ``[B, 2]`` (cdn, p2p); with ``series`` it also
    writes ``p2p / max(p2p + cdn, 1)`` (the reference's
    ``offload_ratio``) into ``series[:, column]``."""
    p2p = torch.sum(state.p2p_bytes, dim=-1)
    cdn = torch.sum(state.cdn_bytes, dim=-1)
    if series is not None:
        series[:, column] = p2p / torch.clamp_min(p2p + cdn, 1.0)
    return torch.stack([cdn, p2p], dim=-1)


def _tree(v: torch.Tensor) -> torch.Tensor:
    """The kernels' tree over the last axis (a power of two, n): at
    strides n/2, ..., 1, entry i adds entry i + stride
    (``ls_warp_sum`` for 32)."""
    s = v.shape[-1] // 2
    while s:
        v = v[..., :s] + v[..., s:2 * s]
        s //= 2
    return v[..., 0]


def lane_sums_in_order(state: SwarmState) -> torch.Tensor:
    """Each lane's ``[B, 2]`` (cdn, p2p) sums in the kernels' order
    (``csrc/lane_sums.cuh``), as float32 PyTorch adds: on the card, the
    bits ``lane_sums`` and ``peer_update``'s epilogue give.  Peers past
    P, partials past the lane's last and super-partials past its last
    add as zeros, as in the kernels."""
    x = torch.stack([state.cdn_bytes, state.p2p_bytes], dim=1)
    B, _two, P = x.shape
    n_sup = sums_supers(P)
    x = torch.nn.functional.pad(x, (0, n_sup * SUMS_FAN * SUMS_BLOCK - P))
    # a partial: 8 runs of 32 peers, each run's tree, then the runs' tree
    part = _tree(_tree(x.view(B, 2, n_sup * SUMS_FAN, SUMS_BLOCK // 32, 32)))
    sup = _tree(part.view(B, 2, n_sup, SUMS_FAN))
    rounds = -(-n_sup // 32)
    sup = torch.nn.functional.pad(sup, (0, rounds * 32 - n_sup))
    acc = torch.zeros((B, 2, 32), dtype=torch.float32, device=x.device)
    for i in range(rounds):
        acc = acc + sup[..., 32 * i:32 * (i + 1)]
    return _tree(acc)


def _rebuffer_plain(reb, join, leave, t):
    """Per-lane stall time over watched time ``Σ clip(min(leave, t) -
    join, 0)`` (reference :1573-1578 and ``rebuffer_ratio``)."""
    watched = torch.sum(torch.clamp_min(torch.minimum(leave, _col(t)) - join,
                                        0.0), dim=-1)
    return torch.sum(reb, dim=-1) / torch.clamp_min(watched, 1e-9)


def rate_factor(config: SwarmConfig, record_every: int) -> float:
    """``8 / interval_s`` as the reference's row applies it: XLA folds
    ``delta * 8.0 / interval_s``, a division by a constant, into one
    multiplication by a float32 constant (``* 3.2`` for a 2.5 s
    interval in the compiled HLO), and so does the port."""
    interval_s = record_every * config.dt_ms / 1000.0
    return float(np.float32(8.0) * (np.float32(1.0) / np.float32(interval_s)))


@functools.lru_cache(maxsize=None)
def _edges(device: torch.device) -> torch.Tensor:
    """The stall-digest edges as float32 on ``device`` (made once)."""
    return torch.tensor(DEFAULT_EDGES, dtype=torch.float32, device=device)


def timeline_row_plain(config: SwarmConfig, scenario: SwarmScenario,
                       state: SwarmState, sums: torch.Tensor,
                       prev_sums: torch.Tensor, prev_rebuffer: torch.Tensor,
                       out: torch.Tensor, sample: int,
                       record_every: int) -> None:
    """Plain TK5 on lanes (reference ``_timeline_row`` :1559-1627):
    writes ``out[:, sample, :]``, the row of
    :func:`~swarm_sim.timeline_columns`, from the state, this step's
    ``sums`` (``peer_update``'s), and the previous sample's ``prev_sums``
    and ``prev_rebuffer``, which it then updates in place.  With
    ``config.n_cohorts > 0``, per cohort k (reference :1594-1611): its
    present peers, its peers whose rebuffer clock moved in the interval,
    and ``p2p_k / max(p2p_k + cdn_k, 1)`` from its masked byte sums."""
    t = state.t_s
    cdn, p2p = sums[:, 0], sums[:, 1]
    offload = p2p / torch.clamp_min(p2p + cdn, 1.0)
    rebuffer = _rebuffer_plain(state.rebuffer_s, scenario.join_s,
                               scenario.leave_s, t)
    k = rate_factor(config, record_every)
    cdn_rate = (cdn - prev_sums[:, 0]) * k
    p2p_rate = (p2p - prev_sums[:, 1]) * k
    stalled = torch.sum((state.rebuffer_s > prev_rebuffer).to(torch.float32),
                        dim=-1)
    present = _present(scenario, t).unsqueeze(-1)
    lvl = torch.arange(config.n_levels, dtype=state.level.dtype,
                       device=t.device)
    parts = [torch.stack([t, offload, rebuffer, cdn_rate, p2p_rate, stalled],
                         dim=-1),
             torch.sum((present & (state.level.unsqueeze(-1) == lvl))
                       .to(torch.float32), dim=-2)]
    if config.n_cohorts:
        moved = state.rebuffer_s > prev_rebuffer
        cols = []
        for k in range(config.n_cohorts):
            mask = scenario.cohort_id == k
            p2p_k = torch.sum(torch.where(mask, state.p2p_bytes, 0.0), dim=-1)
            tot_k = p2p_k + torch.sum(torch.where(mask, state.cdn_bytes, 0.0),
                                      dim=-1)
            cols += [torch.sum((present[..., 0] & mask).to(torch.float32),
                               dim=-1),
                     torch.sum((moved & mask).to(torch.float32), dim=-1),
                     p2p_k / torch.clamp_min(tot_k, 1.0)]
        parts.append(torch.stack(cols, dim=-1))
    if config.stall_digest:
        edges = _edges(t.device)
        interval_ms = (state.rebuffer_s - prev_rebuffer) * 1000.0
        idx = torch.searchsorted(edges, interval_ms, side="left")
        bins = torch.arange(edges.shape[0] + 1, device=t.device)
        parts.append(torch.sum(((idx.unsqueeze(-1) == bins) & present)
                               .to(torch.float32), dim=-2))
    out[:, sample] = torch.cat(parts, dim=-1)
    prev_sums.copy_(sums)
    prev_rebuffer.copy_(state.rebuffer_s)


# ---- the kernels ----------------------------------------------------------

_P = ctypes.c_void_p


class _SelectArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "t_s", "join_s", "leave_s", "p2p_ok", "abr_cap_level",
        "urgent_margin_off_s", "bitrates", "urgent_margin_s",
        "p2p_budget_fraction", "p2p_budget_cap_ms", "p2p_budget_floor_ms",
        "playhead_s", "buffer_s", "fast_estimate", "fast_weight",
        "slow_estimate", "slow_weight", "avail", "dl_flags", "dl_attempts",
        "level", "dl_seg", "dl_level", "dl_done_bytes", "dl_total_bytes",
        "dl_elapsed_ms", "dl_budget_ms", "dl_holder_off", "slot_flags",
        "req")] + [
        ("n_peers", ctypes.c_longlong), ("n_lanes", ctypes.c_int),
        ("n_words", ctypes.c_int),
        ("n_segments", ctypes.c_int), ("n_levels", ctypes.c_int),
        ("n_offs", ctypes.c_int)] + [
        (name, ctypes.c_float) for name in (
            "seg_duration_s", "inv_seg_duration_s", "max_buffer_s",
            "end_s", "fast_alpha",
            "slow_alpha", "default_estimate_bps", "bandwidth_safety")] + [
        ("offs", ctypes.c_int * MAX_OFFS)] + [
        (name, _P) for name in (
            "edge_rank", "fg_wait_ms", "live_sync_s", "live_spread_s",
            "announce_delay_s")] + [
        ("dt_ms", ctypes.c_float), ("live", ctypes.c_int),
        ("dl_cooldown_ms", _P), ("n_slots", ctypes.c_int),
        ("holder_penalty_ms", _P), ("policy", ctypes.c_int),
        ("rank_order", ctypes.c_int * MAX_OFFS), ("neighbors", _P)]


class _AdmitArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "req", "uplink_bps", "uplink_efficiency", "service", "adm_mask")] + [
        ("n_peers", ctypes.c_longlong), ("n_lanes", ctypes.c_int),
        ("n_offs", ctypes.c_int),
        ("cap", ctypes.c_float), ("offs", ctypes.c_int * MAX_OFFS),
        ("n_slots", ctypes.c_int), ("in_edges", _P), ("n_in", ctypes.c_int)]


class _SelectAdmitArgs(ctypes.Structure):
    _fields_ = [("sel", _SelectArgs)] + [(name, _P) for name in (
        "uplink_bps", "uplink_efficiency", "service", "adm_mask")] + [
        ("cap", ctypes.c_float), ("o_max", ctypes.c_int),
        ("o_min", ctypes.c_int), ("soffs", ctypes.c_int * MAX_OFFS)]


class _UpdateArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "t_s", "join_s", "leave_s", "cdn_bps", "p2p_setup_ms", "slot_flags",
        "req", "service", "adm_mask", "dl_seg", "dl_level",
        "dl_total_bytes", "dl_budget_ms", "playhead_s", "buffer_s",
        "rebuffer_s", "fast_estimate", "fast_weight", "slow_estimate",
        "slow_weight", "avail", "cdn_bytes", "p2p_bytes", "dl_flags",
        "dl_done_bytes", "dl_elapsed_ms", "dl_cooldown_ms", "partials",
        "counters", "sums", "series")] + [
        ("n_peers", ctypes.c_longlong), ("series_stride", ctypes.c_longlong),
        ("n_lanes", ctypes.c_int), ("n_words", ctypes.c_int),
        ("n_segments", ctypes.c_int), ("n_offs", ctypes.c_int),
        ("column", ctypes.c_int)] + [
        (name, ctypes.c_float) for name in (
            "seg_duration_s", "end_s", "dt_ms", "dt_s", "p2p_bps",
            "fast_alpha", "slow_alpha", "min_sample_ms")] + [
        ("offs", ctypes.c_int * MAX_OFFS),
        ("live_sync_s", _P), ("fg_wait_ms", _P), ("live", ctypes.c_int),
        ("dl_attempts", _P), ("request_timeout_ms", _P),
        ("retry_dead_ms", _P), ("n_slots", ctypes.c_int),
        ("holder_penalty_ms", _P), ("dl_holder_off", _P),
        ("penalty_ms", _P), ("penalty", ctypes.c_int), ("neighbors", _P)]


class _LaneSumsArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "p2p_bytes", "cdn_bytes", "partials", "counters", "sums",
        "series")] + [
        ("n_peers", ctypes.c_longlong), ("series_stride", ctypes.c_longlong),
        ("n_lanes", ctypes.c_int), ("n_blocks", ctypes.c_int),
        ("column", ctypes.c_int)]


class _TimelineArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "t_s", "join_s", "leave_s", "rebuffer_s", "prev_rebuffer", "level",
        "sums", "prev_sums", "edges", "partials", "counters", "row")] + [
        ("n_peers", ctypes.c_longlong), ("row_stride", ctypes.c_longlong),
        ("n_lanes", ctypes.c_int), ("n_blocks", ctypes.c_int),
        ("n_levels", ctypes.c_int), ("n_edges", ctypes.c_int),
        ("rate", ctypes.c_float), ("cohort_id", _P), ("p2p_bytes", _P),
        ("cdn_bytes", _P), ("n_cohorts", ctypes.c_int)]


#: kernel -> (source, C entry point, argument struct)
_ENTRY = {"elig_select": (SOURCE, "swarm_elig_select", _SelectArgs),
          "admit_service": (SOURCE, "swarm_admit_service", _AdmitArgs),
          "peer_update": (SOURCE, "swarm_peer_update", _UpdateArgs),
          "select_admit": (SOURCE, "swarm_select_admit", _SelectAdmitArgs),
          "elig_select_gather": (SOURCE, "swarm_elig_select_gather",
                                 _SelectArgs),
          "admit_gather": (SOURCE, "swarm_admit_gather", _AdmitArgs),
          "peer_update_gather": (SOURCE, "swarm_peer_update_gather",
                                 _UpdateArgs),
          "lane_sums": (REDUCE_SOURCE, "reduce_lane_sums", _LaneSumsArgs),
          "timeline_row": (REDUCE_SOURCE, "reduce_timeline_row",
                           _TimelineArgs),
          "timeline_row_cohorts": (REDUCE_SOURCE, "reduce_timeline_row",
                                   _TimelineArgs)}
#: each source's macros, its entry point that reports its structs' sizes
#: (of the structs listed, in that order), and the one that loads its
#: kernels onto the card (so that none loads lazily inside a graph
#: capture)
_SOURCES = {SOURCE: (DEFINES, "swarm_args_sizes", "swarm_preload",
                     (_SelectArgs, _AdmitArgs, _UpdateArgs,
                      _SelectAdmitArgs)),
            REDUCE_SOURCE: ((), "reduce_args_sizes", "reduce_preload",
                            (_LaneSumsArgs, _TimelineArgs))}


@functools.lru_cache(maxsize=None)
def _lib(source: str) -> ctypes.CDLL:
    """Build (once, on first use) and bind one source's library, check
    the ctypes mirrors against the C structs' sizes, and load its
    kernels onto the card."""
    from . import _build
    defines, sizes_fn, preload_fn, structs = _SOURCES[source]
    lib = _build.load(source, defines)
    for src, fn, _args in _ENTRY.values():
        if src == source:
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            f.restype = ctypes.c_int
    get_sizes = getattr(lib, sizes_fn)
    get_sizes.argtypes = [ctypes.c_void_p]
    get_sizes.restype = ctypes.c_int
    sizes = (ctypes.c_longlong * len(structs))()
    get_sizes(sizes)
    want = [ctypes.sizeof(a) for a in structs]
    if list(sizes) != want:
        raise RuntimeError(f"{source}: kernel argument structs disagree "
                           f"with their ctypes mirrors: C {list(sizes)} vs "
                           f"{want}")
    preload = getattr(lib, preload_fn)
    preload.restype = ctypes.c_int
    rc = preload()
    if rc != 0:
        raise RuntimeError(f"{source}: loading its kernels failed: CUDA "
                           f"error {rc}")
    return lib


def build_kernels(force: bool = False) -> dict:
    """Build (anew with ``force``) and bind every source now, one
    ``nvcc`` each, started together; they build on first launch
    otherwise.  Returns the build's report (``_build.build``)."""
    from . import _build
    info = _build.build({src: v[0] for src, v in _SOURCES.items()},
                        force=force)
    for src in _SOURCES:
        _lib(src)
    return info


def _launch(wrapper: str, args: ctypes.Structure, device) -> None:
    """Launch the kernel that ``wrapper`` launches (:data:`KERNEL_OF`)
    and count it."""
    name = KERNEL_OF[wrapper]
    source, fn_name, _args = _ENTRY[name]
    fn = getattr(_lib(source), fn_name)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(ctypes.byref(args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> int:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    return t.data_ptr()


def _offs_array(offs_mod):
    if len(offs_mod) > MAX_OFFS:
        raise ValueError(f"{len(offs_mod)} circulant offsets; the kernels "
                         f"take at most {MAX_OFFS}")
    return (ctypes.c_int * MAX_OFFS)(*offs_mod)


_F, _I = torch.float32, torch.int32


_SCALARS = frozenset(("urgent_margin_s", "p2p_budget_fraction",
                      "p2p_budget_cap_ms", "p2p_budget_floor_ms",
                      "p2p_setup_ms", "uplink_efficiency", "live_sync_s",
                      "live_spread_s", "announce_delay_s",
                      "request_timeout_ms", "retry_dead_ms"))

#: the kernels' code for each holder policy (``POL_*`` in the source)
POLICY_CODES = {"spread": 0, "adaptive": 1, "ranked": 2}


def _n_nbr(config: SwarmConfig, scenario: SwarmScenario) -> int:
    """K: the normalized offsets, or the general path's list width."""
    g = geometry(config)
    return scenario.neighbors.shape[-1] if g.general else len(g.offs)


def _penalty(config: SwarmConfig, scenario: SwarmScenario,
             state: SwarmState, dev) -> int:
    """The penalty window's pointer, checked: ``[B, P, K]`` under
    ``"adaptive"`` (a K = 8 row is read and written as two 16-byte
    accesses, so the field must be 16-byte aligned), else ``[B, P, 0]``,
    which no kernel reads."""
    g = geometry(config)
    width = (_n_nbr(config, scenario)
             if config.holder_selection == "adaptive" else 0)
    ptr = _check("holder_penalty_ms", state.holder_penalty_ms, _F,
                 (state.t_s.shape[0], g.P, width), dev)
    if width and ptr % 16:
        raise ValueError("holder_penalty_ms is not 16-byte aligned")
    return ptr


def _neighbors(config: SwarmConfig, scenario: SwarmScenario, B: int,
               dev) -> int:
    """The general path's neighbour list ``[B, P, K]``, checked: at most
    :data:`MAX_OFFS` wide (the kernels' bit masks)."""
    g = geometry(config)
    K = scenario.neighbors.shape[-1]
    if K > MAX_OFFS:
        raise ValueError(f"a neighbour list {K} wide; the kernels take at "
                         f"most {MAX_OFFS} neighbours a peer")
    return _check("neighbors", scenario.neighbors, _I, (B, g.P, K), dev)


def _scenario_ptrs(scenario: SwarmScenario, names, B, P, L, dev) -> dict:
    out = {}
    for name in names:
        shape = ((B,) if name in _SCALARS
                 else (B, L) if name == "bitrates" else (B, P))
        dtype = _I if name == "abr_cap_level" else _F
        out[name] = _check(name, getattr(scenario, name), dtype, shape, dev)
    return out


def _select_args(config: SwarmConfig, scenario: SwarmScenario,
                 state: SwarmState, dev):
    """TK1's arguments (also the selection half of ``select_admit``'s,
    and on the general path its gather form's), checked, with fresh
    ``slot_flags`` and ``req`` outputs.  The live inputs are passed for
    a VOD config too, whose kernels never read them."""
    g = geometry(config)
    P = g.P
    B = state.t_s.shape[0]
    C = config.max_concurrency
    slot_flags = torch.empty((B, P, C), dtype=_I, device=dev)
    req = torch.empty((B, P, C), dtype=_I, device=dev)
    ptrs = _scenario_ptrs(scenario, (
        "join_s", "leave_s", "p2p_ok", "abr_cap_level",
        "urgent_margin_off_s", "bitrates", "urgent_margin_s",
        "p2p_budget_fraction", "p2p_budget_cap_ms", "p2p_budget_floor_ms",
        "edge_rank", "live_sync_s", "live_spread_s", "announce_delay_s"),
        B, P, g.L, dev)
    ptrs["fg_wait_ms"] = _check("fg_wait_ms", state.fg_wait_ms, _F, (B, P),
                                dev)
    ptrs["t_s"] = _check("t_s", state.t_s, _F, (B,), dev)
    for name in ("playhead_s", "buffer_s"):
        ptrs[name] = _check(name, getattr(state, name), _F, (B, P), dev)
    for name, t in state.ewma._asdict().items():
        ptrs[name] = _check(name, t, _F, (B, P), dev)
    ptrs["avail"] = _check("avail", state.avail, _I, (B, P, g.W), dev)
    ptrs["dl_flags"] = _check("dl_flags", state.dl_flags, _I, (B, P), dev)
    ptrs["level"] = _check("level", state.level, _I, (B, P), dev)
    for name in ("dl_attempts", "dl_seg", "dl_level", "dl_holder_off"):
        ptrs[name] = _check(name, getattr(state, name), _I, (B, P, C), dev)
    for name in ("dl_done_bytes", "dl_total_bytes", "dl_elapsed_ms",
                 "dl_budget_ms", "dl_cooldown_ms"):
        ptrs[name] = _check(name, getattr(state, name), _F, (B, P, C), dev)
    ptrs["slot_flags"] = slot_flags.data_ptr()
    ptrs["req"] = req.data_ptr()
    ptrs["holder_penalty_ms"] = _penalty(config, scenario, state, dev)
    if g.general:
        ptrs["neighbors"] = _neighbors(config, scenario, B, dev)
    args = _SelectArgs(
        **ptrs, n_peers=P, n_lanes=B, n_words=g.W, n_segments=g.S,
        n_levels=g.L, n_offs=_n_nbr(config, scenario), seg_duration_s=g.seg,
        inv_seg_duration_s=float(np.float32(1.0) / np.float32(g.seg)),
        max_buffer_s=config.max_buffer_s, end_s=g.end_s,
        fast_alpha=g.fast_alpha, slow_alpha=g.slow_alpha,
        default_estimate_bps=DEFAULT_ESTIMATE_BPS,
        bandwidth_safety=BANDWIDTH_SAFETY, offs=_offs_array(g.offs_mod),
        dt_ms=g.dt_ms, live=int(config.live), n_slots=C,
        policy=POLICY_CODES[config.holder_selection],
        rank_order=_offs_array(g.rank_order))
    return args, slot_flags, req


@_lane_api
def elig_select(config: SwarmConfig, scenario: SwarmScenario,
                state: SwarmState):
    """TK1.  Same signature and outputs as :func:`elig_select_plain`."""
    dev = state.avail.device
    if dev.type != "cuda":
        return elig_select_plain(config, scenario, state)
    args, slot_flags, req = _select_args(config, scenario, state, dev)
    _launch("elig_select", args, dev)
    return slot_flags, req


@_lane_api
def elig_select_gather(config: SwarmConfig, scenario: SwarmScenario,
                       state: SwarmState):
    """TK1's gather form, the general ``[P, K]`` path: same signature and
    outputs as :func:`elig_select_plain` (which takes both paths)."""
    if not geometry(config).general:
        raise ValueError("elig_select_gather runs the general [P, K] path "
                         "(config.neighbor_offsets None)")
    dev = state.avail.device
    if dev.type != "cuda":
        return elig_select_plain(config, scenario, state)
    args, slot_flags, req = _select_args(config, scenario, state, dev)
    _launch("elig_select_gather", args, dev)
    return slot_flags, req


def _select_admit_args(config: SwarmConfig, scenario: SwarmScenario,
                       state: SwarmState, dev):
    g = geometry(config)
    B = state.t_s.shape[0]
    sel, slot_flags, req = _select_args(config, scenario, state, dev)
    service = torch.empty((B, g.P), dtype=_F, device=dev)
    adm = torch.empty((B, g.P, config.max_concurrency), dtype=_I, device=dev)
    args = _SelectAdmitArgs(
        sel=sel,
        uplink_bps=_check("uplink_bps", scenario.uplink_bps, _F, (B, g.P),
                          dev),
        uplink_efficiency=_check("uplink_efficiency",
                                 scenario.uplink_efficiency, _F, (B,), dev),
        service=service.data_ptr(), adm_mask=adm.data_ptr(),
        cap=g.cap, o_max=g.o_hi, o_min=g.o_lo,
        soffs=_offs_array(g.offs))
    return args, (slot_flags, req, service, adm)


@_lane_api
def select_admit(config: SwarmConfig, scenario: SwarmScenario,
                 state: SwarmState):
    """TK1 and TK2 of one step: same signature and outputs as
    :func:`select_admit_plain`.  On every device it takes the fused
    kernel (:func:`select_admit_fused`) where :func:`fused_route` holds,
    else TK1 then TK2; on the general path their gather forms."""
    if geometry(config).general:
        flags, req = elig_select_gather(config, scenario, state)
        return (flags, req) + admit_gather(config, scenario, req)
    if not fused_route(config):
        flags, req = elig_select(config, scenario, state)
        return (flags, req) + admit_service(config, scenario, req)
    return select_admit_fused(config, scenario, state)


@_lane_api
def select_admit_fused(config: SwarmConfig, scenario: SwarmScenario,
                       state: SwarmState):
    """The fused kernel of TK1 and TK2, for an offset tuple that fits
    its tile.  Same signature and outputs as
    :func:`select_admit_plain`."""
    dev = state.avail.device
    if dev.type != "cuda":
        return select_admit_plain(config, scenario, state)
    args, out = _select_admit_args(config, scenario, state, dev)
    _launch("select_admit_fused", args, dev)
    return out


def _admit_args(config: SwarmConfig, scenario: SwarmScenario,
                req: torch.Tensor, dev):
    """TK2's arguments (either form), checked, with fresh ``service``
    and ``adm`` outputs."""
    g = geometry(config)
    P = g.P
    B = req.shape[0]
    C = config.max_concurrency
    service = torch.empty((B, P), dtype=_F, device=dev)
    adm = torch.empty((B, P, C), dtype=_I, device=dev)
    extra = {}
    if g.general:
        n_in = scenario.in_edges.shape[-1]
        _neighbors(config, scenario, B, dev)
        extra = dict(in_edges=_check("in_edges", scenario.in_edges, _I,
                                     (B, P, n_in), dev), n_in=n_in)
    args = _AdmitArgs(
        req=_check("req", req, _I, (B, P, C), dev),
        uplink_bps=_check("uplink_bps", scenario.uplink_bps, _F, (B, P),
                          dev),
        uplink_efficiency=_check("uplink_efficiency",
                                 scenario.uplink_efficiency, _F, (B,), dev),
        service=service.data_ptr(), adm_mask=adm.data_ptr(),
        n_peers=P, n_lanes=B, n_offs=_n_nbr(config, scenario), cap=g.cap,
        offs=_offs_array(g.offs_mod), n_slots=C, **extra)
    return args, service, adm


@_lane_api
def admit_service(config: SwarmConfig, scenario: SwarmScenario,
                  req: torch.Tensor):
    """TK2.  Same signature and outputs as :func:`admit_service_plain`."""
    dev = req.device
    if dev.type != "cuda":
        return admit_service_plain(config, scenario, req)
    args, service, adm = _admit_args(config, scenario, req, dev)
    _launch("admit_service", args, dev)
    return service, adm


@_lane_api
def admit_gather(config: SwarmConfig, scenario: SwarmScenario,
                 req: torch.Tensor):
    """TK2's gather form, the general ``[P, K]`` path: the admission over
    each holder's inbound edge lists ``scenario.in_edges``, in their
    order, and its service.  Same signature as
    :func:`admit_service_plain`; ``adm`` holds per requester and slot
    its admitted flag, defined where ``req >= 0`` (the kernel writes
    nothing elsewhere; the plain version 0)."""
    if not geometry(config).general:
        raise ValueError("admit_gather runs the general [P, K] path "
                         "(config.neighbor_offsets None)")
    dev = req.device
    if dev.type != "cuda":
        return admit_service_plain(config, scenario, req)
    args, service, adm = _admit_args(config, scenario, req, dev)
    _launch("admit_gather", args, dev)
    return service, adm


def _update_args(config: SwarmConfig, scenario: SwarmScenario,
                 state: SwarmState, slot_flags, req, service, adm, series,
                 column: int, dev):
    """TK3's arguments (either form), checked, its ``[B, 2]`` sums output
    and its partials scratch, which the caller holds until the launch is
    queued."""
    g = geometry(config)
    P = g.P
    B = state.t_s.shape[0]
    C = config.max_concurrency
    ptrs = _scenario_ptrs(scenario, ("join_s", "leave_s", "cdn_bps",
                                     "p2p_setup_ms", "live_sync_s",
                                     "request_timeout_ms", "retry_dead_ms"),
                          B, P, g.L, dev)
    ptrs["penalty_ms"] = _check("holder_penalty_ms (scenario)",
                                scenario.holder_penalty_ms, _F, (B,), dev)
    ptrs["holder_penalty_ms"] = _penalty(config, scenario, state, dev)
    if g.general:
        ptrs["neighbors"] = _neighbors(config, scenario, B, dev)
    ptrs["t_s"] = _check("t_s", state.t_s, _F, (B,), dev)
    ptrs["slot_flags"] = _check("slot_flags", slot_flags, _I, (B, P, C),
                                dev)
    ptrs["req"] = _check("req", req, _I, (B, P, C), dev)
    ptrs["service"] = _check("service", service, _F, (B, P), dev)
    ptrs["adm_mask"] = _check("adm", adm, _I, (B, P, C), dev)
    for name in ("playhead_s", "buffer_s", "rebuffer_s", "cdn_bytes",
                 "p2p_bytes", "fg_wait_ms"):
        ptrs[name] = _check(name, getattr(state, name), _F, (B, P), dev)
    for name, t in state.ewma._asdict().items():
        ptrs[name] = _check(name, t, _F, (B, P), dev)
    ptrs["avail"] = _check("avail", state.avail, _I, (B, P, g.W), dev)
    ptrs["dl_flags"] = _check("dl_flags", state.dl_flags, _I, (B, P), dev)
    for name in ("dl_seg", "dl_level", "dl_attempts", "dl_holder_off"):
        ptrs[name] = _check(name, getattr(state, name), _I, (B, P, C), dev)
    for name in ("dl_total_bytes", "dl_budget_ms", "dl_done_bytes",
                 "dl_elapsed_ms", "dl_cooldown_ms"):
        ptrs[name] = _check(name, getattr(state, name), _F, (B, P, C), dev)
    sums, partials, out = _sums_out(dev, "peer_update", B, P, series,
                                    column)
    args = _UpdateArgs(
        **ptrs, **out, n_peers=P, n_lanes=B, n_words=g.W, n_segments=g.S,
        n_offs=_n_nbr(config, scenario), seg_duration_s=g.seg,
        end_s=g.end_s, dt_ms=g.dt_ms, dt_s=g.dt_s, p2p_bps=config.p2p_bps,
        fast_alpha=g.fast_alpha, slow_alpha=g.slow_alpha,
        min_sample_ms=MIN_SAMPLE_DURATION_MS, offs=_offs_array(g.offs_mod),
        live=int(config.live), n_slots=C,
        penalty=int(config.holder_selection == "adaptive"))
    return args, sums, partials


@_lane_api
def peer_update(config: SwarmConfig, scenario: SwarmScenario,
                state: SwarmState, slot_flags: torch.Tensor,
                req: torch.Tensor, service: torch.Tensor,
                adm: torch.Tensor, *, series=None,
                column: int = 0) -> torch.Tensor:
    """TK3 with TK4's sums and the clock's advance in its epilogue:
    :func:`peer_update_plain` (which advances ``t_s``) then
    :func:`lane_sums_plain` on the updated state, in one launch.
    Updates ``state`` in place and returns each lane's ``[B, 2]`` (cdn,
    p2p) sums; with ``series`` (a ``[B, n]`` float32 tensor) it also
    writes the offload ratio into ``series[:, column]``.  The sums are
    the bits :func:`lane_sums` gives on the updated state.  On the
    general ``[P, K]`` path it takes :func:`peer_update_gather`."""
    if geometry(config).general:
        return peer_update_gather(config, scenario, state, slot_flags, req,
                                  service, adm, series=series,
                                  column=column)
    dev = state.avail.device
    if dev.type != "cuda":
        peer_update_plain(config, scenario, state, slot_flags, req, service,
                          adm)
        return lane_sums_plain(state, series, column)
    args, sums, _partials = _update_args(config, scenario, state,
                                         slot_flags, req, service, adm,
                                         series, column, dev)
    _launch("peer_update", args, dev)
    return sums


@_lane_api
def peer_update_gather(config: SwarmConfig, scenario: SwarmScenario,
                       state: SwarmState, slot_flags: torch.Tensor,
                       req: torch.Tensor, service: torch.Tensor,
                       adm: torch.Tensor, *, series=None,
                       column: int = 0) -> torch.Tensor:
    """TK3's gather form, the general ``[P, K]`` path: as
    :func:`peer_update`, with each slot's holder the neighbour list's
    ``req``-th entry and ``adm`` the requesters' admitted flags
    (:func:`admit_gather`)."""
    if not geometry(config).general:
        raise ValueError("peer_update_gather runs the general [P, K] path "
                         "(config.neighbor_offsets None)")
    dev = state.avail.device
    if dev.type != "cuda":
        peer_update_plain(config, scenario, state, slot_flags, req, service,
                          adm)
        return lane_sums_plain(state, series, column)
    args, sums, _partials = _update_args(config, scenario, state,
                                         slot_flags, req, service, adm,
                                         series, column, dev)
    _launch("peer_update_gather", args, dev)
    return sums


# ---- the reductions ---------------------------------------------------------

#: per (device, kernel): zeroed u32 arrival counters of the last-block
#: reductions (:func:`arrival_counters`).  The last arrival at each
#: counter sets it back to 0, so the buffer is zero between launches and
#: is made once (grown when a launch outgrows it).
_COUNTERS: Dict[Tuple[torch.device, str], torch.Tensor] = {}


def _counters(dev: torch.device, name: str, n: int) -> int:
    buf = _COUNTERS.get((dev, name))
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 64),), dtype=_I, device=dev)
        _COUNTERS[(dev, name)] = buf
    return buf.data_ptr()


def sums_blocks(n_peers: int) -> int:
    """Partials per lane of the offload sums: one per
    :data:`SUMS_BLOCK` peers, which is one ``peer_update`` block."""
    return -(-n_peers // SUMS_BLOCK)


def sums_supers(n_peers: int) -> int:
    """Super-partials per lane of the offload sums: one per
    :data:`SUMS_FAN` partials, which is one ``lane_sums`` block."""
    return -(-sums_blocks(n_peers) // SUMS_FAN)


def arrival_counters(name: str, B: int, P: int) -> int:
    """Arrival counters kernel ``name`` takes on ``B`` lanes of ``P``
    peers: one a lane, and for ``peer_update`` one a super-partial."""
    return B * (1 + sums_supers(P)) if name == "peer_update" else B


def _sums_out(dev, name: str, B: int, P: int, series, column: int):
    """The offload sums' outputs for kernel ``name``: a fresh ``[B, 2]``
    sums tensor, its scratch (held by the caller until the launch is
    queued: ``peer_update``'s partials and super-partials, ``[B,
    n_blocks + n_sup, 2]``, or ``lane_sums``' super-partials, ``[B,
    n_sup, 2]``), and the struct fields that point at them, the arrival
    counters and ``series[:, column]``, checked."""
    if P == 0:
        raise ValueError(f"{name} needs at least one peer")
    stride = 0
    if series is not None:
        if (series.device != dev or series.dtype != _F or series.dim() != 2
                or series.shape[0] != B or series.stride(1) != 1
                or not 0 <= column < series.shape[1]):
            raise ValueError(f"series must be a float32 [{B}, n] tensor on "
                             f"{dev} with unit column stride holding "
                             f"column {column}")
        stride = series.stride(0)
    sums = torch.empty((B, 2), dtype=_F, device=dev)
    width = sums_supers(P) + (sums_blocks(P) if name == "peer_update" else 0)
    partials = torch.empty((B, width, 2), dtype=_F, device=dev)
    return sums, partials, dict(
        partials=partials.data_ptr(),
        counters=_counters(dev, name, arrival_counters(name, B, P)),
        sums=sums.data_ptr(),
        series=None if series is None else series.data_ptr(),
        series_stride=stride, column=column)


def lane_sums(state: SwarmState, series=None, column: int = 0):
    """TK4 on lanes: each lane's ``cdn_bytes`` and ``p2p_bytes`` sums as
    a ``[B, 2]`` (cdn, p2p) tensor, and with ``series`` (a ``[B, n]``
    float32 tensor) the offload ratio written into ``series[:,
    column]``.  Same outputs as :func:`lane_sums_plain`, to the sums'
    tolerance; on the card the same bits as ``peer_update``'s epilogue
    on the same counters.  The step does not launch it: it serves the
    sums outside the step (a timeline's first interval,
    ``offload_ratio_batch``)."""
    dev = state.p2p_bytes.device
    if dev.type != "cuda":
        return lane_sums_plain(state, series, column)
    B, P = state.p2p_bytes.shape
    sums, _partials, out = _sums_out(dev, "lane_sums", B, P, series,
                                     column)
    args = _LaneSumsArgs(
        p2p_bytes=_check("p2p_bytes", state.p2p_bytes, _F, (B, P), dev),
        cdn_bytes=_check("cdn_bytes", state.cdn_bytes, _F, (B, P), dev),
        **out, n_peers=P, n_lanes=B, n_blocks=sums_supers(P))
    _launch("lane_sums", args, dev)
    return sums


def _timeline_args(dev, t_s, join, leave, reb, *, n_levels=0, n_edges=0,
                   row, row_stride, rate=0.0, prev_rebuffer=None,
                   level=None, sums=None, prev_sums=None, n_cohorts=0,
                   cohort_id=None, p2p_bytes=None, cdn_bytes=None):
    """TK5's arguments, checked, and its partials buffer, which the
    caller holds until the launch; without ``prev_rebuffer`` the kernel
    computes the rebuffer ratio alone."""
    B, P = reb.shape
    if P == 0:
        raise ValueError("timeline_row needs at least one peer")
    if n_levels > MAX_LEVELS or n_edges > MAX_EDGES:
        raise ValueError(f"the timeline kernel takes at most {MAX_LEVELS} "
                         f"levels and {MAX_EDGES} digest edges")
    if n_cohorts > MAX_COHORTS:
        raise ValueError(f"the timeline kernel takes at most {MAX_COHORTS} "
                         f"cohorts, not {n_cohorts}")
    nb = reduce_blocks(P)
    n_quant = (3 + n_levels + 4 * n_cohorts
               + (n_edges + 1 if n_edges else 0))
    partials = torch.empty((B, nb, n_quant if prev_rebuffer is not None
                            else 2), dtype=_F, device=dev)

    def opt(name, t, dtype, shape):
        return None if t is None else _check(name, t, dtype, shape, dev)
    args = _TimelineArgs(
        t_s=_check("t_s", t_s, _F, (B,), dev),
        join_s=_check("join_s", join, _F, (B, P), dev),
        leave_s=_check("leave_s", leave, _F, (B, P), dev),
        rebuffer_s=_check("rebuffer_s", reb, _F, (B, P), dev),
        prev_rebuffer=opt("prev_rebuffer", prev_rebuffer, _F, (B, P)),
        level=opt("level", level, _I, (B, P)),
        sums=opt("sums", sums, _F, (B, 2)),
        prev_sums=opt("prev_sums", prev_sums, _F, (B, 2)),
        edges=_edges(dev).data_ptr() if n_edges else None,
        partials=partials.data_ptr(),
        counters=_counters(dev, "timeline_row", B), row=row,
        cohort_id=opt("cohort_id", cohort_id, _I, (B, P)),
        p2p_bytes=opt("p2p_bytes", p2p_bytes, _F, (B, P)),
        cdn_bytes=opt("cdn_bytes", cdn_bytes, _F, (B, P)),
        n_peers=P, row_stride=row_stride, n_lanes=B, n_blocks=nb,
        n_levels=n_levels, n_edges=n_edges, n_cohorts=n_cohorts, rate=rate)
    return args, partials


def _row_args(config: SwarmConfig, scenario: SwarmScenario,
              state: SwarmState, sums, prev_sums, prev_rebuffer, out,
              sample: int, record_every: int):
    """TK5's row-mode arguments for ``out[:, sample, :]``, checked (the
    cohort columns' inputs only with ``config.n_cohorts``), and its
    partials."""
    dev = state.rebuffer_s.device
    B, P = state.rebuffer_s.shape
    n_edges = len(DEFAULT_EDGES) if config.stall_digest else 0
    n_cohorts = config.n_cohorts
    M = (6 + config.n_levels + 3 * n_cohorts
         + (n_edges + 1 if n_edges else 0))
    if (out.device != dev or out.dtype != _F or out.dim() != 3
            or out.shape[0] != B or out.shape[2] != M
            or not out.is_contiguous() or not 0 <= sample < out.shape[1]):
        raise ValueError(f"out must be a contiguous float32 [{B}, n, {M}] "
                         f"tensor on {dev} holding sample {sample}")
    row = out.data_ptr() + sample * M * out.element_size()
    extra = {}
    if n_cohorts:
        extra = dict(n_cohorts=n_cohorts, cohort_id=scenario.cohort_id,
                     p2p_bytes=state.p2p_bytes, cdn_bytes=state.cdn_bytes)
    return _timeline_args(
        dev, state.t_s, scenario.join_s, scenario.leave_s, state.rebuffer_s,
        n_levels=config.n_levels, n_edges=n_edges, row=row,
        row_stride=out.stride(0), rate=rate_factor(config, record_every),
        prev_rebuffer=prev_rebuffer, level=state.level, sums=sums,
        prev_sums=prev_sums, **extra)


def timeline_row(config: SwarmConfig, scenario: SwarmScenario,
                 state: SwarmState, sums: torch.Tensor,
                 prev_sums: torch.Tensor, prev_rebuffer: torch.Tensor,
                 out: torch.Tensor, sample: int, record_every: int) -> None:
    """TK5 on lanes.  Same signature and effect as
    :func:`timeline_row_plain`: writes ``out[:, sample, :]`` and updates
    ``prev_sums`` and ``prev_rebuffer`` in place.  With
    ``config.n_cohorts > 0`` it is :func:`timeline_row_cohorts`."""
    if config.n_cohorts:
        return timeline_row_cohorts(config, scenario, state, sums, prev_sums,
                                    prev_rebuffer, out, sample, record_every)
    dev = state.rebuffer_s.device
    if dev.type != "cuda":
        return timeline_row_plain(config, scenario, state, sums, prev_sums,
                                  prev_rebuffer, out, sample, record_every)
    args, _partials = _row_args(config, scenario, state, sums, prev_sums,
                                prev_rebuffer, out, sample, record_every)
    _launch("timeline_row", args, dev)


def timeline_row_cohorts(config: SwarmConfig, scenario: SwarmScenario,
                         state: SwarmState, sums: torch.Tensor,
                         prev_sums: torch.Tensor,
                         prev_rebuffer: torch.Tensor, out: torch.Tensor,
                         sample: int, record_every: int) -> None:
    """TK5's cohort instantiation on lanes, for ``config.n_cohorts`` in
    ``1..MAX_COHORTS``: :func:`timeline_row` with the per-cohort columns,
    from ``scenario.cohort_id`` and the state's byte counters, which only
    this instantiation reads.  More cohorts raise on the card (the CPU
    path takes any number)."""
    dev = state.rebuffer_s.device
    if dev.type != "cuda":
        return timeline_row_plain(config, scenario, state, sums, prev_sums,
                                  prev_rebuffer, out, sample, record_every)
    if not config.n_cohorts:
        raise ValueError("timeline_row_cohorts needs config.n_cohorts > 0")
    args, _partials = _row_args(config, scenario, state, sums, prev_sums,
                                prev_rebuffer, out, sample, record_every)
    _launch("timeline_row_cohorts", args, dev)


def rebuffer_ratio_lanes(reb: torch.Tensor, join: torch.Tensor,
                         leave: torch.Tensor, t: torch.Tensor):
    """Per-lane ``Σ reb / max(Σ clip(min(leave, t) - join, 0), 1e-9)``
    (``[B]``) for ``[B, P]`` arrays and ``[B]`` clocks: on the card TK5,
    which sums the two as it does for the timeline's rebuffer column, so
    the two agree to the bit; on the CPU the plain sums."""
    dev = reb.device
    if dev.type != "cuda":
        return _rebuffer_plain(reb, join, leave, t)
    out = torch.empty((reb.shape[0],), dtype=_F, device=dev)
    args, _partials = _timeline_args(dev, t, join, leave, reb,
                                     row=out.data_ptr(), row_stride=1)
    _launch("rebuffer_ratio_lanes", args, dev)
    return out


# ---- CUDA graphs of the scan ------------------------------------------------

def graph_path(device) -> bool:
    """Whether ``_scan_swarm`` replays its steps as CUDA graphs on
    ``device``: on the card, always; on the CPU it loops eagerly."""
    return torch.device(device).type == "cuda"


class Graph(NamedTuple):
    """A captured CUDA graph, the kernel launches it holds (by name) and
    its memory pool, which a later capture of the same scan may share
    (the graphs replay one at a time, in order)."""

    graph: object
    launches: Dict[str, int]
    pool: object

    def replay(self) -> None:
        """Replay the graph on the current stream, counting its
        launches."""
        self.graph.replay()
        for name, n in self.launches.items():
            LAUNCHES[name] += n


def _prepare_capture(dev: torch.device, n_lanes: int, n_peers: int) -> None:
    """What a capture must find ready, since a graph may not build,
    load, allocate outside its pool or copy from the host: both
    libraries built, bound and their kernels loaded (``_lib``), the
    arrival counters for ``n_lanes`` lanes of ``n_peers`` peers, and the
    digest edges."""
    for source in _SOURCES:
        _lib(source)
    for name in ("peer_update", "lane_sums", "timeline_row"):
        _counters(dev, name, arrival_counters(name, n_lanes, n_peers))
    _edges(dev)


@functools.lru_cache(maxsize=None)
def _capture_stream(dev: torch.device):
    """The side stream captures run on (made once per device)."""
    return torch.cuda.Stream(dev)


def capture(fn, dev: torch.device, n_lanes: int, n_peers: int,
            pool=None) -> Graph:
    """Capture ``fn()``, which launches work on ``n_lanes`` lanes of
    ``n_peers`` peers on the card, as a CUDA graph (in ``pool`` when
    given, else a pool of its own).  The launches ``fn`` makes while
    captured run nothing, so they are taken off :data:`LAUNCHES` and
    counted at each replay instead.  A failed capture raises."""
    _prepare_capture(dev, n_lanes, n_peers)
    before = dict(LAUNCHES)
    try:
        graph = _record(fn, dev, pool)
    finally:
        recorded = {name: LAUNCHES[name] - before[name] for name in LAUNCHES}
        LAUNCHES.update(before)
    return Graph(graph, {k: n for k, n in recorded.items() if n},
                 graph.pool())


def _record(fn, dev: torch.device, pool):
    """``fn()`` captured into a ``torch.cuda.CUDAGraph`` on the capture
    stream.  Unlike the ``torch.cuda.graph`` context manager, it neither
    synchronizes the card nor empties PyTorch's cache of free device
    memory first: a capture is made once per scan, and emptying the
    cache makes the allocations after it allocate anew.  Where
    ``fn()`` raises (an out-of-memory error in the capture's pool, say),
    the capture is ended, so that the stream leaves capture mode and the
    card stays usable, and ``fn``'s error propagates: an error of ending
    a capture that the failure invalidated does not replace it."""
    graph = torch.cuda.CUDAGraph()
    stream = _capture_stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        graph.capture_begin(*(() if pool is None else (pool,)))
        try:
            fn()
        except BaseException as exc:
            try:
                graph.capture_end()
            except RuntimeError as end_exc:
                raise exc from end_exc
            raise
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(stream)
    return graph
