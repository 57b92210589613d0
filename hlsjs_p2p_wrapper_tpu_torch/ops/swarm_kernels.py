"""The kernels of one circulant VOD step, with their plain PyTorch
versions and the wrappers that choose between them.

=====================  ==========================================
kernel                 replaces (reference ``ops/swarm_sim.py``)
=====================  ==========================================
TK1 ``elig_select``    ``circulant_eligibility`` :681-772,
                       ``spread_holder_only`` :959-991, the start
                       decision :1053-1175, pinning :1207-1228
TK2 ``admit_service``  circulant admission and service, :1259-1303
                       (the ``cap > 0`` branch)
``select_admit``       TK1 then TK2 in one launch, over tiles of
                       peers with a halo of requesters
TK3 ``peer_update``    the service readback and the slot-0 update
                       :1351-1525 with ``ewma.update``
=====================  ==========================================

A step is :func:`select_admit` then :func:`peer_update`.  The route of
``select_admit`` is chosen from the offsets before launch
(:func:`fused_route`): the fused kernel where the halo fits its tile
(the main path), else TK1 then TK2.

The sources are ``csrc/swarm_step.cu`` (CUDA C++ for ``sm_90a``, built
by ``ops/_build.py`` and bound with ``ctypes``).  Each wrapper checks
device, dtype, shape and contiguity; for CUDA tensors it launches its
kernel or raises, for CPU tensors it runs the plain version.  There is
no fallback from a failed build or launch to the plain version.

Data flow of a step: TK1 decides every requester's transfer and
selected holder; TK2 needs every requester's demand to admit per
holder; TK3 needs every holder's service.  ``select_admit`` does TK1
and TK2 in one launch by recomputing, in each block, the selection of
the requesters its holders serve.  Between the passes travel four
``[P]`` scratch words: ``slot_flags`` (bit 0 may, bit 1 active, bit 2
is_p2p, bit 3 have_n), ``req`` (the offset index of the selected
holder of a transfer that places demand, else -1), ``service`` and
``adm`` (per holder, a bit mask of the admitted offset indices).

In place: TK1 (and ``select_admit``) writes the slot record into its
own row of the state and TK3 updates its own row of every field.  Each
peer's row has one writer, and the selection has finished reading
neighbours' rows before TK3 writes them.  Inside ``select_admit`` a
block reads requester fields of halo peers that another block writes;
that is sound because each such field is read only when the slot is
active and written only when it is not (``csrc/swarm_step.cu``).  The
plain versions update the state in place too.  Callers that compare two
steps clone the state first.

Every launch adds one to :data:`LAUNCHES`; plain calls add nothing.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.abr import DEFAULT_ESTIMATE_BPS, MIN_SAMPLE_DURATION_MS
from .ewma import _div, get_estimate, update
from .swarm_sim import (BANDWIDTH_SAFETY, SwarmConfig, SwarmScenario,
                        SwarmState, _abr_pick, _normalized_offsets,
                        bit_mask_words, circulant_eligibility,
                        pack_dl_flags, packed_words, resolve_eligibility,
                        unpack_dl_flags)

SOURCE = "swarm_step.cu"
MAX_OFFS = 32

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES = {"select_admit": 0, "elig_select": 0, "admit_service": 0,
            "peer_update": 0}


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
    seg: float
    end_s: float
    dt_ms: float
    dt_s: float
    fast_alpha: float
    slow_alpha: float
    cap: int


@functools.lru_cache(maxsize=64)
def geometry(config: SwarmConfig) -> Geometry:
    P = config.n_peers
    offs = tuple(_normalized_offsets(config.neighbor_offsets, P))
    return Geometry(
        P=P, S=config.n_segments, L=config.n_levels,
        W=packed_words(config), offs=offs,
        offs_mod=tuple(o % P for o in offs),
        o_hi=max((0, *offs)), o_lo=min((0, *offs)),
        seg=config.seg_duration_s,
        end_s=config.n_segments * config.seg_duration_s,
        dt_ms=config.dt_ms, dt_s=config.dt_ms / 1000.0,
        fast_alpha=math.exp(math.log(0.5) / config.fast_half_life_s),
        slow_alpha=math.exp(math.log(0.5) / config.slow_half_life_s),
        cap=config.max_total_serves)


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


def fused_route(config: SwarmConfig) -> bool:
    """Whether :func:`select_admit` runs its fused kernel for
    ``config`` (else TK1 then TK2): decided from the offsets alone."""
    g = geometry(config)
    return g.o_hi - g.o_lo <= MAX_FUSED_SPAN


# ---- plain versions -------------------------------------------------------

def _present(scenario: SwarmScenario, t: torch.Tensor) -> torch.Tensor:
    return (t >= scenario.join_s) & (t < scenario.leave_s)


def slot_targets(config: SwarmConfig, scenario: SwarmScenario,
                 state: SwarmState) -> dict:
    """What each peer wants next (reference :796-894): presence, the
    ABR level, the next segment, the foreground's wish and slot 0's
    flat (level·S + seg) target."""
    g = geometry(config)
    present = _present(scenario, state.t_s)
    dl_active, dl_is_p2p = unpack_dl_flags(state.dl_flags, 1)
    a0 = dl_active[0]
    estimate = get_estimate(state.ewma, config.fast_half_life_s,
                            config.slow_half_life_s)
    want_level = torch.minimum(_abr_pick(estimate, scenario.bitrates),
                               scenario.abr_cap_level)
    pb = state.playhead_s + state.buffer_s
    next_seg = torch.clamp_max(_div(pb, g.seg).to(torch.int32), g.S - 1)
    timeline_left = pb < g.end_s
    fg_wants = (present & ~a0 & timeline_left
                & (state.buffer_s < config.max_buffer_s))
    gi_seg = torch.where(a0, state.dl_seg[:, 0], next_seg)
    gi_level = torch.where(a0, state.dl_level[:, 0], want_level)
    return {"present": present, "a0": a0, "p0": dl_is_p2p[0],
            "want_level": want_level, "next_seg": next_seg,
            "fg_wants": fg_wants, "gi_seg": gi_seg,
            "gi_flat": gi_level * g.S + gi_seg}


def _spread_holder_only(elig, n_holders, gi_seg, rot):
    """Reference :959-991 for slot 0 (salt 0): ONE eligible holder by a
    u32 hash of (peer, segment, slot), its rank advanced by the slot's
    failed attempts.  The u32 products wrap: int64, masked after each
    multiply and add."""
    P = gi_seg.shape[0]
    peer = torch.arange(P, dtype=torch.int64, device=gi_seg.device)
    salt = (0 * 2246822519 + 97) % (1 << 32)
    h = (peer * 2654435761) & 0xFFFFFFFF
    h = (h + ((gi_seg.to(torch.int64) & 0xFFFFFFFF) * 40503
              & 0xFFFFFFFF)) & 0xFFFFFFFF
    h = (h + salt) & 0xFFFFFFFF
    n = torch.clamp_min(n_holders, 1.0).to(torch.int64)
    rot_u = rot.to(torch.int64) & 0xFFFFFFFF
    rank = ((((h % n) + rot_u) & 0xFFFFFFFF) % n).to(torch.int32)
    cum = torch.zeros((P,), dtype=torch.int32, device=gi_seg.device)
    out = []
    for e in elig:
        is_e = e > 0
        out.append((is_e & (cum == rank)).to(torch.float32))
        cum = cum + is_e.to(torch.int32)
    return out


def elig_select_plain(config: SwarmConfig, scenario: SwarmScenario,
                      state: SwarmState):
    """Plain TK1: eligibility, holder selection, slot 0's start
    decision and pinning (reference :796-1246 for the slice).  Writes
    the slot record into ``state`` in place; returns ``(slot_flags,
    req)``."""
    g = geometry(config)
    tg = slot_targets(config, scenario, state)
    present, a0, p0 = tg["present"], tg["a0"], tg["p0"]
    next_seg, want_level = tg["next_seg"], tg["want_level"]
    p2p_req = scenario.p2p_ok
    serve_ok = present & (scenario.p2p_ok > 0.0)
    impl = resolve_eligibility(config, state.avail.device)
    elig, n, _own = circulant_eligibility(state.avail, serve_ok, list(g.offs),
                                          [tg["gi_flat"]], impl=impl)[0]
    elig = [e * p2p_req for e in elig]
    n = n * p2p_req

    margin_s = next_seg.to(torch.float32) * g.seg - state.playhead_s
    urgent = margin_s < (scenario.urgent_margin_s
                         + scenario.urgent_margin_off_s)
    budget_ms = torch.minimum(
        torch.maximum(margin_s * 1000.0 * scenario.p2p_budget_fraction,
                      scenario.p2p_budget_floor_ms),
        scenario.p2p_budget_cap_ms)
    lvl_iota = torch.arange(g.L, dtype=torch.int32, device=p2p_req.device)
    zero = torch.zeros((), dtype=torch.float32, device=p2p_req.device)
    want_bytes = torch.sum(
        torch.where(want_level[:, None] == lvl_iota[None, :],
                    scenario.bitrates[None, :], zero), dim=1) * (g.seg / 8.0)

    have_n = n > 0.0
    wants_dl = tg["fg_wants"]
    start_p2p = wants_dl & have_n & ~urgent
    start_cdn = wants_dl & ~start_p2p
    may = start_p2p | start_cdn
    is_p2p = torch.where(may, start_p2p, p0) & have_n
    active = a0 | may
    level = torch.where(may, want_level, state.level)

    sel = _spread_holder_only(elig, n, tg["gi_seg"],
                              state.dl_attempts[:, 0])
    new_off = sum(((s_k > 0).to(torch.int32) * k
                   for k, s_k in enumerate(sel)), torch.zeros_like(next_seg))
    off = torch.where(a0, state.dl_holder_off[:, 0], new_off)
    sel = [torch.where(a0, e * (off == k), s_k)
           for k, (e, s_k) in enumerate(zip(elig, sel))]
    demand = (active & is_p2p & present).to(torch.float32)
    req = torch.full_like(next_seg, -1)
    for k, s_k in enumerate(sel):
        req = torch.where(s_k * demand > 0.0, torch.full_like(req, k), req)

    state.level.copy_(level)
    state.dl_seg[:, 0].copy_(torch.where(may, next_seg, state.dl_seg[:, 0]))
    state.dl_level[:, 0].copy_(torch.where(may, want_level,
                                           state.dl_level[:, 0]))
    state.dl_total_bytes[:, 0].copy_(
        torch.where(may, want_bytes, state.dl_total_bytes[:, 0]))
    state.dl_done_bytes[:, 0].copy_(
        torch.where(may, zero, state.dl_done_bytes[:, 0]))
    state.dl_elapsed_ms[:, 0].copy_(
        torch.where(may, zero, state.dl_elapsed_ms[:, 0]))
    state.dl_budget_ms[:, 0].copy_(
        torch.where(may, budget_ms, state.dl_budget_ms[:, 0]))
    state.dl_holder_off[:, 0].copy_(off)
    slot_flags = (may.to(torch.int32) | (active.to(torch.int32) << 1)
                  | (is_p2p.to(torch.int32) << 2)
                  | (have_n.to(torch.int32) << 3))
    return slot_flags, req


def admit_service_plain(config: SwarmConfig, scenario: SwarmScenario,
                        req: torch.Tensor):
    """Plain TK2 (reference :1259-1303, ``cap > 0``): admission in
    offset order at each holder, then its service.  Returns
    ``(service [P] f32, adm [P] i32 bit mask)``."""
    g = geometry(config)
    P = req.shape[0]
    zeros = torch.zeros((P,), dtype=torch.float32, device=req.device)
    cum_j = zeros
    adm = torch.zeros((P,), dtype=torch.int32, device=req.device)
    for k, o in enumerate(g.offs):
        contrib_at_j = torch.roll((req == k).to(torch.float32), o)
        adm_at_j = torch.where((contrib_at_j > 0.0) & (cum_j < g.cap),
                               contrib_at_j, zeros)
        cum_j = cum_j + adm_at_j
        adm = adm | ((adm_at_j > 0.0).to(torch.int32) << k)
    service = (scenario.uplink_bps * scenario.uplink_efficiency
               / torch.clamp_min(cum_j, 1.0))
    return service, adm


def select_admit_plain(config: SwarmConfig, scenario: SwarmScenario,
                       state: SwarmState):
    """Plain ``select_admit``: :func:`elig_select_plain` then
    :func:`admit_service_plain`.  Writes the slot record into ``state``
    in place; returns ``(slot_flags, req, service, adm)``."""
    flags, req = elig_select_plain(config, scenario, state)
    return (flags, req) + admit_service_plain(config, scenario, req)


def peer_update_plain(config: SwarmConfig, scenario: SwarmScenario,
                      state: SwarmState, slot_flags: torch.Tensor,
                      req: torch.Tensor, service: torch.Tensor,
                      adm: torch.Tensor) -> None:
    """Plain TK3: the service readback (reference :1297-1303), the
    slot-0 update (:1351-1434, :1467-1493), playback and the repack
    (:1495-1525).  Updates ``state`` in place."""
    g = geometry(config)
    P = req.shape[0]
    dev = req.device
    zeros = torch.zeros((P,), dtype=torch.float32, device=dev)
    present = _present(scenario, state.t_s)
    may = (slot_flags & 1) != 0
    s_active = (slot_flags & 2) != 0
    s_is_p2p = (slot_flags & 4) != 0
    have_n = (slot_flags & 8) != 0

    # service readback: the admitted edge of each requester
    svc = zeros
    admitted_any = torch.zeros((P,), dtype=torch.bool, device=dev)
    for k, o in enumerate(g.offs):
        adm_k = (req == k) & (((torch.roll(adm, -o) >> k) & 1) != 0)
        admitted_any = admitted_any | adm_k
        svc = svc + adm_k.to(torch.float32) * torch.roll(service, -o)
    demand = (s_active & s_is_p2p & present).to(torch.float32)

    total = state.dl_total_bytes[:, 0]
    s_done = state.dl_done_bytes[:, 0]
    p2p_rate = torch.clamp_max(demand * svc, config.p2p_bps)
    progressing = s_active & present
    elapsed = state.dl_elapsed_ms[:, 0] + torch.where(
        progressing, g.dt_ms, 0.0)
    p2p_live_ms = torch.clamp(elapsed - scenario.p2p_setup_ms, 0.0,
                              g.dt_ms)
    p2p_step = _div(p2p_rate * p2p_live_ms, 8000.0)
    step_bytes = torch.where(s_is_p2p, p2p_step,
                             _div(scenario.cdn_bps * g.dt_s, 8.0))
    cdn_accrue = torch.where(
        progressing & ~s_is_p2p,
        torch.minimum(step_bytes, torch.clamp_min(total - s_done, 0.0)),
        zeros)
    done = s_done + torch.where(progressing, step_bytes, zeros)
    completed = progressing & (done >= total)
    active = s_active & ~completed
    is_p2p = s_is_p2p
    cooled = torch.clamp_min(state.dl_cooldown_ms[:, 0] - g.dt_ms, 0.0)
    # BUSY fast-fail: a start the holder did not admit flips to the CDN
    denied = may & is_p2p & have_n & ~admitted_any
    is_p2p = is_p2p & ~denied
    done = torch.where(denied, zeros, done)
    elapsed = torch.where(denied, zeros, elapsed)
    # budget failover to the CDN, discarding partial bytes
    expired = active & is_p2p & (elapsed >= state.dl_budget_ms[:, 0])
    is_p2p = is_p2p & ~expired
    done = torch.where(expired, zeros, done)
    elapsed = torch.where(expired, zeros, elapsed)
    cdn_bytes = state.cdn_bytes + cdn_accrue
    p2p_bytes = state.p2p_bytes + torch.where(completed & is_p2p, total,
                                              zeros)
    buffer_add = zeros + torch.where(completed, g.seg, 0.0)

    # cache insert: the slot's own (level, seg) bit
    Wm = bit_mask_words(state.dl_level[:, 0] * g.S + state.dl_seg[:, 0],
                        g.W)
    insert = torch.where(completed[:, None], Wm,
                         torch.zeros((), dtype=torch.int32, device=dev))
    sample_ms = torch.clamp_min(elapsed, MIN_SAMPLE_DURATION_MS)
    ewma = update(state.ewma, torch.where(completed, sample_ms, zeros),
                  torch.where(completed, total, zeros),
                  config.fast_half_life_s, config.slow_half_life_s)

    # playback
    buffer_s = state.buffer_s + buffer_add
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
    state.dl_flags.copy_(pack_dl_flags([active], [is_p2p]))
    state.dl_done_bytes[:, 0].copy_(done)
    state.dl_elapsed_ms[:, 0].copy_(elapsed)
    state.dl_cooldown_ms[:, 0].copy_(cooled)


def plain_step(config: SwarmConfig, scenario: SwarmScenario,
               state: SwarmState) -> SwarmState:
    """One step through the plain versions on any device: the oracle a
    kernel step is held against.  Updates ``state`` in place and returns
    it with the clock advanced, as ``swarm_step`` does."""
    flags, req, service, adm = select_admit_plain(config, scenario, state)
    peer_update_plain(config, scenario, state, flags, req, service, adm)
    return state._replace(t_s=state.t_s + config.dt_ms / 1000.0)


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
        ("n_peers", ctypes.c_longlong), ("n_words", ctypes.c_int),
        ("n_segments", ctypes.c_int), ("n_levels", ctypes.c_int),
        ("n_offs", ctypes.c_int)] + [
        (name, ctypes.c_float) for name in (
            "seg_duration_s", "inv_seg_duration_s", "max_buffer_s",
            "end_s", "fast_alpha",
            "slow_alpha", "default_estimate_bps", "bandwidth_safety")] + [
        ("offs", ctypes.c_int * MAX_OFFS)]


class _AdmitArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "req", "uplink_bps", "uplink_efficiency", "service", "adm_mask")] + [
        ("n_peers", ctypes.c_longlong), ("n_offs", ctypes.c_int),
        ("cap", ctypes.c_float), ("offs", ctypes.c_int * MAX_OFFS)]


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
        "dl_done_bytes", "dl_elapsed_ms", "dl_cooldown_ms")] + [
        ("n_peers", ctypes.c_longlong), ("n_words", ctypes.c_int),
        ("n_segments", ctypes.c_int), ("n_offs", ctypes.c_int)] + [
        (name, ctypes.c_float) for name in (
            "seg_duration_s", "end_s", "dt_ms", "dt_s", "p2p_bps",
            "fast_alpha", "slow_alpha", "min_sample_ms")] + [
        ("offs", ctypes.c_int * MAX_OFFS)]


_ENTRY = {"elig_select": ("swarm_elig_select", _SelectArgs),
          "admit_service": ("swarm_admit_service", _AdmitArgs),
          "peer_update": ("swarm_peer_update", _UpdateArgs),
          "select_admit": ("swarm_select_admit", _SelectAdmitArgs)}


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    """Build (once, on first use) and bind the kernels' library, and
    check the ctypes mirrors against the C structs' sizes."""
    from . import _build
    lib = _build.load(SOURCE, DEFINES)
    for fn, _args in _ENTRY.values():
        f = getattr(lib, fn)
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        f.restype = ctypes.c_int
    lib.swarm_args_sizes.argtypes = [ctypes.c_void_p]
    lib.swarm_args_sizes.restype = ctypes.c_int
    sizes = (ctypes.c_longlong * len(_ENTRY))()
    lib.swarm_args_sizes(sizes)
    want = [ctypes.sizeof(a) for _fn, a in _ENTRY.values()]
    if list(sizes) != want:
        raise RuntimeError(f"kernel argument structs disagree with their "
                           f"ctypes mirrors: C {list(sizes)} vs {want}")
    return lib


def build_kernels(force: bool = False) -> dict:
    """Build (anew with ``force``) and bind the kernels now; they build
    on first launch otherwise.  Returns the build's report
    (``_build.build``)."""
    from . import _build
    info = _build.build({SOURCE: DEFINES}, force=force)
    _lib()
    return info


def _launch(name: str, args: ctypes.Structure, device) -> None:
    fn = getattr(_lib(), _ENTRY[name][0])
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
                      "p2p_setup_ms", "uplink_efficiency"))


def _scenario_ptrs(scenario: SwarmScenario, names, P, L, dev) -> dict:
    out = {}
    for name in names:
        shape = (() if name in _SCALARS
                 else (L,) if name == "bitrates" else (P,))
        dtype = _I if name == "abr_cap_level" else _F
        out[name] = _check(name, getattr(scenario, name), dtype, shape, dev)
    return out


def _select_args(config: SwarmConfig, scenario: SwarmScenario,
                 state: SwarmState, dev):
    """TK1's arguments (also the selection half of ``select_admit``'s),
    checked, with fresh ``slot_flags`` and ``req`` outputs."""
    g = geometry(config)
    P = g.P
    slot_flags = torch.empty((P,), dtype=_I, device=dev)
    req = torch.empty((P,), dtype=_I, device=dev)
    ptrs = _scenario_ptrs(scenario, (
        "join_s", "leave_s", "p2p_ok", "abr_cap_level",
        "urgent_margin_off_s", "bitrates", "urgent_margin_s",
        "p2p_budget_fraction", "p2p_budget_cap_ms", "p2p_budget_floor_ms"),
        P, g.L, dev)
    ptrs["t_s"] = _check("t_s", state.t_s, _F, (), dev)
    for name in ("playhead_s", "buffer_s"):
        ptrs[name] = _check(name, getattr(state, name), _F, (P,), dev)
    for name, t in state.ewma._asdict().items():
        ptrs[name] = _check(name, t, _F, (P,), dev)
    ptrs["avail"] = _check("avail", state.avail, _I, (P, g.W), dev)
    ptrs["dl_flags"] = _check("dl_flags", state.dl_flags, _I, (P,), dev)
    ptrs["level"] = _check("level", state.level, _I, (P,), dev)
    for name in ("dl_attempts", "dl_seg", "dl_level", "dl_holder_off"):
        ptrs[name] = _check(name, getattr(state, name), _I, (P, 1), dev)
    for name in ("dl_done_bytes", "dl_total_bytes", "dl_elapsed_ms",
                 "dl_budget_ms"):
        ptrs[name] = _check(name, getattr(state, name), _F, (P, 1), dev)
    ptrs["slot_flags"] = slot_flags.data_ptr()
    ptrs["req"] = req.data_ptr()
    args = _SelectArgs(
        **ptrs, n_peers=P, n_words=g.W, n_segments=g.S, n_levels=g.L,
        n_offs=len(g.offs), seg_duration_s=g.seg,
        inv_seg_duration_s=float(np.float32(1.0) / np.float32(g.seg)),
        max_buffer_s=config.max_buffer_s, end_s=g.end_s,
        fast_alpha=g.fast_alpha, slow_alpha=g.slow_alpha,
        default_estimate_bps=DEFAULT_ESTIMATE_BPS,
        bandwidth_safety=BANDWIDTH_SAFETY, offs=_offs_array(g.offs_mod))
    return args, slot_flags, req


def elig_select(config: SwarmConfig, scenario: SwarmScenario,
                state: SwarmState):
    """TK1.  Same signature and outputs as :func:`elig_select_plain`."""
    dev = state.avail.device
    if dev.type != "cuda":
        return elig_select_plain(config, scenario, state)
    args, slot_flags, req = _select_args(config, scenario, state, dev)
    _launch("elig_select", args, dev)
    return slot_flags, req


def _select_admit_args(config: SwarmConfig, scenario: SwarmScenario,
                       state: SwarmState, dev):
    g = geometry(config)
    sel, slot_flags, req = _select_args(config, scenario, state, dev)
    service = torch.empty((g.P,), dtype=_F, device=dev)
    adm = torch.empty((g.P,), dtype=_I, device=dev)
    args = _SelectAdmitArgs(
        sel=sel,
        uplink_bps=_check("uplink_bps", scenario.uplink_bps, _F, (g.P,),
                          dev),
        uplink_efficiency=_check("uplink_efficiency",
                                 scenario.uplink_efficiency, _F, (), dev),
        service=service.data_ptr(), adm_mask=adm.data_ptr(),
        cap=float(g.cap), o_max=g.o_hi, o_min=g.o_lo,
        soffs=_offs_array(g.offs))
    return args, (slot_flags, req, service, adm)


def select_admit(config: SwarmConfig, scenario: SwarmScenario,
                 state: SwarmState):
    """TK1 and TK2 of one step: same signature and outputs as
    :func:`select_admit_plain`.  On a CUDA state it launches the fused
    kernel where :func:`fused_route` holds, else TK1 then TK2."""
    dev = state.avail.device
    if dev.type != "cuda":
        return select_admit_plain(config, scenario, state)
    if not fused_route(config):
        flags, req = elig_select(config, scenario, state)
        return (flags, req) + admit_service(config, scenario, req)
    args, out = _select_admit_args(config, scenario, state, dev)
    _launch("select_admit", args, dev)
    return out


def admit_service(config: SwarmConfig, scenario: SwarmScenario,
                  req: torch.Tensor):
    """TK2.  Same signature and outputs as :func:`admit_service_plain`."""
    dev = req.device
    if dev.type != "cuda":
        return admit_service_plain(config, scenario, req)
    g = geometry(config)
    P = g.P
    service = torch.empty((P,), dtype=_F, device=dev)
    adm = torch.empty((P,), dtype=_I, device=dev)
    args = _AdmitArgs(
        req=_check("req", req, _I, (P,), dev),
        uplink_bps=_check("uplink_bps", scenario.uplink_bps, _F, (P,), dev),
        uplink_efficiency=_check("uplink_efficiency",
                                 scenario.uplink_efficiency, _F, (), dev),
        service=service.data_ptr(), adm_mask=adm.data_ptr(),
        n_peers=P, n_offs=len(g.offs), cap=float(g.cap),
        offs=_offs_array(g.offs_mod))
    _launch("admit_service", args, dev)
    return service, adm


def peer_update(config: SwarmConfig, scenario: SwarmScenario,
                state: SwarmState, slot_flags: torch.Tensor,
                req: torch.Tensor, service: torch.Tensor,
                adm: torch.Tensor) -> None:
    """TK3.  Same signature and effect as :func:`peer_update_plain`."""
    dev = state.avail.device
    if dev.type != "cuda":
        return peer_update_plain(config, scenario, state, slot_flags, req,
                                 service, adm)
    g = geometry(config)
    P = g.P
    ptrs = _scenario_ptrs(scenario, ("join_s", "leave_s", "cdn_bps",
                                     "p2p_setup_ms"), P, g.L, dev)
    ptrs["t_s"] = _check("t_s", state.t_s, _F, (), dev)
    ptrs["slot_flags"] = _check("slot_flags", slot_flags, _I, (P,), dev)
    ptrs["req"] = _check("req", req, _I, (P,), dev)
    ptrs["service"] = _check("service", service, _F, (P,), dev)
    ptrs["adm_mask"] = _check("adm", adm, _I, (P,), dev)
    for name in ("playhead_s", "buffer_s", "rebuffer_s", "cdn_bytes",
                 "p2p_bytes"):
        ptrs[name] = _check(name, getattr(state, name), _F, (P,), dev)
    for name, t in state.ewma._asdict().items():
        ptrs[name] = _check(name, t, _F, (P,), dev)
    ptrs["avail"] = _check("avail", state.avail, _I, (P, g.W), dev)
    ptrs["dl_flags"] = _check("dl_flags", state.dl_flags, _I, (P,), dev)
    for name in ("dl_seg", "dl_level"):
        ptrs[name] = _check(name, getattr(state, name), _I, (P, 1), dev)
    for name in ("dl_total_bytes", "dl_budget_ms", "dl_done_bytes",
                 "dl_elapsed_ms", "dl_cooldown_ms"):
        ptrs[name] = _check(name, getattr(state, name), _F, (P, 1), dev)
    args = _UpdateArgs(
        **ptrs, n_peers=P, n_words=g.W, n_segments=g.S,
        n_offs=len(g.offs), seg_duration_s=g.seg, end_s=g.end_s,
        dt_ms=g.dt_ms, dt_s=g.dt_s, p2p_bps=config.p2p_bps,
        fast_alpha=g.fast_alpha, slow_alpha=g.slow_alpha,
        min_sample_ms=MIN_SAMPLE_DURATION_MS, offs=_offs_array(g.offs_mod))
    _launch("peer_update", args, dev)
