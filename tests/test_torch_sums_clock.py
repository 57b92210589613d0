"""The offload sums' order and the step's clock, on the CPU.

The sums: ``csrc/lane_sums.cuh`` fixes one summation order that TK4
``lane_sums`` and ``peer_update``'s epilogue share (partials of 256
peers, super-partials of 32 partials, then the lane), and
``swarm_kernels.lane_sums_in_order`` writes it in PyTorch.  Here that
twin is held to a scalar NumPy emulation of both kernels' index
arithmetic (what each warp lane loads and adds, in float32) to the bit,
to ``lane_sums_plain`` within 1e-5 relative (``torch.sum`` adds in
another order), and a lane alone to its batch to the bit; the geometry
(partials, super-partials, counters and scratch a lane) depends on P
alone.  On the card ``chip_smoke.py`` holds both kernels to the twin.

The clock: ``peer_update`` advances ``t_s`` (the kernel in its last
block of each lane, ``peer_update_plain`` after its update), so every
path adds it once: the plain versions, ``plain_step``, ``swarm_step``
on both routes and the scan, to the reference's float32 bits.  Runs
against the reference: final offload and rebuffer within ``RUN_TOL`` =
1e-4 (tests/test_torch_swarm_sim.py)."""

import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlsjs_p2p_wrapper_tpu.ops import swarm_sim as ref
from hlsjs_p2p_wrapper_tpu_torch.ops import _build
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_kernels as sk
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as port

BITRATES = [300_000.0, 800_000.0, 2_000_000.0]
RUN_TOL = 1e-4
#: the twin against ``torch.sum``: float32 sums in two orders
SUMS_RTOL = 1e-5
WIDE = (1, -1, 2, -2, 97, -97, 300, -300)


def _counters(B, P, seed):
    rng = np.random.default_rng(seed)
    cdn = np.floor(rng.random((B, P), dtype=np.float32) * 2e7)
    p2p = np.floor(rng.random((B, P), dtype=np.float32) * 2e7)
    p2p[:, ::7] = 0.0
    return types.SimpleNamespace(cdn_bytes=torch.from_numpy(cdn),
                                 p2p_bytes=torch.from_numpy(p2p))


# ---- a scalar emulation of the kernels' order ------------------------------

F = np.float32


def _tree_down(vals):
    """Lane t adds lane t + s for s = n/2, ..., 1 (``shfl_down``); lane
    0's value."""
    v = [F(x) for x in vals]
    s = len(v) // 2
    while s:
        v = [F(v[t] + v[t + s]) if t + s < len(v) else v[t]
             for t in range(len(v))]
        s //= 2
    return v[0]


def _finish(sup):
    """``ls_finish``: lane t adds super-partials t, t + 32, ... from 0,
    then the warp's tree."""
    lanes = [F(0.0)] * 32
    for k, s in enumerate(sup):
        lanes[k % 32] = F(lanes[k % 32] + s)
    return _tree_down(lanes)


def _partial8(vals):
    """``ls_partial8``: lane t holds vals[t][k], peer 32k + t; the xor
    butterfly, exchange by exchange.  Every lane ends with the partial."""
    def xor(arr, m):
        return [arr[t ^ m] for t in range(32)]

    def half(arr, bit, n):
        keep = [[a[i + n] if t & bit else a[i] for i in range(n)]
                for t, a in enumerate(arr)]
        send = [[a[i] if t & bit else a[i + n] for i in range(n)]
                for t, a in enumerate(arr)]
        recv = [xor([s[i] for s in send], bit) for i in range(n)]
        return [[F(keep[t][i] + recv[i][t]) for i in range(n)]
                for t in range(32)]
    z = [a[0] for a in half(half(half(vals, 16, 4), 8, 2), 4, 1)]
    for m in (2, 1, 16, 8, 4):
        z = [F(a + b) for a, b in zip(z, xor(z, m))]
    assert len({x.view(np.uint32).item() for x in z}) == 1
    return z[0]


def _tk4(x, P):
    """One lane of ``lane_sums_kernel``: block j, warp w, partial m =
    w + 8 i, lane t loading peers base + t + 32 k."""
    n_sup = -(-P // 8192)
    sup = []
    for j in range(n_sup):
        part_s = [None] * 32
        for w in range(8):
            for i in range(4):
                m = w + 8 * i
                base = j * 8192 + m * 256
                vals = [[x[base + t + 32 * k] if base + t + 32 * k < P
                         else F(0.0) for k in range(8)] for t in range(32)]
                part_s[m] = _partial8(vals)
        sup.append(_tree_down(part_s))
    return _finish(sup)


def _epilogue(x, P):
    """One lane of ``peer_update``'s epilogue: block blk, thread i holding
    peer 256 blk + i (zeros past P); each warp's run of 32, then warp 0
    over the 8 runs (``ls_block_sum``); each super-partial's last block
    sums its 32 partials, lane t holding partial t (``ls_super``); then
    the lane."""
    n_part = -(-P // 256)
    part = []
    for blk in range(n_part):
        s = [x[blk * 256 + i] if blk * 256 + i < P else F(0.0)
             for i in range(256)]
        runs = [_tree_down(s[32 * w:32 * w + 32]) for w in range(8)]
        part.append(_tree_down(runs))
    n_sup = -(-n_part // 32)
    sup = [_tree_down([part[32 * j + t] if 32 * j + t < n_part else F(0.0)
                       for t in range(32)]) for j in range(n_sup)]
    return _finish(sup)


@pytest.mark.parametrize("P", [1, 300, 1000, 1001, 8192 + 257])
def test_the_twin_is_both_kernels_order(P):
    """``lane_sums_in_order`` gives, to the bit, what an emulation of
    TK4's loads and butterfly and of ``peer_update``'s epilogue add up,
    for every P shape: a partial last partial, a partial last
    super-partial, more than one super-partial, P not a multiple of 4."""
    st = _counters(2, P, P)
    twin = sk.lane_sums_in_order(st).numpy()
    for b in range(2):
        for q, name in enumerate(("cdn_bytes", "p2p_bytes")):
            x = getattr(st, name)[b].numpy()
            want = twin[b, q]
            assert _tk4(x, P).view(np.uint32) == want.view(np.uint32)
            assert _epilogue(x, P).view(np.uint32) == want.view(np.uint32)


@pytest.mark.parametrize("P", [1, 255, 257, 1000, 1001, 262_149])
@pytest.mark.parametrize("B", [1, 4])
def test_the_twin_sums_within_tolerance_and_a_lane_alone(P, B):
    st = _counters(B, P, P + B)
    twin = sk.lane_sums_in_order(st)
    torch.testing.assert_close(twin, sk.lane_sums_plain(st),
                               rtol=SUMS_RTOL, atol=0.0)
    for b in range(B):
        alone = sk.lane_sums_in_order(types.SimpleNamespace(
            cdn_bytes=st.cdn_bytes[b:b + 1], p2p_bytes=st.p2p_bytes[b:b + 1]))
        assert torch.equal(alone[0], twin[b])


# ---- the geometry depends on P alone ----------------------------------------

def _define(src, name):
    with open(os.path.join(_build.CSRC_DIR, src)) as fh:
        return re.search(r"#define %s (\S+)" % name, fh.read()).group(1)


def test_the_order_s_numbers_are_the_sources():
    assert int(_define("lane_sums.cuh", "LS_THREADS")) == sk.SUMS_BLOCK
    assert int(_define("lane_sums.cuh", "LS_FAN")) == sk.SUMS_FAN
    assert _define("lane_sums.cuh", "LS_SUPER") == "(LS_THREADS"
    with open(os.path.join(_build.CSRC_DIR, sk.REDUCE_SOURCE)) as fh:
        text = fh.read()
    # TK4's blocks a lane are the super-partials, checked at launch
    assert "(a->n_peers + LS_SUPER - 1) / LS_SUPER" in text


@pytest.mark.parametrize("P,parts,supers", [
    (1, 1, 1), (256, 1, 1), (257, 2, 1), (1_000, 4, 1), (8_192, 32, 1),
    (8_193, 33, 2), (262_144, 1_024, 32), (1_048_576, 4_096, 128)])
def test_sums_geometry_depends_on_p_alone(monkeypatch, P, parts, supers):
    """Partials, super-partials, counters and scratch a lane are the
    same whatever the batch, so a lane sums in one order alone or
    batched."""
    assert sk.sums_blocks(P) == parts and sk.sums_supers(P) == supers
    made = []

    def counters(dev, name, n):
        made.append((name, n))
        return 0
    monkeypatch.setattr(sk, "_counters", counters)
    for B in (1, 4, 48):
        assert sk.arrival_counters("peer_update", B, P) == B * (1 + supers)
        assert sk.arrival_counters("lane_sums", B, P) == B
        assert sk.arrival_counters("timeline_row", B, P) == B
        for name, width in (("peer_update", parts + supers),
                            ("lane_sums", supers)):
            _sums, scratch, out = sk._sums_out(torch.device("cpu"), name, B,
                                               P, None, 0)
            assert tuple(scratch.shape) == (B, width, 2)
            assert out["counters"] == 0
    assert made == [(name, sk.arrival_counters(name, B, P))
                    for B in (1, 4, 48)
                    for name in ("peer_update", "lane_sums")]


# ---- the clock --------------------------------------------------------------

def _case(P=64, S=16, dt_ms=100.0, batch=None, offsets=None):
    rc = ref.SwarmConfig(n_peers=P, n_segments=S, n_levels=3,
                         neighbor_offsets=offsets or ref.ring_offsets(8),
                         dt_ms=dt_ms)
    pc = port.SwarmConfig(*rc)
    join = port.staggered_joins(P, 5.0, device="cpu")
    scen = port.make_scenario(pc, BITRATES, None,
                              np.full(P, 4e6, np.float32), join, device="cpu")
    state = port.init_swarm(pc, device="cpu")
    if batch:
        scen = port.stack_pytrees([scen] * batch)
        state = port.init_swarm(pc, device="cpu", batch=batch)
    return rc, pc, join, scen, state


def _bits(t):
    return np.asarray(t, np.float32).view(np.uint32).tolist()


@pytest.mark.parametrize("batch", [None, 3])
def test_peer_update_plain_advances_the_clock_once(batch):
    """One float32 add of dt a call, in place, for one lane and for
    stacked lanes; ``select_admit_plain`` leaves the clock alone."""
    _rc, pc, _join, scen, state = _case(batch=batch)
    t_s = state.t_s
    want = np.float32(0.0)
    for _ in range(12):
        flags, req, service, adm = sk.select_admit_plain(pc, scen, state)
        assert _bits(t_s) == _bits(np.broadcast_to(want, t_s.shape))
        sk.peer_update_plain(pc, scen, state, flags, req, service, adm)
        want = np.float32(want + np.float32(pc.dt_ms / 1000.0))
        assert state.t_s is t_s
        assert _bits(t_s) == _bits(np.broadcast_to(want, t_s.shape))
    assert float(want) != 12 * 0.1   # the adds round: a real check


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("offsets", [None, WIDE])
def test_every_step_adds_the_clock_once(batch, offsets):
    """``plain_step``, ``swarm_step`` on the fused route and on the
    TK1 + TK2 route, 45 steps each: the clock ends at the reference's
    bits, and the two paths agree on every field."""
    P, T = (64, 45) if offsets is None else (700, 45)
    rc, pc, join, scen, state = _case(P=P, batch=batch, offsets=offsets)
    assert sk.fused_route(pc) is (offsets is None)
    a, b = state, port.clone_state(state)
    for _ in range(T):
        a = sk.plain_step(pc, scen, a)
        b = port.swarm_step(pc, scen, b)
    for x, y in zip(port.tree_leaves(a), port.tree_leaves(b)):
        assert torch.equal(x, y)
    rfinal, _ = ref.run_swarm(rc, jnp.array(BITRATES), None,
                              jnp.full((P,), 4e6), ref.init_swarm(rc), T,
                              jnp.asarray(join.numpy()))
    want = np.asarray(rfinal.t_s, np.float32)
    assert _bits(a.t_s) == _bits(np.broadcast_to(want, a.t_s.shape))


def test_scan_eager_matches_the_reference_clock_and_ratios():
    """45 steps of ``_scan_eager`` with a timeline row every 9: the
    clock at the reference's bits, each row's clock the clock after its
    step, the final offload and rebuffer within RUN_TOL of the
    reference's, and the last row's offload the last series entry."""
    P, S, T, R = 256, 64, 45, 9
    rc = ref.SwarmConfig(n_peers=P, n_segments=S, n_levels=3,
                         neighbor_offsets=ref.ring_offsets(8), dt_ms=100.0)
    pc = port.SwarmConfig(*rc)
    join = ref.staggered_joins(P, 5.0)
    join_np = np.asarray(join)
    rfinal, rseries = ref.run_swarm(rc, jnp.array(BITRATES), None,
                                    jnp.full((P,), 8e6), ref.init_swarm(rc),
                                    T, join)
    scen = port.make_scenario(pc, BITRATES, None, np.full(P, 8e6, np.float32),
                              join_np, device="cpu")
    final, series, timeline = port._scan_eager(
        pc, scen, port.init_swarm(pc, device="cpu"), T, R)
    assert _bits(final.t_s) == _bits(rfinal.t_s)
    clocks, t = [], np.float32(0.0)
    for _ in range(T):
        t = np.float32(t + np.float32(0.1))
        clocks.append(t)
    ti = port.timeline_columns(pc).index("t_s")
    assert _bits(timeline[:, ti]) == _bits(clocks[R - 1::R])
    elapsed = T * pc.dt_ms / 1000.0
    assert abs(float(port.offload_ratio(final))
               - float(ref.offload_ratio(rfinal))) <= RUN_TOL
    assert abs(float(port.rebuffer_ratio(final, elapsed, join_np))
               - float(ref.rebuffer_ratio(rfinal, elapsed, join))) <= RUN_TOL
    np.testing.assert_allclose(series.numpy(), np.asarray(rseries),
                               atol=RUN_TOL)
    oi = port.timeline_columns(pc).index("offload")
    assert float(timeline[-1, oi]) == float(series[-1])
