"""The port's CUDA kernels (ops/swarm_kernels.py, csrc/swarm_step.cu).

On the CPU: the ctypes mirrors of the kernels' argument structs against
the C source (field for field, since nothing compiles the source here),
the wrappers' dispatch to the plain versions, ``select_admit``'s route
and the index arithmetic of its tiles, and the byte counts
``chip_smoke.py`` computes the kernels' bounds from.  On the card
(marker ``gpu``, skipped without one): each route against the plain
step."""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from hlsjs_p2p_wrapper_tpu_torch.ops import _build
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_kernels as sk
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as port

BITRATES = [300_000.0, 800_000.0, 2_000_000.0]
C_TYPES = {"float*": ctypes.c_void_p, "int*": ctypes.c_void_p,
           "uint32_t*": ctypes.c_void_p, "long long": ctypes.c_longlong,
           "int": ctypes.c_int, "float": ctypes.c_float,
           "SelectArgs": sk._SelectArgs}
#: offset tuples at which the fused kernel's tiles wrap the ring: the
#: main path's ring at P = 16 (< one tile), a degree-12 ring at P = 96,
#: a tuple with an offset beyond P and no negative offset, and the ring
#: at P = 1000, whose last tile is partial (1000 = 7 * 128 + 104)
WRAPS = [(16, port.ring_offsets(8)), (96, port.ring_offsets(12)),
         (16, (1, 2, 20)), (1000, port.ring_offsets(8))]
#: a tuple whose halo is too wide for the fused kernel's tile
WIDE = (1, -1, 2, -2, 97, -97, 300, -300)


def _source():
    """Both CUDA sources of the port, one after the other."""
    out = []
    for src in (sk.SOURCE, sk.REDUCE_SOURCE):
        with open(os.path.join(_build.CSRC_DIR, src)) as fh:
            out.append(fh.read())
    return "\n".join(out)


def _c_struct(name):
    src = _source()
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        m = re.match(r"(?:const )?([\w ]+?\*?)\s*(\w+)(\[MAX_OFFS\])?$",
                     line)
        ctype, fname, arr = m.group(1).replace(" *", "*"), m.group(2), \
            m.group(3)
        fields.append((fname, C_TYPES[ctype], bool(arr)))
    return fields


@pytest.mark.parametrize("c_name,mirror", [
    ("SelectArgs", sk._SelectArgs), ("AdmitArgs", sk._AdmitArgs),
    ("UpdateArgs", sk._UpdateArgs), ("SelectAdmitArgs", sk._SelectAdmitArgs),
    ("LaneSumsArgs", sk._LaneSumsArgs), ("TimelineArgs", sk._TimelineArgs)])
def test_ctypes_mirrors_match_the_c_structs(c_name, mirror):
    c_fields = _c_struct(c_name)
    assert [f for f, _t, _a in c_fields] == [f for f, _t in mirror._fields_]
    for (fname, ctype, is_array), (_n, mtype) in zip(c_fields,
                                                     mirror._fields_):
        if is_array:
            assert mtype._type_ is ctype and mtype._length_ == sk.MAX_OFFS
        else:
            assert mtype is ctype, fname


def test_c_source_flags_and_no_torch_headers():
    src = _source()
    assert "torch/" not in src and "ATen" not in src
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert _build.BUILD_DIR.endswith(os.path.join("build", "torch_kernels"))


def test_select_admit_tile_and_limit_reach_the_build():
    """The route helper's tile and span limit are the only ones: the
    build passes them to nvcc, the source defines neither itself, and a
    changed limit names (so builds) a different library."""
    src = _source()
    tile, span = sk.SELECT_ADMIT_TILE, sk.MAX_FUSED_SPAN
    flags = _build.flags(sk.DEFINES)
    assert f"-DSA_TILE={tile}" in flags and f"-DSA_MAX_SPAN={span}" in flags
    assert not re.search(r"#define SA_(TILE|MAX_SPAN)\b", src)
    assert "#error" in src
    wider = (("SA_TILE", tile), ("SA_MAX_SPAN", span + 1))
    assert (_build.library_path(sk.SOURCE, sk.DEFINES)
            != _build.library_path(sk.SOURCE, wider))
    threads = -(-(tile + span) // 32) * 32
    min_blocks = int(re.search(r"#define SA_MIN_BLOCKS (\d+)", src).group(1))
    assert min_blocks * threads <= 2048   # the blocks fit on an SM


def _case(P=64, S=16, steps=60, offsets=None):
    """A small swarm mid-run: staggered joins over 20 s, so that some
    transfers ride peers (and place demand) 15 s in."""
    config = port.SwarmConfig(
        n_peers=P, n_segments=S, n_levels=3,
        neighbor_offsets=offsets or port.ring_offsets(8))
    join = port.staggered_joins(P, 20.0, device="cpu")
    scenario = port.make_scenario(config, BITRATES, None,
                                  np.full(P, 4e6, np.float32), join,
                                  device="cpu")
    state = port.init_swarm(config, device="cpu")
    for _ in range(steps):
        state = port.swarm_step(config, scenario, state)
    return config, scenario, state


def test_kernel_bytes_counts():
    config, scenario, state = _case()
    before = port.clone_state(state)
    flags, req = sk.elig_select(config, scenario, state)
    service, adm = sk.admit_service(config, scenario, req)
    sk.peer_update(config, scenario, state, flags, req, service, adm)
    nbytes = chip_smoke.kernel_bytes(sk, config, scenario, before, flags,
                                     req, adm, state)
    P, K = config.n_peers, 8
    assert nbytes["admit_service"] == 16 * P + 4
    assert nbytes["select_admit"] == nbytes["elig_select"] + 12 * P + 4
    # TK1 reads at most one word of each neighbour per requester
    assert 4 * 15 * P < nbytes["elig_select"] <= 4 * (22 + K) * P + 64
    assert 4 * 24 * P < nbytes["peer_update"] <= 4 * 38 * P + 8


def test_wrappers_run_plain_on_cpu_and_match():
    config, scenario, state = _case()
    a, b = port.clone_state(state), port.clone_state(state)
    sk.reset_launch_counts()
    fa, ra = sk.elig_select(config, scenario, a)
    fb, rb = sk.elig_select_plain(config, scenario, b)
    assert torch.equal(fa, fb) and torch.equal(ra, rb)
    assert bool((ra >= 0).any())   # some transfers place demand
    sa, ma = sk.admit_service(config, scenario, ra)
    sb, mb = sk.admit_service_plain(config, scenario, rb)
    assert torch.equal(sa, sb) and torch.equal(ma, mb)
    sk.peer_update(config, scenario, a, fa, ra, sa, ma)
    sk.peer_update_plain(config, scenario, b, fb, rb, sb, mb)
    for x, y in zip(port.clone_state(a), port.clone_state(b)):
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            assert torch.equal(u, v)
    assert sk.LAUNCHES == {name: 0 for name in sk.LAUNCHES}


def test_plain_step_is_swarm_step_on_cpu():
    config, scenario, state = _case(steps=30)
    a = port.swarm_step(config, scenario, port.clone_state(state))
    b = sk.plain_step(config, scenario, port.clone_state(state))
    for x, y in zip(a, b):
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            assert torch.equal(u, v)


def test_admission_never_exceeds_the_cap():
    config, scenario, state = _case(P=48, S=8)
    _flags, req = sk.elig_select(config, scenario, state)
    _service, adm = sk.admit_service(config, scenario, req)
    bits = [(adm >> k) & 1 for k in range(8)]
    load = torch.stack(bits).sum(0)
    assert int(load.max()) <= config.max_total_serves


@pytest.mark.parametrize("P,offsets", [(64, None)] + WRAPS)
def test_select_admit_on_cpu_is_the_two_plain_passes(P, offsets):
    config, scenario, state = _case(P=P, offsets=offsets, steps=80)
    a, b = port.clone_state(state), port.clone_state(state)
    sk.reset_launch_counts()
    out = sk.select_admit(config, scenario, a)
    fb, rb = sk.elig_select_plain(config, scenario, b)
    sb, mb = sk.admit_service_plain(config, scenario, rb)
    for x, y in zip(out, (fb, rb, sb, mb)):
        assert torch.equal(x, y)
    assert bool((rb >= 0).any())   # some transfers place demand
    for x, y in zip(a, b):
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            assert torch.equal(u, v)
    assert sk.LAUNCHES == {name: 0 for name in sk.LAUNCHES}


@pytest.mark.parametrize("P,offsets,fused", [
    (262_144, port.ring_offsets(8), True),
    (262_144, WIDE, False),
    (16, port.ring_offsets(8), True),
    (96, port.ring_offsets(12), True),
    (1000, port.ring_offsets(8), True),
    (262_144, (1, -(sk.MAX_FUSED_SPAN - 1)), True),
    (262_144, (1, -sk.MAX_FUSED_SPAN), False)])
def test_route_is_chosen_from_the_offsets(P, offsets, fused):
    config = port.SwarmConfig(n_peers=P, n_segments=16, n_levels=3,
                              neighbor_offsets=offsets)
    assert sk.fused_route(config) is fused


def _tiled_select_admit(config, scenario, state, req, tile):
    """The fused kernel's index arithmetic, block by block, on the
    inputs of one step (``req`` from the plain selection): the requester
    range of each tile with its halo (indices mod P), which requester
    positions own their peer, the (neighbour row, offset) pairs that
    set each requester's eligibility bits, and each holder's walk over
    the block's copy of req.  Returns ``(owners per peer, eligibility
    bits per requester position as {peer: set of values}, service,
    adm)``."""
    g = sk.geometry(config)
    P = g.P
    tg = sk.slot_targets(config, scenario, state)
    wi = (tg["gi_flat"][..., 0] >> 5).numpy()
    bit = (tg["gi_flat"][..., 0] & 31).numpy()
    avail = port.i32_to_u32(state.avail).numpy()
    serve = (tg["present"] & (scenario.p2p_ok > 0.0)).numpy()
    req = req[..., 0].numpy()
    up = scenario.uplink_bps.numpy()
    eff = np.float32(scenario.uplink_efficiency.numpy())
    owners = np.zeros(P, np.int64)
    elig = {}
    service = np.zeros(P, np.float32)
    adm = np.zeros(P, np.int32)
    span = g.o_hi - g.o_lo
    R, H = tile + span, tile + 2 * span
    for b in range(0, P, tile):
        q0 = b - g.o_hi
        h0 = q0 + g.o_lo
        peer = (q0 + np.arange(R)) % P
        bits = np.zeros(R, np.int64)
        for h in range(H):
            row = (h0 + h) % P
            for k, o in enumerate(g.offs):
                q = h + g.o_lo - o
                if 0 <= q < R and serve[row]:
                    r = peer[q]
                    if (avail[row, wi[r]] >> bit[r]) & 1:
                        bits[q] |= 1 << k
        for q in range(R):
            elig.setdefault(int(peer[q]), set()).add(int(bits[q]))
            u = q - g.o_hi
            if 0 <= u < tile and b + u < P:
                owners[peer[q]] += 1
        req_s = req[peer]
        for jl in range(min(tile, P - b)):
            cum, mask = np.float32(0.0), 0
            for k, o in enumerate(g.offs):
                if req_s[jl - o + g.o_hi] == k and cum < g.cap:
                    cum += np.float32(1.0)
                    mask |= 1 << k
            service[b + jl] = up[b + jl] * eff / max(cum, np.float32(1.0))
            adm[b + jl] = mask
    return owners, elig, service, adm


@pytest.mark.parametrize("P,offsets,tile", [
    (64, port.ring_offsets(8), 16), (200, port.ring_offsets(8), 64)]
    + [(P, o, sk.SELECT_ADMIT_TILE) for P, o in WRAPS])
def test_fused_tiles_cover_the_ring_and_match_tk1_tk2(P, offsets, tile):
    """Every peer is owned by exactly one requester position; every
    position of a peer, halo copies included, gathers the circulant
    eligibility of that peer; and the holders' walk over a block's copy
    of req gives TK2's result, also where the ring wraps inside one
    tile."""
    config, scenario, state = _case(P=P, offsets=offsets, steps=80)
    g = sk.geometry(config)
    tg = sk.slot_targets(config, scenario, state)
    serve = tg["present"] & (scenario.p2p_ok > 0.0)
    ref, _n, _own = port.circulant_eligibility(
        state.avail, serve, list(g.offs), [tg["gi_flat"][..., 0]],
        impl="kpass")[0]
    ref_bits = sum((e > 0).to(torch.int64) << k for k, e in enumerate(ref))
    _flags, req = sk.elig_select_plain(config, scenario,
                                       port.clone_state(state))
    assert bool((req >= 0).any())
    owners, elig, service, adm = _tiled_select_admit(config, scenario,
                                                     state, req, tile)
    assert (owners == 1).all()
    assert elig == {p: {int(ref_bits[p])} for p in range(P)}
    assert int(ref_bits.count_nonzero()) > 0
    sv, ad = sk.admit_service_plain(config, scenario, req)
    np.testing.assert_array_equal(adm, ad[..., 0].numpy())
    np.testing.assert_array_equal(service, sv.numpy())


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("P,offsets", [(4096, port.ring_offsets(8)),
                                       (4096, WIDE),
                                       (1000, port.ring_offsets(8))])
def test_kernels_match_plain_on_the_card(cuda_device, P, offsets):
    S = 64
    config = port.SwarmConfig(n_peers=P, n_segments=S, n_levels=3,
                              neighbor_offsets=offsets)
    join = port.staggered_joins(P, 10.0, device=cuda_device)
    scenario = port.make_scenario(config, BITRATES, None,
                                  np.full(P, 8e6, np.float32), join,
                                  device=cuda_device)
    state = port.init_swarm(config, device=cuda_device)
    for _ in range(60):
        state = sk.plain_step(config, scenario, state)
    a, b = port.clone_state(state), port.clone_state(state)
    sk.reset_launch_counts()
    for _ in range(20):
        a = port.swarm_step(config, scenario, a)
        b = sk.plain_step(config, scenario, b)
    torch.cuda.synchronize()
    fused = sk.fused_route(config)
    assert fused is (offsets == port.ring_offsets(8))
    assert sk.LAUNCHES == {"select_admit": 20 if fused else 0,
                           "elig_select": 0 if fused else 20,
                           "admit_service": 0 if fused else 20,
                           "peer_update": 20, "lane_sums": 0,
                           "timeline_row": 0, "elig_select_gather": 0,
                           "admit_gather": 0, "peer_update_gather": 0,
                           "timeline_row_cohorts": 0}
    for x, y in zip(a, b):
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            if u.is_floating_point():
                torch.testing.assert_close(u, v, rtol=1e-6, atol=1e-6)
            else:
                assert torch.equal(u, v)


def _lanes_case(device, P=4096, S=64, warm=52, more=8):
    """Four stacked VOD grid points mid-run on ``device``: the state
    ``more`` plain steps after ``prev``."""
    from hlsjs_p2p_wrapper_tpu_torch import sweep_grid as sg
    config = sg.build_config(P, S, False, 8)
    join = port.staggered_joins(P, 10.0, device=device)
    scenario = port.stack_pytrees(
        [sg.build_scenario(config, k, watch_s=20.0, stagger_s=10.0, seed=0,
                           join_s=join, device=device)[0]
         for k in sg.sample_grid(sg.vod_grid(), 4)])
    state = port.init_swarm(config, device=device, batch=4)
    for _ in range(warm):
        state = sk.plain_step(config, scenario, state)
    prev = port.clone_state(state)
    for _ in range(more):
        state = sk.plain_step(config, scenario, state)
    return config, scenario, prev, state


@pytest.mark.gpu
def test_batched_kernels_match_plain_on_the_card(cuda_device):
    """Four lanes stepped by the kernels, one launch of each a step,
    against the plain step."""
    config, scenario, _prev, state = _lanes_case(cuda_device)
    a, b = port.clone_state(state), port.clone_state(state)
    sk.reset_launch_counts()
    for _ in range(20):
        a = port.swarm_step(config, scenario, a)
        b = sk.plain_step(config, scenario, b)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == {"select_admit": 20, "elig_select": 0,
                           "admit_service": 0, "peer_update": 20,
                           "lane_sums": 0, "timeline_row": 0,
                           "elig_select_gather": 0, "admit_gather": 0,
                           "peer_update_gather": 0,
                           "timeline_row_cohorts": 0}
    for u, v in zip(port.tree_leaves(a), port.tree_leaves(b)):
        if u.is_floating_point():
            torch.testing.assert_close(u, v, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(u, v)


@pytest.mark.gpu
@pytest.mark.parametrize("digest", [False, True])
def test_reductions_match_plain_on_the_card(cuda_device, digest):
    """``lane_sums`` and ``timeline_row`` against their plain versions:
    sums within 1e-5 relative (another summation order), counts and
    everything taken from the same sums equal; a lane alone sums to
    the bits of its batch, and the rebuffer ratio alone to the bits of
    the row's rebuffer column."""
    config, scenario, prev, state = _lanes_case(cuda_device)
    config = config._replace(stall_digest=digest)
    series = torch.zeros((4, 2), device=cuda_device)
    sums = sk.lane_sums(state, series, 1)
    torch.testing.assert_close(sums, sk.lane_sums_plain(state), rtol=1e-5,
                               atol=0.0)
    for b in range(4):
        alone = sk.lane_sums(port.as_lanes(port.lane(state, b)))
        assert torch.equal(alone[0], sums[b])
    cols = port.timeline_columns(config)
    ri = cols.index("rebuffer")
    rows = []
    for fn in (sk.timeline_row, sk.timeline_row_plain):
        out = torch.zeros((4, 1, len(cols)), device=cuda_device)
        fn(config, scenario, state, sums, sk.lane_sums_plain(prev),
           prev.rebuffer_s.clone(), out, 0, 8)
        rows.append(out[:, 0])
    kernel, plain = rows
    keep = [i for i in range(len(cols)) if i != ri]
    assert torch.equal(kernel[:, keep], plain[:, keep])
    torch.testing.assert_close(kernel[:, ri], plain[:, ri], rtol=1e-5,
                               atol=0.0)
    assert bool((kernel[:, cols.index("stalled_peers")] > 0).any())
    ratio = sk.rebuffer_ratio_lanes(state.rebuffer_s, scenario.join_s,
                                    scenario.leave_s, state.t_s)
    assert torch.equal(ratio, kernel[:, ri])
