"""The gather kernels' designs on the general ``[P, K]`` path, modelled in
PyTorch on the CPU and held to the port's plain versions.

``admit_gather`` walks a holder's inbound edge row once for all transfer
slots: per slot a bit mask of the edges whose requester selected this
holder, 32 edges a mask word, then the admission slot by slot from the
masks (the match of rank n admitted iff the count at the slot's start
plus n is below the cap, the count carried across slots).  The model
below computes exactly that and is held to ``admit_service_plain`` on
random meshes whose inbound rows fit one mask word and on one whose rows
take two, at caps 1 and 2 and uncapped, with 1, 3 and 5 slots.

``elig_select_gather`` gathers each serving neighbour's map data once for
all slots: a row of at most 4 words whole, a wider row one word per
distinct word index across the slots.  The model stands in for the
eligibility inside ``elig_select_plain``, and the selection's flags,
``req`` and the state it writes must equal the plain selection's at map
widths of 1, 4 and 8 words, with the gathers counted."""

import numpy as np
import pytest
import torch

from hlsjs_p2p_wrapper_tpu_torch import policy_grid as pg
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_kernels as sk
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as port

#: edges a mask word
MASK_BITS = 32


def _popcount(x: torch.Tensor) -> torch.Tensor:
    return sum(((x >> b) & 1) for b in range(MASK_BITS))


def admit_model(in_edges: torch.Tensor, req: torch.Tensor, K: int,
                cap: float, uplink: torch.Tensor, efficiency: torch.Tensor):
    """``admit_gather``'s algorithm on lanes: ``in_edges [B, P, n_in]``,
    ``req [B, P, C]``.  Returns ``(service [B, P], adm [B, P, C],
    masks)``, ``adm`` 0 where no holder wrote a flag, ``masks[c][w]`` slot
    c's mask word w ``[B, P]``."""
    B, P, n_in = in_edges.shape
    C = req.shape[-1]
    ok = in_edges >= 0
    flat = torch.clamp_min(in_edges, 0).long()
    src, col = flat // K, flat % K
    # one walk: each edge's requester's C entries together
    rq = torch.gather(req.long(), 1, src.reshape(B, -1, 1).expand(-1, -1, C))
    match = ok.unsqueeze(-1) & (rq.reshape(B, P, n_in, C) == col.unsqueeze(-1))
    n_words = -(-n_in // MASK_BITS)
    masks = [[sum(match[..., e, c].long() << (e - w * MASK_BITS)
                  for e in range(w * MASK_BITS,
                                 min(n_in, (w + 1) * MASK_BITS)))
              for w in range(n_words)] for c in range(C)]
    # the counts, slot by slot: the slot's start, then admission while
    # the count is below the cap
    cum = torch.zeros((B, P), dtype=torch.float32)
    starts = []
    for c in range(C):
        starts.append(cum.clone())
        n = sum(_popcount(m) for m in masks[c])
        for step in range(n_in):
            cum = cum + ((n > step) & (cum < cap)).to(torch.float32)
    # the flags, each slot's matches in edge order
    adm = torch.zeros((B, P, C), dtype=torch.int32)
    lanes = torch.arange(B)[:, None].expand(B, P)
    for c in range(C):
        cur = starts[c]
        for w, m in enumerate(masks[c]):
            for b in range(min(MASK_BITS, n_in - w * MASK_BITS)):
                hit = ((m >> b) & 1) == 1
                i = src[..., w * MASK_BITS + b]
                adm[lanes[hit], i[hit], c] = (cur[hit] < cap).to(torch.int32)
                cur = cur + hit.to(torch.float32)
    service = uplink * efficiency[:, None] / torch.clamp_min(cum, 1.0)
    return service, adm, masks


def _mesh_lanes(peers, degree, slots, cap, seed):
    """One lane of ``random_neighbors(peers, degree, seed)`` and a ``req``
    that selects, per requester and slot, a random real column or none."""
    rng = np.random.default_rng(seed)
    nbr = port.random_neighbors(peers, degree, seed, device="cpu")
    config = port.SwarmConfig(n_peers=peers, n_segments=8, n_levels=1,
                              max_concurrency=slots, max_total_serves=cap)
    uplink = rng.uniform(1e6, 9e6, peers).astype(np.float32)
    scen = port.as_lanes(port.make_scenario(
        config, [1e6], nbr, np.full(peers, 8e6), device="cpu",
        uplink_bps=uplink))
    k = rng.integers(0, degree, (peers, slots))
    real = nbr.numpy()[np.arange(peers)[:, None], k] != np.arange(
        peers)[:, None]
    want = rng.random((peers, slots)) < 0.8
    req = torch.from_numpy(np.where(real & want, k, -1).astype(np.int32))
    return config, scen, req.unsqueeze(0)


@pytest.mark.parametrize("peers,degree", [(256, 8), (48, 32)],
                         ids=["one_mask_word", "two_mask_words"])
@pytest.mark.parametrize("slots", [1, 3, 5])
@pytest.mark.parametrize("cap", [1, 2, 0], ids=["cap1", "cap2", "uncapped"])
def test_admission_model_matches_plain(peers, degree, slots, cap):
    config, scen, req = _mesh_lanes(peers, degree, slots, cap,
                                    seed=peers + slots + cap)
    n_in = scen.in_edges.shape[-1]
    assert (n_in > MASK_BITS) == (degree > MASK_BITS // 2)
    g = sk.geometry(config)
    service, adm, masks = admit_model(scen.in_edges, req, degree, g.cap,
                                      scen.uplink_bps,
                                      scen.uplink_efficiency)
    want_service, want_adm = sk.admit_service_plain(config, scen, req)
    placed = req >= 0
    assert torch.equal(service, want_service)
    assert torch.equal(torch.where(placed, adm, 0), want_adm)
    n_match = sum(int(_popcount(m).sum()) for ms in masks for m in ms)
    assert n_match == int(placed.sum())   # every demand reaches its holder
    if n_in > MASK_BITS:
        # matches past the first 32 edges: the second word binds
        assert any(int(ms[1].count_nonzero()) for ms in masks)
    if cap:
        assert int((placed & (want_adm == 0)).sum()) > 0   # the cap binds


def reuse_eligibility(counts):
    """``gather_eligibility`` as ``elig_select_gather`` gathers the map:
    once per serving neighbour for all slots, the whole row where it
    holds at most 4 words, else one word per distinct word index across
    the slots (a slot whose index an earlier slot shares takes that
    slot's word).  ``counts["loads"]`` adds the map loads a requester
    issues, ``counts["serving"]`` the serving neighbours."""
    def eligibility(avail_p, present, neighbors, gi_flats):
        P, W = avail_p.shape[-2:]
        K = neighbors.shape[-1]
        lead = tuple(avail_p.shape[:-2])
        peer = torch.arange(P)
        nbr = neighbors.long()
        serving = (nbr != peer[:, None]) & torch.gather(
            present, -1, nbr.reshape(lead + (P * K,))).reshape(nbr.shape)
        rows = torch.gather(
            avail_p.reshape(lead + (P * W,)), -1,
            (nbr.unsqueeze(-1) * W + torch.arange(W)).reshape(
                lead + (P * K * W,))).reshape(nbr.shape + (W,))
        wis = [(gf >> 5).long() for gf in gi_flats]
        bits = [(gf & 31).long() for gf in gi_flats]
        counts["serving"] += int(serving.sum())
        words = []
        if W <= 4:
            copy = torch.where(serving.unsqueeze(-1), rows, 0)
            counts["loads"] += int(serving.sum())
            for wi in wis:
                words.append(torch.gather(
                    copy, -1, wi[..., None, None].expand(
                        nbr.shape + (1,)))[..., 0])
        else:
            for c, wi in enumerate(wis):
                first = torch.full_like(wi, c)
                for o in range(c - 1, -1, -1):
                    first = torch.where(wis[o] == wi, o, first)
                fresh = (first == c).unsqueeze(-1) & serving
                counts["loads"] += int(fresh.sum())
                word = torch.where(fresh, torch.gather(
                    rows, -1, wi[..., None, None].expand(
                        nbr.shape + (1,)))[..., 0], 0)
                for o in range(c):
                    word = torch.where((first == o).unsqueeze(-1), words[o],
                                       word)
                words.append(word)
        out = []
        for wi, bit, word in zip(wis, bits, words):
            elig = (serving & (((word >> bit.unsqueeze(-1)) & 1) == 1)).to(
                torch.float32)
            own = ((torch.gather(avail_p, -1, wi.unsqueeze(-1))[..., 0]
                    >> bit) & 1) == 1
            out.append((list(elig.unbind(-1)), elig.sum(-1), own))
        return out
    return eligibility


def _shift_segments(config, state, n):
    """A clone of ``state`` whose playheads and one-level cache maps moved
    ``n`` segments on: the wishes cross into the next map word where the
    slots in flight keep their targets, so slots ask for distinct
    words."""
    g = sk.geometry(config)
    assert g.L == 1
    st = port.clone_state(state)
    st.playhead_s.add_(n * g.seg)
    shape = st.avail.shape
    bits = ((st.avail.long().unsqueeze(-1) >> torch.arange(32)) & 1).reshape(
        shape[:-1] + (g.W * 32,))
    bits = torch.cat([torch.zeros_like(bits[..., :n]), bits[..., :-n]], -1)
    words = (bits.reshape(shape + (32,)) << torch.arange(32)).sum(-1)
    st.avail.copy_(torch.where(words >= 1 << 31, words - (1 << 32),
                               words).to(torch.int32))
    return st


@pytest.mark.parametrize("segments,policy", [(32, "spread"),
                                             (128, "adaptive"),
                                             (256, "ranked")],
                         ids=["W1", "W4", "W8"])
def test_map_reuse_model_matches_plain_selection(monkeypatch, segments,
                                                 policy):
    peers, slots = 256, 3
    config = pg.random_config(peers, segments, policy)._replace(
        max_concurrency=slots)
    g = sk.geometry(config)
    assert g.W == segments // 32
    mesh = pg.random_topology(peers, 3, device="cpu")
    audience = pg.build_audience(peers, 3, device="cpu")
    lanes = [pg.build_cell_scenario(config, audience, uplink_bps=up * 1e6,
                                    pattern=pattern, wave=wave, watch_s=20.0,
                                    neighbors=mesh)[0]
             for pattern, wave, up in list(pg.cells())[:2]]
    scen = port.stack_pytrees(lanes)
    state = port.init_swarm(config, 8, device="cpu", batch=len(lanes))
    counts = {"loads": 0, "serving": 0}
    eligible = 0
    for step in range(40):
        if step % 8 == 7:
            for st in (state, _shift_segments(config, state, 30)):
                want_state = port.clone_state(st)
                want = sk.elig_select_plain(config, scen, want_state)
                with monkeypatch.context() as m:
                    m.setattr(sk, "gather_eligibility",
                              reuse_eligibility(counts))
                    got_state = port.clone_state(st)
                    got = sk.elig_select_plain(config, scen, got_state)
                for u, v in zip(got, want):
                    assert torch.equal(u, v)
                for u, v in zip(port.tree_leaves(got_state),
                                port.tree_leaves(want_state)):
                    assert torch.equal(u, v)
                eligible += int((want[0] & 8).count_nonzero())
        state = sk.plain_step(config, scen, state)
    assert counts["serving"] > 0 and eligible > 0
    if g.W <= 4:
        assert counts["loads"] == counts["serving"]
    else:
        # one load a serving neighbour per distinct word: slots that share
        # a word and slots that do not both occur
        assert counts["serving"] < counts["loads"] < slots * counts[
            "serving"]
