"""The scan as the card runs it, checked on the CPU: the step's clock
added in place, the offload sums that ``peer_update`` now returns, the
graph path's replay bookkeeping (series columns, timeline rows,
trailing steps, launch counts) against the eager loop, and the port's
own joins against the JAX reference's runs.

The CPU has no CUDA graphs, so the graph path runs here with an eager
stand-in for the capture: the captured callable runs at each replay.
Tolerances: the graph path and the eager loop to the bit; the series,
``offload_ratio_batch`` and the last timeline row to the bit; the port
against the reference ``RUN_TOL`` = 1e-4 (tests/test_torch_swarm_sim.py:
float32 sums over peers taken in another order)."""

import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlsjs_p2p_wrapper_tpu.ops import swarm_sim as ref
from hlsjs_p2p_wrapper_tpu_torch import sweep_grid as sg
from hlsjs_p2p_wrapper_tpu_torch.ops import _build
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_kernels as sk
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as port
from hlsjs_p2p_wrapper_tpu_torch.testing import (REFERENCE_BATCH,
                                                 run_batch_fixture)
from hlsjs_p2p_wrapper_tpu_torch.testing.rehearse import EagerGraph

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import sweep as ref_sweep  # noqa: E402

BITRATES = [300_000.0, 800_000.0, 2_000_000.0]
RUN_TOL = 1e-4


def _lanes(n_lanes=3, P=96, S=16, window_s=8.0, dt_ms=250.0):
    """``n_lanes`` VOD grid points at the ample supply point (where
    peers serve, so the offload is not 0), stacked, with shared joins."""
    config = sg.build_config(P, S, False, 8)._replace(dt_ms=dt_ms)
    join = port.staggered_joins(P, window_s, device="cpu")
    grid = sg.vod_grid()[3::4][:n_lanes]
    scen = port.stack_pytrees(
        [sg.build_scenario(config, k, watch_s=30.0, stagger_s=window_s,
                           seed=0, join_s=join, device="cpu")[0]
         for k in grid])
    return config, scen, join


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in
               zip(port.tree_leaves(a), port.tree_leaves(b)))


@pytest.fixture
def graph_on_cpu(monkeypatch):
    """The graph path on CPU tensors, captures recorded by length."""
    captured = []

    def capture(fn, dev, n_lanes, n_peers, pool=None):
        captured.append(n_lanes)
        return sk.Graph(EagerGraph(fn), {}, None)
    monkeypatch.setattr(sk, "graph_path", lambda dev: True)
    monkeypatch.setattr(sk, "capture", capture)
    return captured


# ---- the clock -------------------------------------------------------------

@pytest.mark.parametrize("batch", [None, 3])
def test_clock_keeps_its_storage_and_matches_the_reference(batch):
    """45 steps of dt = 0.1 s (a float32 add that rounds): ``t_s`` is
    the same tensor, at the same address, after each step, and ends at
    the reference's clock to the bit."""
    P, S, T = 64, 16, 45
    rc = ref.SwarmConfig(n_peers=P, n_segments=S, n_levels=3,
                         neighbor_offsets=ref.ring_offsets(8), dt_ms=100.0)
    pc = port.SwarmConfig(*rc)
    join = port.staggered_joins(P, 5.0, device="cpu")
    scen = port.make_scenario(pc, BITRATES, None,
                              np.full(P, 4e6, np.float32), join,
                              device="cpu")
    state = port.init_swarm(pc, device="cpu")
    if batch:
        scen = port.stack_pytrees([scen] * batch)
        state = port.init_swarm(pc, device="cpu", batch=batch)
    t_s, ptr = state.t_s, state.t_s.data_ptr()
    for _ in range(T):
        out = port.swarm_step(pc, scen, state)
        assert out.t_s is t_s and out.t_s.data_ptr() == ptr
    rfinal, _ = ref.run_swarm(rc, jnp.array(BITRATES), None,
                              jnp.full((P,), 4e6), ref.init_swarm(rc), T,
                              jnp.asarray(join.numpy()))
    want = np.asarray(rfinal.t_s, np.float32)
    got = t_s.numpy()
    assert got.view(np.uint32).tolist() == np.broadcast_to(
        want, got.shape).view(np.uint32).tolist()
    assert float(want) != T * 0.1   # the adds round: a real check


def test_plain_step_adds_the_clock_in_place():
    config, scen, _join = _lanes()
    state = port.init_swarm(config, device="cpu", batch=3)
    t_s = state.t_s
    out = sk.plain_step(config, scen, state)
    assert out.t_s is t_s and torch.equal(t_s, torch.full((3,), 0.25))


# ---- peer_update's sums ----------------------------------------------------

def test_peer_update_returns_the_lane_sums_on_cpu():
    config, scen, _join = _lanes()
    state = port.init_swarm(config, device="cpu", batch=3)
    for _ in range(40):
        port.swarm_step(config, scen, state)
    flags, req, service, adm = sk.select_admit(config, scen, state)
    series = torch.zeros((3, 4))
    sums = sk.peer_update(config, scen, state, flags, req, service, adm,
                          series=series, column=2)
    ref_series = torch.zeros((3, 4))
    assert torch.equal(sums, sk.lane_sums(state, ref_series, 2))
    assert torch.equal(series, ref_series)
    assert bool((series[:, 2] > 0).all())
    one = port.lane(port.clone_state(state), 0)
    f1, r1, s1, a1 = sk.select_admit(config, port.lane(scen, 0), one)
    single = sk.peer_update(config, port.lane(scen, 0), one, f1, r1, s1, a1)
    assert tuple(single.shape) == (2,)
    assert torch.equal(single, sk.lane_sums(port.as_lanes(one))[0])


def test_sums_blocks_are_the_kernels_blocks():
    """``peer_update``'s blocks are the offload sums' blocks: one
    thread a peer, ``SUMS_BLOCK`` peers a block, in both sources."""
    def define(src, name):
        with open(os.path.join(_build.CSRC_DIR, src)) as fh:
            text = fh.read()
        return int(re.search(r"#define %s (\d+)" % name, text).group(1))
    assert define(sk.SOURCE, "BLOCK") == sk.SUMS_BLOCK
    assert define("lane_sums.cuh", "LS_THREADS") == sk.SUMS_BLOCK
    with open(os.path.join(_build.CSRC_DIR, sk.REDUCE_SOURCE)) as fh:
        assert '#include "lane_sums.cuh"' in fh.read()
    for P, nb in ((1, 1), (256, 1), (257, 2), (1_000, 4),
                  (1_048_576, 4_096)):
        assert sk.sums_blocks(P) == nb


def test_a_changed_header_names_another_library(tmp_path, monkeypatch):
    """The build's hash covers the headers beside a source."""
    for name in (sk.SOURCE, "lane_sums.cuh"):
        (tmp_path / name).write_text("// a\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    before = _build.library_path(sk.SOURCE)
    (tmp_path / "lane_sums.cuh").write_text("// b\n")
    assert _build.library_path(sk.SOURCE) != before


def test_update_args_mirror_has_the_sums_fields_in_c_order():
    """The epilogue's fields of ``UpdateArgs``, pinned by name and place
    (a wrong order is a size-checked load error on the card)."""
    names = [n for n, _t in sk._UpdateArgs._fields_]
    i = names.index("dl_cooldown_ms")
    assert names[i + 1:i + 5] == ["partials", "counters", "sums", "series"]
    assert names[i + 5:i + 7] == ["n_peers", "series_stride"]
    assert names[names.index("n_offs") + 1] == "column"
    with open(os.path.join(_build.CSRC_DIR, sk.SOURCE)) as fh:
        body = re.search(r"struct UpdateArgs \{(.*?)\};", fh.read(),
                         re.S).group(1)
    c_names = re.findall(r"(\w+)(?:\[MAX_OFFS\])?;",
                         re.sub(r"//.*", "", body))
    assert c_names == names


# ---- the graph path's bookkeeping ------------------------------------------

@pytest.mark.parametrize("n_steps,record_every", [
    (100, 0), (7, 0), (40, 0), (45, 20), (40, 40), (41, 3), (5, 8)])
def test_graph_path_equals_the_eager_loop(graph_on_cpu, n_steps,
                                          record_every):
    """Replayed runs of steps (a graph per interval, else per
    GRAPH_STEPS steps, and one for the trailing steps) give the eager
    loop's final state, series and timeline to the bit; one capture per
    distinct run length."""
    config, scen, _join = _lanes()
    a = port.init_swarm(config, device="cpu", batch=3)
    b = port.clone_state(a)
    ga = port._scan_swarm(config, scen, a, n_steps, record_every)
    eb = port._scan_eager(config, scen, b, n_steps, record_every)
    assert _equal(ga[0], eb[0])
    assert len(ga) == len(eb) == (3 if record_every else 2)
    for x, y in zip(ga[1:], eb[1:]):
        assert torch.equal(x, y)
    G = record_every or port.GRAPH_STEPS
    lengths = {min(G, n_steps - d) for d in range(0, n_steps, G)}
    assert len(graph_on_cpu) == len(lengths)


def test_graph_path_single_scenario(graph_on_cpu):
    config, scen, _join = _lanes(n_lanes=1)
    one = port.lane(scen, 0)
    a = port.init_swarm(config, device="cpu")
    b = port.clone_state(a)
    fa, sa, ta = port._scan_swarm(config, one, a, 50, 10)
    fb, sb, tb = port._scan_eager(config, one, b, 50, 10)
    assert fa.t_s.dim() == 0 and tuple(sa.shape) == (50,)
    assert _equal(fa, fb) and torch.equal(sa, sb) and torch.equal(ta, tb)


def test_graph_replay_counts_its_launches():
    sk.reset_launch_counts()
    g = sk.Graph(EagerGraph(lambda: None),
                 {"select_admit": 40, "peer_update": 40}, None)
    g.replay()
    g.replay()
    assert sk.LAUNCHES["select_admit"] == sk.LAUNCHES["peer_update"] == 80
    assert sk.LAUNCHES["lane_sums"] == 0
    sk.reset_launch_counts()


class _FakeCUDAGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1

    def pool(self):
        return ("pool", id(self))


def test_capture_moves_its_launches_to_the_replays(monkeypatch):
    """Launches made while captured run nothing: ``capture`` takes them
    off the counts and each replay adds them back; a failed capture
    leaves the counts as they were and raises."""
    def record(fn, dev, pool):
        fn()
        return _FakeCUDAGraph()
    monkeypatch.setattr(sk, "_prepare_capture", lambda dev, n, p: None)
    monkeypatch.setattr(sk, "_record", record)
    sk.reset_launch_counts()
    sk.LAUNCHES["lane_sums"] = 1

    def steps():
        for _ in range(3):
            sk.LAUNCHES["select_admit"] += 1
            sk.LAUNCHES["peer_update"] += 1
    g = sk.capture(steps, torch.device("cpu"), 2, 256)
    assert g.launches == {"select_admit": 3, "peer_update": 3}
    assert g.pool == ("pool", id(g.graph))
    assert sk.LAUNCHES == {**{k: 0 for k in sk.LAUNCHES}, "lane_sums": 1}
    g.replay()
    assert sk.LAUNCHES["peer_update"] == 3 and g.graph.replays == 1

    def fails():
        sk.LAUNCHES["select_admit"] += 1
        raise RuntimeError("capture failed")
    before = dict(sk.LAUNCHES)
    with pytest.raises(RuntimeError, match="capture failed"):
        sk.capture(fails, torch.device("cpu"), 2, 256)
    assert sk.LAUNCHES == before
    sk.reset_launch_counts()


# ---- which kernel each wrapper launches -------------------------------------

def test_kernel_of_names_every_launching_wrapper():
    """Every launch in the module goes through a wrapper that
    ``KERNEL_OF`` names, by the wrapper's own name, to a counted
    kernel."""
    with open(sk.__file__) as fh:
        text = fh.read()
    launched_by = re.findall(r'_launch\("(\w+)"', text)
    assert sorted(set(launched_by)) == sorted(sk.KERNEL_OF)
    for wrapper in launched_by:
        body = text[text.index(f"def {wrapper}("):]
        body = body[:body.index("\ndef ", 1)]
        assert f'_launch("{wrapper}"' in body
    assert set(sk.KERNEL_OF.values()) == set(sk.LAUNCHES)


@pytest.mark.parametrize("offsets,fused", [
    (port.ring_offsets(8), True),
    ((1, -sk.MAX_FUSED_SPAN), False)])
def test_select_admit_routes_before_the_device(monkeypatch, offsets, fused):
    """``select_admit`` takes the route ``fused_route`` gives on the CPU
    too, through the wrappers ``KERNEL_OF`` names, and its outputs are
    ``select_admit_plain``'s to the bit on either route."""
    config = port.SwarmConfig(n_peers=64, n_segments=16, n_levels=3,
                              neighbor_offsets=offsets)
    scen = port.make_scenario(config, BITRATES, None,
                              np.full((64,), 8e6, np.float32),
                              port.staggered_joins(64, 4.0, device="cpu"),
                              device="cpu")
    state = port.init_swarm(config, device="cpu")
    for _ in range(12):
        port.swarm_step(config, scen, state)
    called = []
    for wrapper in ("select_admit_fused", "elig_select", "admit_service"):
        fn = getattr(sk, wrapper)
        monkeypatch.setattr(sk, wrapper, lambda *a, _fn=fn, _w=wrapper, **k:
                            called.append(_w) or _fn(*a, **k))
    a, b = port.clone_state(state), port.clone_state(state)
    out = sk.select_admit(config, scen, a)
    want = sk.select_admit_plain(config, scen, b)
    assert called == (["select_admit_fused"] if fused
                      else ["elig_select", "admit_service"])
    assert all(torch.equal(x, y) for x, y in zip(out, want))
    assert _equal(a, b)


def test_the_card_takes_the_graph_path():
    assert sk.graph_path(torch.device("cuda"))
    assert sk.graph_path("cuda:0")
    assert not sk.graph_path(torch.device("cpu"))


# ---- the series, the final ratio and the last row agree --------------------

@pytest.mark.parametrize("n_steps,record_every", [(40, 8), (45, 15), (30, 30)])
def test_series_final_offload_and_last_row_agree(n_steps, record_every):
    config, scen, _join = _lanes(n_lanes=4)
    final, series, tl = port.run_swarm_batch(
        config, scen, port.init_swarm(config, device="cpu", batch=4),
        n_steps, record_every=record_every)
    cols = port.timeline_columns(config)
    offs = port.offload_ratio_batch(final)
    assert torch.equal(series[:, -1], offs)
    if n_steps % record_every == 0:
        assert torch.equal(tl[:, -1, cols.index("offload")], offs)
    for b in range(4):
        assert float(port.offload_ratio(port.lane(final, b))) == float(
            offs[b])


# ---- the port's own joins against the reference ----------------------------

@pytest.mark.parametrize("cdn_bps", [8e6, 2.5e6])
def test_whole_run_with_the_ports_joins_matches_reference(cdn_bps):
    """256 × 64 × 100 steps, each side drawing its own joins (the same
    bits): the series and the final ratios within RUN_TOL."""
    P, S, T = 256, 64, 100
    rc = ref.SwarmConfig(n_peers=P, n_segments=S, n_levels=3,
                         neighbor_offsets=ref.ring_offsets(8))
    pc = port.SwarmConfig(*rc)
    rjoin = ref.staggered_joins(P, 60.0)
    pjoin = port.staggered_joins(P, 60.0, device="cpu")
    np.testing.assert_array_equal(pjoin.numpy(), np.asarray(rjoin))
    fr, series_r = ref.run_swarm(rc, jnp.array(BITRATES), None,
                                 jnp.full((P,), cdn_bps),
                                 ref.init_swarm(rc), T, rjoin)
    fp, series_p = port.run_swarm(pc, BITRATES, None,
                                  np.full((P,), cdn_bps, np.float32),
                                  port.init_swarm(pc, device="cpu"), T,
                                  pjoin, device="cpu")
    np.testing.assert_allclose(series_p.numpy(), np.asarray(series_r),
                               atol=RUN_TOL)
    elapsed = T * pc.dt_ms / 1000.0
    assert abs(float(port.offload_ratio(fp))
               - float(ref.offload_ratio(fr))) <= RUN_TOL
    assert abs(float(port.rebuffer_ratio(fp, elapsed, pjoin))
               - float(ref.rebuffer_ratio(fr, elapsed, rjoin))) <= RUN_TOL


def test_batch_fixture_without_passed_joins():
    """The batch fixture's four VOD points with the joins the port draws
    itself: the fixture's joins to the bit, and its reference results
    within RUN_TOL."""
    d = np.load(REFERENCE_BATCH)
    P = int(d["shape"][0])
    joins = port.staggered_joins(P, float(d["stagger_s"]), int(d["seed"]),
                                 device="cpu")
    np.testing.assert_array_equal(joins.numpy(), d["join_s"])
    rconfig = ref.SwarmConfig(*sg.build_config(P, int(d["shape"][1]), False,
                                               8))
    assert np.array_equal(
        np.asarray(ref_sweep.build_scenario(
            rconfig, sg.vod_grid()[0], watch_s=50.0,
            stagger_s=float(d["stagger_s"]), seed=int(d["seed"]))[1]),
        d["join_s"])
    fixture = dict(d)
    fixture["join_s"] = None
    offload, rebuffer, series, timeline = run_batch_fixture(fixture, "cpu")
    np.testing.assert_allclose(offload.numpy(), d["offload"], atol=RUN_TOL)
    np.testing.assert_allclose(rebuffer.numpy(), d["rebuffer"], atol=RUN_TOL)
    np.testing.assert_allclose(series.numpy(), d["series"], atol=RUN_TOL)


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_graphs_equal_the_eager_loop_on_the_card(cuda_device):
    """Replayed CUDA graphs against the eager loop of the same kernels:
    the same launches, and the same bits."""
    config, scen, _join = _lanes(P=4_096, S=64)
    scen = port.tree_map(lambda x: x.to(cuda_device), scen)
    a = port.init_swarm(config, device=cuda_device, batch=3)
    b = port.clone_state(a)
    sk.reset_launch_counts()
    ga = port._scan_swarm(config, scen, a, 90, 40)
    la = dict(sk.LAUNCHES)
    sk.reset_launch_counts()
    eb = port._scan_eager(config, scen, b, 90, 40)
    torch.cuda.synchronize()
    assert la == dict(sk.LAUNCHES) == {
        **{name: 0 for name in sk.LAUNCHES},
        "select_admit": 90, "peer_update": 90, "lane_sums": 1,
        "timeline_row": 2}
    assert _equal(ga[0], eb[0])
    for x, y in zip(ga[1:], eb[1:]):
        assert torch.equal(x, y)
    assert torch.equal(ga[1][:, -1], port.offload_ratio_batch(ga[0]))
