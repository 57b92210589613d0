"""Slice 1 of the PyTorch port (the circulant VOD swarm step) against
the JAX reference, on the CPU: the data model, the eligibility
formulations against the NumPy oracle, one step from a shared mid-run
state, a whole run, the device policy and the slice's limits.

Inputs are made from seeds with numpy and handed to both sides.  The
reference's ``staggered_joins`` draws from ``jax.random``, which
PyTorch cannot reproduce, so the reference's join array is passed to
both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hlsjs_p2p_wrapper_tpu.ops import swarm_sim as ref
from hlsjs_p2p_wrapper_tpu.testing import kpass_eligibility
from hlsjs_p2p_wrapper_tpu_torch.ops import ewma as port_ewma
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_kernels as sk
from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as port
from hlsjs_p2p_wrapper_tpu_torch.testing.convert import (
    scenario_from_numpy, state_from_numpy, state_to_numpy)

BITRATES = [300_000.0, 800_000.0, 2_000_000.0]

#: whole-run final offload and rebuffer ratio, port vs reference.
#: Integer trajectories agree exactly; the ratios are float32 sums over
#: peers taken in another order (measured difference at 256 × 64 × 100:
#: 0 for offload, 0 for rebuffer at 8 Mb/s and ≤ 1e-8 at 2.5 Mb/s).
#: The slack covers an EWMA ulp (``pow``) flipping one late decision.
RUN_TOL = 1e-4
#: one step, EWMA fields: ``pow`` may round the last ulp apart
#: between XLA and PyTorch
EWMA_RTOL = 1e-6
#: one step, the other float fields: XLA's CPU backend may contract a
#: multiply and an add into one FMA (tests/test_torch_ewma.py shows it
#: on the EWMA weight), which the port rounds apart.  Measured at both
#: shapes below: equal.
FLOAT_RTOL = 1e-6

INT_FIELDS = ("level", "avail", "dl_flags", "dl_seg", "dl_level",
              "dl_holder_off", "dl_attempts")


def _tree_np(tree):
    out = {}
    for k, v in tree._asdict().items():
        out[k] = ({f: np.asarray(x) for f, x in v._asdict().items()}
                  if hasattr(v, "_asdict") else np.asarray(v))
    return out


def _configs(P, S):
    r = ref.SwarmConfig(n_peers=P, n_segments=S, n_levels=3,
                        neighbor_offsets=ref.ring_offsets(8))
    return r, port.SwarmConfig(*r)


# ---- the data model ---------------------------------------------------------

def test_config_fields_and_defaults_match_reference():
    assert port.SwarmConfig._fields == ref.SwarmConfig._fields
    assert port.SwarmConfig._field_defaults == ref.SwarmConfig._field_defaults


@pytest.mark.parametrize("name", ["SwarmState", "SwarmScenario"])
def test_tuple_fields_match_reference(name):
    assert getattr(port, name)._fields == getattr(ref, name)._fields


def test_constants_match_reference():
    assert port.NEVER_S == ref.NEVER_S
    assert port.UNREACHABLE_BITRATE == ref.UNREACHABLE_BITRATE
    assert port.BANDWIDTH_SAFETY == ref.BANDWIDTH_SAFETY


def test_init_swarm_shapes_match_reference():
    cr, cp = _configs(40, 50)
    r = _tree_np(ref.init_swarm(cr))
    p = state_to_numpy(port.init_swarm(cp, device="cpu"))
    for k, v in r.items():
        if k == "ewma":
            for f in v:
                assert p[k][f].shape == v[f].shape
            continue
        assert p[k].shape == v.shape, k
        assert p[k].dtype == v.dtype, k
    assert port.packed_words(cp) == ref.packed_words(cr)


def test_dl_flags_pack_roundtrip_all_16_slots():
    rng = np.random.default_rng(7)
    act = rng.random((16, 64)) < 0.5
    p2p = rng.random((16, 64)) < 0.5
    want = np.asarray(ref.pack_dl_flags([jnp.asarray(a) for a in act],
                                        [jnp.asarray(b) for b in p2p]))
    got = port.pack_dl_flags([torch.from_numpy(a) for a in act],
                             [torch.from_numpy(b) for b in p2p])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    a_out, p_out = port.unpack_dl_flags(got, 16)
    for c in range(16):
        np.testing.assert_array_equal(a_out[c].numpy(), act[c])
        np.testing.assert_array_equal(p_out[c].numpy(), p2p[c])


def test_unpack_avail_and_bit_mask_match_reference():
    cr, cp = _configs(24, 45)   # W = 5, bit 31 of every word in range
    rng = np.random.default_rng(3)
    W = port.packed_words(cp)
    words = rng.integers(0, 2 ** 32, (24, W), dtype=np.uint64).astype(
        np.uint32)
    st_r = ref.init_swarm(cr)._replace(avail=jnp.asarray(words))
    st_p = port.init_swarm(cp, device="cpu")._replace(
        avail=torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(port.unpack_avail(st_p, cp).numpy(),
                                  np.asarray(ref.unpack_avail(st_r, cr)))
    gi = rng.integers(0, 3 * 45, 24).astype(np.int32)
    gi[:3] = [31, 63, 127]
    np.testing.assert_array_equal(
        port.bit_mask_words(torch.from_numpy(gi), W).numpy().view(
            np.uint32),
        np.asarray(ref.bit_mask_words(jnp.asarray(gi), W)))


def test_convert_keeps_u32_bit_patterns():
    cr, _ = _configs(16, 64)
    fields = _tree_np(ref.init_swarm(cr))
    fields["avail"] = np.full(fields["avail"].shape, 0xFFFFFFFF,
                              np.uint32)
    fields["dl_flags"] = np.full((16,), 0x80000003, np.uint32)
    back = state_to_numpy(state_from_numpy(fields, "cpu"))
    np.testing.assert_array_equal(back["avail"], fields["avail"])
    np.testing.assert_array_equal(back["dl_flags"], fields["dl_flags"])
    assert back["t_s"].shape == ()


# ---- eligibility against the NumPy oracle -------------------------------

def _random_map(rng, P, n_bits, density=0.4):
    W = -(-n_bits // 32)
    cells = rng.random((P, n_bits)) < density
    packed = np.zeros((P, W), np.uint32)
    for b in range(n_bits):
        packed[:, b // 32] |= (cells[:, b].astype(np.uint32)
                               << np.uint32(b % 32))
    return packed


@pytest.mark.parametrize("impl", ["stencil", "kpass"])
@pytest.mark.parametrize("P,L,S,degree", [
    (64, 3, 40, 8),     # multi-word, shipped degree
    (48, 2, 50, 6),
    (32, 1, 20, 4),     # W=1: every bit in one word
    (16, 3, 11, 8),     # tiny P: offsets wrap + dedup (mod P)
    (96, 4, 64, 12),    # wide ladder, W=8, high degree
])
def test_eligibility_matches_oracle(P, L, S, degree, impl):
    """Both formulations reproduce ``testing/elig_oracle`` exactly, with
    word-boundary targets planted (the shapes of
    tests/test_eligibility_stencil.py, one slot)."""
    rng = np.random.default_rng(P * 1000 + S)
    n_bits = L * S
    offs = port._normalized_offsets(port.ring_offsets(degree), P)
    assert offs == ref._normalized_offsets(ref.ring_offsets(degree), P)
    avail = _random_map(rng, P, n_bits)
    present = rng.random(P) < 0.8
    gi = rng.integers(0, n_bits, size=P).astype(np.int32)
    planted = [b for b in (0, 31, 32, 63, n_bits - 1) if b < n_bits]
    gi[:len(planted)] = planted
    (elig, n, own), = port.circulant_eligibility(
        torch.from_numpy(avail.view(np.int32)), torch.from_numpy(present),
        offs, [torch.from_numpy(gi)], impl=impl)
    want_elig, want_n, want_own = kpass_eligibility(avail, present, offs, gi)
    assert len(elig) == len(want_elig)
    for k, (got, want) in enumerate(zip(elig, want_elig)):
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"offset {offs[k]}")
    np.testing.assert_array_equal(n.numpy(), want_n)
    np.testing.assert_array_equal(own.numpy(), want_own)


def test_resolve_eligibility_by_device():
    _, cp = _configs(16, 8)
    assert port.resolve_eligibility(cp, torch.device("cpu")) == "kpass"
    assert port.resolve_eligibility(cp, torch.device("cuda")) == "stencil"
    assert port.resolve_eligibility(
        cp._replace(eligibility="stencil"), torch.device("cpu")) == "stencil"
    with pytest.raises(ValueError):
        port.resolve_eligibility(cp._replace(eligibility="fast"))


def test_stencil_and_kpass_runs_bit_identical():
    _, cp = _configs(64, 16)
    join = np.linspace(0.0, 5.0, 64, dtype=np.float32)[::-1].copy()
    finals = [state_to_numpy(port.run_swarm(
        cp._replace(eligibility=e), BITRATES, None,
        np.full(64, 1.5e6, np.float32), port.init_swarm(cp, device="cpu"),
        30, join, device="cpu")[0]) for e in ("stencil", "kpass")]
    for k, v in finals[0].items():
        if k == "ewma":
            for f in v:
                np.testing.assert_array_equal(v[f], finals[1][k][f])
        else:
            np.testing.assert_array_equal(v, finals[1][k], err_msg=k)


# ---- one step from a shared mid-run state ----------------------------------

@pytest.mark.parametrize("P,S,window_s,cdn_bps", [
    (256, 64, 60.0, 8e6),   # bench.py's CPU shape (bench.py:189)
    (16, 11, 5.0, 1.5e6),   # W=2, offsets wrap mod P
])
def test_one_step_matches_reference(P, S, window_s, cdn_bps):
    cr, cp = _configs(P, S)
    join = ref.staggered_joins(P, window_s)
    cdn = jnp.full((P,), cdn_bps)
    st_r, _ = ref.run_swarm(cr, jnp.array(BITRATES), None, cdn,
                            ref.init_swarm(cr), 40, join)
    assert int(jnp.sum(st_r.dl_flags & 1)) > 0    # transfers in flight
    scen_r = ref.make_scenario(cr, jnp.array(BITRATES), None, cdn, join)
    want = _tree_np(jax.jit(ref.swarm_step, static_argnums=0)(
        cr, scen_r, st_r))
    got = state_to_numpy(port.swarm_step(
        cp, scenario_from_numpy(_tree_np(scen_r), "cpu"),
        state_from_numpy(_tree_np(st_r), "cpu")))
    for k, v in want.items():
        if k == "ewma":
            for f in v:
                np.testing.assert_allclose(got[k][f], v[f], rtol=EWMA_RTOL,
                                           err_msg=f"ewma.{f}")
            continue
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if k in INT_FIELDS:
            # integer, index and packed fields: bit-identical
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=FLOAT_RTOL,
                                       err_msg=k)


# ---- a whole run ------------------------------------------------------------

@pytest.mark.parametrize("cdn_bps", [8e6, 2.5e6])
def test_whole_run_matches_reference(cdn_bps):
    """256 × 64 × 100 steps with the reference's staggered joins: the
    final offload and rebuffer ratio within RUN_TOL."""
    P, S, T = 256, 64, 100
    cr, cp = _configs(P, S)
    join = ref.staggered_joins(P, 60.0)
    fr, series_r = ref.run_swarm(cr, jnp.array(BITRATES), None,
                                 jnp.full((P,), cdn_bps),
                                 ref.init_swarm(cr), T, join)
    join_np = np.asarray(join)
    fp, series_p = port.run_swarm(cp, BITRATES, None,
                                  np.full((P,), cdn_bps, np.float32),
                                  port.init_swarm(cp, device="cpu"), T,
                                  join_np, device="cpu")
    assert tuple(series_p.shape) == (T,)
    np.testing.assert_allclose(series_p.numpy(), np.asarray(series_r),
                               atol=RUN_TOL)
    elapsed = T * cp.dt_ms / 1000.0
    assert abs(float(port.offload_ratio(fp))
               - float(ref.offload_ratio(fr))) <= RUN_TOL
    assert abs(float(port.rebuffer_ratio(fp, elapsed, join_np))
               - float(ref.rebuffer_ratio(fr, elapsed, join))) <= RUN_TOL


def test_run_swarm_leaves_the_callers_state_alone():
    _, cp = _configs(32, 8)
    state = port.init_swarm(cp, device="cpu")
    port.run_swarm(cp, BITRATES, None, np.full(32, 8e6, np.float32), state,
                   5, device="cpu")
    assert float(state.t_s) == 0.0
    assert int(state.avail.abs().sum()) == 0


# ---- device policy -----------------------------------------------------------

def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cp = _configs(16, 8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port.run_swarm(cp, BITRATES, None, np.full(16, 8e6), None, 2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port.init_swarm(cp)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port.staggered_joins(16)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_ewma.init_state(16)
    fields = _tree_np(ref.init_swarm(ref.SwarmConfig(*cp)))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        state_from_numpy(fields, None)


def test_cpu_path_launches_no_kernel():
    _, cp = _configs(32, 8)
    sk.reset_launch_counts()
    final, series = port.run_swarm(
        cp, BITRATES, None, np.full(32, 8e6, np.float32),
        port.init_swarm(cp, device="cpu"), 8,
        port.staggered_joins(32, 1.0, device="cpu"), device="cpu")
    assert final.avail.device.type == "cpu"
    assert bool(torch.isfinite(series).all())
    assert sk.LAUNCHES == {name: 0 for name in sk.LAUNCHES}


def test_staggered_joins_is_a_seeded_permutation():
    a = port.staggered_joins(100, 60.0, seed=3, device="cpu")
    b = port.staggered_joins(100, 60.0, seed=3, device="cpu")
    assert torch.equal(a, b)
    np.testing.assert_allclose(np.sort(a.numpy()),
                               np.linspace(0.0, 60.0, 100), rtol=1e-6)


# ---- the slice's limits ------------------------------------------------------

@pytest.mark.parametrize("change,err", [
    ({"max_concurrency": 2}, NotImplementedError),
    ({"live": True}, NotImplementedError),
    ({"holder_selection": "adaptive"}, NotImplementedError),
    ({"holder_selection": "ranked"}, NotImplementedError),
    ({"max_total_serves": 0}, NotImplementedError),
    ({"neighbor_offsets": None}, NotImplementedError),
    ({"holder_selection": "nearest"}, ValueError),
    ({"eligibility": "fast"}, ValueError),
])
def test_outside_the_slice_raises(change, err):
    _, cp = _configs(16, 8)
    cfg = cp._replace(**change)
    with pytest.raises(err):
        port.check_slice(cfg)


def test_record_every_and_neighbors_raise():
    _, cp = _configs(16, 8)
    state = port.init_swarm(cp, device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        port.run_swarm(cp, BITRATES, None, np.full(16, 8e6), state, 2,
                       record_every=1, device="cpu")
    with pytest.raises(NotImplementedError, match="item 9a"):
        port.make_scenario(cp, BITRATES, np.zeros((16, 2), np.int32),
                           np.full(16, 8e6), device="cpu")
