"""The port's CUDA kernels (ops/swarm_kernels.py, csrc/swarm_step.cu).

On the CPU: the ctypes mirrors of the kernels' argument structs against
the C source (field for field, since nothing compiles the source here),
the wrappers' dispatch to the plain versions, and the byte counts
``chip_smoke.py`` computes the kernels' bounds from.  On the card
(marker ``gpu``, skipped without one): each kernel against its plain
version."""

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
           "int": ctypes.c_int, "float": ctypes.c_float}


def _c_struct(name):
    with open(os.path.join(_build.CSRC_DIR, sk.SOURCE)) as fh:
        src = fh.read()
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
    ("UpdateArgs", sk._UpdateArgs)])
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
    with open(os.path.join(_build.CSRC_DIR, sk.SOURCE)) as fh:
        src = fh.read()
    assert "torch/" not in src and "ATen" not in src
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert _build.BUILD_DIR.endswith(os.path.join("build", "torch_kernels"))


def _case(P=64, S=16, steps=60):
    """A small swarm mid-run: staggered joins over 20 s, so that some
    transfers ride peers (and place demand) 15 s in."""
    config = port.SwarmConfig(n_peers=P, n_segments=S, n_levels=3,
                              neighbor_offsets=port.ring_offsets(8))
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


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_on_the_card(cuda_device):
    P, S = 4096, 64
    config = port.SwarmConfig(n_peers=P, n_segments=S, n_levels=3,
                              neighbor_offsets=port.ring_offsets(8))
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
    assert sk.LAUNCHES == {name: 20 for name in sk.LAUNCHES}
    for x, y in zip(a, b):
        for u, v in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            if u.is_floating_point():
                torch.testing.assert_close(u, v, rtol=1e-6, atol=1e-6)
            else:
                assert torch.equal(u, v)
