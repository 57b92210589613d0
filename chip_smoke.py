#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit: ``python3 chip_smoke.py``.  Phases, in order; any failure
exits nonzero:

1. the card and the toolchain (``nvidia-smi``, torch, CUDA, ``nvcc``);
2. build the kernels from ``hlsjs_p2p_wrapper_tpu_torch/csrc/`` and
   print each one's registers and spills;
3. each kernel against its plain PyTorch version on the card, at
   1,048,576 peers × 256 segments, from a state the plain path reached
   after 300 steps;
4. the routes of ``select_admit`` away from the main path: the fused
   kernel where its tiles wrap the ring (16 peers with the ring of 8,
   96 peers with a ring of 12, 1,000 peers with the ring of 8, whose
   last tile is partial) and the TK1 + TK2 route of a wide offset
   tuple, each stepped beside the plain step, launches checked; then,
   at the main path's size, the fused kernel at halos of 8, 16, 24 and
   32 peers (the widest it takes) against its plain version and timed
   against TK1 + TK2, which sets the route's span limit;
5. the main path — ``run_swarm`` at 262,144 peers × 256 segments ×
   2,400 steps, the configuration of ``bench.py``'s headline — through
   ``select_admit`` and ``peer_update``, with the launch counts checked;
   then, from its final state, each kernel against its plain version,
   the step timed with CUDA events and traced with ``torch.profiler``
   on the main path's route and on the TK1 + TK2 route, and the same
   run on the plain path;
6. the port at the committed reference fixture's shape and joins,
   against the JAX reference's final offload and rebuffer ratio.

The last line of standard output is one JSON object
``{"ok": true, "device": {...}}``; the line before it gives the card's
name and power limit, and the ``{"kernels": [...]}`` line the kernels'
launches and times.  Without a card, or outside a checkout, it exits
nonzero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "hlsjs_p2p_wrapper_tpu_torch"

#: the kernel-vs-plain check: the production sweep width (bench.py:753),
#: from a state the plain path reached after CHECK_WARM_STEPS steps
CHECK_PEERS = 1_048_576
CHECK_WARM_STEPS = 300
#: the main path: bench.py's accelerator headline (bench.py:169-188)
PEERS = 262_144
SEGMENTS = 256
STEPS = 2_400
#: steps in each timed window: a kernels' window of CUDA events must fit
#: in the launch queue while the card sleeps (~15 entries per step)
WINDOW = 40

#: H100 SXM device memory rate, bytes/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
BITRATES = (300_000.0, 800_000.0, 2_000_000.0)
DEGREE = 8

#: kernel vs plain on the card: integer, index and packed outputs must
#: be equal; a float output may differ by RTOL·|plain| + ATOL (a few
#: ulps: powf in the kernel and torch.pow may round the EWMA apart)
RTOL, ATOL = 1e-6, 1e-6
#: final offload and rebuffer ratio, kernels vs plain path and port vs
#: the JAX fixture: the CPU whole-run test's tolerance
#: (tests/test_torch_swarm_sim.py RUN_TOL)
RUN_TOL = 1e-4

KERNELS = {
    "select_admit": "hlsjs_p2p_wrapper_tpu/ops/swarm_sim.py:681 + :1259",
    "elig_select": "hlsjs_p2p_wrapper_tpu/ops/swarm_sim.py:681",
    "admit_service": "hlsjs_p2p_wrapper_tpu/ops/swarm_sim.py:1259",
    "peer_update": "hlsjs_p2p_wrapper_tpu/ops/swarm_sim.py:1351",
}
#: the kernels the main path launches, once a step each; the other two
#: are the route of offset tuples too wide for select_admit's tile
MAIN_PATH = ("select_admit", "peer_update")
#: shapes where select_admit's tiles wrap the ring, (peers, ring
#: degree); at 1,000 peers the last tile is partial
WRAP_CASES = ((16, 8), (96, 12), (1000, 8))
#: an offset tuple too wide for select_admit's tile, and its shape
WIDE_OFFSETS = (1, -1, 2, -2, 97, -97, 300, -300)
WIDE_PEERS, WIDE_SEGMENTS = 65_536, 64
ROUTE_STEPS = 20
#: K = 8 offset tuples with halos (max(o, 0) - min(o, 0)) of 8 (the main
#: path's ring), 16, 24 and 32 peers, at which the fused kernel is timed
#: against TK1 + TK2 at the main path's size, each from the state its
#: own STEPS-step run reached
SPAN_OFFSETS = ((1, 2, 3, 4, -1, -2, -3, -4),
                (1, 2, 3, 8, -1, -2, -3, -8),
                (1, 2, 3, 12, -1, -2, -3, -12),
                (1, 2, 3, 16, -1, -2, -3, -16))
#: launches back to back per timing of one route
BACK_TO_BACK = 200
#: steps per host-clock run of each route, run in turns fused, pair,
#: pair, fused
HOST_STEPS = 400
SOURCE = f"{PACKAGE}/csrc/swarm_step.cu"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg=""):
    print(msg, flush=True)


def run_cmd(cmd, timeout=120):
    out = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout)
    check(out.returncode == 0, f"{cmd[0]} failed: {out.stderr.strip()}")
    return out.stdout.strip()


# ---- comparisons ----------------------------------------------------------

def _pairs(named_a, named_b):
    for name in named_a:
        a, b = named_a[name], named_b[name]
        if isinstance(a, tuple):   # the nested EWMA state
            for f, x, y in zip(a._fields, a, b):
                yield f"ewma.{f}", x, y
        else:
            yield name, a, b


def compare(what, named_a, named_b):
    """Kernel outputs ``named_a`` against plain outputs ``named_b``:
    returns the largest float difference; raises on any integer
    mismatch or a float outside RTOL/ATOL."""
    import torch
    worst = 0.0
    for name, a, b in _pairs(named_a, named_b):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{what}: {name} shape/dtype {a.shape}/{a.dtype} vs "
              f"{b.shape}/{b.dtype}")
        if not a.is_floating_point():
            bad = int((a != b).sum())
            check(bad == 0, f"{what}: {name} differs at {bad} entries")
            continue
        check(bool(torch.isfinite(a).all()), f"{what}: {name} not finite")
        diff = (a.double() - b.double()).abs()
        limit = RTOL * b.double().abs() + ATOL
        bad = int((diff > limit).sum())
        err = float(diff.max()) if diff.numel() else 0.0
        check(bad == 0, f"{what}: {name} outside tolerance at {bad} "
                        f"entries (max abs err {err!r})")
        worst = max(worst, err)
    return worst


SELECT_OUT = ("slot_flags", "req", "service", "adm")


def compare_select_admit(sim, sk, config, scenario, state, label):
    """``select_admit`` against ``select_admit_plain`` on the same
    inputs, outputs and the state it writes; returns the max float
    error."""
    import torch
    a, b = sim.clone_state(state), sim.clone_state(state)
    out_k = sk.select_admit(config, scenario, a)
    out_p = sk.select_admit_plain(config, scenario, b)
    torch.cuda.synchronize()
    return compare(f"{label} select_admit",
                   {**dict(zip(SELECT_OUT, out_k)), **a._asdict()},
                   {**dict(zip(SELECT_OUT, out_p)), **b._asdict()})


def compare_kernels(sim, sk, config, scenario, state, label):
    """One step's kernels against their plain versions on the same
    inputs: ``select_admit`` (on its fused route), then TK1, TK2 and TK3
    called directly; returns ``{kernel: max abs float error}``."""
    import torch
    check(sk.fused_route(config), f"{label}: not on the fused route")
    errs = {"select_admit": compare_select_admit(sim, sk, config, scenario,
                                                 state, label)}
    errs.update(compare_kernels_pair(sim, sk, config, scenario, state,
                                     label))
    b = sim.clone_state(state)
    fp, rp, sv_p, adm_p = sk.select_admit_plain(config, scenario, b)
    c, d = sim.clone_state(b), sim.clone_state(b)
    sk.peer_update(config, scenario, c, fp, rp, sv_p, adm_p)
    sk.peer_update_plain(config, scenario, d, fp, rp, sv_p, adm_p)
    torch.cuda.synchronize()
    errs["peer_update"] = compare(f"{label} peer_update", c._asdict(),
                                  d._asdict())
    n_active = int((b.dl_flags & 1).sum())
    log(f"  {label}: all four kernels agree with their plain versions "
        f"({n_active} transfers in flight); max float err "
        f"{json.dumps(errs)}")
    return errs


def compare_kernels_pair(sim, sk, config, scenario, state, label):
    """TK1 then TK2, called directly, against their plain versions (TK2
    on the plain TK1's req)."""
    import torch
    a, b = sim.clone_state(state), sim.clone_state(state)
    fk, rk = sk.elig_select(config, scenario, a)
    fp, rp = sk.elig_select_plain(config, scenario, b)
    sv_k, adm_k = sk.admit_service(config, scenario, rp)
    sv_p, adm_p = sk.admit_service_plain(config, scenario, rp)
    torch.cuda.synchronize()
    return {"elig_select": compare(
                f"{label} elig_select",
                {"slot_flags": fk, "req": rk, **a._asdict()},
                {"slot_flags": fp, "req": rp, **b._asdict()}),
            "admit_service": compare(
                f"{label} admit_service", {"service": sv_k, "adm": adm_k},
                {"service": sv_p, "adm": adm_p})}


# ---- the phases -----------------------------------------------------------

def phase_card():
    import torch
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"])
    log(f"[1] card: {smi}")
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    from hlsjs_p2p_wrapper_tpu_torch.ops import _build
    nvcc = run_cmd([_build.nvcc_path(), "--version"]).splitlines()
    log(f"    nvcc: {nvcc[-1] if nvcc else '?'}")
    return smi.splitlines()[0]


def phase_build():
    from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_kernels as sk
    t0 = time.perf_counter()
    info = sk.build_kernels(force=True)
    log(f"[2] built {len(info)} source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for src, rec in info.items():
        for line in rec["ptxas"]:
            log(f"    {src}: {line.strip()}")


def make_case(sim, sk, P, S, n_steps_plain, device, offsets=None,
              window_s=60.0):
    """A config and scenario at P × S (the ring of DEGREE unless
    ``offsets``), joins spread over ``window_s``, and a state the plain
    path reached after ``n_steps_plain`` steps."""
    import numpy as np
    config = sim.SwarmConfig(
        n_peers=P, n_segments=S, n_levels=3,
        neighbor_offsets=offsets or sim.ring_offsets(DEGREE))
    join = sim.staggered_joins(P, window_s, device=device)
    scenario = sim.make_scenario(config, BITRATES, None,
                                 np.full((P,), 8e6, np.float32), join,
                                 device=device)
    state = sim.init_swarm(config, device=device)
    for _ in range(n_steps_plain):
        state = sk.plain_step(config, scenario, state)
    return config, scenario, state


def phase_kernels_vs_plain(sim, sk, P, S, warm_steps):
    import torch
    t0 = time.perf_counter()
    config, scenario, state = make_case(sim, sk, P, S, warm_steps, "cuda")
    torch.cuda.synchronize()
    log(f"[3] {P:,} peers x {S} segments: plain path warmed "
        f"{warm_steps} steps in {time.perf_counter() - t0:.2f} s")
    check(int((state.dl_flags & 1).sum()) > 0, "no transfer in flight")
    check(int((state.avail != 0).sum()) > 0, "cache maps are empty")
    return compare_kernels(sim, sk, config, scenario, state,
                           f"{P:,} peers")


def phase_routes(sim, sk):
    """select_admit's fused kernel where its tiles wrap the ring, and
    the TK1 + TK2 route of a wide offset tuple: each stepped
    ROUTE_STEPS times through ``swarm_step`` beside ``plain_step``, the
    launches of each kernel counted.  Returns the max float error of
    select_admit, TK1 and TK2."""
    errs = {"select_admit": 0.0, "elig_select": 0.0, "admit_service": 0.0}
    cases = [(P, sim.ring_offsets(d), 16, 20.0, 80) for P, d in WRAP_CASES]
    cases.append((WIDE_PEERS, WIDE_OFFSETS, WIDE_SEGMENTS, 10.0, 60))
    for P, offsets, S, window_s, warm in cases:
        config, scenario, state = make_case(sim, sk, P, S, warm, "cuda",
                                            offsets, window_s)
        fused = sk.fused_route(config)
        label = f"{P:,} peers, offsets {offsets}"
        check(fused is (offsets != WIDE_OFFSETS),
              f"{label}: fused route {fused}")
        check(int((state.dl_flags & 1).sum()) > 0,
              f"{label}: no transfer in flight")
        sk.reset_launch_counts()
        if fused:
            errs["select_admit"] = max(errs["select_admit"],
                                       compare_select_admit(
                                           sim, sk, config, scenario,
                                           state, label))
        else:
            e = compare_kernels_pair(sim, sk, config, scenario, state, label)
            for name in e:
                errs[name] = max(errs[name], e[name])
        direct = dict(sk.LAUNCHES)
        a, b = sim.clone_state(state), sim.clone_state(state)
        sk.reset_launch_counts()
        placed = 0
        for _ in range(ROUTE_STEPS):
            placed += int((sk.select_admit_plain(
                config, scenario, sim.clone_state(b))[1] >= 0).sum())
            a = sim.swarm_step(config, scenario, a)
            b = sk.plain_step(config, scenario, b)
        launches = dict(sk.LAUNCHES)
        n = ROUTE_STEPS
        want = ({"select_admit": n, "elig_select": 0, "admit_service": 0,
                 "peer_update": n} if fused else
                {"select_admit": 0, "elig_select": n, "admit_service": n,
                 "peer_update": n})
        check(launches == want, f"{label}: launches {launches}, not {want}")
        check(placed > 0, f"{label}: no transfer placed demand")
        err = compare(f"{label} {n} steps", a._asdict(), b._asdict())
        log(f"[4] {label}: {'fused' if fused else 'TK1 + TK2'} route; "
            f"one call equals its plain version (launches {direct}); "
            f"{n} steps equal the plain step (launches {launches}, "
            f"{placed} demands placed; max float err {err!r})")
    return errs


def back_to_back(fn, state):
    """Mean device ms per call of ``fn(state)`` over BACK_TO_BACK calls
    on ``state``, queued behind a GPU sleep and bracketed by two CUDA
    events.  The selection writes only slot fields it does not read
    back, so every call repeats the same work."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    torch.cuda.synchronize()
    torch.cuda._sleep(int(3e8))
    slept = torch.cuda.Event()
    slept.record()
    start.record()
    for _ in range(BACK_TO_BACK):
        fn(state)
    end.record()
    queued_ahead = not slept.query()
    torch.cuda.synchronize()
    check(queued_ahead, "back-to-back launches not queued ahead")
    return start.elapsed_time(end) / BACK_TO_BACK


def phase_spans(sim, sk, P, S, T):
    """The fused kernel at each halo of SPAN_OFFSETS, at P × S from the
    final state of a T-step ``run_swarm``: against its plain version,
    then timed against TK1 + TK2 on the same state (routes in turns
    fused, pair, pair, fused).  Returns the max float error."""
    import numpy as np
    err = 0.0
    for offsets in SPAN_OFFSETS:
        config = sim.SwarmConfig(n_peers=P, n_segments=S, n_levels=3,
                                 neighbor_offsets=offsets)
        g = sk.geometry(config)
        span = g.o_hi - g.o_lo
        label = f"{P:,} peers, halo {span}, offsets {offsets}"
        check(sk.fused_route(config), f"{label}: not on the fused route")
        cdn = np.full((P,), 8e6, np.float32)
        join = sim.staggered_joins(P, 60.0, device="cuda")
        final, _series = sim.run_swarm(config, BITRATES, None, cdn,
                                       sim.init_swarm(config, device="cuda"),
                                       T, join, device="cuda")
        scenario = sim.make_scenario(config, BITRATES, None, cdn, join,
                                     device="cuda")
        err = max(err, compare_select_admit(sim, sk, config, scenario,
                                            final, label))

        def pair(st):
            flags, req = sk.elig_select(config, scenario, st)
            return sk.admit_service(config, scenario, req)
        fused = lambda st: sk.select_admit(config, scenario, st)  # noqa: E731
        st = sim.clone_state(final)
        runs = {"fused": [], "pair": []}
        for route in ("fused", "pair", "pair", "fused"):
            runs[route].append(back_to_back(
                fused if route == "fused" else pair, st))
        log(f"[4] {label}: select_admit equals its plain version; "
            f"{BACK_TO_BACK} launches back to back, mean ms per launch: "
            f"select_admit {runs['fused']}, TK1 + TK2 {runs['pair']}; "
            f"fused / pair {sum(runs['fused']) / sum(runs['pair'])!r}")
    return err


def _ratios(sim, state, n_steps, dt_s, join):
    return (float(sim.offload_ratio(state)),
            float(sim.rebuffer_ratio(state, n_steps * dt_s, join)))


def _stages(sk, config, scenario, route):
    """The passes of one step on ``route`` as ``[(kernel, fn)]``, each
    ``fn(state, outputs so far) -> outputs``: ``"fused"`` is the main
    path (select_admit, TK3), ``"pair"`` TK1, TK2 and TK3 called
    directly, ``"plain"`` and ``"plain_pair"`` the plain versions of
    the one and the other."""
    if route in ("fused", "plain"):
        sa = sk.select_admit if route == "fused" else sk.select_admit_plain
        first = [("select_admit",
                  lambda st, o: sa(config, scenario, st))]
    else:
        es, ad = ((sk.elig_select, sk.admit_service) if route == "pair"
                  else (sk.elig_select_plain, sk.admit_service_plain))
        first = [("elig_select", lambda st, o: es(config, scenario, st)),
                 ("admit_service",
                  lambda st, o: o + ad(config, scenario, o[1]))]
    pu = (sk.peer_update_plain if route.startswith("plain")
          else sk.peer_update)
    return first + [("peer_update",
                     lambda st, o: pu(config, scenario, st, *o))]


def time_window(sim, sk, config, scenario, state0, n_steps, route):
    """Device time over ``n_steps`` consecutive steps from ``state0`` (a
    clone is stepped) on ``route`` (see :func:`_stages`), each step as
    ``_scan_swarm`` runs it: the passes, the clock add and the
    offload-series write.  CUDA events bracket each pass and the step's
    tail.  A GPU sleep ahead of the window lets the host queue the
    launches, so the events time the device, not the host.  A kernels'
    window fails if the host did not stay ahead.  The plain passes
    launch hundreds of small ops a step, more than the launch queue
    holds, so their times are the passes as the host drives them,
    launch gaps included.  Returns ``({kernel: mean ms per pass}, mean
    ms per whole step)``."""
    import torch
    stages = _stages(sk, config, scenario, route)
    st = sim.clone_state(state0)
    series = torch.empty((n_steps,), dtype=torch.float32, device="cuda")
    ev = [[torch.cuda.Event(enable_timing=True)
           for _ in range(len(stages) + 2)] for _ in range(n_steps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(3e8))
    slept = torch.cuda.Event()
    slept.record()
    for s in range(n_steps):
        e = ev[s]
        e[0].record()
        out = ()
        for n, (_name, fn) in enumerate(stages):
            out = fn(st, out)
            e[n + 1].record()
        st = st._replace(t_s=st.t_s + config.dt_ms / 1000.0)
        series[s] = sim.offload_ratio(st)
        e[-1].record()
    queued_ahead = not slept.query()
    torch.cuda.synchronize()
    check(route.startswith("plain") or queued_ahead,
          f"timing window: the host did not queue {n_steps} steps within "
          f"the GPU sleep, so the events would time the host")
    per_pass = {name: sum(ev[s][n].elapsed_time(ev[s][n + 1])
                          for s in range(n_steps)) / n_steps
                for n, (name, _fn) in enumerate(stages)}
    return per_pass, ev[0][0].elapsed_time(ev[-1][-1]) / n_steps


def host_wall(sim, sk, config, scenario, state0, n_steps, route):
    """Host wall per step (ms) of ``n_steps`` steps on ``route`` from a
    clone of ``state0``, stepped as ``_scan_swarm`` steps (passes, clock
    add, offload-series write), ending in a synchronize."""
    import torch
    stages = _stages(sk, config, scenario, route)
    st = sim.clone_state(state0)
    series = torch.empty((n_steps,), dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(n_steps):
        out = ()
        for _name, fn in stages:
            out = fn(st, out)
        st = st._replace(t_s=st.t_s + config.dt_ms / 1000.0)
        series[s] = sim.offload_ratio(st)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n_steps * 1e3


def trace_steps(sim, sk, config, scenario, state0, n_steps, route):
    """``n_steps`` steps under ``torch.profiler`` (CUPTI): the main
    path's loop (``_scan_swarm``) for ``route == "fused"``, else the
    same loop over the passes of :func:`_stages`.  Returns ``(device
    busy ms per step, {kernel: (launches, mean ms)})`` over the kernels
    of :data:`KERNELS` that the trace holds; the busy time is None where
    the trace holds no device op."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    stages = _stages(sk, config, scenario, route)
    st = sim.clone_state(state0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if route == "fused":
            sim._scan_swarm(config, scenario, st, n_steps)
        else:
            series = torch.empty((n_steps,), dtype=torch.float32,
                                 device="cuda")
            for s in range(n_steps):
                out = ()
                for _name, fn in stages:
                    out = fn(st, out)
                st = st._replace(t_s=st.t_s + config.dt_ms / 1000.0)
                series[s] = sim.offload_ratio(st)
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in ops)
    per_kernel = {}
    for name in KERNELS:
        durs = [e.time_range.elapsed_us() for e in ops
                if f"{name}_kernel" in e.name]
        if durs:
            per_kernel[name] = (len(durs), sum(durs) / len(durs) / 1e3)
    return (busy_us / n_steps / 1e3 if ops else None), per_kernel


def kernel_bytes(sk, config, scenario, state_before, slot_flags, req, adm,
                 state_after):
    """Bytes each kernel must move for one step on these inputs: every
    input read once and every output written once, counting a
    data-dependent read or write only where this step's data needs it
    (the neighbours' map words that requesters ask for, the slot record
    of peers that start, the cache word and estimator of peers that
    complete).  A kernel's bound is these bytes over the card's memory
    rate."""
    import torch
    g = sk.geometry(config)
    P, K = g.P, len(g.offs)
    tg = sk.slot_targets(config, scenario, state_before)
    a0 = int(tg["a0"].sum())
    may = int(((slot_flags & 1) != 0).sum())
    # distinct (holder row, word) pairs that TK1's requesters read
    peer = torch.arange(P, device=req.device)
    wi = (tg["gi_flat"] >> 5).to(torch.int64)
    keys = torch.stack([((peer + o) % P) * g.W + wi for o in g.offs_mod])
    words = int(torch.unique(keys).numel()) if K else 0
    tk1 = (4 * 13 * P          # 13 per-peer arrays read by every thread
           + 4 * 3 * a0        # dl_seg, dl_level, dl_holder_off (active)
           + 4 * words         # neighbours' wanted map words
           + 4 * (g.L + 5)     # ladder, t_s, four policy scalars
           + 4 * 2 * P         # slot_flags, req
           + 4 * (P - a0)      # dl_holder_off of idle slots
           + 4 * 7 * may)      # the slot record of starts
    tk2 = 4 * 4 * P + 4        # req, uplink in; service, adm out; eff
    placed = int((req >= 0).sum())
    # slot 0 only turns inactive by completing
    completed = int(((slot_flags & 2) != 0).sum()
                    - ((state_after.dl_flags & 1) != 0).sum())
    tk3 = (4 * 5 * P           # join, leave, cdn_bps, slot_flags, req
           + 4 * 2 * placed    # adm word and service of the holder
           + 4 * 10 * P        # 10 state arrays read
           + 4 * 9 * P         # 9 state arrays written
           + 4 * 2             # t_s, p2p_setup_ms
           + (8 + 8 + 32) * completed)  # seg/level, map word, EWMA
    # select_admit: TK1's traffic plus uplink in, service and adm out,
    # the efficiency scalar (req stays in shared memory)
    fused = tk1 + 4 * 3 * P + 4
    return {"select_admit": float(fused), "elig_select": float(tk1),
            "admit_service": float(tk2), "peer_update": float(tk3)}


def window_bytes(sim, sk, config, scenario, state0, n_steps):
    """Mean bytes each kernel must move over the same window as
    :func:`time_window` (the kernels are deterministic, and both routes
    give the same outputs, so a pass over a clone repeats the work)."""
    st = sim.clone_state(state0)
    total = {name: 0.0 for name in KERNELS}
    for _ in range(n_steps):
        before = sim.clone_state(st)
        flags, req, service, adm = sk.select_admit(config, scenario, st)
        sk.peer_update(config, scenario, st, flags, req, service, adm)
        for name, b in kernel_bytes(sk, config, scenario, before, flags,
                                    req, adm, st).items():
            total[name] += b
        st = st._replace(t_s=st.t_s + config.dt_ms / 1000.0)
    return {name: b / n_steps for name, b in total.items()}


def phase_main(sim, sk, P, S, T, window):
    import numpy as np
    import torch
    config = sim.SwarmConfig(n_peers=P, n_segments=S, n_levels=3,
                             neighbor_offsets=sim.ring_offsets(DEGREE))
    cdn = np.full((P,), 8e6, np.float32)
    join = sim.staggered_joins(P, 60.0, device="cuda")
    state0 = sim.init_swarm(config, device="cuda")
    dt_s = config.dt_ms / 1000.0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    final, series = sim.run_swarm(config, BITRATES, None, cdn, state0, T,
                                  join, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"[5] main path {P:,} peers x {S} segments x {T} steps through "
        f"the kernels: {wall:.3f} s, {P * T / wall:,.0f} peer-steps/s; "
        f"launches {json.dumps(launches)}; peak memory {peak:,} B")
    for name in KERNELS:
        want = T if name in MAIN_PATH else 0
        check(launches[name] == want, f"{name} launched {launches[name]} "
                                      f"times on the main path, not {want}")
    check(tuple(series.shape) == (T,), f"series shape {series.shape}")
    check(bool(torch.isfinite(series).all()), "offload series not finite")
    for name, t in final._asdict().items():
        ts = t if not isinstance(t, tuple) else torch.stack(list(t))
        if ts.is_floating_point():
            check(bool(torch.isfinite(ts).all()), f"final {name} "
                                                  f"not finite")
    offload, rebuffer = _ratios(sim, final, T, dt_s, join)
    check(0.0 <= offload <= 1.0 and 0.0 <= rebuffer <= 1.0,
          f"ratios out of range: {offload!r} {rebuffer!r}")
    log(f"    final offload {offload!r}, rebuffer ratio {rebuffer!r}")

    scenario = sim.make_scenario(config, BITRATES, None, cdn, join,
                                 device="cuda")
    errs = compare_kernels(sim, sk, config, scenario, final,
                           f"{P:,} peers")
    # both routes from the same final state, in turns
    fused_ms, fused_step_ms = time_window(sim, sk, config, scenario, final,
                                          window, "fused")
    pair_ms, pair_step_ms = time_window(sim, sk, config, scenario, final,
                                        window, "pair")
    plain_ms, plain_step_ms = time_window(sim, sk, config, scenario, final,
                                          max(window // 5, 5), "plain")
    plain_pair_ms, _ = time_window(sim, sk, config, scenario, final,
                                   max(window // 5, 5), "plain_pair")
    ms = {**pair_ms, **fused_ms}
    plain_ms = {**plain_pair_ms, **plain_ms}
    nbytes = window_bytes(sim, sk, config, scenario, final, window)
    busy_ms, traced = trace_steps(sim, sk, config, scenario, final, window,
                                  "fused")
    pair_busy_ms, pair_traced = trace_steps(sim, sk, config, scenario,
                                            final, window, "pair")
    walls = {"fused": [], "pair": []}
    for route in ("fused", "pair", "pair", "fused"):
        walls[route].append(host_wall(sim, sk, config, scenario, final,
                                      HOST_STEPS, route))

    # the same run on the plain path, stepped as _scan_swarm steps
    st = sim.clone_state(state0)
    series_p = torch.empty((T,), dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(T):
        st = sk.plain_step(config, scenario, st)
        series_p[s] = sim.offload_ratio(st)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    offload_p, rebuffer_p = _ratios(sim, st, T, dt_s, join)
    log(f"    plain path on the card: {wall_p:.3f} s "
        f"({P * T / wall_p:,.0f} peer-steps/s) vs kernels {wall:.3f} s; "
        f"offload {offload_p!r}, rebuffer ratio {rebuffer_p!r}")
    check(abs(offload_p - offload) <= RUN_TOL
          and abs(rebuffer_p - rebuffer) <= RUN_TOL,
          "kernels and plain path disagree on the main path's ratios")
    host_ms = wall / T * 1e3
    log(f"    device time per whole step ({window}-step windows queued "
        f"ahead, CUDA events; kernels, clock add, offload-series write): "
        f"main path {fused_step_ms!r} ms (select_admit + peer_update "
        f"{sum(fused_ms.values())!r} ms), TK1 + TK2 + TK3 route "
        f"{pair_step_ms!r} ms (kernels {sum(pair_ms.values())!r} ms); "
        f"plain passes {plain_step_ms!r} ms; host wall per step on the "
        f"main path {host_ms!r} ms")
    log(f"    host wall per step over {HOST_STEPS} steps from the final "
        f"state, routes in turns (ms): select_admit + peer_update "
        f"{walls['fused']}, TK1 + TK2 + TK3 {walls['pair']}")
    log(f"    per pass, CUDA events (ms): main path {json.dumps(fused_ms)}; "
        f"TK1 + TK2 + TK3 {json.dumps(pair_ms)}; plain versions "
        f"{json.dumps(plain_ms)}")
    if busy_ms is None or pair_busy_ms is None:
        log("    trace: torch.profiler recorded no device op; device busy "
            "time and idle share not measured")
    else:
        log(f"    trace ({window} steps each, torch.profiler): main path "
            f"device busy {busy_ms!r} ms per step, i.e. idle "
            f"{1.0 - busy_ms / host_ms!r} of the main path's host wall "
            f"per step; per kernel (launches, mean ms) "
            f"{json.dumps(traced)}.  TK1 + TK2 + TK3 route: busy "
            f"{pair_busy_ms!r} ms per step; per kernel "
            f"{json.dumps(pair_traced)}")
    traced_ms = {**{k: v[1] for k, v in pair_traced.items()},
                 **{k: v[1] for k, v in traced.items()}}
    return launches, errs, ms, traced_ms, plain_ms, nbytes


def phase_fixture(sim):
    import numpy as np
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.testing import REFERENCE_RUN
    d = np.load(REFERENCE_RUN)
    P, S, L, K, T = (int(x) for x in d["shape"])
    config = sim.SwarmConfig(n_peers=P, n_segments=S, n_levels=L,
                             neighbor_offsets=sim.ring_offsets(K))
    final, _ = sim.run_swarm(
        config, d["bitrates"], None,
        np.full((P,), float(d["cdn_bps"]), np.float32),
        sim.init_swarm(config, device="cuda"), T, d["join_s"],
        device="cuda")
    torch.cuda.synchronize()
    offload, rebuffer = _ratios(sim, final, T, config.dt_ms / 1000.0,
                                d["join_s"])
    ref_o, ref_r = float(d["offload"]), float(d["rebuffer"])
    log(f"[6] fixture {P} x {S} x {T}: offload {offload!r} (JAX "
        f"{ref_o!r}), rebuffer ratio {rebuffer!r} (JAX {ref_r!r})")
    check(abs(offload - ref_o) <= RUN_TOL and abs(rebuffer - ref_r)
          <= RUN_TOL, "the port disagrees with the JAX fixture")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        print(f"chip_smoke: {PACKAGE}/ not found beside this script; run "
              f"it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from hlsjs_p2p_wrapper_tpu_torch.ops import (swarm_kernels as sk,
                                                 swarm_sim as sim)
    try:
        smi = phase_card()
        phase_build()
        errs_1m = phase_kernels_vs_plain(sim, sk, CHECK_PEERS, SEGMENTS,
                                         CHECK_WARM_STEPS)
        errs_routes = phase_routes(sim, sk)
        errs_routes["select_admit"] = max(
            errs_routes["select_admit"],
            phase_spans(sim, sk, PEERS, SEGMENTS, STEPS))
        launches, errs, ms, traced_ms, plain_ms, nbytes = phase_main(
            sim, sk, PEERS, SEGMENTS, STEPS, WINDOW)
        phase_fixture(sim)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    kernels = []
    for name, replaces in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs[name], errs_1m[name],
                               errs_routes.get(name, 0.0)),
            "ms": ms[name], "traced_ms": traced_ms.get(name),
            "plain_ms": plain_ms[name],
            "bound_ms": nbytes[name] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "bytes": nbytes[name],
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
