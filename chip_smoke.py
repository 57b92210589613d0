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
4. the main path — ``run_swarm`` at 262,144 peers × 256 segments ×
   2,400 steps, the configuration of ``bench.py``'s headline — through
   the kernels, with the launch counts checked; then each kernel's time
   beside its bound and its plain version's time, the same check of
   each kernel against its plain version at these shapes, and the same
   run on the plain path;
5. the port at the committed reference fixture's shape and joins,
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
    "elig_select": "hlsjs_p2p_wrapper_tpu/ops/swarm_sim.py:681",
    "admit_service": "hlsjs_p2p_wrapper_tpu/ops/swarm_sim.py:1259",
    "peer_update": "hlsjs_p2p_wrapper_tpu/ops/swarm_sim.py:1351",
}
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


def compare_kernels(sim, sk, config, scenario, state, label):
    """One step's three kernels against their plain versions on the
    same inputs; returns ``{kernel: max abs float error}``."""
    import torch
    a, b = sim.clone_state(state), sim.clone_state(state)
    fk, rk = sk.elig_select(config, scenario, a)
    fp, rp = sk.elig_select_plain(config, scenario, b)
    torch.cuda.synchronize()
    errs = {"elig_select": compare(
        f"{label} elig_select",
        {"slot_flags": fk, "req": rk, **a._asdict()},
        {"slot_flags": fp, "req": rp, **b._asdict()})}
    sv_k, adm_k = sk.admit_service(config, scenario, rp)
    sv_p, adm_p = sk.admit_service_plain(config, scenario, rp)
    torch.cuda.synchronize()
    errs["admit_service"] = compare(f"{label} admit_service",
                                    {"service": sv_k, "adm": adm_k},
                                    {"service": sv_p, "adm": adm_p})
    c, d = sim.clone_state(b), sim.clone_state(b)
    sk.peer_update(config, scenario, c, fp, rp, sv_p, adm_p)
    sk.peer_update_plain(config, scenario, d, fp, rp, sv_p, adm_p)
    torch.cuda.synchronize()
    errs["peer_update"] = compare(f"{label} peer_update", c._asdict(),
                                  d._asdict())
    n_active = int((b.dl_flags & 1).sum())
    log(f"  {label}: all three kernels agree with their plain versions "
        f"({n_active} transfers in flight); max float err "
        f"{json.dumps(errs)}")
    return errs


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
    from hlsjs_p2p_wrapper_tpu_torch.ops import _build, swarm_kernels as sk
    t0 = time.perf_counter()
    info = _build.build(force=True)
    sk.build_kernels()
    log(f"[2] built {len(info)} source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for src, rec in info.items():
        for line in rec["ptxas"]:
            log(f"    {src}: {line.strip()}")


def make_case(sim, sk, P, S, n_steps_plain, device):
    """A config and scenario at P × S, and a state the plain path
    reached after ``n_steps_plain`` steps."""
    import numpy as np
    config = sim.SwarmConfig(n_peers=P, n_segments=S, n_levels=3,
                             neighbor_offsets=sim.ring_offsets(DEGREE))
    join = sim.staggered_joins(P, 60.0, device=device)
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


def _ratios(sim, state, n_steps, dt_s, join):
    return (float(sim.offload_ratio(state)),
            float(sim.rebuffer_ratio(state, n_steps * dt_s, join)))


def time_window(sim, sk, config, scenario, state0, n_steps, plain):
    """Device time over ``n_steps`` consecutive steps from ``state0`` (a
    clone is stepped), each step as ``_scan_swarm`` runs it: the three
    passes, the clock add and the offload-series write.  CUDA events
    bracket each pass and the step's tail.  A GPU sleep ahead of the
    window lets the host queue the launches, so the events time the
    device, not the host.  The kernels' window fails if the host did
    not stay ahead.  The plain passes launch hundreds of small ops a
    step, more than the launch queue holds, so their times are the
    passes as the host drives them, launch gaps included.  Returns
    ``({kernel: mean ms per pass}, mean ms per whole step)``."""
    import torch
    st = sim.clone_state(state0)
    series = torch.empty((n_steps,), dtype=torch.float32, device="cuda")
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(5)]
          for _ in range(n_steps)]
    passes = ((sk.elig_select_plain, sk.admit_service_plain,
               sk.peer_update_plain) if plain
              else (sk.elig_select, sk.admit_service, sk.peer_update))
    torch.cuda.synchronize()
    torch.cuda._sleep(int(3e8))
    slept = torch.cuda.Event()
    slept.record()
    for s in range(n_steps):
        e = ev[s]
        e[0].record()
        flags, req = passes[0](config, scenario, st)
        e[1].record()
        service, adm = passes[1](config, scenario, req)
        e[2].record()
        passes[2](config, scenario, st, flags, req, service, adm)
        e[3].record()
        st = st._replace(t_s=st.t_s + config.dt_ms / 1000.0)
        series[s] = sim.offload_ratio(st)
        e[4].record()
    queued_ahead = not slept.query()
    torch.cuda.synchronize()
    check(plain or queued_ahead,
          f"timing window: the host did not queue {n_steps} steps within "
          f"the GPU sleep, so the events would time the host")
    per_pass = {name: sum(ev[s][i].elapsed_time(ev[s][i + 1])
                          for s in range(n_steps)) / n_steps
                for i, name in enumerate(KERNELS)}
    return per_pass, ev[0][0].elapsed_time(ev[-1][4]) / n_steps


def trace_main_path(sim, config, scenario, state0, n_steps):
    """``n_steps`` steps of the main path's loop under ``torch.profiler``
    (CUPTI): the device time of every op on the card, summed per step,
    and each kernel's launches and mean device time in the trace.
    Returns ``(busy ms per step, {kernel: (launches, mean ms)})``; the
    busy time is None where the trace holds no device op."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    st = sim.clone_state(state0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim._scan_swarm(config, scenario, st, n_steps)
        torch.cuda.synchronize()
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in ops)
    per_kernel = {}
    for name in KERNELS:
        durs = [e.time_range.elapsed_us() for e in ops
                if f"{name}_kernel" in e.name]
        per_kernel[name] = (len(durs),
                            sum(durs) / len(durs) / 1e3 if durs else None)
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
    return {"elig_select": float(tk1), "admit_service": float(tk2),
            "peer_update": float(tk3)}


def window_bytes(sim, sk, config, scenario, state0, n_steps):
    """Mean bytes each kernel must move over the same window as
    :func:`time_window` (the kernels are deterministic, so a second
    pass over a clone repeats the same work)."""
    st = sim.clone_state(state0)
    total = {name: 0.0 for name in KERNELS}
    for _ in range(n_steps):
        before = sim.clone_state(st)
        flags, req = sk.elig_select(config, scenario, st)
        service, adm = sk.admit_service(config, scenario, req)
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
    log(f"[4] main path {P:,} peers x {S} segments x {T} steps through "
        f"the kernels: {wall:.3f} s, {P * T / wall:,.0f} peer-steps/s; "
        f"launches {json.dumps(launches)}; peak memory {peak:,} B")
    for name in KERNELS:
        check(launches[name] == T, f"{name} launched {launches[name]} "
                                   f"times on the main path, not {T}")
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
    ms, step_ms = time_window(sim, sk, config, scenario, final, window,
                              False)
    plain_ms, plain_step_ms = time_window(sim, sk, config, scenario, final,
                                          max(window // 5, 5), True)
    nbytes = window_bytes(sim, sk, config, scenario, final, window)
    busy_ms, traced = trace_main_path(sim, config, scenario, final, window)

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
    log(f"    device time per whole step (three kernels, clock add, "
        f"offload-series write; {window}-step window queued ahead, CUDA "
        f"events) {step_ms!r} ms, of which the three kernels "
        f"{sum(ms.values())!r} ms; plain passes {plain_step_ms!r} ms; "
        f"host wall per step on the main path {host_ms!r} ms")
    if busy_ms is None:
        log("    trace: torch.profiler recorded no device op; device busy "
            "time and idle share not measured")
    else:
        log(f"    trace ({window} main-path steps, torch.profiler): device "
            f"busy {busy_ms!r} ms per step, i.e. idle "
            f"{1.0 - busy_ms / host_ms!r} of the main path's host wall "
            f"per step; per kernel (launches, mean ms) "
            f"{json.dumps(traced)}")
    return launches, errs, ms, plain_ms, nbytes


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
    log(f"[5] fixture {P} x {S} x {T}: offload {offload!r} (JAX "
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
        launches, errs, ms, plain_ms, nbytes = phase_main(
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
            "max_abs_err": max(errs[name], errs_1m[name]),
            "ms": ms[name], "plain_ms": plain_ms[name],
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
