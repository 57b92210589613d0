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
   against the JAX reference's final offload and rebuffer ratio;
7. the batched kernels: four lanes of ``sample_grid(vod_grid(), 4)`` at
   1,048,576 peers × 128 segments, a few plain steps in, every kernel
   (``lane_sums`` and ``timeline_row`` too) against its plain version
   on the same stacked state;
8. the port's batched run against the committed batch fixture (the JAX
   reference's ``run_swarm_batch`` over four VOD grid points, with its
   metrics timeline);
9. the sweep path: all 48 points of the VOD grid at 1,048,576 peers ×
   128 segments × 960 steps with a timeline row every 40 steps, through
   ``run_batch_chunked`` with the autotuned chunk, launches checked;
   then chunk 16 and one direct 48-lane ``run_swarm_batch`` give the
   same rows to the bit, two lanes run alone give their lanes' series,
   timelines and ratios to the bit, each last timeline row equals its
   final ratios; then 20 batched steps at B = 48 traced, and the two
   reductions timed against their plain versions and ``torch.sum``.

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

#: the sweep path: tools/sweep.py's 48-point VOD grid as
#: SWEEP_1M_r05.json ran it (1,048,576 peers × 128 segments, a 240 s
#: watch window: 960 steps; joins staggered over the sweep's default
#: 60 s, seed 0), a timeline row every 40 steps
GRID_PEERS = 1_048_576
GRID_SEGMENTS = 128
GRID_WATCH_S = 240.0
GRID_STAGGER_S = 60.0
GRID_RECORD_EVERY = 40
GRID_CHUNK = 16
#: rows of the reference's SWEEP_1M_r05.json that stall (rebuffer > 0),
#: printed beside the port's count (its joins come from another
#: generator, so the counts need not agree)
REFERENCE_STALLING_ROWS = 36
#: the lanes run alone against their batched lanes: the first point
#: (scarce supply, stalls) and the last (ample supply)
ALONE_LANES = (0, 47)
#: batched steps traced at B = 48, with a timeline row at the end
TRACE_STEPS = 20
#: the batched kernel check: lanes, and plain steps before it, then
#: steps more to the state the timeline row is taken at
BATCH_LANES = 4
BATCH_WARM_STEPS = 60
BATCH_ROW_STEPS = 8

#: H100 SXM device memory rate, bytes/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
BITRATES = (300_000.0, 800_000.0, 2_000_000.0)
DEGREE = 8

#: kernel vs plain on the card: integer, index and packed outputs must
#: be equal; a float output may differ by RTOL·|plain| + ATOL (a few
#: ulps: powf in the kernel and torch.pow may round the EWMA apart)
RTOL, ATOL = 1e-6, 1e-6
#: the reductions' sums, kernel vs plain on the card: float32 sums of
#: up to 1,048,576 values in another order (the kernel's blocks, then
#: the blocks; torch.sum's own tree), held to 1e-5 relative.  Counts
#: are exact, and a ratio taken from the same sums is the same bits.
REDUCE_RTOL = 1e-5
#: final offload and rebuffer ratio, kernels vs plain path and port vs
#: the JAX fixture: the CPU whole-run test's tolerance
#: (tests/test_torch_swarm_sim.py RUN_TOL)
RUN_TOL = 1e-4

SOURCE = f"{PACKAGE}/csrc/swarm_step.cu"
REDUCE_SOURCE = f"{PACKAGE}/csrc/swarm_reduce.cu"
REF = "hlsjs_p2p_wrapper_tpu/ops/swarm_sim.py"
#: kernel -> (source, the reference lines it replaces)
KERNELS = {
    "select_admit": (SOURCE, f"{REF}:681 + :1259"),
    "elig_select": (SOURCE, f"{REF}:681"),
    "admit_service": (SOURCE, f"{REF}:1259"),
    "peer_update": (SOURCE, f"{REF}:1351"),
    "lane_sums": (REDUCE_SOURCE, f"{REF}:1643 + :2607"),
    "timeline_row": (REDUCE_SOURCE, f"{REF}:1559"),
}
#: the kernels the single-scenario main path launches, once a step
#: each; TK1 and TK2 are the route of offset tuples too wide for
#: select_admit's tile, and timeline_row runs only with a timeline
MAIN_PATH = ("select_admit", "peer_update", "lane_sums")
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
        want.update(lane_sums=0, timeline_row=0)
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


def _as_lanes(sim, scenario, state):
    """A scenario and a clone of its state as lanes (one lane for a
    single scenario), as ``_scan_swarm`` steps them."""
    state = sim.clone_state(state)
    if sim.is_lanes(state):
        return scenario, state
    return sim.as_lanes(scenario), sim.as_lanes(state)


def _steps(sim, sk, config, scenario, st, n_steps, route, series,
           events=None):
    """``n_steps`` steps of ``st`` on ``route`` as ``_scan_swarm`` steps
    them: the passes, the clock add and the offload series
    (``lane_sums``, or its plain version on the plain routes); with
    ``events``, one list of CUDA events per step bracketing each pass
    and the series."""
    stages = _stages(sk, config, scenario, route)
    ls = sk.lane_sums_plain if route.startswith("plain") else sk.lane_sums
    for s in range(n_steps):
        e = events[s] if events is not None else None
        if e:
            e[0].record()
        out = ()
        for n, (_name, fn) in enumerate(stages):
            out = fn(st, out)
            if e:
                e[n + 1].record()
        st = st._replace(t_s=st.t_s + config.dt_ms / 1000.0)
        ls(st, series, s)
        if e:
            e[-1].record()
    return st


def time_window(sim, sk, config, scenario, state0, n_steps, route):
    """Device time over ``n_steps`` consecutive steps from ``state0`` (a
    clone is stepped) on ``route`` (see :func:`_stages`), each step as
    ``_scan_swarm`` runs it: the passes, the clock add and the
    offload-series write.  CUDA events bracket each pass and the
    series.  A GPU sleep ahead of the window lets the host queue the
    launches, so the events time the device, not the host.  A kernels'
    window fails if the host did not stay ahead.  The plain passes
    launch hundreds of small ops a step, more than the launch queue
    holds, so their times are the passes as the host drives them,
    launch gaps included.  Returns ``({kernel: mean ms per pass}, mean
    ms per whole step)``."""
    import torch
    scenario, st = _as_lanes(sim, scenario, state0)
    names = [n for n, _fn in _stages(sk, config, scenario, route)]
    names.append("lane_sums")
    series = torch.empty((st.t_s.shape[0], n_steps), dtype=torch.float32,
                         device="cuda")
    ev = [[torch.cuda.Event(enable_timing=True)
           for _ in range(len(names) + 1)] for _ in range(n_steps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(int(3e8))
    slept = torch.cuda.Event()
    slept.record()
    _steps(sim, sk, config, scenario, st, n_steps, route, series, ev)
    queued_ahead = not slept.query()
    torch.cuda.synchronize()
    check(route.startswith("plain") or queued_ahead,
          f"timing window: the host did not queue {n_steps} steps within "
          f"the GPU sleep, so the events would time the host")
    per_pass = {name: sum(ev[s][n].elapsed_time(ev[s][n + 1])
                          for s in range(n_steps)) / n_steps
                for n, name in enumerate(names)}
    return per_pass, ev[0][0].elapsed_time(ev[-1][-1]) / n_steps


def host_wall(sim, sk, config, scenario, state0, n_steps, route):
    """Host wall per step (ms) of ``n_steps`` steps on ``route`` from a
    clone of ``state0``, stepped as ``_scan_swarm`` steps (passes, clock
    add, offload-series write), ending in a synchronize."""
    import torch
    scenario, st = _as_lanes(sim, scenario, state0)
    series = torch.empty((st.t_s.shape[0], n_steps), dtype=torch.float32,
                         device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _steps(sim, sk, config, scenario, st, n_steps, route, series)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n_steps * 1e3


def trace_steps(sim, sk, config, scenario, state0, n_steps, route,
                record_every=0):
    """``n_steps`` steps under ``torch.profiler`` (CUPTI): the main
    path's loop (``_scan_swarm``, with ``record_every``) for ``route ==
    "fused"``, else the same loop over the passes of :func:`_stages`.
    Returns ``(device busy ms per step, host wall ms per step, {kernel:
    (launches, mean ms)})`` over the kernels of :data:`KERNELS` that the
    trace holds; the busy time is None where the trace holds no device
    op.  The trace may miss a launch (at B = 48 it held 19 of 20 of one
    kernel), so the busy time per step is each kernel's mean time
    times its launches per step, plus the other device ops' time over
    the steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    scenario, st = _as_lanes(sim, scenario, state0)
    series = torch.empty((st.t_s.shape[0], n_steps), dtype=torch.float32,
                         device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if route == "fused":
            sim._scan_swarm(config, scenario, st, n_steps,
                            record_every=record_every)
        else:
            _steps(sim, sk, config, scenario, st, n_steps, route, series)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    per_kernel = {}
    for name in KERNELS:
        durs = [e.time_range.elapsed_us() for e in ops
                if f"{name}_kernel" in e.name]
        if durs:
            per_kernel[name] = (len(durs), sum(durs) / len(durs) / 1e3)
    if not ops:
        return None, wall_ms, per_kernel
    per_step = {name: 1.0 for name, _fn in _stages(sk, config, scenario,
                                                    route)}
    per_step["lane_sums"] = 1.0
    if record_every:
        per_step["timeline_row"] = 1.0 / record_every
    other_us = sum(e.time_range.elapsed_us() for e in ops
                   if not any(f"{name}_kernel" in e.name for name in KERNELS))
    busy_ms = other_us / n_steps / 1e3 + sum(
        per_kernel[name][1] * n for name, n in per_step.items()
        if name in per_kernel)
    return busy_ms, wall_ms, per_kernel


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


def lane_sums_bytes(B, P):
    """TK4 reads two [B, P] float32 arrays and writes the [B, 2] sums
    and one series entry a lane."""
    return float(8 * B * P + 12 * B)


def timeline_bytes(B, P, n_cols):
    """TK5 in row mode reads rebuffer, the previous rebuffer, join,
    leave and level ([B, P] each), writes the previous rebuffer, reads
    this step's and the previous sums and writes them back, and writes
    one row of ``n_cols`` floats a lane."""
    return float(24 * B * P + 24 * B + 4 * n_cols * B)


def step_bytes(sim, sk, config, scenario, state_before, slot_flags, req,
               adm, state_after):
    """:func:`kernel_bytes` of one step, summed over its lanes (a single
    scenario is one lane), plus the series write's ``lane_sums``."""
    if not sim.is_lanes(state_before):
        scenario, state_before, state_after = (
            sim.as_lanes(x) for x in (scenario, state_before, state_after))
        slot_flags, req, adm = (x[None] for x in (slot_flags, req, adm))
    B = state_before.t_s.shape[0]
    total = {}
    for b in range(B):
        for name, v in kernel_bytes(
                sk, config, sim.lane(scenario, b),
                sim.lane(state_before, b), slot_flags[b], req[b], adm[b],
                sim.lane(state_after, b)).items():
            total[name] = total.get(name, 0.0) + v
    total["lane_sums"] = lane_sums_bytes(B, config.n_peers)
    return total


def window_bytes(sim, sk, config, scenario, state0, n_steps):
    """Mean bytes each step kernel must move over the same window as
    :func:`time_window` (the kernels are deterministic, and both routes
    give the same outputs, so a pass over a clone repeats the work)."""
    st = sim.clone_state(state0)
    total = {}
    for _ in range(n_steps):
        before = sim.clone_state(st)
        flags, req, service, adm = sk.select_admit(config, scenario, st)
        sk.peer_update(config, scenario, st, flags, req, service, adm)
        for name, b in step_bytes(sim, sk, config, scenario, before, flags,
                                  req, adm, st).items():
            total[name] = total.get(name, 0.0) + b
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
    busy_ms, _wall, traced = trace_steps(sim, sk, config, scenario, final,
                                         window, "fused")
    pair_busy_ms, _wall, pair_traced = trace_steps(
        sim, sk, config, scenario, final, window, "pair")
    walls = {"fused": [], "pair": []}
    for route in ("fused", "pair", "pair", "fused"):
        walls[route].append(host_wall(sim, sk, config, scenario, final,
                                      HOST_STEPS, route))

    # the same run on the plain path, stepped as _scan_swarm steps
    scen_l, st = _as_lanes(sim, scenario, state0)
    series_p = torch.empty((1, T), dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = _steps(sim, sk, config, scen_l, st, T, "plain", series_p)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    offload_p, rebuffer_p = _ratios(sim, sim.lane(st, 0), T, dt_s, join)
    log(f"    plain path on the card: {wall_p:.3f} s "
        f"({P * T / wall_p:,.0f} peer-steps/s) vs kernels {wall:.3f} s; "
        f"offload {offload_p!r}, rebuffer ratio {rebuffer_p!r}")
    check(abs(offload_p - offload) <= RUN_TOL
          and abs(rebuffer_p - rebuffer) <= RUN_TOL,
          "kernels and plain path disagree on the main path's ratios")
    host_ms = wall / T * 1e3
    log(f"    device time per whole step ({window}-step windows queued "
        f"ahead, CUDA events; kernels, clock add, offload-series write): "
        f"main path {fused_step_ms!r} ms (select_admit + peer_update + "
        f"lane_sums {sum(fused_ms.values())!r} ms), TK1 + TK2 + TK3 route "
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
    library_ms = back_to_back(lambda st: (torch.sum(st.p2p_bytes, dim=-1),
                                          torch.sum(st.cdn_bytes, dim=-1)),
                              final)
    log(f"    torch.sum of p2p_bytes and cdn_bytes (two calls, the "
        f"library yardstick of lane_sums), {BACK_TO_BACK} back to back: "
        f"{library_ms!r} ms")
    return launches, errs, ms, traced_ms, plain_ms, nbytes, library_ms


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


def build_lanes(sim, sg, config, grid, watch_s):
    """The stacked scenarios of ``grid``'s points on the card, and their
    joins ``[B, P]``."""
    import torch
    built = [sg.build_scenario(config, k, watch_s=watch_s,
                               stagger_s=GRID_STAGGER_S, seed=0,
                               device="cuda") for k in grid]
    return (sim.stack_pytrees([sc for sc, _ in built]),
            torch.stack([j for _, j in built]))


def _rel_err(a, b):
    return float(((a.double() - b.double()).abs()
                  / b.double().abs().clamp_min(1e-30)).max())


def compare_reductions(sim, sk, config, scenario, prev, state, label,
                       record_every):
    """``lane_sums`` and ``timeline_row`` (a row, and the rebuffer ratio
    alone) against their plain versions on the stacked ``state``, the
    sample interval starting at ``prev``.  Sums within REDUCE_RTOL,
    counts and everything computed from the same inputs equal; each
    lane's sums alone equal its batched sums to the bit.  Returns
    ``({kernel: max abs err}, max relative error of the sums)``."""
    import torch
    B = state.t_s.shape[0]
    ser_k = torch.zeros((B, 3), dtype=torch.float32, device="cuda")
    ser_p = ser_k.clone()
    sums_k = sk.lane_sums(state, ser_k, 1)
    sums_p = sk.lane_sums_plain(state, ser_p, 1)
    torch.cuda.synchronize()
    rel = _rel_err(sums_k, sums_p)
    check(rel <= REDUCE_RTOL, f"{label} lane_sums: sums off by {rel!r} "
                              f"relative")
    ls_err = float((ser_k - ser_p).abs().max())
    check(ls_err <= REDUCE_RTOL and bool((ser_k[:, [0, 2]] == 0).all()),
          f"{label} lane_sums: series off by {ls_err!r}")
    for b in range(B):
        alone = sk.lane_sums(sim.as_lanes(sim.lane(state, b)))
        check(torch.equal(alone[0], sums_k[b]),
              f"{label} lane_sums: lane {b} alone differs from its batch")
    cols = sim.timeline_columns(config)
    M, ri = len(cols), cols.index("rebuffer")
    prev_sums = sk.lane_sums_plain(prev)
    outs, prevs = [], []
    for fn in (sk.timeline_row, sk.timeline_row_plain):
        out = torch.full((B, 2, M), float("nan"), device="cuda")
        ps, pr = prev_sums.clone(), prev.rebuffer_s.clone()
        fn(config, scenario, state, sums_p, ps, pr, out, 1, record_every)
        outs.append(out)
        prevs.append((ps, pr))
    torch.cuda.synchronize()
    (row_k, row_p), ((ps_k, pr_k), (ps_p, pr_p)) = outs, prevs
    check(bool(torch.isnan(row_k[:, 0]).all()),
          f"{label} timeline_row wrote outside its sample")
    row_k, row_p = row_k[:, 1], row_p[:, 1]
    same = [i for i in range(M) if i != ri]
    check(torch.equal(row_k[:, same], row_p[:, same]),
          f"{label} timeline_row: columns other than rebuffer differ "
          f"(kernel {row_k.tolist()}, plain {row_p.tolist()})")
    reb_rel = _rel_err(row_k[:, ri], row_p[:, ri])
    check(reb_rel <= REDUCE_RTOL, f"{label} timeline_row: rebuffer off by "
                                  f"{reb_rel!r} relative")
    check(torch.equal(ps_k, ps_p) and torch.equal(pr_k, pr_p),
          f"{label} timeline_row: the carried sums or rebuffer differ")
    ratio = sk.rebuffer_ratio_lanes(state.rebuffer_s, scenario.join_s,
                                    scenario.leave_s, state.t_s)
    check(torch.equal(ratio, row_k[:, ri]),
          f"{label} timeline_row: the ratio alone differs from the row's "
          f"rebuffer column")
    stalled = row_p[:, cols.index("stalled_peers")]
    check(bool((stalled > 0).any()), f"{label}: no peer stalled in the "
                                     f"interval, the stall columns are idle")
    log(f"  {label}, stall digest {config.stall_digest}: lane_sums and "
        f"timeline_row agree with their plain versions (sums rel err "
        f"{rel!r}, rebuffer rel err {reb_rel!r}, stalled "
        f"{stalled.tolist()}); each lane alone equals its batch")
    return ({"lane_sums": ls_err,
             "timeline_row": float((row_k - row_p).abs().max())}, rel)


def phase_batch_kernels(sim, sk, sg):
    """Every kernel against its plain version on BATCH_LANES stacked
    lanes of the VOD grid at the sweep's size."""
    import torch
    t0 = time.perf_counter()
    config = sg.build_config(GRID_PEERS, GRID_SEGMENTS, False, 8)
    grid = sg.sample_grid(sg.vod_grid(), BATCH_LANES)
    scenario, _joins = build_lanes(sim, sg, config, grid, GRID_WATCH_S)
    state = sim.init_swarm(config, device="cuda", batch=BATCH_LANES)
    for _ in range(BATCH_WARM_STEPS):
        state = sk.plain_step(config, scenario, state)
    prev = sim.clone_state(state)
    for _ in range(BATCH_ROW_STEPS):
        state = sk.plain_step(config, scenario, state)
    torch.cuda.synchronize()
    label = f"{BATCH_LANES} lanes x {GRID_PEERS:,} peers"
    log(f"[7] {label} x {GRID_SEGMENTS} segments: plain path warmed "
        f"{BATCH_WARM_STEPS + BATCH_ROW_STEPS} steps in "
        f"{time.perf_counter() - t0:.2f} s")
    check(bool(((state.dl_flags & 1).sum(dim=1) > 0).all()),
          "a lane has no transfer in flight")
    errs = compare_kernels(sim, sk, config, scenario, state, label)
    rel = 0.0
    for digest in (False, True):
        e, r = compare_reductions(sim, sk,
                                  config._replace(stall_digest=digest),
                                  scenario, prev, state, label,
                                  BATCH_ROW_STEPS)
        rel = max(rel, r)
        for name, v in e.items():
            errs[name] = max(errs.get(name, 0.0), v)
    return errs, rel


def phase_batch_fixture():
    """The port's batched run against the committed JAX batch
    fixture."""
    import numpy as np
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.testing import (REFERENCE_BATCH,
                                                     run_batch_fixture)
    d = np.load(REFERENCE_BATCH)
    offload, rebuffer, series, timeline = run_batch_fixture(d, "cuda")
    torch.cuda.synchronize()
    offload, rebuffer = offload.cpu().numpy(), rebuffer.cpu().numpy()
    series, timeline = series.cpu().numpy(), timeline.cpu().numpy()
    errs = {"offload": float(np.abs(offload - d["offload"]).max()),
            "rebuffer": float(np.abs(rebuffer - d["rebuffer"]).max()),
            "series": float(np.abs(series - d["series"]).max())}
    log(f"[8] batch fixture {d['shape'].tolist()} (peers, segments, steps, "
        f"record_every, lanes): offload {offload.tolist()} (JAX "
        f"{d['offload'].tolist()}), rebuffer {rebuffer.tolist()} (JAX "
        f"{d['rebuffer'].tolist()}); max abs err {json.dumps(errs)}")
    check(max(errs.values()) <= RUN_TOL,
          "the port's batched run disagrees with the JAX batch fixture")
    cols = list(d["columns"])
    exact = [i for i, c in enumerate(cols)
             if c in ("t_s", "stalled_peers") or c.startswith("level_")]
    check(np.array_equal(timeline[..., exact], d["timeline"][..., exact]),
          "the batch fixture's clock or count columns differ")


def _rows_equal(a, b):
    import numpy as np
    return len(a) == len(b) and all(
        x[0] == y[0] and x[1] == y[1] and np.array_equal(x[2], y[2])
        for x, y in zip(a, b))


def phase_grid(sim, sk, sg, dp):
    """The sweep path at its real size: the 48-point VOD grid through
    ``run_batch_chunked``.  Returns what the trace and the report
    need."""
    import numpy as np
    import torch
    config = sg.build_config(GRID_PEERS, GRID_SEGMENTS, False, 8)
    grid = sg.vod_grid()
    n_steps = int(GRID_WATCH_S * 1000.0 / config.dt_ms)
    n_rows = n_steps // GRID_RECORD_EVERY
    cols = sim.timeline_columns(config)

    def build(knobs):
        return sg.build_scenario(config, knobs, watch_s=GRID_WATCH_S,
                                 stagger_s=GRID_STAGGER_S, seed=0,
                                 device="cuda")

    def run(chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = dp.run_batch_chunked(config, grid, build, n_steps,
                                    watch_s=GRID_WATCH_S, chunk=chunk,
                                    record_every=GRID_RECORD_EVERY)
        torch.cuda.synchronize()
        return rows, time.perf_counter() - t0

    chunk = sim.autotune_chunk(config, len(grid), n_steps,
                               record_every=GRID_RECORD_EVERY,
                               scenario=build(grid[0])[0], device="cuda")
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    rows, wall = run(None)
    launches = dict(sk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_chunks = -(-len(grid) // chunk)
    peer_steps = len(grid) * GRID_PEERS * n_steps
    log(f"[9] VOD grid: {len(grid)} points x {GRID_PEERS:,} peers x "
        f"{GRID_SEGMENTS} segments x {n_steps} steps, a row every "
        f"{GRID_RECORD_EVERY} steps; autotuned chunk {chunk} "
        f"({n_chunks} chunk(s)); wall {wall!r} s, "
        f"{len(grid) / wall!r} grid points/s, {peer_steps / wall:,.0f} "
        f"peer-steps/s; launches {json.dumps(launches)}; peak memory "
        f"{peak:,} B")
    # per chunk: a launch of each step kernel a step; lane_sums once a
    # step, once for the timeline's first interval and once for the
    # final offload ratio; timeline_row once a row and once for the
    # final rebuffer ratio
    want = {"select_admit": n_steps * n_chunks, "elig_select": 0,
            "admit_service": 0, "peer_update": n_steps * n_chunks,
            "lane_sums": (n_steps + 2) * n_chunks,
            "timeline_row": (n_rows + 1) * n_chunks}
    check(launches == want, f"grid launches {launches}, not {want}")
    offs = [r[0] for r in rows]
    rebs = [r[1] for r in rows]
    for i, (off, reb, tl) in enumerate(rows):
        check(0.0 <= off <= 1.0 and 0.0 <= reb <= 1.0,
              f"grid point {i}: ratios out of range {off!r} {reb!r}")
        check(tl.shape == (n_rows, len(cols)) and np.isfinite(tl).all(),
              f"grid point {i}: timeline {tl.shape} not finite")
        last = tl[-1]
        check(float(last[cols.index("t_s")]) == GRID_WATCH_S
              and float(last[cols.index("offload")]) == off
              and float(last[cols.index("rebuffer")]) == reb,
              f"grid point {i}: the last timeline row {last[:3].tolist()} "
              f"is not its final ratios {off!r} {reb!r}")
    stalling = sum(r > 0.0 for r in rebs)
    check(len(set(offs)) > 1, "every grid point has the same offload")
    check(stalling > 0, "no grid point stalls: the stall columns are idle")
    log(f"    offload {min(offs)!r} .. {max(offs)!r}; {stalling} of "
        f"{len(grid)} points stall (the reference's SWEEP_1M_r05.json: "
        f"{REFERENCE_STALLING_ROWS}; the port's joins come from another "
        f"generator); each last timeline row equals its final ratios")

    rows16, wall16 = run(GRID_CHUNK)
    check(_rows_equal(rows16, rows),
          f"chunk {GRID_CHUNK} rows differ from the autotuned run's")
    scen48, joins48 = build_lanes(sim, sg, config, grid, GRID_WATCH_S)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final48, series48, tl48 = sim.run_swarm_batch(
        config, scen48, sim.init_swarm(config, device="cuda",
                                       batch=len(grid)), n_steps,
        record_every=GRID_RECORD_EVERY)
    torch.cuda.synchronize()
    wall48 = time.perf_counter() - t0
    offs48 = sim.offload_ratio_batch(final48)
    rebs48 = sim.rebuffer_ratio_batch(final48, GRID_WATCH_S, joins48)
    direct = [(float(o), float(r), t) for o, r, t in
              zip(offs48.tolist(), rebs48.tolist(), tl48.cpu().numpy())]
    check(_rows_equal(direct, rows), "the direct 48-lane batch's rows "
                                     "differ from the dispatch's")
    for b in ALONE_LANES:
        sc, join = build(grid[b])
        f1, s1, t1 = sim.run_swarm_scenario(
            config, sc, sim.init_swarm(config, device="cuda"), n_steps,
            record_every=GRID_RECORD_EVERY)
        check(torch.equal(s1, series48[b]) and torch.equal(t1, tl48[b])
              and torch.equal(sim.offload_ratio(f1), offs48[b])
              and torch.equal(sim.rebuffer_ratio(f1, GRID_WATCH_S, join),
                              rebs48[b]),
              f"grid point {b} run alone differs from its batched lane")
    log(f"    chunk {GRID_CHUNK}: {wall16!r} s, rows equal to the bit; one "
        f"direct {len(grid)}-lane run_swarm_batch: {wall48!r} s, rows "
        f"equal; points {list(ALONE_LANES)} run alone: series, timelines "
        f"and ratios equal their lanes to the bit")
    return {"config": config, "scenario": scen48, "final": final48,
            "launches": launches, "wall48": wall48, "n_steps": n_steps}


def cuda_ms(fn, n):
    """Mean ms of ``n`` calls of ``fn()`` between two CUDA events, as
    the host drives them (for the plain versions)."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_trace48(sim, sk, g):
    """TRACE_STEPS batched steps at B = 48 from the grid's final state,
    traced (both routes), each kernel's bytes for one of those steps,
    and the two reductions timed (CUDA events, 200 launches back to
    back) against their plain versions and ``torch.sum``."""
    import torch
    config, scenario, final = g["config"], g["scenario"], g["final"]
    B, P = final.rebuffer_s.shape
    busy, wall_ms, traced = trace_steps(sim, sk, config, scenario, final,
                                        TRACE_STEPS, "fused",
                                        record_every=TRACE_STEPS)
    pair_busy, _wall, pair_traced = trace_steps(sim, sk, config, scenario,
                                                final, TRACE_STEPS, "pair")
    before, st = sim.clone_state(final), sim.clone_state(final)
    flags, req, _service, adm = sk.select_admit(config, scenario, st)
    sk.peer_update(config, scenario, st, flags, req, _service, adm)
    nbytes = step_bytes(sim, sk, config, scenario, before, flags, req, adm,
                        st)
    M = len(sim.timeline_columns(config))
    nbytes["timeline_row"] = timeline_bytes(B, P, M)
    del before, st

    series = torch.empty((B, 1), dtype=torch.float32, device="cuda")
    sums = sk.lane_sums(final)
    prev_sums, prev_reb = sums.clone(), final.rebuffer_s.clone()
    out = torch.empty((B, 1, M), dtype=torch.float32, device="cuda")

    def row(st):
        sk.timeline_row(config, scenario, st, sums, prev_sums, prev_reb,
                        out, 0, GRID_RECORD_EVERY)

    def row_plain():
        sk.timeline_row_plain(config, scenario, final, sums, prev_sums,
                              prev_reb, out, 0, GRID_RECORD_EVERY)
    ms = {"lane_sums": back_to_back(lambda st: sk.lane_sums(st, series, 0),
                                    final),
          "timeline_row": back_to_back(row, final)}
    plain = {"lane_sums": cuda_ms(lambda: sk.lane_sums_plain(final, series,
                                                             0), 5),
             "timeline_row": cuda_ms(row_plain, 5)}
    library = back_to_back(lambda st: (torch.sum(st.p2p_bytes, dim=1),
                                       torch.sum(st.cdn_bytes, dim=1)),
                           final)
    traced_ms = {**{k: v[1] for k, v in pair_traced.items()},
                 **{k: v[1] for k, v in traced.items()}}
    bound = {k: b / HBM_BYTES_PER_S * 1e3 for k, b in nbytes.items()}
    step_ms = g["wall48"] * 1e3 / g["n_steps"]
    if busy is None:
        log("[9] trace at B = 48: torch.profiler recorded no device op; "
            "device busy time and idle share not measured")
    else:
        log(f"[9] trace of {TRACE_STEPS} batched steps at B = {B} "
            f"(torch.profiler, a row at the end): device busy {busy!r} ms "
            f"per step, idle {1.0 - busy / wall_ms!r} of the traced "
            f"window's host wall ({wall_ms!r} ms per step; the direct "
            f"48-lane run took {step_ms!r} ms per step); TK1 + TK2 route "
            f"busy {pair_busy!r} ms per step")
    log(f"    per kernel at B = {B} (launches, traced mean ms): "
        f"{json.dumps(traced)}, TK1 + TK2 route {json.dumps(pair_traced)}; "
        f"bytes {json.dumps(nbytes)}; bound ms at 3.35 TB/s "
        f"{json.dumps(bound)}; traced / bound "
        f"{json.dumps({k: traced_ms[k] / bound[k] for k in traced_ms})}")
    log(f"    reductions at B = {B}, {BACK_TO_BACK} launches back to back "
        f"(CUDA events): {json.dumps(ms)} ms; plain versions "
        f"{json.dumps(plain)} ms; torch.sum of p2p_bytes and cdn_bytes "
        f"(two calls) {library!r} ms")
    return {"traced_ms": traced_ms, "bytes": nbytes, "bound_ms": bound,
            "launches": {k: v[0] for k, v in {**pair_traced,
                                              **traced}.items()},
            "ms": ms, "plain_ms": plain, "library_ms": library}


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
    from hlsjs_p2p_wrapper_tpu_torch import sweep_grid as sg
    from hlsjs_p2p_wrapper_tpu_torch.ops import (dispatch as dp,
                                                 swarm_kernels as sk,
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
        (main_launches, errs, ms, traced_ms, plain_ms, nbytes,
         library_b1) = phase_main(sim, sk, PEERS, SEGMENTS, STEPS, WINDOW)
        phase_fixture(sim)
        errs_batch, sums_rel = phase_batch_kernels(sim, sk, sg)
        phase_batch_fixture()
        grid = phase_grid(sim, sk, sg, dp)
        b48 = phase_trace48(sim, sk, grid)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        err = max(d.get(name, 0.0) for d in (errs, errs_1m, errs_routes,
                                              errs_batch))
        wide = {"shape": f"48 x {GRID_PEERS:,}",
                "launches": b48["launches"].get(name, 0),
                "traced_ms": b48["traced_ms"].get(name),
                "bytes": b48["bytes"][name],
                "bound_ms": b48["bound_ms"][name]}
        if name in b48["ms"]:
            wide.update(ms=b48["ms"][name], plain_ms=b48["plain_ms"][name])
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": grid["launches"][name],
                 "main_path_launches": main_launches[name],
                 "max_abs_err": err, "bound_by": "bytes"}
        if name == "timeline_row":   # runs only with a timeline
            entry.update(shape=wide["shape"], ms=wide["ms"],
                         traced_ms=wide["traced_ms"],
                         plain_ms=wide["plain_ms"],
                         bound_ms=wide["bound_ms"], bytes=wide["bytes"],
                         library_ms=None)
        else:
            entry.update(
                shape=f"1 x {PEERS:,}", ms=ms[name],
                traced_ms=traced_ms.get(name), plain_ms=plain_ms[name],
                bound_ms=nbytes[name] / HBM_BYTES_PER_S * 1e3,
                bytes=nbytes[name],
                library_ms=library_b1 if name == "lane_sums" else None)
        if name == "lane_sums":
            wide["library_ms"] = b48["library_ms"]
            entry["max_rel_err_sums"] = sums_rel
        entry["b48"] = wide
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
