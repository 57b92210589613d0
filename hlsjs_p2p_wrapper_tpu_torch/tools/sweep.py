"""Design-space sweep on the port's chunked dispatch: the reference's
``tools/sweep.py`` (its engine functions :348-403, :419-799 and
``main``) on ``ops/dispatch.py``.

Runs a grid of design knobs through the batched simulator and prints
the offload/rebuffer frontier.  Grid points are grouped by their
static knobs (:data:`STATIC_KNOBS`: the ring degree only), so each
shipped grid is one dispatch group: its points are stacked as lanes
and stepped in chunks (autotuned from the card's free memory unless
``--chunk`` pins it), the next chunk's scenarios built while the card
runs the last one.  ``--sequential`` steps one point at a time through
``run_swarm_scenario`` instead, the per-point parity path (lanes
batched and alone are equal to the bit).

Warm starts (``engine/artifact_cache.py``): finished rows are cached
by content under ``$HLSJS_P2P_TORCH_CACHE_DIR`` (else
``~/.cache/hlsjs_p2p_wrapper_tpu_torch``), so a rerun recomputes
nothing for unchanged points; ``--no-row-cache`` recomputes,
``--no-warm-start`` turns the row cache and the kernel libraries'
event counts off.  The dispatch is resilient (``engine/faults.py``):
transient errors retry, an out-of-memory chunk bisects, an exhausted
budget becomes a ``"failed": true`` row, completed rows are journaled
so ``--resume`` replays a killed run against the row cache, and the
artifact is written atomically; ``--inject-faults`` is the
deterministic chaos hook.  ``--fabric DIR`` shards the grid into
lease-claimed units that cooperating host processes compute
(``engine/fabric.py``); ``--trace-dir`` arms the flight recorder
(``engine/tracer.py``).

Usage::

    python -m hlsjs_p2p_wrapper_tpu_torch.tools.sweep            # VOD grid
    python -m hlsjs_p2p_wrapper_tpu_torch.tools.sweep --live     # live grid
    python -m hlsjs_p2p_wrapper_tpu_torch.tools.sweep --peers 64 --device cpu
    python -m hlsjs_p2p_wrapper_tpu_torch.tools.sweep --peers 1048576 \\
        --out SWEEP.json

Output: one row per grid point with the P2P offload ratio and the
rebuffer ratio beside its knobs, best offload first; ``--json`` prints
one JSON line a row, ``--out FILE`` writes meta and rows as a JSON
artifact with the reference's keys, and ``--record-every N`` with
``--timelines-out FILE`` writes each point's metrics timeline as JSON
lines.  ``--population SPEC.json`` overlays every point with a cohort
mixture (``engine/population.py``), crossing the grid with the spec's
mixture axis.  The compile count in the summary and in the artifact's
``compile_groups`` is the port's ``CompileCounter``: ``nvcc`` builds
started plus CUDA-graph captures.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from . import (COMPILES_MEANING, add_device_flag, device_identity,
               launch_counts, open_device, report_kernels)
from ..core.device import resolve_device
from ..engine.artifact_cache import (CompileCounter, SweepJournal,
                                     WarmStart, atomic_write_json,
                                     atomic_write_text, journal_path,
                                     journal_shards)
from ..engine.fabric import (FleetChaos, WorkLedger, barrier,
                             fleet_report, run_units)
from ..engine.faults import FaultPlan, FaultPolicy
from ..engine.population import load_spec
from ..engine.tracer import FlightRecorder, counter_families, run_id_for
from ..ops.dispatch import run_groups_chunked
from ..ops.swarm_sim import (autotune_chunk, init_swarm, offload_ratio,
                             rebuffer_ratio, run_swarm_scenario,
                             timeline_columns)
from ..sweep_grid import (build_config, build_scenario, journal_meta,
                          live_grid, population_grid, vod_grid)

#: the checkout's root, the working directory of spawned fabric workers
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: dispatch-group knobs: grid fields baked into ``SwarmConfig``; every
#: other knob is scenario data, so the shipped grids are one group each
STATIC_KNOBS = (
    "degree",  # static: the circulant neighbour offsets are config
)


def _static_key(knobs):
    """One dispatch group per distinct value of this tuple."""
    return tuple(knobs[k] for k in STATIC_KNOBS)


def group_grid(grid):
    """The dispatch-group map: ``_static_key`` → grid indices."""
    groups = {}
    for idx, knobs in enumerate(grid):
        groups.setdefault(_static_key(knobs), []).append(idx)
    return groups


def build_groups(grid, *, peers, segments, watch_s, live, seed,
                 stagger_s=60.0, population=None, device=None):
    """The group decomposition every execution path shares (the batched
    dispatch, fabric workers, the fabric merge): ``group_list`` is
    ``run_groups_chunked``'s ``(config, items, build)`` triples with
    scenarios built on ``device`` (the card when None), ``group_keys``
    maps each group back to its grid indices, and ``n_steps`` is the
    run's length.  A pure function of the grid and the sizes, so every
    fabric host derives the same groups."""
    group_list = []
    group_keys = []
    for key, idxs in group_grid(grid).items():
        config = build_config(
            peers, segments, live, key[0],
            n_cohorts=(len(population.cohorts)
                       if population is not None else 0))
        build = (lambda k, cfg=config:
                 build_scenario(cfg, k, watch_s=watch_s,
                                stagger_s=stagger_s, seed=seed,
                                population=population, device=device))
        group_list.append((config, [grid[i] for i in idxs], build))
        group_keys.append((key, idxs))
    n_steps = int(watch_s * 1000.0 / group_list[0][0].dt_ms)
    return group_list, group_keys, n_steps


def run_grid_batched(grid, *, peers, segments, watch_s, live, seed,
                     chunk=None, stagger_s=60.0, record_every=0,
                     warm_start=None, raw=False, faults=None,
                     journal=None, trace=None, population=None,
                     device=None):
    """The batched engine: ``run_groups_chunked`` over
    :func:`build_groups`' groups.  Returns ``(rows, info)``, rows in
    grid order (``offload`` rounded to 4 places and ``rebuffer`` to 5
    unless ``raw``; ``"_timeline"`` the ``[n_steps // record_every, M]``
    array when recording; ``failed`` rows for points whose recovery
    budget ran out) and ``info`` the groups' stats (``compile_groups``,
    the resolved ``chunk``, ``row_hits``, structured ``failures``, per
    group ``chunk`` / ``chunks`` / ``row_hits`` / ``first_dispatch_s``,
    None where every row came from the row cache)."""
    if not grid:
        return [], {"compile_groups": 0, "chunk": None,
                    "chunk_autotuned": chunk is None, "groups": []}
    group_list, group_keys, n_steps = build_groups(
        grid, peers=peers, segments=segments, watch_s=watch_s,
        live=live, seed=seed, stagger_s=stagger_s,
        population=population, device=device)
    results, stats = run_groups_chunked(
        group_list, n_steps, watch_s=watch_s, chunk=chunk,
        record_every=record_every, warm_start=warm_start, faults=faults,
        journal=journal, trace=trace)

    rows = [None] * len(grid)
    for (key, idxs), metrics in zip(group_keys, results):
        for i, metric in zip(idxs, metrics):
            if metric is None:
                rows[i] = {**grid[i], "offload": None,
                           "rebuffer": None, "failed": True}
                continue
            off, reb = metric[0], metric[1]
            row = {**grid[i],
                   "offload": off if raw else round(off, 4),
                   "rebuffer": reb if raw else round(reb, 5)}
            if record_every:
                row["_timeline"] = metric[2]
            rows[i] = row
    chunks = [st["chunk"] for st in stats if st["chunk"] is not None]
    info = {
        "compile_groups": len(group_list),
        "chunk": max(chunks) if chunks else None,
        "chunk_autotuned": chunk is None,
        "row_hits": sum(st["row_hits"] for st in stats),
        "failures": [{"group": list(key),
                      "items": [idxs[j] for j in f["items"]],
                      "reason": f["reason"], "error": f["error"]}
                     for (key, idxs), st in zip(group_keys, stats)
                     for f in st["failures"]],
        "groups": [{"key": list(key), "points": len(idxs),
                    "chunk": st["chunk"], "chunks": st["chunks"],
                    "row_hits": st["row_hits"],
                    "failures": st["failures"],
                    "first_dispatch_s": (
                        round(st["first_dispatch_s"], 3)
                        if st["first_dispatch_s"] is not None
                        else None)}
                   for (key, idxs), st in zip(group_keys, stats)],
    }
    return rows, info


def run_grid_sequential(grid, *, peers, segments, watch_s, live, seed,
                        stagger_s=60.0, population=None, raw=False,
                        device=None, **_):
    """The per-point path: one ``run_swarm_scenario`` and one readback
    a grid point, its scenario built as the batched path builds it, so
    its rows equal the batched rows to the bit."""
    rows = []
    groups = set()
    for knobs in grid:
        config = build_config(
            peers, segments, live, knobs["degree"],
            n_cohorts=(len(population.cohorts)
                       if population is not None else 0))
        n_steps = int(watch_s * 1000.0 / config.dt_ms)
        scenario, join = build_scenario(config, knobs, watch_s=watch_s,
                                        stagger_s=stagger_s, seed=seed,
                                        population=population,
                                        device=device)
        final = run_swarm_scenario(
            config, scenario,
            init_swarm(config, device=scenario.join_s.device),
            n_steps)[0]
        groups.add(_static_key(knobs))
        off = float(offload_ratio(final))
        reb = float(rebuffer_ratio(final, watch_s, join))
        rows.append({**knobs,
                     "offload": off if raw else round(off, 4),
                     "rebuffer": reb if raw else round(reb, 5)})
    return rows, {"compile_groups": len(groups), "chunk": None,
                  "chunk_autotuned": False, "groups": []}


# -- the multi-host fabric (engine/fabric.py) ---------------------------

def resolve_group_chunks(group_list, n_steps, chunk):
    """Per-group lanes a unit for the fabric manifest: the pinned
    ``chunk`` (clamped to the group) or the autotuned fit on the device
    the group's scenarios are built on.  Only the first host's
    resolution matters: the others adopt the published manifest."""
    chunks = []
    for config, items, build in group_list:
        if chunk is not None:
            chunks.append(max(min(chunk, len(items)), 1))
        else:
            probe = build(items[0])[0] if items else None
            chunks.append(autotune_chunk(
                config, len(items), n_steps, scenario=probe,
                device=None if probe is None else probe.join_s.device))
    return chunks


def fabric_host(grid, *, peers, segments, watch_s, live, seed, chunk,
                fabric_dir, host_id, lease_s, warm_start, faults,
                chaos_spec=None, barrier_hosts=0, stagger_s=60.0,
                record_every=0, trace=None, device=None):
    """One fabric host's work: join the work ledger in ``fabric_dir``
    (``chaos_spec``, ``kill@N`` or ``stall@N:S``, arms the fleet gate's
    claim-ordinal chaos), publish or adopt the unit manifest, wait at
    the start-line ``barrier`` for ``barrier_hosts`` hosts (the kernel
    libraries loaded and the card's context made first, so a host is not
    still loading while its peers drain the grid), then claim → dispatch → journal → finalize
    units (``run_units``, this host's journal shard) until the grid is
    done.  Returns a dict: ``group_keys``, ``results`` (per group, item
    → metric or None), ``unit_log``, the ``ledger``, the manifest's
    ``units`` and ``chunks``, the ``journal`` path and ``run_s``, the
    wall of ``run_units``."""
    group_list, group_keys, n_steps = build_groups(
        grid, peers=peers, segments=segments, watch_s=watch_s,
        live=live, seed=seed, stagger_s=stagger_s, device=device)
    meta = journal_meta(grid, peers=peers, segments=segments,
                        watch_s=watch_s, live=live, seed=seed,
                        record_every=record_every)
    ledger = WorkLedger(
        fabric_dir, meta, host_id, lease_s=lease_s,
        registry=warm_start.registry,
        chaos=FleetChaos.parse(chaos_spec) if chaos_spec else None,
        trace=trace)
    units, chunks = ledger.ensure_manifest(
        [len(items) for _, items, _ in group_list],
        resolve_group_chunks(group_list, n_steps, chunk))
    if barrier_hosts:
        dev = resolve_device(device)
        if dev.type == "cuda":
            from ..ops import swarm_kernels
            swarm_kernels.build_kernels()
            # the card's context too: a host's first lease then pays for
            # its dispatch alone
            torch.zeros(1, device=dev)
        barrier(fabric_dir, host_id, barrier_hosts)
    jpath = journal_path(warm_start.cache_dir, meta, host_id)
    t0 = time.perf_counter()
    with SweepJournal(jpath, meta,
                      resume=os.path.exists(jpath)) as journal:
        results, unit_log = run_units(
            ledger, group_list, n_steps, watch_s=watch_s,
            record_every=record_every, warm_start=warm_start,
            faults=faults, journal=journal)
    return {"group_keys": group_keys, "results": results,
            "unit_log": unit_log, "ledger": ledger, "units": units,
            "chunks": chunks, "journal": jpath,
            "run_s": time.perf_counter() - t0}


def run_grid_fabric_worker(grid, *, peers, segments, watch_s, live,
                           seed, chunk, fabric_dir, host_id, lease_s,
                           warm_start, faults, chaos_spec=None,
                           barrier_hosts=0, stagger_s=60.0, trace=None,
                           device=None):
    """One fabric host process: :func:`fabric_host`, then this host's
    partial artifact, written atomically to
    ``<fabric_dir>/partial/<host>.json``: its rows by grid index at full
    precision (the merge rounds), its claim counts, fault counts, the
    registry's replayed counter families and its unit log."""
    host = fabric_host(
        grid, peers=peers, segments=segments, watch_s=watch_s, live=live,
        seed=seed, chunk=chunk, fabric_dir=fabric_dir, host_id=host_id,
        lease_s=lease_s, warm_start=warm_start, faults=faults,
        chaos_spec=chaos_spec, barrier_hosts=barrier_hosts,
        stagger_s=stagger_s, trace=trace, device=device)
    rows = {}
    for gi, (key, idxs) in enumerate(host["group_keys"]):
        for local, metric in host["results"][gi].items():
            if metric is None:
                rows[str(idxs[local])] = {"failed": True}
            else:
                rows[str(idxs[local])] = [metric[0], metric[1]]
    partial = {
        "host": host_id,
        "rows": rows,
        "claims": host["ledger"].claim_counts(),
        "faults": faults.fault_counts() if faults is not None else {},
        "counters": counter_families(warm_start.registry),
        "units": host["unit_log"],
        "lease_s": lease_s,
    }
    if trace is not None:
        # every buffered event durable before the partial exists
        trace.flush()
    atomic_write_json(os.path.join(fabric_dir, "partial",
                                   f"{host_id}.json"), partial)
    return partial


def merge_fabric(grid, *, peers, segments, watch_s, live, seed,
                 fabric_dir, warm_start, chunk=None, raw=False,
                 stagger_s=60.0, device=None):
    """Merge the hosts' partial artifacts into ``(rows, info)``.  Rows
    merge by grid index, a success over a failed placeholder, else the
    first partial's (hosts' rows are bit-identical); rows a host
    finalized but never exported (killed before its partial) come back
    from the row cache by key (``recovered_rows``).  A grid index with
    no row anywhere means unfinished units: the merge raises, and
    rerunning the workers on the same fabric directory completes them."""
    group_list, group_keys, n_steps = build_groups(
        grid, peers=peers, segments=segments, watch_s=watch_s,
        live=live, seed=seed, stagger_s=stagger_s, device=device)
    partial_dir = os.path.join(fabric_dir, "partial")
    partials = []
    for name in (sorted(os.listdir(partial_dir))
                 if os.path.isdir(partial_dir) else []):
        if name.endswith(".json"):
            with open(os.path.join(partial_dir, name),
                      encoding="utf-8") as fh:
                partials.append(json.load(fh))
    merged = [None] * len(grid)
    for p in partials:
        for key, value in p["rows"].items():
            idx = int(key)
            current = merged[idx]
            if current is None or (isinstance(current, dict)
                                   and not isinstance(value, dict)):
                merged[idx] = value
    recovered = 0
    if any(v is None or isinstance(v, dict) for v in merged):
        for (key, idxs), (config, items, build) in zip(group_keys,
                                                       group_list):
            for local, grid_idx in enumerate(idxs):
                if not (merged[grid_idx] is None
                        or isinstance(merged[grid_idx], dict)):
                    continue
                scenario, join = build(items[local])
                rkey = warm_start.row_key(config, scenario, join,
                                          n_steps, watch_s=watch_s,
                                          record_every=0)
                cached = warm_start.row_load(rkey)
                if cached is not None:
                    if merged[grid_idx] is None:
                        recovered += 1
                    merged[grid_idx] = [cached[0], cached[1]]
    missing = [i for i, v in enumerate(merged) if v is None]
    if missing:
        raise RuntimeError(
            f"fabric merge: {len(missing)} grid points have no "
            f"completed row (indices {missing[:8]}…) — units are "
            f"still unfinished; rerun workers against {fabric_dir} "
            f"to complete the remaining claims")
    rows = []
    for knobs, value in zip(grid, merged):
        if isinstance(value, dict):
            rows.append({**knobs, "offload": None, "rebuffer": None,
                         "failed": True})
        else:
            off, reb = value
            rows.append({**knobs,
                         "offload": off if raw else round(off, 4),
                         "rebuffer": reb if raw else round(reb, 5)})
    report = fleet_report(fabric_dir)
    units_detail = report.pop("units_detail")
    info = {
        "compile_groups": len(group_list),
        "chunk": None, "chunk_autotuned": chunk is None,
        "row_hits": 0,
        "failures": [
            {"host": p["host"], "unit": u["unit"], **f}
            for p in partials for u in p["units"]
            for f in u["failures"]],
        "groups": [],
        "fabric": {
            "hosts": [{"host": p["host"],
                       "rows": len(p["rows"]),
                       "claims": p["claims"],
                       "units": len(p["units"])}
                      for p in partials],
            "report": report,
            "recovered_rows": recovered,
            "units": len(units_detail),
        },
    }
    manifest_path = os.path.join(fabric_dir, "units.json")
    if os.path.exists(manifest_path):
        with open(manifest_path, encoding="utf-8") as fh:
            info["chunk"] = max(json.load(fh)["chunks"])
    return rows, info


def spawn_local_fleet(args, hosts):
    """Spawn-local mode: ``hosts`` worker processes of this tool on the
    shared fabric directory, waited out.  The claim protocol is files
    only, so a shared-filesystem fleet runs the same worker path."""
    procs = []
    for h in range(hosts):
        cmd = [sys.executable, "-m", __spec__.name,
               "--fabric", args.fabric, "--host-id", f"host{h:02d}",
               "--fabric-lease-s", str(args.fabric_lease_s),
               "--peers", str(args.peers),
               "--segments", str(args.segments),
               "--watch-s", str(args.watch_s),
               "--seed", str(args.seed), "--device", args.device]
        if args.live:
            cmd.append("--live")
        if args.chunk is not None:
            cmd.extend(["--chunk", str(args.chunk)])
        if args.trace_dir:
            cmd.extend(["--trace-dir", args.trace_dir])
        procs.append(subprocess.Popen(cmd, cwd=_ROOT))
    rcs = [proc.wait() for proc in procs]
    if any(rcs):
        raise SystemExit(
            "fabric workers failed: "
            + ", ".join(f"host{h:02d} rc={rc}"
                        for h, rc in enumerate(rcs) if rc))


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--peers", type=int, default=1024)
    ap.add_argument("--segments", type=int, default=128)
    ap.add_argument("--watch-s", type=float, default=240.0)
    ap.add_argument("--live", action="store_true",
                    help="sweep the live-edge stagger grid instead of VOD")
    ap.add_argument("--population", metavar="SPEC",
                    help="heterogeneous-population scenario plane "
                         "(engine/population.py): path to a JSON "
                         "PopulationSpec (see examples/).  A spec with "
                         "a mix_cohort/mix_fractions axis crosses the "
                         "grid with one population_mix knob value per "
                         "fraction (scenario data: the mixture grid "
                         "stays one dispatch group)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=None,
                    help="scenarios per batched dispatch (default: "
                         "autotuned from the card's free memory and "
                         "the per-lane state footprint)")
    ap.add_argument("--sequential", action="store_true",
                    help="per-point dispatch (the per-point parity "
                         "path)")
    ap.add_argument("--no-warm-start", action="store_true",
                    help="disable the warm-start engine entirely (no "
                         "row cache, no kernel-library event counts; "
                         "engine/artifact_cache.py)")
    ap.add_argument("--no-row-cache", action="store_true",
                    help="disable row reuse only: grid points "
                         "recompute even when an identical finished "
                         "row is cached")
    ap.add_argument("--record-every", type=int, default=0, metavar="N",
                    help="emit a metrics timeline sample every N steps "
                         "per grid point (0 = off; batched engine only)")
    ap.add_argument("--timelines-out", metavar="FILE",
                    help="write per-point timelines as JSON lines "
                         "(knobs + columns + samples); implies "
                         "--record-every 20 when that is unset")
    ap.add_argument("--json", action="store_true",
                    help="one JSON line per grid point")
    ap.add_argument("--out", metavar="FILE",
                    help="write the full sweep (meta + rows) as JSON; "
                         "its compile_groups is the count of "
                         + COMPILES_MEANING)
    ap.add_argument("--resume", action="store_true",
                    help="resume an interrupted sweep: replay the "
                         "crash-safe journal against the row cache "
                         "(zero recompute of completed rows) and "
                         "dispatch only the rest")
    ap.add_argument("--fabric", metavar="DIR",
                    help="multi-host work ledger directory "
                         "(engine/fabric.py): shard the grid into "
                         "lease-claimed work units that cooperating "
                         "host processes compute, steal on host death, "
                         "and merge")
    ap.add_argument("--hosts", type=int, default=None, metavar="N",
                    help="with --fabric: spawn N local worker "
                         "processes, wait, and merge their partial "
                         "artifacts (0 = merge-only, the shared-FS "
                         "fleet's final step)")
    ap.add_argument("--host-id", metavar="ID",
                    help="with --fabric: join the ledger as this "
                         "worker (each host of a shared-FS fleet runs "
                         "one, with a unique id), write "
                         "partial/<ID>.json, and exit")
    ap.add_argument("--fabric-lease-s", type=float, default=30.0,
                    metavar="S",
                    help="work-unit claim TTL: a host that stops "
                         "heartbeating for this long has its units "
                         "stolen (size it to outlive one chunk's "
                         "dispatch; default 30)")
    ap.add_argument("--fabric-chaos", metavar="SPEC",
                    help=argparse.SUPPRESS)  # fleet-gate hook:
    # kill@N / stall@N:S on this worker's Nth claim
    ap.add_argument("--fabric-barrier", type=int, default=0,
                    metavar="N", help=argparse.SUPPRESS)  # fleet-gate
    # hook: load the kernels, then wait for N ready hosts
    ap.add_argument("--inject-faults", metavar="SPEC",
                    help="deterministic fault plane (chaos/test hook): "
                         "comma-separated kind@group:chunk[xN] "
                         "coordinates, kind one of oom/transient/"
                         "timeout/kill (engine/faults.py FaultPlan)")
    ap.add_argument("--trace-dir", metavar="DIR",
                    help="arm the flight recorder (engine/tracer.py): "
                         "one append-only event shard per host under "
                         "DIR — dispatch spans, correlated fault/cache/"
                         "fabric counter events, row finalizes, lease "
                         "steps")
    add_device_flag(ap)
    return ap


def _check_args(ap, args):
    """The reference tool's flag rules."""
    if args.timelines_out and not args.record_every:
        args.record_every = 20
    if args.record_every and args.sequential:
        ap.error("--record-every needs the batched engine "
                 "(drop --sequential)")
    if args.record_every and not args.timelines_out:
        ap.error("--record-every without --timelines-out would "
                 "compute every timeline and then discard it — "
                 "name an output file")
    if args.sequential and (args.resume or args.inject_faults):
        ap.error("--resume/--inject-faults need the batched engine "
                 "(drop --sequential)")
    if args.trace_dir and args.sequential:
        ap.error("--trace-dir needs the batched engine "
                 "(drop --sequential)")
    if args.fabric:
        if args.sequential:
            ap.error("--fabric needs the batched engine "
                     "(drop --sequential)")
        if args.no_warm_start or args.no_row_cache:
            ap.error("--fabric requires the row cache: steals are "
                     "safe precisely because every completion "
                     "resolves to one content-addressed row (drop "
                     "--no-warm-start/--no-row-cache)")
        if args.record_every or args.timelines_out:
            ap.error("--record-every/--timelines-out are single-host "
                     "features (timelines do not ride the fabric's "
                     "partial artifacts)")
        if args.resume:
            ap.error("--resume is implicit under --fabric: rerun the "
                     "workers against the same fabric dir and they "
                     "claim exactly the unfinished units")
        if args.hosts is None and not args.host_id:
            ap.error("--fabric needs --hosts N (spawn-local fleet), "
                     "--host-id ID (join as one worker), or "
                     "--hosts 0 (merge existing partials)")
    elif (args.hosts is not None or args.host_id
          or args.fabric_chaos or args.fabric_barrier):
        ap.error("--hosts/--host-id/--fabric-* need --fabric DIR")
    if args.population and args.fabric:
        ap.error("--population is single-host for now (the fabric "
                 "manifest does not carry the spec; run the mixture "
                 "grid without --fabric)")


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    dev = open_device(ap, args.device)
    _check_args(ap, args)
    # before anything touches the kernels: every build and capture counts
    probe = CompileCounter().attach()
    launches = launch_counts()
    try:
        rc = _run(ap, args, dev, probe)
    finally:
        probe.detach()
    report_kernels(probe, launches)
    return rc


def _run(ap, args, dev, probe):
    grid = live_grid() if args.live else vod_grid()
    population = None
    if args.population:
        population = load_spec(args.population)
        grid = population_grid(grid, population)
    engine = run_grid_sequential if args.sequential else run_grid_batched
    warm_start = None
    if not (args.no_warm_start or args.sequential):
        warm_start = WarmStart(row_cache=not args.no_row_cache)
    # recovery is on by default for the batched engine, counted in the
    # warm start's registry so one export sees both
    faults = FaultPolicy(
        plan=(FaultPlan.parse(args.inject_faults)
              if args.inject_faults else None),
        registry=(warm_start.registry if warm_start is not None
                  else None))
    trace = None
    if args.trace_dir and not (args.fabric and not args.host_id):
        # attached to the shared registry before any engine work; the
        # fabric launcher and merge record nothing (one writer a shard)
        trace_meta = journal_meta(
            grid, peers=args.peers, segments=args.segments,
            watch_s=args.watch_s, live=args.live, seed=args.seed,
            record_every=args.record_every, population=population)
        trace = FlightRecorder(
            args.trace_dir, args.host_id or "host00",
            run_id=run_id_for(trace_meta),
            registry=(warm_start.registry if warm_start is not None
                      else faults.registry))
    if args.fabric and args.host_id:
        partial = run_grid_fabric_worker(
            grid, peers=args.peers, segments=args.segments,
            watch_s=args.watch_s, live=args.live, seed=args.seed,
            chunk=args.chunk, fabric_dir=args.fabric,
            host_id=args.host_id, lease_s=args.fabric_lease_s,
            warm_start=warm_start, faults=faults,
            chaos_spec=args.fabric_chaos,
            barrier_hosts=args.fabric_barrier, trace=trace, device=dev)
        print(f"# fabric worker {args.host_id}: "
              f"{len(partial['rows'])} rows, "
              f"claims {partial['claims'] or '{}'}, "
              f"faults {partial['faults'] or '{}'}",
              file=sys.stderr)
        if trace is not None:
            trace.close()
        return 0
    journal = None
    if args.resume and (warm_start is None
                        or not warm_start.rows_enabled):
        ap.error("--resume replays the journal against the row "
                 "cache (drop --no-row-cache/--no-warm-start)")
    if (warm_start is not None and warm_start.rows_enabled
            and not args.fabric):
        meta = journal_meta(grid, peers=args.peers,
                            segments=args.segments,
                            watch_s=args.watch_s, live=args.live,
                            seed=args.seed,
                            record_every=args.record_every,
                            population=population)
        jpath = journal_path(warm_start.cache_dir, meta)
        shards = journal_shards(warm_start.cache_dir, meta)
        if args.resume and not (os.path.exists(jpath) or shards):
            ap.error(f"--resume: no journal for this sweep "
                     f"configuration ({jpath})")
        # merge= folds a fleet's per-host shards of the same sweep into
        # the resumed completed-set
        journal = SweepJournal(jpath, meta, resume=args.resume,
                               merge=shards if args.resume else ())
        if args.resume:
            print(f"# resume: journal lists "
                  f"{len(journal.completed)} completed rows; "
                  f"replaying against the row cache",
                  file=sys.stderr)
    t0 = time.perf_counter()
    if args.fabric:
        if args.hosts:
            spawn_local_fleet(args, args.hosts)
        rows, info = merge_fabric(
            grid, peers=args.peers, segments=args.segments,
            watch_s=args.watch_s, live=args.live, seed=args.seed,
            fabric_dir=args.fabric, warm_start=warm_start,
            chunk=args.chunk, device=dev)
    else:
        rows, info = engine(
            grid, peers=args.peers, segments=args.segments,
            watch_s=args.watch_s, live=args.live, seed=args.seed,
            chunk=args.chunk, record_every=args.record_every,
            warm_start=warm_start, faults=faults, journal=journal,
            trace=trace, population=population, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    n_compiles = probe.compiles

    # the timeline blocks ride the rows out of the engine but never
    # enter the frontier table or the artifact
    timelines = [row.pop("_timeline", None) for row in rows]
    if args.timelines_out:
        columns = timeline_columns(
            build_config(args.peers, args.segments, args.live,
                         grid[0]["degree"],
                         n_cohorts=(len(population.cohorts)
                                    if population is not None else 0)))
        lines = []
        for row, tl in zip(rows, timelines):
            if tl is None:
                continue  # a failed point computed no timeline
            lines.append(json.dumps({
                **{k: v for k, v in row.items()
                   if k not in ("offload", "rebuffer")},
                "offload": row["offload"],
                "rebuffer": row["rebuffer"],
                "record_every": args.record_every,
                **({"cohorts": list(population.cohort_names)}
                   if population is not None else {}),
                "columns": list(columns),
                # full precision: the last sample is the final-state
                # metric pair the row rounds
                "samples": [[float(v) for v in sample]
                            for sample in tl],
            }))
        atomic_write_text(args.timelines_out,
                          "".join(line + "\n" for line in lines))
        print(f"# wrote {len(lines)} timelines "
              f"({len(columns)} columns) to {args.timelines_out}",
              file=sys.stderr)

    failed = [row for row in rows if row.get("failed")]
    rows.sort(key=lambda r: (r["offload"] is None,
                             -(r["offload"] or 0.0),
                             r["rebuffer"] or 0.0))
    if args.json:
        for row in rows:
            print(json.dumps(row))
    else:
        knob_names = [k for k in rows[0]
                      if k not in ("offload", "rebuffer", "failed")]
        header = " | ".join(f"{k:>15}" for k in knob_names
                            + ["offload", "rebuffer"])
        print(header)
        print("-" * len(header))
        for row in rows:
            print(" | ".join(f"{row.get(k)!s:>15}" for k in knob_names
                             + ["offload", "rebuffer"]))
    if args.fabric:
        mode = f"fabric x{len(info['fabric']['hosts'])} hosts"
    else:
        mode = "sequential" if args.sequential else "batched"
    chunk_note = ("" if args.sequential else
                  f", chunk {info['chunk']}"
                  f"{' (autotuned)' if info['chunk_autotuned'] else ''}")
    summary = (f"{len(rows)} grid points x {args.peers} peers x "
               f"{args.watch_s:.0f}s in {elapsed:.1f}s "
               f"({len(rows) / elapsed:.2f} points/s, {mode} engine, "
               f"{n_compiles} builds + captures{chunk_note}; "
               f"{dev.type})")
    print(f"# {summary}", file=sys.stderr)
    if warm_start is not None:
        ws = warm_start.summary()
        print(f"# warm start: kernel libraries {ws['executable']} rows "
              f"{ws['row']} (cache {ws['cache_dir']}; "
              f"--no-row-cache / --no-warm-start opt out)",
              file=sys.stderr)
    fault_counts = faults.fault_counts()
    if fault_counts or failed:
        detail = ", ".join(f"{k}={v}"
                           for k, v in sorted(fault_counts.items()))
        print(f"# dispatch faults: {detail or 'none'}; "
              f"{len(failed)} point"
              f"{'s' if len(failed) != 1 else ''} failed "
              f"(failed rows carry offload/rebuffer null; rerun "
              f"with --resume to retry just those)",
              file=sys.stderr)
    if args.out:
        platform, kind = device_identity(dev)
        atomic_write_json(args.out, {
            "meta": {
                "peers": args.peers, "segments": args.segments,
                "watch_s": args.watch_s, "live": args.live,
                "elapsed_s": round(elapsed, 1),
                "grid_points": len(rows),
                "points_per_sec": round(len(rows) / elapsed, 3),
                "engine": mode,
                "chunk": info.get("chunk"),
                "chunk_autotuned": info.get("chunk_autotuned"),
                "compile_groups": n_compiles,
                "record_every": args.record_every or None,
                "platform": platform,
                "device_kind": kind,
                "warm_start": (warm_start.summary()
                               if warm_start is not None else None),
                "resume": bool(args.resume),
                **({"population": population.to_json()}
                   if population is not None else {}),
                "dispatch_faults": fault_counts,
                "failed_points": len(failed),
                "failures": info.get("failures", []),
                **({"fabric": info["fabric"]}
                   if "fabric" in info else {}),
            },
            "rows": rows,
        })
        print(f"# wrote {args.out}", file=sys.stderr)
    if journal is not None:
        # finalize only a fully successful sweep: failed points were
        # never journaled, so --resume retries exactly those
        if not failed:
            journal.finalize()
        journal.close()
    if trace is not None:
        trace.close()
        print(f"# trace: event shard {trace.path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
