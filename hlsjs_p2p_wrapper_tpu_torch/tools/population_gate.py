"""Population-plane gate on the port: one seeded spec, provably.

The reference's ``tools/population_gate.py`` (the four spec builders
:60-104, ``run_rows``, ``check_degenerate``, ``check_mixture_group``,
``digest_child`` with ``check_determinism``, ``check_frontier`` and
``main``, :105-318) on the port's ``sweep_grid.py``, ``tools.sweep``
(``run_grid_batched``) and ``engine/population.py``.  The
heterogeneous-population subsystem makes four promises this gate holds
at process level:

1. **Degenerate bit-identity** — a single-cohort, all-inherit population
   run through BOTH shipped grids (48-pt VOD, 144-pt live; ``tools.sweep
   --population``) reproduces the homogeneous path's rows BIT-EXACTLY
   (``float.hex`` on ``run_grid_batched(raw=True)``), in the same number
   of dispatch groups.
2. **One compile group** — a two-cohort mixture swept across its
   ``mix_fractions`` axis stays ONE dispatch group
   (``info["compile_groups"]``, the groups ``run_grid_batched``
   dispatched: cohort membership, rates, connectivity and device caps
   are all scenario DATA).  On the port this counts dispatch groups,
   not ``CompileCounter``'s builds + captures.
3. **Cross-process determinism** — the same spec + seed materializes to
   byte-identical arrays (``population_digest``) in two separate
   interpreter processes (``testing/tool_child.py`` processes started by
   :func:`prepare`, run beside checks 1 and 2; ``testing/tool_child.py
   population_gate --prepare`` starts them beside its own start).
4. **The mixture is a different WORKLOAD** — a two-cohort
   constrained-uplink mixture (half the audience CDN-only cellular)
   produces an offload/rebuffer frontier measurably OUTSIDE its
   homogeneous-mean equivalent's (max per-point offload delta ≥
   :data:`FRONTIER_BAR`).

   4b. The flash-crowd + regional-partition population survives the
   twin's real-protocol plane: the same ``TwinScenario`` runs through
   the port's copy of the real plane (``testing/twin.py``
   ``run_real_plane``, host Python: the agent swarm, the tracker and
   the loopback wire), its partition windows driven on the wire through
   the shared ``NetFaultPlan`` grammar (``engine/netfaults.py``).
   Asserted, as the reference does: every window closed, **the
   partition fired on the wire** (``mesh.transport_faults{kind=
   partition}`` ≥ 1), offload in [0, 1] with rebuffer ≥ 0, and the
   crowd fully present.

The gate makes no compile claim.  The simulator runs in the gate's own
process; its builds, captures and launches are the process's.

Sizes are CPU gate defaults; ``POPULATION_GATE_PEERS``,
``POPULATION_GATE_SEGMENTS``, ``POPULATION_GATE_WATCH_S`` and
``POPULATION_GATE_CHUNK`` scale them.

Run: ``python -m hlsjs_p2p_wrapper_tpu_torch.tools.population_gate
[--device cpu]`` (exit 1 on any violation).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import WaitingTool, add_device_flag, json_records, open_device
from ..engine.population import (Arrival, Cohort, Dist, PopulationSpec,
                                 fault_specs_from, load_spec, materialize,
                                 population_digest)

#: the checkout's root, the children's working directory
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

EXAMPLE_SPEC = os.path.join(_ROOT, "examples",
                            "population_cellular_broadband.json")

#: check 4's acceptance bar: the mixture's best-offload frontier
#: point must sit at least this far from the homogeneous-mean
#: equivalent's (the reference measured ~0.07-0.14 at the gate shape;
#: half of the worst measured headroom)
FRONTIER_BAR = 0.05

#: check 3's children (:func:`prepare`)
_PREPARED: list = []

def degenerate_spec() -> PopulationSpec:
    """ONE cohort, everything inherited: the population that must be
    indistinguishable — bit-for-bit — from no population at all."""
    return PopulationSpec(name="degenerate", seed=0,
                          cohorts=(Cohort(name="all", fraction=1.0),))


def mixture_spec() -> PopulationSpec:
    """Check 4's constrained-uplink mixture: half broadband (open,
    4 Mbps up), half cellular behind symmetric NAT (CDN-only,
    0.4 Mbps up it can never donate)."""
    return PopulationSpec(name="gate_mixture", seed=3, cohorts=(
        Cohort(name="broadband", fraction=0.5,
               uplink_bps=Dist(value=4.0e6)),
        Cohort(name="cellular", fraction=0.5,
               uplink_bps=Dist(value=0.4e6),
               connectivity="cdn_only")))


def homogeneous_mean_spec() -> PopulationSpec:
    """The mixture's homogeneous-mean equivalent: every peer open at
    the mixture's mean uplink (0.5·4.0 + 0.5·0.4 = 2.2 Mbps)."""
    return PopulationSpec(name="gate_homog_mean", seed=3, cohorts=(
        Cohort(name="mean", fraction=1.0,
               uplink_bps=Dist(value=2.2e6)),))


def crowd_partition_spec() -> PopulationSpec:
    """Check 4b's scenario: a staggered base audience, a flash-crowd
    cohort landing in one wave, and a regional-partition window (which
    the real plane drives on the wire through the shared NetFaultPlan
    grammar).  Every cohort stays "open"."""
    return PopulationSpec(
        name="gate_crowd_partition", seed=11,
        cohorts=(
            Cohort(name="base", fraction=0.6,
                   arrival=Arrival(kind="staggered", at_s=0.5,
                                   window_s=28.0)),
            Cohort(name="crowd", fraction=0.4,
                   arrival=Arrival(kind="wave", at_s=33.0,
                                   window_s=1.0))),
        partitions=((40.0, 52.0),))


def frontier_grid():
    """Check 4's two points: the urgent margin at 0.5 s and 4 s."""
    return [dict(degree=8, ladder="hd", spread_s=0.0,
                 urgent_margin_s=u, budget_cap_ms=6_000.0,
                 uplink_mbps=2.2, cdn_mbps=1.2)
            for u in (0.5, 4.0)]


def crowd_scenario():
    """Check 4b's ``TwinScenario``."""
    from ..testing.twin import TwinScenario
    spec = crowd_partition_spec()
    return TwinScenario(seed=spec.seed, n_peers=8, wave_peers=4,
                        frag_count=20, watch_s=64.0, window_s=8.0,
                        population=spec)


def run_rows(grid, sizes, *, live, population=None, device=None, **kw):
    from . import sweep as sweep_tool
    return sweep_tool.run_grid_batched(
        grid, peers=sizes["peers"], segments=sizes["segments"],
        watch_s=sizes["watch_s"], live=live, seed=0,
        chunk=sizes["chunk"], raw=True, population=population,
        device=device, **kw)


def check_degenerate(sizes, device):
    """Check 1 + the degenerate half of check 2."""
    from .. import sweep_grid
    problems = []
    spec = degenerate_spec()
    for name, live in (("vod", False), ("live", True)):
        grid = (sweep_grid.live_grid() if live
                else sweep_grid.vod_grid())
        plain, info_p = run_rows(grid, sizes, live=live, device=device)
        pop, info_d = run_rows(sweep_grid.population_grid(grid, spec),
                               sizes, live=live, population=spec,
                               device=device)
        hex_plain = [(r["offload"].hex(), r["rebuffer"].hex())
                     for r in plain]
        hex_pop = [(r["offload"].hex(), r["rebuffer"].hex())
                   for r in pop]
        if hex_plain != hex_pop:
            diverged = sum(1 for a, b in zip(hex_plain, hex_pop)
                           if a != b)
            problems.append(
                f"{name}: degenerate population diverged from the "
                f"homogeneous path at {diverged}/{len(hex_plain)} "
                f"grid points (must be float.hex bit-identical)")
        if info_d["compile_groups"] != info_p["compile_groups"]:
            problems.append(
                f"{name}: degenerate population compiled "
                f"{info_d['compile_groups']} groups vs the "
                f"homogeneous path's {info_p['compile_groups']}")
        print(f"population-gate degenerate {name}: "
              f"{len(hex_plain)} points bit-identical="
              f"{hex_plain == hex_pop}, groups "
              f"{info_d['compile_groups']}")
    return problems


def check_mixture_group(sizes, device):
    """Check 2: the committed example spec's full mixture axis stays
    one dispatch group on a sampled grid slice."""
    from .. import sweep_grid
    spec = load_spec(EXAMPLE_SPEC)
    grid = sweep_grid.population_grid(
        sweep_grid.sample_grid(sweep_grid.vod_grid(), 4), spec)
    rows, info = run_rows(grid, sizes, live=False, population=spec,
                          device=device)
    print(f"population-gate mixture: {len(rows)} points "
          f"({len(spec.mix_fractions)} fractions) in "
          f"{info['compile_groups']} compile group(s)")
    if info["compile_groups"] != 1:
        return [f"mixture grid compiled {info['compile_groups']} "
                f"groups — cohort mixtures must be dynamic scenario "
                f"data (ONE group)"]
    return []


def digest_child():
    """Subprocess body for check 3: materialize the committed
    example spec and print its content digest."""
    spec = load_spec(EXAMPLE_SPEC)
    pop = materialize(spec, 4096, n_levels=3,
                      default_uplink_bps=2.4e6,
                      default_cdn_bps=1.2e6)
    print(json.dumps({"digest": population_digest(pop),
                      "counts": pop.cohort_counts()}))
    return 0


def prepare():
    """Check 3's two interpreters, started now and waiting for their
    argv."""
    if not _PREPARED:
        _PREPARED.extend(WaitingTool("population_gate", _ROOT)
                         for _ in range(2))
    return _PREPARED


def check_determinism(children):
    """Check 3: two separate interpreters, one digest."""
    outs = []
    for child in children:
        rc, out, err = child.wait()
        if rc != 0:
            return [f"digest child failed:\n{out}\n{err}"]
        outs.append(next(r for r in json_records(out) if "digest" in r))
    print(f"population-gate determinism: digests "
          f"{outs[0]['digest'][:16]}… == "
          f"{outs[1]['digest'][:16]}… -> "
          f"{outs[0]['digest'] == outs[1]['digest']}")
    if outs[0]["digest"] != outs[1]["digest"]:
        return ["same-seed spec materialized to DIFFERENT arrays in "
                "two processes — the determinism contract is broken"]
    return []


def frontier_rows(sizes, device):
    """Check 4's rows: the mixture's and the homogeneous mean's on
    :func:`frontier_grid`, each ``(rows, info)``."""
    grid = frontier_grid()
    kw = dict(live=False, stagger_s=sizes["frontier_stagger_s"],
              device=device)
    sizes = dict(sizes, watch_s=sizes["frontier_watch_s"])
    return (run_rows(grid, sizes, population=mixture_spec(), **kw)[0],
            run_rows(grid, sizes, population=homogeneous_mean_spec(),
                     **kw)[0])


def check_frontier(sizes, device):
    """Check 4: the constrained-uplink mixture's frontier sits
    measurably outside its homogeneous-mean equivalent's."""
    rows_mix, rows_mean = frontier_rows(sizes, device)
    deltas = [abs(m["offload"] - h["offload"])
              for m, h in zip(rows_mix, rows_mean)]
    best_mix = max(r["offload"] for r in rows_mix)
    best_mean = max(r["offload"] for r in rows_mean)
    print(f"population-gate frontier: mixture best offload "
          f"{best_mix:.4f} vs homogeneous-mean {best_mean:.4f} "
          f"(max per-point delta {max(deltas):.4f}, bar "
          f"{FRONTIER_BAR})")
    if max(deltas) < FRONTIER_BAR:
        return [f"the two-cohort mixture's frontier is "
                f"indistinguishable from its homogeneous-mean "
                f"equivalent (max offload delta {max(deltas):.4f} < "
                f"{FRONTIER_BAR}) — the population plane is not "
                f"changing the workload"]
    return []


def check_real_plane():
    """Check 4b: flash crowd + regional partition through the
    real-protocol plane, partitions firing via NetFaultPlan."""
    from ..engine.netfaults import NetFaultPlan
    from ..testing.twin import run_real_plane
    scenario = crowd_scenario()
    spec = scenario.population
    problems = []
    fault_specs = fault_specs_from(spec)
    # the grammar itself must parse (the shared-plan contract)
    NetFaultPlan.parse(fault_specs, seed=spec.seed)
    result = run_real_plane(scenario)
    frames = result.registry_frames
    fired = result.transport_faults.get("partition", 0)
    print(f"population-gate real plane: {frames.n_windows} windows, "
          f"offload {result.offload:.4f}, rebuffer "
          f"{result.rebuffer:.4f}, partition faults {fired}")
    if frames.n_windows != scenario.n_windows:
        problems.append(
            f"real plane closed {frames.n_windows} windows, "
            f"expected {scenario.n_windows} — the run did not "
            f"survive the crowd+partition scenario")
    if fired < 1:
        problems.append(
            "the spec's partition window never fired on the wire "
            "(mesh.transport_faults{kind=partition} == 0) — the "
            "shared NetFaultPlan grammar is not being honored")
    if not (0.0 <= result.offload <= 1.0) or result.rebuffer < 0.0:
        problems.append(
            f"real-plane metrics are not sane under the partition "
            f"(offload {result.offload}, rebuffer "
            f"{result.rebuffer})")
    # the crowd cohort must actually be present: the last window's
    # membership covers the whole audience
    presents = frames.column("present_peers") \
        if "present_peers" in frames.columns else None
    if presents is not None and max(presents) < scenario.total_peers:
        problems.append(
            f"crowd cohort never fully joined (peak membership "
            f"{max(presents)}/{scenario.total_peers})")
    return problems


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--digest-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--peers", type=int, default=int(
        os.environ.get("POPULATION_GATE_PEERS", 64)))
    ap.add_argument("--segments", type=int, default=int(
        os.environ.get("POPULATION_GATE_SEGMENTS", 16)))
    ap.add_argument("--watch-s", type=float, default=float(
        os.environ.get("POPULATION_GATE_WATCH_S", 10.0)))
    ap.add_argument("--chunk", type=int, default=int(
        os.environ.get("POPULATION_GATE_CHUNK", 24)))
    add_device_flag(ap)
    return ap


def gate_sizes(args) -> dict:
    return {"peers": args.peers, "segments": args.segments,
            "watch_s": args.watch_s, "chunk": args.chunk,
            # check 4 needs enough presence for a P2P ramp: a
            # longer watch over a tighter join stagger
            "frontier_watch_s": max(args.watch_s, 20.0),
            "frontier_stagger_s": 8.0}


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    dev = open_device(ap, args.device)

    if args.digest_child:
        return digest_child()

    sizes = gate_sizes(args)
    digests = prepare()
    for child in digests:
        child.go(["--digest-child", "--device", args.device])
    problems = []
    walls = {}
    try:
        for name, check in (
                ("degenerate", lambda: check_degenerate(sizes, dev)),
                ("mixture", lambda: check_mixture_group(sizes, dev)),
                ("determinism", lambda: check_determinism(digests)),
                ("frontier", lambda: check_frontier(sizes, dev)),
                ("real_plane", check_real_plane)):
            t0 = time.perf_counter()
            problems.extend(check())
            walls[name] = round(time.perf_counter() - t0, 3)
        print(f"population-gate walls (s): {json.dumps(walls)}")
    finally:
        for child in digests:
            child.stop()
        _PREPARED.clear()
    for problem in problems:
        print(f"population-gate: {problem}", file=sys.stderr)
    print(f"# population-gate: "
          f"{'PASS' if not problems else 'FAIL'} "
          f"(degenerate bit-identity on both shipped grids, "
          f"one-group mixture, cross-process determinism, "
          f"mixture-vs-mean frontier, real-plane crowd+partition; "
          f"{args.peers} peers, {args.device})", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
