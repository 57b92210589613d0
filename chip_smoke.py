#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit: ``python3 chip_smoke.py``.  Phases, in order; any failure
exits nonzero:

1. the card and the toolchain (``nvidia-smi``, torch, CUDA, ``nvcc``);
2. build the kernels from ``hlsjs_p2p_wrapper_tpu_torch/csrc/`` and
   print each one's registers and spills, and of every instantiation of
   the gather kernels its resident blocks an SM;
3. each kernel against its plain PyTorch version on the card, at
   1,048,576 peers × 256 segments, from a state the plain path reached
   after 300 steps (``peer_update`` with the offload sums and the clock
   advance of its epilogue, against ``peer_update_plain`` then
   ``lane_sums_plain``, its sums against ``lane_sums``' and
   ``lane_sums_in_order``'s to the bit, its clock against ``t_s + dt``
   to the bit);
4. the routes of ``select_admit`` away from the main path: the fused
   kernel where its tiles wrap the ring (16 peers with the ring of 8,
   96 peers with a ring of 12, 1,000 peers with the ring of 8, whose
   last tile and last ``peer_update`` block are partial) and the TK1 +
   TK2 route of a wide offset tuple, each stepped beside the plain
   step, launches checked, ``peer_update`` and its sums against plain
   at each; then, at the main path's size, the fused kernel at halos of
   8, 16, 24 and 32 peers (the widest it takes) against its plain
   version and timed against TK1 + TK2, which sets the route's span
   limit;
5. the main path — ``run_swarm`` at 262,144 peers × 256 segments ×
   2,400 steps, the configuration of ``bench.py``'s headline — replayed
   as CUDA graphs of ``select_admit`` and ``peer_update``, with the
   launch counts checked; the same run through the eager loop
   (``_scan_eager``) equal to the bit, runs of the two in turns timed
   by the host clock (a graph run's captures timed apart from its
   replays), and each traced with ``torch.profiler``, which shows fewer
   device ops besides the kernels than steps (the clock advances inside
   ``peer_update``: a step is two graph nodes); then,
   from the final state, each kernel against its plain version, each
   pass timed with CUDA events on the main path's route and on the TK1
   + TK2 route; last (the children of phases 35 and 38 start beside
   it) the same run on the plain path, its ratios and offload series
   held to the kernels' run's;
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
   128 segments × 960 steps with a timeline row every 40 steps, joins
   and ranks drawn by the port (the reference's threefry draws), through
   ``run_batch_chunked`` with the autotuned chunk, launches checked, 36
   points stalling as in the reference's ``SWEEP_1M_r05.json``; then
   chunk 16 with a warm start on a fresh root and a journal (48 rows
   stored, 48 keys journaled, the journal finalized), one direct 48-lane
   ``run_swarm_batch`` and the same batch
   through the eager loop give the same rows, series and timelines to
   the bit, two lanes run alone give their lanes' to the bit, each last
   timeline row and last series entry equal the final ratios; then the
   direct 48-lane run traced whole (graphs and eager loop), 80 eager
   steps from its final state traced per kernel, and the two
   reductions timed against their plain versions and ``torch.sum``;
10. ``lane_sums`` on random byte counters at 1,000, 1,001, 262,144 and
   1,048,576 peers × 1, 4 and 48 lanes against its plain version, the
   bits of ``lane_sums_in_order`` and each lane alone;
11. live mode's kernels: four lanes of the live grid (points 15, 43, 107
   and 136) at 1,048,576 peers × 128 segments, at t = 60 s (the crowd
   joins) and 6 plain steps later, ``select_admit``, TK1 + TK2 (on the
   ring and on a wide offset tuple) and ``peer_update`` against their
   plain versions, with every live branch shown to bind (floored
   joiners, the playback cushion, the stagger, the announce lag);
12. the port's live run against the committed live fixture (the JAX
   reference's ``run_swarm_batch`` over those four points);
13. the live sweep: all 144 points of ``live_grid()`` at 1,048,576
   peers × 128 segments × 960 steps, a row every 40 steps, through
   ``run_batch_chunked`` with the autotuned chunk (64, 64, 16), launches
   checked, each last row its final ratios, the last 32 points in one
   chunk equal to the bit, and the rows held to the reference's record
   ``SWEEP_LIVE_1M_r05.json`` after its rounding (at the points that
   ``tools/torch_port_live_anchor.py`` re-ran, to the reference at
   HEAD): the same stalling count, the largest difference bounded;
14. a 64-lane live chunk run as graphs and traced whole (idle share),
   80 eager steps from its final state traced per kernel, with each
   kernel's bytes and bound;
15. prefetch slots: the step kernels with three transfer slots
   (``select_admit``, TK1 + TK2 on the ring and on a wide offset tuple,
   ``peer_update``) against their plain versions on the prefetch
   fixture's four cells at 1,048,576 peers × 128 segments, at t = 25 s
   (a departure wave leaves) and 6 steps later, every prefetch branch
   shown to bind (absorb, the dedup guard, each abort kind, the
   cooldown, the attempt rotation); then the generic instantiation at 2
   and 16 slots;
16. the port's run against the committed prefetch fixture (the JAX
   reference's ``run_swarm_batch`` over those cells with three slots);
17. the spread column of ``tools/policy_ab.py``'s ring table: 20 cells ×
   262,144 peers × 128 segments × 960 steps, three slots, through
   ``run_batch_chunked`` with a ``FaultPolicy`` armed and the autotuned
   chunk, launches checked, a direct run of the 20 lanes equal (each
   last series entry its final offload), two cells alone equal to the
   bit, and the rows held to the reference's record
   ``POLICY_AB_r05.json`` after its rounding (at the cells that
   ``tools/torch_port_policy_anchor.py`` re-ran, to the reference at
   HEAD);
18. that chunk run as graphs and traced whole (idle share), 80 eager
   steps from its final state traced per kernel, with bytes and bound;
19. injected faults on the ring grid in chunks of 4 (retries, a
   recursive bisection, an exhausted budget): rows equal the unfaulted
   run's to the bit, the reference's counts, a structured failure;
20. a real CUDA out-of-memory: the allocator capped so that the 48-point
   VOD grid's one chunk cannot fit but its halves can; without a policy
   it raises (where the failing allocation landed is printed), with a
   ``FaultPolicy`` it bisects and returns phase 9's rows to the bit;
21. after the cap is lifted, phase 16's run again: the card is usable;
22. the "adaptive" and "ranked" holder policies' kernels: each policy at
   three slots and at one, VOD, and at three slots live, on the prefetch
   fixture's four cells at 1,048,576 peers × 128 segments, at t = 25 s
   and 6 steps later, ``select_admit``, TK1 + TK2 (on the ring and on a
   wide offset tuple) and ``peer_update`` against their plain versions
   (the penalty window to the bit), every policy branch shown to bind
   (adaptive's tier moving the pick off spread's, its own-load key and
   its penalty window each excluding a holder, the window re-armed at a
   foreground deny and at each prefetch abort kind, ranked's skip at
   each of its values); then both policies at 16 and 1,000 peers, where
   ranked picks by peer id across the ring's wrap, one call and 20
   steps against the plain step;
23. the port's runs against the committed policies fixture (the JAX
   reference's ``run_swarm_batch`` over the prefetch fixture's cells
   under each policy);
24. the adaptive and ranked columns of ``tools/policy_ab.py``'s ring
   table, each as phase 17 runs the spread column (20 cells × 262,144 ×
   128 × 960, three slots, the autotuned chunk, launches checked, a
   direct run and two cells alone equal to the bit, the rows within
   RING_ROW_TOL of ``POLICY_AB_r05.json`` and equal to HEAD's reference
   at the anchored cells);
25. each policy's chunk traced as phase 18 traces the spread one;
26. the general ``[P, K]`` path's gather kernels (TK1, TK2 and TK3 in
   their gather forms) against their plain versions on ``tools/
   policy_ab.py``'s random mesh: the prefetch fixture's four cells at 4
   × 262,144 peers × 128 segments, each policy at three slots, VOD and
   live, and spread uncapped, at t = 25 s and 6 steps later; then each
   policy on meshes of 16 peers (degree 20: every row padded), 1,000
   (degree 8 padded to 10) and 48 (degree 32: inbound rows up to 40
   edges, two mask words of ``admit_gather``), 80 steps of the kernels
   in, one call and 20 steps against the plain step; the line ``gather
   branches over every state`` must show padding, inbound edges walked
   beyond K and beyond 32, denied and over-cap demands nonzero; then the
   ring uncapped at the main path's shape (the fused kernel, TK1 + TK2,
   TK3), with the demands a cap would have denied;
27. the port's runs against the committed general fixture (the JAX
   reference's ``run_swarm_batch`` over the prefetch fixture's cells on
   the random mesh: spread and adaptive capped, ranked uncapped);
28. the random half of ``tools/policy_ab.py`` at the tool's size, each
   policy: 20 cells × 8,192 peers × 128 × 960, three slots, one chunk,
   a ``FaultPolicy`` armed, launches checked (three gather kernels a
   step), a direct run and two cells alone equal to the bit, the rows
   within RANDOM_ROW_TOL of ``POLICY_AB_r05.json``'s random table after
   its rounding and equal to HEAD's reference at the cells of
   RANDOM_ANCHOR (``tools/torch_port_policy_anchor.py --topology
   random``); each chunk traced as phase 18 traces the ring's, with the
   gather kernels' CUDA-event and plain times;
29. the same at 262,144 peers, the size a user runs on this card (no
   record: its checks are phase 26's and the lanes alone equal to the
   batch), with grid wall, cells/s, peer-steps/s, peak memory, the idle
   share and each gather kernel's times, bytes and bound;
30. the population plane (``engine/population.py``): the step kernels
   against their plain versions under the example population
   (``examples/population_cellular_broadband.json`` at mix 0.5) at t =
   62 s, after the cellular wave: the sweep's VOD and live lanes at 4 ×
   1,048,576, three slots on the ring under each policy at 4 × 1,048,576
   and on the random mesh under adaptive at 4 × 262,144, with the line
   ``population fields binding over every case`` showing requesters and
   holders gated off P2P, picks clipped by the ladder cap, foregrounds
   urgent only by the cohort's offset and session departures nonzero;
31. the port's runs against the committed population fixture (the JAX
   reference with the example population over three VOD mixture points
   and a live one, with the cohort columns);
32. the mixture grid (``tools/sweep.py --population``): the 48-point VOD
   grid crossed with the spec's mix fractions, 144 points × 1,048,576 ×
   128 × 960, a row every 40 steps with the cohort columns, through
   ``run_groups_chunked`` with the autotuned chunk and a ``FaultPolicy``
   armed: one dispatch group, launches checked, the cdn_only cohort's
   offload 0 in every row, every row's cohort peers summing to its level
   counts, the points of POPULATION_ANCHOR within POPULATION_ROW_TOL of
   HEAD's reference (``tools/torch_port_population_anchor.py``); its
   first 48 points as one direct run equal to the dispatch's rows, the
   cdn_only cohort's P2P bytes 0, traced (idle share, busy ms a step,
   the per-kernel split);
33. TK5's cohort instantiation (``timeline_row_cohorts``) against its
   plain version: on that run's final state one interval on, with the
   spec's 2 cohorts and 8 seeded labels, the stall digest off and on,
   and at 16 and 1,000 peers; counts equal, ratios within REDUCE_RTOL,
   lanes alone equal to their batched rows to the bit; timed beside the
   instantiation without cohorts;
34. the degenerate population (one cohort, everything inherited) at 4
   sampled points of the VOD and the live grid at 1,048,576 peers:
   offload and rebuffer equal the homogeneous rows to the bit;
35. (its children started beside phase 5's plain run, each importing
   torch and waiting, without touching the card, until phase 9 and its
   trace are done; run after them) the crash-safe
   journal and the row cache across processes: phase 9's grid swept by
   three children (``testing/resumable_sweep.py``, chunks of 16), the
   killed one under ``kill@0:2`` on a fresh root (it dies by SIGKILL with
   chunk 0's 16 rows journaled and no ``done`` line), then the resumed
   one on its root, collected after phases 10-12 run beside it (the 16
   rows served as hits, the other 32 dispatched, all 48 equal to phase
   9's to the bit, the journal finalized), and, while the killed one
   sweeps, the warm one on phase 9's root (48 hits, nothing built or
   captured, no kernel launched), each with its wall and its
   prefilter's seconds;
36. the flight recorder: phase 9's grid once more through
   ``run_batch_chunked`` in chunks of 16 with ``trace=`` (a
   ``FlightRecorder`` on the warm start's registry), ``tracer=`` (a
   ``SpanRecorder``), one injected transient fault and a fresh row cache
   and journal: rows equal to phase 9's to the bit, one finalize event a
   journaled row, the ``dispatch_faults`` and ``aot_cache_events``
   counters replayed from the shard exactly, the retry's event in its
   ``(group, chunk, attempt)`` context; then warm: 48 cached row events
   and no dispatch span, nothing built, captured or launched;
37. the policy search (``search_eval``, ``engine/search.py``):
   ``tools/optimize.py``'s halving search with its defaults over the
   144-point live lattice at 1,048,576 peers × 128 segments × 960
   steps, in chunks of phase 13's autotuned width,
   stopped as its second round asks and resumed
   from its checkpoint in this process (the same seed on its warm start
   is phase 42's ``tools.optimize``);
38. the fabric (``engine/fabric.py``): phase 9's grid shared by three
   ``testing/fleet_worker.py`` processes (started beside phase 5's plain
   run, each touching the card only now) through one ``WorkLedger`` in
   units of 8, each traced and journaled on its own shard: host01
   SIGKILLed as it claims its second unit, host02 stalled past its lease
   as it claims its second, so that host00 steals that unit (and
   host01's) and host02 finishes it second; each unit's dispatch shorter
   than the lease; the merged rows (the killed host's
   finalized rows read back from the row cache) equal to phase 9's to the
   bit, the survivors' ``fabric_claims`` equal to ``fleet_report``'s
   reading of the claim files, one finalize event a journaled row on
   every shard, the survivors' counters replayed from their shards;
39. the twin's sim half (``testing/twin.py``) on the card, against the
   committed control fixture (``testing/reference_control/``, from
   ``tools/torch_port_twin_fixture.py``): ``run_sim_plane`` of the clean
   and chaos scenarios of ``tools/twin_gate.py`` (8 + 4 peers, 160 s:
   the general path at K = 11, three slots, spread, the stall digest, a
   timeline row a frame window) inside the ``TWIN_r10.json`` bands
   against the reference's real-plane frames (``compare_frames`` finds
   nothing), peer counts equal to the reference's sim frames and the
   rest within 1e-5 relative + 1e-6; the clean wave shifted by two
   windows found first at the wave window on the membership columns;
   33 peers (K = 32, the widest list the kernels take) on the card and
   on the CPU path, frames agreeing; 34 peers refused on the card
   (``ValueError``);
40. the controller (``engine/controller.py``) on the card:
   ``ControlLoop(device="cuda")`` replays the control gate's recorded
   chaos shard under config (a) with a ``LogActuator``, a
   ``FlightRecorder`` and a ``WarmStart`` on a fresh root: decisions
   equal to the reference's (``decision_sig``), every forecast row within
   1e-4 of its, one ``control_tick`` mark a window and one
   ``actuation`` mark an epoch, each epoch once in the actuation log;
   a second loop on the same root equal with no row dispatched and no
   kernel launched; a loop stopped by ``tick_gate`` after its first
   actuation and a fresh one ``resume()``d from its checkpoint equal,
   each epoch once in their log; the median tick phases;
41. the fleet form, config (b) (SLO-armed, ``tools/fleet_control_gate.
   py``): the shard split four ways (``split_shard``) and replayed,
   decisions and SLO burn windows equal to the reference's; the one
   shard on the same row cache equal.
42. the port's tools (``hlsjs_p2p_wrapper_tpu_torch/tools/``) as child
   processes on the card, side by side (``testing/tool_child.py``: each
   started beside phase 3, importing torch and its tool, then waiting
   without a context on the card for its argv): ``tools.sweep`` on phase
   9's grid (1,048,576 × 128 × 240 s, a row every 40 steps) on a fresh
   warm-start root, every point dispatched, its rows and timelines equal
   to phase 9's to the bit and its ``--out`` artifact with the keys of
   ``SWEEP_1M_r05.json`` and of the reference tool at HEAD (the committed
   tools fixture), ``platform`` gpu; ``tools.optimize`` at phase 37's
   settings on phase 37's root: the same frontier and trials
   (``float.hex``) with no fresh dispatch, build, capture or launch;
   ``tools.policy_ab`` at its defaults (a row every 40 steps): its ring
   rows equal to phases 17 and 24's and its random rows to phase 28's,
   to the bit; each child's wall and kernel launches printed.
43. the port's sweep-side gates (``tools.fleet_gate``,
   ``tools.trace_gate``, ``tools.optimize_gate``,
   ``tools.population_gate``) as child processes on the card, side by
   side (``testing/tool_child.py --prepare``: each started after phase
   38 with its own children, all waiting without a context on the
   card):
   the fleet and trace gates at phase 9's width (1,048,576 × 128 × 240
   s, the 48-point VOD grid in units of 3, a 6-s lease; a SIGKILLed
   host, a host stalled 3 leases, a transient burst), the optimize and
   population gates at their defaults (48 and 64 peers); each must
   print PASS; each gate's wall from its go and its own and its
   children's builds, captures and kernel launches printed.
44. the port's twin and control gates (``tools.twin_gate``,
   ``tools.control_gate``) at their defaults (8 peers plus a wave of 4,
   160 s in 8-s windows) as child processes on the card, side by side,
   each on its own warm-start root (``testing/tool_child.py --prepare``:
   started with phase 43's gates, their own children too, all waiting):
   the real-protocol plane (the agent swarm, the tracker, the loopback
   wire) against the twin's sim plane on the card within
   ``TWIN_r10.json``'s bands, and the controller closing the loop under
   chaos with its forecasts on the card, over the real TCP wire on the
   loopback interface, and across a SIGKILL.  The twin gate must print
   PASS and the control gate every check passed, with 0 ``nvcc`` builds
   in their children; each gate's wall from its go, its stages' walls,
   and its own and its children's builds, captures and kernel launches
   printed.

The last line of standard output is one JSON object
``{"ok": true, "device": {...}}``; the line before it gives the card's
name and power limit, and the ``{"kernels": [...]}`` line the kernels'
launches and times (each step kernel's ``live`` entry: phase 14's
numbers and the live instantiation's registers; its ``prefetch``
entry: phase 18's and the three-slot instantiation's; its ``adaptive``
and ``ranked`` entries: phase 25's and those instantiations'; its
``uncapped`` entry: phase 26's check on the ring; each gather kernel:
phase 29's launches over the three policies and times on the spread
chunk, with an entry per size and policy; ``timeline_row_cohorts``:
phase 32's launches and phase 33's times; each gather kernel,
``lane_sums`` and ``timeline_row``: a ``control_plane`` entry with the
launches of phases 39, 40, 41 and 44).  Without a card, or outside
a checkout, it exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
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
#: the main path's host-clock runs of the graphs and the eager loop, in
#: turns, after the first of each
TURNS = ("graph", "eager", "eager", "graph")
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
#: the reference's run of this grid (a TPU, tools/sweep.py), whose
#: rows are rounded to 4-5 digits; 36 of its 48 rows stall (rebuffer >
#: 0, the least 0.00119), and the port, drawing the same joins, must
#: stall at the same count
REFERENCE_SWEEP = "SWEEP_1M_r05.json"
REFERENCE_STALLING_ROWS = 36
#: the lanes run alone against their batched lanes: the first point
#: (scarce supply, stalls) and the last (ample supply)
ALONE_LANES = (0, 47)
#: the warm-start roots of phases 9 and 35 (A: phase 9's chunk-16 pass,
#: then the warm child; B: the killed and the resumed child), made anew
#: each run, and the children's standard error
WARM_DIR = os.path.join(ROOT, "build", "torch_warm_start")
#: the killed child dies as chunk 2 of its 16-point chunks dispatches;
#: the drain runs one chunk behind the dispatch, so chunk 0's 16 rows
#: are journaled by then and chunk 1's are not
KILL_PLAN = "kill@0:2"
KILLED_ROWS = 16
#: phase 36: phase 9's grid again, traced, with one transient fault
#: injected as chunk 1 dispatches (a retry inside its attempt context)
TRACE_FAULTS = "transient@0:1x1"
#: phase 38: three fabric workers (testing/fleet_worker.py) share phase
#: 9's grid in units of FLEET_CHUNK points, as the reference's fleet gate
#: runs them: host01 is SIGKILLed as it claims its second unit; host02
#: sleeps FLEET_STALL_S holding its second claim, whose FLEET_LEASE_S
#: lease (longer than a unit's dispatch, captures included, with three
#: hosts on the card) expires so that host00 steals it.  host00 steals
#: host01's unit too, and the two steals end about a lease and two units
#: after host02's claim; host02 wakes after that, so that it finishes
#: its unit second.  (A stall at the first claim would end sooner, but
#: host02 would then compute and journal nothing.)
FLEET_HOSTS = ("host00", "host01", "host02")
FLEET_CHUNK = 8
FLEET_LEASE_S = 6.0
FLEET_STALL_S = 10.0
FLEET_CHAOS = {"host01": "kill@1", "host02": f"stall@1:{FLEET_STALL_S}"}
#: phase 42: the port's tools (hlsjs_p2p_wrapper_tpu_torch/tools/) as
#: child processes (testing/tool_child.py), started after the build,
#: beside phase 3, and waiting, without a context on the card, for their
#: argv; the three run side by side
TOOL_CHILDREN = ("sweep", "policy_ab", "optimize")
TOOLS_DIR = os.path.join(WARM_DIR, "tools")
#: phase 43: the port's sweep-side gates as child processes, started
#: after phase 38 and waiting (each gate's own children too); the four
#: run side by side, after phase 42.  The fleet and trace gates at phase
#: 9's full width (their *_GATE_* knobs) with a lease of GATE_LEASE_S
#: (FLEET_LEASE_S, the shortest shown honest at 1M peers) and units of
#: GATE_CHUNK, the optimize and population gates at their defaults (48
#: and 64 peers)
GATE_CHILDREN = ("fleet_gate", "trace_gate", "optimize_gate",
                 "population_gate")
GATE_LEASE_S = FLEET_LEASE_S
#: units of 3 points (16 a grid): a host's first unit, its capture and
#: the card shared by seven processes at 1M peers, took 4.4-4.6 s beat to
#: beat, against the 6-s lease; at the gates' default 6 a host ran out of
#: units while another's first one outlasted its lease (a third steal)
GATE_CHUNK = 3
GATE_BUDGET_S = 45.0
#: phase 44: the port's twin and control gates as child processes,
#: started with phase 43's (each gate's own children too: the twin
#: gate's three real-plane runs, the control gate's static run, its part
#: B and its three tools.control runs) and run side by side after phase
#: 43, at their defaults
CONTROL_GATE_CHILDREN = ("twin_gate", "control_gate")
CONTROL_GATE_BUDGET_S = 45.0
#: the committed reference-tools fixture (the reference's tools at HEAD on
#: a CPU): the meta keys the port's artifacts must carry
TOOLS_FIXTURE = os.path.join(ROOT, PACKAGE, "testing", "reference_tools")
REFERENCE_SEARCH = "POLICY_OPT_r09.json"
#: the platform the tools' artifacts name (the card's, ``device_kind`` its
#: name)
TOOL_PLATFORM = "gpu"
#: eager steps at B = 48 traced per kernel from the grid's final state
#: (a row every GRID_RECORD_EVERY steps), and steps of the TK1 + TK2
#: route; the grid's direct run is traced whole besides
TRACE_STEPS = 80
TRACE_PAIR_STEPS = 20
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
#: float outputs held to the bit: adaptive's penalty window, which the
#: kernel drains and re-arms by the plain version's float ops
EXACT_FLOATS = ("holder_penalty_ms",)
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
    "elig_select_gather": (SOURCE, f"{REF}:859 + :907"),
    "admit_gather": (SOURCE, f"{REF}:1304"),
    "peer_update_gather": (SOURCE, f"{REF}:1347 + :1351"),
}
#: the kernels the single-scenario main path launches, once a step
#: each (peer_update writes the offload series); TK1 and TK2 are the
#: route of offset tuples too wide for select_admit's tile, lane_sums
#: serves the sums outside the step, and timeline_row runs only with a
#: timeline
MAIN_PATH = ("select_admit", "peer_update")
#: shapes where select_admit's tiles wrap the ring, (peers, ring
#: degree); at 1,000 peers the last tile is partial
WRAP_CASES = ((16, 8), (96, 12), (1000, 8))
#: the same check at other cache-map widths (peers, ring degree,
#: segments; 3 levels; the cases above have 2 words a row): 1 word (8
#: segments) at 1,000 peers, and 256 words (2,730 segments) at 16 peers,
#: where the ring wraps more than once in one tile; each map's last word
#: is partial
MAP_CASES = ((1000, 8, 8), (16, 8, 2730))
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
#: TK4 against its plain version and its order's PyTorch twin on random
#: byte counters: peers (1,001 takes its scalar loads; 1,000 a partial
#: last partial and super-partial) and lanes
SUMS_PEERS = (1_000, 1_001, 262_144, 1_048_576)
SUMS_LANES = (1, 4, 48)
#: steps per host-clock run of each route, run in turns fused, pair,
#: pair, fused
HOST_STEPS = 400

#: live mode.  The kernel check's lanes, points of live_grid() (the live
#: fixture's: stagger windows of 2 and 8 s, announce lags of 0 and 4 s,
#: both join waves, every supply point, both cushions and both urgency
#: margins) at GRID_PEERS × GRID_SEGMENTS, compared at two states: after
#: LIVE_CHECK_STEPS plain steps (t = 60 s, when the crowd joins: its
#: playhead floor binds) and LIVE_CHECK_MORE steps later (fresh segments
#: held by peers that the announce lag still hides)
LIVE_POINTS = (15, 43, 107, 136)
LIVE_CHECK_STEPS = 240
LIVE_CHECK_MORE = 6
#: the reference's run of the 144-point live grid (a TPU, tools/sweep.py
#: --live; 1,048,576 × 128 × 960, seed 0), rows rounded as
#: tools/sweep.py:491-492 rounds them: offload to 4 digits, rebuffer to 5
REFERENCE_LIVE_SWEEP = "SWEEP_LIVE_1M_r05.json"
OFFLOAD_DIGITS, REBUFFER_DIGITS = 4, 5
#: the reference at HEAD, re-run on a CPU at the record's shape by
#: tools/torch_port_live_anchor.py: {point: (offload, rebuffer)}, rounded
#: as the record.  Where it differs from the record (point 100's offload)
#: the port is held to it, not to the record.
LIVE_ANCHOR = {107: (0.4613, 7e-05), 100: (0.2511, 1e-05),
               28: (0.0002, 0.00726), 15: (0.0, 0.01259)}
#: the tail chunk's lanes, rerun inside a chunk of this many (with the
#: lanes before them): rows equal to the bit
LIVE_TAIL_CHUNK = 32
#: lanes of the traced live chunk: the autotuned chunk at 1,048,576 peers
LIVE_TRACE_LANES = 64
#: the largest difference of a live row from the reference's after its
#: rounding.  Measured on an H100 80GB HBM3 at 700 W (PERF.md): 6e-4,
#: in the offload of 17 points (the card's float32 sums in another order
#: than the TPU's, then rounded); every rebuffer equal.  Held to 1e-3.
LIVE_ROW_TOL = 1e-3

#: prefetch slots (max_concurrency = 3, tools/policy_ab.py's ring).  The
#: kernel check's lanes: the prefetch fixture's four cells
#: (tools/torch_port_fixture.py PREFETCH_CELLS, its departure wave on
#: lane 1) at GRID_PEERS × 128 segments with the fixture's 50 s watch
#: window (the crowd joins at 12.5 s, the wave departs at 25 s), compared
#: at two states: after PREFETCH_CHECK_STEPS plain steps (t = 25 s, the
#: departure) and PREFETCH_CHECK_MORE steps later
PREFETCH_CHECK_STEPS = 100
PREFETCH_CHECK_MORE = 6
PREFETCH_WATCH_S = 50.0
#: the generic instantiation (CT = 0) against the plain step at (slots,
#: peers, plain steps before), on the prefetch fixture's four lanes
GENERIC_SLOTS = ((2, 65_536, 60), (16, 4_096, 60))
#: the ring grid's peers (tools/policy_ab.py --ring-peers)
RING_PEERS = 262_144
#: the reference's run of the policy A/B grid (a TPU, tools/policy_ab.py;
#: the ring at 262,144 × 128 × 960, seed 0), rows rounded as
#: tools/policy_ab.py:155-163 rounds them: offload to 4 digits, rebuffer
#: to 5
REFERENCE_POLICY_AB = "POLICY_AB_r05.json"
#: the reference at HEAD, re-run on a CPU at the record's shape by
#: tools/torch_port_policy_anchor.py: {policy: {cell: (offload,
#: rebuffer)}}, rounded as the record.  Where it differs from the record
#: (spread: cells 0, 11 and 17; adaptive: 0, 5 and 11; ranked: 0 and 11)
#: the port is held to it, not to the record.
RING_ANCHOR = {
    "spread": {5: (0.2396, 0.00128), 11: (0.4796, 0.00119),
               0: (0.3556, 0.00119), 17: (0.3185, 0.00128)},
    "adaptive": {0: (0.4334, 0.00119), 5: (0.3062, 0.00128),
                 11: (0.5054, 0.00119), 17: (0.3299, 0.00128)},
    "ranked": {0: (0.3598, 0.00119), 5: (0.2291, 0.00128),
               11: (0.5291, 0.00119), 17: (0.3836, 0.00128)}}
#: the cells run alone, each as a chunk of its own: the anchored crowd
#: cell and hetero stagger cell
RING_ALONE = (5, 11)
#: the largest difference of a ring row from the reference's after its
#: rounding.  Measured on an H100 80GB HBM3 at 700 W (PERF.md): 2e-4, in
#: the offload of 9 cells (the card's float32 sums in another order than
#: the TPU's, then rounded); every rebuffer equal.  Held to 5e-4.
RING_ROW_TOL = 5e-4
#: the injected faults on the ring grid: the chunk, and each plan with
#: the counts it gives (the reference's for that plan on those chunks,
#: tests/test_torch_faults.py); the last plan exhausts its budget on
#: chunk 1, whose cells come back as a structured failure
FAULT_CHUNK = 4
#: the holder policies besides "spread", and their kernel check's cases
#: (policy, slots, live) on the prefetch fixture's lanes, at the two states
#: of PREFETCH_CHECK_STEPS
POLICIES = ("adaptive", "ranked")
POLICY_CASES = tuple((p, c, live) for p in POLICIES
                     for c, live in ((3, False), (1, False), (3, True)))
#: peers (the ring of 8, three slots) at which ranked's ids wrap for many
#: requesters and select_admit's tiles wrap the ring (phase 4's sizes),
#: and plain steps before the check
POLICY_WRAP_PEERS = (16, 1000)
POLICY_WRAP_STEPS = 80
#: the general [P, K] path: tools/policy_ab.py's random mesh (degree 8).
#: The kernel check's lanes: the prefetch fixture's four cells at
#: GATHER_PEERS × GRID_SEGMENTS on the mesh, each policy at three slots,
#: VOD and live, and spread uncapped, at the two states of
#: PREFETCH_CHECK_STEPS; then small meshes (peers, degree, k_pad) where
#: rows hold self-padding (degree >= P collapses to everyone else plus
#: padding; k_pad pads), holders' in-degree passes K, and (48 peers at
#: degree 32) passes 32, so that admit_gather's rows take a second mask
#: word, one call and ROUTE_STEPS steps against the plain step, each
#: policy
GATHER_PEERS = 262_144
GATHER_SMALL = ((16, 20, None), (1000, 8, 10), (48, 32, None))
#: the gather kernels' codes in swarm_gather_occupancy
GATHER_KERNEL_IDS = {"elig_select_gather": 0, "admit_gather": 1,
                     "peer_update_gather": 2}
#: the random half of the policy grid: the tool's size (the record's,
#: tools/policy_ab.py --peers) and the size a user runs on this card
RANDOM_PEERS = 8_192
RANDOM_PEERS_LARGE = 262_144
#: the reference at HEAD on the random mesh, re-run on a CPU at the
#: record's shape by tools/torch_port_policy_anchor.py --topology random:
#: {policy: {cell: (offload, rebuffer)}}, rounded as the record.  Where it
#: differs from the record (spread: cells 0 and 11; adaptive: 0, 5 and 11;
#: ranked: 0 and 11, each by 1e-4 or 2e-4 of offload) the port is held to
#: it, not to the record.
RANDOM_ANCHOR = {
    "spread": {0: (0.3612, 0.00119), 5: (0.2282, 0.00128),
               11: (0.4778, 0.00119), 17: (0.3482, 0.00128)},
    "adaptive": {0: (0.4384, 0.00119), 5: (0.3123, 0.00128),
                 11: (0.5011, 0.00119), 17: (0.3558, 0.00128)},
    "ranked": {0: (0.3558, 0.00119), 5: (0.3219, 0.00128),
               11: (0.5055, 0.00119), 17: (0.3742, 0.00128)}}
#: the largest difference of a random-mesh row from the record's after its
#: rounding.  Measured on an H100 80GB HBM3 at 700 W (PERF.md): 2e-4, in
#: the offload of 8 or 9 cells of each column (the card's float32 sums in
#: another order than the TPU's, then rounded); every rebuffer equal.  Held
#: to 5e-4, as the ring's RING_ROW_TOL.
RANDOM_ROW_TOL = 5e-4
#: steps of the plain versions timed beside the gather kernels
PLAIN_STEPS = 3
FAULT_PLANS = {"transient@0:0x2": {"transient|retry": 2},
               "oom@0:0x2": {"oom|bisect": 2},
               "transient@0:1x4": {"transient|retry": 3,
                                   "transient|giveup": 1}}

#: the population plane (engine/population.py): the example spec that
#: tools/sweep.py --population documents (60% broadband on lognormal
#: uplinks arriving over 60 s, 40% cdn_only cellular capped at level 1,
#: urgent 2 s earlier, arriving in one wave at 60 s with 600 s sessions;
#: mixture axis 0, 0.25, 0.5 cellular)
POPULATION_SPEC = "examples/population_cellular_broadband.json"
#: the step kernels' check under the example population at mix 0.5, from
#: the state the kernels' own steps reach after POPULATION_CHECK_STEPS
#: steps (t = 62 s: the cellular wave of 60-62 s in): the VOD lanes
#: (mixture points of VOD points 0, 29, 42 and 47), the live lanes (of
#: live points 15, 43, 107 and 136), and for three slots (the ring under
#: each policy, the random mesh under adaptive) four lanes of the spec at
#: these default CDN rates (Mb/s) with the HD ladder
POPULATION_CHECK_STEPS = 248
POPULATION_VOD_LANES = (2, 89, 128, 143)
POPULATION_LIVE_LANES = (47, 131, 323, 410)
POPULATION_CDN_MBPS = (1.2, 2.4, 4.0, 8.0)
#: the reference at HEAD at points of the mixture grid (VOD point i at
#: the m-th mix fraction is point 3 i + m), re-run on a CPU at 1,048,576 ×
#: 128 × 960 by tools/torch_port_population_anchor.py: {point: (offload,
#: rebuffer)}, rounded as a sweep's rows (4 and 5 digits).  No TPU record
#: of this grid exists.
POPULATION_ANCHOR = {2: (0.3871, 0.00426), 87: (0.6425, 0.00462),
                     88: (0.4997, 0.00438), 141: (0.646, 0.0),
                     142: (0.5625, 0.0)}
#: the anchored rows against the port's unrounded ones: the rounding
#: (5e-5 in offload) and the card's float32 sums in another order
POPULATION_ROW_TOL = 2e-4
#: lanes of the mixture grid's direct chunk (its first points), traced
#: and held to the dispatch's rows; steps of its whole-run trace (a
#: quarter of the run); TK5's cohort check runs on its final state
POPULATION_TRACE_LANES = 48
POPULATION_TRACE_STEPS = 240
#: TK5's cohort check: cohort counts (2 the spec's labels, 8 seeded
#: labels), and small swarms (peers) where blocks are partial
COHORT_COUNTS = (2, 8)
COHORT_PEERS = (16, 1000)
#: the degenerate population's sampled points of each grid
DEGENERATE_POINTS = 4


#: phases 39-41: the control plane and the twin's sim half against the
#: committed control fixture (testing/reference_control/); the bands the
#: twin gate holds the sim plane to
TWIN_BANDS = "TWIN_r10.json"
#: the widest twin audience the card takes (24 peers and a wave of 9: K =
#: 32), run on the card and on the CPU path over 8 frame windows (the
#: wave lands in the sixth) so that the CPU run stays short
WIDE_TWIN = dict(n_peers=24, wave_peers=9, watch_s=64.0)
#: the kernels each path must launch: the sim plane's step and timeline,
#: the forecasts' step and offload sums
TWIN_KERNELS = ("elig_select_gather", "admit_gather", "peer_update_gather",
                "timeline_row")
CONTROL_KERNELS = ("elig_select_gather", "admit_gather",
                   "peer_update_gather", "lane_sums")
#: the tick phases whose medians phase 40 prints
CONTROL_TICK_PHASES = ("reconstruct", "forecast", "decide")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


#: wall seconds by phase tag ("[9]"): the time before each log line goes
#: to the tag the line starts with, or to the last tag logged
PHASE_WALLS = {}
_CLOCK = {"start": time.perf_counter(), "last": time.perf_counter(),
          "tag": "[1]"}


def log(msg=""):
    now = time.perf_counter()
    if msg.startswith("[") and "]" in msg:
        _CLOCK["tag"] = msg[:msg.index("]") + 1]
    tag = _CLOCK["tag"]
    PHASE_WALLS[tag] = PHASE_WALLS.get(tag, 0.0) + now - _CLOCK["last"]
    _CLOCK["last"] = now
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
    mismatch, a float of EXACT_FLOATS not equal to the bit, or another
    float outside RTOL/ATOL."""
    import torch
    worst = 0.0
    for name, a, b in _pairs(named_a, named_b):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{what}: {name} shape/dtype {a.shape}/{a.dtype} vs "
              f"{b.shape}/{b.dtype}")
        if name in EXACT_FLOATS:
            a, b = a.view(torch.int32), b.view(torch.int32)
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
    errs["peer_update"], rel = compare_peer_update(sim, sk, config,
                                                   scenario, state, label)
    n_active = int((state.dl_flags & 1).sum())
    log(f"  {label}: all four kernels agree with their plain versions "
        f"({n_active} transfers in flight); max float err "
        f"{json.dumps(errs)}; peer_update's sums rel err {rel!r}")
    return errs


def compare_peer_update(sim, sk, config, scenario, state, label):
    """``peer_update`` (its offload sums and series entry in the
    epilogue) against ``peer_update_plain`` then ``lane_sums_plain`` on
    the plain selection's outputs: the state as :func:`compare` holds
    it, the sums and the series entry within REDUCE_RTOL; and its sums
    and series entry equal to the bit to what ``lane_sums`` gives on the
    state it wrote.  Returns ``(max abs float error, max relative error
    of the sums)``."""
    import torch
    scenario, b = _as_lanes(sim, scenario, state)
    B = b.t_s.shape[0]
    fp, rp, sv_p, adm_p = sk.select_admit_plain(config, scenario, b)
    c, d = sim.clone_state(b), sim.clone_state(b)
    ser_k = torch.zeros((B, 3), dtype=torch.float32, device="cuda")
    ser_p, ser_l = ser_k.clone(), ser_k.clone()
    sums_k = sk.peer_update(config, scenario, c, fp, rp, sv_p, adm_p,
                            series=ser_k, column=1)
    sk.peer_update_plain(config, scenario, d, fp, rp, sv_p, adm_p)
    sums_p = sk.lane_sums_plain(d, ser_p, 1)
    sums_l = sk.lane_sums(c, ser_l, 1)
    torch.cuda.synchronize()
    err = compare(f"{label} peer_update", c._asdict(), d._asdict())
    rel = _rel_err(sums_k, sums_p)
    ser_err = float((ser_k - ser_p).abs().max())
    check(rel <= REDUCE_RTOL and ser_err <= REDUCE_RTOL,
          f"{label} peer_update: sums off by {rel!r} relative, series by "
          f"{ser_err!r}")
    check(torch.equal(sums_k, sums_l) and torch.equal(ser_k, ser_l),
          f"{label} peer_update: its sums {sums_k.tolist()} are not "
          f"lane_sums' {sums_l.tolist()}")
    check(torch.equal(sums_k, sk.lane_sums_in_order(c)),
          f"{label} peer_update: its sums are not the bits of "
          f"lane_sums_in_order")
    clock = b.t_s.clone().add_(config.dt_ms / 1000.0)
    check(torch.equal(c.t_s, clock) and torch.equal(d.t_s, clock),
          f"{label} peer_update: the clock {c.t_s.tolist()} (plain "
          f"{d.t_s.tolist()}) is not t_s + dt {clock.tolist()}")
    check(bool((ser_k[:, [0, 2]] == 0).all()),
          f"{label} peer_update wrote outside its series column")
    return max(err, ser_err), rel


def compare_gather(sim, sk, config, scenario, state, label):
    """The general path's kernels against their plain versions on the
    same inputs: TK1-gather, TK2-gather on the plain TK1's req (its
    admitted flags where a slot placed demand: the kernel writes no
    other), TK3-gather as :func:`compare_peer_update` holds it.  Returns
    ``{kernel: max abs float error}``."""
    import torch
    a, b = sim.clone_state(state), sim.clone_state(state)
    fk, rk = sk.elig_select_gather(config, scenario, a)
    fp, rp = sk.elig_select_plain(config, scenario, b)
    sv_k, adm_k = sk.admit_gather(config, scenario, rp)
    sv_p, adm_p = sk.admit_service_plain(config, scenario, rp)
    torch.cuda.synchronize()
    placed = rp >= 0
    errs = {"elig_select_gather": compare(
                f"{label} elig_select_gather",
                {"slot_flags": fk, "req": rk, **a._asdict()},
                {"slot_flags": fp, "req": rp, **b._asdict()}),
            "admit_gather": compare(
                f"{label} admit_gather",
                {"service": sv_k, "adm": torch.where(placed, adm_k, 0)},
                {"service": sv_p, "adm": adm_p})}
    errs["peer_update_gather"], rel = compare_peer_update(
        sim, sk, config, scenario, state, label)
    log(f"  {label}: the three gather kernels agree with their plain "
        f"versions ({int((state.dl_flags & 1).sum())} transfers in "
        f"flight, {int(placed.sum())} demands placed); max float err "
        f"{json.dumps(errs)}; sums rel err {rel!r}")
    return errs


def gather_branch_counts(sim, sk, config, scenario, state):
    """What of the general path binds in the next step, as the plain
    step sees it: ``padding``, self entries of the neighbour lists (no
    edge); ``beyond_k``, inbound edges walked past column K (a holder of
    in-degree above K) whose requester's slot contributes to it;
    ``beyond_32``, the same past edge 32 (admit_gather's second mask
    word); ``denied``, contributions the cap did not admit; ``over_cap``, holders
    with more contributions than a cap of 2 admits (uncapped, the
    demands the cap would have denied)."""
    import torch
    g = sk.geometry(config)
    nbr = scenario.neighbors
    P, K = g.P, nbr.shape[-1]
    peer = torch.arange(P, device=nbr.device)
    _flags, req = sk.elig_select_plain(config, scenario,
                                       sim.clone_state(state))
    _svc, adm = sk.admit_service_plain(config, scenario, req)
    in_e = scenario.in_edges.long()
    ok = in_e >= 0
    flat = torch.clamp_min(in_e, 0)
    lanes = torch.arange(in_e.shape[0], device=nbr.device)[:, None, None]
    src, col = flat // max(K, 1), flat % max(K, 1)
    beyond, beyond_32, n_contrib = 0, 0, 0
    for c in range(config.max_concurrency):
        contrib = ok & (req[..., c][lanes, src] == col)
        beyond += int(contrib[..., K:].sum())
        beyond_32 += int(contrib[..., 32:].sum())
        n_contrib = n_contrib + contrib.sum(-1)
    return {"padding": int((nbr == peer[:, None]).sum()),
            "beyond_k": beyond, "beyond_32": beyond_32,
            "denied": int(((req >= 0) & (adm == 0)).sum()),
            "over_cap": int((n_contrib > 2).sum())}


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
    """Build both sources anew, print ptxas's lines, and return
    :func:`kernel_registers` of the build."""
    from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_kernels as sk
    t0 = time.perf_counter()
    info = sk.build_kernels(force=True)
    log(f"[2] built {len(info)} source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for src, rec in info.items():
        for line in rec["ptxas"]:
            log(f"    {src}: {line.strip()}")
    return kernel_registers(line for rec in info.values()
                            for line in rec["ptxas"])


def kernel_registers(lines):
    """``{entry function (mangled): {"registers": n, "spill_bytes":
    stores + loads, "smem_bytes": static shared memory a block}}`` from
    ptxas's ``-v`` lines."""
    import re
    out, name = {}, None
    for line in lines:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": None, "spill_bytes": 0,
                         "smem_bytes": 0}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and name:
            out[name]["smem_bytes"] = int(m.group(1))
    return out


def registers_of(regs, kernel, live, slots=1, policy="spread"):
    """The build's registers and spills of ``kernel``'s instantiation on
    the main path's ring (K = 8 for ``select_admit``), live or VOD, for
    ``slots`` transfer slots (1 or 3; 0 the generic instantiation) and
    holder ``policy`` (``peer_update``'s penalty instantiation for
    ``"adaptive"``)."""
    from hlsjs_p2p_wrapper_tpu_torch.ops.swarm_kernels import POLICY_CODES
    b, ct, pol = int(live), slots, POLICY_CODES[policy]
    pen = int(policy == "adaptive")
    tag = {"select_admit": f"select_admit_kernelILi8ELb{b}ELi{ct}ELi{pol}EE",
           "peer_update": f"peer_update_kernelILb{b}ELi{ct}ELb{pen}EE",
           "elig_select_gather":
               f"elig_select_gather_kernelILb{b}ELi{ct}ELi{pol}EE",
           "admit_gather": f"admit_gather_kernelILi{ct}EE",
           "peer_update_gather":
               f"peer_update_gather_kernelILb{b}ELi{ct}ELb{pen}EE"}[kernel]
    return regs_of_entry(regs, tag)


def gather_resources(sk, regs):
    """Registers, spills, and resident blocks an SM at the threads a
    block each launches with (``swarm_gather_occupancy``: the card's
    occupancy calculator) of every instantiation of the gather kernels,
    ``{(kernel, live, slots, policy): {...}}`` with slots 1, 3 and 0 (the
    generic instantiation); logged whole."""
    import ctypes
    from hlsjs_p2p_wrapper_tpu_torch.ops.swarm_kernels import POLICY_CODES
    fn = sk._lib(sk.SOURCE).swarm_gather_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    got = (ctypes.c_int * 2)()
    out = {}
    for name, kid in GATHER_KERNEL_IDS.items():
        for live in (False, True):
            for slots in (1, 3, 0):
                for policy, pol in POLICY_CODES.items():
                    if name == "admit_gather" and (live or pol):
                        continue   # one instantiation a slot count
                    if name == "peer_update_gather" and policy == "ranked":
                        continue   # PEN only: spread's instantiation
                    rc = fn(kid, int(live), slots or 2, pol, got)
                    check(rc == 0 and got[0] > 0,
                          f"the occupancy of {name} (live {live}, CT "
                          f"{slots}, {policy}): CUDA error {rc}, "
                          f"{got[0]} blocks")
                    out[(name, live, slots, policy)] = dict(
                        registers_of(regs, name, live, slots, policy),
                        blocks_per_sm=got[0], threads_per_block=got[1])
    log("    gather kernels' registers, spills, static shared memory and "
        "resident blocks an SM by (kernel, live, CT, policy): "
        + json.dumps({"/".join(str(x) for x in k): v
                      for k, v in out.items()}))
    return out


def regs_of_entry(regs, tag):
    """The build's registers and spills of the one entry function whose
    mangled name holds ``tag``."""
    found = [v for k, v in regs.items() if tag in k]
    check(len(found) == 1, f"ptxas reported no single {tag} function")
    return found[0]


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
    errs = {"select_admit": 0.0, "elig_select": 0.0, "admit_service": 0.0,
            "peer_update": 0.0}
    cases = [(P, sim.ring_offsets(d), 16, 20.0, 80) for P, d in WRAP_CASES]
    cases += [(P, sim.ring_offsets(d), S, 20.0, 80) for P, d, S in MAP_CASES]
    cases.append((WIDE_PEERS, WIDE_OFFSETS, WIDE_SEGMENTS, 10.0, 60))
    for P, offsets, S, window_s, warm in cases:
        config, scenario, state = make_case(sim, sk, P, S, warm, "cuda",
                                            offsets, window_s)
        fused = sk.fused_route(config)
        label = (f"{P:,} peers, offsets {offsets}, "
                 f"{sk.geometry(config).W}-word map")
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
        pu_err, pu_rel = compare_peer_update(sim, sk, config, scenario,
                                             state, label)
        errs["peer_update"] = max(errs["peer_update"], pu_err)
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
        want.update(lane_sums=0, timeline_row=0, timeline_row_cohorts=0,
                    **{k: 0 for k in sk.GATHER_PATH})
        check(launches == want, f"{label}: launches {launches}, not {want}")
        check(placed > 0, f"{label}: no transfer placed demand")
        err = compare(f"{label} {n} steps", a._asdict(), b._asdict())
        log(f"[4] {label}: {'fused' if fused else 'TK1 + TK2'} route; "
            f"one call equals its plain version, peer_update's too (sums "
            f"rel err {pu_rel!r}; launches {direct}); "
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
    ``fn(state, outputs so far, series, column) -> outputs``:
    ``"fused"`` is the main path (select_admit, then TK3 with the
    offload sums in its epilogue), ``"pair"`` TK1, TK2 and TK3 called
    directly, ``"gather"`` the general path's gather forms of the three,
    ``"plain"`` and ``"plain_pair"`` the plain versions of the one and the
    other (TK3's is ``peer_update_plain`` then ``lane_sums_plain``)."""
    if route == "gather":
        def pu(st, o, ser, s):
            return sk.peer_update(config, scenario, st, *o, series=ser,
                                  column=s)
        return [("elig_select_gather",
                 lambda st, o, ser, s: sk.elig_select_gather(config, scenario,
                                                             st)),
                ("admit_gather",
                 lambda st, o, ser, s: o + sk.admit_gather(config, scenario,
                                                           o[1])),
                ("peer_update_gather", pu)]
    if route in ("fused", "plain"):
        sa = sk.select_admit if route == "fused" else sk.select_admit_plain
        first = [("select_admit",
                  lambda st, o, ser, s: sa(config, scenario, st))]
    else:
        es, ad = ((sk.elig_select, sk.admit_service) if route == "pair"
                  else (sk.elig_select_plain, sk.admit_service_plain))
        first = [("elig_select",
                  lambda st, o, ser, s: es(config, scenario, st)),
                 ("admit_service",
                  lambda st, o, ser, s: o + ad(config, scenario, o[1]))]
    if route.startswith("plain"):
        def pu(st, o, ser, s):
            sk.peer_update_plain(config, scenario, st, *o)
            return sk.lane_sums_plain(st, ser, s)
    else:
        def pu(st, o, ser, s):
            return sk.peer_update(config, scenario, st, *o, series=ser,
                                  column=s)
    return first + [("peer_update", pu)]


def _as_lanes(sim, scenario, state):
    """A scenario and a clone of its state as lanes (one lane for a
    single scenario), as ``_scan_swarm`` steps them."""
    state = sim.clone_state(state)
    if sim.is_lanes(state):
        return scenario, state
    return sim.as_lanes(scenario), sim.as_lanes(state)


def _steps(sim, sk, config, scenario, st, n_steps, route, series,
           events=None):
    """``n_steps`` eager steps of the lanes ``st`` on ``route``, as
    ``_scan_eager`` steps them: the passes, TK3 (or its plain version)
    writing the offload series and advancing the clock; with
    ``events``, one list of CUDA events per step bracketing each
    pass."""
    stages = _stages(sk, config, scenario, route)
    for s in range(n_steps):
        e = events[s] if events is not None else None
        if e:
            e[0].record()
        out = ()
        for n, (_name, fn) in enumerate(stages):
            out = fn(st, out, series, s)
            if e:
                e[n + 1].record()
    return st


def time_window(sim, sk, config, scenario, state0, n_steps, route):
    """Device time over ``n_steps`` consecutive eager steps from
    ``state0`` (a clone is stepped) on ``route`` (see :func:`_stages`),
    each step as ``_scan_eager`` runs it.  CUDA events bracket each
    pass.  A GPU sleep ahead of the window lets the host
    queue the launches, so the events time the device, not the host.  A
    kernels' window fails if the host did not stay ahead.  The plain
    passes launch hundreds of small ops a step, more than the launch
    queue holds, so their times are the passes as the host drives them,
    launch gaps included.  Returns ``({kernel: mean ms per pass}, mean
    ms per whole step)``."""
    import torch
    scenario, st = _as_lanes(sim, scenario, state0)
    names = [n for n, _fn in _stages(sk, config, scenario, route)]
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


def timed_run(sim, sk, config, scenario, state0, n_steps, path,
              record_every=0):
    """One ``_scan_swarm`` (``path="graph"``: the entry points' path on
    the card, replayed CUDA graphs) or ``_scan_eager`` (``"eager"``: the
    same kernels launched step by step) run of ``n_steps`` from a clone
    of ``state0``, by the host clock from its start to a synchronize
    after it.  Returns ``(seconds, seconds of them inside the run's
    graph captures, the run's outputs)``; the rest of a graph run is its
    replays (the first uploads its graph) and the copies between
    them."""
    import torch
    scenario, st = _as_lanes(sim, scenario, state0)
    run = sim._scan_swarm if path == "graph" else sim._scan_eager
    with capture_clock(sk) as spent:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(config, scenario, st, n_steps, record_every=record_every)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, sum(spent), out


@contextlib.contextmanager
def capture_clock(sk):
    """Within it, the host seconds of each graph capture
    (``swarm_kernels.capture``) are appended to the list it yields."""
    capture, spent = sk.capture, []

    def timed_capture(*args, **kw):
        t = time.perf_counter()
        try:
            return capture(*args, **kw)
        finally:
            spent.append(time.perf_counter() - t)
    sk.capture = timed_capture
    try:
        yield spent
    finally:
        sk.capture = capture


def same_bits(a, b):
    """Whether two states, or tensors, or tuples of them, are equal to
    the bit."""
    import torch
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_bits(x, y)
                                        for x, y in zip(a, b))
    return torch.equal(a, b)


def _traced(prof, n_steps):
    """From a ``torch.profiler`` run: ``({kernel: (launches, mean ms)}``
    over the kernels of :data:`KERNELS` the trace holds, the other
    device ops ``{name: count}`` and their ms per step, whether it holds
    any device op)."""
    import torch
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    per_kernel = {}
    for name in KERNELS:
        durs = [e.time_range.elapsed_us() for e in ops
                if f"{name}_kernel" in e.name]
        if durs:
            per_kernel[name] = (len(durs), sum(durs) / len(durs) / 1e3)
    others = [e for e in ops
              if not any(f"{name}_kernel" in e.name for name in KERNELS)]
    counts = {}
    for e in others:
        counts[e.name] = counts.get(e.name, 0) + 1
    other_us = sum(e.time_range.elapsed_us() for e in others)
    return per_kernel, counts, other_us / n_steps / 1e3, bool(ops)


def trace_steps(sim, sk, config, scenario, state0, n_steps, route,
                record_every=0):
    """``n_steps`` steps from a clone of ``state0`` under
    ``torch.profiler`` (CUPTI): the scan as the entry points run it on
    the card (``route="graph"``, with ``record_every``), the eager loop
    (``"eager"``), or the eager loop over the passes of :func:`_stages`
    (the other routes).  Returns ``(device busy ms per step, host wall
    ms per step, {kernel: (launches, mean ms)}, {other device op:
    count})`` over the kernels of :data:`KERNELS` that the trace holds,
    and what else ran on the device; the busy time is None where
    the trace holds no device op, or (graph route) where it holds none
    of the step's kernels.  The trace may miss a launch (at B = 48 it
    held 19 of 20 of one kernel), so the busy time per step is each
    kernel's mean time times its launches per step, plus the other
    device ops' time over the steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    scenario, st = _as_lanes(sim, scenario, state0)
    series = torch.empty((st.t_s.shape[0], n_steps), dtype=torch.float32,
                         device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if route in ("graph", "eager"):
            run = sim._scan_swarm if route == "graph" else sim._scan_eager
            run(config, scenario, st, n_steps, record_every=record_every)
        else:
            _steps(sim, sk, config, scenario, st, n_steps, route, series)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    per_kernel, others, other_ms, any_op = _traced(prof, n_steps)
    if route in ("graph", "eager"):
        per_step = dict.fromkeys(sk.GATHER_PATH if sk.geometry(config).general
                                 else MAIN_PATH, 1.0)
    else:
        per_step = {name: 1.0
                    for name, _fn in _stages(sk, config, scenario, route)}
    if record_every:
        per_step["timeline_row"] = 1.0 / record_every
    if not any_op or not all(name in per_kernel for name in per_step):
        return None, wall_ms, per_kernel, others
    busy_ms = other_ms + sum(per_kernel[name][1] * n
                             for name, n in per_step.items())
    return busy_ms, wall_ms, per_kernel, others


def trace_calls(fn, n):
    """``{kernel: mean traced ms}`` over ``n`` calls of ``fn()`` under
    ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {k: v[1] for k, v in _traced(prof, n)[0].items()}


def other_ops(prof_counts, n_steps, label):
    """Checks that a traced run of ``n_steps`` steps launched fewer
    device ops outside :data:`KERNELS` than steps (no clock add or other
    PyTorch kernel a step: ``peer_update`` advances the clock) and
    returns a summary of them for the log."""
    n = sum(prof_counts.values())
    check(n < n_steps, f"{label}: {n} device ops besides the kernels in "
                       f"{n_steps} steps ({json.dumps(prof_counts)}), so a "
                       f"step still launches one")
    return (f"{n} other device op(s) in {n_steps} steps "
            f"{json.dumps(prof_counts)}")


def kernel_bytes(sk, config, scenario, state_before, slot_flags, req, adm,
                 state_after):
    """Bytes each kernel must move for one step on these inputs: every
    input read once and every output written once, counting a
    data-dependent read or write only where this step's data needs it
    (the neighbours' map words that requesters ask for, the slot record
    of slots that start, the cache word and estimator of slots that
    complete).  Per (peer, slot) fields count once a slot; with prefetch
    slots the selection also reads the own map word of each wishing slot
    and the cooldown of each prefetch slot whose wish reaches it, and
    ``peer_update`` reads the two per-lane prefetch scalars and rewrites
    the attempts of slots that abort or complete.  In live mode the
    selection also reads each requester's stagger rank and wait clock
    and three lane scalars, and ``peer_update`` writes every wait clock,
    reads those of the foregrounds blocked on the stagger (the others
    reset) and reads the cushion.  Under ``"adaptive"`` the selection
    reads each requester's penalty row, and ``peer_update`` reads every
    row, writes back the rows that were open or re-arm, and reads the
    holder offset of each deny and abort and the lane's re-arm value;
    ``"ranked"`` does not read an active slot's stored holder.  A
    kernel's bound is these bytes over the card's memory rate."""
    import torch
    g = sk.geometry(config)
    K = scenario.neighbors.shape[-1] if g.general else len(g.offs)
    P, C = g.P, config.max_concurrency
    policy = config.holder_selection
    tg = sk.slot_targets(config, scenario, state_before)
    act = tg["active"]
    n_active = int(act.sum())
    may = (slot_flags & 1) != 0
    n_may0 = int(may[..., 0].sum())
    n_may = int(may.sum())
    # distinct (holder row, word) pairs that the requesters read
    peer = torch.arange(P, device=req.device)
    wi = (tg["gi_flat"] >> 5).to(torch.int64)
    words = 0   # the general path's gathers: gather_kernel_bytes
    if g.offs:
        keys = torch.stack([((peer + o) % P) * g.W + wi[:, c]
                            for o in g.offs_mod for c in range(C)])
        words = int(torch.unique(keys).numel())
    tk1 = (4 * (12 + C) * P    # 12 per-peer arrays and each slot's attempts
           # dl_seg, dl_level and (but for ranked) dl_holder_off (active)
           + 4 * (2 if policy == "ranked" else 3) * n_active
           + 4 * words         # neighbours' wanted map words
           + 4 * (g.L + 5)     # ladder, t_s, four policy scalars
           + 4 * 2 * P * C     # slot_flags, req
           + 4 * (P * C - n_active)  # dl_holder_off of idle slots
           + 4 * (7 * n_may0 + 6 * (n_may - n_may0)))  # starts' records
    if C > 1:
        present = tg["present"]
        raw = tg["next_seg"][:, None] + torch.arange(1, C,
                                                     device=req.device)
        window = (present[:, None] & ~act[:, 1:] & (raw <= g.S - 1)
                  & (raw.to(torch.float32) * config.seg_duration_s
                     < tg["playhead"][:, None] + config.max_buffer_s))
        wishes = (int(tg["fg_wants"].sum()) + int(
            (window & (state_before.dl_cooldown_ms[:, 1:] <= 0.0)).sum()))
        tk1 += 4 * int(window.sum()) + 4 * wishes   # cooldowns, own words
    tk2 = 4 * (2 * C + 2) * P + 4  # req, uplink in; service, adm out; eff
    placed = int((req >= 0).sum())
    act_after = torch.stack([((state_after.dl_flags >> (2 * c)) & 1) != 0
                             for c in range(C)], -1)
    was = (slot_flags & 2) != 0
    # slot 0 only turns inactive by completing; a prefetch slot also by
    # aborting, which bumps its attempts where completing resets them
    done = was & ~act_after
    completed = done.clone()
    completed[:, 1:] &= state_after.dl_attempts[:, 1:] == 0
    n_completed = int(completed.sum())
    n_aborted = int(done.sum()) - n_completed
    tk3 = (4 * 3 * P           # join, leave, cdn_bps
           + 4 * 2 * P * C     # slot_flags, req
           + 4 * 2 * placed    # adm word and service of the holder
           + 4 * (6 + 4 * C) * P  # state arrays read
           + 4 * (6 + 3 * C) * P  # state arrays written
           + 4 * 2             # t_s, p2p_setup_ms
           + (8 + 8 + 32) * n_completed   # seg/level, map word, EWMA
           # the epilogue: each block's (cdn, p2p) partial and each
           # super-partial written and read back once, the sums, the
           # series entry and the advanced clock
           + 2 * 8 * (sk.sums_blocks(P) + sk.sums_supers(P)) + 8 + 4 + 4)
    if C > 1:
        # the request timeout and retry cooldown; attempts written where
        # a prefetch completes, read and written where one aborts
        tk3 += 4 * 2 + 4 * int(completed[:, 1:].sum()) + 8 * n_aborted
    if config.live:
        blocked = int(((slot_flags[..., 0] & 16) != 0).sum())
        tk1 += 4 * 2 * P + 4 * 3   # edge_rank, fg_wait_ms; three scalars
        tk3 += 4 * P + 4 * blocked + 4   # fg_wait_ms; live_sync_s
    if policy == "adaptive":
        f0 = slot_flags[:, 0]
        admitted = (req[:, 0] >= 0) & (adm[:, 0] != 0) if g.general else (
            torch.zeros_like(f0, dtype=torch.bool))
        for k, o in enumerate(g.offs):
            admitted |= (req[:, 0] == k) & (
                ((torch.roll(adm[:, 0], -o, 0) >> k) & 1) != 0)
        n_denied = int((((f0 & 1) != 0) & ((f0 & 4) != 0)
                        & ((f0 & 8) != 0) & ~admitted).sum())
        rows = torch.stack([state_before.holder_penalty_ms,
                            state_after.holder_penalty_ms]).view(torch.int32)
        written = int((rows != 0).any(-1).any(0).sum())
        tk1 += 4 * K * P
        tk3 += (4 * K * P + 4 * K * written + 4 * (n_denied + n_aborted)
                + 4)
    # select_admit: TK1's traffic plus uplink in, service and adm out,
    # the efficiency scalar (req stays in shared memory)
    fused = tk1 + 4 * (2 + C) * P + 4
    return {"select_admit": float(fused), "elig_select": float(tk1),
            "admit_service": float(tk2), "peer_update": float(tk3)}


def _sectors(words):
    """Bytes of the 32-byte sectors that 4-byte accesses at the word
    indices ``words`` touch: a random gather moves a sector for its 4
    useful bytes."""
    import torch
    return 32 * int(torch.unique(words // 8).numel()) if words.numel() else 0


def gather_kernel_bytes(sk, config, scenario, state_before, slot_flags, req,
                        adm, state_after):
    """:func:`kernel_bytes` for the general path's gather kernels, one
    lane: what TK1, TK2 and TK3 move on the ring besides their
    neighbours' reads, plus the gathers counted as the sectors they
    touch.  TK1-gather reads each requester's neighbour row and one map
    word of every serving neighbour a slot (the join, leave and p2p_ok
    it gathers for each neighbour are the per-peer arrays
    :func:`kernel_bytes` counts once, as it counts the ring's neighbour
    reads); TK2-gather reads each
    holder's inbound edges up to the first padding entry, the req of
    every inbound edge's (requester, slot) and writes the admitted flag
    where a slot placed demand; TK3-gather reads, where a slot placed
    demand, the neighbour id and its own flag, and where it was admitted
    the holder's service."""
    import torch
    base = kernel_bytes(sk, config, scenario, state_before, slot_flags, req,
                        adm, state_after)
    g = sk.geometry(config)
    P, C = g.P, config.max_concurrency
    nbr = scenario.neighbors.long()
    K = nbr.shape[-1]
    peer = torch.arange(P, device=nbr.device)
    tg = sk.slot_targets(config, scenario, state_before)
    present = tg["present"]
    real = nbr != peer[:, None]
    serving = real & present[nbr] & (scenario.p2p_ok[nbr] > 0.0)
    wi = (tg["gi_flat"] >> 5).long()
    words = torch.cat([(nbr * g.W + wi[:, c, None])[serving]
                       for c in range(C)])
    tk1 = base["elig_select"] + 4 * K * P + _sectors(words)
    in_e = scenario.in_edges.long()
    k_in = in_e.shape[-1]
    deg = (in_e >= 0).sum(-1)
    flat = in_e[in_e >= 0]
    src = flat // max(K, 1)
    placed = req >= 0
    slot_words = (peer[:, None] * C + torch.arange(C, device=nbr.device))
    tk2 = (4 * int(torch.clamp_max(deg + 1, k_in).sum())
           + _sectors(torch.cat([src * C + c for c in range(C)]))
           + _sectors(slot_words[placed]) + 4 * 2 * P + 4)
    holder = torch.gather(nbr, 1, torch.clamp_min(req, 0).long())
    admitted = placed & (adm != 0)
    tk3 = base["peer_update"] + _sectors(holder[admitted])
    return {"elig_select_gather": float(tk1), "admit_gather": float(tk2),
            "peer_update_gather": float(tk3)}


def live_branch_counts(sim, sk, config, scenario, state):
    """How many peers of the lanes ``state`` each live branch binds, as
    the plain selection sees the next step: ``floored``, present peers
    whose playhead the join floor raises; ``gated``, present peers
    still inside their playback cushion; ``blocked``, foregrounds held
    by the edge stagger; ``hidden``, wishes that have holders the
    announce lag still hides."""
    tg = sk.slot_targets(config, scenario, state)
    t = state.t_s[:, None]
    present = tg["present"]
    flags, _req = sk.elig_select_plain(config, scenario,
                                       sim.clone_state(state))
    visible_at = ((tg["next_seg"].to(state.t_s.dtype) + 1.0)
                  * config.seg_duration_s
                  + scenario.announce_delay_s[:, None])
    return {
        "floored": int((present & (tg["playhead"]
                                   > state.playhead_s)).sum()),
        "gated": int((present & (t < scenario.join_s
                                 + scenario.live_sync_s[:, None])).sum()),
        "blocked": int(((flags[..., 0] & 16) != 0).sum()),
        "hidden": int((tg["fg_wants"] & ((flags[..., 0] & 8) != 0)
                       & (t < visible_at)).sum())}


def prefetch_branch_counts(sim, sk, config, scenario, state):
    """How many (peer, slot) pairs of the lanes ``state`` each prefetch
    branch binds in the next step, as the plain step sees it:
    ``absorb``, foreground wishes served from the own cache;
    ``conflict``, prefetch wishes with holders, uncached (and announced
    in live mode), held back by the dedup guard; ``lost``, ``timeout``
    and ``busy``, prefetch aborts on lost holders, on the request
    timeout and on a BUSY deny; ``cooldown``, prefetch wishes the retry
    cooldown holds back; ``rotation``, prefetch selections that place
    demand with ``dl_attempts > 0``."""
    import torch
    g = sk.geometry(config)
    S, C = g.S, config.max_concurrency
    tg = sk.slot_targets(config, scenario, state)
    st = sim.clone_state(state)
    flags, req, service, adm = sk.select_admit_plain(config, scenario, st)
    after = sim.clone_state(st)
    sk.peer_update_plain(config, scenario, after, flags, req, service, adm)
    t = state.t_s[:, None]
    pre_act, post_act = tg["active"], (flags & 2) != 0
    pre_flat = state.dl_level * S + state.dl_seg
    post_flat = st.dl_level * S + st.dl_seg
    counts = dict(absorb=int(((flags[..., 0] & 32) != 0).sum()),
                  conflict=0, lost=0, timeout=0, busy=0, cooldown=0,
                  rotation=0)
    bit_table = 1 << torch.arange(32, device=req.device)
    for c in range(1, C):
        raw = tg["next_seg"] + c
        target = torch.clamp_max(raw, S - 1)
        flat = tg["want_level"] * S + target
        reach = (tg["present"] & ~pre_act[..., c] & (raw <= S - 1)
                 & (raw.to(torch.float32) * config.seg_duration_s
                    < tg["playhead"] + config.max_buffer_s))
        if config.live:
            reach &= ((raw.to(torch.float32) + 1.0) * config.seg_duration_s
                      <= t)
        cooled = state.dl_cooldown_ms[..., c] <= 0.0
        counts["cooldown"] += int((reach & ~cooled).sum())
        conflict = torch.zeros_like(reach)
        for o in range(C):
            if o < c:
                conflict |= post_act[..., o] & (post_flat[..., o] == flat)
            elif o > c:
                conflict |= pre_act[..., o] & (pre_flat[..., o] == flat)
        word = torch.gather(state.avail, -1, (flat >> 5).long()[..., None])
        own = (word[..., 0] & bit_table[flat & 31].to(torch.int32)) != 0
        have_n = (flags[..., c] & 8) != 0
        guarded = reach & cooled & have_n & ~own & conflict
        if config.live:
            guarded &= t >= ((target.to(torch.float32) + 1.0)
                             * config.seg_duration_s
                             + scenario.announce_delay_s[:, None])
        counts["conflict"] += int(guarded.sum())
        was = post_act[..., c]
        aborted = (was & ~(((after.dl_flags >> (2 * c)) & 1) != 0)
                   & (after.dl_attempts[..., c] > 0))
        admitted = torch.zeros_like(was)
        for k, o in enumerate(g.offs):
            admitted |= (req[..., c] == k) & (
                ((torch.roll(adm[..., c], -o, -1) >> k) & 1) != 0)
        elapsed = st.dl_elapsed_ms[..., c] + torch.where(
            tg["present"], config.dt_ms, 0.0)
        counts["lost"] += int((aborted & ~have_n).sum())
        counts["timeout"] += int(
            (aborted & (elapsed >= scenario.request_timeout_ms[:, None]))
            .sum())
        counts["busy"] += int((aborted & ((flags[..., c] & 1) != 0)
                               & have_n & ~admitted).sum())
        counts["rotation"] += int((~pre_act[..., c] & (req[..., c] >= 0)
                                   & (state.dl_attempts[..., c] > 0)).sum())
    return counts


def _bitmask(cols):
    """``[..., K]`` booleans as an int64 bit mask (bit k, column k)."""
    import torch
    shift = torch.arange(cols.shape[-1], device=cols.device)
    weights = torch.ones_like(shift) << shift
    return (cols.to(torch.int64) * weights).sum(-1)


def _popcount(x):
    import torch
    n = torch.zeros_like(x)
    for k in range(32):
        n += (x >> k) & 1
    return n


def signed_offset_picks(config, elig, skip):
    """What ranked would pick if peer ids followed the signed offsets
    (no wrap): per requester, from its eligible-offset bit mask
    ``elig``, the offset index of the (``skip`` + 1)-th eligible holder
    in signed-offset order (the last where fewer exist), else -1."""
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_kernels as sk
    offs = sk.geometry(config).offs
    n_e = _popcount(elig)
    target = torch.clamp_max(n_e - 1, skip)
    seen = torch.zeros_like(n_e)
    pick = torch.full_like(n_e, -1)
    for k in sorted(range(len(offs)), key=lambda k: offs[k]):
        e_k = ((elig >> k) & 1) != 0
        pick = torch.where(e_k & (seen == target), k, pick)
        seen += e_k.to(seen.dtype)
    return pick


def eligible_bits(sim, sk, config, scenario, state):
    """Each slot's eligible-offset bit mask ``[..., P]`` (int64) at the
    next step, requester-gated as the selection sees it."""
    import torch
    g = sk.geometry(config)
    C = config.max_concurrency
    tg = sk.slot_targets(config, scenario, state)
    serve_ok = tg["present"] & (scenario.p2p_ok > 0.0)
    return [_bitmask(torch.stack(e, -1) > 0) * (scenario.p2p_ok > 0.0)
            for e, _n, _own in sim.circulant_eligibility(
                state.avail, serve_ok, list(g.offs),
                [tg["gi_flat"][..., c] for c in range(C)], impl="kpass")]


def policy_branch_counts(sim, sk, config, scenario, state):
    """How many (peer, slot) pairs of the lanes ``state`` each branch of
    the holder policy binds in the next step, as the plain step sees it.
    Under ``"adaptive"``: ``tier``, idle slots whose new holder differs
    from the one ``"spread"`` picks on the same state; ``own_used`` and
    ``penalty``, idle slots with an eligible holder that the own-load key
    or the penalty window keeps out of the lowest tier; ``rearm_deny``,
    ``rearm_lost``, ``rearm_timeout`` and ``rearm_busy``, the foreground
    BUSY denies and the prefetch aborts by kind whose holder's window
    the update re-arms.  Under ``"ranked"``: ``skip_s``, selections that
    place demand with more than s eligible holders, for each skip s the
    slots take; ``wrap``, selections that place demand on another holder
    than an order by signed offset would (the ring's wrap)."""
    import torch
    g = sk.geometry(config)
    C, K = config.max_concurrency, len(g.offs)
    tg = sk.slot_targets(config, scenario, state)
    pre_act, pre_p2p = tg["active"], tg["is_p2p"]
    st = sim.clone_state(state)
    flags, req, service, adm = sk.select_admit_plain(config, scenario, st)
    elig = eligible_bits(sim, sk, config, scenario, state)
    counts = {}
    if config.holder_selection == "ranked":
        counts["wrap"] = 0
        for c in range(C):
            skip = C - 1 if c == 0 else c - 1
            placed = req[..., c] >= 0
            key = f"skip_{skip}"
            counts[key] = counts.get(key, 0) + int(
                (placed & (_popcount(elig[c]) > skip)).sum())
            alt = signed_offset_picks(config, elig[c], skip)
            counts["wrap"] += int((placed & (alt != req[..., c])).sum())
        return counts
    check(config.holder_selection == "adaptive",
          f"no policy branches for {config.holder_selection!r}")
    pen = _bitmask(state.holder_penalty_ms > 0.0)
    post_act, post_p2p = (flags & 2) != 0, (flags & 4) != 0
    spread = sim.clone_state(state)._replace(
        holder_penalty_ms=state.holder_penalty_ms[..., :0].contiguous())
    sk.elig_select_plain(config._replace(holder_selection="spread"),
                         scenario, spread)
    counts.update(tier=0, own_used=0, penalty=0)
    for c in range(C):
        used = torch.zeros_like(pen)
        for o in range(C):
            if o == c:
                continue
            a_o, p_o, off = ((post_act[..., o], post_p2p[..., o],
                              st.dl_holder_off[..., o]) if o < c else
                             (pre_act[..., o], pre_p2p[..., o],
                              state.dl_holder_off[..., o]))
            ok = a_o & p_o & (off >= 0) & (off < K)
            bit = off.clamp(0, 31).to(torch.int64)
            used |= torch.where(ok, torch.ones_like(bit) << bit, 0)
        e = elig[c]
        tier = torch.zeros_like(e)
        for part in (e & ~used & ~pen, e & ~used & pen, e & used & ~pen,
                     e & used & pen):
            tier = torch.where(tier != 0, tier, part)
        idle = ~pre_act[..., c]
        counts["own_used"] += int((idle & ((e & used & ~tier) != 0)).sum())
        counts["penalty"] += int((idle & ((e & pen & ~tier) != 0)).sum())
        counts["tier"] += int((idle & (st.dl_holder_off[..., c]
                                       != spread.dl_holder_off[..., c]))
                              .sum())
    after = sim.clone_state(st)
    sk.peer_update_plain(config, scenario, after, flags, req, service, adm)
    value = scenario.holder_penalty_ms[:, None]
    counts.update(rearm_deny=0, rearm_lost=0, rearm_timeout=0, rearm_busy=0)
    for c in range(C):
        admitted = torch.zeros_like(post_act[..., c])
        for k, o in enumerate(g.offs):
            admitted |= (req[..., c] == k) & (
                ((torch.roll(adm[..., c], -o, -1) >> k) & 1) != 0)
        fl = flags[..., c]
        off = st.dl_holder_off[..., c]
        armed = (off >= 0) & (off < K) & (torch.gather(
            after.holder_penalty_ms, -1,
            off.clamp(0, K - 1).long()[..., None])[..., 0] == value)
        may, have_n = (fl & 1) != 0, (fl & 8) != 0
        busy = may & have_n & ~admitted
        if c == 0:
            counts["rearm_deny"] += int((armed & busy & ((fl & 4) != 0))
                                        .sum())
            continue
        was = post_act[..., c]
        aborted = (was & ~(((after.dl_flags >> (2 * c)) & 1) != 0)
                   & (after.dl_attempts[..., c] > st.dl_attempts[..., c]))
        elapsed = st.dl_elapsed_ms[..., c] + torch.where(
            tg["present"], config.dt_ms, 0.0)
        timeout = elapsed >= scenario.request_timeout_ms[:, None]
        counts["rearm_lost"] += int((armed & aborted & ~have_n).sum())
        counts["rearm_timeout"] += int((armed & aborted & timeout).sum())
        counts["rearm_busy"] += int((armed & aborted & busy).sum())
    return counts


def lane_sums_bytes(sk, B, P):
    """TK4 reads two [B, P] float32 arrays, writes and reads back one
    (cdn, p2p) super-partial a thread block, and writes the [B, 2] sums
    and one series entry a lane."""
    return float(8 * B * P + 16 * B * sk.sums_supers(P) + 12 * B)


def timeline_bytes(B, P, n_cols, cohorts=False):
    """TK5 in row mode reads rebuffer, the previous rebuffer, join,
    leave and level ([B, P] each), writes the previous rebuffer, reads
    this step's and the previous sums and writes them back, and writes
    one row of ``n_cols`` floats a lane; its cohort instantiation also
    reads ``cohort_id``, ``p2p_bytes`` and ``cdn_bytes``."""
    return float((36 if cohorts else 24) * B * P + 24 * B + 4 * n_cols * B)


def step_bytes(sim, sk, config, scenario, state_before, slot_flags, req,
               adm, state_after):
    """:func:`kernel_bytes` (on the general path
    :func:`gather_kernel_bytes`) of one step, summed over its lanes (a
    single scenario is one lane), and ``lane_sums``' on the same
    lanes."""
    if not sim.is_lanes(state_before):
        scenario, state_before, state_after = (
            sim.as_lanes(x) for x in (scenario, state_before, state_after))
        slot_flags, req, adm = (x[None] for x in (slot_flags, req, adm))
    B = state_before.t_s.shape[0]
    total = {}
    count = (gather_kernel_bytes if config.neighbor_offsets is None
             else kernel_bytes)
    for b in range(B):
        for name, v in count(
                sk, config, sim.lane(scenario, b),
                sim.lane(state_before, b), slot_flags[b], req[b], adm[b],
                sim.lane(state_after, b)).items():
            total[name] = total.get(name, 0.0) + v
    total["lane_sums"] = lane_sums_bytes(sk, B, config.n_peers)
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
    with capture_clock(sk) as spent:
        t0 = time.perf_counter()
        final, series = sim.run_swarm(config, BITRATES, None, cdn, state0,
                                      T, join, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"[5] main path {P:,} peers x {S} segments x {T} steps, replayed "
        f"as CUDA graphs of {sim.GRAPH_STEPS} steps: {wall!r} s "
        f"({sum(spent)!r} s of it in {len(spent)} captures), "
        f"{P * T / wall:,.0f} peer-steps/s, host wall per step "
        f"{wall / T * 1e3!r} ms; launches {json.dumps(launches)}; peak "
        f"memory {peak:,} B")
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
    check(torch.equal(series[-1], sim.offload_ratio(final)),
          "the last series entry is not offload_ratio of the final state")
    log(f"    final offload {offload!r} (= the last series entry), "
        f"rebuffer ratio {rebuffer!r}")

    # the eager loop on the same inputs: the same launches, the same bits
    scenario = sim.make_scenario(config, BITRATES, None, cdn, join,
                                 device="cuda")
    sk.reset_launch_counts()
    wall_e, _cap, (final_e, series_e) = timed_run(
        sim, sk, config, scenario, state0, T, "eager")
    launches_e = dict(sk.LAUNCHES)
    check(launches_e == launches, f"eager loop launches {launches_e}, not "
                                  f"the graphs' {launches}")
    check(same_bits(sim.lane(final_e, 0), final)
          and torch.equal(series_e[0], series),
          "the graphs' run and the eager loop's differ")
    walls = {"graph": [], "eager": []}
    captures = []
    for path in TURNS:
        w, cap, (f, ser) = timed_run(sim, sk, config, scenario, state0, T,
                                     path)
        check(same_bits(f, final_e) and torch.equal(ser, series_e),
              f"a repeated {path} run differs")
        walls[path].append(w / T * 1e3)
        if path == "graph":
            captures.append(cap * 1e3)
    log(f"    eager loop on the same inputs: {wall_e!r} s "
        f"({P * T / wall_e:,.0f} peer-steps/s), launches equal, final "
        f"state and series equal to the bit; host wall per step (ms) of "
        f"runs in turns {', '.join(TURNS)}: graphs {walls['graph']}, "
        f"eager {walls['eager']}; host ms of each graph run spent in its "
        f"captures {captures}, so its replays took (ms per step) "
        f"{[w - c / T for w, c in zip(walls['graph'], captures)]}")
    g_busy, g_wall, g_traced, g_other = trace_steps(
        sim, sk, config, scenario, state0, T, "graph")
    e_busy, e_wall, e_traced, e_other = trace_steps(
        sim, sk, config, scenario, state0, T, "eager")
    if e_busy is None:
        log("    trace: torch.profiler recorded no device op; device busy "
            "time and idle share not measured")
    else:
        if g_busy is None:
            g_busy = e_busy
            how = ("torch.profiler holds none of the graphs' kernels, so "
                   "their busy time is the eager loop's")
        else:
            how = f"per kernel {json.dumps(g_traced)}"
        log(f"    traced whole run ({T} steps each): graphs device busy "
            f"{g_busy!r} ms per step over host wall {g_wall!r} ms, idle "
            f"{1.0 - g_busy / g_wall!r} ({how}); eager loop busy "
            f"{e_busy!r} ms over {e_wall!r} ms, idle "
            f"{1.0 - e_busy / e_wall!r}; per kernel "
            f"{json.dumps(e_traced)}")
        log(f"    besides the kernels (no clock add a step): graphs "
            f"{other_ops(g_other, T, 'graph run')}; eager loop "
            f"{other_ops(e_other, T, 'eager run')}")

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
    busy_ms, _wall, traced, _other = trace_steps(
        sim, sk, config, scenario, final, window, "fused")
    pair_busy_ms, _wall, pair_traced, _other = trace_steps(
        sim, sk, config, scenario, final, window, "pair")

    log(f"    device time per whole eager step ({window}-step windows "
        f"from the final state queued ahead, CUDA events; the kernels, "
        f"which advance the clock): main path {fused_step_ms!r} ms "
        f"(select_admit + peer_update {sum(fused_ms.values())!r} ms), "
        f"TK1 + TK2 + TK3 "
        f"route {pair_step_ms!r} ms (kernels {sum(pair_ms.values())!r} "
        f"ms); plain passes {plain_step_ms!r} ms")
    log(f"    per pass, CUDA events (ms): main path {json.dumps(fused_ms)}; "
        f"TK1 + TK2 + TK3 {json.dumps(pair_ms)}; plain versions "
        f"{json.dumps(plain_ms)}")
    if busy_ms is not None and pair_busy_ms is not None:
        log(f"    trace ({window} eager steps from the final state, "
            f"torch.profiler): main path busy {busy_ms!r} ms per step, "
            f"per kernel (launches, mean ms) {json.dumps(traced)}; TK1 + "
            f"TK2 + TK3 route busy {pair_busy_ms!r} ms per step, per "
            f"kernel {json.dumps(pair_traced)}")
    traced_ms = {**{k: v[1] for k, v in pair_traced.items()},
                 **{k: v[1] for k, v in traced.items()}}

    # lane_sums, off the step: at this shape, on the final state
    _scen, lanes = _as_lanes(sim, scenario, final)
    one = torch.empty((1, 1), dtype=torch.float32, device="cuda")
    ms["lane_sums"] = back_to_back(lambda st: sk.lane_sums(st, one, 0),
                                   lanes)
    plain_ms["lane_sums"] = cuda_ms(lambda: sk.lane_sums_plain(lanes, one,
                                                               0), 5)
    traced_ms.update({k: v for k, v in trace_calls(
        lambda: sk.lane_sums(lanes, one, 0), WINDOW).items()
        if k == "lane_sums"})
    nbytes["lane_sums"] = lane_sums_bytes(sk, 1, P)
    library_ms = back_to_back(lambda st: (torch.sum(st.p2p_bytes, dim=-1),
                                          torch.sum(st.cdn_bytes, dim=-1)),
                              lanes)
    log(f"    lane_sums (not launched by the step; {BACK_TO_BACK} launches "
        f"back to back): {ms['lane_sums']!r} ms by CUDA events, "
        f"{traced_ms.get('lane_sums')!r} ms traced; torch.sum of "
        f"p2p_bytes and cdn_bytes (two calls, its library yardstick) "
        f"{library_ms!r} ms")
    run = {"config": config, "scenario": scenario, "state0": state0,
           "join": join, "wall": wall, "offload": offload,
           "rebuffer": rebuffer, "series": series}
    return launches, errs, ms, traced_ms, plain_ms, nbytes, library_ms, run


def phase_main_plain(sim, sk, run):
    """The main path's whole run again on the plain path, stepped as
    ``_scan_eager`` steps, its ratios and offload series held to the
    kernels' run's."""
    import torch
    config, join, wall = run["config"], run["join"], run["wall"]
    P, T = config.n_peers, STEPS
    dt_s = config.dt_ms / 1000.0
    scen_l, st = _as_lanes(sim, run["scenario"], run["state0"])
    series_p = torch.empty((1, T), dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = _steps(sim, sk, config, scen_l, st, T, "plain", series_p)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    offload_p, rebuffer_p = _ratios(sim, sim.lane(st, 0), T, dt_s, join)
    series_err = float((series_p[0] - run["series"]).abs().max())
    log(f"    plain path on the card (the children of phases 35 and 38 "
        f"starting beside it): {wall_p:.3f} s ({P * T / wall_p:,.0f} "
        f"peer-steps/s) vs kernels {wall:.3f} s; offload {offload_p!r}, "
        f"rebuffer ratio {rebuffer_p!r}, largest offload series "
        f"difference {series_err!r}")
    check(abs(offload_p - run["offload"]) <= RUN_TOL
          and abs(rebuffer_p - run["rebuffer"]) <= RUN_TOL
          and series_err <= RUN_TOL,
          "kernels and plain path disagree on the main path's ratios")


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


def build_lanes(sim, sg, config, grid, watch_s, population=None):
    """The stacked scenarios of ``grid``'s points on the card (with
    ``population``'s overlay when given), and their joins ``[B, P]``."""
    import torch
    built = [sg.build_scenario(config, k, watch_s=watch_s,
                               stagger_s=GRID_STAGGER_S, seed=0,
                               population=population, device="cuda")
             for k in grid]
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

    def run(chunk, **warm):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = dp.run_batch_chunked(config, grid, build, n_steps,
                                    watch_s=GRID_WATCH_S, chunk=chunk,
                                    record_every=GRID_RECORD_EVERY, **warm)
        torch.cuda.synchronize()
        return rows, time.perf_counter() - t0

    chunk = sim.autotune_chunk(config, len(grid), n_steps,
                               record_every=GRID_RECORD_EVERY,
                               scenario=build(grid[0])[0], device="cuda")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
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
    # per chunk: a launch of each step kernel a step, replayed from the
    # graphs; lane_sums once for the timeline's first interval and once
    # for the final offload ratio; timeline_row once a row and once for
    # the final rebuffer ratio
    want = {"select_admit": n_steps * n_chunks, "elig_select": 0,
            "admit_service": 0, "peer_update": n_steps * n_chunks,
            "lane_sums": 2 * n_chunks,
            "timeline_row": (n_rows + 1) * n_chunks,
            "timeline_row_cohorts": 0, **{k: 0 for k in sk.GATHER_PATH}}
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
    with open(os.path.join(ROOT, REFERENCE_SWEEP)) as fh:
        ref_rows = {tuple(r[k] for k in grid[0]): r
                    for r in json.load(fh)["rows"]}
    ref = [ref_rows[tuple(knobs.values())] for knobs in grid]
    check(stalling == REFERENCE_STALLING_ROWS,
          f"{stalling} grid points stall, the reference's "
          f"{REFERENCE_SWEEP} {REFERENCE_STALLING_ROWS}")
    diff = max(max(abs(o - r["offload"]), abs(b - r["rebuffer"]))
               for o, b, r in zip(offs, rebs, ref))
    log(f"    point 0 {json.dumps(grid[0])}: offload {offs[0]!r}, "
        f"rebuffer {rebs[0]!r} (the reference's {REFERENCE_SWEEP}: "
        f"offload {ref[0]['offload']!r}, rebuffer {ref[0]['rebuffer']!r})")
    log(f"    offload {min(offs)!r} .. {max(offs)!r}; {stalling} of "
        f"{len(grid)} points stall ({REFERENCE_SWEEP}: "
        f"{REFERENCE_STALLING_ROWS}); largest difference from its rows "
        f"(rounded to 4-5 digits, a TPU's run) {diff!r}; each last "
        f"timeline row equals its final ratios")

    # chunk 16 with a warm start on a fresh root A and a journal: every
    # row a miss, stored and journaled
    from hlsjs_p2p_wrapper_tpu_torch.engine.artifact_cache import (
        SweepJournal, WarmStart, journal_path)
    warm = WarmStart(os.path.join(WARM_DIR, "A"))
    meta = grid_meta(sg, grid)
    with SweepJournal(journal_path(warm.cache_dir, meta), meta) as journal:
        rows16, wall16 = run(GRID_CHUNK, warm_start=warm, journal=journal)
        check(_rows_equal(rows16, rows),
              f"chunk {GRID_CHUNK} rows differ from the autotuned run's")
        row_events = warm.event_counts("row")
        check(row_events == {"miss": len(grid), "store": len(grid)},
              f"chunk {GRID_CHUNK} with a warm start: row events "
              f"{row_events}, not {len(grid)} misses and stores")
        check(len(journal.completed) == len(grid),
              f"{len(journal.completed)} rows journaled, not {len(grid)}")
        journal.finalize()
    check(journal.finished, "phase 9's journal is not finalized")
    log(f"    chunk {GRID_CHUNK} with a warm start on a fresh root and a "
        f"journal: {wall16!r} s, {warm.prefilter_seconds()!r} s of it the "
        f"row cache's prefilter ({len(grid)} builds and keys); row events "
        f"{json.dumps(row_events)}, library events "
        f"{json.dumps(warm.event_counts('executable'))}, "
        f"{len(journal.completed)} keys journaled, journal finalized")
    scen48, joins48 = build_lanes(sim, sg, config, grid, GRID_WATCH_S)
    directs = {}
    for path in ("graph", "eager"):
        init = sim.init_swarm(config, device="cuda", batch=len(grid))
        sk.reset_launch_counts()
        w, cap, out = timed_run(sim, sk, config, scen48, init, n_steps,
                                path, record_every=GRID_RECORD_EVERY)
        del init
        final, series, tl = out
        offs48 = sim.offload_ratio_batch(final)
        rebs48 = sim.rebuffer_ratio_batch(final, GRID_WATCH_S, joins48)
        check(torch.equal(series[:, -1], offs48),
              f"{path}: a last series entry is not its final offload")
        directs[path] = (w, final, series, tl, offs48, rebs48,
                         dict(sk.LAUNCHES), cap)
        if path == "eager":
            del final, series, tl, out
    (wall48, final48, series48, tl48, offs48, rebs48, l48,
     cap48) = directs["graph"]
    wall_e, final_e, series_e, tl_e, offs_e, rebs_e, l_e, _cap = (
        directs.pop("eager"))
    direct = [(float(o), float(r), t) for o, r, t in
              zip(offs48.tolist(), rebs48.tolist(), tl48.cpu().numpy())]
    check(_rows_equal(direct, rows), "the direct 48-lane batch's rows "
                                     "differ from the dispatch's")
    check(l_e == l48 and torch.equal(series_e, series48)
          and torch.equal(tl_e, tl48) and torch.equal(offs_e, offs48)
          and torch.equal(rebs_e, rebs48) and same_bits(final_e, final48),
          "the 48-lane batch through the eager loop differs from the "
          "graphs'")
    del final_e, series_e, tl_e
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
    log(f"    chunk {GRID_CHUNK}: rows equal to the bit; one "
        f"direct {len(grid)}-lane run_swarm_batch (graphs): {wall48!r} s "
        f"({wall48 * 1e3 / n_steps!r} ms per step; {cap48!r} s of it in "
        f"its captures), rows equal; the same "
        f"batch through the eager loop: {wall_e!r} s "
        f"({wall_e * 1e3 / n_steps!r} ms per step), launches, final "
        f"states (clocks included), series, timelines and ratios equal to "
        f"the bit; each last series entry "
        f"equals its final offload; points {list(ALONE_LANES)} run alone: "
        f"series, timelines and ratios equal their lanes to the bit")
    return {"config": config, "scenario": scen48, "final": final48,
            "launches": launches, "wall48": wall48, "wall_eager": wall_e,
            "n_steps": n_steps, "rows": rows, "build": build, "grid": grid,
            "base": base, "peak": peak, "wall": wall, "wall16": wall16}


def grid_meta(sg, grid):
    """Phase 9's grid's sweep identity (``sweep_grid.journal_meta``)."""
    return sg.journal_meta(grid, peers=GRID_PEERS, segments=GRID_SEGMENTS,
                           watch_s=GRID_WATCH_S, live=False, seed=0,
                           record_every=GRID_RECORD_EVERY)


def start_children():
    """Phase 35's three children and phase 38's three fabric workers,
    started ahead of time (each imports torch and the package, then
    waits for a line on its standard input before it touches the card):
    the killed, the resumed and the warm sweep; the hosts of the
    fabric."""
    os.makedirs(os.path.join(WARM_DIR, "fleet"))
    children = {}
    fleet = os.path.join(WARM_DIR, "fleet")
    for host in FLEET_HOSTS:
        cmd = [sys.executable, "-m", f"{PACKAGE}.testing.fleet_worker",
               "--fabric", os.path.join(fleet, "fabric"),
               "--root", os.path.join(fleet, "root"),
               "--trace-dir", os.path.join(fleet, "trace"),
               "--host-id", host, "--lease-s", str(FLEET_LEASE_S),
               "--barrier", str(len(FLEET_HOSTS)),
               "--out", os.path.join(fleet, f"{host}.npz"),
               "--peers", str(GRID_PEERS), "--segments", str(GRID_SEGMENTS),
               "--watch-s", str(GRID_WATCH_S),
               "--stagger-s", str(GRID_STAGGER_S),
               "--record-every", str(GRID_RECORD_EVERY),
               "--chunk", str(FLEET_CHUNK), "--device", "cuda", "--wait"]
        if host in FLEET_CHAOS:
            cmd += ["--chaos", FLEET_CHAOS[host]]
        err = open(os.path.join(WARM_DIR, f"{host}.err"), "w")
        children[host] = subprocess.Popen(
            cmd, cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=err, text=True)
        err.close()
    for name, root, extra in (("killed", "B", ("--inject-faults",
                                               KILL_PLAN)),
                              ("resumed", "B", ("--resume",)),
                              ("warm", "A", ())):
        cmd = [sys.executable, "-m", f"{PACKAGE}.testing.resumable_sweep",
               "--root", os.path.join(WARM_DIR, root),
               "--out", os.path.join(WARM_DIR, f"{name}.npz"),
               "--peers", str(GRID_PEERS), "--segments", str(GRID_SEGMENTS),
               "--watch-s", str(GRID_WATCH_S),
               "--stagger-s", str(GRID_STAGGER_S),
               "--record-every", str(GRID_RECORD_EVERY),
               "--chunk", str(GRID_CHUNK), "--device", "cuda", "--wait",
               *extra]
        err = open(os.path.join(WARM_DIR, f"{name}.err"), "w")
        children[name] = subprocess.Popen(
            cmd, cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=err, text=True)
        err.close()
    return children


def _start_tool_child(tool, prepare=False):
    """One ``testing/tool_child.py`` process for ``tool``, its standard
    error in WARM_DIR; with ``prepare`` (a gate) it starts the gate's own
    children too, all in a process group of their own that
    :func:`stop_children` ends whole."""
    name = f"tool_{tool}"
    with open(os.path.join(WARM_DIR, f"{name}.err"), "w") as err:
        return name, subprocess.Popen(
            [sys.executable, "-m", f"{PACKAGE}.testing.tool_child", tool,
             *(["--prepare"] if prepare else [])],
            cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=err, text=True, start_new_session=prepare)


def start_tool_children():
    """Phase 42's three tools (``testing/tool_child.py``), started after
    the build, beside phase 3: each imports torch and its tool, then
    waits for its argv before it touches the card.  Clears the children's
    directory first."""
    import shutil
    shutil.rmtree(WARM_DIR, ignore_errors=True)
    os.makedirs(WARM_DIR)
    return dict(_start_tool_child(tool) for tool in TOOL_CHILDREN)


def start_gate_children():
    """Phase 43's four gates and phase 44's two, started after phase 38,
    each with its own children, all waiting (thirty processes importing
    torch, which slow what runs beside them: twenty beside phase 3
    slowed phase 4's launch queue past its check, beside phase 5's plain
    run they slowed that run by 15.6 s; here, phase 41 by ~8 s)."""
    return dict(_start_tool_child(gate, prepare=True)
                for gate in GATE_CHILDREN + CONTROL_GATE_CHILDREN)


def stop_children(children):
    """End every child, and a gate's children with it (its process
    group, whose id is the gate's pid)."""
    import signal
    for proc in children.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass  # no group of its own, or the group is gone
        for fh in (proc.stdin, proc.stdout):
            if fh is not None:
                fh.close()


def _child_failure(name, proc, what):
    with open(os.path.join(WARM_DIR, f"{name}.err")) as fh:
        tail = fh.read()[-3000:]
    return f"the {name} child {what} (exit {proc.poll()}):\n{tail}"


def _child_go(name, proc):
    """Read the child's ready line, then let it sweep."""
    line = proc.stdout.readline()
    check(line.startswith("{"), _child_failure(name, proc,
                                               "did not get ready"))
    try:
        proc.stdin.write("go\n")
        proc.stdin.flush()
    except BrokenPipeError:
        check(False, _child_failure(name, proc, "died before its sweep"))
    return json.loads(line), time.perf_counter()


#: each ended child's standard output, by name
CHILD_STDOUT = {}


def _child_end(name, proc, t_go):
    """The child's exit code, its JSON lines after the ready line, and
    the host wall from its go to its exit (read at once only for the
    killed child: the others report their sweep's wall)."""
    out, _ = proc.communicate(timeout=600)
    wall = time.perf_counter() - t_go
    CHILD_STDOUT[name] = out
    records = [json.loads(ln) for ln in out.splitlines()
               if ln.startswith("{")]
    return proc.returncode, records, wall


def _child_rows(name):
    import numpy as np
    with np.load(os.path.join(WARM_DIR, f"{name}.npz")) as data:
        return [(float(o), float(r), tl) for o, r, tl in
                zip(data["offload"], data["rebuffer"], data["timeline"])]


def _rows_hex_equal(a, b):
    """Rows equal to the bit: ratios by ``float.hex``, timelines by
    their bytes."""
    return len(a) == len(b) and all(
        x[0].hex() == y[0].hex() and x[1].hex() == y[1].hex()
        and x[2].dtype == y[2].dtype and x[2].tobytes() == y[2].tobytes()
        for x, y in zip(a, b))


def phase_resume_killed(sg, children, g9):
    """Phase 9's grid in three processes of their own, with a warm start
    and a journal each: the warm one on phase 9's root A and the killed
    one (by the fault plane, on root B) sweep together; once the killed
    one is dead and its journal checked, the resumed one starts on root
    B.  Returns what :func:`phase_resume_rest` needs: it collects the
    resumed and the warm child after phases 10-12, which run in this
    process meanwhile (they check and time nothing of the grid)."""
    import signal
    from hlsjs_p2p_wrapper_tpu_torch.engine.artifact_cache import (
        journal_path, read_jsonl_tolerant)
    grid = g9["grid"]
    ready, t_go = {}, {}
    for name in ("warm", "killed"):
        ready[name], t_go[name] = _child_go(name, children[name])
    rc, killed, wall_killed = _child_end("killed", children["killed"],
                                         t_go["killed"])
    check(rc == -signal.SIGKILL, _child_failure(
        "killed", children["killed"], f"did not die by SIGKILL ({rc})"))
    path = journal_path(os.path.join(WARM_DIR, "B"), grid_meta(sg, grid))
    lines = list(read_jsonl_tolerant(path))
    journaled = sum(r.get("kind") == "row" for r in lines)
    check(journaled == KILLED_ROWS and not any(
        r.get("kind") == "done" for r in lines),
        f"the killed child's journal holds {journaled} rows "
        f"(want {KILLED_ROWS}) and kinds {[r.get('kind') for r in lines]}")
    ready["resumed"], t_go["resumed"] = _child_go("resumed",
                                                  children["resumed"])
    startup = {k: v["startup_s"] for k, v in ready.items()}
    pre = [r["prefilter_s"] for r in killed if "prefilter_s" in r]
    card = [r["card_s"] for r in killed if "card_s" in r]
    log(f"[35] phase 9's grid ({len(grid)} points x {GRID_PEERS:,} peers x "
        f"{GRID_SEGMENTS} segments x {g9['n_steps']} steps, chunks of "
        f"{GRID_CHUNK}) in three processes started beside phase 5's plain "
        f"run, each with a warm start and a journal; a child's wall is its "
        f"start-up (imports, beside phase 5: {json.dumps(startup)} s) and "
        f"its sweep (the card made ready first)")
    log(f"    killed ({KILL_PLAN}, root B, beside the warm one): exit "
        f"{-signal.SIGKILL}, wall {startup['killed'] + wall_killed!r} s "
        f"(its sweep {wall_killed!r} s to its death, the host's clock from "
        f"its go; the card made ready in {card[0] if card else None!r} s), "
        f"its prefilter {pre[0] if pre else None!r} s; its journal "
        f"holds {journaled} rows (chunk 0 drained before the kill), no done "
        f"line; the resumed child starts, beside phases 10-12")
    return {"startup": startup, "t_go": t_go}


def phase_resume_rest(children, g9, started):
    """The resumed child (the journaled rows served as hits, the rest
    dispatched, all rows phase 9's to the bit, the journal finalized)
    and the warm one (every row a hit, nothing built, captured or
    launched)."""
    want = g9["rows"]
    n = len(want)
    startup, t_go = started["startup"], started["t_go"]
    out = {}
    for name in ("resumed", "warm"):
        rc, records, _wall = _child_end(name, children[name], t_go[name])
        check(rc == 0, _child_failure(name, children[name], "failed"))
        out[name] = records[-1]
    res, hot = out["resumed"], out["warm"]
    check(res["journal_rows_at_open"] == KILLED_ROWS
          and res["row_hits"] == KILLED_ROWS
          and res["row"] == {"hit": KILLED_ROWS, "miss": n - KILLED_ROWS,
                             "store": n - KILLED_ROWS}
          and res["chunks"] == -(-(n - KILLED_ROWS) // GRID_CHUNK)
          and res["journal_finished"],
          f"the resumed child: {json.dumps(res)}")
    check(_rows_hex_equal(_child_rows("resumed"), want),
          "the resumed child's rows differ from phase 9's")
    check(hot["row_hits"] == n and hot["row"] == {"hit": n}
          and hot["chunks"] == 0 and hot["builds"] == 0
          and hot["captures"] == 0
          and not any(hot["launches"].values()),
          f"the warm child: {json.dumps(hot)}")
    check(_rows_hex_equal(_child_rows("warm"), want),
          "the warm child's rows differ from phase 9's")
    log(f"[35] resumed (root B, beside phases 10-12): wall "
        f"{startup['resumed'] + res['wall_s']!r} s (sweep "
        f"{res['wall_s']!r} s: the card made ready {res['card_s']!r} s, "
        f"prefilter {res['prefilter_s']!r} s); "
        f"{res['journal_rows_at_open']} journaled rows served as hits, "
        f"{res['chunks']} chunks dispatched; row events "
        f"{json.dumps(res['row'])}, library events "
        f"{json.dumps(res['executable'])}, builds {res['builds']}, "
        f"captures {res['captures']}; its {n} rows equal phase 9's to the "
        f"bit (float.hex, timeline bytes); journal finalized")
    log(f"    warm (root A, beside the killed one): wall "
        f"{startup['warm'] + hot['wall_s']!r} s (sweep {hot['wall_s']!r} "
        f"s: the card made ready {hot['card_s']!r} s, prefilter "
        f"{hot['prefilter_s']!r} s); row events "
        f"{json.dumps(hot['row'])}, builds {hot['builds']}, captures "
        f"{hot['captures']}, launches {sum(hot['launches'].values())}, "
        f"chunks {hot['chunks']}; rows equal phase 9's to the bit; device "
        f"{hot['device']}")


def phase_lane_sums(sim, sk):
    """TK4 on random byte counters (made on the card from a seed, as
    large as a swarm's after a watch window) at each of SUMS_PEERS ×
    SUMS_LANES: its sums within REDUCE_RTOL of ``lane_sums_plain``, its
    series entry the ratio of its own sums, the bits of
    ``lane_sums_in_order`` (the order ``peer_update``'s epilogue shares),
    and each lane alone the bits of its batch.  Returns ``(max abs
    series error, max relative error of the sums)``."""
    import types

    import torch
    gen = torch.Generator(device="cuda")
    worst_ser, worst_rel = 0.0, 0.0
    for P in SUMS_PEERS:
        for B in SUMS_LANES:
            gen.manual_seed(P * 100 + B)
            counters = [torch.rand((B, P), generator=gen, device="cuda")
                        .mul_(2e7).floor_() for _ in range(2)]
            counters[1][:, ::7] = 0.0   # peers that fetched nothing
            st = types.SimpleNamespace(cdn_bytes=counters[0],
                                       p2p_bytes=counters[1])
            ser_k = torch.zeros((B, 2), dtype=torch.float32, device="cuda")
            ser_p = ser_k.clone()
            sums_k = sk.lane_sums(st, ser_k, 1)
            sums_p = sk.lane_sums_plain(st, ser_p, 1)
            twin = sk.lane_sums_in_order(st)
            torch.cuda.synchronize()
            label = f"lane_sums {B} x {P:,}"
            rel = _rel_err(sums_k, sums_p)
            ser_err = float((ser_k - ser_p).abs().max())
            check(rel <= REDUCE_RTOL and ser_err <= REDUCE_RTOL,
                  f"{label}: sums off by {rel!r} relative, series by "
                  f"{ser_err!r}")
            c, p = sums_k[:, 0], sums_k[:, 1]
            check(torch.equal(ser_k[:, 1], p / torch.clamp_min(p + c, 1.0))
                  and bool((ser_k[:, 0] == 0).all()),
                  f"{label}: the series entry is not its sums' ratio")
            check(torch.equal(sums_k, twin),
                  f"{label}: sums {sums_k[:2].tolist()} are not "
                  f"lane_sums_in_order's {twin[:2].tolist()}")
            for b in {0, B - 1}:
                alone = sk.lane_sums(types.SimpleNamespace(
                    cdn_bytes=counters[0][b:b + 1].clone(),
                    p2p_bytes=counters[1][b:b + 1].clone()))
                check(torch.equal(alone[0], sums_k[b]),
                      f"{label}: lane {b} alone differs from its batch")
            worst_ser, worst_rel = max(worst_ser, ser_err), max(worst_rel,
                                                                 rel)
            del counters, st, twin
    log(f"[10] lane_sums at {list(SUMS_PEERS)} peers x {list(SUMS_LANES)} "
        f"lanes: within {REDUCE_RTOL} of its plain version (max rel err "
        f"{worst_rel!r}), equal to lane_sums_in_order to the bit, lanes "
        f"alone equal to their batch")
    return worst_ser, worst_rel


def phase_live_kernels(sim, sk, sg):
    """Every step kernel against its plain version on the LIVE_POINTS
    lanes at the sweep's size, at the two states of LIVE_CHECK_STEPS:
    ``select_admit``, TK1 and TK2 on the ring and on WIDE_OFFSETS, and
    ``peer_update`` on both; the live branches shown to bind.  Returns
    ``{kernel: max abs float error}``."""
    import torch
    t0 = time.perf_counter()
    config = sg.build_config(GRID_PEERS, GRID_SEGMENTS, True, 8)
    wide = config._replace(neighbor_offsets=WIDE_OFFSETS)
    grid = [sg.live_grid()[i] for i in LIVE_POINTS]
    scenario, _joins = build_lanes(sim, sg, config, grid, GRID_WATCH_S)
    state = sim.init_swarm(config, device="cuda", batch=len(grid))
    errs, total = {}, {}
    for n_steps in (LIVE_CHECK_STEPS, LIVE_CHECK_MORE):
        for _ in range(n_steps):
            state = sk.plain_step(config, scenario, state)
        torch.cuda.synchronize()
        label = (f"live {len(grid)} lanes x {GRID_PEERS:,} peers at "
                 f"t = {float(state.t_s[0])!r} s")
        log(f"[11] {label} x {GRID_SEGMENTS} segments (points "
            f"{list(LIVE_POINTS)}): plain path warmed in "
            f"{time.perf_counter() - t0:.2f} s")
        e = compare_kernels(sim, sk, config, scenario, state, label)
        wide_label = f"{label}, offsets {WIDE_OFFSETS}"
        for name, v in compare_kernels_pair(sim, sk, wide, scenario, state,
                                            wide_label).items():
            e[name] = max(e[name], v)
        e["peer_update"] = max(e["peer_update"], compare_peer_update(
            sim, sk, wide, scenario, state, wide_label)[0])
        counts = live_branch_counts(sim, sk, config, scenario, state)
        counts["waiting"] = int((state.fg_wait_ms > 0).sum())
        log(f"  {label}: TK1 + TK2 and peer_update agree on offsets "
            f"{WIDE_OFFSETS} too; max float err {json.dumps(e)}; peers "
            f"each live branch binds {json.dumps(counts)}")
        for name, v in e.items():
            errs[name] = max(errs.get(name, 0.0), v)
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    idle = [name for name, n in total.items() if n == 0]
    check(not idle, f"live branches idle at both states: {idle}")
    return errs


def phase_live_fixture():
    """The port's batched live run against the committed live fixture:
    ratios and series within RUN_TOL, the timeline's clock and count
    columns equal, the port's joins the fixture's to the bit."""
    import numpy as np
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.testing import (REFERENCE_LIVE,
                                                     run_live_fixture)
    d = np.load(REFERENCE_LIVE)
    offload, rebuffer, series, timeline, joins, fg_wait = run_live_fixture(
        d, "cuda")
    torch.cuda.synchronize()
    offload, rebuffer = offload.cpu().numpy(), rebuffer.cpu().numpy()
    series, timeline = series.cpu().numpy(), timeline.cpu().numpy()
    errs = {"offload": float(np.abs(offload - d["offload"]).max()),
            "rebuffer": float(np.abs(rebuffer - d["rebuffer"]).max()),
            "series": float(np.abs(series - d["series"]).max())}
    waits = int((fg_wait.cpu().numpy() != d["fg_wait_ms"]).sum())
    log(f"[12] live fixture {d['shape'].tolist()} (peers, segments, steps, "
        f"record_every, lanes), points {d['points'].tolist()}: offload "
        f"{offload.tolist()} (JAX {d['offload'].tolist()}), rebuffer "
        f"{rebuffer.tolist()} (JAX {d['rebuffer'].tolist()}); max abs err "
        f"{json.dumps(errs)}; final wait clocks differing from JAX's: "
        f"{waits} of {fg_wait.numel()}")
    check(np.array_equal(joins.cpu().numpy(), d["join_s"]),
          "the port's live joins are not the fixture's")
    check(max(errs.values()) <= RUN_TOL,
          "the port's live run disagrees with the JAX live fixture")
    cols = list(d["columns"])
    exact = [i for i, c in enumerate(cols)
             if c in ("t_s", "stalled_peers") or c.startswith("level_")]
    check(np.array_equal(timeline[..., exact], d["timeline"][..., exact]),
          "the live fixture's clock or count columns differ")


def _rounded(off, reb):
    return round(off, OFFLOAD_DIGITS), round(reb, REBUFFER_DIGITS)


def phase_live_grid(sim, sk, sg, dp):
    """The live sweep at its real size: the 144-point live grid through
    ``run_batch_chunked`` with the autotuned chunk, launches checked per
    chunk, each last row its final ratios, the tail chunk's lanes rerun
    inside a larger chunk to the bit, and the rows held to the
    reference's record after its rounding.  Returns what the report
    needs."""
    import numpy as np
    import torch
    config = sg.build_config(GRID_PEERS, GRID_SEGMENTS, True, 8)
    grid = sg.live_grid()
    n_steps = int(GRID_WATCH_S * 1000.0 / config.dt_ms)
    n_rows = n_steps // GRID_RECORD_EVERY
    cols = sim.timeline_columns(config)

    def build(knobs):
        return sg.build_scenario(config, knobs, watch_s=GRID_WATCH_S,
                                 stagger_s=GRID_STAGGER_S, seed=0,
                                 device="cuda")

    def run(items, chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = dp.run_batch_chunked(config, items, build, n_steps,
                                    watch_s=GRID_WATCH_S, chunk=chunk,
                                    record_every=GRID_RECORD_EVERY)
        torch.cuda.synchronize()
        return rows, time.perf_counter() - t0

    chunk = sim.autotune_chunk(config, len(grid), n_steps,
                               record_every=GRID_RECORD_EVERY,
                               scenario=build(grid[0])[0], device="cuda")
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    rows, wall = run(grid, None)
    launches = dict(sk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    starts = list(range(0, len(grid), chunk))
    sizes = [min(chunk, len(grid) - a) for a in starts]
    peer_steps = len(grid) * GRID_PEERS * n_steps
    log(f"[13] live grid: {len(grid)} points x {GRID_PEERS:,} peers x "
        f"{GRID_SEGMENTS} segments x {n_steps} steps, a row every "
        f"{GRID_RECORD_EVERY} steps; autotuned chunk {chunk} (chunks "
        f"{sizes}); wall {wall!r} s, {len(grid) / wall!r} grid points/s, "
        f"{peer_steps / wall:,.0f} peer-steps/s; launches "
        f"{json.dumps(launches)}; peak memory {peak:,} B")
    n_chunks = len(sizes)
    want = {"select_admit": n_steps * n_chunks, "elig_select": 0,
            "admit_service": 0, "peer_update": n_steps * n_chunks,
            "lane_sums": 2 * n_chunks,
            "timeline_row": (n_rows + 1) * n_chunks,
            "timeline_row_cohorts": 0, **{k: 0 for k in sk.GATHER_PATH}}
    check(launches == want, f"live grid launches {launches}, not {want}")
    for i, (off, reb, tl) in enumerate(rows):
        check(0.0 <= off <= 1.0 and 0.0 <= reb <= 1.0,
              f"live point {i}: ratios out of range {off!r} {reb!r}")
        check(tl.shape == (n_rows, len(cols)) and np.isfinite(tl).all(),
              f"live point {i}: timeline {tl.shape} not finite")
        last = tl[-1]
        check(float(last[cols.index("t_s")]) == GRID_WATCH_S
              and float(last[cols.index("offload")]) == off
              and float(last[cols.index("rebuffer")]) == reb,
              f"live point {i}: the last timeline row {last[:3].tolist()} "
              f"is not its final ratios {off!r} {reb!r}")

    # the tail chunk's lanes inside a larger chunk, with the lanes before
    first = len(grid) - LIVE_TAIL_CHUNK
    check(sizes[-1] < LIVE_TAIL_CHUNK <= len(grid),
          f"the tail chunk ({sizes[-1]} lanes) does not fit inside "
          f"{LIVE_TAIL_CHUNK}")
    tail, wall_tail = run(grid[first:], LIVE_TAIL_CHUNK)
    check(_rows_equal(tail, rows[first:]),
          f"points {first}..{len(grid) - 1} in one chunk of "
          f"{LIVE_TAIL_CHUNK} differ from the autotuned chunks' rows")

    # the reference's record, and HEAD's reference where it was re-run
    with open(os.path.join(ROOT, REFERENCE_LIVE_SWEEP)) as fh:
        record = json.load(fh)
    meta = record["meta"]
    check((meta["peers"], meta["segments"], meta["watch_s"], meta["live"])
          == (GRID_PEERS, GRID_SEGMENTS, GRID_WATCH_S, True),
          f"{REFERENCE_LIVE_SWEEP} is not at this grid's size: {meta}")
    by_knobs = {tuple(r[k] for k in grid[0]): r for r in record["rows"]}
    ref = []
    for i, knobs in enumerate(grid):
        r = by_knobs[tuple(knobs.values())]
        ref.append(LIVE_ANCHOR.get(i, (r["offload"], r["rebuffer"])))
    mine = [_rounded(off, reb) for off, reb, _tl in rows]
    stalling = sum(reb > 0.0 for _off, reb in mine)
    ref_stalling = sum(reb > 0.0 for _off, reb in ref)
    diffs = {i: (abs(m[0] - r[0]), abs(m[1] - r[1]))
             for i, (m, r) in enumerate(zip(mine, ref)) if m != r}
    worst = max((max(d) for d in diffs.values()), default=0.0)
    log(f"    rows equal the reference's at {len(grid) - len(diffs)} of "
        f"{len(grid)} points after its rounding ({OFFLOAD_DIGITS} and "
        f"{REBUFFER_DIGITS} digits; {REFERENCE_LIVE_SWEEP}, a TPU's run, "
        f"and at points {sorted(LIVE_ANCHOR)} the reference at HEAD re-run "
        f"on a CPU); {stalling} points stall (reference {ref_stalling}); "
        f"largest difference {worst!r}; points that differ "
        f"(offload, rebuffer differences) "
        f"{json.dumps({i: d for i, d in sorted(diffs.items())})}; "
        f"chunk {LIVE_TAIL_CHUNK} of points {first}..{len(grid) - 1}: "
        f"{wall_tail!r} s, rows equal to the bit; each last timeline row "
        f"equals its final ratios")
    check(stalling == ref_stalling,
          f"{stalling} live points stall, the reference {ref_stalling}")
    check(worst <= LIVE_ROW_TOL,
          f"live rows differ from the reference by {worst!r}, more than "
          f"{LIVE_ROW_TOL}")
    return {"config": config, "launches": launches, "chunk": chunk,
            "n_steps": n_steps, "wall": wall, "build": build, "grid": grid}


def phase_live_trace(sim, sk, g):
    """A LIVE_TRACE_LANES-lane live chunk (the grid's first points): one
    direct run as graphs timed (its final state kept), the run traced
    whole (device busy time and idle share), TRACE_STEPS eager steps
    from its final state traced per kernel, and each kernel's bytes for
    one of those steps."""
    import torch
    config, build = g["config"], g["build"]
    built = [build(k) for k in g["grid"][:LIVE_TRACE_LANES]]
    scenario = sim.stack_pytrees([sc for sc, _ in built])
    del built
    B = scenario.join_s.shape[0]
    init = sim.init_swarm(config, device="cuda", batch=B)
    sk.reset_launch_counts()
    wall, cap, (final, _series, _tl) = timed_run(
        sim, sk, config, scenario, init, g["n_steps"], "graph",
        record_every=GRID_RECORD_EVERY)
    del _series, _tl
    busy, wall_ms, traced, others = trace_steps(
        sim, sk, config, scenario, init, g["n_steps"], "graph",
        record_every=GRID_RECORD_EVERY)
    del init
    _busy, _wall, e_traced, _other = trace_steps(
        sim, sk, config, scenario, final, TRACE_STEPS, "eager",
        record_every=GRID_RECORD_EVERY)
    before, st = sim.clone_state(final), sim.clone_state(final)
    flags, req, service, adm = sk.select_admit(config, scenario, st)
    sk.peer_update(config, scenario, st, flags, req, service, adm)
    nbytes = step_bytes(sim, sk, config, scenario, before, flags, req, adm,
                        st)
    del before, st, final
    bound = {k: b / HBM_BYTES_PER_S * 1e3 for k, b in nbytes.items()}
    idle = None if busy is None else 1.0 - busy / wall_ms
    log(f"[14] live chunk of {B} lanes x {GRID_PEERS:,} peers x "
        f"{g['n_steps']} steps (graphs): {wall!r} s ({cap!r} s of it in "
        f"captures; {wall * 1e3 / g['n_steps']!r} ms per step); traced "
        f"whole: device busy {busy!r} ms per step, idle {idle!r} of the "
        f"traced host wall ({wall_ms!r} ms per step; per kernel "
        f"{json.dumps(traced)}; "
        f"{other_ops(others, g['n_steps'], 'live graph run')})")
    log(f"    per kernel (launches, traced mean ms), {TRACE_STEPS} eager "
        f"steps from the final state: {json.dumps(e_traced)}; bytes "
        f"{json.dumps({k: nbytes[k] for k in MAIN_PATH})}; bound ms at "
        f"3.35 TB/s {json.dumps({k: bound[k] for k in MAIN_PATH})}; "
        f"traced / bound "
        f"{json.dumps({k: e_traced[k][1] / bound[k] for k in MAIN_PATH if k in e_traced})}")
    return {"traced": e_traced, "bytes": nbytes, "bound_ms": bound,
            "idle": idle, "wall": wall}


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
    """The direct 48-lane run of the grid traced whole, as the graphs
    replay it and through the eager loop (device busy time and idle
    share); TRACE_STEPS eager steps from its final state traced per
    kernel (the windows of earlier runs), and TRACE_PAIR_STEPS on the
    TK1 + TK2 route; each kernel's bytes for one of those steps; and the
    two reductions timed (CUDA events, 200 launches back to back)
    against their plain versions and ``torch.sum``."""
    import torch
    config, scenario, final = g["config"], g["scenario"], g["final"]
    B, P = final.rebuffer_s.shape
    init = sim.init_swarm(config, device="cuda", batch=B)
    busy, wall_ms, traced, g_other = trace_steps(
        sim, sk, config, scenario, init, g["n_steps"], "graph",
        record_every=GRID_RECORD_EVERY)
    run_busy, run_wall_ms, run_traced, e_other = trace_steps(
        sim, sk, config, scenario, init, g["n_steps"], "eager",
        record_every=GRID_RECORD_EVERY)
    del init
    _busy, _wall, e_traced, _other = trace_steps(
        sim, sk, config, scenario, final, TRACE_STEPS, "eager",
        record_every=GRID_RECORD_EVERY)
    pair_busy, _wall, pair_traced, _other = trace_steps(
        sim, sk, config, scenario, final, TRACE_PAIR_STEPS, "pair")
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
    ls_traced = trace_calls(lambda: sk.lane_sums(final, series, 0), 20)
    traced_ms = {**{k: v[1] for k, v in pair_traced.items()},
                 **{k: v[1] for k, v in e_traced.items()}}
    traced_ms["lane_sums"] = ls_traced.get("lane_sums")
    bound = {k: b / HBM_BYTES_PER_S * 1e3 for k, b in nbytes.items()}
    if run_busy is None:
        log("[9] trace at B = 48: torch.profiler recorded no device op; "
            "device busy time and idle share not measured")
    else:
        if busy is None:
            busy = run_busy
            how = ("torch.profiler holds none of the graphs' kernels, so "
                   "their busy time is the eager loop's")
        else:
            how = f"per kernel {json.dumps(traced)}"
        log(f"[9] the direct {B}-lane run traced whole ({g['n_steps']} "
            f"steps from the start, a row every {GRID_RECORD_EVERY}; "
            f"torch.profiler): graphs device busy {busy!r} ms per step, "
            f"idle {1.0 - busy / wall_ms!r} of the traced host wall "
            f"({wall_ms!r} ms per step; {how}); eager loop busy "
            f"{run_busy!r} ms per step, idle "
            f"{1.0 - run_busy / run_wall_ms!r} ({run_wall_ms!r} ms per "
            f"step; per kernel {json.dumps(run_traced)}); untraced, the "
            f"direct runs took {g['wall48'] * 1e3 / g['n_steps']!r} "
            f"(graphs) and {g['wall_eager'] * 1e3 / g['n_steps']!r} "
            f"(eager) ms per step; TK1 + TK2 route busy {pair_busy!r} ms "
            f"per step ({TRACE_PAIR_STEPS} steps from the final state)")
        log(f"    besides the kernels at B = {B}: graphs "
            f"{other_ops(g_other, g['n_steps'], 'B = 48 graph run')}; "
            f"eager loop "
            f"{other_ops(e_other, g['n_steps'], 'B = 48 eager run')}")
    log(f"    per kernel at B = {B} (launches, traced mean ms): eager, "
        f"{TRACE_STEPS} steps from the final state {json.dumps(e_traced)}, "
        f"TK1 + TK2 route "
        f"{json.dumps(pair_traced)}, lane_sums alone {json.dumps(ls_traced)}"
        f"; bytes {json.dumps(nbytes)}; bound ms at 3.35 TB/s "
        f"{json.dumps(bound)}; traced / bound "
        f"{json.dumps({k: v / bound[k] for k, v in traced_ms.items() if v})}")
    log(f"    reductions at B = {B}, {BACK_TO_BACK} launches back to back "
        f"(CUDA events): {json.dumps(ms)} ms; plain versions "
        f"{json.dumps(plain)} ms; torch.sum of p2p_bytes and cdn_bytes "
        f"(two calls) {library!r} ms")
    # as traced: lane_sums once, for the timeline's first interval
    launches = {k: v[0] for k, v in {**pair_traced, **e_traced}.items()}
    window = (f"traced: {TRACE_STEPS} eager steps from the final state, a "
              f"row every {GRID_RECORD_EVERY} (lane_sums: the timeline's "
              f"first interval); elig_select and admit_service: "
              f"{TRACE_PAIR_STEPS} steps on their route")
    return {"traced_ms": traced_ms, "bytes": nbytes, "bound_ms": bound,
            "launches": launches, "launches_in": window, "ms": ms,
            "plain_ms": plain, "library_ms": library}


def phase_prefetch_kernels(sim, sk):
    """Every step kernel against its plain version with three transfer
    slots: the prefetch fixture's lanes at GRID_PEERS × GRID_SEGMENTS,
    at the two states of PREFETCH_CHECK_STEPS, ``select_admit``, TK1 and
    TK2 on the ring and on WIDE_OFFSETS, and ``peer_update`` on both;
    every prefetch branch shown to bind.  Then the generic instantiation
    at each of GENERIC_SLOTS.  Returns ``{kernel: max abs float
    error}``."""
    import numpy as np
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.testing import (REFERENCE_PREFETCH,
                                                     prefetch_lanes)
    t0 = time.perf_counter()
    d = np.load(REFERENCE_PREFETCH)
    config, scenario, _joins, _leaves = prefetch_lanes(
        d, "cuda", peers=GRID_PEERS, segments=GRID_SEGMENTS,
        watch_s=PREFETCH_WATCH_S)
    wide = config._replace(neighbor_offsets=WIDE_OFFSETS)
    B, C = scenario.join_s.shape[0], config.max_concurrency
    state = sim.init_swarm(config, device="cuda", batch=B)
    errs, total = {}, {}

    def merge(e):
        for name, v in e.items():
            errs[name] = max(errs.get(name, 0.0), v)
    for n_steps in (PREFETCH_CHECK_STEPS, PREFETCH_CHECK_MORE):
        for _ in range(n_steps):
            state = sk.plain_step(config, scenario, state)
        torch.cuda.synchronize()
        label = (f"C = {C}, {B} lanes x {GRID_PEERS:,} peers at t = "
                 f"{float(state.t_s[0])!r} s")
        log(f"[15] {label} x {GRID_SEGMENTS} segments (the prefetch "
            f"fixture's cells {str(d['cells'])}, lane "
            f"{int(d['leave_lane'])} with its departure wave): plain path "
            f"warmed in {time.perf_counter() - t0:.2f} s")
        e = compare_kernels(sim, sk, config, scenario, state, label)
        wide_label = f"{label}, offsets {WIDE_OFFSETS}"
        for name, v in compare_kernels_pair(sim, sk, wide, scenario, state,
                                            wide_label).items():
            e[name] = max(e[name], v)
        e["peer_update"] = max(e["peer_update"], compare_peer_update(
            sim, sk, wide, scenario, state, wide_label)[0])
        counts = prefetch_branch_counts(sim, sk, config, scenario, state)
        log(f"  {label}: TK1 + TK2 and peer_update agree on offsets "
            f"{WIDE_OFFSETS} too; max float err {json.dumps(e)}; (peer, "
            f"slot) pairs each prefetch branch binds {json.dumps(counts)}")
        merge(e)
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
    idle = [name for name, n in total.items() if n == 0]
    log(f"    prefetch branches over both states: {json.dumps(total)}")
    check(not idle, f"prefetch branches idle at both states: {idle}")
    del state, scenario
    for slots, peers, steps in GENERIC_SLOTS:
        cfg, scen, _j, _l = prefetch_lanes(
            d, "cuda", peers=peers, segments=GRID_SEGMENTS,
            watch_s=PREFETCH_WATCH_S, slots=slots)
        st = sim.init_swarm(cfg, device="cuda", batch=scen.join_s.shape[0])
        for _ in range(steps):
            st = sk.plain_step(cfg, scen, st)
        label = f"C = {slots} (the generic instantiation), {peers:,} peers"
        merge(compare_kernels(sim, sk, cfg, scen, st, label))
        a, b = sim.clone_state(st), sim.clone_state(st)
        for _ in range(ROUTE_STEPS):
            a = sim.swarm_step(cfg, scen, a)
            b = sk.plain_step(cfg, scen, b)
        merge({"peer_update": compare(f"{label} {ROUTE_STEPS} steps",
                                      a._asdict(), b._asdict())})
    return errs


def phase_prefetch_fixture(label="[16]"):
    """The port's batched run with three transfer slots against the
    committed prefetch fixture: ratios and series within RUN_TOL, the
    timeline's clock and count columns equal, the port's joins and
    leaves the fixture's to the bit."""
    import numpy as np
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.testing import (REFERENCE_PREFETCH,
                                                     run_prefetch_fixture)
    d = np.load(REFERENCE_PREFETCH)
    offload, rebuffer, series, timeline, joins, leaves = (
        run_prefetch_fixture(d, "cuda"))
    torch.cuda.synchronize()
    offload, rebuffer = offload.cpu().numpy(), rebuffer.cpu().numpy()
    series, timeline = series.cpu().numpy(), timeline.cpu().numpy()
    errs = {"offload": float(np.abs(offload - d["offload"]).max()),
            "rebuffer": float(np.abs(rebuffer - d["rebuffer"]).max()),
            "series": float(np.abs(series - d["series"]).max())}
    log(f"{label} prefetch fixture {d['shape'].tolist()} (peers, segments, "
        f"steps, record_every, lanes), cells {str(d['cells'])}: offload "
        f"{offload.tolist()} (JAX {d['offload'].tolist()}), rebuffer "
        f"{rebuffer.tolist()} (JAX {d['rebuffer'].tolist()}); max abs err "
        f"{json.dumps(errs)}")
    check(np.array_equal(joins.cpu().numpy(), d["join_s"])
          and np.array_equal(leaves.cpu().numpy(), d["leave_s"]),
          "the port's prefetch joins or leaves are not the fixture's")
    check(max(errs.values()) <= RUN_TOL,
          "the port's prefetch run disagrees with the JAX prefetch fixture")
    cols = list(d["columns"])
    exact = [i for i, c in enumerate(cols)
             if c in ("t_s", "stalled_peers") or c.startswith("level_")]
    check(np.array_equal(timeline[..., exact], d["timeline"][..., exact]),
          "the prefetch fixture's clock or count columns differ")


def phase_policy_kernels(sim, sk):
    """The holder policies' step kernels against their plain versions:
    each case of POLICY_CASES on the prefetch fixture's lanes at
    GRID_PEERS × GRID_SEGMENTS, at the two states of
    PREFETCH_CHECK_STEPS (reached by the kernels' own steps),
    ``select_admit``, TK1 and TK2 on the ring and on WIDE_OFFSETS, and
    ``peer_update`` on both, the penalty window to the bit; every policy
    branch shown to bind (:func:`policy_branch_counts`).  Then both
    policies at each of POLICY_WRAP_PEERS, where ranked's ids wrap: one
    call of each kernel and ROUTE_STEPS steps against the plain step.
    Returns ``({kernel: max abs float error}, {policy: branch counts})``."""
    import numpy as np
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.testing import (REFERENCE_PREFETCH,
                                                     prefetch_lanes)
    d = np.load(REFERENCE_PREFETCH)
    errs, total = {}, {p: {} for p in POLICIES}

    def merge(e, counts=None, policy=None):
        for name, v in e.items():
            errs[name] = max(errs.get(name, 0.0), v)
        for name, n in (counts or {}).items():
            total[policy][name] = total[policy].get(name, 0) + n
    for policy, slots, live in POLICY_CASES:
        t0 = time.perf_counter()
        config, scenario, _j, _l = prefetch_lanes(
            d, "cuda", peers=GRID_PEERS, segments=GRID_SEGMENTS,
            watch_s=PREFETCH_WATCH_S, slots=slots, policy=policy)
        config = config._replace(live=live)
        wide = config._replace(neighbor_offsets=WIDE_OFFSETS)
        B = scenario.join_s.shape[0]
        state = sim.init_swarm(config, device="cuda", batch=B)
        for n_steps in (PREFETCH_CHECK_STEPS, PREFETCH_CHECK_MORE):
            for _ in range(n_steps):
                state = sim.swarm_step(config, scenario, state)
            torch.cuda.synchronize()
            label = (f"{policy}, C = {slots}{', live' if live else ''}, "
                     f"{B} lanes x {GRID_PEERS:,} peers at t = "
                     f"{float(state.t_s[0])!r} s")
            windows = (f"; {int((state.holder_penalty_ms > 0).sum())} "
                       f"penalty windows open" if policy == "adaptive"
                       else "")
            log(f"[22] {label} x {GRID_SEGMENTS} segments (the prefetch "
                f"fixture's cells): warmed by the kernels in "
                f"{time.perf_counter() - t0:.2f} s{windows}")
            e = compare_kernels(sim, sk, config, scenario, state, label)
            wide_label = f"{label}, offsets {WIDE_OFFSETS}"
            for name, v in compare_kernels_pair(sim, sk, wide, scenario,
                                                state, wide_label).items():
                e[name] = max(e[name], v)
            e["peer_update"] = max(e["peer_update"], compare_peer_update(
                sim, sk, wide, scenario, state, wide_label)[0])
            counts = policy_branch_counts(sim, sk, config, scenario, state)
            log(f"  {label}: TK1 + TK2 and peer_update agree on offsets "
                f"{WIDE_OFFSETS} too; max float err {json.dumps(e)}; "
                f"(peer, slot) pairs each {policy} branch binds "
                f"{json.dumps(counts)}")
            merge(e, counts, policy)
        del state, scenario
    for peers in POLICY_WRAP_PEERS:
        for policy in POLICIES:
            cfg, scen, _j, _l = prefetch_lanes(
                d, "cuda", peers=peers, segments=GRID_SEGMENTS,
                watch_s=PREFETCH_WATCH_S, policy=policy)
            st = sim.init_swarm(cfg, device="cuda",
                                batch=scen.join_s.shape[0])
            for _ in range(POLICY_WRAP_STEPS):
                st = sk.plain_step(cfg, scen, st)
            label = f"{policy}, C = 3, {peers:,} peers (the ring's wrap)"
            e = compare_kernels(sim, sk, cfg, scen, st, label)
            counts = policy_branch_counts(sim, sk, cfg, scen, st)
            a, b = sim.clone_state(st), sim.clone_state(st)
            for _ in range(ROUTE_STEPS):
                a = sim.swarm_step(cfg, scen, a)
                b = sk.plain_step(cfg, scen, b)
            e["peer_update"] = max(e["peer_update"], compare(
                f"{label} {ROUTE_STEPS} steps", a._asdict(), b._asdict()))
            log(f"[22] {label}: the kernels and {ROUTE_STEPS} steps agree "
                f"with the plain step; max float err {json.dumps(e)}; "
                f"branch counts {json.dumps(counts)}")
            merge(e, counts, policy)
    log(f"    policy branches over every state: {json.dumps(total)}")
    idle = {p: [n for n, v in c.items() if v == 0] for p, c in total.items()}
    check(not any(idle.values()), f"policy branches idle: {idle}")
    check(set(total["ranked"]) >= {f"skip_{s}" for s in range(3)}
          | {"wrap"}, f"ranked's branches counted: {total['ranked']}")
    return errs, total


def phase_policies_fixture(sim):
    """The port's batched runs under each of POLICIES against the
    committed policies fixture: ratios and series within RUN_TOL, the
    timeline's clock and count columns equal, the joins and leaves the
    fixture's to the bit."""
    import numpy as np
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.testing import (REFERENCE_POLICIES,
                                                     run_prefetch_fixture)
    d = np.load(REFERENCE_POLICIES)
    check(tuple(d["policies"]) == POLICIES,
          f"the policies fixture holds {list(d['policies'])}")
    cols = list(d["columns"])
    exact = [i for i, c in enumerate(cols)
             if c in ("t_s", "stalled_peers") or c.startswith("level_")]
    for policy in POLICIES:
        offload, rebuffer, series, timeline, joins, leaves = (
            run_prefetch_fixture(d, "cuda", policy))
        torch.cuda.synchronize()
        offload, rebuffer = offload.cpu().numpy(), rebuffer.cpu().numpy()
        series, timeline = series.cpu().numpy(), timeline.cpu().numpy()
        want = {k: d[f"{policy}_{k}"] for k in ("offload", "rebuffer",
                                                 "series", "timeline")}
        errs = {k: float(np.abs(v - want[k]).max())
                for k, v in (("offload", offload), ("rebuffer", rebuffer),
                             ("series", series))}
        log(f"[23] policies fixture, {policy}: {d['shape'].tolist()} "
            f"(peers, segments, steps, record_every, lanes), cells "
            f"{str(d['cells'])}: offload {offload.tolist()} (JAX "
            f"{want['offload'].tolist()}), rebuffer {rebuffer.tolist()} "
            f"(JAX {want['rebuffer'].tolist()}); max abs err "
            f"{json.dumps(errs)}")
        check(np.array_equal(joins.cpu().numpy(), d["join_s"])
              and np.array_equal(leaves.cpu().numpy(), d["leave_s"]),
              "the port's joins or leaves are not the policies fixture's")
        check(max(errs.values()) <= RUN_TOL,
              f"the port's {policy} run disagrees with the JAX fixture")
        check(np.array_equal(timeline[..., exact],
                             want["timeline"][..., exact]),
              f"the {policy} fixture's clock or count columns differ")


def _random_lanes(d, policy, slots=3, live=False, cap=2, peers=None):
    """The prefetch fixture's lanes on the random mesh at ``peers``
    (GATHER_PEERS when None) × GRID_SEGMENTS (its departure wave on its
    leave lane), the card's."""
    from hlsjs_p2p_wrapper_tpu_torch.testing import prefetch_lanes
    config, scenario, _j, _l = prefetch_lanes(
        d, "cuda", peers=peers or GATHER_PEERS, segments=GRID_SEGMENTS,
        watch_s=PREFETCH_WATCH_S, slots=slots, policy=policy,
        topology="random", max_total_serves=cap)
    return config._replace(live=live), scenario


def _init(sim, config, scenario, batch=None):
    """A fresh state for ``scenario``'s lanes: on the general path with
    the penalty field as wide as its neighbour lists."""
    K = (scenario.neighbors.shape[-1] if config.neighbor_offsets is None
         else None)
    return sim.init_swarm(config, K, device="cuda", batch=batch)


def _denied_by_cap(sim, sk, config, scenario, state, cap=2):
    """On the ring, the demands of the next step that a cap of ``cap``
    would deny: demands placed minus the bits a capped admission sets."""
    import torch
    _f, req = sk.elig_select_plain(config, scenario, sim.clone_state(state))
    _s, adm = sk.admit_service_plain(
        config._replace(max_total_serves=cap), scenario, req)
    bits = sum(int(((adm >> k) & 1).sum()) for k in range(32))
    return int((req >= 0).sum()) - bits


def phase_gather_kernels(sim, sk):
    """The general path's kernels and the uncapped fair share against
    their plain versions.  On the random mesh at GATHER_PEERS: each policy
    at three slots, VOD and live, and spread uncapped, on the prefetch
    fixture's four cells, at the two states of PREFETCH_CHECK_STEPS
    (reached by the kernels' own steps), TK1-gather, TK2-gather and
    TK3-gather (:func:`compare_gather`); then each policy on the meshes of
    GATHER_SMALL, POLICY_WRAP_STEPS steps of the kernels in, one call and
    ROUTE_STEPS steps against the plain step; every gather branch shown
    to bind (:func:`gather_branch_counts`).
    Then the ring uncapped at the main path's shape: the fused kernel,
    TK1 + TK2 and TK3 against their plain versions, with the demands a
    cap would have denied.  Returns ``{kernel: max abs float error}``."""
    import numpy as np
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.testing import REFERENCE_PREFETCH
    d = np.load(REFERENCE_PREFETCH)
    errs, total = {}, {}

    def merge(e, counts=None):
        for name, v in e.items():
            errs[name] = max(errs.get(name, 0.0), v)
        for name, n in (counts or {}).items():
            total[name] = total.get(name, 0) + n
    cases = ([(p, live, 2) for p in ("spread", "adaptive", "ranked")
              for live in (False, True)] + [("spread", False, 0)])
    for policy, live, cap in cases:
        t0 = time.perf_counter()
        config, scenario = _random_lanes(d, policy, live=live, cap=cap)
        B = scenario.join_s.shape[0]
        state = _init(sim, config, scenario, B)
        for n_steps in (PREFETCH_CHECK_STEPS, PREFETCH_CHECK_MORE):
            for _ in range(n_steps):
                state = sim.swarm_step(config, scenario, state)
            torch.cuda.synchronize()
            label = (f"random mesh, {policy}, C = 3{', live' if live else ''}"
                     f"{', uncapped' if cap == 0 else ''}, {B} lanes x "
                     f"{GATHER_PEERS:,} peers at t = "
                     f"{float(state.t_s[0])!r} s")
            log(f"[26] {label} x {GRID_SEGMENTS} segments: warmed by the "
                f"kernels in {time.perf_counter() - t0:.2f} s")
            counts = gather_branch_counts(sim, sk, config, scenario, state)
            log(f"  {label}: branch counts {json.dumps(counts)}")
            merge(compare_gather(sim, sk, config, scenario, state, label),
                  counts)
        del state, scenario
    for peers, degree, k_pad in GATHER_SMALL:
        nbr = sim.random_neighbors(peers, degree, 0, k_pad, device="cuda")
        inv = sim.invert_neighbors(nbr, device="cuda")
        for policy in ("spread", "adaptive", "ranked"):
            config, scen = _random_lanes(d, policy, peers=peers)
            B = scen.join_s.shape[0]
            scen = scen._replace(
                neighbors=nbr.expand(B, *nbr.shape).contiguous(),
                in_edges=inv.expand(B, *inv.shape).contiguous())
            st = _init(sim, config, scen, B)
            for _ in range(POLICY_WRAP_STEPS):
                st = sim.swarm_step(config, scen, st)
            label = (f"random mesh {peers:,} peers, degree {degree}, k_pad "
                     f"{k_pad}, {policy}, C = 3")
            counts = gather_branch_counts(sim, sk, config, scen, st)
            e = compare_gather(sim, sk, config, scen, st, label)
            a, b = sim.clone_state(st), sim.clone_state(st)
            for _ in range(ROUTE_STEPS):
                a = sim.swarm_step(config, scen, a)
                b = sk.plain_step(config, scen, b)
            e["peer_update_gather"] = max(e["peer_update_gather"], compare(
                f"{label} {ROUTE_STEPS} steps", a._asdict(), b._asdict()))
            log(f"[26] {label}: {ROUTE_STEPS} steps agree with the plain "
                f"step; branch counts {json.dumps(counts)}")
            merge(e, counts)
    log(f"    gather branches over every state: {json.dumps(total)}")
    idle = [name for name, n in total.items() if n == 0]
    check(not idle, f"gather branches idle over every state: {idle}")
    # the ring uncapped at the main path's shape
    config, scenario, state = make_case(sim, sk, PEERS, SEGMENTS, 0, "cuda")
    config = config._replace(max_total_serves=0)
    for _ in range(CHECK_WARM_STEPS):
        state = sim.swarm_step(config, scenario, state)
    label = f"ring uncapped, {PEERS:,} peers x {SEGMENTS} segments"
    would = _denied_by_cap(sim, sk, config, scenario, state)
    e = compare_kernels(sim, sk, config, scenario, state, label)
    log(f"[26] {label}: {would} demands of the next step a cap of 2 would "
        f"deny, all admitted")
    check(would > 0, f"{label}: no holder above the cap, the uncapped "
                     f"branch does not bind")
    errs["uncapped"] = max(e.values())
    merge(e)
    return errs, total


def phase_general_fixture(sim):
    """The port's batched runs of the committed general fixture (the
    prefetch fixture's lanes on the random mesh, each of its runs):
    ratios and series within RUN_TOL, the timeline's clock and count
    columns equal, the joins and leaves the fixture's to the bit."""
    import numpy as np
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.testing import (REFERENCE_GENERAL,
                                                     general_runs,
                                                     run_prefetch_fixture)
    d = np.load(REFERENCE_GENERAL)
    cols = list(d["columns"])
    exact = [i for i, c in enumerate(cols)
             if c in ("t_s", "stalled_peers") or c.startswith("level_")]
    worst = 0.0
    for name, policy, cap in general_runs(d):
        offload, rebuffer, series, timeline, joins, leaves = (
            run_prefetch_fixture(d, "cuda", policy, topology="random",
                                 max_total_serves=cap))
        torch.cuda.synchronize()
        offload, rebuffer = offload.cpu().numpy(), rebuffer.cpu().numpy()
        series, timeline = series.cpu().numpy(), timeline.cpu().numpy()
        want = {k: d[f"{name}_{k}"] for k in ("offload", "rebuffer",
                                               "series", "timeline")}
        errs = {k: float(np.abs(v - want[k]).max())
                for k, v in (("offload", offload), ("rebuffer", rebuffer),
                             ("series", series))}
        worst = max(worst, *errs.values())
        log(f"[27] general fixture, {name} ({policy}, max_total_serves "
            f"{cap}): {d['shape'].tolist()} (peers, segments, steps, "
            f"record_every, lanes) on the random mesh: offload "
            f"{offload.tolist()} (JAX {want['offload'].tolist()}), rebuffer "
            f"{rebuffer.tolist()} (JAX {want['rebuffer'].tolist()}); max abs "
            f"err {json.dumps(errs)}")
        check(np.array_equal(joins.cpu().numpy(), d["join_s"])
              and np.array_equal(leaves.cpu().numpy(), d["leave_s"]),
              "the port's joins or leaves are not the general fixture's")
        check(max(errs.values()) <= RUN_TOL,
              f"the port's {name} run disagrees with the general fixture")
        check(np.array_equal(timeline[..., exact],
                             want["timeline"][..., exact]),
              f"the {name} fixture's clock or count columns differ")
    return worst


def _ring_run(dp, g, items, chunk, faults=None):
    """``run_groups_chunked`` of the ring grid's ``items`` in chunks of
    ``chunk`` (autotuned when None): ``(rows, stats, wall seconds)``."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, stats = dp.run_groups_chunked(
        [(g["config"], items, g["build"])], g["n_steps"],
        watch_s=g["watch_s"], chunk=chunk, faults=faults)
    torch.cuda.synchronize()
    return results[0], stats[0], time.perf_counter() - t0


def phase_ring_grid(sim, sk, pg, dp, policy="spread", tag="[17]",
                    topology="ring", peers=RING_PEERS):
    """The ``policy`` column of one of tools/policy_ab.py's tables: the
    ring (``topology="ring"``, at 262,144 peers as the tool runs it) or
    the random mesh (``"random"``, the general path), 20 cells × ``peers``
    × 128 segments × 960 steps, three transfer slots, through
    ``run_batch_chunked`` with a ``FaultPolicy`` armed and the autotuned
    chunk; launches checked; a direct run of the 20 lanes gives the same
    rows, and each last series entry its final offload; two cells alone,
    each a chunk of its own, give their rows to the bit; where the
    record holds the table at ``peers``, the rows held to it after its
    rounding (at the cells ``tools/torch_port_policy_anchor.py`` re-ran
    for the policy, to the reference at HEAD).  Returns what the later
    phases need."""
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.engine.faults import FaultPolicy
    mesh = None
    if topology == "random":
        config = pg.random_config(peers, policy=policy)
        mesh = pg.random_topology(peers, pg.SEED, device="cuda")
    else:
        config = pg.ring_config(peers, policy=policy)
    cells = pg.cells()
    n_steps = int(pg.WATCH_S * 1000.0 / config.dt_ms)
    audience = pg.build_audience(config.n_peers, pg.SEED, device="cuda")

    def build(cell):
        pattern, wave, up = cell
        return pg.build_cell_scenario(config, audience, uplink_bps=up * 1e6,
                                      pattern=pattern, wave=wave,
                                      watch_s=pg.WATCH_S, neighbors=mesh)
    g = {"config": config, "cells": cells, "build": build,
         "n_steps": n_steps, "watch_s": pg.WATCH_S}
    chunk = sim.autotune_chunk(config, len(cells), n_steps,
                               scenario=build(cells[0])[0], device="cuda")
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    faults = FaultPolicy()
    rows, stats, wall = _ring_run(dp, g, cells, None, faults)
    launches = dict(sk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_chunks = -(-len(cells) // chunk)
    peer_steps = len(cells) * config.n_peers * n_steps
    log(f"{tag} {topology} {policy} grid (tools/policy_ab.py): "
        f"{len(cells)} cells x "
        f"{config.n_peers:,} peers x {config.n_segments} segments x "
        f"{n_steps} steps, C = {config.max_concurrency}, a FaultPolicy "
        f"armed; autotuned chunk {chunk} ({n_chunks} chunk(s)); wall "
        f"{wall!r} s, {len(cells) / wall!r} cells/s, "
        f"{peer_steps / wall:,.0f} peer-steps/s; launches "
        f"{json.dumps(launches)}; peak memory {peak:,} B; fault counts "
        f"{json.dumps(faults.fault_counts())}")
    # per chunk: a launch of each step kernel a step; lane_sums once (the
    # final offload ratio), timeline_row once (the final rebuffer ratio)
    want = {name: 0 for name in sk.LAUNCHES}
    want.update(lane_sums=n_chunks, timeline_row=n_chunks)
    for name in (MAIN_PATH if mesh is None else sk.GATHER_PATH):
        want[name] = n_steps * n_chunks
    check(launches == want, f"{topology} grid launches {launches}, not "
                            f"{want}")
    check(stats["chunk"] == chunk and not stats["failures"]
          and faults.fault_counts() == {},
          f"the ring grid recovered from something: {stats}")
    for i, (off, reb) in enumerate(rows):
        check(0.0 <= off <= 1.0 and 0.0 <= reb <= 1.0,
              f"{topology} cell {i}: ratios out of range {off!r} {reb!r}")

    # the 20 lanes as one direct run: the dispatch's rows, each last series
    # entry its final offload
    built = [build(c) for c in cells]
    scenario = sim.stack_pytrees([sc for sc, _ in built])
    joins = torch.stack([j for _, j in built])
    del built
    init = _init(sim, config, scenario, len(cells))
    w20, cap20, (final, series) = timed_run(sim, sk, config, scenario, init,
                                            n_steps, "graph")
    offs = sim.offload_ratio_batch(final)
    rebs = sim.rebuffer_ratio_batch(final, pg.WATCH_S, joins)
    check(torch.equal(series[:, -1], offs),
          "a ring lane's last series entry is not its final offload")
    direct = list(zip(offs.tolist(), rebs.tolist()))
    check(direct == rows, "the direct 20-lane run's rows differ from the "
                          "dispatch's")
    del series
    for i in RING_ALONE:
        (alone,), _stats, _w = _ring_run(dp, g, [cells[i]], 1)
        check(alone == rows[i], f"ring cell {i} alone {alone} differs from "
                                f"its lane {rows[i]}")

    # the reference's record, and HEAD's reference where it was re-run
    with open(os.path.join(ROOT, REFERENCE_POLICY_AB)) as fh:
        record = json.load(fh)
    table = record["topologies"][topology]
    check((record["meta"]["segments"], record["meta"]["watch_s"])
          == (config.n_segments, pg.WATCH_S),
          f"{REFERENCE_POLICY_AB} is not at this grid's segments and watch "
          f"window")
    mine = [_rounded(off, reb) for off, reb in rows]
    held = f"the direct 20-lane run (graphs) {w20!r} s ({cap20!r} s of it "\
        f"in captures), rows equal; cells {list(RING_ALONE)} alone equal "\
        f"to the bit; each last series entry equals its final offload"
    if table["peers"] != config.n_peers:
        log(f"    rows (offload, rebuffer) {json.dumps(mine)}; no record at "
            f"{config.n_peers:,} peers ({REFERENCE_POLICY_AB} holds the "
            f"{topology} table at {table['peers']:,}); {held}")
    else:
        by_cell = {(r["pattern"], r["wave"], r["uplink_mbps"]): r
                   for r in table["rows"]}
        anchor, tol = ((RING_ANCHOR, RING_ROW_TOL) if mesh is None
                       else (RANDOM_ANCHOR, RANDOM_ROW_TOL))
        anchor = anchor[policy]
        ref = [anchor.get(i, (by_cell[c][f"{policy}_offload"],
                              by_cell[c][f"{policy}_rebuffer"]))
               for i, c in enumerate(cells)]
        diffs = {i: (abs(m[0] - r[0]), abs(m[1] - r[1]))
                 for i, (m, r) in enumerate(zip(mine, ref)) if m != r}
        worst = max((max(v) for v in diffs.values()), default=0.0)
        log(f"    rows (offload, rebuffer) {json.dumps(mine)}; equal to the "
            f"reference's at {len(cells) - len(diffs)} of {len(cells)} "
            f"cells after its rounding ({REFERENCE_POLICY_AB}, a TPU's run, "
            f"and at cells {sorted(anchor)} the reference at HEAD re-run on "
            f"a CPU); largest difference {worst!r}; cells that differ "
            f"(offload, rebuffer differences) "
            f"{json.dumps({i: v for i, v in sorted(diffs.items())})}; {held}")
        check(worst <= tol,
              f"{topology} {policy} rows differ from the reference by "
              f"{worst!r}, more than {tol}")
        check(all(mine[i] == r for i, r in anchor.items()),
              f"{topology} {policy} rows differ from HEAD's reference at "
              f"the anchored cells {sorted(anchor)}")
        g["worst"] = worst
    g.update(launches=launches, chunk=chunk, wall=wall, rows=rows,
             scenario=scenario, final=final, peak=peak, policy=policy,
             topology=topology, peer_steps_per_s=peer_steps / wall)
    return g


def phase_ring_trace(sim, sk, g, tag="[18]"):
    """A policy grid's 20-lane chunk traced: the whole run as graphs
    (device busy time and idle share), TRACE_STEPS eager steps from its
    final state per kernel, and each kernel's bytes for one step from
    that state and its bound; CUDA-event times over WINDOW steps from
    that state of TK1 and TK2 on the ring, and on the general path of
    each gather kernel, with its plain version's over PLAIN_STEPS."""
    config, scenario, final = g["config"], g["scenario"], g["final"]
    general = config.neighbor_offsets is None
    path = sk.GATHER_PATH if general else MAIN_PATH
    B = final.t_s.shape[0]
    init = _init(sim, config, scenario, B)
    busy, wall_ms, traced, others = trace_steps(
        sim, sk, config, scenario, init, g["n_steps"], "graph")
    del init
    _busy, _wall, e_traced, _other = trace_steps(
        sim, sk, config, scenario, final, TRACE_STEPS, "eager")
    before, st = sim.clone_state(final), sim.clone_state(final)
    flags, req, service, adm = sk.select_admit(config, scenario, st)
    sk.peer_update(config, scenario, st, flags, req, service, adm)
    nbytes = step_bytes(sim, sk, config, scenario, before, flags, req, adm,
                        st)
    del before, st
    bound = {k: b / HBM_BYTES_PER_S * 1e3 for k, b in nbytes.items()}
    idle = None if busy is None else 1.0 - busy / wall_ms
    out = {"traced": e_traced, "bytes": nbytes, "bound_ms": bound,
           "idle": idle, "busy_ms": busy, "wall_ms": wall_ms}
    log(f"{tag} the {g['topology']} {g['policy']} grid's {B}-lane chunk "
        f"(C = {config.max_concurrency}, {config.n_peers:,} peers, "
        f"{g['n_steps']} steps) traced whole as graphs: device busy "
        f"{busy!r} ms per step, idle {idle!r} of the traced host wall "
        f"({wall_ms!r} ms per step; per kernel {json.dumps(traced)}; "
        f"{other_ops(others, g['n_steps'], 'policy grid graph run')})")
    log(f"    per kernel (launches, traced mean ms), {TRACE_STEPS} eager "
        f"steps from the final state: {json.dumps(e_traced)}; bytes "
        f"{json.dumps({k: nbytes[k] for k in path})}; bound ms at "
        f"3.35 TB/s {json.dumps({k: bound[k] for k in path})}; "
        f"traced / bound "
        f"{json.dumps({k: e_traced[k][1] / bound[k] for k in path if k in e_traced})}")
    if not general:
        # TK1 + TK2, the route of wide spans, from the same state
        pair, _step = time_window(sim, sk, config, scenario, final, WINDOW,
                                  "pair")
        out["pair_ms"] = pair
        log(f"    TK1 + TK2 from the final state (CUDA events, {WINDOW} "
            f"eager steps): ms {json.dumps(pair)}; bytes "
            f"{json.dumps({k: nbytes[k] for k in pair})}; bound ms "
            f"{json.dumps({k: bound[k] for k in pair})}")
    if general:
        ms, _step = time_window(sim, sk, config, scenario, final, WINDOW,
                                "gather")
        plain, _step = time_window(sim, sk, config, scenario, final,
                                   PLAIN_STEPS, "plain_pair")
        plain = dict(zip(sk.GATHER_PATH, plain.values()))
        out.update(ms=ms, plain_ms=plain)
        log(f"    CUDA events, {WINDOW} eager steps from the final state: "
            f"ms {json.dumps(ms)}; the plain versions over {PLAIN_STEPS} "
            f"steps: ms {json.dumps(plain)}")
    return out


def phase_injected_faults(sim, dp, g):
    """The fault plane on the card: the ring grid in chunks of
    FAULT_CHUNK, unfaulted and under each plan of FAULT_PLANS (a
    recording sleep in place of the backoff's): the rows equal the
    unfaulted run's to the bit, the counts are the plan's, and the cells
    of a chunk that exhausted its budget come back as a structured
    failure."""
    from hlsjs_p2p_wrapper_tpu_torch.engine.faults import (FaultPlan,
                                                           FaultPolicy)
    cells = g["cells"]
    base, _stats, wall0 = _ring_run(dp, g, cells, FAULT_CHUNK)
    check(base == g["rows"], f"the ring grid in chunks of {FAULT_CHUNK} "
                             f"differs from its autotuned chunk's rows")
    walls = {"unfaulted": wall0}
    for spec, want in FAULT_PLANS.items():
        sleeps = []
        policy = FaultPolicy(FaultPlan.parse(spec), sleep=sleeps.append)
        rows, stats, wall = _ring_run(dp, g, cells, FAULT_CHUNK, policy)
        walls[spec] = wall
        counts = policy.fault_counts()
        check(counts == want, f"{spec}: fault counts {counts}, not {want}")
        failed = [i for f in stats["failures"] for i in f["items"]]
        gave_up = want.get("transient|giveup", 0)
        lost = list(range(FAULT_CHUNK, 2 * FAULT_CHUNK)) if gave_up else []
        check(failed == lost and all(
            f["reason"] == "transient" and "injected fault" in f["error"]
            for f in stats["failures"]),
            f"{spec}: failures {stats['failures']}")
        check(all((r is None) if i in lost else (r == base[i])
                  for i, r in enumerate(rows)),
              f"{spec}: rows differ from the unfaulted run's")
        check(len(sleeps) == sum(n for k, n in counts.items()
                                 if k.endswith("|retry")),
              f"{spec}: {len(sleeps)} backoffs for counts {counts}")
    sim.reset_oom_feedback()
    log(f"[19] injected faults on the ring grid in chunks of {FAULT_CHUNK}: "
        f"{json.dumps(FAULT_PLANS)}; rows equal the unfaulted run's to the "
        f"bit, the exhausted chunk's cells a structured failure; wall s "
        f"(backoffs recorded, not slept) {json.dumps(walls)}")
    return walls


def _oom_site(exc):
    """Where an out-of-memory error was raised: the innermost frame of
    the port, and whether a CUDA graph capture was open."""
    import traceback
    frames = traceback.extract_tb(exc.__traceback__)
    ours = [f for f in frames if PACKAGE in f.filename]
    where = ours[-1] if ours else frames[-1]
    capturing = any(f.name == "_record" for f in frames)
    return (f"{os.path.basename(where.filename)}:{where.lineno} "
            f"({where.name}), "
            f"{'inside' if capturing else 'outside'} a graph capture")


def phase_real_oom(sim, sg, dp, g9):
    """A real CUDA out-of-memory: the caching allocator capped
    (``set_per_process_memory_fraction``) so that the 48-point VOD
    grid's one chunk cannot fit but its halves can.  Without a policy
    the chunk raises ``torch.OutOfMemoryError`` (where the failing
    allocation landed is reported); with a ``FaultPolicy`` it bisects,
    gives nothing up and returns phase 9's rows to the bit.  Then the
    cap is lifted and the OOM feedback reset."""
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.engine.faults import FaultPolicy
    config, grid, build, n_steps = (g9["config"], g9["grid"], g9["build"],
                                    g9["n_steps"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    base = torch.cuda.memory_allocated()
    need = g9["peak"] - g9["base"]
    built = [build(k) for k in grid]
    held = torch.cuda.memory_allocated() - base
    del built
    half = held + (need - held) / 2.0
    cap = base + (need + half) / 2.0
    where, sleeps = None, []
    policy = FaultPolicy(sleep=sleeps.append)
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        try:
            dp.run_batch_chunked(config, grid, build, n_steps,
                                 watch_s=GRID_WATCH_S, chunk=len(grid),
                                 record_every=GRID_RECORD_EVERY)
        except torch.OutOfMemoryError as exc:
            where = _oom_site(exc)
        check(where is not None, f"the {len(grid)}-lane chunk fit under "
                                 f"the cap of {cap:,.0f} B")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rows = dp.run_batch_chunked(config, grid, build, n_steps,
                                    watch_s=GRID_WATCH_S, chunk=len(grid),
                                    record_every=GRID_RECORD_EVERY,
                                    faults=policy)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        bisections = sim.oom_bisections()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        sim.reset_oom_feedback()
    torch.cuda.empty_cache()
    counts = policy.fault_counts()
    log(f"[20] a real CUDA OOM: the allocator capped at {cap:,.0f} B "
        f"({cap / total!r} of {total:,} B; the {len(grid)}-lane VOD chunk "
        f"needs {need:,} B beyond {base:,} B held, its {held:,} B of "
        f"scenarios included); without a policy the chunk ran out of "
        f"memory at {where}; with a FaultPolicy: fault counts "
        f"{json.dumps(counts)} ({bisections} bisection(s)), {len(sleeps)} "
        f"backoff(s), wall {wall!r} s")
    check(counts.get("oom|bisect", 0) >= 1
          and not any(k.endswith("|giveup") for k in counts),
          f"the capped chunk did not recover by bisection: {counts}")
    check(_rows_equal(rows, g9["rows"]),
          "the bisected chunk's rows differ from phase 9's")
    log("    the bisected chunk's rows equal phase 9's to the bit")
    return {"where": where, "counts": counts, "wall": wall}


# ---- the population plane ---------------------------------------------------

def _population_spec():
    from hlsjs_p2p_wrapper_tpu_torch.engine.population import load_spec
    return load_spec(os.path.join(ROOT, POPULATION_SPEC))


def _spec_lanes(sim, config, spec, neighbors=None):
    """Four lanes of ``spec`` at mix 0.5 on the card, one a default CDN
    rate of POPULATION_CDN_MBPS, with the HD ladder."""
    from hlsjs_p2p_wrapper_tpu_torch.testing import population_lanes
    lanes = [population_lanes(config, spec, (0.5,), BITRATES,
                              cdn_bps=cdn * 1e6, uplink_bps=2.4e6,
                              device="cuda", neighbors=neighbors)[0]
             for cdn in POPULATION_CDN_MBPS]
    return sim.stack_pytrees([sim.lane(sc, 0) for sc in lanes])


def population_cases(sim, sg, pg, spec):
    """``(label, config, scenario)`` of the step kernels' check under the
    example population: the sweep's VOD and live lanes (the ring, one
    slot), three slots on the ring under each policy, and three slots on
    the random mesh under adaptive."""
    n_cohorts = len(spec.cohorts)
    for live, points in ((False, POPULATION_VOD_LANES),
                         (True, POPULATION_LIVE_LANES)):
        config = sg.build_config(GRID_PEERS, GRID_SEGMENTS, live, 8,
                                 n_cohorts=n_cohorts)
        grid = sg.population_grid(sg.live_grid() if live else sg.vod_grid(),
                                  spec)
        scenario, _joins = build_lanes(sim, sg, config,
                                       [grid[i] for i in points],
                                       GRID_WATCH_S, population=spec)
        yield (f"{'live' if live else 'VOD'} ring, C = 1, "
               f"{GRID_PEERS:,} peers", config, scenario)
    for policy in pg.POLICIES:
        config = pg.ring_config(GRID_PEERS, GRID_SEGMENTS, policy)._replace(
            n_levels=len(BITRATES), n_cohorts=n_cohorts)
        yield (f"ring {policy}, C = 3, {GRID_PEERS:,} peers", config,
               _spec_lanes(sim, config, spec))
    config = pg.random_config(GATHER_PEERS, GRID_SEGMENTS,
                              "adaptive")._replace(n_levels=len(BITRATES),
                                                   n_cohorts=n_cohorts)
    mesh = pg.random_topology(GATHER_PEERS, pg.SEED, device="cuda")
    yield (f"random mesh adaptive, C = 3, {GATHER_PEERS:,} peers", config,
           _spec_lanes(sim, config, spec, mesh))


def phase_population_kernels(sim, sk, sg, pg):
    """The step kernels against their plain versions under the example
    population (mix 0.5) on each path of :func:`population_cases`, at the
    state the kernels' own steps reach at t = 62 s, with the population
    fields shown to bind (``testing.population_binding``): requesters and
    holders the ``p2p_ok`` gate holds off P2P, picks clipped by
    ``abr_cap_level``, foregrounds urgent only by ``urgent_margin_off_s``,
    peers whose session ended."""
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.testing import population_binding
    spec = _population_spec()
    log(f"[30] the step kernels under the example population "
        f"({POPULATION_SPEC}, mix 0.5), {POPULATION_CHECK_STEPS} steps in")
    errs, total = {}, {}
    for label, config, scenario in population_cases(sim, sg, pg, spec):
        B = scenario.join_s.shape[0]
        state = _init(sim, config, scenario, B)
        sim._scan_swarm(config, scenario, state, POPULATION_CHECK_STEPS)
        torch.cuda.synchronize()
        binds = population_binding(config, scenario, state)
        check(binds["gate_requesters"] > 0 and binds["gate_holders"] > 0
              and binds["departed"] > 0,
              f"{label}: the p2p_ok gate or the sessions bind nowhere "
              f"{binds}")
        if config.neighbor_offsets is None:
            e = compare_gather(sim, sk, config, scenario, state, label)
        else:
            e = compare_kernels(sim, sk, config, scenario, state, label)
        for name, v in e.items():
            errs[name] = max(errs.get(name, 0.0), v)
        for name, v in binds.items():
            total[name] = total.get(name, 0) + v
        log(f"  {label}: population fields binding at t = "
            f"{float(state.t_s[0])!r} s {json.dumps(binds)}")
        del state, scenario
    log(f"    population fields binding over every case "
        f"{json.dumps(total)}; max float err {json.dumps(errs)}")
    check(all(v > 0 for v in total.values()),
          f"a population field binds in no case: {total}")
    return errs


def _exact_columns(cols):
    """The timeline's count columns (and its clock): equal, not close."""
    return [i for i, c in enumerate(cols)
            if c in ("t_s", "stalled_peers") or c.startswith("level_")
            or c.endswith(("_peers", "_stalled"))]


def phase_population_fixture():
    """The port's batched runs against the committed population fixture
    (the JAX reference with the example population over three VOD
    mixture points and a live one): offload, rebuffer, the series and the
    timeline's other columns within RUN_TOL (its rates relative), its
    counts (cohort columns included) equal."""
    import numpy as np
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.testing import (REFERENCE_POPULATION,
                                                     run_population_fixture)
    d = np.load(REFERENCE_POPULATION)
    runs = run_population_fixture(d, "cuda")
    torch.cuda.synchronize()
    worst = {}
    for key, (offload, rebuffer, series, tl, _p2p) in runs.items():
        cols = [str(c) for c in d[f"{key}_columns"]]
        tl, want = tl.cpu().numpy(), d[f"{key}_timeline"]
        exact = _exact_columns(cols)
        rates = [i for i, c in enumerate(cols) if c.endswith("_rate_bps")]
        other = [i for i in range(len(cols)) if i not in exact + rates]
        errs = {
            "offload": float(np.abs(offload.cpu().numpy()
                                    - d[f"{key}_offload"]).max()),
            "rebuffer": float(np.abs(rebuffer.cpu().numpy()
                                     - d[f"{key}_rebuffer"]).max()),
            "series": float(np.abs(series.cpu().numpy()
                                   - d[f"{key}_series"]).max()),
            "timeline": float(np.abs(tl[..., other]
                                     - want[..., other]).max()),
            "rates_rel": float((np.abs(tl[..., rates] - want[..., rates])
                                / np.maximum(np.abs(want[..., rates]),
                                             1.0)).max())}
        check(max(errs.values()) <= RUN_TOL,
              f"the port's {key} population run disagrees with the fixture "
              f"{errs}")
        check(np.array_equal(tl[..., exact], want[..., exact]),
              f"the population fixture's {key} count columns differ")
        check(bool((tl[..., cols.index("cohort_1_offload")] == 0).all()),
              f"the {key} cdn_only cohort's offload is not 0")
        worst[key] = errs
    log(f"[31] population fixture {d['shape'].tolist()} (peers, segments, "
        f"steps, record_every): max abs err {json.dumps(worst)}; counts, "
        f"cohort columns included, equal")


def phase_population_grid(sim, sk, sg, dp):
    """The mixture grid at its real size: ``tools/sweep.py --population
    examples/population_cellular_broadband.json``, the 48-point VOD grid
    crossed with the spec's mix fractions (144 points × 1,048,576 peers
    × 128 segments × 960 steps, a row every 40 steps with the cohort
    columns), through ``run_groups_chunked`` with the autotuned chunk and
    a ``FaultPolicy`` armed: one dispatch group, launches checked, every
    row's cohort peers summing to its level counts, the cdn_only cohort's
    offload 0 in every row, each last row its final offload, the anchored
    points within POPULATION_ROW_TOL of HEAD's reference.  Then the first
    POPULATION_TRACE_LANES points as one direct run (graphs), equal to
    the dispatch's rows, the cdn_only cohort's P2P bytes 0, traced whole
    for POPULATION_TRACE_STEPS steps and per kernel over TRACE_STEPS
    eager steps from its final state."""
    import numpy as np
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.engine.faults import FaultPolicy
    spec = _population_spec()
    config = sg.build_config(GRID_PEERS, GRID_SEGMENTS, False, 8,
                             n_cohorts=len(spec.cohorts))
    grid = sg.population_grid(sg.vod_grid(), spec)
    n_steps = int(GRID_WATCH_S * 1000.0 / config.dt_ms)
    n_rows = n_steps // GRID_RECORD_EVERY
    cols = sim.timeline_columns(config)

    def build(knobs):
        return sg.build_scenario(config, knobs, watch_s=GRID_WATCH_S,
                                 stagger_s=GRID_STAGGER_S, seed=0,
                                 population=spec, device="cuda")

    chunk = sim.autotune_chunk(config, len(grid), n_steps,
                               record_every=GRID_RECORD_EVERY,
                               scenario=build(grid[0])[0], device="cuda")
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launch_counts()
    faults = FaultPolicy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, stats = dp.run_groups_chunked(
        [(config, grid, build)], n_steps, watch_s=GRID_WATCH_S,
        record_every=GRID_RECORD_EVERY, faults=faults)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    rows = results[0]
    sizes = [min(chunk, len(grid) - a) for a in range(0, len(grid), chunk)]
    n_chunks = len(sizes)
    peer_steps = len(grid) * GRID_PEERS * n_steps
    log(f"[32] mixture grid (tools/sweep.py --population {POPULATION_SPEC}"
        f"): {len(grid)} points x {GRID_PEERS:,} peers x {GRID_SEGMENTS} "
        f"segments x {n_steps} steps, a row every {GRID_RECORD_EVERY} "
        f"steps with {len(spec.cohorts)} cohorts' columns, a FaultPolicy "
        f"armed; {len(stats)} dispatch group(s), autotuned chunk {chunk} "
        f"(chunks {sizes}); wall {wall!r} s, {len(grid) / wall!r} grid "
        f"points/s, {peer_steps / wall:,.0f} peer-steps/s; launches "
        f"{json.dumps(launches)}; peak memory {peak:,} B; fault counts "
        f"{json.dumps(faults.fault_counts())}")
    check(len(stats) == 1 and stats[0]["chunk"] == chunk
          and not stats[0]["failures"] and faults.fault_counts() == {},
          f"the mixture grid is not one clean dispatch group: {stats}")
    # per chunk: a launch of each step kernel a step, replayed from the
    # graphs; lane_sums for the timeline's first interval and the final
    # offload; the cohort row once a row; timeline_row (no cohorts) once,
    # for the final rebuffer ratio
    want = {name: 0 for name in sk.LAUNCHES}
    want.update(select_admit=n_steps * n_chunks,
                peer_update=n_steps * n_chunks, lane_sums=2 * n_chunks,
                timeline_row=n_chunks,
                timeline_row_cohorts=n_rows * n_chunks)
    check(launches == want, f"mixture grid launches {launches}, not {want}")
    levels = [cols.index(f"level_{i}_peers") for i in range(config.n_levels)]
    peers_k = [cols.index(f"cohort_{k}_peers")
               for k in range(config.n_cohorts)]
    cell_off = cols.index("cohort_1_offload")
    for i, (off, reb, tl) in enumerate(rows):
        check(0.0 <= off <= 1.0 and 0.0 <= reb <= 1.0,
              f"mixture point {i}: ratios out of range {off!r} {reb!r}")
        check(tl.shape == (n_rows, len(cols)) and np.isfinite(tl).all(),
              f"mixture point {i}: timeline {tl.shape} not finite")
        check(np.array_equal(tl[:, peers_k].sum(axis=1),
                             tl[:, levels].sum(axis=1)),
              f"mixture point {i}: cohort peers do not sum to the level "
              f"counts")
        check(bool((tl[:, cell_off] == 0.0).all()),
              f"mixture point {i}: the cdn_only cohort's offload is not 0")
        check(float(tl[-1, cols.index("t_s")]) == GRID_WATCH_S
              and float(tl[-1, cols.index("offload")]) == off,
              f"mixture point {i}: the last row is not its final offload")
    diffs = {i: (abs(rows[i][0] - o), abs(rows[i][1] - r))
             for i, (o, r) in POPULATION_ANCHOR.items()}
    worst = max(max(v) for v in diffs.values())
    stalling = sum(r > 0.0 for _o, r, _t in rows)
    log(f"    at the points HEAD's reference re-ran on a CPU "
        f"(tools/torch_port_population_anchor.py; point: (offload, "
        f"rebuffer) differences) {json.dumps(diffs)}, largest {worst!r}; "
        f"offload {min(r[0] for r in rows)!r} .. "
        f"{max(r[0] for r in rows)!r}, {stalling} of {len(grid)} points "
        f"stall; every row's cohort peers sum to its level counts and the "
        f"cdn_only cohort's offload is 0 in every row")
    check(worst <= POPULATION_ROW_TOL,
          f"mixture rows differ from HEAD's reference by {worst!r}")

    built = [build(k) for k in grid[:POPULATION_TRACE_LANES]]
    scenario = sim.stack_pytrees([sc for sc, _ in built])
    joins = torch.stack([j for _, j in built])
    del built
    B = scenario.join_s.shape[0]
    init = sim.init_swarm(config, device="cuda", batch=B)
    sk.reset_launch_counts()
    w_d, cap, (final, series, tl) = timed_run(
        sim, sk, config, scenario, init, n_steps, "graph",
        record_every=GRID_RECORD_EVERY)
    direct = [(float(o), float(r), t) for o, r, t in zip(
        sim.offload_ratio_batch(final).tolist(),
        sim.rebuffer_ratio_batch(final, GRID_WATCH_S, joins).tolist(),
        tl.cpu().numpy())]
    check(_rows_equal(direct, rows[:B]),
          f"the direct {B}-lane run's rows differ from the dispatch's")
    cell = scenario.cohort_id == 1
    cell_p2p = float(final.p2p_bytes[cell].sum())
    check(cell_p2p == 0.0 and bool(cell.any()),
          f"the cdn_only cohort moved {cell_p2p!r} P2P bytes")
    del series, tl
    busy, wall_ms, traced, others = trace_steps(
        sim, sk, config, scenario, init, POPULATION_TRACE_STEPS, "graph",
        record_every=GRID_RECORD_EVERY)
    del init
    _b, _w, e_traced, _o = trace_steps(
        sim, sk, config, scenario, final, TRACE_STEPS, "eager",
        record_every=GRID_RECORD_EVERY)
    before, st = sim.clone_state(final), sim.clone_state(final)
    flags, req, service, adm = sk.select_admit(config, scenario, st)
    sk.peer_update(config, scenario, st, flags, req, service, adm)
    nbytes = step_bytes(sim, sk, config, scenario, before, flags, req, adm,
                        st)
    del before, st
    idle = None if busy is None else 1.0 - busy / wall_ms
    log(f"    the first {B} points as one direct run (graphs): {w_d!r} s "
        f"({cap!r} s of it in captures; {w_d * 1e3 / n_steps!r} ms per "
        f"step), rows equal to the dispatch's, the cdn_only cohort's P2P "
        f"bytes 0; traced whole over {POPULATION_TRACE_STEPS} steps: "
        f"device busy {busy!r} ms per step, idle {idle!r} of the traced "
        f"host wall ({wall_ms!r} ms per step; per kernel "
        f"{json.dumps(traced)}; "
        f"{other_ops(others, POPULATION_TRACE_STEPS, 'mixture graph run')})")
    log(f"    per kernel (launches, traced mean ms), {TRACE_STEPS} eager "
        f"steps from the final state: {json.dumps(e_traced)}; bytes "
        f"{json.dumps({k: nbytes[k] for k in MAIN_PATH})}")
    return {"config": config, "scenario": scenario, "final": final,
            "launches": launches, "wall": wall, "chunk": chunk,
            "peak": peak, "traced": e_traced, "idle": idle, "busy": busy,
            "n_steps": n_steps, "rows": rows}


def _cohort_labels(scenario, n_cohorts, seed=0):
    """``scenario`` with seeded labels in ``[0, n_cohorts)``."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, n_cohorts, tuple(scenario.cohort_id.shape),
                        generator=gen, device="cuda", dtype=torch.int32)
    return scenario._replace(cohort_id=ids)


def compare_cohort_rows(sim, sk, config, scenario, prev, state, label):
    """TK5's cohort instantiation against its plain version on the
    stacked ``state``, the interval starting at ``prev``: counts (and
    every column computed from the same inputs) equal, the rebuffer and
    the cohort offloads within REDUCE_RTOL, the carried sums equal, each
    cohort's peers summing to the level counts, and the first and last
    lanes alone equal to their batched rows to the bit.  Returns the
    largest absolute difference."""
    import torch
    B = state.t_s.shape[0]
    cols = sim.timeline_columns(config)
    M = len(cols)
    sums, prev_sums = sk.lane_sums(state), sk.lane_sums(prev)
    soft = [cols.index("rebuffer")] + [
        cols.index(f"cohort_{k}_offload") for k in range(config.n_cohorts)]
    same = [i for i in range(M) if i not in soft]

    def row(fn):
        out = torch.full((B, 2, M), float("nan"), device="cuda")
        ps, pr = prev_sums.clone(), prev.rebuffer_s.clone()
        fn(config, scenario, state, sums, ps, pr, out, 1, GRID_RECORD_EVERY)
        return out, ps, pr
    (row_k, ps_k, pr_k), (row_p, ps_p, pr_p) = (
        row(fn) for fn in (sk.timeline_row, sk.timeline_row_plain))
    torch.cuda.synchronize()
    check(bool(torch.isnan(row_k[:, 0]).all()),
          f"{label}: the cohort row wrote outside its sample")
    row_k, row_p = row_k[:, 1], row_p[:, 1]
    check(torch.equal(row_k[:, same], row_p[:, same]),
          f"{label}: the cohort row's counts or clock differ from plain")
    rel = _rel_err(row_k[:, soft], row_p[:, soft])
    check(rel <= REDUCE_RTOL, f"{label}: the cohort row's ratios off by "
                              f"{rel!r} relative")
    check(torch.equal(ps_k, ps_p) and torch.equal(pr_k, pr_p),
          f"{label}: the carried sums or rebuffer differ")
    levels = [cols.index(f"level_{i}_peers") for i in range(config.n_levels)]
    peers_k = [cols.index(f"cohort_{k}_peers")
               for k in range(config.n_cohorts)]
    check(torch.equal(row_k[:, peers_k].sum(-1), row_k[:, levels].sum(-1)),
          f"{label}: cohort peers do not sum to the level counts")
    for b in sorted({0, B - 1}):
        one = [sim.as_lanes(sim.lane(x, b)) for x in (scenario, state, prev)]
        out = torch.full((1, 2, M), float("nan"), device="cuda")
        sk.timeline_row(config, one[0], one[1], sums[b:b + 1].clone(),
                        prev_sums[b:b + 1].clone(),
                        one[2].rebuffer_s.clone(), out, 1, GRID_RECORD_EVERY)
        check(torch.equal(out[0, 1], row_k[b]),
              f"{label}: lane {b} alone differs from its batched row")
    return float((row_k - row_p).abs().max()), rel


def phase_cohort_rows(sim, sk, g):
    """TK5's cohort instantiation against its plain version: on the
    mixture chunk's final state (POPULATION_TRACE_LANES × 1,048,576)
    after one more interval, with the spec's 2 cohorts and 8 seeded
    labels, the stall digest off and on; then on the example population
    at COHORT_PEERS peers (partial blocks); and timed at the chunk's size
    (CUDA events, launches back to back) beside the instantiation without
    cohorts, its plain version, its bytes and bound."""
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.testing import population_lanes
    config, scenario = g["config"], g["scenario"]
    prev = g["final"]
    state = sim.clone_state(prev)
    sim._scan_swarm(config, scenario, state, GRID_RECORD_EVERY)
    B, P = state.rebuffer_s.shape
    log(f"[33] TK5's cohort instantiation against its plain version")
    err, rel = 0.0, 0.0
    for n_cohorts in COHORT_COUNTS:
        scen = (scenario if n_cohorts == config.n_cohorts
                else _cohort_labels(scenario, n_cohorts))
        for digest in (False, True):
            cfg = config._replace(n_cohorts=n_cohorts, stall_digest=digest)
            e, r = compare_cohort_rows(
                sim, sk, cfg, scen, prev, state,
                f"{B} x {P:,}, {n_cohorts} cohorts, digest {digest}")
            err, rel = max(err, e), max(rel, r)
    spec = _population_spec()
    for peers in COHORT_PEERS:
        cfg = sim.SwarmConfig(n_peers=peers, n_segments=GRID_SEGMENTS,
                              n_levels=len(BITRATES),
                              neighbor_offsets=sim.ring_offsets(DEGREE),
                              n_cohorts=len(spec.cohorts))
        scen, _joins = population_lanes(cfg, spec, (0.25, 0.5), BITRATES,
                                        cdn_bps=8e6, uplink_bps=2.4e6,
                                        device="cuda")
        small_prev = sim.init_swarm(cfg, device="cuda", batch=2)
        sim._scan_swarm(cfg, scen, small_prev, POPULATION_CHECK_STEPS)
        small = sim.clone_state(small_prev)
        sim._scan_swarm(cfg, scen, small, GRID_RECORD_EVERY)
        for n_cohorts in COHORT_COUNTS:
            sc = scen if n_cohorts == 2 else _cohort_labels(scen, n_cohorts)
            for digest in (False, True):
                e, r = compare_cohort_rows(
                    sim, sk, cfg._replace(n_cohorts=n_cohorts,
                                          stall_digest=digest),
                    sc, small_prev, small,
                    f"2 x {peers:,}, {n_cohorts} cohorts, digest {digest}")
                err, rel = max(err, e), max(rel, r)
    # timing at the chunk's size, the spec's cohorts
    M = len(sim.timeline_columns(config))
    sums = sk.lane_sums(state)
    prev_sums, prev_reb = sk.lane_sums(prev), prev.rebuffer_s.clone()
    out = torch.empty((B, 1, M), dtype=torch.float32, device="cuda")
    bare = config._replace(n_cohorts=0)
    out0 = torch.empty((B, 1, M - 3 * config.n_cohorts),
                       dtype=torch.float32, device="cuda")
    ms = back_to_back(lambda st: sk.timeline_row_cohorts(
        config, scenario, st, sums, prev_sums, prev_reb, out, 0,
        GRID_RECORD_EVERY), state)
    ms_bare = back_to_back(lambda st: sk.timeline_row(
        bare, scenario, st, sums, prev_sums, prev_reb, out0, 0,
        GRID_RECORD_EVERY), state)
    plain = cuda_ms(lambda: sk.timeline_row_plain(
        config, scenario, state, sums, prev_sums, prev_reb, out, 0,
        GRID_RECORD_EVERY), 5)
    traced = trace_calls(lambda: sk.timeline_row_cohorts(
        config, scenario, state, sums, prev_sums, prev_reb, out, 0,
        GRID_RECORD_EVERY), 20).get("timeline_row")
    nbytes = timeline_bytes(B, P, M, cohorts=True)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"    counts equal, ratios within {rel!r} relative (max abs err "
        f"{err!r}), lanes alone equal to their batched rows; at {B} x "
        f"{P:,} with {config.n_cohorts} cohorts ({BACK_TO_BACK} launches "
        f"back to back, CUDA events): {ms!r} ms (without cohorts "
        f"{ms_bare!r} ms), traced {traced!r} ms; plain {plain!r} ms; "
        f"{nbytes:,.0f} B, bound {bound!r} ms at 3.35 TB/s, "
        f"{ms / bound!r} x")
    return {"max_abs_err": err, "rel": rel, "ms": ms, "ms_bare": ms_bare,
            "plain_ms": plain, "traced_ms": traced, "bytes": nbytes,
            "bound_ms": bound, "shape": f"{B} x {P:,}, "
            f"{config.n_cohorts} cohorts"}


def phase_degenerate(sim, sg, dp):
    """The population gate's promise 1 on the card: a population of one
    cohort that inherits everything gives, at DEGENERATE_POINTS sampled
    points of the VOD and of the live grid at 1,048,576 peers, the
    homogeneous rows' offload and rebuffer to the bit and the same
    timeline columns, its one cohort's counts the audience's."""
    import numpy as np
    from hlsjs_p2p_wrapper_tpu_torch.engine.population import (Cohort,
                                                               PopulationSpec)
    spec = PopulationSpec(name="degenerate", seed=0,
                          cohorts=(Cohort(name="all", fraction=1.0),))
    out = {}
    for live in (False, True):
        base = sg.sample_grid(sg.live_grid() if live else sg.vod_grid(),
                              DEGENERATE_POINTS)
        hom = sg.build_config(GRID_PEERS, GRID_SEGMENTS, live, 8)
        deg = hom._replace(n_cohorts=1)
        n_steps = int(GRID_WATCH_S * 1000.0 / hom.dt_ms)
        runs = []
        for config, population in ((hom, None), (deg, spec)):
            def build(knobs, config=config, population=population):
                return sg.build_scenario(config, knobs, watch_s=GRID_WATCH_S,
                                         stagger_s=GRID_STAGGER_S, seed=0,
                                         population=population,
                                         device="cuda")
            runs.append(dp.run_batch_chunked(
                config, sg.population_grid(base, spec), build, n_steps,
                watch_s=GRID_WATCH_S, record_every=GRID_RECORD_EVERY))
        cols = sim.timeline_columns(deg)
        n = len(sim.timeline_columns(hom))
        levels = [cols.index(f"level_{i}_peers") for i in range(deg.n_levels)]
        for i, ((o_h, r_h, t_h), (o_d, r_d, t_d)) in enumerate(zip(*runs)):
            check(o_h == o_d and r_h == r_d
                  and np.array_equal(t_h, t_d[:, :n]),
                  f"degenerate {'live' if live else 'VOD'} point {i}: "
                  f"({o_d!r}, {r_d!r}) is not the homogeneous "
                  f"({o_h!r}, {r_h!r})")
            check(np.array_equal(t_d[:, n], t_d[:, levels].sum(axis=1))
                  and np.array_equal(t_d[:, n + 1],
                                     t_d[:, cols.index("stalled_peers")]),
                  f"degenerate point {i}: the cohort's counts are not the "
                  f"audience's")
        out["live" if live else "vod"] = [(o, r) for o, r, _t in runs[0]]
    log(f"[34] degenerate population (one cohort, everything inherited) at "
        f"{DEGENERATE_POINTS} sampled points of each grid x {GRID_PEERS:,} "
        f"peers: offload and rebuffer equal the homogeneous rows to the "
        f"bit {json.dumps(out)}; timelines equal, the cohort's counts the "
        f"audience's")


def _hexed(obj):
    """A tree with every float as ``float.hex``: equality to the bit."""
    if isinstance(obj, float):
        return obj.hex()
    if isinstance(obj, dict):
        return {k: _hexed(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_hexed(v) for v in obj]
    return obj


def phase_traced_grid(sg, dp, sk, g9):
    """Phase 9's grid through ``run_batch_chunked`` once more, in chunks
    of 16, with the flight recorder (``trace=``, on the warm start's
    registry), a ``SpanRecorder`` (``tracer=``), a fault plan that
    retries chunk 1 once, and a row cache and journal of its own: rows
    equal to phase 9's to the bit, one finalize event a journaled row,
    the fault and cache counters replayed from the shard exactly; then
    the same grid warm: 48 cached row events, no dispatch span."""
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.engine.artifact_cache import (
        CompileCounter, SweepJournal, WarmStart, journal_path)
    from hlsjs_p2p_wrapper_tpu_torch.engine.faults import (FaultPlan,
                                                           FaultPolicy)
    from hlsjs_p2p_wrapper_tpu_torch.engine.telemetry import SpanRecorder
    from hlsjs_p2p_wrapper_tpu_torch.engine.tracer import (
        FlightRecorder, counter_families, finalize_keys, read_shard,
        replay_counter_families, run_id_for)
    config, grid, build = g9["config"], g9["grid"], g9["build"]
    n_steps, want = g9["n_steps"], g9["rows"]
    meta = grid_meta(sg, grid)
    warm = WarmStart(os.path.join(WARM_DIR, "C"))
    walls, shards, spans = [], [], []
    for run in ("traced", "warm"):
        rec = FlightRecorder(os.path.join(WARM_DIR, "trace36", run),
                             "host00", run_id=run_id_for(meta),
                             registry=warm.registry)
        spans.append(SpanRecorder())
        faults = FaultPolicy(FaultPlan.parse(TRACE_FAULTS)
                             if run == "traced" else None,
                             registry=warm.registry)
        probe = CompileCounter().attach()
        launches = dict(sk.LAUNCHES)
        with SweepJournal(journal_path(warm.cache_dir, meta), meta,
                          resume=run == "warm") as journal:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = dp.run_batch_chunked(
                config, grid, build, n_steps, watch_s=GRID_WATCH_S,
                chunk=GRID_CHUNK, record_every=GRID_RECORD_EVERY,
                warm_start=warm, faults=faults, journal=journal, trace=rec,
                tracer=spans[-1])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            journal.finalize()
            journaled = set(journal.completed)
        probe.detach()
        rec.close()
        check(_rows_hex_equal(rows, want),
              f"[36] the {run} grid's rows differ from phase 9's")
        shards.append(read_shard(rec.path)[1])
    events, warm_events = shards
    finals = finalize_keys(events)
    check(len(journaled) == len(grid) and sorted(finals) == sorted(journaled)
          and set(finals.values()) == {1},
          f"[36] {len(journaled)} journaled rows, finalize events "
          f"{sorted(set(finals.values()))} for {len(finals)} keys")
    replay = replay_counter_families(events + warm_events)
    families = counter_families(warm.registry)
    check(all(replay[f] == families[f]
              for f in ("dispatch_faults", "aot_cache_events"))
          and families["dispatch_faults"] == {
              "action=retry,reason=transient": 1},
          f"[36] replayed {json.dumps(replay)} against the registry's "
          f"{json.dumps(families)}")
    retry = [e.get("ctx") for e in events if e["kind"] == "counter"
             and e["name"] == "dispatch_faults"]
    check(retry == [{"group": 0, "chunk": 1, "attempt": 0}],
          f"[36] the retry's context {retry}")
    n_chunks = -(-len(grid) // GRID_CHUNK)
    names = [s["name"] for s in spans[0].spans]
    check(sorted(names) == sorted(["build", "dispatch", "readback"]
                                  * n_chunks)
          and sorted(e["name"] for e in events if e["kind"] == "span")
          == sorted(names), f"[36] spans {names}")
    warm_rows = [e for e in warm_events if e["kind"] == "row"]
    check(len(warm_rows) == len(grid) and all(e["cached"]
                                              for e in warm_rows)
          and not any(e["kind"] == "span" for e in warm_events)
          and not spans[1].by_name().get("dispatch")
          and probe.compiles == 0
          and all(sk.LAUNCHES[k] == launches[k] for k in launches),
          f"[36] the warm rerun: {len(warm_rows)} row events, spans "
          f"{[s['name'] for s in spans[1].spans]}, {probe.builds} builds, "
          f"{probe.captures} captures")
    span_s = {name: round(sum(s["duration_s"] for s in group), 4)
              for name, group in spans[0].by_name().items()}
    log(f"[36] phase 9's grid ({len(grid)} points x {GRID_PEERS:,} peers x "
        f"{GRID_SEGMENTS} segments x {n_steps} steps, chunks of "
        f"{GRID_CHUNK}) traced (trace= a FlightRecorder on the warm start's "
        f"registry, tracer= a SpanRecorder), {TRACE_FAULTS} injected, a "
        f"fresh root and journal: wall {walls[0]!r} s (phase 9: autotuned "
        f"{g9['wall']!r} s, chunk {GRID_CHUNK} with a warm start "
        f"{g9['wall16']!r} s); rows equal phase 9's to the bit; "
        f"{len(events)} events, {len(finals)} finalize events for "
        f"{len(journaled)} journaled rows (one each); counters replayed "
        f"exactly {json.dumps(families)}; span seconds "
        f"{json.dumps(span_s)}")
    log(f"    warm rerun (trace= and tracer= on): {walls[1]!r} s, "
        f"{len(warm_rows)} cached row events, no dispatch span, "
        f"{probe.builds} builds, {probe.captures} captures, no launch; "
        f"rows equal phase 9's to the bit")
    return {"walls": walls, "events": len(events)}


def phase_search(chunk):
    """``tools/optimize.py``'s halving search on the port
    (``search_eval``) with the tool's defaults (budget 64, 2 rungs, eta
    6, screens at a quarter of the watch window, rebuffer <= 0.02, seed
    0) over the live lattice at the sweep's shapes, in chunks of
    ``chunk`` (phase 13's autotuned width for the live grid): run
    and stopped as its second round asks (a checkpoint after round 1),
    resumed in this process to the end.  The same seed again on its warm
    start (the same frontier, no fresh dispatch, build, capture or
    launch) is phase 42's ``tools.optimize`` child.  Returns what phase
    42 holds that child to."""
    import torch
    from hlsjs_p2p_wrapper_tpu_torch import search_eval as se
    from hlsjs_p2p_wrapper_tpu_torch.engine.artifact_cache import (
        SweepJournal, WarmStart, journal_path)
    from hlsjs_p2p_wrapper_tpu_torch.engine.faults import FaultPolicy
    from hlsjs_p2p_wrapper_tpu_torch.engine.search import (
        Constraint, PolicySearch, scrub_provenance, search_checkpoint_path)
    args = se.search_args(peers=GRID_PEERS, segments=GRID_SEGMENTS,
                          watch_s=GRID_WATCH_S, chunk=chunk)
    space, constraint = se.live_space(), Constraint.parse(args.constraint)
    meta = se.search_meta(args, space, constraint)
    root = os.path.join(WARM_DIR, "D")
    warm = WarmStart(root)
    ckpt = search_checkpoint_path(root, meta)

    class Stop(Exception):
        pass

    def search(journal, stop_at=None):
        evaluator = se.Evaluator(
            space, peers=args.peers, segments=args.segments,
            watch_s=args.watch_s, seed=args.seed, chunk=args.chunk,
            warm_start=warm, faults=FaultPolicy(registry=warm.registry),
            journal=journal, device="cuda")

        def evaluate(proposals, round_index):
            if round_index == stop_at:
                raise Stop
            return evaluator(proposals, round_index)
        return PolicySearch(se.build_driver(args, space, constraint),
                            evaluate, constraint, budget=args.budget,
                            batch=args.batch, registry=warm.registry,
                            checkpoint_path=ckpt, checkpoint_meta=meta)

    walls = []
    jpath = journal_path(root, meta)
    with SweepJournal(jpath, meta) as journal:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stopped = search(journal, stop_at=1)
        try:
            stopped.run()
            check(False, "[37] the search did not reach its second round")
        except Stop:
            pass
        walls.append(time.perf_counter() - t0)
        resumed = search(journal)
        check(resumed.resume() and resumed.round == 1,
              f"[37] the checkpoint holds round {resumed.round}")
        first = resumed.run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        journal.finalize()
        n_journaled = len(journal.completed)
    rounds = first["rounds"]
    fresh = sum(r["fresh_dispatches"] for r in rounds)
    n_trials = len(first["trials"])
    check(first["frontier"]["best"] is not None and n_trials > 144
          and fresh == n_trials == n_journaled and not first["truncated"]
          and first["frontier"]["failed"] == 0,
          f"[37] the search: {n_trials} trials, {fresh} fresh, "
          f"{n_journaled} journaled, best {first['frontier']['best']}")
    best = first["frontier"]["best"]
    table = [[r["proposals"], r["cost"], r["fresh_dispatches"],
              r["row_cache_hits"], r["infeasible"]] for r in rounds]
    log(f"[37] tools/optimize.py's halving search (search_eval, budget "
        f"{args.budget:g}, {args.rungs} rungs, eta {args.eta:g}, screens at "
        f"{args.screen_fidelity:g}, {args.constraint}, seed {args.seed}) "
        f"over the {len(se.live_lattice())}-point live lattice at "
        f"{GRID_PEERS:,} peers x {GRID_SEGMENTS} segments x "
        f"{GRID_WATCH_S:g} s, chunks of {args.chunk} (phase 13's "
        f"autotuned width): stopped as round 2 "
        f"asked ({walls[0]!r} s, checkpointed), resumed in this process "
        f"(whole {walls[1]!r} s); rounds {json.dumps(table)} "
        f"(proposals, cost, fresh, cached, infeasible); {n_trials} trials, "
        f"spent {first['spent']}, {first['frontier']['feasible']} "
        f"feasible; best offload {best['offload']!r} rebuffer "
        f"{best['rebuffer']!r} at {json.dumps(best['knobs'])}; the same "
        f"seed on this warm start runs in [42], as tools.optimize")
    return {"walls": walls, "trials": n_trials, "root": root,
            "chunk": args.chunk,
            "frontier": _hexed(scrub_provenance(first["frontier"])),
            "trial_list": _hexed(scrub_provenance(first["trials"]))}


def phase_fleet(sg, g9, children):
    """Phase 9's grid shared by three fabric workers on this card: one
    SIGKILLed as it claims its second unit, one stalled past its lease
    so that another steals its unit, each with its own trace shard and
    journal shard.  Their rows, with the killed host's finalized rows
    read back from the row cache, equal phase 9's to the bit; the claim
    files agree with the registries; every journaled row has one
    finalize event in its host's shard; each survivor's counters replay
    from its shard."""
    import signal

    import numpy as np
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.engine.artifact_cache import (
        WarmStart, journal_path, read_jsonl_tolerant)
    from hlsjs_p2p_wrapper_tpu_torch.engine.fabric import fleet_report
    from hlsjs_p2p_wrapper_tpu_torch.engine.tracer import (
        finalize_keys, read_shard, replay_counter_families)
    fleet = os.path.join(WARM_DIR, "fleet")
    grid, want = g9["grid"], g9["rows"]
    meta = grid_meta(sg, grid)
    # the card's cached free memory back, for three more processes
    torch.cuda.empty_cache()
    t_go = {}
    for host in FLEET_HOSTS:
        _ready, t_go[host] = _child_go(host, children[host])
    t0 = min(t_go.values())
    ends = {}
    for host in FLEET_HOSTS:
        rc, records, _w = _child_end(host, children[host], t_go[host])
        ends[host] = (rc, records)
    wall = time.perf_counter() - t0
    killed, survivors = "host01", ("host00", "host02")
    check(ends[killed][0] == -signal.SIGKILL, _child_failure(
        killed, children[killed], f"did not die by SIGKILL "
                                  f"({ends[killed][0]})"))
    out = {}
    for host in survivors:
        rc, records = ends[host]
        check(rc == 0 and records and "claims" in records[-1],
              _child_failure(host, children[host], "failed"))
        out[host] = records[-1]
    with open(os.path.join(fleet, "fabric", "units.json")) as fh:
        units = json.load(fh)["units"]
    # rows: the survivors' by grid index (a unit both computed must
    # agree to the bit), the killed host's from the row cache by the keys
    # its journal holds, placed by its finalize events
    merged = {}
    for host in survivors:
        with np.load(os.path.join(fleet, f"{host}.npz")) as data:
            for i, o, r, tl in zip(data["index"], data["offload"],
                                   data["rebuffer"], data["timeline"]):
                row = (float(o), float(r), tl)
                if int(i) in merged:
                    check(_rows_hex_equal([row], [merged[int(i)]]),
                          f"[38] point {int(i)} differs between hosts")
                merged[int(i)] = row
    shards = {h: read_shard(os.path.join(fleet, "trace", f"{h}.jsonl"))
              for h in FLEET_HOSTS}
    warm = WarmStart(os.path.join(fleet, "root"))
    journaled = {}
    for host in FLEET_HOSTS:
        journaled[host] = [r["key"] for r in read_jsonl_tolerant(
            journal_path(warm.cache_dir, meta, host))
            if r.get("kind") == "row"]
        finals = finalize_keys(shards[host][1])
        check(journaled[host] and sorted(finals) == sorted(journaled[host])
              and set(finals.values()) == {1},
              f"[38] {host}: {len(journaled[host])} journaled rows, "
              f"finalize events {finals}")
    recovered = 0
    for e in shards[killed][1]:
        if e["kind"] == "row" and e.get("journaled"):
            index = units[e["ctx"]["unit"]][2] + e["index"]
            row = warm.row_load(e["key"])
            check(row is not None, f"[38] the killed host's row {index} "
                                   f"is not in the row cache")
            if index not in merged:
                recovered += 1
            else:
                check(_rows_hex_equal([row], [merged[index]]),
                      f"[38] point {index} differs between hosts")
            merged[index] = row
    check(sorted(merged) == list(range(len(grid)))
          and _rows_hex_equal([merged[i] for i in range(len(grid))], want),
          f"[38] the fleet's {len(merged)} rows differ from phase 9's")
    check(recovered > 0, "[38] no row came back from the row cache alone")
    report = fleet_report(os.path.join(fleet, "fabric"))
    totals = {k: v for k, v in report.items() if k != "units_detail"}
    counted = {a: sum(out[h]["claims"].get(a, 0) for h in survivors)
               for a in ("steal", "expire", "duplicate")}
    check(report["finished"] == report["units"] == len(units)
          and report["steals"] >= 1 and report["claim_races"] == 0
          and (counted["steal"], counted["expire"], counted["duplicate"])
          == (report["steals"], report["expires"], report["duplicates"])
          and all(len(u["done"]) <= len(u["gens"])
                  for u in report["units_detail"]),
          f"[38] claim files {json.dumps(totals)}, registries {counted}")
    # each unit's dispatch, heartbeat to heartbeat (run_units beats just
    # before and just after it), against the lease; and the steals, in
    # seconds from the first lease event of the fleet
    leases = [(h, e) for h, (_m, events) in shards.items() for e in events
              if e["kind"] == "lease"]
    t_first = min(e["t"] for _h, e in leases)
    beats, steals = {}, []
    for host, e in leases:
        if e["action"] == "beat":
            beats.setdefault((host, e["unit"], e["gen"]), []).append(e["t"])
        elif e["action"] == "steal":
            steals.append({"host": host, "unit": e["unit"],
                           "from": e.get("prev_host"),
                           "at_s": round(e["t"] - t_first, 3)})
    dispatch_s = {f"{h} unit {u}": round(ts[-1] - ts[0], 3)
                  for (h, u, _g), ts in sorted(beats.items())
                  if len(ts) == 2}
    check(dispatch_s and max(dispatch_s.values()) < FLEET_LEASE_S,
          f"[38] a unit's dispatch outlasted the {FLEET_LEASE_S:g}-s "
          f"lease: {json.dumps(dispatch_s)}")
    stalled = [st for st in steals if st["from"] == "host02"]
    check(len(stalled) == 1 and stalled[0]["host"] != "host02",
          f"[38] the stalled host's unit was not stolen: steals "
          f"{json.dumps(steals)}")
    run_ids = {m.get("run_id") for m, _e in shards.values()}
    check(len(run_ids) == 1, f"[38] run ids {run_ids}")
    for host in survivors:
        replay = replay_counter_families(shards[host][1])
        check(replay == out[host]["counters"] and out[host]["builds"] == 0,
              f"[38] {host}: replayed {json.dumps(replay)}, registry "
              f"{json.dumps(out[host]['counters'])}, builds "
              f"{out[host]['builds']}")
    n_events = sum(len(events) for _meta, events in shards.values())
    log(f"[38] phase 9's grid ({len(grid)} points x {GRID_PEERS:,} peers x "
        f"{GRID_SEGMENTS} segments x {g9['n_steps']} steps) on one card by "
        f"{len(FLEET_HOSTS)} fabric workers (testing/fleet_worker.py, "
        f"started beside phase 5), {len(units)} units of {FLEET_CHUNK}, "
        f"lease {FLEET_LEASE_S:g} s, {json.dumps(FLEET_CHAOS)}: wall "
        f"{wall!r} s from the go to the last exit (the survivors' go to "
        f"exit {json.dumps({h: round(out[h]['go_s'], 3) for h in survivors})}"
        f" s, of it in run_units "
        f"{json.dumps({h: round(out[h]['wall_s'], 3) for h in survivors})}"
        f" s); each unit's dispatch, beat to beat (s) "
        f"{json.dumps(dispatch_s)}; steals {json.dumps(steals)}")
    log(f"    host01 died by SIGKILL ({len(journaled[killed])} rows "
        f"journaled, {recovered} served only from the row cache); claim "
        f"files: {report['claims']} claims, {report['steals']} steals, "
        f"{report['expires']} expiries, {report['duplicates']} "
        f"duplicates, equal to the survivors' fabric_claims "
        f"{json.dumps({h: out[h]['claims'] for h in survivors})}; "
        f"merged rows equal phase 9's to the bit; {n_events} events, "
        f"one finalize event a journaled row on every shard, the "
        f"survivors' counters replayed exactly; builds "
        f"{[out[h]['builds'] for h in survivors]}, captures "
        f"{[out[h]['captures'] for h in survivors]}, row events "
        f"{json.dumps({h: out[h]['row'] for h in survivors})}")
    return {"wall": wall, "report": report}


# ---- phases 39-41: the control plane and the twin's sim half -------------

def _fixture_frame(d):
    from hlsjs_p2p_wrapper_tpu_torch.engine.twinframe import ObservationFrame
    return ObservationFrame.from_dict(d)


def phase_twin(sk, smi):
    """The twin's sim plane (``testing/twin.run_sim_plane``) on the card
    against the committed twin frames: the clean and chaos scenarios of
    ``tools/twin_gate.py`` inside the committed bands against the
    reference's real-plane frames and equal to its sim frames; the wave
    shifted by two windows caught first on the membership columns at the
    wave window; the widest audience the card takes on the card and on
    the CPU path; one peer more refused on the card."""
    import dataclasses
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.engine.twinframe import compare_frames
    from hlsjs_p2p_wrapper_tpu_torch.testing import control_fixture as cf
    from hlsjs_p2p_wrapper_tpu_torch.testing.twin import (
        MAX_CARD_AUDIENCE, parity_sim_config, run_sim_plane)
    doc = cf.load_json(cf.TWIN_FRAMES)
    bands = cf.load_json(os.path.join(ROOT, TWIN_BANDS))["scenarios"]
    specs = {name: cf.scenario_from_dict(doc["scenarios"][name]["scenario"])
             for name in ("clean", "chaos")}
    clean = specs["clean"]
    sk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sims = {name: run_sim_plane(spec, device="cuda")
            for name, spec in specs.items()}
    perturbed = run_sim_plane(
        clean, wave_shift_s=doc["shift_windows"] * clean.window_s,
        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in sk.LAUNCHES.items() if v}
    check(all(k in launches for k in TWIN_KERNELS),
          f"[39] the sim planes launched {json.dumps(launches)}")
    for name, sim in sims.items():
        entry = doc["scenarios"][name]
        findings = compare_frames(sim, _fixture_frame(entry["real"]),
                                  bands[name]["bands"])
        check(not findings, f"[39] {name}: the sim plane leaves the "
                            f"committed bands: {findings}")
        bad = cf.frames_agree(sim, _fixture_frame(entry["sim"]))
        check(not bad, f"[39] {name}: the card's sim frames differ from "
                       f"the reference's: {bad}")
    bad = cf.frames_agree(perturbed, _fixture_frame(doc["perturbed_sim"]))
    check(not bad, f"[39] the shifted wave's sim frames differ from the "
                   f"reference's: {bad}")
    # tools/twin_gate.py's fourth check: the injected mapping bug is
    # found first, at the wave window, on the membership columns
    findings = compare_frames(
        perturbed, _fixture_frame(doc["scenarios"]["clean"]["real"]),
        bands["clean"]["bands"])
    wave_window = int(clean.wave_at_s // clean.window_s)
    by_metric = {f["metric"]: f for f in findings
                 if f["reason"] == "band_divergence"}
    earliest = min((f.get("first_window", 10**9) for f in findings),
                   default=10**9)
    leading = {f["metric"] for f in findings
               if f.get("first_window") == earliest}
    check(earliest == wave_window
          and by_metric.get("joins", {}).get("first_window") == wave_window
          and by_metric["joins"]["moved_first"] == "real"
          and by_metric.get("present_peers", {}).get("first_window")
          == wave_window
          and leading <= {"joins", "present_peers", "leaves",
                          "stalled_peers"},
          f"[39] the shifted wave is not found first at window "
          f"{wave_window} on the membership columns: {findings}")
    wide = dataclasses.replace(clean, **WIDE_TWIN)
    check(wide.total_peers == MAX_CARD_AUDIENCE,
          f"[39] {wide.total_peers} peers")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = run_sim_plane(wide, device="cuda")
    torch.cuda.synchronize()
    wide_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = run_sim_plane(wide, device="cpu")
    cpu_wall = time.perf_counter() - t0
    bad = cf.frames_agree(card, plain)
    check(not bad, f"[39] {wide.total_peers} peers: the card's frames "
                   f"differ from the CPU path's: {bad}")
    over = dataclasses.replace(wide, wave_peers=wide.wave_peers + 1)
    try:
        run_sim_plane(over, device="cuda")
        refused = None
    except ValueError as exc:
        refused = str(exc)
    check(refused is not None,
          f"[39] the card's audience limit: {over.total_peers} peers ran")
    torch.cuda.synchronize()
    log(f"[39] the twin's sim plane on the card (testing/twin.py, the "
        f"parity mapping: full neighbours, C = 3, spread, a row every "
        f"{clean.window_s * 1000 / parity_sim_config(clean).dt_ms:g} "
        f"steps): the clean and chaos "
        f"scenarios of tools/twin_gate.py ({clean.total_peers} peers x "
        f"{clean.watch_s:g} s) and the wave shifted by "
        f"{doc['shift_windows']} windows in {wall!r} s on {smi}; inside "
        f"the TWIN_r10.json bands against the reference's real planes, "
        f"peer counts equal to its sim frames and the rest within "
        f"{cf.FRAME_RTOL:g} relative + {cf.FRAME_ATOL:g}; the shifted wave "
        f"found first at window {wave_window} on {sorted(leading)}; "
        f"launches {json.dumps(launches)}")
    log(f"    {wide.total_peers} peers (K = {wide.total_peers - 1}, "
        f"{wide.watch_s:g} s): card {wide_wall!r} s, CPU path "
        f"{cpu_wall!r} s, frames agree; {over.total_peers} peers refused "
        f"on the card: {refused}")
    return {"launches": launches, "wall": wall}


def _control_loop(config, shard, root, tag, warm, **kw):
    from hlsjs_p2p_wrapper_tpu_torch.engine.controller import (ControlLoop,
                                                                LogActuator)
    from hlsjs_p2p_wrapper_tpu_torch.testing import control_fixture as cf
    return cf.recording(ControlLoop)(
        config, shard, LogActuator(os.path.join(root, f"{tag}.jsonl")),
        warm_start=warm, device="cuda", **kw)


def _rows_by_source(loop):
    return {labels["source"]: value for labels, value
            in loop.registry.series("control.forecast_rows")}


def _tick_medians(loop, warmup):
    import statistics
    stats = [s for s in loop.tick_stats if s["tick"] >= warmup]
    return {k: statistics.median(s[k] for s in stats)
            for k in CONTROL_TICK_PHASES}


def _check_run(loop, ref, tag, first_tick=0):
    """A loop's decisions equal to the fixture run's, its forecasts from
    ``first_tick`` on within FORECAST_TOL of the reference's."""
    from hlsjs_p2p_wrapper_tpu_torch.testing import control_fixture as cf
    check(cf.decision_sig(loop.decisions) == ref["decisions"],
          f"{tag} decisions {cf.decision_sig(loop.decisions)} against the "
          f"reference's {ref['decisions']}")
    err = cf.forecast_error(
        cf.forecast_rows(loop.forecasts),
        [r for r in ref["forecasts"] if r[0] >= first_tick])
    check(err <= cf.FORECAST_TOL,
          f"{tag} forecasts off the reference's by {err!r}")
    return err


def phase_control(sk, smi):
    """``ControlLoop`` on the card over the control gate's recorded chaos
    shard, config (a): decisions and forecasts against the reference's,
    a flight recorder and a fresh row cache; warm on the same root; then
    stopped after its first actuation and resumed from its checkpoint."""
    import shutil
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.engine.artifact_cache import WarmStart
    from hlsjs_p2p_wrapper_tpu_torch.engine.controller import (
        LogActuator, control_checkpoint_path)
    from hlsjs_p2p_wrapper_tpu_torch.engine.tracer import (FlightRecorder,
                                                           read_shard)
    from hlsjs_p2p_wrapper_tpu_torch.testing import control_fixture as cf
    root = os.path.join(WARM_DIR, "control")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    doc = cf.load_json(cf.CONTROL_DECISIONS)
    config = cf.config_from_dict(doc["configs"]["a"])
    ref = doc["runs"]["a"]
    shard = cf.unpack_shard(os.path.join(root, "shard.jsonl"))
    warm_root = os.path.join(root, "rows")
    recorder = FlightRecorder(os.path.join(root, "trace"), "control")
    sk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cold = _control_loop(config, shard, root, "actuate",
                         WarmStart(warm_root), recorder=recorder)
    cold.run_available()
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = {k: v for k, v in sk.LAUNCHES.items() if v}
    check(all(k in launches for k in CONTROL_KERNELS),
          f"[40] the forecasts launched {json.dumps(launches)}")
    err = _check_run(cold, ref, "[40] the loop's")
    recorder.close()
    _meta, events = read_shard(recorder.path)
    marks = [e["name"] for e in events if e.get("kind") == "mark"]
    check(marks.count("control_tick") == len(ref["decisions"])
          and marks.count("actuation") == len(ref["epochs"]),
          f"[40] the recorder's marks: {marks.count('control_tick')} "
          f"ticks, {marks.count('actuation')} actuations")
    log_path = os.path.join(root, "actuate.jsonl")
    check(LogActuator(log_path).epochs() == ref["epochs"],
          f"[40] the actuation log {LogActuator(log_path).epochs()}")
    cold_rows = _rows_by_source(cold)

    before = dict(sk.LAUNCHES)
    t0 = time.perf_counter()
    again = _control_loop(config, shard, root, "actuate",
                          WarmStart(warm_root))
    again.run_available()
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    _check_run(again, ref, "[40] the warm loop's")
    warm_rows = _rows_by_source(again)
    check(warm_rows.get("dispatch", 0) == 0 and dict(sk.LAUNCHES) == before
          and LogActuator(log_path).epochs() == ref["epochs"],
          f"[40] the warm loop: rows {warm_rows}, actuation log "
          f"{LogActuator(log_path).epochs()}")

    ckpt = control_checkpoint_path(os.path.join(root, "cache"), config)
    resume_root = os.path.join(root, "rows-resume")
    t0 = time.perf_counter()
    stopped = _control_loop(config, shard, root, "resume",
                            WarmStart(resume_root), checkpoint_path=ckpt,
                            tick_gate=lambda _w: stopped.epoch == 0)
    stopped.run_available()
    acted = next(i for i, d in enumerate(ref["decisions"])
                 if d[1] == "actuate")
    check(stopped.epoch == 1 and len(stopped.decisions) == acted + 1
          and stopped.pending_windows > 0,
          f"[40] the stopped loop: epoch {stopped.epoch}, "
          f"{len(stopped.decisions)} decisions")
    resumed = _control_loop(config, shard, root, "resume",
                            WarmStart(resume_root), checkpoint_path=ckpt)
    check(resumed.resume(), "[40] no checkpoint to resume")
    resumed.run_available()
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    _check_run(resumed, ref, "[40] the resumed loop's", acted + 1)
    resume_log = LogActuator(os.path.join(root, "resume.jsonl")).epochs()
    check(resume_log == ref["epochs"],
          f"[40] the resumed actuation log {resume_log}")
    medians = {"cold": _tick_medians(cold, config.warmup_windows),
               "warm": _tick_medians(again, config.warmup_windows)}
    key_ms = _row_key_ms(config, cold._lattice[0])
    acts = [(d[0], d[2]) for d in ref["decisions"] if d[1] == "actuate"]
    log(f"[40] ControlLoop on the card over the control gate's chaos shard "
        f"({len(ref['decisions'])} windows, a {len(cold._lattice)}-point "
        f"lattice, config (a)): {walls[0]!r} s cold, {walls[1]!r} s warm, "
        f"{walls[2]!r} s stopped after its first actuation and resumed, "
        f"on {smi}; decisions equal to the reference's (actuations "
        f"{acts}), forecasts within {err!r} of its; rows {cold_rows} "
        f"cold, {warm_rows} warm; each epoch once in the actuation logs; "
        f"launches {json.dumps(launches)}")
    log(f"    median tick phases, s (after the {config.warmup_windows} "
        f"warmup windows): {json.dumps(medians)}; one row-cache key of a "
        f"forecast point {key_ms!r} ms")
    return {"launches": launches, "walls": walls, "medians": medians}


def _row_key_ms(config, knobs, n=5):
    """Milliseconds of one row-cache key of a forecast point on the card
    (the mean of ``n`` keys): most of a warm forecast tick."""
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.engine.artifact_cache import row_key
    from hlsjs_p2p_wrapper_tpu_torch.testing.twin import forecast_group
    spec = config.spec
    sim_config, _items, build = forecast_group(spec, spec.join_times_s(),
                                               [knobs], device="cuda")
    scenario, join = build(knobs)
    n_steps = int(round(spec.watch_s * 1000.0 / sim_config.dt_ms))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        row_key(sim_config, scenario, join, n_steps, watch_s=spec.watch_s,
                record_every=0)
    return (time.perf_counter() - t0) / n * 1e3


def phase_fleet_control(sk, smi):
    """Config (b), the SLO-armed fleet form, on the card: the shard split
    four ways (``testing/twin.split_shard``), its decisions and SLO burn
    against the reference's; the one shard on the same rows, equal."""
    import torch
    from hlsjs_p2p_wrapper_tpu_torch.engine.artifact_cache import WarmStart
    from hlsjs_p2p_wrapper_tpu_torch.testing import control_fixture as cf
    from hlsjs_p2p_wrapper_tpu_torch.testing.twin import split_shard
    root = os.path.join(WARM_DIR, "control")
    doc = cf.load_json(cf.CONTROL_DECISIONS)
    config = cf.config_from_dict(doc["configs"]["b"])
    ref = doc["runs"]["b"]
    shard = os.path.join(root, "shard.jsonl")
    quarters = split_shard(shard, os.path.join(root, "mux"), 4)
    warm_root = os.path.join(root, "rows-fleet")
    walls, loops = [], {}
    sk.reset_launch_counts()
    for tag, paths in (("four", quarters), ("one", shard)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loops[tag] = _control_loop(config, paths, root, f"fleet-{tag}",
                                   WarmStart(warm_root))
        loops[tag].run_available()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if tag == "four":
            launches = {k: v for k, v in sk.LAUNCHES.items() if v}
    check(all(k in launches for k in CONTROL_KERNELS),
          f"[41] the forecasts launched {json.dumps(launches)}")
    for tag, loop in loops.items():
        err = _check_run(loop, ref, f"[41] the {tag}-shard loop's")
        burns = [a["window"] for a in loop.slo.alerts]
        check(burns == ref["burn_windows"],
              f"[41] the {tag}-shard loop's burns at {burns}, the "
              f"reference's at {ref['burn_windows']}")
    alert = loops["four"].slo.alerts[0] if loops["four"].slo.alerts else {}
    log(f"[41] the fleet form on the card (config (b): SLO-armed, "
        f"{len(quarters)} shards by split_shard): {walls[0]!r} s, then the "
        f"one shard on the same rows {walls[1]!r} s, on {smi}; both "
        f"equal to the reference's decisions, burn at windows "
        f"{ref['burn_windows']} (worst cohort "
        f"{(alert.get('worst_cohort') or {}).get('cohort')}, worst shard "
        f"{(alert.get('worst_shard') or {}).get('shard')}); rows "
        f"{_rows_by_source(loops['four'])} and "
        f"{_rows_by_source(loops['one'])}; launches "
        f"{json.dumps(launches)}")
    return {"launches": launches, "walls": walls}


def _tool_go(name, proc, argv, env=None):
    """Read a tool child's ready line, then send it its argv (and the
    environment entries it sets before the tool runs)."""
    line = proc.stdout.readline()
    check(line.startswith("{"), _child_failure(name, proc,
                                               "did not get ready"))
    try:
        proc.stdin.write(json.dumps({"argv": [str(a) for a in argv],
                                     "env": env or {}}) + "\n")
        proc.stdin.flush()
    except BrokenPipeError:
        check(False, _child_failure(name, proc, "died before its run"))
    return json.loads(line), time.perf_counter()


def _tool_end(name, proc, t_go):
    """A tool child's report (its last stdout line) and its wall from the
    go to its exit; fails unless the child and its tool exited 0."""
    rc, records, wall = _child_end(name, proc, t_go)
    check(rc == 0 and records and records[-1].get("rc") == 0,
          _child_failure(name, proc, f"failed ({records[-1:]})"))
    return records[-1], wall


def _fixture_meta_keys(name):
    with open(os.path.join(TOOLS_FIXTURE, f"{name}.json")) as fh:
        return set(json.load(fh)["meta"])


def _timeline_records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _last_ratios(record):
    cols, last = record["columns"], record["samples"][-1]
    return (last[cols.index("offload")], last[cols.index("rebuffer")])


def phase_tools(g9, ring, rings, randoms, search, children):
    """The port's tools as child processes on the card
    (``testing/tool_child.py``, started beside phase 3 and waiting
    without a context on the card), at full width and side by side:
    ``tools.sweep`` on phase 9's grid (1,048,576 x 128 x 240 s, a row
    every 40 steps) on a fresh warm-start root, ``tools.optimize`` at
    phase 37's settings on phase 37's root, and ``tools.policy_ab`` at
    its defaults (a row every 40 steps) on a fresh root.  The sweep's rows and
    timelines equal phase 9's to the bit (the timelines' full-precision
    last samples), every point dispatched, its ``--out`` artifact with
    the keys of ``SWEEP_1M_r05.json`` and of the reference tool's at HEAD
    (the committed tools fixture), ``platform`` gpu; the policy A/B's
    ring rows equal phases 17 and 24's and its random rows phase 28's to
    the bit; the search equals phase 37's frontier and trials
    (``float.hex``) with no fresh dispatch, build, capture or launch.
    Each child's wall and its kernels' launches are printed."""
    import torch
    from hlsjs_p2p_wrapper_tpu_torch import policy_grid as pg
    torch.cuda.synchronize()
    # the children size their chunks from the card's free memory
    torch.cuda.empty_cache()
    os.makedirs(TOOLS_DIR)
    t0 = time.perf_counter()
    sweep_out = os.path.join(TOOLS_DIR, "sweep.json")
    sweep_tl = os.path.join(TOOLS_DIR, "sweep.timelines.jsonl")
    go = {}
    go["sweep"] = _tool_go(
        "tool_sweep", children["tool_sweep"],
        ["--peers", GRID_PEERS, "--segments", GRID_SEGMENTS, "--watch-s",
         GRID_WATCH_S, "--record-every", GRID_RECORD_EVERY,
         "--timelines-out", sweep_tl, "--out", sweep_out,
         "--device", "cuda"],
        {"HLSJS_P2P_TORCH_CACHE_DIR": os.path.join(TOOLS_DIR, "sweep")})
    opt_out = os.path.join(TOOLS_DIR, "optimize.json")
    go["optimize"] = _tool_go(
        "tool_optimize", children["tool_optimize"],
        ["--peers", GRID_PEERS, "--segments", GRID_SEGMENTS, "--watch-s",
         GRID_WATCH_S, "--chunk", search["chunk"], "--cache-dir",
         search["root"], "--out", opt_out, "--device", "cuda"])
    pab_out = os.path.join(TOOLS_DIR, "policy_ab.json")
    pab_tl = os.path.join(TOOLS_DIR, "policy_ab.timelines.jsonl")
    go["policy_ab"] = _tool_go(
        "tool_policy_ab", children["tool_policy_ab"],
        ["--peers", randoms[(RANDOM_PEERS, "spread")]["config"].n_peers,
         "--ring-peers", ring["config"].n_peers, "--segments", pg.SEGMENTS,
         "--watch-s", pg.WATCH_S, "--record-every",
         GRID_RECORD_EVERY, "--timelines-out", pab_tl, "--out", pab_out,
         "--device", "cuda"],
        {"HLSJS_P2P_TORCH_CACHE_DIR": os.path.join(TOOLS_DIR, "policy_ab")})
    reports, walls = {}, {}
    for tool in TOOL_CHILDREN:
        reports[tool], walls[tool] = _tool_end(
            f"tool_{tool}", children[f"tool_{tool}"], go[tool][1])
    phase_wall = time.perf_counter() - t0
    kind = torch.cuda.get_device_name(0)

    def identity_ok(meta):
        return (meta["platform"], meta["device_kind"]) == (
            TOOL_PLATFORM, kind if TOOL_PLATFORM == "gpu" else "cpu")

    # tools.sweep: phase 9's rows and timelines to the bit
    with open(sweep_out) as fh:
        art = json.load(fh)
    with open(os.path.join(ROOT, REFERENCE_SWEEP)) as fh:
        record_keys = set(json.load(fh)["meta"])
    meta = art["meta"]
    check(set(meta) >= record_keys
          and set(meta) == _fixture_meta_keys("sweep_vod")
          and identity_ok(meta)
          and meta["grid_points"] == len(g9["grid"])
          and meta["failed_points"] == 0
          and meta["warm_start"]["row"] == {"miss": len(g9["grid"]),
                                            "store": len(g9["grid"])},
          f"[42] tools.sweep's artifact meta {json.dumps(meta)}")
    timelines = _timeline_records(sweep_tl)
    check(len(timelines) == len(g9["rows"]) and all(
        _hexed(_last_ratios(rec)) == _hexed((off, reb))
        and rec["samples"] == tl.tolist()
        for rec, (off, reb, tl) in zip(timelines, g9["rows"])),
        "[42] tools.sweep's rows or timelines differ from phase 9's")
    want = sorted(({**knobs, "offload": round(off, 4),
                    "rebuffer": round(reb, 5)}
                   for knobs, (off, reb, _tl) in zip(g9["grid"], g9["rows"])),
                  key=lambda r: (-r["offload"], r["rebuffer"]))
    check(art["rows"] == want, "[42] tools.sweep's table differs from "
                               "phase 9's rows, rounded and sorted")

    # tools.policy_ab: the ring columns of phases 17 and 24, the random
    # columns of phase 28
    with open(pab_out) as fh:
        pab = json.load(fh)
    check(set(pab["meta"]) == _fixture_meta_keys("policy_ab")
          and identity_ok(pab["meta"])
          and pab["meta"]["failed_cells"] == 0,
          f"[42] tools.policy_ab's meta {json.dumps(pab['meta'])}")
    by_column = {}
    for rec in _timeline_records(pab_tl):
        by_column.setdefault((rec["topology"], rec["policy"]), []).append(rec)
    columns = {("ring", "spread"): ring,
               **{("ring", p): rings[p] for p in POLICIES},
               **{("random", p): randoms[(RANDOM_PEERS, p)]
                  for p in pg.POLICIES}}
    for (topology, policy), g in sorted(columns.items()):
        recs = by_column.get((topology, policy), [])
        check(len(recs) == len(g["rows"]) and all(
            _hexed(_last_ratios(rec)) == _hexed(tuple(row))
            for rec, row in zip(recs, g["rows"])),
            f"[42] tools.policy_ab's {topology} {policy} rows differ from "
            f"the phase's")
        table = pab["topologies"][topology]["rows"]
        check([(r[f"{policy}_offload"], r[f"{policy}_rebuffer"])
               for r in table] == [_rounded(*row) for row in g["rows"]],
              f"[42] tools.policy_ab's {topology} {policy} table differs")

    with open(os.path.join(ROOT, REFERENCE_POLICY_AB)) as fh:
        record = json.load(fh)["meta"]

    # tools.optimize: phase 37's frontier from its warm start alone
    with open(opt_out) as fh:
        opt = json.load(fh)
    from hlsjs_p2p_wrapper_tpu_torch.engine.search import scrub_provenance
    with open(os.path.join(ROOT, REFERENCE_SEARCH)) as fh:
        search_keys = set(json.load(fh)["meta"])
    rep = reports["optimize"]
    fresh = sum(r["fresh_dispatches"] for r in opt["rounds"])
    cached = sum(r["row_cache_hits"] for r in opt["rounds"])
    check(_hexed(scrub_provenance(opt["frontier"])) == search["frontier"]
          and _hexed(scrub_provenance(opt["trials"])) == search["trial_list"],
          "[42] tools.optimize's frontier or trials differ from phase 37's")
    check(fresh == 0 and cached == search["trials"]
          and opt["meta"]["xla_compiles"] == 0 and rep["builds"] == 0
          and rep["captures"] == 0 and not any(rep["launches"].values())
          and set(opt["meta"]) == _fixture_meta_keys("optimize")
          and set(opt["meta"]) >= search_keys
          and identity_ok(opt["meta"]),
          f"[42] tools.optimize on phase 37's root: {fresh} fresh, "
          f"{cached} cached, report {json.dumps(rep)}")
    log(f"[42] the tools as child processes on {kind}, side by side "
        f"(started beside phase 3; startup {json.dumps({k: round(v[0]['startup_s'], 3) for k, v in go.items()})} s): "
        f"{phase_wall!r} s from the first go to the last exit")
    log(f"    tools.sweep (VOD grid, {len(g9['grid'])} points x "
        f"{GRID_PEERS:,} x {GRID_SEGMENTS} x {GRID_WATCH_S:g} s, a row every "
        f"{GRID_RECORD_EVERY} steps, fresh root): wall {walls['sweep']!r} s "
        f"(the tool's own {meta['elapsed_s']} s, chunk {meta['chunk']} "
        f"autotuned, {meta['compile_groups']} builds + captures); rows and "
        f"timelines equal phase 9's to the bit, the table its rows rounded; "
        f"row events {json.dumps(meta['warm_start']['row'])}; launches "
        f"{json.dumps(reports['sweep']['launches'])}")
    log(f"    tools.optimize (phase 37's settings and root): wall {walls['optimize']!r} s (the tool's own "
        f"{opt['meta']['elapsed_s']} s); {fresh} fresh dispatches, {cached} "
        f"row-cache hits, {rep['builds']} builds, {rep['captures']} "
        f"captures, launches {json.dumps(rep['launches'])}; frontier and "
        f"trials equal phase 37's to the bit (float.hex, provenance aside)")
    log(f"    tools.policy_ab (its defaults: random "
        f"{pab['topologies']['random']['peers']:,}, ring "
        f"{pab['topologies']['ring']['peers']:,}, a row every {GRID_RECORD_EVERY} steps, fresh "
        f"root): wall {walls['policy_ab']!r} s (the tool's "
        f"own {pab['meta']['elapsed_s']} s, chunks "
        f"{json.dumps(pab['meta']['resolved_chunks'])}); ring rows equal "
        f"phases 17 and 24's, random rows phase 28's, to the bit; verdict "
        f"{'PASS' if pab['meta']['sim_acceptance_pass'] else 'FAIL'} (worst "
        f"default margin {pab['meta']['worst_default_margin']} at "
        f"{pab['meta']['worst_cell']}; {REFERENCE_POLICY_AB}: "
        f"{record['worst_default_margin']} at {record['worst_cell']}); "
        f"launches "
        f"{json.dumps(reports['policy_ab']['launches'])}")
    return {"walls": walls, "phase_wall": phase_wall, "reports": reports}


def _gate_line(name):
    """The gate's PASS/FAIL line in its child's standard error."""
    with open(os.path.join(WARM_DIR, f"tool_{name}.err")) as fh:
        lines = [ln for ln in fh.read().splitlines()
                 if ln.startswith(f"# {name.replace('_', '-')}: ")]
    return lines[-1] if lines else None


def _gate_children(name):
    """The builds, captures and launches of the gate's children, summed
    (its ``# children's kernels:`` line)."""
    from hlsjs_p2p_wrapper_tpu_torch.tools import CHILDREN_LINE
    with open(os.path.join(WARM_DIR, f"tool_{name}.err")) as fh:
        lines = [ln for ln in fh.read().splitlines()
                 if ln.startswith(CHILDREN_LINE)]
    return json.loads(lines[-1][len(CHILDREN_LINE):]) if lines else {}


def _gate_summary(name):
    """The gate's own lines (``<gate>: ...`` and ``<gate> ...``: its
    summary, its checks' lines, its problems) in its child's standard
    output and error."""
    prefix = name.replace("_", "-")
    with open(os.path.join(WARM_DIR, f"tool_{name}.err")) as fh:
        err = fh.read()
    return [ln for ln in CHILD_STDOUT.get(f"tool_{name}", "").splitlines()
            + err.splitlines() if ln.startswith(prefix)]


def phase_gates(children):
    """The port's four sweep-side gates (``tools.fleet_gate``,
    ``tools.trace_gate``, ``tools.optimize_gate``,
    ``tools.population_gate``) as child processes on the card
    (``testing/tool_child.py --prepare``, started after phase 38 with
    their own children, all waiting), side by side, each on its own
    throwaway roots.  Widths: the fleet and trace gates at phase
    9's, 1,048,576 peers x 128 segments x 240 s on the 48-point VOD grid
    (units of GATE_CHUNK, 3; a lease of GATE_LEASE_S, no shorter than
    phase 38's; the fleet gate's stall 3 leases); the optimize and
    population gates at their defaults (48 and 64 peers: at 1,048,576
    peers they would repeat grids that phases 13, 32, 34, 37 and 42 run
    through the same dispatch).  Each must print PASS; a failing gate
    fails the script.  Each gate's wall from its go, its own and its
    children's builds, captures and kernel launches are printed (the
    gates' "0 compiles" is 0 nvcc builds in a warm, rerun or resumed
    child and 0 captures where nothing dispatches).  The phase runs
    after phase 42, not beside phases 39-41: there the gates slowed
    those phases' small forecasts by more than the overlap saved
    (PERF.md §6)."""
    import torch
    torch.cuda.synchronize()
    # the gates' children size nothing from free memory, but seven
    # processes at 1M peers share the card
    torch.cuda.empty_cache()
    wide = {"PEERS": GRID_PEERS, "SEGMENTS": GRID_SEGMENTS,
            "WATCH_S": GRID_WATCH_S, "LEASE_S": GATE_LEASE_S,
            "CHUNK": GATE_CHUNK}
    envs = {"fleet_gate": {f"FLEET_GATE_{k}": str(v)
                           for k, v in wide.items()},
            "trace_gate": {f"TRACE_GATE_{k}": str(v)
                           for k, v in wide.items()}}
    t0 = time.perf_counter()
    go = {gate: _tool_go(f"tool_{gate}", children[f"tool_{gate}"],
                         ["--device", "cuda"], envs.get(gate))
          for gate in GATE_CHILDREN}
    reports, walls = {}, {}
    for gate in GATE_CHILDREN:
        reports[gate], walls[gate] = _tool_end(
            f"tool_{gate}", children[f"tool_{gate}"], go[gate][1])
    phase_wall = time.perf_counter() - t0
    for gate in GATE_CHILDREN:
        line = _gate_line(gate)
        check(line is not None and ": PASS " in line,
              f"[43] {gate}: {line}")
    log(f"[43] the sweep-side gates as child processes on "
        f"{torch.cuda.get_device_name(0)}, side by side (started after "
        f"phase 38; startup "
        f"{json.dumps({k: round(v[0]['startup_s'], 3) for k, v in go.items()})}"
        f" s): {phase_wall!r} s from the first go to the last exit (budget "
        f"{GATE_BUDGET_S:g} s)")
    for gate in GATE_CHILDREN:
        rep = reports[gate]
        kids = _gate_children(gate)
        own = {k: v for k, v in rep["launches"].items() if v}
        theirs = {k: v for k, v in (kids.get("launches") or {}).items() if v}
        log(f"    {gate}: wall {walls[gate]!r} s (its main "
            f"{rep['wall_s']!r} s); builds {rep['builds']}, captures "
            f"{rep['captures']}, launches {json.dumps(own)} in the gate's "
            f"process; its children: builds {kids.get('builds', 0)}, "
            f"captures {kids.get('captures', 0)}, launches "
            f"{json.dumps(theirs)}; {_gate_line(gate)}")
        for summary in _gate_summary(gate):
            log(f"      {summary}")
    return {"walls": walls, "phase_wall": phase_wall, "reports": reports}


def _walls_line(name):
    """The gate's ``<gate> walls (s): {...}`` line, parsed."""
    prefix = f"{name.replace('_', '-')} walls (s): "
    lines = [ln for ln in CHILD_STDOUT.get(f"tool_{name}", "").splitlines()
             if ln.startswith(prefix)]
    return json.loads(lines[-1][len(prefix):]) if lines else {}


def _checks_line(name):
    """The control gate's ``control-gate: N/M checks passed`` line."""
    prefix = f"{name.replace('_', '-')}: "
    lines = [ln for ln in CHILD_STDOUT.get(f"tool_{name}", "").splitlines()
             if ln.startswith(prefix) and ln.endswith(" checks passed")]
    return lines[-1] if lines else None


def phase_control_gates(children):
    """The port's twin and control gates (``tools.twin_gate``,
    ``tools.control_gate``) as child processes on the card
    (``testing/tool_child.py --prepare``, started with phase 43's gates,
    their own children too, all waiting), side by side, each on its own
    warm-start root, at their defaults: 8 peers plus a wave of 4, 160 s
    in 8-s windows (the shape ``TWIN_r10.json``'s bands are calibrated
    at).  The twin gate holds the port's real-protocol plane to its sim
    plane on the card within those bands (event plane equal to the
    registry plane, a same-seed rerun in another process equal, the
    injected wave shift localized, the consumers rendering); the control
    gate closes the controller's loop under chaos with its forecasts on
    the card (part A), over the real TCP wire on the loopback interface
    (part B) and across a SIGKILL of ``tools.control --device cuda``
    (part C).  The twin gate must print PASS, the control gate every
    check passed; their children build nothing.  Each gate's wall from
    its go, its stages' walls, and its own and its children's builds,
    captures and kernel launches are printed."""
    import torch
    torch.cuda.synchronize()
    roots = {gate: os.path.join(WARM_DIR, f"root_{gate}")
             for gate in CONTROL_GATE_CHILDREN}
    t0 = time.perf_counter()
    go = {gate: _tool_go(f"tool_{gate}", children[f"tool_{gate}"],
                         ["--device", "cuda"],
                         {"HLSJS_P2P_TORCH_CACHE_DIR": roots[gate]})
          for gate in CONTROL_GATE_CHILDREN}
    reports, walls = {}, {}
    for gate in CONTROL_GATE_CHILDREN:
        reports[gate], walls[gate] = _tool_end(
            f"tool_{gate}", children[f"tool_{gate}"], go[gate][1])
    phase_wall = time.perf_counter() - t0
    twin_line = _gate_line("twin_gate")
    check(twin_line is not None and ": PASS " in twin_line,
          f"[44] twin_gate: {twin_line}")
    checks = _checks_line("control_gate")
    passed = checks and checks.split()[1].split("/")
    check(passed and passed[0] == passed[1],
          f"[44] control_gate: {checks}")
    launches = {}
    for gate in CONTROL_GATE_CHILDREN:
        kids = _gate_children(gate)
        check(kids.get("builds") == 0,
              f"[44] {gate}: its children made {kids.get('builds')} nvcc "
              f"builds (0 expected: the libraries are built)")
        for part in (reports[gate]["launches"], kids.get("launches") or {}):
            for name, n in part.items():
                launches[name] = launches.get(name, 0) + n
    log(f"[44] the twin and control gates as child processes on "
        f"{torch.cuda.get_device_name(0)}, side by side (started with "
        f"phase 43's; startup "
        f"{json.dumps({k: round(v[0]['startup_s'], 3) for k, v in go.items()})}"
        f" s): {phase_wall!r} s from the first go to the last exit (budget "
        f"{CONTROL_GATE_BUDGET_S:g} s)")
    for gate in CONTROL_GATE_CHILDREN:
        rep = reports[gate]
        kids = _gate_children(gate)
        own = {k: v for k, v in rep["launches"].items() if v}
        theirs = {k: v for k, v in (kids.get("launches") or {}).items() if v}
        log(f"    {gate}: wall {walls[gate]!r} s (its main "
            f"{rep['wall_s']!r} s); stages (s) "
            f"{json.dumps(_walls_line(gate))}; builds {rep['builds']}, "
            f"captures {rep['captures']}, launches {json.dumps(own)} in the "
            f"gate's process; its children: builds {kids.get('builds', 0)}, "
            f"captures {kids.get('captures', 0)}, launches "
            f"{json.dumps(theirs)}; "
            f"{twin_line if gate == 'twin_gate' else checks}")
        for summary in _gate_summary(gate):
            if not summary.startswith(("control-gate walls",
                                       "twin-gate walls")):
                log(f"      {summary}")
    return {"walls": walls, "phase_wall": phase_wall, "reports": reports,
            "launches": launches}


def _resources(res, name, live, slots, policy):
    """:func:`gather_resources`' entry of the instantiation that ``name``
    launches for ``policy`` (admit_gather has one a slot count,
    peer_update_gather one with the penalty window and one without)."""
    if name == "admit_gather" or (name == "peer_update_gather"
                                  and policy != "adaptive"):
        policy = "spread"
    return res.get((name, live, slots, policy), "not built")


def gather_entry(name, source, replaces, randoms, errs_gather, res):
    """The ``kernels`` line's entry of a gather kernel: launches over the
    random half at RANDOM_PEERS_LARGE (each policy's grid), its
    CUDA-event, traced and plain times, bytes and bound on the spread
    grid's chunk there, and per (size, policy) the same besides, with
    the instantiation's registers, spills and resident blocks an SM."""
    big = randoms[(RANDOM_PEERS_LARGE, "spread")]
    tr = big["trace"]
    traced = tr["traced"].get(name)
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces,
             "launches": sum(randoms[(RANDOM_PEERS_LARGE, p)]["launches"]
                             [name] for p in POLICIES + ("spread",)),
             "launches_in": f"the random half of tools/policy_ab.py at "
                            f"{RANDOM_PEERS_LARGE:,} peers, each policy",
             "max_abs_err": errs_gather.get(name, 0.0),
             "shape": f"{len(big['cells'])} x {RANDOM_PEERS_LARGE:,}, "
                      f"C = {big['config'].max_concurrency}, spread",
             "ms": tr["ms"][name], "plain_ms": tr["plain_ms"][name],
             "traced_ms": None if traced is None else traced[1],
             "bytes": tr["bytes"][name], "bound_ms": tr["bound_ms"][name],
             "bound_by": "bytes", "library_ms": None,
             "registers": _resources(res, name, False, 3, "spread")}
    for (peers, policy), r in sorted(randoms.items()):
        t = r["trace"]
        traced = t["traced"].get(name)
        entry[f"{policy}_{peers}"] = {
            "launches": r["launches"][name], "ms": t["ms"][name],
            "plain_ms": t["plain_ms"][name],
            "traced_ms": None if traced is None else traced[1],
            "bytes": t["bytes"][name], "bound_ms": t["bound_ms"][name],
            "registers": _resources(res, name, False, 3, policy)}
    return entry


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
    from hlsjs_p2p_wrapper_tpu_torch import policy_grid as pg
    from hlsjs_p2p_wrapper_tpu_torch import sweep_grid as sg
    from hlsjs_p2p_wrapper_tpu_torch.ops import (dispatch as dp,
                                                 swarm_kernels as sk,
                                                 swarm_sim as sim)
    children = {}
    try:
        smi = phase_card()
        regs = phase_build()
        res = gather_resources(sk, regs)
        children.update(start_tool_children())
        errs_1m = phase_kernels_vs_plain(sim, sk, CHECK_PEERS, SEGMENTS,
                                         CHECK_WARM_STEPS)
        errs_routes = phase_routes(sim, sk)
        errs_routes["select_admit"] = max(
            errs_routes["select_admit"],
            phase_spans(sim, sk, PEERS, SEGMENTS, STEPS))
        (main_launches, errs, ms, traced_ms, plain_ms, nbytes,
         library_b1, main_run) = phase_main(sim, sk, PEERS, SEGMENTS, STEPS,
                                            WINDOW)
        children.update(start_children())
        phase_main_plain(sim, sk, main_run)
        del main_run
        phase_fixture(sim)
        errs_batch, sums_rel = phase_batch_kernels(sim, sk, sg)
        phase_batch_fixture()
        grid = phase_grid(sim, sk, sg, dp)
        b48 = phase_trace48(sim, sk, grid)
        del grid["scenario"], grid["final"]
        started = phase_resume_killed(sg, children, grid)
        ls_err, ls_rel = phase_lane_sums(sim, sk)
        errs_batch["lane_sums"] = max(errs_batch.get("lane_sums", 0.0),
                                      ls_err)
        sums_rel = max(sums_rel, ls_rel)
        errs_live = phase_live_kernels(sim, sk, sg)
        phase_live_fixture()
        phase_resume_rest(children, grid, started)
        live_grid = phase_live_grid(sim, sk, sg, dp)
        live = phase_live_trace(sim, sk, live_grid)
        errs_prefetch = phase_prefetch_kernels(sim, sk)
        phase_prefetch_fixture()
        ring = phase_ring_grid(sim, sk, pg, dp)
        prefetch = phase_ring_trace(sim, sk, ring)
        phase_injected_faults(sim, dp, ring)
        del ring["scenario"], ring["final"]
        phase_real_oom(sim, sg, dp, grid)
        # the card after the recovery: a run that captures graphs
        phase_prefetch_fixture("[21] after the real OOM, again the")
        errs_policy, _branches = phase_policy_kernels(sim, sk)
        phase_policies_fixture(sim)
        rings, traces = {}, {}
        for policy in POLICIES:
            rings[policy] = phase_ring_grid(sim, sk, pg, dp, policy, "[24]")
            traces[policy] = phase_ring_trace(sim, sk, rings[policy],
                                              "[25]")
            del rings[policy]["scenario"], rings[policy]["final"]
        errs_gather, _gather_counts = phase_gather_kernels(sim, sk)
        phase_general_fixture(sim)
        randoms = {}
        for tag, peers in (("[28]", RANDOM_PEERS),
                           ("[29]", RANDOM_PEERS_LARGE)):
            for policy in pg.POLICIES:
                r = phase_ring_grid(sim, sk, pg, dp, policy, tag, "random",
                                    peers)
                r["trace"] = phase_ring_trace(sim, sk, r, tag)
                del r["scenario"], r["final"]
                randoms[(peers, policy)] = r
        errs_population = phase_population_kernels(sim, sk, sg, pg)
        phase_population_fixture()
        mixture = phase_population_grid(sim, sk, sg, dp)
        cohorts = phase_cohort_rows(sim, sk, mixture)
        del mixture["scenario"], mixture["final"]
        phase_degenerate(sim, sg, dp)
        phase_traced_grid(sg, dp, sk, grid)
        search = phase_search(live_grid["chunk"])
        phase_fleet(sg, grid, children)
        children.update(start_gate_children())
        twin = phase_twin(sk, smi)
        control = phase_control(sk, smi)
        fleet_control = phase_fleet_control(sk, smi)
        phase_tools(grid, ring, rings, randoms, search, children)
        phase_gates(children)
        control_gates = phase_control_gates(children)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        stop_children(children)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        if name in sk.GATHER_PATH:
            kernels.append(gather_entry(name, source, replaces, randoms,
                                        errs_gather, res))
            continue
        err = max(d.get(name, 0.0) for d in (errs, errs_1m, errs_routes,
                                              errs_batch, errs_live,
                                              errs_prefetch, errs_policy,
                                              errs_gather, errs_population))
        wide = {"shape": f"48 x {GRID_PEERS:,}",
                "launches": b48["launches"].get(name, 0),
                "launches_in": b48["launches_in"],
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
        if name in MAIN_PATH:
            entry["registers"] = registers_of(regs, name, False)
            traced = live["traced"].get(name)
            entry["live"] = {
                "shape": f"{LIVE_TRACE_LANES} x {GRID_PEERS:,}",
                "launches": live_grid["launches"][name],
                "launches_in": "the 144-point live grid",
                "traced_ms": None if traced is None else traced[1],
                "traced_in": f"{TRACE_STEPS} eager steps from the traced "
                             f"chunk's final state",
                "bytes": live["bytes"][name],
                "bound_ms": live["bound_ms"][name],
                "registers": registers_of(regs, name, True)}
            traced = prefetch["traced"].get(name)
            entry["prefetch"] = {
                "shape": f"{len(ring['cells'])} x {ring['config'].n_peers:,}"
                         f", C = {ring['config'].max_concurrency}",
                "launches": ring["launches"][name],
                "launches_in": "the ring spread grid of tools/policy_ab.py",
                "traced_ms": None if traced is None else traced[1],
                "traced_in": f"{TRACE_STEPS} eager steps from the chunk's "
                             f"final state",
                "bytes": prefetch["bytes"][name],
                "bound_ms": prefetch["bound_ms"][name],
                "registers": registers_of(regs, name, False, 3)}
            for policy in POLICIES:
                ring_p, trace_p = rings[policy], traces[policy]
                traced = trace_p["traced"].get(name)
                entry[policy] = {
                    "shape": f"{len(ring_p['cells'])} x "
                             f"{ring_p['config'].n_peers:,}, C = "
                             f"{ring_p['config'].max_concurrency}",
                    "launches": ring_p["launches"][name],
                    "launches_in": f"the ring {policy} grid of "
                                   f"tools/policy_ab.py",
                    "traced_ms": None if traced is None else traced[1],
                    "traced_in": f"{TRACE_STEPS} eager steps from the "
                                 f"chunk's final state",
                    "bytes": trace_p["bytes"][name],
                    "bound_ms": trace_p["bound_ms"][name],
                    "registers": registers_of(regs, name, False, 3, policy)}
            entry["uncapped"] = {
                "shape": f"1 x {PEERS:,}, ring of {DEGREE}",
                "max_abs_err": errs_gather.get(name, 0.0),
                "checked_in": "[26], against the plain version"}
        kernels.append(entry)
    kernels.append({
        "name": "timeline_row_cohorts", "route": "cuda",
        "source": REDUCE_SOURCE, "replaces": f"{REF}:1594",
        "launches": mixture["launches"]["timeline_row_cohorts"],
        "launches_in": "the 144-point mixture grid",
        "max_abs_err": cohorts["max_abs_err"],
        "max_rel_err_ratios": cohorts["rel"], "shape": cohorts["shape"],
        "ms": cohorts["ms"], "ms_without_cohorts": cohorts["ms_bare"],
        # the profiler may miss the 20 calls; then the launches it caught
        # in the mixture chunk's eager steps
        "traced_ms": (cohorts["traced_ms"] if cohorts["traced_ms"]
                      else mixture["traced"].get("timeline_row",
                                                 (None, None))[1]),
        "plain_ms": cohorts["plain_ms"],
        "bytes": cohorts["bytes"], "bound_ms": cohorts["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "registers": regs_of_entry(regs, "timeline_row_kernelILb1EE")})
    for entry in kernels:
        name = entry["name"]
        if name in TWIN_KERNELS + CONTROL_KERNELS:
            entry["control_plane"] = {
                "sim_plane_launches": twin["launches"].get(name, 0),
                "forecast_launches": control["launches"].get(name, 0),
                "fleet_forecast_launches":
                    fleet_control["launches"].get(name, 0),
                "gate_launches": control_gates["launches"].get(name, 0),
                "launches_in": "[39] the twin's sim planes at 12 peers; "
                               "[40] config (a)'s cold loop; [41] config "
                               "(b)'s four-shard loop; [44] the twin and "
                               "control gates with their children"}
    log(f"wall s by phase (up to each line, by its tag): "
        f"{json.dumps({k: round(v, 2) for k, v in PHASE_WALLS.items()})}; "
        f"total {time.perf_counter() - _CLOCK['start']:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
