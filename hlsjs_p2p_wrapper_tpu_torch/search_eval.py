"""The closed-loop policy search over the live scenario family, as the
reference's ``tools/optimize.py`` sets it up (:93-290), on the port's
dispatch: ``live_space`` and ``live_lattice`` (:93-135), ``search_meta``
(:137-175), ``TRIAL_METRICS``, ``Evaluator`` (:176-255, with
``sweep_grid.build_config`` / ``build_scenario`` in place of the sweep
tool's) and ``build_driver`` (:257-290), copied (a CMA-ES batch
smaller than its population raises ``ValueError`` where the tool
exits).  ``search_args`` gives the tool's command-line defaults
(``tools/optimize.py:396-465``) as the namespace these take, so a port
tool can wrap them.

A search on the port::

    args = search_args(peers=P)
    space, constraint = live_space(), Constraint.parse(args.constraint)
    meta = search_meta(args, space, constraint)
    warm = WarmStart(root)
    with SweepJournal(journal_path(root, meta), meta) as journal:
        evaluator = Evaluator(space, peers=P, segments=S, watch_s=W,
                              seed=0, chunk=C, warm_start=warm,
                              faults=FaultPolicy(registry=warm.registry),
                              journal=journal)
        search = PolicySearch(build_driver(args, space, constraint),
                              evaluator, constraint, budget=args.budget,
                              batch=args.batch, registry=warm.registry,
                              checkpoint_path=search_checkpoint_path(
                                  root, meta), checkpoint_meta=meta)
        result = search.run()

One proposal batch is one ``stream_groups_chunked`` call a fidelity:
the row cache's misses dispatch, revisited points are bit-identical row
hits, and the journal and the search's checkpoint make a killed search
resumable (``PolicySearch.resume``).
"""

from __future__ import annotations

import argparse
import itertools

from . import sweep_grid
from .engine.search import (CategoricalAxis, CmaEsDriver, Constraint,
                            ContinuousAxis, GridDriver, GridRefineDriver,
                            HalvingDriver, RandomDriver, SearchSpace)
from .ops.dispatch import stream_groups_chunked


def search_args(**overrides) -> argparse.Namespace:
    """``tools/optimize.py``'s command-line defaults as a namespace,
    with ``overrides`` (``peers=``, ``chunk=``, ...) applied."""
    args = {"driver": "halving", "budget": 64.0, "batch": 144,
            "constraint": "rebuffer<=0.02", "seed": 0, "peers": 1024,
            "segments": 128, "watch_s": 240.0, "chunk": 16, "rungs": 2,
            "eta": 6.0, "screen_fidelity": 0.25, "popsize": None,
            "sigma0": 0.3, "pin": None}
    unknown = set(overrides) - set(args)
    if unknown:
        raise TypeError(f"unknown search arguments {sorted(unknown)}")
    args.update(overrides)
    return argparse.Namespace(**args)


def live_space() -> SearchSpace:
    """The live scenario FAMILY as a search space: the smooth knobs
    continuous (they are all scenario data, so a proposal batch is one
    dispatch group), the coupled/discrete ones categorical, the
    topology degree fixed.  The 144-point live grid is exactly this
    space's lattice (:func:`live_lattice`), so lattice rows share the
    sweep's row-cache keys."""
    return SearchSpace(
        continuous=(
            ContinuousAxis("live_sync_s", 4.0, 16.0),
            ContinuousAxis("urgent_margin_s", 0.25, 8.0),
            ContinuousAxis("spread_s", 0.0, 10.0),
        ),
        categorical=(
            CategoricalAxis("supply", (
                {"uplink_mbps": 1.2, "cdn_mbps": 1.2},
                {"uplink_mbps": 2.4, "cdn_mbps": 2.4},
                {"uplink_mbps": 10.0, "cdn_mbps": 8.0},
            )),
            CategoricalAxis("announce_delay_s", (0.0, 4.0)),
            CategoricalAxis("join_wave", ("steady", "crowd")),
        ),
        fixed={"degree": 8, "ladder": "hd",
               "budget_cap_ms": 6_000.0},
    )


def live_lattice():
    """The 144-point live grid as points in :func:`live_space`: the
    same knob crossing ``sweep_grid.live_grid()`` ships, expressed as
    space points so the lattice drivers (halving / refine / grid) can
    seed from it."""
    syncs = (6.0, 12.0)
    urgents = (0.5, 4.0)
    spreads = (0.0, 2.0, 8.0)
    return [{"live_sync_s": sync, "urgent_margin_s": u,
             "spread_s": sp, "supply": sup,
             "announce_delay_s": ann, "join_wave": wave}
            for sync, u, sp, sup, ann, wave in itertools.product(
                syncs, urgents, spreads, range(3), range(2),
                range(2))]


def search_meta(args, space: SearchSpace,
                constraint: Constraint) -> dict:
    """The search-identity material the journal AND the checkpoint
    are content-addressed by: everything that changes what a trial IS
    or which trial comes next, so a resume can never replay a
    different search's progress."""
    return {
        "tool": "optimize", "peers": args.peers,
        "segments": args.segments, "watch_s": args.watch_s,
        "seed": args.seed, "driver": args.driver,
        "budget": args.budget, "batch": args.batch,
        "constraint": [constraint.metric, constraint.bound],
        "chunk": args.chunk,
        # every driver hyperparameter that changes which trial comes
        # next: two searches differing only in these must not share a
        # journal/checkpoint digest
        "driver_params": {
            "rungs": args.rungs, "eta": args.eta,
            "screen_fidelity": args.screen_fidelity,
            "popsize": args.popsize, "sigma0": args.sigma0,
            "pin": sorted(args.pin or ()),
        },
        "space": {
            "continuous": [list(a) for a in space.continuous],
            "categorical": [[a.name, list(a.values)]
                            for a in space.categorical],
            "fixed": space.fixed,
        },
    }


#: the metric fields every evaluated trial carries (the Evaluator fills
#: them from the dispatch stream): the only names a constraint can
#: reference
TRIAL_METRICS = ("offload", "rebuffer")


class Evaluator:
    """proposals → trials, through the chunked dispatch: one
    ``stream_groups_chunked`` call per distinct fidelity in the batch
    (each fidelity its own ``n_steps``), at the pinned ``chunk`` lanes a
    dispatch.  Row-cache hits fill trials without dispatching
    (``cached: true``); a point whose recovery budget ran out comes back
    as a labeled ``failed`` trial, never an exception.  ``device`` is
    where the scenarios are built (the card when None)."""

    def __init__(self, space: SearchSpace, *, peers: int,
                 segments: int, watch_s: float, seed: int, chunk: int,
                 warm_start, faults, journal=None, trace=None,
                 stagger_s: float = 60.0, device=None):
        self.space = space
        self.peers = peers
        self.segments = segments
        self.watch_s = watch_s
        self.seed = seed
        self.chunk = chunk
        self.warm_start = warm_start
        self.faults = faults
        self.journal = journal
        self.trace = trace
        self.stagger_s = stagger_s
        self.device = device

    def _run_fidelity(self, fidelity: float, knob_list):
        """One fidelity's dispatch: a short screen scales the whole
        scenario horizon (watch window, join wave, rebuffer
        denominator) by the fidelity, a consistent short proxy of the
        same scenario with its own row keys."""
        watch = self.watch_s * fidelity
        config = sweep_grid.build_config(
            self.peers, self.segments, True,
            self.space.fixed.get("degree", 8))
        n_steps = max(1, int(watch * 1000.0 / config.dt_ms))
        build = (lambda k, cfg=config, w=watch:
                 sweep_grid.build_scenario(cfg, k, watch_s=w,
                                           stagger_s=self.stagger_s,
                                           seed=self.seed,
                                           device=self.device))
        results = [None] * len(knob_list)
        stream = stream_groups_chunked(
            [(config, knob_list, build)], n_steps, watch_s=watch,
            chunk=self.chunk, exact_chunk=True,
            warm_start=self.warm_start, faults=self.faults,
            journal=self.journal, trace=self.trace)
        for event in stream:
            if event.metric is None:
                results[event.index] = {
                    "offload": None, "rebuffer": None,
                    "failed": True, "cached": False,
                    "reason": event.reason}
            else:
                results[event.index] = {
                    "offload": float(event.metric[0]),
                    "rebuffer": float(event.metric[1]),
                    "failed": False, "cached": bool(event.cached)}
        return results

    def __call__(self, proposals, round_index):
        trials = [None] * len(proposals)
        by_fidelity = {}
        for i, prop in enumerate(proposals):
            by_fidelity.setdefault(float(prop["fidelity"]),
                                   []).append(i)
        for fidelity in sorted(by_fidelity):
            idxs = by_fidelity[fidelity]
            knob_list = [self.space.materialize(proposals[i]["point"])
                         for i in idxs]
            results = self._run_fidelity(fidelity, knob_list)
            for local, i in enumerate(idxs):
                trials[i] = {"point": dict(proposals[i]["point"]),
                             "fidelity": fidelity,
                             "knobs": knob_list[local],
                             **results[local]}
        return trials


def build_driver(args, space: SearchSpace, constraint: Constraint):
    """The search driver ``args.driver`` names, with its
    hyperparameters from ``args``; the lattice drivers seed from
    :func:`live_lattice`."""
    if args.driver == "random":
        return RandomDriver(space, args.seed)
    if args.driver == "grid":
        return GridDriver(space, args.seed, initial=live_lattice())
    if args.driver == "halving":
        fidelities = [args.screen_fidelity ** (args.rungs - 1 - r)
                      for r in range(args.rungs)]
        return HalvingDriver(space, args.seed,
                             initial=live_lattice(),
                             rungs=args.rungs, eta=args.eta,
                             fidelities=fidelities,
                             constraint=constraint)
    if args.driver == "cmaes":
        pins = {}
        for pin in args.pin or ():
            name, _, index = pin.partition("=")
            pins[name.strip()] = int(index)
        driver = CmaEsDriver(space, args.seed, popsize=args.popsize,
                             sigma0=args.sigma0, pins=pins,
                             constraint=constraint)
        if args.batch < driver.lam:
            raise ValueError(
                f"batch {args.batch} is smaller than the CMA-ES "
                f"population ({driver.lam}): a round must hold a "
                f"whole generation; raise the batch or lower the "
                f"population")
        return driver
    if args.driver == "refine":
        return GridRefineDriver(space, args.seed,
                                initial=live_lattice(),
                                max_per_round=args.batch)
    raise ValueError(f"unknown driver {args.driver!r}")
