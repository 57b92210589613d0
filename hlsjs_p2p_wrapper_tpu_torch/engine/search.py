# A copy of the reference's engine/search.py (hlsjs_p2p_wrapper_tpu/engine/search.py): the
# same names, formats and bytes; only the imports point at the port's own
# modules.
"""Closed-loop policy search plane over the warm-started sweep engine.

The reference wrapper could only ever RUN one P2P policy per browser
tab (PAPER.md §0); the rebuilt engine can MEASURE 144 policies per
dispatch — but a grid only answers "what happens at these points".
The north star's question is the inverse: **which knobs maximize
offload subject to rebuffer ≤ X** (ROADMAP, closed-loop item).  This
module is that loop: seeded, deterministic, resumable black-box
search whose unit of work is exactly the dispatch engine's unit of
work — one proposal batch = one ``stream_groups_chunked`` dispatch
of the misses, with the layer-2 row cache serving every revisited
point bit-identically and the crash-safe journal making a week-long
search SIGKILL-proof for free.

**The protocol** (:class:`SearchDriver`): ``ask(n)`` yields up to
``n`` proposals — a ``point`` in the :class:`SearchSpace` plus a
``fidelity`` (fraction of the full scan horizon; short screens are
cheap dispatches with their own compile group, full runs are the
real thing) — and ``tell(trials)`` feeds evaluated
offload/rebuffer pairs back.  Drivers are deterministic functions
of ``(seed, tells)``: the same seed replays the same proposal
sequence to the bit, which is what makes a resumed search's
frontier identical to an uninterrupted one (``make optimize-gate``
holds the whole chain to that).

**The drivers**:

- :class:`RandomDriver` — batched quasi-random warmup: a
  Cranley-Patterson-rotated Halton sequence over the continuous
  axes (low-discrepancy coverage without the clumping a plain
  uniform draw suffers at small budgets), categorical axes drawn
  from a per-index seeded ``Generator`` so the stream is a pure
  function of ``(seed, index)``.
- :class:`HalvingDriver` — successive halving: the whole cohort
  (a lattice, e.g. the shipped 144-pt live grid, or a quasi-random
  population) is screened at a short fidelity, the top ``1/eta``
  promoted to the next rung, until the survivors run full-length.
  The row cache makes re-screens free; only the promotions cost new
  dispatch.
- :class:`CmaEsDriver` — a compact (μ/μ_w, λ) CMA-ES over the
  smooth knobs (they are all dynamic ``SwarmScenario`` data since
  the live-sync promotion, so a proposal batch is literally one
  stacked-scenario chunk): rank-μ covariance update, cumulative
  step-size control, per-generation RNG derived from
  ``(seed, generation)`` so checkpoints never serialize RNG
  internals.  Categorical axes are pinned (``pins=``).
- :class:`GridRefineDriver` — the ADAPTIVE GRID REFINER: evaluates
  a lattice, joins the constraint verdicts against the knob axes
  exactly like ``triage_timelines.py --grid`` joins pathology
  verdicts (1-D neighbor diffs per axis line), and proposes
  midpoints across every feasibility FLIP EDGE — proposal density
  concentrates around the phase boundaries instead of uniform axes
  — plus the diagonal midpoints of two-knob INTERACTION flips
  (a point that only flips when BOTH knobs move; the AND-shaped
  pathology single-axis diffs cannot see).  The refined-edge map
  rides the artifact.

**Constraint handling** is explicit (:class:`Constraint`):
maximize ``offload`` subject to ``rebuffer <= bound``.  Infeasible
points are KEPT and labeled — never silently dropped — and rank
below every feasible point, ordered by violation (the search can
walk back across the boundary); an all-infeasible search reports
``best=None`` plus the least-violating trial.

**The loop** (:class:`PolicySearch`): every ask/tell round bumps
``search_*`` registry counters (``search_rounds`` /
``search_evals{source=dispatch|cache|failed}`` /
``search_infeasible`` / ``search_checkpoints`` and the
``search_best_offload`` / ``search_budget_spent`` gauges), emits a
flight-recorder ``mark`` per round when armed, and checkpoints the
driver state + trial history through the journal's atomic-write
discipline (:func:`~.artifact_cache.atomic_write_json`, digest-
checked like the sweep journal) — a SIGKILL'd search resumes from
the last completed round, re-asks the in-flight round
deterministically, and the rows it journaled before dying come back
as row-cache hits with zero recompute.

Budget is counted in FULL-RUN EQUIVALENTS of *proposed* work
(``fidelity`` summed over proposals, cache hits included): the
spend is a pure function of the proposal sequence, so a warm rerun
walks the identical schedule — provenance (row-cache hits vs fresh
dispatches) is recorded separately per round.

SNIPPETS.md's optimizer-state partition-spec exemplar is the
pattern for sharding this state alongside the ``scenarios`` mesh
axis when a search someday spans hosts; today the state is one
checkpoint file and the fabric shards the EVALUATIONS instead.

``tools/optimize.py`` is the CLI; ``tools/optimize_gate.py`` /
``make optimize-gate`` is the acceptance bar.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from .artifact_cache import _digest, atomic_write_json
from .telemetry import MetricsRegistry
# the ONE grid-join implementation, shared verbatim with
# tools/triage_timelines.py --grid (core/gridjoin.py): the refiner
# joins CONSTRAINT verdicts through exactly the code the triage tool
# joins PATHOLOGY verdicts through — re-exported here because the
# refiner's tests and consumers reach them via this module
from ..core.gridjoin import grid_flips, grid_interactions  # noqa: F401

#: first primes — Halton bases for up to this many continuous axes
_HALTON_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29)


class ContinuousAxis(NamedTuple):
    """One smooth knob: searched over ``[lo, hi]`` (inclusive)."""

    name: str
    lo: float
    hi: float

    def denorm(self, u: float) -> float:
        return self.lo + (self.hi - self.lo) * min(max(u, 0.0), 1.0)

    def norm(self, v: float) -> float:
        if self.hi == self.lo:
            return 0.0
        return min(max((v - self.lo) / (self.hi - self.lo), 0.0), 1.0)


class CategoricalAxis(NamedTuple):
    """One discrete knob: ``values`` may be scalars (stored into the
    knob dict under ``name``) or dicts (merged into the knob dict —
    e.g. a coupled ``{"uplink_mbps": …, "cdn_mbps": …}`` supply
    pair).  A point stores the INDEX, so checkpoints stay JSON."""

    name: str
    values: tuple


class SearchSpace:
    """The knob space a driver proposes in: continuous + categorical
    axes plus ``fixed`` knobs every point shares (the compile-group
    statics, e.g. ``degree``).  A POINT is a plain dict
    ``{axis name: float | categorical index}`` — JSON-able, so
    driver state checkpoints verbatim."""

    def __init__(self, continuous: Sequence[ContinuousAxis] = (),
                 categorical: Sequence[CategoricalAxis] = (),
                 fixed: Optional[dict] = None):
        self.continuous = tuple(continuous)
        self.categorical = tuple(categorical)
        self.fixed = dict(fixed or {})
        names = [a.name for a in self.continuous] + \
            [a.name for a in self.categorical]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate axis names in {names}")

    @property
    def axis_names(self) -> List[str]:
        return [a.name for a in self.continuous] + \
            [a.name for a in self.categorical]

    def materialize(self, point: dict) -> dict:
        """The full knob dict one point evaluates as: fixed knobs,
        continuous values, categorical picks resolved (dict-valued
        picks merge)."""
        knobs = dict(self.fixed)
        for axis in self.continuous:
            knobs[axis.name] = float(point[axis.name])
        for axis in self.categorical:
            value = axis.values[int(point[axis.name])]
            if isinstance(value, dict):
                knobs.update(value)
            else:
                knobs[axis.name] = value
        return knobs

    def to_unit(self, point: dict) -> np.ndarray:
        return np.array([axis.norm(float(point[axis.name]))
                         for axis in self.continuous])

    def from_unit(self, unit, cats: Optional[dict] = None) -> dict:
        point = {axis.name: axis.denorm(float(u))
                 for axis, u in zip(self.continuous, unit)}
        for axis in self.categorical:
            point[axis.name] = int((cats or {}).get(axis.name, 0))
        return point

    def point_key(self, point: dict) -> str:
        """Stable dedup key for one point (refiner bookkeeping)."""
        return repr(sorted((k, round(float(v), 9)
                            if isinstance(v, float) else v)
                           for k, v in point.items()))


class Constraint(NamedTuple):
    """Explicit constraint: maximize ``objective`` subject to
    ``metric <= bound``.  Infeasible trials are kept and labeled,
    never dropped."""

    metric: str = "rebuffer"
    bound: float = 0.02
    objective: str = "offload"

    @classmethod
    def parse(cls, text: str) -> "Constraint":
        """``"rebuffer<=0.02"`` → Constraint("rebuffer", 0.02)."""
        if "<=" not in text:
            raise ValueError(f"bad constraint {text!r} "
                             f"(want metric<=bound)")
        metric, bound = text.split("<=", 1)
        return cls(metric.strip(), float(bound))

    def feasible(self, trial: dict) -> bool:
        value = trial.get(self.metric)
        return value is not None and value <= self.bound

    def violation(self, trial: dict) -> float:
        value = trial.get(self.metric)
        if value is None:
            return math.inf
        return max(0.0, value - self.bound)


def rank_key(trial: dict, constraint: Constraint) -> tuple:
    """Constraint-aware TOTAL ORDER, best first: feasible trials by
    objective descending (ties → lower constrained metric), then
    infeasible by violation ascending (closest to the boundary
    first), failed rows last.  Callers break remaining ties with
    evaluation order (stable sorts), so "tie on objective" has ONE
    deterministic winner."""
    if trial.get("failed"):
        return (2, 0.0, 0.0)
    obj = trial.get(constraint.objective) or 0.0
    if constraint.feasible(trial):
        return (0, -obj, trial.get(constraint.metric) or 0.0)
    return (1, constraint.violation(trial), -obj)


def best_trial(trials: Sequence[dict],
               constraint: Constraint) -> Optional[dict]:
    """The best FEASIBLE full-fidelity trial, or None when the whole
    history is infeasible (the caller reports the least-violating
    trial separately — kept, labeled, never dropped)."""
    feasible = [t for t in trials
                if not t.get("failed") and t.get("fidelity", 1.0) >= 1.0
                and constraint.feasible(t)]
    if not feasible:
        return None
    return min(feasible, key=lambda t: rank_key(t, constraint))


def pareto_front(trials: Sequence[dict],
                 constraint: Constraint) -> List[dict]:
    """The offload/rebuffer Pareto set over full-fidelity trials
    (maximize objective, minimize constrained metric), feasible or
    not — the artifact's frontier table keeps the infeasible side
    labeled so the tradeoff curve is visible across the bound."""
    # a trial missing either coordinate has no position on the
    # objective/metric plane — it stays in the trial history (labeled
    # infeasible, violation inf) but cannot join the dominance test
    done = [t for t in trials if not t.get("failed")
            and t.get("fidelity", 1.0) >= 1.0
            and t.get(constraint.objective) is not None
            and t.get(constraint.metric) is not None]
    front = []
    for t in done:
        dominated = any(
            o.get(constraint.objective) >= t.get(constraint.objective)
            and o.get(constraint.metric) <= t.get(constraint.metric)
            and (o.get(constraint.objective) >
                 t.get(constraint.objective)
                 or o.get(constraint.metric) < t.get(constraint.metric))
            for o in done)
        if not dominated:
            front.append(t)
    front.sort(key=lambda t: -(t.get(constraint.objective) or 0.0))
    return front


def scrub_provenance(obj):
    """Recursively drop the ``cached`` provenance flag from an
    artifact/trial tree so comparisons are over VALUES: a row served
    from the cache is bit-identical to the dispatch it replaced, but
    its provenance legitimately differs across a warm rerun or a
    resume.  The gate and the process tests share this one
    definition of "bit-identical modulo provenance"."""
    if isinstance(obj, dict):
        return {k: scrub_provenance(v) for k, v in obj.items()
                if k != "cached"}
    if isinstance(obj, list):
        return [scrub_provenance(v) for v in obj]
    return obj


# -- drivers ------------------------------------------------------------

class SearchDriver:
    """The ask/tell protocol.  Drivers are deterministic in
    ``(seed, tells)`` and their whole mutable state round-trips
    through :meth:`state` / :meth:`load_state` as JSON — the
    checkpoint/resume contract."""

    name = "driver"

    def ask(self, n: int) -> List[dict]:
        """Up to ``n`` proposals: ``{"point": …, "fidelity": f}``.
        May return fewer (a cohort tail); an empty list with
        ``done`` False means "waiting on tells"."""
        raise NotImplementedError

    def tell(self, trials: Sequence[dict]) -> None:
        """Evaluated trials for previously-asked proposals, in ask
        order (each carries its ``point`` / ``fidelity`` back plus
        the metric fields)."""
        raise NotImplementedError

    @property
    def done(self) -> bool:
        return False

    def state(self) -> dict:
        raise NotImplementedError

    def load_state(self, state: dict) -> None:
        raise NotImplementedError

    def report(self) -> dict:
        """Driver-specific artifact payload (e.g. the refiner's
        edge map); default empty."""
        return {}


def _halton(index: int, base: int) -> float:
    """The ``index``-th element of the base-``base`` van der Corput
    sequence (1-indexed internally so index 0 is not 0.0)."""
    result, f, i = 0.0, 1.0, index + 1
    while i > 0:
        f /= base
        result += f * (i % base)
        i //= base
    return result


class RandomDriver(SearchDriver):
    """Quasi-random warmup: rotated Halton over the continuous axes,
    per-index seeded categorical picks.  The stream is a pure
    function of ``(seed, index)`` — state is one integer."""

    name = "random"

    def __init__(self, space: SearchSpace, seed: int = 0, *,
                 fidelity: float = 1.0):
        if len(space.continuous) > len(_HALTON_BASES):
            raise ValueError("too many continuous axes for the "
                             "Halton table")
        self.space = space
        self.seed = int(seed)
        self.fidelity = float(fidelity)
        self._index = 0
        rng = np.random.default_rng([self.seed, 0xC0FFEE])
        self._shift = rng.random(len(space.continuous))

    def ask(self, n: int) -> List[dict]:
        out = []
        for _ in range(max(n, 0)):
            unit = [( _halton(self._index, base) + shift) % 1.0
                    for base, shift in zip(_HALTON_BASES, self._shift)]
            cats = {}
            if self.space.categorical:
                crng = np.random.default_rng([self.seed, self._index])
                for axis in self.space.categorical:
                    cats[axis.name] = int(
                        crng.integers(len(axis.values)))
            out.append({"point": self.space.from_unit(unit, cats),
                        "fidelity": self.fidelity})
            self._index += 1
        return out

    def tell(self, trials) -> None:
        pass  # memoryless: the sequence does not adapt

    def state(self) -> dict:
        return {"driver": self.name, "index": self._index}

    def load_state(self, state: dict) -> None:
        self._index = int(state["index"])


class HalvingDriver(SearchDriver):
    """Successive halving over a cohort: screen everyone at the
    lowest rung's fidelity, promote the constraint-aware top
    ``1/eta`` one rung up, repeat until the survivors run at
    fidelity 1.0.  ``initial`` seeds the cohort with explicit points
    (e.g. the shipped live-grid lattice); otherwise ``n0``
    quasi-random points.  Promotion is deterministic: stable sort by
    :func:`rank_key` then ask order."""

    name = "halving"

    def __init__(self, space: SearchSpace, seed: int = 0, *,
                 initial: Optional[Sequence[dict]] = None,
                 n0: int = 64, rungs: int = 3, eta: float = 4.0,
                 fidelities: Optional[Sequence[float]] = None,
                 constraint: Constraint = Constraint()):
        if rungs < 1:
            raise ValueError("rungs must be >= 1")
        self.space = space
        self.seed = int(seed)
        self.eta = float(eta)
        self.constraint = constraint
        if fidelities is not None:
            self.fidelities = [float(f) for f in fidelities]
            if self.fidelities[-1] < 1.0:
                raise ValueError("the last rung must run full "
                                 "fidelity (1.0)")
        else:
            self.fidelities = [eta ** -(rungs - 1 - r)
                               for r in range(rungs)]
        if initial is not None:
            cohort = [dict(p) for p in initial]
        else:
            cohort = [p["point"] for p in
                      RandomDriver(space, seed).ask(n0)]
        self._rung = 0
        self._cohort = cohort
        self._asked = 0
        self._pending: List[dict] = []

    @property
    def fidelity(self) -> float:
        return self.fidelities[self._rung]

    def ask(self, n: int) -> List[dict]:
        if self.done:
            return []
        take = self._cohort[self._asked:self._asked + max(n, 0)]
        self._asked += len(take)
        return [{"point": dict(p), "fidelity": self.fidelity}
                for p in take]

    def tell(self, trials) -> None:
        self._pending.extend(trials)
        if len(self._pending) < len(self._cohort):
            return
        # rung complete: promote the constraint-aware top 1/eta
        # (at least one survivor; the FINAL rung just finishes)
        if self._rung + 1 >= len(self.fidelities):
            self._rung += 1  # done
            return
        keep = max(1, int(math.ceil(len(self._cohort) / self.eta)))
        order = sorted(range(len(self._pending)),
                       key=lambda i: (rank_key(self._pending[i],
                                               self.constraint), i))
        survivors = [dict(self._pending[i]["point"])
                     for i in order[:keep]]
        self._rung += 1
        self._cohort = survivors
        self._asked = 0
        self._pending = []

    @property
    def done(self) -> bool:
        return self._rung >= len(self.fidelities)

    def state(self) -> dict:
        return {"driver": self.name, "rung": self._rung,
                "cohort": self._cohort, "asked": self._asked,
                "pending": self._pending,
                "fidelities": self.fidelities}

    def load_state(self, state: dict) -> None:
        self._rung = int(state["rung"])
        self._cohort = [dict(p) for p in state["cohort"]]
        self._asked = int(state["asked"])
        self._pending = [dict(t) for t in state["pending"]]
        self.fidelities = [float(f) for f in state["fidelities"]]


class CmaEsDriver(SearchDriver):
    """Compact (μ/μ_w, λ) CMA-ES in the unit cube of the continuous
    axes — rank-μ covariance update, cumulative step-size control
    (Hansen's defaults).  Each generation's draw comes from
    ``default_rng([seed, generation])``, so the state checkpoint is
    plain arrays, no RNG internals.  Categorical axes ride along
    PINNED (``pins={name: index}``): CMA's Gaussian model has no
    notion of an unordered axis — sweep those with the halving or
    refiner drivers instead."""

    name = "cmaes"

    def __init__(self, space: SearchSpace, seed: int = 0, *,
                 popsize: Optional[int] = None, sigma0: float = 0.3,
                 generations: int = 1_000_000,
                 pins: Optional[dict] = None,
                 constraint: Constraint = Constraint()):
        n = len(space.continuous)
        self.constraint = constraint
        if n < 2:
            raise ValueError("CMA-ES needs >= 2 continuous axes")
        self.space = space
        self.seed = int(seed)
        self.n = n
        self.lam = popsize or (4 + int(3 * math.log(n)))
        self.generations = generations
        self.pins = {a.name: int((pins or {}).get(a.name, 0))
                     for a in space.categorical}
        mu = self.lam // 2
        w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
        self.w = w / w.sum()
        self.mueff = float(1.0 / np.sum(self.w ** 2))
        self.cc = (4 + self.mueff / n) / (n + 4 + 2 * self.mueff / n)
        self.cs = (self.mueff + 2) / (n + self.mueff + 5)
        self.c1 = 2 / ((n + 1.3) ** 2 + self.mueff)
        self.cmu = min(1 - self.c1,
                       2 * (self.mueff - 2 + 1 / self.mueff)
                       / ((n + 2) ** 2 + self.mueff))
        self.damps = (1 + 2 * max(0.0, math.sqrt(
            (self.mueff - 1) / (n + 1)) - 1) + self.cs)
        self.chi_n = math.sqrt(n) * (1 - 1 / (4 * n)
                                     + 1 / (21 * n * n))
        self.mean = np.full(n, 0.5)
        self.sigma = float(sigma0)
        self.C = np.eye(n)
        self.pc = np.zeros(n)
        self.ps = np.zeros(n)
        self.gen = 0
        self._asked: List[np.ndarray] = []  # this generation's z draws

    def ask(self, n: int) -> List[dict]:
        if self.done or self._asked:
            return []  # one full generation in flight at a time
        if n < self.lam:
            raise ValueError(
                f"CMA-ES proposes whole generations: ask(n) needs "
                f"n >= popsize ({self.lam}), got {n} — raise the "
                f"batch or lower popsize")
        rng = np.random.default_rng([self.seed, self.gen])
        evals, evecs = np.linalg.eigh(self.C)
        scale = evecs @ np.diag(np.sqrt(np.maximum(evals, 1e-20)))
        out = []
        for _ in range(self.lam):
            z = rng.standard_normal(self.n)
            x = np.clip(self.mean + self.sigma * (scale @ z), 0.0, 1.0)
            self._asked.append(x)
            out.append({"point": self.space.from_unit(x, self.pins),
                        "fidelity": 1.0})
        return out

    def tell(self, trials) -> None:
        if len(trials) < len(self._asked):
            # budget truncation abandoned the generation: DROP it
            # without an update (a partial generation cannot update
            # the covariance deterministically) so the driver is not
            # frozen — the next ask redraws the SAME generation
            # (rng is (seed, gen)-derived), whose already-evaluated
            # points come back as row-cache hits
            self._asked = []
            return
        order = sorted(range(len(trials)),
                       key=lambda i: (rank_key(trials[i],
                                               self.constraint), i))
        mu = len(self.w)
        xs = np.stack([self._asked[i] for i in order[:mu]])
        old_mean = self.mean
        self.mean = self.w @ xs
        y = (self.mean - old_mean) / self.sigma
        evals, evecs = np.linalg.eigh(self.C)
        inv_sqrt = evecs @ np.diag(
            1.0 / np.sqrt(np.maximum(evals, 1e-20))) @ evecs.T
        self.ps = ((1 - self.cs) * self.ps
                   + math.sqrt(self.cs * (2 - self.cs) * self.mueff)
                   * (inv_sqrt @ y))
        hsig = (np.linalg.norm(self.ps)
                / math.sqrt(1 - (1 - self.cs)
                            ** (2 * (self.gen + 1)))
                < (1.4 + 2 / (self.n + 1)) * self.chi_n)
        self.pc = ((1 - self.cc) * self.pc
                   + (math.sqrt(self.cc * (2 - self.cc) * self.mueff)
                      * y if hsig else 0.0))
        artmp = (xs - old_mean) / self.sigma
        self.C = ((1 - self.c1 - self.cmu) * self.C
                  + self.c1 * (np.outer(self.pc, self.pc)
                               + (0.0 if hsig else
                                  self.cc * (2 - self.cc)) * self.C)
                  + self.cmu * (artmp.T * self.w) @ artmp)
        self.C = (self.C + self.C.T) / 2.0
        self.sigma *= math.exp(
            (self.cs / self.damps)
            * (np.linalg.norm(self.ps) / self.chi_n - 1))
        self.gen += 1
        self._asked = []

    @property
    def done(self) -> bool:
        return self.gen >= self.generations

    def state(self) -> dict:
        return {"driver": self.name, "gen": self.gen,
                "mean": self.mean.tolist(), "sigma": self.sigma,
                "C": self.C.tolist(), "pc": self.pc.tolist(),
                "ps": self.ps.tolist(),
                "asked": [x.tolist() for x in self._asked]}

    def load_state(self, state: dict) -> None:
        self.gen = int(state["gen"])
        self.mean = np.array(state["mean"])
        self.sigma = float(state["sigma"])
        self.C = np.array(state["C"])
        self.pc = np.array(state["pc"])
        self.ps = np.array(state["ps"])
        self._asked = [np.array(x) for x in state["asked"]]


class GridRefineDriver(SearchDriver):
    """The adaptive grid refiner: evaluate ``initial`` (a lattice),
    flag each point by the constraint verdict, and propose midpoints
    across every 1-D feasibility flip edge on the continuous axes —
    proposal density follows the flip count per axis, so the budget
    concentrates where the phase boundary actually is — plus the
    diagonal midpoint of every two-knob interaction flip
    (:func:`grid_interactions`).  Each tell re-joins ALL evaluated
    points (refined values thicken the lines), so edges bisect
    progressively; ``done`` when a join proposes nothing new.
    :meth:`report` carries the refined-edge map + interactions into
    the artifact."""

    name = "refine"

    def __init__(self, space: SearchSpace, seed: int = 0, *,
                 initial: Sequence[dict] = (),
                 max_per_round: int = 16):
        self.space = space
        self.seed = int(seed)
        self.max_per_round = int(max_per_round)
        self._phase = "warmup"
        self._initial = [dict(p) for p in initial]
        self._asked = 0
        self._trials: List[dict] = []
        self._pending = 0
        self._seen = {space.point_key(p) for p in self._initial}
        self._queue: List[dict] = []
        self._edges: Dict[str, list] = {}
        self._interactions: List[dict] = []
        self._rounds = 0

    def _continuous_names(self):
        return {a.name for a in self.space.continuous}

    def _refine(self) -> List[dict]:
        """One join over everything evaluated so far → fresh midpoint
        proposals, most-flipping axis first."""
        points = [t["point"] for t in self._trials]
        flagged = {i for i, t in enumerate(self._trials)
                   if t.get("failed") or not t.get("feasible")}
        axes = self.space.axis_names
        flips = grid_flips(points, axes, flagged)
        interactions = grid_interactions(points, axes, flagged)
        per_axis: Dict[str, list] = {}
        for flip in flips:
            per_axis.setdefault(flip["axis"], []).append(flip)
        cont = self._continuous_names()
        proposals = []
        # the edge map and interaction list ACCUMULATE across joins
        # (deduped): later joins run over lines the midpoints made
        # non-uniform, so each join's view narrows — the report is
        # everything the refiner ever located, tightest edges last
        for axis, axis_flips in sorted(per_axis.items(),
                                       key=lambda kv: -len(kv[1])):
            if axis not in cont:
                continue  # categorical edges cannot bisect
            edges = self._edges.setdefault(axis, [])
            known = {(e["lo"], e["hi"]) for e in edges}
            for flip in axis_flips:
                lo = min(flip["healthy_value"], flip["flagged_value"])
                hi = max(flip["healthy_value"], flip["flagged_value"])
                mid = (lo + hi) / 2.0
                if (lo, hi) not in known:
                    known.add((lo, hi))
                    edges.append({"lo": lo, "hi": hi, "mid": mid,
                                  "healthy_point":
                                      flip["healthy_point"],
                                  "flagged_point":
                                      flip["flagged_point"]})
                base = dict(points[flip["flagged_point"]])
                base[axis] = mid
                proposals.append(base)
        known_inter = {(tuple(i["axes"]), repr(i["flagged_values"]))
                       for i in self._interactions}
        for inter in interactions:
            key = (tuple(inter["axes"]), repr(inter["flagged_values"]))
            if key not in known_inter:
                known_inter.add(key)
                self._interactions.append(inter)
            a, b = inter["axes"]
            if a not in cont or b not in cont:
                continue
            base = dict(self._trials[inter["flagged_point"]]["point"])
            other = self._trials[inter["base_point"]]["point"]
            base[a] = (float(base[a]) + float(other[a])) / 2.0
            base[b] = (float(base[b]) + float(other[b])) / 2.0
            proposals.append(base)
        fresh = []
        for p in proposals:
            key = self.space.point_key(p)
            if key not in self._seen:
                self._seen.add(key)
                fresh.append(p)
        return fresh

    def ask(self, n: int) -> List[dict]:
        if self._phase == "warmup":
            take = self._initial[self._asked:self._asked + max(n, 0)]
            self._asked += len(take)
            self._pending += len(take)
            return [{"point": dict(p), "fidelity": 1.0} for p in take]
        take = self._queue[:min(max(n, 0), self.max_per_round)]
        self._queue = self._queue[len(take):]
        self._pending += len(take)
        return [{"point": dict(p), "fidelity": 1.0} for p in take]

    def tell(self, trials) -> None:
        self._trials.extend(dict(t) for t in trials)
        self._pending -= len(trials)
        if self._pending > 0:
            return
        if self._phase == "warmup" and self._asked < len(self._initial):
            return
        self._phase = "refine"
        if not self._queue:
            self._queue = self._refine()
            self._rounds += 1

    @property
    def done(self) -> bool:
        # after at least one refine join, an empty queue with nothing
        # in flight means the last join proposed nothing new — every
        # flip edge bisected below point_key resolution
        return (self._phase == "refine" and not self._queue
                and self._pending <= 0 and self._rounds > 0)

    def state(self) -> dict:
        return {"driver": self.name, "phase": self._phase,
                "asked": self._asked, "pending": self._pending,
                "trials": self._trials, "queue": self._queue,
                "seen": sorted(self._seen), "edges": self._edges,
                "interactions": self._interactions,
                "rounds": self._rounds}

    def load_state(self, state: dict) -> None:
        self._phase = state["phase"]
        self._asked = int(state["asked"])
        self._pending = int(state["pending"])
        self._trials = [dict(t) for t in state["trials"]]
        self._queue = [dict(p) for p in state["queue"]]
        self._seen = set(state["seen"])
        self._edges = {k: list(v)
                       for k, v in state["edges"].items()}
        self._interactions = [dict(i)
                              for i in state["interactions"]]
        self._rounds = int(state["rounds"])

    def report(self) -> dict:
        return {"refined_edges": self._edges,
                "interactions": self._interactions,
                "refine_rounds": self._rounds}


class GridDriver(SearchDriver):
    """Exhaustive evaluation of an explicit lattice at full fidelity
    — the uniform-grid BASELINE the gate measures the budgeted
    drivers against (and a convenient way to run the shipped grids
    through the search plane's constraint/frontier reporting)."""

    name = "grid"

    def __init__(self, space: SearchSpace, seed: int = 0, *,
                 initial: Sequence[dict] = ()):
        self.space = space
        self._points = [dict(p) for p in initial]
        self._asked = 0
        self._told = 0

    def ask(self, n: int) -> List[dict]:
        take = self._points[self._asked:self._asked + max(n, 0)]
        self._asked += len(take)
        return [{"point": dict(p), "fidelity": 1.0} for p in take]

    def tell(self, trials) -> None:
        self._told += len(trials)

    @property
    def done(self) -> bool:
        return self._told >= len(self._points)

    def state(self) -> dict:
        return {"driver": self.name, "asked": self._asked,
                "told": self._told}

    def load_state(self, state: dict) -> None:
        self._asked = int(state["asked"])
        self._told = int(state["told"])


# -- the closed loop ----------------------------------------------------

def search_checkpoint_path(cache_dir: str, meta: dict) -> str:
    """Checkpoint location for one search identity: co-located with
    the journals under the warm-start root, content-addressed by the
    search meta — two different searches can never clobber each
    other's state (the journal_path convention)."""
    digest = _digest({"kind": "policy-search", **meta})
    return os.path.join(cache_dir, "searches", digest + ".json")


class PolicySearch:
    """The closed loop: ``ask → evaluate (one chunked dispatch of
    the misses) → tell``, with explicit constraint handling, budget
    in full-run equivalents of PROPOSED work, ``search_*`` registry
    counters + flight-recorder marks per round, and an atomic
    digest-checked checkpoint after every round (module docstring).

    ``evaluate(proposals, round_index)`` is injected by the tool
    (tools/optimize.py builds it on ``stream_groups_chunked`` +
    ``WarmStart`` + ``SweepJournal``) and must return one trial dict
    per proposal, in order, carrying ``point`` / ``fidelity`` /
    ``knobs`` / the metric fields / ``cached`` / ``failed``."""

    def __init__(self, driver: SearchDriver, evaluate,
                 constraint: Constraint, *, budget: float,
                 batch: int = 16,
                 registry: Optional[MetricsRegistry] = None,
                 trace=None, checkpoint_path: Optional[str] = None,
                 checkpoint_meta: Optional[dict] = None):
        self.driver = driver
        self.evaluate = evaluate
        self.constraint = constraint
        self.budget = float(budget)
        self.batch = int(batch)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.trace = trace
        self.checkpoint_path = checkpoint_path
        self.digest = _digest({"kind": "policy-search",
                               **(checkpoint_meta or {})})
        self.spent = 0.0
        self.round = 0
        self.truncated = False
        self.trials: List[dict] = []
        self.rounds: List[dict] = []

    # -- persistence ----------------------------------------------------

    def checkpoint(self) -> None:
        if self.checkpoint_path is None:
            return
        atomic_write_json(self.checkpoint_path, {
            "kind": "policy-search", "digest": self.digest,
            "round": self.round, "spent": self.spent,
            "driver": self.driver.state(),
            "trials": self.trials, "rounds": self.rounds})
        self.registry.counter("search_checkpoints").inc()

    def resume(self) -> bool:
        """Load the checkpoint if one exists (digest-checked like
        the sweep journal); returns whether anything was restored."""
        if (self.checkpoint_path is None
                or not os.path.exists(self.checkpoint_path)):
            return False
        with open(self.checkpoint_path, encoding="utf-8") as fh:
            state = json.load(fh)
        if state.get("digest") != self.digest:
            raise ValueError(
                f"search checkpoint {self.checkpoint_path} was "
                f"written by a different search configuration — "
                f"not resuming against it")
        self.round = int(state["round"])
        self.spent = float(state["spent"])
        self.trials = [dict(t) for t in state["trials"]]
        self.rounds = [dict(r) for r in state["rounds"]]
        self.driver.load_state(state["driver"])
        return True

    # -- the loop -------------------------------------------------------

    def _trim_to_budget(self, proposals: List[dict]) -> List[dict]:
        """The largest prefix whose summed fidelity fits the
        remaining budget — spend is a function of the PROPOSAL
        sequence alone, so warm reruns walk the identical
        schedule."""
        out = []
        spent = self.spent
        for prop in proposals:
            cost = float(prop["fidelity"])
            if out and spent + cost > self.budget + 1e-9:
                break
            out.append(prop)
            spent += cost
        return out

    def run(self) -> dict:
        """Drive ask/tell rounds until the driver finishes or the
        budget is spent; returns :meth:`result`."""
        while not self.driver.done and self.spent < self.budget - 1e-9:
            asked = self.driver.ask(self.batch)
            if not asked:
                break
            proposals = self._trim_to_budget(asked)
            # a trimmed ask means the budget cannot cover what the
            # driver needs next (a rung mid-cohort, a generation):
            # evaluate the affordable prefix, then STOP — the driver
            # was asked for work the loop can never tell it about,
            # so continuing would leave it silently mid-cohort.  The
            # truncation is labeled on the round and the result, not
            # swallowed
            truncated = len(proposals) < len(asked)
            trials = self.evaluate(proposals, self.round)
            if len(trials) != len(proposals):
                raise ValueError(
                    f"evaluator returned {len(trials)} trials for "
                    f"{len(proposals)} proposals — every proposal "
                    f"must come back (failed rows included)")
            cost = sum(float(p["fidelity"]) for p in proposals)
            fresh = cached = failed = infeasible = 0
            for trial in trials:
                trial["round"] = self.round
                trial["feasible"] = (not trial.get("failed")
                                     and self.constraint.feasible(
                                         trial))
                if trial.get("failed"):
                    failed += 1
                elif trial.get("cached"):
                    cached += 1
                else:
                    fresh += 1
                if not trial["feasible"] and not trial.get("failed"):
                    infeasible += 1
            self.driver.tell(trials)
            self.trials.extend(trials)
            self.spent += cost
            best = best_trial(self.trials, self.constraint)
            self.rounds.append({
                "round": self.round, "driver": self.driver.name,
                "proposals": len(proposals), "cost": round(cost, 6),
                "fresh_dispatches": fresh, "row_cache_hits": cached,
                "failed": failed, "infeasible": infeasible,
                "budget_truncated": truncated,
                "spent": round(self.spent, 6),
                "best_offload": (best.get(self.constraint.objective)
                                 if best else None)})
            reg = self.registry
            reg.counter("search_rounds",
                        driver=self.driver.name).inc()
            reg.counter("search_evals", source="dispatch").inc(fresh)
            reg.counter("search_evals", source="cache").inc(cached)
            reg.counter("search_evals", source="failed").inc(failed)
            reg.counter("search_infeasible").inc(infeasible)
            reg.gauge("search_budget_spent").set(self.spent)
            if best is not None:
                reg.gauge("search_best_offload").set(
                    best[self.constraint.objective])
            if self.trace is not None:
                self.trace.mark(
                    "search_round", round=self.round,
                    driver=self.driver.name,
                    proposals=len(proposals), fresh=fresh,
                    cached=cached, failed=failed,
                    spent=round(self.spent, 6),
                    best_offload=(best.get(self.constraint.objective)
                                  if best else None))
                self.trace.flush()
            self.round += 1
            self.checkpoint()
            if truncated:
                self.truncated = True
                break
        return self.result()

    # -- reporting ------------------------------------------------------

    def frontier(self) -> dict:
        """The discovered frontier: the best feasible trial (None
        when everything violates the bound — then
        ``least_violating`` carries the closest trial, labeled), the
        offload/rebuffer Pareto set, and the feasibility census."""
        best = best_trial(self.trials, self.constraint)
        done = [t for t in self.trials if not t.get("failed")
                and t.get("fidelity", 1.0) >= 1.0]
        least = None
        if best is None and done:
            least = min(done, key=lambda t:
                        (self.constraint.violation(t),
                         -(t.get(self.constraint.objective) or 0.0)))
        return {
            "constraint": {"metric": self.constraint.metric,
                           "bound": self.constraint.bound,
                           "objective": self.constraint.objective},
            "best": best,
            "least_violating": least,
            "pareto": pareto_front(self.trials, self.constraint),
            "feasible": sum(1 for t in self.trials
                            if t.get("feasible")),
            "infeasible": sum(1 for t in self.trials
                              if not t.get("feasible")
                              and not t.get("failed")),
            "failed": sum(1 for t in self.trials if t.get("failed")),
        }

    def result(self) -> dict:
        return {"driver": self.driver.name,
                "budget": self.budget,
                "spent": round(self.spent, 6),
                # True when the budget cut a cohort/generation short
                # and the search stopped mid-schedule — the frontier
                # below covers only what was affordable
                "truncated": self.truncated,
                "rounds": self.rounds,
                "trials": self.trials,
                "frontier": self.frontier(),
                **self.driver.report()}
