"""Heterogeneous-population scenario plane, copied from the reference's
``engine/population.py`` (NumPy only; the port imports nothing of the
reference).

A :class:`PopulationSpec` names COHORTS of the audience, each with
parametric per-peer attribute distributions (uplink and CDN rates), a
connectivity class, a device ladder cap, an urgency offset and temporal
arrival and departure processes, and MATERIALIZES deterministically
(same seed, same arrays, any process) into the per-peer vectors of
:class:`Population`.  :func:`to_scenario_kwargs` turns them into keyword
arguments of the port's ``ops/swarm_sim.py`` ``make_scenario``: per-peer
uplink and CDN rates, join and leave schedules, and the four population
fields of ``SwarmScenario`` (``p2p_ok``, the connectivity mask that
gates both sides of P2P eligibility; ``abr_cap_level``, the device
ladder cap; ``urgent_margin_off_s``, the per-cohort urgency offset;
``cohort_id``, the labels that the timeline's per-cohort columns slice
by).  All of them are scenario data, so a whole mixture grid is one
dispatch group, and a degenerate single-cohort population that inherits
everything is bit-identical to the homogeneous path.
``sweep_grid.build_scenario(population=)`` is the sweep's overlay.

A TRACE-DRIVEN variant (:func:`materialize_trace`) replays recorded
join/leave/rate records into the same :class:`Population` arrays.
:func:`fault_specs_from` renders the spec's regional-partition windows
in the reference's ``NetFaultPlan`` grammar, for its real-protocol
plane; the simulator does not model them.

Determinism contract: materialization draws ONLY from
explicitly-seeded ``np.random.default_rng([seed, cohort_index])``
streams, cohort assignment is a seed-free low-discrepancy interleave,
and :func:`population_digest` hashes the materialized arrays.  The
per-cohort draw ORDER (uplink, cdn, join, session) is part of the
contract: the port's arrays and digest equal the reference's to the
byte for the same spec and seed (``tests/test_torch_population.py``).
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass, field, fields
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

#: mirror of ops/swarm_sim.NEVER_S, kept here so that this host module
#: imports no torch (pinned equal by the tests)
NEVER_S = 1e18

#: connectivity classes and the P2P-eligibility each grants.  "open"
#: peers serve and fetch P2P; "cdn_only" models the
#: symmetric-NAT/enterprise-firewall class that can never establish a
#: peer link — it neither serves nor fetches P2P and rides the CDN
#: for everything (the kernel gates BOTH eligibility sides on the
#: materialized ``p2p_ok`` mask).
CONNECTIVITY_CLASSES = {"open": 1.0, "cdn_only": 0.0}

#: ``abr_cap`` value meaning "uncapped" in a cohort spec (resolved to
#: the ladder top at materialization time)
UNCAPPED = -1


@dataclass(frozen=True)
class Dist:
    """One parametric scalar distribution with DECLARED bounds.

    Kinds: ``const`` (value), ``uniform`` (lo..hi), ``lognormal``
    (median + sigma in log-space, clipped to lo..hi — the shape
    measured access networks actually have), ``choice`` (values +
    optional weights).  ``bounds()`` is the property-test surface:
    every sample must land inside it, every seed."""

    kind: str = "const"
    value: float = 0.0
    lo: float = 0.0
    hi: float = 0.0
    median: float = 0.0
    sigma: float = 0.5
    values: Tuple[float, ...] = ()
    weights: Tuple[float, ...] = ()

    def __post_init__(self):
        if self.kind not in ("const", "uniform", "lognormal",
                             "choice"):
            raise ValueError(f"unknown distribution kind "
                             f"{self.kind!r}")
        if self.kind == "uniform" and self.hi < self.lo:
            raise ValueError(f"uniform hi {self.hi} < lo {self.lo}")
        if self.kind == "lognormal":
            if self.median <= 0.0:
                raise ValueError("lognormal needs median > 0")
            if self.hi < self.lo:
                raise ValueError(f"lognormal hi {self.hi} < lo "
                                 f"{self.lo}")
        if self.kind == "choice" and not self.values:
            raise ValueError("choice needs at least one value")
        if (self.kind == "choice" and self.weights
                and len(self.weights) != len(self.values)):
            raise ValueError("choice weights length != values length")

    def bounds(self) -> Tuple[float, float]:
        if self.kind == "const":
            return self.value, self.value
        if self.kind == "choice":
            return min(self.values), max(self.values)
        return self.lo, self.hi

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "const":
            return np.full(n, self.value, np.float64)
        if self.kind == "uniform":
            return rng.uniform(self.lo, self.hi, n)
        if self.kind == "choice":
            w = None
            if self.weights:
                w = np.asarray(self.weights, np.float64)
                w = w / w.sum()
            return rng.choice(np.asarray(self.values, np.float64),
                              size=n, p=w)
        # lognormal, clipped to the DECLARED bounds so the property
        # "every sample honors bounds()" holds by construction
        out = self.median * np.exp(rng.standard_normal(n)
                                   * self.sigma)
        return np.clip(out, self.lo, self.hi)

    @classmethod
    def from_json(cls, obj) -> "Dist":
        if isinstance(obj, (int, float)):
            return cls(kind="const", value=float(obj))
        kw = dict(obj)
        for key in ("values", "weights"):
            if key in kw:
                kw[key] = tuple(float(v) for v in kw[key])
        return cls(**kw)

    def to_json(self):
        out = {"kind": self.kind}
        keep = {"const": ("value",),
                "uniform": ("lo", "hi"),
                "lognormal": ("median", "sigma", "lo", "hi"),
                "choice": ("values", "weights")}[self.kind]
        for f in fields(self):
            if f.name in keep:
                val = getattr(self, f.name)
                if isinstance(val, tuple):
                    val = list(val)
                out[f.name] = val
        return out


@dataclass(frozen=True)
class Arrival:
    """One cohort's join process.

    - ``inherit`` (default): the consumer's own join logic applies
      (the sweep's staggered/crowd schedules) — the degenerate mode
      the bit-identity gate rides;
    - ``steady``: everyone at ``at_s``;
    - ``staggered``: uniform over ``[at_s, at_s + window_s]``;
    - ``diurnal``: inverse-CDF draws from intensity
      ``1 + amplitude·sin(2π·(t − phase_s)/period_s)`` over the
      window — the daily audience curve;
    - ``wave``: a flash crowd — every member inside
      ``[at_s, at_s + window_s]`` (window 0 = one instant)."""

    kind: str = "inherit"
    at_s: float = 0.0
    window_s: float = 0.0
    period_s: float = 86_400.0
    amplitude: float = 0.8
    phase_s: float = 0.0

    def __post_init__(self):
        if self.kind not in ("inherit", "steady", "staggered",
                             "diurnal", "wave"):
            raise ValueError(f"unknown arrival kind {self.kind!r}")
        if not 0.0 <= self.amplitude <= 1.0:
            raise ValueError("diurnal amplitude must be in [0, 1] "
                             "(intensity must stay nonnegative)")

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "steady":
            return np.full(n, self.at_s, np.float64)
        if self.kind in ("staggered", "wave"):
            if self.window_s <= 0.0:
                return np.full(n, self.at_s, np.float64)
            return self.at_s + rng.uniform(0.0, self.window_s, n)
        # diurnal: numeric inverse CDF of the sine intensity over the
        # window (1024-knot grid — smooth, deterministic, vectorized)
        t = np.linspace(0.0, max(self.window_s, 1e-9), 1025)
        lam = 1.0 + self.amplitude * np.sin(
            2.0 * math.pi * (t - self.phase_s) / self.period_s)
        cdf = np.concatenate([[0.0], np.cumsum(
            (lam[1:] + lam[:-1]) * 0.5 * np.diff(t))])
        cdf /= cdf[-1]
        return self.at_s + np.interp(rng.uniform(0.0, 1.0, n), cdf, t)

    @classmethod
    def from_json(cls, obj) -> "Arrival":
        if obj is None:
            return cls()
        if isinstance(obj, str):
            return cls(kind=obj)
        return cls(**obj)

    def to_json(self):
        if self.kind == "inherit":
            return "inherit"
        out = {"kind": self.kind, "at_s": self.at_s,
               "window_s": self.window_s}
        if self.kind == "diurnal":
            out.update(period_s=self.period_s,
                       amplitude=self.amplitude,
                       phase_s=self.phase_s)
        return out


@dataclass(frozen=True)
class Cohort:
    """One named slice of the audience: attribute distributions +
    connectivity class + device ladder cap + temporal process."""

    name: str
    fraction: float
    #: per-peer rate distributions; None = inherit the consumer's
    #: homogeneous default (the sweep's supply knobs)
    uplink_bps: Optional[Dist] = None
    cdn_bps: Optional[Dist] = None
    connectivity: str = "open"
    #: highest ABR ladder level this cohort's devices decode
    #: (:data:`UNCAPPED` = the ladder top)
    abr_cap: int = UNCAPPED
    #: additive offset on the scheduler's urgency threshold — a
    #: risk-averse cohort (cellular, long RTTs) rescues to the CDN
    #: earlier than the swarm-wide knob
    urgent_margin_off_s: float = 0.0
    arrival: Arrival = field(default_factory=Arrival)
    #: exponential mean session length; None = watch to the end
    session_mean_s: Optional[float] = None
    session_min_s: float = 1.0

    def __post_init__(self):
        if self.fraction < 0.0:
            raise ValueError(f"cohort {self.name!r}: negative "
                             f"fraction {self.fraction}")
        if self.connectivity not in CONNECTIVITY_CLASSES:
            raise ValueError(
                f"cohort {self.name!r}: unknown connectivity class "
                f"{self.connectivity!r} (one of "
                f"{tuple(CONNECTIVITY_CLASSES)})")
        if self.abr_cap < UNCAPPED:
            raise ValueError(f"cohort {self.name!r}: abr_cap "
                             f"{self.abr_cap} < {UNCAPPED}")

    @classmethod
    def from_json(cls, obj) -> "Cohort":
        kw = dict(obj)
        for key in ("uplink_bps", "cdn_bps"):
            if kw.get(key) is not None:
                kw[key] = Dist.from_json(kw[key])
        kw["arrival"] = Arrival.from_json(kw.get("arrival"))
        return cls(**kw)

    def to_json(self):
        out = {"name": self.name, "fraction": self.fraction}
        if self.uplink_bps is not None:
            out["uplink_bps"] = self.uplink_bps.to_json()
        if self.cdn_bps is not None:
            out["cdn_bps"] = self.cdn_bps.to_json()
        if self.connectivity != "open":
            out["connectivity"] = self.connectivity
        if self.abr_cap != UNCAPPED:
            out["abr_cap"] = self.abr_cap
        if self.urgent_margin_off_s:
            out["urgent_margin_off_s"] = self.urgent_margin_off_s
        if self.arrival.kind != "inherit":
            out["arrival"] = self.arrival.to_json()
        if self.session_mean_s is not None:
            out["session_mean_s"] = self.session_mean_s
            out["session_min_s"] = self.session_min_s
        return out


@dataclass(frozen=True)
class PopulationSpec:
    """The whole audience: cohorts + spec-level temporal structure.

    ``partitions`` are regional-partition windows (seconds) rendered
    into the shared ``NetFaultPlan`` grammar for the real plane
    (:func:`fault_specs_from`); the simulator does not model them.
    ``mix_cohort``/``mix_fractions`` declare the sweep's mixture axis:
    ``sweep_grid.population_grid`` crosses the grid with one
    :func:`with_mix` re-weighting per fraction, all inside ONE
    dispatch group."""

    name: str = "population"
    seed: int = 0
    cohorts: Tuple[Cohort, ...] = ()
    partitions: Tuple[Tuple[float, float], ...] = ()
    mix_cohort: Optional[str] = None
    mix_fractions: Tuple[float, ...] = ()

    def __post_init__(self):
        if not self.cohorts:
            raise ValueError("a PopulationSpec needs >= 1 cohort")
        names = [c.name for c in self.cohorts]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate cohort names in {names}")
        if sum(c.fraction for c in self.cohorts) <= 0.0:
            raise ValueError("cohort fractions sum to zero")
        if self.mix_cohort is not None and self.mix_cohort not in names:
            raise ValueError(f"mix_cohort {self.mix_cohort!r} names "
                             f"no cohort (have {names})")
        inherit = [c.arrival.kind == "inherit" for c in self.cohorts]
        if any(inherit) and not all(inherit):
            raise ValueError(
                "mixed arrival modes: either every cohort inherits "
                "the consumer's join schedule or none does (a "
                "half-materialized join schedule would silently "
                "misalign the rebuffer denominator)")
        for t0, t1 in self.partitions:
            if t1 <= t0:
                raise ValueError(f"partition window {t0}-{t1} is "
                                 f"empty")

    @property
    def cohort_names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.cohorts)

    @property
    def inherits_joins(self) -> bool:
        return self.cohorts[0].arrival.kind == "inherit"

    def with_mix(self, mix: float) -> "PopulationSpec":
        """Re-weight the mixture axis: the ``mix_cohort`` takes
        fraction ``mix`` and every other cohort shares the remainder
        in its original proportions — the ``--population`` sweep
        knob.  ``mix`` is dynamic DATA (it only changes materialized
        arrays), so a whole fraction sweep is one dispatch group."""
        if self.mix_cohort is None:
            raise ValueError("spec declares no mix_cohort")
        if not 0.0 <= mix <= 1.0:
            raise ValueError(f"mix fraction {mix} outside [0, 1]")
        others = [c for c in self.cohorts if c.name != self.mix_cohort]
        rest = sum(c.fraction for c in others)
        scale = (1.0 - mix) / rest if rest > 0.0 else 0.0
        cohorts = []
        for c in self.cohorts:
            f = mix if c.name == self.mix_cohort else c.fraction * scale
            cohorts.append(Cohort(**{**_cohort_kwargs(c),
                                     "fraction": f}))
        return PopulationSpec(
            name=self.name, seed=self.seed, cohorts=tuple(cohorts),
            partitions=self.partitions, mix_cohort=self.mix_cohort,
            mix_fractions=self.mix_fractions)

    @classmethod
    def from_json(cls, obj) -> "PopulationSpec":
        kw = dict(obj)
        kw["cohorts"] = tuple(Cohort.from_json(c)
                              for c in kw.get("cohorts", ()))
        kw["partitions"] = tuple(
            (float(a), float(b)) for a, b in kw.get("partitions", ()))
        kw["mix_fractions"] = tuple(
            float(f) for f in kw.get("mix_fractions", ()))
        return cls(**kw)

    def to_json(self):
        out = {"name": self.name, "seed": self.seed,
               "cohorts": [c.to_json() for c in self.cohorts]}
        if self.partitions:
            out["partitions"] = [list(w) for w in self.partitions]
        if self.mix_cohort is not None:
            out["mix_cohort"] = self.mix_cohort
            out["mix_fractions"] = list(self.mix_fractions)
        return out


def _cohort_kwargs(c: Cohort) -> dict:
    return {f.name: getattr(c, f.name) for f in fields(Cohort)}


def load_spec(path: str) -> PopulationSpec:
    """Load a committed spec file (see ``examples/``)."""
    with open(path, encoding="utf-8") as fh:
        return PopulationSpec.from_json(json.load(fh))


class Population(NamedTuple):
    """Materialized per-peer arrays (numpy, host-side) — the ONE
    shape both planes consume.  ``uplink_bps``/``cdn_bps``/``join_s``
    are None when every cohort inherits the consumer's homogeneous
    defaults (the degenerate mode)."""

    cohort_names: Tuple[str, ...]
    cohort_id: np.ndarray            # [P] i32
    p2p_ok: np.ndarray               # [P] f32 0/1 connectivity mask
    abr_cap_level: np.ndarray        # [P] i32 (resolved to the top)
    urgent_margin_off_s: np.ndarray  # [P] f32
    uplink_bps: Optional[np.ndarray]
    cdn_bps: Optional[np.ndarray]
    join_s: Optional[np.ndarray]
    leave_s: Optional[np.ndarray]

    @property
    def n_peers(self) -> int:
        return int(self.cohort_id.shape[0])

    @property
    def n_cohorts(self) -> int:
        return len(self.cohort_names)

    def cohort_counts(self) -> Dict[str, int]:
        counts = np.bincount(self.cohort_id,
                             minlength=self.n_cohorts)
        return {name: int(counts[k])
                for k, name in enumerate(self.cohort_names)}


def cohort_counts(fractions: Sequence[float], n: int) -> List[int]:
    """Exact per-cohort peer counts: largest-remainder apportionment
    of ``n`` over the (renormalized) fractions — deterministic,
    sums to ``n`` exactly, ties broken by cohort order."""
    total = sum(fractions)
    raw = [f / total * n for f in fractions]
    base = [int(math.floor(x)) for x in raw]
    rem = n - sum(base)
    order = sorted(range(len(raw)),
                   key=lambda k: (-(raw[k] - base[k]), k))
    for k in order[:rem]:
        base[k] += 1
    return base


def interleave_cohorts(counts: Sequence[int]) -> np.ndarray:
    """Deterministic proportional INTERLEAVE of cohort ids over the
    peer index axis: cohort k's members sit at the evenly-spaced
    ticks ``(j + 0.5) / count_k``, merged in tick order.  Index
    position IS overlay position on the circulant ring, so a
    contiguous-arc assignment would manufacture topology/cohort
    correlation (a crowd arc with zero seed neighbors — the artifact
    ``sweep_grid``'s live crowd interleave already
    guards against); the interleave keeps every prefix's mixture
    within one peer of the target fractions."""
    ticks, labels = [], []
    for k, c in enumerate(counts):
        if c <= 0:
            continue
        ticks.append((np.arange(c, dtype=np.float64) + 0.5) / c)
        labels.append(np.full(c, k, np.int32))
    if not ticks:
        raise ValueError("no peers to assign")
    ticks = np.concatenate(ticks)
    labels = np.concatenate(labels)
    order = np.lexsort((labels, ticks))
    return labels[order]


def materialize(spec: PopulationSpec, n_peers: int, *,
                n_levels: int = 1,
                default_uplink_bps: float = 0.0,
                default_cdn_bps: float = 0.0,
                registry=None) -> Population:
    """Materialize the spec into per-peer arrays.

    Each cohort draws from its OWN ``np.random.default_rng([seed,
    cohort_index])`` stream in a fixed order (uplink, cdn, join,
    session), so cohort k's attributes are invariant to every other
    cohort's parameters — re-weighting the mixture axis perturbs
    only the affected lanes' values, never the whole audience.
    ``n_levels`` resolves :data:`UNCAPPED` device caps to the ladder
    top; the ``default_*`` rates fill cohorts whose distributions
    inherit (the sweep's supply knobs).  ``registry`` (optional,
    engine/telemetry.py) gains one ``population.materializations``
    bump and per-cohort ``population.cohort_peers`` gauges."""
    if n_peers <= 0:
        raise ValueError(f"n_peers must be positive, got {n_peers}")
    counts = cohort_counts([c.fraction for c in spec.cohorts],
                           n_peers)
    cohort_id = interleave_cohorts(counts)
    p2p_ok = np.ones(n_peers, np.float32)
    abr_cap = np.full(n_peers, n_levels - 1, np.int32)
    margin_off = np.zeros(n_peers, np.float32)
    inherit_rates = all(c.uplink_bps is None and c.cdn_bps is None
                        for c in spec.cohorts)
    uplink = None if inherit_rates else np.empty(n_peers, np.float32)
    cdn = None if inherit_rates else np.empty(n_peers, np.float32)
    inherit_joins = spec.inherits_joins
    join = None if inherit_joins else np.empty(n_peers, np.float32)
    any_session = any(c.session_mean_s is not None
                      for c in spec.cohorts)
    leave = (np.full(n_peers, NEVER_S, np.float32)
             if (any_session and not inherit_joins) else None)
    if any_session and inherit_joins:
        raise ValueError(
            "session departures need materialized joins (a leave "
            "clock relative to a join this spec does not own would "
            "be meaningless); give every cohort an explicit arrival")
    for k, cohort in enumerate(spec.cohorts):
        mask = cohort_id == k
        n_k = int(counts[k])
        if n_k == 0:
            continue
        # one seeded stream per cohort; DRAW ORDER IS CONTRACT
        rng = np.random.default_rng([spec.seed, k])
        if cohort.connectivity != "open":
            p2p_ok[mask] = CONNECTIVITY_CLASSES[cohort.connectivity]
        if cohort.abr_cap != UNCAPPED:
            abr_cap[mask] = min(cohort.abr_cap, n_levels - 1)
        if cohort.urgent_margin_off_s:
            margin_off[mask] = cohort.urgent_margin_off_s
        if not inherit_rates:
            up_d = cohort.uplink_bps or Dist(value=default_uplink_bps)
            cd_d = cohort.cdn_bps or Dist(value=default_cdn_bps)
            uplink[mask] = up_d.sample(rng, n_k)
            cdn[mask] = cd_d.sample(rng, n_k)
        if not inherit_joins:
            join[mask] = cohort.arrival.sample(rng, n_k)
            if cohort.session_mean_s is not None:
                session = np.maximum(
                    rng.exponential(cohort.session_mean_s, n_k),
                    cohort.session_min_s)
                leave[mask] = join[mask] + session.astype(np.float32)
    pop = Population(cohort_names=spec.cohort_names,
                     cohort_id=cohort_id, p2p_ok=p2p_ok,
                     abr_cap_level=abr_cap,
                     urgent_margin_off_s=margin_off,
                     uplink_bps=uplink, cdn_bps=cdn,
                     join_s=join, leave_s=leave)
    _note(registry, pop, source="parametric")
    return pop


def materialize_trace(records, *, cohort: str = "trace",
                      n_levels: int = 1,
                      default_uplink_bps: float = 0.0,
                      default_cdn_bps: float = 0.0,
                      registry=None) -> Population:
    """The trace-driven variant: replay recorded join/leave/rate
    records into the same :class:`Population` arrays.

    ``records`` is an iterable of dicts (e.g. JSONL rows): each
    ``{"peer": id, "join_s": t}`` row adds a peer; optional keys
    ``leave_s``, ``uplink_bps``, ``cdn_bps``, ``cohort`` (label,
    default ``cohort``), ``connectivity``, ``abr_cap``.  Peers land
    in record order (first record per peer id wins; a later record
    for the same peer updates its leave clock — the natural shape of
    an event log).  No randomness at all: a trace IS its own seed.

    Defaults mirror the parametric path's inherit semantics: a rate
    key the WHOLE trace omits stays None (the consumer's homogeneous
    default applies); a peer missing a key other peers carry gets
    the ``default_*`` fill; a missing or :data:`UNCAPPED` ``abr_cap``
    resolves to the ladder top (``n_levels - 1``) — never 0, which
    would silently pin a traced audience to the lowest rung."""
    order: List[str] = []
    by_peer: Dict[str, dict] = {}
    for rec in records:
        peer = str(rec.get("peer", len(order)))
        if peer not in by_peer:
            by_peer[peer] = dict(rec)
            order.append(peer)
        else:
            cur = by_peer[peer]
            for key in ("leave_s", "uplink_bps", "cdn_bps"):
                if key in rec:
                    cur[key] = rec[key]
    if not order:
        raise ValueError("empty population trace")
    names: List[str] = []
    rows = [by_peer[p] for p in order]
    for rec in rows:
        label = str(rec.get("cohort", cohort))
        if label not in names:
            names.append(label)
    n = len(rows)
    cohort_id = np.array([names.index(str(r.get("cohort", cohort)))
                          for r in rows], np.int32)
    top = n_levels - 1

    def cap_of(rec) -> int:
        cap = int(rec.get("abr_cap", UNCAPPED))
        # any negative is the uncapped sentinel — a raw negative
        # would wrap as a level index downstream
        return top if cap < 0 else min(cap, top)

    def rates(key, default):
        # inherit semantics: a key NO record carries stays None (the
        # consumer's homogeneous default applies); once any record
        # carries it, peers missing it get the explicit default fill
        if not any(key in r for r in rows):
            return None
        return np.array([float(r.get(key, default)) for r in rows],
                        np.float32)

    pop = Population(
        cohort_names=tuple(names), cohort_id=cohort_id,
        p2p_ok=np.array(
            [CONNECTIVITY_CLASSES[r.get("connectivity", "open")]
             for r in rows], np.float32),
        abr_cap_level=np.array([cap_of(r) for r in rows], np.int32),
        urgent_margin_off_s=np.array(
            [float(r.get("urgent_margin_off_s", 0.0)) for r in rows],
            np.float32),
        uplink_bps=rates("uplink_bps", default_uplink_bps),
        cdn_bps=rates("cdn_bps", default_cdn_bps),
        join_s=np.array([float(r.get("join_s", 0.0)) for r in rows],
                        np.float32),
        leave_s=np.array([float(r.get("leave_s", NEVER_S))
                          for r in rows], np.float32))
    _note(registry, pop, source="trace")
    return pop


def _note(registry, pop: Population, *, source: str) -> None:
    if registry is None:
        return
    registry.counter("population.materializations",
                     source=source).inc()
    for name, count in pop.cohort_counts().items():
        registry.gauge("population.cohort_peers",
                       cohort=name).set(count)


def to_scenario_kwargs(pop: Population) -> dict:
    """The simulator's view: keyword arguments for
    ``ops/swarm_sim.py make_scenario`` (every array dynamic scenario
    DATA — one dispatch group per mixture grid).  Keys whose arrays
    inherit the consumer's defaults are omitted, so a degenerate
    population produces exactly the homogeneous call."""
    out = {"cohort_id": pop.cohort_id, "p2p_ok": pop.p2p_ok,
           "abr_cap_level": pop.abr_cap_level,
           "urgent_margin_off_s": pop.urgent_margin_off_s}
    for key in ("uplink_bps", "cdn_bps", "join_s", "leave_s"):
        val = getattr(pop, key)
        if val is not None:
            out[key] = val
    return out


def fault_specs_from(spec: PopulationSpec) -> Optional[str]:
    """The spec's regional-partition windows in the shared
    ``NetFaultPlan`` grammar (``partition@T0-T1``), for the real
    plane's loopback/TCP fabrics.  None when the spec declares no
    partitions."""
    if not spec.partitions:
        return None
    return ",".join(f"partition@{_fmt(t0)}-{_fmt(t1)}"
                    for t0, t1 in spec.partitions)


def _fmt(t: float) -> str:
    return f"{t:g}"


def population_digest(pop: Population) -> str:
    """Content digest of the materialized arrays — the
    cross-process determinism surface (same spec + seed ⇒ same digest
    in any process), equal to the reference's for the same spec."""
    h = hashlib.sha256()
    h.update(json.dumps(list(pop.cohort_names)).encode())
    for leaf in pop[1:]:
        if leaf is None:
            h.update(b"\x00none")
        else:
            h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()
