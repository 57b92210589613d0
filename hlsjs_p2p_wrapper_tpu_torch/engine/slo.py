# A copy of the reference's engine/slo.py (hlsjs_p2p_wrapper_tpu/engine/slo.py): the
# same names, formats and bytes; only the imports point at the port's own
# modules.
"""SLO layer over the fleet observation plane: declarative
objectives, error budgets, multi-window burn-rate alerts.

The planes below this one produce a merged frame stream (engine/
twinframe.py ``ShardMuxFollower``: one canonical row per fleet
window, per-shard sub-rows, per-peer stall intervals) and tail
columns (engine/digest.py quantiles).  This module is the judgment
layer a production delivery stack runs on top of exactly that
pipeline: it turns "p99 rebuffer was 2.1 s in window 12" into "the
``rebuffer-p99`` SLO is burning its error budget 4× too fast, worst
shard ``mux02``, worst cohort ``cellular``".

- :class:`SLOSpec` — one declarative objective: a frame-column
  metric (mean columns like ``rebuffer`` or quantile columns like
  ``rebuffer_ms_p99``), a threshold, an error budget (the fraction
  of windows allowed to violate it over the budget period), and the
  multi-window burn-rate alert shape (fast + slow windows, one
  threshold).  JSON round-trippable — the committed ``SLO_r12.json``
  artifact is a list of these plus the gate's measured results.
- :class:`SLOEvaluator` — the streaming judge: feed it one merged
  window at a time (the mux's cadence) and it maintains per-SLO
  good/bad history, burn rates, and budget remaining.  An alert
  fires on the RISING EDGE of "both burn windows exceed the
  threshold" (the classic multi-window discipline: the fast window
  makes it prompt, the slow window keeps a single bad window from
  paging anyone), and every alert NAMES metric, quantile, window
  shape, both burn rates, the worst SHARD contributor (from the
  mux's per-shard rows) and the worst COHORT contributor (from the
  per-peer stall intervals + a cohort map) — the triage mold: an
  alert that cannot say who is burning the budget is noise.

Everything is derived from VirtualClock-stamped frames — this file
holds no clock of its own (tools/lint.py's injectable-clock rule
covers it) and draws no randomness (the digest seed-free rule's
neighbor).  Registry families: ``slo.windows{slo,verdict}``,
``slo.alerts{slo}``, ``slo.burn_rate{slo,window}`` /
``slo.budget_remaining{slo}`` gauges.  Flight-recorder marks:
``slo_window`` per evaluated window, ``slo_alert`` per firing —
what ``tools/fleet_console.py --slo`` and the Perfetto exporter's
SLO row render.
"""

from __future__ import annotations

from collections import deque
from dataclasses import asdict, dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from .digest import QuantileDigest
from .twinframe import FRAME_COLUMNS

#: burn-rate gauge label values for the two alert windows
FAST, SLOW = "fast", "slow"


def _interval_offload(row: Tuple[float, ...]) -> Optional[float]:
    """Derived per-window objective: the INTERVAL offload ratio
    (this window's P2P share of delivered bits, from the interval
    rate columns) — the cumulative ``offload`` column is too sticky
    to alert on (a regional outage moves it by a rounding error
    after an hour of history).  A window that delivered NOTHING
    returns None: no delivery is no violation (the VOD tail where
    every peer is done must not burn budget)."""
    cdn = row[FRAME_COLUMNS.index("cdn_rate_bps")]
    p2p = row[FRAME_COLUMNS.index("p2p_rate_bps")]
    total = cdn + p2p
    if total <= 0.0:
        return None
    return p2p / total


#: objectives DERIVED from frame rows (name -> row -> value-or-None;
#: None = idle window, skipped): the alertable per-window forms of
#: metrics whose frame columns are cumulative
DERIVED_METRICS = {"interval_offload": _interval_offload}


@dataclass(frozen=True)
class SLOSpec:
    """One service-level objective over a frame column.

    A window is GOOD when ``value <op> threshold`` holds.  The error
    budget is the fraction of the trailing ``budget_windows`` allowed
    to be bad; a burn rate of 1.0 means "spending the budget exactly
    as fast as it accrues", and the alert fires while BOTH the fast
    and the slow trailing windows burn above ``burn_threshold``."""

    name: str
    metric: str
    threshold: float
    op: str = "<="
    error_budget: float = 0.05
    budget_windows: int = 20
    fast_windows: int = 3
    slow_windows: int = 10
    burn_threshold: float = 2.0

    def __post_init__(self):
        if self.metric not in FRAME_COLUMNS \
                and self.metric not in DERIVED_METRICS:
            raise ValueError(
                f"SLO {self.name!r}: {self.metric!r} is neither a "
                f"frame column ({FRAME_COLUMNS}) nor a derived "
                f"metric ({tuple(DERIVED_METRICS)})")
        if self.op not in ("<=", ">="):
            raise ValueError(f"SLO {self.name!r}: op must be <= or "
                             f">=, got {self.op!r}")
        if not 0.0 < self.error_budget <= 1.0:
            raise ValueError(f"SLO {self.name!r}: error_budget must "
                             f"be in (0, 1]")
        if not (1 <= self.fast_windows <= self.slow_windows
                <= self.budget_windows):
            raise ValueError(
                f"SLO {self.name!r}: need fast <= slow <= budget "
                f"windows, got {self.fast_windows}/"
                f"{self.slow_windows}/{self.budget_windows}")

    def good(self, value: float) -> bool:
        return (value <= self.threshold if self.op == "<="
                else value >= self.threshold)

    @property
    def quantile(self) -> str:
        """Which quantile the objective metric carries (from the
        column naming convention), ``mean`` for plain columns —
        every alert names it."""
        for q in ("p50", "p95", "p99"):
            if self.metric.endswith(f"_{q}"):
                return q
        return "mean"

    def as_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "SLOSpec":
        return cls(**data)


def _bad_fraction(history, n: int) -> float:
    """Bad-window fraction over the trailing ``n`` entries of a
    0/1-bad history (fewer entries than ``n``: over what exists —
    a young stream burns honestly, not optimistically)."""
    recent = list(history)[-n:]
    if not recent:
        return 0.0
    return sum(recent) / len(recent)


def worst_shard(spec: SLOSpec,
                shard_rows: Dict[str, Optional[Tuple[float, ...]]]
                ) -> Optional[dict]:
    """The shard whose own sub-frame is furthest on the BAD side of
    the objective this window (``<=`` objectives: largest value;
    derived metrics evaluate per shard row, idle shards skipped).
    Shards excluded from the window (None rows) cannot be blamed —
    they are already counted as exclusions."""
    derived = DERIVED_METRICS.get(spec.metric)
    candidates = []
    for shard, row in sorted(shard_rows.items()):
        if row is None:
            continue
        value = (derived(row) if derived is not None
                 else row[FRAME_COLUMNS.index(spec.metric)])
        if value is not None:
            candidates.append((value, shard))
    if not candidates:
        return None
    value, shard = (max(candidates) if spec.op == "<="
                    else min(candidates))
    return {"shard": shard, "value": round(value, 6)}


#: which per-peer surface attributes each objective family, and
#: which DIRECTION is "worse" on it: the rebuffer family blames the
#: cohort carrying the most stall; the delivery family (offload /
#: p2p rate) blames the cohort whose members STOPPED receiving P2P
#: bytes — the regional-outage shape
_ATTRIBUTION = {"rebuffer": ("stall", max),
                "offload": ("p2p", min),
                "interval_offload": ("p2p", min),
                "p2p_rate_bps": ("p2p", min)}


def _attribution_for(metric: str):
    for prefix, rule in _ATTRIBUTION.items():
        if metric.startswith(prefix):
            return rule
    return None


def worst_cohort(spec: SLOSpec,
                 surfaces: Dict[str, Dict[str, float]],
                 cohort_of: Callable[[str], str]) -> Optional[dict]:
    """The cohort whose members carry the worst of the objective
    this window, from the per-peer surface the objective family
    maps to (``_ATTRIBUTION``): for quantile objectives, each
    cohort's OWN digest quantile of the per-peer values (the same
    sketch, so cohort and fleet numbers share one definition); for
    mean objectives, the cohort mean.  Ties break on cohort name
    (deterministic).  Metrics with no honest per-peer surface
    attribute nobody rather than guessing."""
    rule = _attribution_for(spec.metric)
    if rule is None:
        return None
    surface, worse = rule
    peer_values = surfaces.get(surface) or {}
    if not peer_values:
        return None
    groups: Dict[str, List[float]] = {}
    for peer in sorted(peer_values):
        groups.setdefault(cohort_of(peer), []).append(
            peer_values[peer])
    q = {"p50": 0.5, "p95": 0.95, "p99": 0.99}.get(spec.quantile)
    scored = []
    for cohort in sorted(groups):
        values = groups[cohort]
        if q is None:
            score = sum(values) / len(values)
        else:
            digest = QuantileDigest()
            for value in values:
                digest.add(value)
            score = digest.quantile(q)
        scored.append((score, cohort, len(values)))
    score, cohort, n = worse(scored)
    return {"cohort": cohort, "value": round(score, 6), "peers": n,
            "surface": surface}


class SLOEvaluator:
    """The streaming burn-rate judge (module docstring).

    Feed :meth:`observe_window` once per merged fleet window, in
    window order.  ``registry`` receives the ``slo.*`` families,
    ``recorder`` the ``slo_window`` / ``slo_alert`` marks (flushed
    per window, the sampler's fsync=False discipline), ``cohort_of``
    maps a peer id to its cohort name for attribution (default: one
    ``all`` cohort)."""

    def __init__(self, specs: Iterable[SLOSpec], *, registry=None,
                 recorder=None,
                 cohort_of: Optional[Callable[[str], str]] = None,
                 warmup_windows: int = 0):
        self.specs = list(specs)
        names = [spec.name for spec in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        if registry is None:
            # private fallback so judgment call sites stay
            # unconditional (the AgentStats convention)
            from .telemetry import MetricsRegistry
            registry = MetricsRegistry()
        self.registry = registry
        self.recorder = recorder
        self.cohort_of = cohort_of or (lambda _peer: "all")
        #: windows before this index are observed but not JUDGED
        #: (counted ``verdict=warmup``): a fleet filling its join
        #: cushions violates every delivery objective by design,
        #: and startup must spend patience, not error budget — the
        #: controller's warmup_windows discipline
        self.warmup_windows = int(warmup_windows)
        self._history: Dict[str, deque] = {
            spec.name: deque(maxlen=spec.budget_windows)
            for spec in self.specs}
        self._firing: Dict[str, bool] = {spec.name: False
                                         for spec in self.specs}
        self.alerts: List[dict] = []
        self.windows = 0
        #: last evaluated state per SLO (the console's summary view)
        self.state: Dict[str, dict] = {}

    def observe_window(self, row: Tuple[float, ...], *,
                       shard_rows: Optional[
                           Dict[str, Optional[Tuple[float, ...]]]
                       ] = None,
                       peer_stall: Optional[Dict[str, float]] = None,
                       peer_p2p: Optional[Dict[str, float]] = None,
                       excluded: Tuple[str, ...] = ()) -> List[dict]:
        """One merged window; returns the alerts that FIRED on it
        (rising edges only).  ``row`` is a canonical frame row
        (:data:`~.twinframe.FRAME_COLUMNS` order); ``shard_rows`` /
        ``peer_stall`` / ``peer_p2p`` / ``excluded`` are the mux's
        per-window attribution surfaces."""
        surfaces = {"stall": peer_stall or {},
                    "p2p": peer_p2p or {}}
        t_s = row[FRAME_COLUMNS.index("t_s")]
        window = self.windows
        self.windows += 1
        fired = []
        for spec in self.specs:
            if spec.metric in DERIVED_METRICS:
                value = DERIVED_METRICS[spec.metric](row)
            else:
                value = row[FRAME_COLUMNS.index(spec.metric)]
            if window < self.warmup_windows or value is None:
                # warmup or idle: observed, counted, never judged —
                # but the budget/burn view must carry the JUDGED
                # history forward (a stream ending on an idle VOD
                # tail must not report a full budget it already
                # spent; summary() and the committed artifact read
                # this state)
                history = self._history[spec.name]
                self.registry.counter(
                    "slo.windows", slo=spec.name,
                    verdict=("warmup"
                             if window < self.warmup_windows
                             else "idle")).inc()
                self.state[spec.name] = {
                    "slo": spec.name, "metric": spec.metric,
                    "quantile": spec.quantile,
                    "value": (round(value, 6)
                              if value is not None else None),
                    "good": None,
                    "burn_fast": round(
                        _bad_fraction(history, spec.fast_windows)
                        / spec.error_budget, 4),
                    "burn_slow": round(
                        _bad_fraction(history, spec.slow_windows)
                        / spec.error_budget, 4),
                    "budget_remaining": round(
                        1.0 - sum(history) / (spec.error_budget
                                              * spec.budget_windows),
                        4),
                    "firing": self._firing[spec.name],
                    "window": window, "t_s": round(t_s, 3)}
                continue
            good = spec.good(value)
            history = self._history[spec.name]
            history.append(0 if good else 1)
            burn_fast = (_bad_fraction(history, spec.fast_windows)
                         / spec.error_budget)
            burn_slow = (_bad_fraction(history, spec.slow_windows)
                         / spec.error_budget)
            budget_spent = (sum(history)
                            / (spec.error_budget
                               * spec.budget_windows))
            remaining = 1.0 - budget_spent
            self.registry.counter(
                "slo.windows", slo=spec.name,
                verdict="good" if good else "bad").inc()
            self.registry.gauge("slo.burn_rate", slo=spec.name,
                                window=FAST).set(round(burn_fast, 4))
            self.registry.gauge("slo.burn_rate", slo=spec.name,
                                window=SLOW).set(round(burn_slow, 4))
            self.registry.gauge("slo.budget_remaining",
                                slo=spec.name).set(round(remaining,
                                                         4))
            firing = (burn_fast > spec.burn_threshold
                      and burn_slow > spec.burn_threshold)
            state = {
                "slo": spec.name, "metric": spec.metric,
                "quantile": spec.quantile, "value": round(value, 6),
                "good": good, "burn_fast": round(burn_fast, 4),
                "burn_slow": round(burn_slow, 4),
                "budget_remaining": round(remaining, 4),
                "firing": firing, "window": window,
                "t_s": round(t_s, 3)}
            if firing and not self._firing[spec.name]:
                alert = dict(state)
                alert.update({
                    "reason": "burn_rate",
                    "threshold": spec.threshold, "op": spec.op,
                    "fast_windows": spec.fast_windows,
                    "slow_windows": spec.slow_windows,
                    "burn_threshold": spec.burn_threshold,
                    "worst_shard": worst_shard(spec,
                                               shard_rows or {}),
                    "worst_cohort": worst_cohort(spec, surfaces,
                                                 self.cohort_of),
                    "excluded_shards": list(excluded)})
                self.alerts.append(alert)
                fired.append(alert)
                self.registry.counter("slo.alerts",
                                      slo=spec.name).inc()
                if self.recorder is not None:
                    self.recorder.mark("slo_alert", **alert)
            self._firing[spec.name] = firing
            self.state[spec.name] = state
            if self.recorder is not None:
                self.recorder.mark("slo_window", **state)
        if self.recorder is not None:
            self.recorder.flush(fsync=False)
        return fired

    def summary(self) -> dict:
        """Per-SLO totals after a stream: windows seen, bad windows,
        budget remaining, peak burn rates, alerts — the committed
        ``SLO_r12.json`` results shape."""
        out = {}
        for spec in self.specs:
            history = self._history[spec.name]
            state = self.state.get(spec.name, {})
            out[spec.name] = {
                "windows": self.windows,
                "bad_windows": sum(history),
                "budget_remaining": state.get("budget_remaining",
                                              1.0),
                "burn_fast": state.get("burn_fast", 0.0),
                "burn_slow": state.get("burn_slow", 0.0),
                "alerts": sum(1 for a in self.alerts
                              if a["slo"] == spec.name)}
        return out


def evaluate_mux(mux, specs: Iterable[SLOSpec], *, registry=None,
                 recorder=None,
                 cohort_of: Optional[Callable[[str], str]] = None,
                 warmup_windows: int = 0) -> SLOEvaluator:
    """Batch-evaluate a drained :class:`~.twinframe.ShardMuxFollower`
    (``per_shard=True`` for shard attribution): every closed window
    through one :class:`SLOEvaluator`, in window order — the gate's
    and the console's offline path, and by construction identical to
    having streamed the same windows live."""
    evaluator = SLOEvaluator(specs, registry=registry,
                             recorder=recorder, cohort_of=cohort_of,
                             warmup_windows=warmup_windows)
    for window, row in enumerate(mux.rows):
        shard_rows = {shard: rows[window]
                      for shard, rows in mux.shard_rows.items()} \
            if mux.shard_rows else None
        evaluator.observe_window(
            row, shard_rows=shard_rows,
            peer_stall=mux.peer_stall[window],
            peer_p2p=mux.peer_p2p[window],
            excluded=mux.exclusions[window])
    return evaluator
