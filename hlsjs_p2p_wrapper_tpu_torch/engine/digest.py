"""The stall-digest bin layout and the mergeable quantile digest, copied
from the reference's ``engine/digest.py``: ``log_edges``,
``DEFAULT_EDGES``, ``REPORTED_QUANTILES``, ``bin_index``,
``quantiles_from_counts`` and :class:`QuantileDigest` (the frame
reducer's and the SLO evaluator's tail quantiles).

The metrics timeline's ``stall_digest`` columns bin each present peer's
interval stall (ms) over these edges with ``searchsorted(side="left")``:
bin 0 is the underflow (``value <= edges[0]``, zeros included), bin
``i`` holds ``edges[i-1] < value <= edges[i]`` and the last bin the
overflow.  The edges are a pure function of their arguments, so the
port's copy and the reference's are the same floats (pinned by a
test).
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Dict, Iterable, List, Sequence, Tuple

#: 1 ms resolution floor to a 120 s ceiling, 24 bins
DEFAULT_LO_MS = 1.0
DEFAULT_HI_MS = 120_000.0
DEFAULT_BINS = 24

#: the quantiles the observation plane reports everywhere (frame
#: columns, SLO objectives, console panels) — one list, so no two
#: consumers can disagree about what "tail" means
REPORTED_QUANTILES = (0.5, 0.95, 0.99)


def log_edges(lo: float = DEFAULT_LO_MS, hi: float = DEFAULT_HI_MS,
              bins: int = DEFAULT_BINS) -> Tuple[float, ...]:
    """The ``bins + 1`` log-spaced bin edges from ``lo`` to ``hi``
    (inclusive ends, geometric spacing)."""
    if not (0.0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    if bins < 1:
        raise ValueError(f"need >= 1 bin, got {bins}")
    ratio = math.log(hi / lo) / bins
    edges = [lo * math.exp(i * ratio) for i in range(bins)]
    edges.append(float(hi))  # exact, not exp-rounded
    return tuple(edges)


#: the shared default layout
DEFAULT_EDGES = log_edges()


def bin_index(edges: Sequence[float], value: float) -> int:
    """Which of the ``len(edges) + 1`` bins ``value`` lands in:
    bin 0 is the underflow (``value <= edges[0]``, zeros included),
    bin ``i`` holds ``edges[i-1] < value <= edges[i]``, and the last
    bin is the overflow (``value > edges[-1]``).  ``bisect_left``
    semantics — the jnp plane's ``searchsorted(..., side="left")``
    computes the identical index."""
    return bisect_left(edges, value)


def quantiles_from_counts(edges: Sequence[float],
                          counts: Sequence[int],
                          qs: Iterable[float] = REPORTED_QUANTILES
                          ) -> List[float]:
    """Deterministic quantile estimates from a bin-count vector
    (``len(edges) + 1`` long, :func:`bin_index` layout).

    The estimate for rank ``ceil(q * n)``'s bin: 0.0 for the
    underflow bin (mass below the resolution floor reads as zero —
    honest for stall/latency families where "under 1 ms" IS zero),
    the geometric midpoint for an interior bin, the top edge for the
    overflow bin (a deliberately clamped, never-extrapolated tail).
    An empty digest reports 0.0 for every quantile."""
    total = sum(counts)
    out = []
    for q in qs:
        if total <= 0:
            out.append(0.0)
            continue
        rank = max(1, math.ceil(q * total))
        cum = 0
        idx = len(counts) - 1
        for i, n in enumerate(counts):
            cum += n
            if cum >= rank:
                idx = i
                break
        if idx == 0:
            out.append(0.0)
        elif idx >= len(edges):
            out.append(float(edges[-1]))
        else:
            out.append(math.sqrt(edges[idx - 1] * edges[idx]))
    return out


class QuantileDigest:
    """One mergeable sketch: fixed edges + integer bin counts.

    ``add``/``add_binned`` feed it, ``merge`` folds another digest
    of the SAME layout in (layout mismatch is a hard error — two
    different layouts have no common refinement, and silently
    rebinning would break the exactness contract), and
    :meth:`quantile` / :meth:`quantiles` read it.  Not thread-safe;
    the registry instrument (engine/telemetry.py) adds the lock."""

    __slots__ = ("edges", "counts")

    def __init__(self, edges: Sequence[float] = DEFAULT_EDGES,
                 counts: Sequence[int] = None):
        self.edges = tuple(float(e) for e in edges)
        if counts is None:
            self.counts = [0] * (len(self.edges) + 1)
        else:
            self.counts = [int(n) for n in counts]
            if len(self.counts) != len(self.edges) + 1:
                raise ValueError(
                    f"counts length {len(self.counts)} does not fit "
                    f"{len(self.edges)} edges (+ under/overflow)")

    def add(self, value: float, n: int = 1) -> None:
        self.counts[bin_index(self.edges, value)] += n

    def add_binned(self, counts: Sequence[int]) -> None:
        """Fold a raw bin-count vector (the jnp plane's timeline
        columns) — the cross-plane feeder."""
        if len(counts) != len(self.counts):
            raise ValueError(
                f"binned vector length {len(counts)} != "
                f"{len(self.counts)}")
        for i, n in enumerate(counts):
            self.counts[i] += int(n)

    def merge(self, other: "QuantileDigest") -> "QuantileDigest":
        if other.edges != self.edges:
            raise ValueError("digest layouts differ — refusing a "
                             "silently-rebinned merge")
        for i, n in enumerate(other.counts):
            self.counts[i] += n
        return self

    @property
    def count(self) -> int:
        return sum(self.counts)

    def quantile(self, q: float) -> float:
        return quantiles_from_counts(self.edges, self.counts, (q,))[0]

    def quantiles(self, qs: Iterable[float] = REPORTED_QUANTILES
                  ) -> List[float]:
        return quantiles_from_counts(self.edges, self.counts, qs)

    def read(self) -> Dict[str, float]:
        """The reporting view (the registry instrument's ``read()``):
        count plus the standard quantile trio."""
        p50, p95, p99 = self.quantiles(REPORTED_QUANTILES)
        return {"count": self.count, "p50": round(p50, 6),
                "p95": round(p95, 6), "p99": round(p99, 6)}

    def as_dict(self) -> dict:
        return {"edges": list(self.edges), "counts": list(self.counts)}

    @classmethod
    def from_dict(cls, data: dict) -> "QuantileDigest":
        return cls(edges=data["edges"], counts=data["counts"])

    def __eq__(self, other) -> bool:
        return (isinstance(other, QuantileDigest)
                and self.edges == other.edges
                and self.counts == other.counts)

    def __repr__(self) -> str:
        return (f"QuantileDigest(n={self.count}, "
                f"bins={len(self.counts)})")
