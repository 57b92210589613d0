"""The stall-digest bin layout, copied from the reference's
``engine/digest.py`` (``log_edges`` and ``DEFAULT_EDGES``).

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
from typing import Tuple

#: 1 ms resolution floor to a 120 s ceiling, 24 bins
DEFAULT_LO_MS = 1.0
DEFAULT_HI_MS = 120_000.0
DEFAULT_BINS = 24


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
