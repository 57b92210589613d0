# A copy of the reference's engine/scheduler.py
# (hlsjs_p2p_wrapper_tpu/engine/scheduler.py): the same names, formats and
# bytes; the imports point at the port's own modules.
"""Deadline-aware source selection.

The hardest open design question the reference leaves unanswered
(SURVEY.md §7.3(2)): when should a segment come from peers and when
from the CDN?  The policy here is explicit and unit-testable:

- A request with little playback margin (the fragment starts soon
  relative to the playhead) must not gamble on peers — straight to
  CDN.  P2P still contributes via cache hits.
- With margin, try peers under ONE strict time budget (a fraction of
  the margin, capped): the best holder first, then — on deny/timeout,
  while budget remains — the next-least-loaded holders, up to
  ``max_p2p_attempts``.  CDN only when holders or budget are
  exhausted, so one dead best-holder doesn't waste the whole budget
  when another peer has the bytes.  The budget guarantees worst-case
  added latency is bounded and proportional to how much slack
  playback actually has.
- No holders → CDN immediately.

All decisions are pure functions of (margin, holders, toggles) so the
swarm simulator and the live agent share one policy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

DEFAULT_URGENT_MARGIN_S = 4.0
DEFAULT_P2P_BUDGET_FRACTION = 0.5
DEFAULT_P2P_BUDGET_CAP_MS = 6_000.0
DEFAULT_P2P_BUDGET_FLOOR_MS = 500.0
DEFAULT_MAX_P2P_ATTEMPTS = 3


@dataclass(frozen=True)
class SchedulingPolicy:
    """Tunables, overridable via ``p2p_config``."""

    urgent_margin_s: float = DEFAULT_URGENT_MARGIN_S
    p2p_budget_fraction: float = DEFAULT_P2P_BUDGET_FRACTION
    p2p_budget_cap_ms: float = DEFAULT_P2P_BUDGET_CAP_MS
    p2p_budget_floor_ms: float = DEFAULT_P2P_BUDGET_FLOOR_MS
    #: how many distinct holders one foreground request may try
    #: within its budget before conceding to the CDN
    max_p2p_attempts: int = DEFAULT_MAX_P2P_ATTEMPTS

    @classmethod
    def from_config(cls, p2p_config: dict) -> "SchedulingPolicy":
        cfg = p2p_config or {}
        return cls(
            urgent_margin_s=cfg.get("urgent_margin_s", DEFAULT_URGENT_MARGIN_S),
            p2p_budget_fraction=cfg.get("p2p_budget_fraction",
                                        DEFAULT_P2P_BUDGET_FRACTION),
            p2p_budget_cap_ms=cfg.get("p2p_budget_cap_ms",
                                      DEFAULT_P2P_BUDGET_CAP_MS),
            p2p_budget_floor_ms=cfg.get("p2p_budget_floor_ms",
                                        DEFAULT_P2P_BUDGET_FLOOR_MS),
            max_p2p_attempts=cfg.get("max_p2p_attempts",
                                     DEFAULT_MAX_P2P_ATTEMPTS))


@dataclass(frozen=True)
class Decision:
    """What the agent should do for one foreground request."""

    use_p2p: bool
    p2p_budget_ms: float = 0.0  # how long P2P may run before CDN failover


def decide(policy: SchedulingPolicy, *, margin_s: Optional[float],
           holder_count: int, download_on: bool) -> Decision:
    """Pick the source for a foreground segment request.

    ``margin_s`` is the playback slack: fragment start time minus
    current playhead, in seconds; ``None`` when the playhead is
    unknown (no media element yet) — treated as comfortable, since
    nothing is being consumed yet.
    """
    if not download_on or holder_count == 0:
        return Decision(use_p2p=False)
    if margin_s is not None and margin_s < policy.urgent_margin_s:
        return Decision(use_p2p=False)

    if margin_s is None:
        budget = policy.p2p_budget_cap_ms
    else:
        budget = min(margin_s * 1000.0 * policy.p2p_budget_fraction,
                     policy.p2p_budget_cap_ms)
    return Decision(use_p2p=True,
                    p2p_budget_ms=max(budget, policy.p2p_budget_floor_ms))
