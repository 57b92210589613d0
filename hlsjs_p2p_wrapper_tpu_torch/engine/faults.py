"""Fault plane and recovery policy of the chunked dispatch, copied from
the reference's ``engine/faults.py``: :class:`InjectedFault`,
:func:`classify_error`, :class:`FaultPlan` and :class:`FaultPolicy`,
with the same message templates, tokens and ``_NEVER_RETRY`` types.

The plan injects ``kind@group:chunk[xN]`` faults at the top of every
dispatch attempt (``ops/dispatch.py``); the policy classifies a
failure by its message (``"oom"``, ``"transient"``, ``"timeout"``, or
None to re-raise), backs off with seeded jitter and counts each retry,
bisection and give-up as ``dispatch_faults{reason,action}`` in its
registry (``engine/telemetry.py``).  PyTorch's CUDA out-of-memory error
(``torch.OutOfMemoryError``, "CUDA out of memory. ...") carries the
token ``"out of memory"`` and is classified ``"oom"``; the port's own
kernel launch failure ("... launch failed: CUDA error N") carries no
token and re-raises.
"""

from __future__ import annotations

import os
import random
import signal
import time
from typing import Optional

from .telemetry import MetricsRegistry

#: injectable fault kinds (the failure modes accelerator hosts
#: actually throw at long sweeps)
OOM = "oom"
TRANSIENT = "transient"
TIMEOUT = "timeout"
KILL = "kill"
FAULT_KINDS = (OOM, TRANSIENT, TIMEOUT, KILL)

#: message templates that MIMIC the real XLA error text, so injected
#: faults and real faults flow through the same classifier
_FAULT_MESSAGES = {
    OOM: ("RESOURCE_EXHAUSTED: injected fault: out of memory while "
          "allocating the batch state for group {group} chunk {chunk}"),
    TRANSIENT: ("INTERNAL: injected fault: transient runtime failure "
                "dispatching group {group} chunk {chunk}"),
    TIMEOUT: ("DEADLINE_EXCEEDED: injected fault: dispatch of group "
              "{group} chunk {chunk} timed out"),
}

#: error-message tokens → fault reason.  Ordered: OOM before the
#: transient catch-alls (an OOM report can mention INTERNAL frames).
_OOM_TOKENS = ("RESOURCE_EXHAUSTED", "Resource exhausted",
               "out of memory", "Out of memory", "OOM")
_TIMEOUT_TOKENS = ("DEADLINE_EXCEEDED", "deadline exceeded",
                   "timed out", "timeout")
_TRANSIENT_TOKENS = ("UNAVAILABLE", "ABORTED", "CANCELLED",
                     "INTERNAL", "preempt", "connection reset")

#: exception types recovery must NEVER swallow: these are programming
#: errors (shapes, types, contracts), not infrastructure weather —
#: retrying them can only hide a bug
_NEVER_RETRY = (TypeError, ValueError, KeyError, IndexError,
                AttributeError, AssertionError, NotImplementedError)


class InjectedFault(RuntimeError):
    """A fault the plan injected; ``kind`` short-circuits the
    classifier so tests never depend on message parsing."""

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind


def classify_error(exc: BaseException) -> Optional[str]:
    """Map an exception to a recovery reason (``"oom"`` /
    ``"transient"`` / ``"timeout"``) or ``None`` (not recoverable —
    re-raise).  Classification is by message token, the only surface
    the XLA runtime exposes stably across jaxlib versions; obvious
    programming errors (``ValueError`` & friends) are never
    classified no matter what their message says."""
    if isinstance(exc, InjectedFault):
        return exc.kind if exc.kind != KILL else None
    if isinstance(exc, _NEVER_RETRY):
        return None
    msg = str(exc)
    if any(tok in msg for tok in _OOM_TOKENS):
        return OOM
    if any(tok in msg for tok in _TIMEOUT_TOKENS):
        return TIMEOUT
    if any(tok in msg for tok in _TRANSIENT_TOKENS):
        return TRANSIENT
    return None


class FaultPlan:
    """Deterministic fault schedule: ``(kind, group, chunk, count)``
    specs, consumed as the dispatch engine reaches each coordinate.

    A spec fires on the first ``count`` dispatch ATTEMPTS at its
    ``(group, chunk)`` coordinate — so ``transient@0:2x3`` makes the
    first three attempts of group 0's chunk 2 fail (recovered within
    the default budget of 3 retries; ``x4`` would exhaust it), and
    ``oom@0:1x2`` OOMs the original chunk AND its first bisected
    half, exercising recursive bisection.  Coordinates are the
    engine's (group index,
    group-local chunk index) pair; sub-dispatches born from
    bisection/retry keep their parent chunk's coordinate."""

    def __init__(self, specs):
        self.specs = [dict(spec) for spec in specs]
        for spec in self.specs:
            if spec["kind"] not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {spec['kind']!r}"
                                 f" (one of {FAULT_KINDS})")
            spec.setdefault("count", 1)

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """``"oom@0:1,transient@0:2x3,kill@0:4"`` →
        kind ``oom`` at (group 0, chunk 1) once, three transients at
        (0, 2), a process SIGKILL at (0, 4)."""
        specs = []
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                kind, coord = part.split("@")
                count = 1
                if "x" in coord.split(":")[1]:
                    coord, count = coord.rsplit("x", 1)
                group, chunk = coord.split(":")
                specs.append({"kind": kind.strip(),
                              "group": int(group), "chunk": int(chunk),
                              "count": int(count)})
            except (ValueError, IndexError):
                raise ValueError(
                    f"bad fault spec {part!r} (want kind@group:chunk"
                    f"[xCOUNT], kind one of {FAULT_KINDS})") from None
        return cls(specs)

    def pop(self, group: int, chunk: int) -> Optional[str]:
        """The fault kind to fire at this coordinate (decrements the
        matching spec's remaining count), or None."""
        for spec in self.specs:
            if (spec["group"] == group and spec["chunk"] == chunk
                    and spec["count"] > 0):
                spec["count"] -= 1
                return spec["kind"]
        return None

    def remaining(self) -> int:
        return sum(spec["count"] for spec in self.specs)


class FaultPolicy:
    """The recovery policy the dispatch engine threads through
    (``run_groups_chunked(faults=...)``): classification, bounded
    jittered backoff, per-(reason, action) telemetry — plus the
    optional :class:`FaultPlan` injection hook.

    ``registry`` receives ``dispatch_faults{reason,action}`` counters
    (actions: ``retry`` / ``bisect`` / ``giveup``); a private
    registry is created when none is injected so call sites stay
    unconditional (the telemetry module's convention).  ``sleep`` and
    ``seed`` make the backoff schedule fully deterministic under
    test."""

    def __init__(self, plan: Optional[FaultPlan] = None, *,
                 max_retries: int = 3, backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0, jitter: float = 0.5,
                 seed: int = 0,
                 registry: Optional[MetricsRegistry] = None,
                 sleep=time.sleep):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.plan = plan
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.jitter = jitter
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._rng = random.Random(seed)
        self._sleep = sleep

    # -- the fault plane ------------------------------------------------

    def before_dispatch(self, *, group: int, chunk: int) -> None:
        """Injection point: called at the top of EVERY dispatch
        attempt (retries and bisected halves included, under their
        parent chunk's coordinate)."""
        if self.plan is None:
            return
        kind = self.plan.pop(group, chunk)
        if kind is None:
            return
        if kind == KILL:
            # the preemption model: the host dies NOW, mid-sweep,
            # with no chance to flush or finalize — exactly what the
            # journal + row cache must survive (tools/chaos_gate.py)
            os.kill(os.getpid(), signal.SIGKILL)
        raise InjectedFault(kind, _FAULT_MESSAGES[kind].format(
            group=group, chunk=chunk))

    # -- classification + accounting ------------------------------------

    def classify(self, exc: BaseException) -> Optional[str]:
        return classify_error(exc)

    def record(self, reason: str, action: str) -> None:
        self.registry.counter("dispatch_faults", reason=reason,
                              action=action).inc()

    def fault_counts(self) -> dict:
        """``{"reason|action": count}`` — the summary surface the
        tools print and the chaos gate asserts on."""
        return {f"{labels['reason']}|{labels['action']}": value
                for labels, value in
                self.registry.series("dispatch_faults")}

    # -- backoff --------------------------------------------------------

    def backoff_s(self, attempt: int) -> float:
        """Jittered exponential delay for retry number ``attempt``
        (0-based): ``min(cap, base·2^attempt)`` stretched by up to
        ``jitter`` — the jitter de-synchronizes a fleet of sweep
        processes retrying against one recovering host."""
        base = min(self.backoff_cap_s,
                   self.backoff_base_s * (2.0 ** attempt))
        return base * (1.0 + self.jitter * self._rng.random())

    def sleep_backoff(self, attempt: int) -> float:
        delay = self.backoff_s(attempt)
        self._sleep(delay)
        return delay
