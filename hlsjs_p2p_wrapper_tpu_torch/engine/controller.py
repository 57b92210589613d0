# A copy of the reference's engine/controller.py (hlsjs_p2p_wrapper_tpu/engine/controller.py): the
# same names, decisions and checkpoint bytes; the imports point at the
# port's own modules, the forecasts run on ``device`` (the card when
# None) through the port's dispatch, and a few comments no longer cite the
# reference's history.
"""Live control plane: the forecast-driven controller that closes the
observe → predict → actuate loop.

The reference wrapper steers a P2P swarm's delivery policy one
browser tab at a time (PAPER.md §0); everything this repo built since
exists to do it GLOBALLY — the flight-recorder event stream to
observe with, the sharded tracker to push knobs through, the
self-healing wire to survive on, the warm-started dispatch engine to
forecast with, and the calibrated twin that gives every forecast a
MEASURED error bar.  This module is the loop itself.  Each control tick:

1. **observe** — :class:`ObservationIngest` tail-follows the live
   flight-recorder shard — or a fleet's shard LIST, merged on the
   virtual window clock by :class:`~.twinframe.ShardMuxFollower`
   with explicit per-shard watermarks (torn-tail tolerant per shard,
   the journal reader's discipline) — and reduces the ``twin.*``
   provenance + membership events through the shared frame reducer:
   EXACTLY :func:`~.twinframe.frames_from_events`' window
   partitioning, incrementally; one closed (merged) observation
   window is one control tick, and the decisions are bit-identical
   whether the traffic arrives as one shard or split across four.
2. **predict** — observed membership becomes a forecast scenario
   (``testing/twin.scenario_from_observation``: observed joins AND
   departures on the calibrated parity mapping's lanes, absent lanes
   parked past the horizon so the compiled program shape never
   changes), and the
   candidate-knob lattice around the current config becomes ONE
   ``stream_groups_chunked`` dispatch of the row-cache misses — a
   warm tick whose membership stopped changing dispatches nothing.
3. **decide** — :func:`decide_tick`, a pure function: candidates are
   ranked under the explicit :class:`~.search.Constraint` (the
   search's grammar), and the DO-NO-HARM rule holds the current config
   unless the forecast improvement clears the committed twin band
   (``TWIN_r10.json``): the deciding metric's delta must exceed
   ``atol + rtol·max(|a|, |b|)`` — the twin's own divergence
   tolerance, so the controller never acts on a difference the twin
   cannot measure.  Every decision NAMES the band it cleared (or
   held inside); hysteresis additionally vetoes actuations closer
   than ``hysteresis_ticks`` to the previous one.
4. **actuate** — the knob update rides the tracker's Announce/Peers
   channel as a ``SET_KNOBS`` publish (engine/protocol.py): epochs
   are strictly monotone, the tracker piggybacks the current epoch
   on every answered announce, clients apply idempotently by epoch,
   and the reconnect listener's immediate re-announce converges
   healed links automatically.

Every tick bumps the ``control.*`` registry families, emits a flushed
``control_tick`` flight-recorder mark, and checkpoints the controller
state atomically (digest-checked, the search-checkpoint discipline) —
a SIGKILL'd controller resumes by replaying the shard through the
same reducers, re-derives the identical decision sequence, and never
re-actuates a stale epoch (the checkpoint's epoch floor, the
actuator's idempotency, and the tracker's monotonicity each
independently refuse it).  ``tools/control.py`` is the service CLI;
``tools/control_gate.py`` / ``make control-gate`` is the proof.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .artifact_cache import _digest, atomic_write_json
from .protocol import (CtrlLease, CtrlLeaseAck, KnobUpdate, SetKnobs,
                       decode, encode)
from .search import Constraint, rank_key
from .telemetry import MetricsRegistry
# ShardFollower lives in engine/twinframe.py (the mux reuses its
# torn-tail discipline per shard); re-exported here
from .twinframe import (FRAME_COLUMNS, ShardFollower,
                        ShardMuxFollower)

__all__ = ["ShardFollower", "ObservationIngest", "ControlConfig",
           "ControlLoop", "TransportActuator", "LogActuator",
           "LeaseClient", "HAActuator",
           "band_halfwidth", "decide_tick", "control_checkpoint_path",
           "TICK_PHASES"]

#: the tick phases whose walls the loop records (bench.py
#: ``detail.control_tick`` reads them): observe → predict → decide →
#: actuate, plus the checkpoint write
TICK_PHASES = ("ingest", "reconstruct", "forecast", "decide",
               "actuate", "checkpoint")


class ObservationIngest:
    """The observe leg: shard tail-follow + the incremental frame
    reducer, for ONE shard or a FLEET of them.  ``shard_paths`` may
    be a single path (the single-shard signature) or a
    list — the fleet case, merged on the virtual window clock by
    :class:`~.twinframe.ShardMuxFollower` with explicit per-shard
    watermarks, so the controller's decisions are bit-identical
    whether the same traffic arrives as one shard or split across
    four (``make slo-gate`` asserts exactly that).  ``poll()``
    returns the frame rows whose merged windows closed since the
    last poll, :meth:`membership_at` exposes the per-window observed
    join/leave snapshots the forecast scenario is reconstructed
    from, and :attr:`exclusions` records which shards each window
    closed WITHOUT (a dead shard is excluded-and-counted, never
    silently merged)."""

    def __init__(self, shard_paths, source: str = "real", *,
                 dead_after_polls: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None,
                 per_shard: bool = False):
        paths = ([shard_paths] if isinstance(shard_paths, str)
                 else list(shard_paths))
        self.mux = ShardMuxFollower(
            paths, source=source, dead_after_polls=dead_after_polls,
            registry=registry, per_shard=per_shard)

    @property
    def rows(self) -> List[Tuple[float, ...]]:
        return self.mux.rows

    @property
    def memberships(self):
        return self.mux.memberships

    @property
    def exclusions(self) -> List[Tuple[str, ...]]:
        return self.mux.exclusions

    @property
    def shard_rows(self):
        return self.mux.shard_rows

    @property
    def peer_stall(self) -> List[Dict[str, float]]:
        return self.mux.peer_stall

    @property
    def peer_p2p(self) -> List[Dict[str, float]]:
        return self.mux.peer_p2p

    def poll(self) -> List[Tuple[float, ...]]:
        return self.mux.poll()

    def membership_at(self, window: int) \
            -> Tuple[Dict[str, float], Dict[str, float]]:
        return self.mux.membership_at(window)


@dataclass
class ControlConfig:
    """Everything one controller identity is: the world model the
    forecasts run on (a ``testing/twin.TwinScenario``), the
    candidate-knob lattice, the constraint, and the committed twin
    bands the do-no-harm rule inherits.  JSON round-trippable — the
    CLI ships it as a spec file, and the checkpoint digest covers it
    so a resumed controller can never replay a different
    controller's decisions."""

    spec: object                      # testing/twin.TwinScenario
    knob_grid: Dict[str, List[float]]
    initial_knobs: Dict[str, float]
    constraint: Constraint
    bands: Dict[str, dict]            # metric -> {rtol, atol, ...}
    band_set: str = "clean"           # which TWIN_r10 scenario's bands
    swarm_id: str = ""
    warmup_windows: int = 2
    hysteresis_ticks: int = 2
    forecast_chunk: int = 8
    #: SLO-burn trigger (engine/slo.py): SLOSpec dicts evaluated
    #: INSIDE the tick — a burn-rate alert forces candidate
    #: evaluation even when the forecast holds in-band, and the
    #: decision names the trigger that fired.  None keeps the
    #: pre-0.20 forecast-band-only controller.
    slo_specs: Optional[List[dict]] = None
    #: peer id -> cohort name, the alert-attribution map (peers
    #: absent from it fall into the ``all`` cohort)
    cohorts: Optional[Dict[str, str]] = None
    #: SLO judgment's own warmup (None → ``warmup_windows``): the
    #: join/fill phase legitimately misses delivery objectives, and
    #: it outlasts the controller's shorter forecast warmup — a
    #: startup-window alert would be the clean-run false actuation
    #: the fleet gate forbids
    slo_warmup_windows: Optional[int] = None

    def lattice(self) -> List[Dict[str, float]]:
        """The candidate-knob lattice: the cartesian product of the
        grid axes, in deterministic axis-sorted order.  Fixed across
        ticks, so revisited candidates are layer-2 row-cache hits."""
        names = sorted(self.knob_grid)
        points = []
        for values in itertools.product(
                *(self.knob_grid[n] for n in names)):
            points.append({n: float(v)
                           for n, v in zip(names, values)})
        return points

    def identity(self) -> dict:
        """The digest material (what changes a decision)."""
        spec = self.spec
        spec_dict = {f: getattr(spec, f)
                     for f in ("seed", "n_peers", "wave_peers",
                               "frag_count", "seg_duration_s",
                               "cdn_bps", "uplink_bps", "watch_s",
                               "window_s", "cdn_latency_ms")}
        spec_dict["level_bitrates"] = list(spec.level_bitrates)
        out = {
            "kind": "control-loop", "spec": spec_dict,
            "knob_grid": {k: list(v)
                          for k, v in sorted(self.knob_grid.items())},
            "initial_knobs": dict(sorted(self.initial_knobs.items())),
            "constraint": [self.constraint.metric,
                           self.constraint.bound,
                           self.constraint.objective],
            "bands": self.bands, "band_set": self.band_set,
            "swarm_id": self.swarm_id,
            "warmup_windows": self.warmup_windows,
            "hysteresis_ticks": self.hysteresis_ticks,
        }
        # only an SLO-armed controller digests its SLO identity —
        # pre-0.20 identity dicts (and so their checkpoint digests)
        # stay byte-identical
        if self.slo_specs:
            out["slo_specs"] = [dict(sorted(spec.items()))
                                for spec in self.slo_specs]
            out["cohorts"] = dict(sorted(
                (self.cohorts or {}).items()))
            out["slo_warmup_windows"] = (
                self.warmup_windows if self.slo_warmup_windows is None
                else self.slo_warmup_windows)
        return out


def band_halfwidth(bands: Dict[str, dict], metric: str,
                   a: float, b: float) -> float:
    """The twin's own divergence tolerance between two values of one
    metric (``detect_band_divergence``'s formula): the smallest
    difference the calibrated twin can distinguish from sim/real
    disagreement.  A forecast improvement below this is noise by the
    twin's OWN measurement, and the do-no-harm rule refuses it."""
    band = bands.get(metric, {})
    return (float(band.get("atol", 0.0))
            + float(band.get("rtol", 0.0)) * max(abs(a), abs(b)))


def decide_tick(trials: List[dict], current_knobs: Dict[str, float],
                constraint: Constraint, bands: Dict[str, dict],
                band_set: str,
                burn_alert: Optional[dict] = None) -> dict:
    """The pure decision function: one tick's forecast trials →
    ``{action, knobs, band, trigger, ...}``.  ``trials`` carry
    ``knobs`` + the metric fields (the Evaluator contract); exactly
    one trial's knobs must equal ``current_knobs`` (the lattice
    always contains the current config).

    The do-no-harm rule: the best-ranked candidate is actuated ONLY
    when its improvement over the current config — on the deciding
    metric the constraint grammar implies — clears the committed
    twin band (:func:`band_halfwidth`).  A candidate that would
    trade the current config's feasibility away is refused outright.
    The returned decision always names the band it cleared or held
    inside, and the TRIGGER that fired it: ``forecast_band`` when
    the band cleared, ``slo_burn`` when a burn-rate alert
    (``burn_alert``, an :class:`~.slo.SLOEvaluator` alert dict)
    forced the best candidate through a hold — the fleet is
    measurably burning its error budget, so a difference the twin
    cannot distinguish is still worth acting on.  Burn never forces
    an infeasible candidate, and never invents one: with the best
    candidate equal to the current config there is nothing to
    actuate and the burn is recorded on a hold."""
    current = next(t for t in trials
                   if t["knobs"] == current_knobs)
    alert_note = None if burn_alert is None else {
        "slo": burn_alert.get("slo"),
        "burn_fast": burn_alert.get("burn_fast"),
        "burn_slow": burn_alert.get("burn_slow"),
        "worst_shard": burn_alert.get("worst_shard"),
        "worst_cohort": burn_alert.get("worst_cohort"),
    }
    if current.get("failed"):
        # the current config's OWN forecast failed: there is no
        # baseline to measure a banded improvement against, and
        # violation() on its None metrics would be infinite — an
        # unconditional actuation.  Do-no-harm degrades to a hold.
        return {
            "action": "hold", "reason": "current_forecast_failed",
            "knobs": dict(current_knobs),
            "band": {"set": band_set, "metric": None,
                     "halfwidth": None, "delta": None},
            "headroom": None, "trigger": None,
            "slo_alert": alert_note,
        }
    ranked = sorted(
        (t for t in trials if not t.get("failed")),
        key=lambda t: rank_key(t, constraint))
    best = ranked[0] if ranked else current
    cur_feas = constraint.feasible(current)
    best_feas = constraint.feasible(best)
    infeasible_best = False
    if best_feas and cur_feas:
        metric = constraint.objective
        delta = (best.get(metric) or 0.0) - (current.get(metric)
                                             or 0.0)
    elif best_feas or not cur_feas:
        # feasibility gained, or both infeasible: the constrained
        # metric decides (violation must measurably shrink)
        metric = constraint.metric
        delta = constraint.violation(current) \
            - constraint.violation(best)
    else:
        # best is infeasible while current is feasible: never trade
        # feasibility away, whatever the objective promises
        metric = constraint.metric
        delta = 0.0
        infeasible_best = True
    halfwidth = band_halfwidth(bands, metric,
                               best.get(metric) or 0.0,
                               current.get(metric) or 0.0)
    cleared = delta > halfwidth and best["knobs"] != current_knobs
    trigger = "forecast_band" if cleared else None
    if (not cleared and burn_alert is not None
            and not infeasible_best
            and best["knobs"] != current_knobs):
        # SLO-burn override of the band hold: the fleet is burning
        # its error budget faster than the alert threshold on BOTH
        # burn windows, so the best-ranked candidate is actuated
        # even though the forecast difference sits inside the twin
        # band (do-no-harm guards against acting on NOISE; a
        # measured burn is signal from the real fleet, not noise)
        cleared = True
        trigger = "slo_burn"
    headroom = constraint.bound - ((best if cleared else current)
                                   .get(constraint.metric) or 0.0)
    return {
        "action": "actuate" if cleared else "hold",
        "reason": None if cleared else (
            "best_is_current" if best["knobs"] == current_knobs
            else ("infeasible_best" if infeasible_best else "band")),
        "trigger": trigger, "slo_alert": alert_note,
        "knobs": dict(best["knobs"]) if cleared
        else dict(current_knobs),
        "band": {"set": band_set, "metric": metric,
                 "rtol": float(bands.get(metric, {}).get("rtol", 0.0)),
                 "atol": float(bands.get(metric, {}).get("atol", 0.0)),
                 "halfwidth": round(halfwidth, 6),
                 "delta": round(delta, 6)},
        "forecast": {
            "best": {"knobs": dict(best["knobs"]),
                     "offload": best.get("offload"),
                     "rebuffer": best.get("rebuffer")},
            "current": {"offload": current.get("offload"),
                        "rebuffer": current.get("rebuffer")},
        },
        "headroom": round(headroom, 6),
    }


class TransportActuator:
    """Actuation over the live tracker channel: SET_KNOBS frames from
    the controller's own transport endpoint, acked by KNOB_UPDATE.
    Idempotent by construction — the tracker refuses stale epochs —
    and non-blocking: :meth:`actuate`'s True means the frame was
    handed to the transport, NOT that the tracker accepted it.  The
    loop's convergence republish closes that gap for lost frames; a
    tracker REFUSAL is visible too — the ack then carries an epoch
    below the one we published (stale publish, or the knob-swarm cap)
    and is counted ``control.publish_refusals`` with
    :attr:`refused_epoch` recording the publish it rejected."""

    def __init__(self, endpoint, swarm_id: str,
                 tracker_peer_id: str = "tracker",
                 registry: Optional[MetricsRegistry] = None):
        self.endpoint = endpoint
        self.swarm_id = swarm_id
        self.tracker_peer_id = tracker_peer_id
        self.registry = registry
        self.acked_epoch = 0
        self.acked_knobs: tuple = ()
        self.published_epoch = 0
        self.refused_epoch = 0
        endpoint.on_receive = self._on_frame

    def _on_frame(self, src_id: str, frame: bytes) -> None:
        if src_id != self.tracker_peer_id:
            return
        try:
            msg = decode(frame)
        except Exception:  # fault-ok: a malformed ack is ignorable
            return
        if not isinstance(msg, KnobUpdate) \
                or msg.swarm_id != self.swarm_id:
            return
        if msg.epoch >= self.acked_epoch:
            # a stale ack (reordered across a heal/republish window)
            # must not pair an old knob tuple with a newer epoch
            self.acked_epoch = msg.epoch
            self.acked_knobs = msg.knobs
        if msg.epoch < self.published_epoch \
                and self.refused_epoch < self.published_epoch:
            # the tracker answered a publish with an OLDER epoch:
            # that publish was refused (stale or cap), counted once
            self.refused_epoch = self.published_epoch
            if self.registry is not None:
                self.registry.counter(
                    "control.publish_refusals").inc()

    def actuate(self, epoch: int, knobs: Dict[str, float],
                generation: int = 0) -> bool:
        wire = tuple(sorted((name, float(value))
                            for name, value in knobs.items()))
        self.published_epoch = max(self.published_epoch, epoch)
        return bool(self.endpoint.send(
            self.tracker_peer_id,
            encode(SetKnobs(self.swarm_id, epoch, wire,
                            generation))))


class LeaseClient:
    """One controller's handle on the tracker-arbitrated controller
    lease (``CTRL_LEASE`` / ``CTRL_LEASE_ACK`` on the announce
    channel — the fabric WorkLedger's claim / renew / steal
    semantics ported to the control plane).  :meth:`request` sends
    one claim-or-renewal; acks arrive through the shared endpoint's
    receive hook (this client CHAINS the hook the actuator already
    installed, so one endpoint serves both planes) and update:

    - :attr:`is_leader` / :attr:`generation` — whether the tracker
      currently grants US the lease, and at which generation (what
      the leader stamps into every SET_KNOBS it publishes — the
      tracker's fencing floor);
    - :attr:`leader_id` / :attr:`leader_generation` /
      :attr:`remaining_ttl_ms` — the tracker's view of the holder
      (the console's leader-identity panel);
    - :attr:`knob_epoch` — the swarm's current knob epoch, piggy-
      backed on every ack: the STANDBY's fleet watermark, gating its
      shadow ticks so it never runs ahead of what the leader
      actually landed.

    All lease judgement is the TRACKER's (its injectable clock, its
    generation counter) — two controllers never compare wall clocks
    with each other, which is the whole point of the arbitration.
    Counted ``control.lease.acks{result=granted|renewed|refused}``
    and ``control.lease.transitions{to=leader|standby}``; every ack
    lands as an eagerly-flushed ``lease`` flight-recorder event when
    a recorder is armed."""

    def __init__(self, endpoint, swarm_id: str, controller_id: str,
                 *, tracker_peer_id: str = "tracker",
                 ttl_ms: float = 2_000.0,
                 registry: Optional[MetricsRegistry] = None,
                 recorder=None):
        self.endpoint = endpoint
        self.swarm_id = swarm_id
        self.controller_id = controller_id
        self.tracker_peer_id = tracker_peer_id
        self.ttl_ms = float(ttl_ms)
        self.registry = registry
        self.recorder = recorder
        self.is_leader = False
        self.generation = 0
        self.leader_id: Optional[str] = None
        self.leader_generation = 0
        self.remaining_ttl_ms = 0.0
        self.knob_epoch = 0
        self._chain = getattr(endpoint, "on_receive", None)
        endpoint.on_receive = self._on_frame

    def request(self) -> bool:
        """Send one lease claim/renewal (generation 0 until first
        granted — the fresh-claim form; afterwards the granted
        generation, the renewal form).  True means handed to the
        transport; the ack arrives asynchronously."""
        return bool(self.endpoint.send(
            self.tracker_peer_id,
            encode(CtrlLease(self.swarm_id, self.controller_id,
                             self.generation, int(self.ttl_ms)))))

    def assume(self, generation: int) -> None:
        """CHAOS HOOK: believe we hold the lease at ``generation``
        without asking the tracker — the resurrected-zombie-leader
        harness (tools/fleet_control_gate.py) uses it to prove the
        tracker's generation fencing refuses exactly this client-side
        delusion.  Never called by the service path."""
        self.is_leader = True
        self.generation = int(generation)

    def _on_frame(self, src_id: str, frame: bytes) -> None:
        if src_id == self.tracker_peer_id:
            try:
                msg = decode(frame)
            except Exception:  # fault-ok: counted, chain decides
                if self.registry is not None:
                    self.registry.counter(
                        "control.lease.decode_rejects").inc()
                msg = None
            if isinstance(msg, CtrlLeaseAck) \
                    and msg.swarm_id == self.swarm_id:
                self._on_ack(msg)
                return
        if self._chain is not None:
            self._chain(src_id, frame)

    def _on_ack(self, msg: CtrlLeaseAck) -> None:
        self.leader_id = msg.leader_id
        self.leader_generation = msg.generation
        self.remaining_ttl_ms = float(msg.ttl_ms)
        if msg.knob_epoch > self.knob_epoch:
            self.knob_epoch = msg.knob_epoch
        leading = bool(msg.granted
                       and msg.leader_id == self.controller_id)
        if leading:
            result = ("renewed" if self.is_leader
                      and msg.generation == self.generation
                      else "granted")
            self.generation = msg.generation
        else:
            result = "refused"
        if self.registry is not None:
            self.registry.counter("control.lease.acks",
                                  result=result).inc()
            if leading != self.is_leader:
                self.registry.counter(
                    "control.lease.transitions",
                    to="leader" if leading else "standby").inc()
            self.registry.gauge("control.lease.generation").set(
                msg.generation)
        if self.recorder is not None:
            self.recorder.lease(
                result, unit=0, gen=msg.generation,
                scope="ctrl", swarm=self.swarm_id,
                leader=msg.leader_id,
                ttl_ms=int(msg.ttl_ms), knob_epoch=msg.knob_epoch)
        self.is_leader = leading


class HAActuator:
    """Leader-fenced actuation for a hot controller pair.  The
    LEADER publishes through the inner :class:`TransportActuator`
    with its lease generation stamped into the frame (the tracker
    refuses any generation below the lease's — a deposed leader's
    publishes are refused-and-counted server-side, whatever this
    client believes).  A STANDBY never publishes: it SHADOW-applies
    an epoch the fleet watermark (:attr:`LeaseClient.knob_epoch`)
    proves the leader already landed — returning True so its derived
    decision prefix stays bit-identical to the leader's recorded one
    (counted ``control.shadow_applies``) — and refuses an epoch
    BEYOND the watermark (counted ``control.publish_fenced``; the
    standby's tick gate pauses the loop before this can happen, so
    the refusal is the belt to that suspender).

    :attr:`acked_epoch` folds the lease watermark into the inner
    actuator's ack view: an epoch the tracker reports on the lease
    channel IS landed, so neither role issues a convergence
    republish for it."""

    def __init__(self, inner: TransportActuator, lease: LeaseClient,
                 registry: Optional[MetricsRegistry] = None):
        self.inner = inner
        self.lease = lease
        self.registry = registry

    @property
    def acked_epoch(self) -> int:
        return max(self.inner.acked_epoch, self.lease.knob_epoch)

    @property
    def role(self) -> str:
        """Stamped into the durable ``actuation`` mark: the fleet
        gate's exactly-once proof counts PUBLISHES (leader-role
        marks), not the standby's shadow re-derivations of the same
        epochs."""
        return "leader" if self.lease.is_leader else "standby"

    def publishes(self, epoch: int) -> bool:
        """Would :meth:`actuate` reach the wire for ``epoch``?  The
        control loop consults this before emitting the durable
        ``actuation`` intent mark, so the merged fleet stream holds
        EXACTLY one intent per published epoch (a shadow-applied or
        replayed epoch re-derives the decision without re-marking —
        the marks are the gate's per-epoch publish witnesses)."""
        return self.lease.is_leader and epoch > self.acked_epoch

    def actuate(self, epoch: int, knobs: Dict[str, float]) -> bool:
        if epoch <= self.acked_epoch:
            # the fleet watermark proves this epoch already landed:
            # BOTH roles re-derive it silently.  This is the takeover
            # replay path — the new leader re-deriving the dead
            # leader's prefix must never republish it (the duplicate
            # this layer exists to prevent), only the NEXT epoch.
            if self.registry is not None:
                self.registry.counter("control.shadow_applies").inc()
            return True
        if self.lease.is_leader:
            return self.inner.actuate(
                epoch, knobs, generation=self.lease.generation)
        if self.registry is not None:
            self.registry.counter("control.publish_fenced",
                                  role="standby").inc()
        return False


class LogActuator:
    """Actuation into an append-only fsync'd JSONL log — the replay
    mode's externally visible effect (and the gate's duplicate
    detector).  Idempotent by epoch: an epoch already in the log is
    NOT re-appended, which is exactly the guard that makes a
    SIGKILL between actuation and checkpoint safe to resume
    through."""

    def __init__(self, path: str):
        self.path = path
        self._seen = set()
        if os.path.exists(path):
            with open(path, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        self._seen.add(int(
                            json.loads(line)["epoch"]))
                    except (ValueError, KeyError):
                        continue

    def publishes(self, epoch: int) -> bool:
        """Intent-mark gate (:meth:`HAActuator.publishes`): a resume
        replaying an epoch the log already holds re-derives it
        without re-marking."""
        return epoch not in self._seen

    @property
    def acked_epoch(self) -> int:
        """The log is fsync'd on append, so published IS acked —
        lets the log ride as :class:`HAActuator`'s inner leg."""
        return max(self._seen, default=0)

    def actuate(self, epoch: int, knobs: Dict[str, float],
                generation: int = 0) -> bool:
        if epoch in self._seen:
            return True  # already durably actuated: idempotent
        record = {"epoch": epoch,
                  "knobs": dict(sorted(knobs.items()))}
        if generation:
            record["generation"] = generation  # the publishing lease
        with open(self.path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(record) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        self._seen.add(epoch)
        return True

    def epochs(self) -> List[int]:
        if not os.path.exists(self.path):
            return []  # nothing ever published
        with open(self.path, encoding="utf-8") as fh:
            return [int(json.loads(line)["epoch"])
                    for line in fh if line.strip()]


def control_checkpoint_path(cache_dir: str,
                            config: "ControlConfig",
                            instance: str = "") -> str:
    """Checkpoint location for one controller identity: co-located
    with the search checkpoints under the warm-start root,
    content-addressed by the controller identity — two different
    controllers can never clobber each other's state.  ``instance``
    disambiguates an HA PAIR running the SAME identity (leader and
    standby re-derive identical decisions by design, but their
    checkpoints must never clobber each other through a shared
    cache): it suffixes the digest, so the empty default keeps every
    pre-HA path byte-identical."""
    digest = _digest(config.identity())
    name = digest + (f"-{instance}" if instance else "") + ".json"
    return os.path.join(cache_dir, "controllers", name)


class ControlLoop:
    """The service (module docstring).  Drive it with
    :meth:`run_available` after advancing the world (the gate's
    window-locked loop), or let the CLI poll it.  ``warm_start`` is
    the two-layer cache the forecast dispatches run against;
    ``recorder`` arms the flight-recorder marks; ``wall`` is the
    injectable phase-timing clock; ``device`` is where the forecasts
    run (the card when None)."""

    def __init__(self, config: ControlConfig, shard_path,
                 actuator, *, warm_start=None,
                 registry: Optional[MetricsRegistry] = None,
                 recorder=None, checkpoint_path: Optional[str] = None,
                 dead_after_polls: Optional[int] = None,
                 wall: Callable[[], float] = time.perf_counter,
                 tick_gate: Optional[Callable[[int], bool]] = None,
                 device=None):
        self.config = config
        self.device = device
        self.actuator = actuator
        self.warm_start = warm_start
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        #: ``shard_path`` may be one path or a list of them (the
        #: fleet ingest; ObservationIngest muxes on the window clock
        #: and the decisions are layout-independent by construction).
        #: An SLO-armed controller muxes per_shard for worst-shard
        #: alert attribution.
        self.ingest = ObservationIngest(
            shard_path, dead_after_polls=dead_after_polls,
            registry=self.registry,
            per_shard=bool(config.slo_specs))
        #: the SLO-burn trigger: evaluated INSIDE the tick so the
        #: decide leg sees the alert the same window it fires
        self.slo = None
        self._burn: Optional[dict] = None
        if config.slo_specs:
            from .slo import SLOEvaluator, SLOSpec
            cohorts = dict(config.cohorts or {})
            self.slo = SLOEvaluator(
                [SLOSpec.from_dict(d) for d in config.slo_specs],
                registry=self.registry, recorder=recorder,
                cohort_of=lambda peer: cohorts.get(peer, "all"),
                warmup_windows=(
                    config.warmup_windows
                    if config.slo_warmup_windows is None
                    else config.slo_warmup_windows))
        #: ``tick_gate(window) -> bool``: called before each tick;
        #: False BUFFERS the window (re-checked on the next
        #: run_available) instead of ticking it — how a hot STANDBY
        #: pauses at the fleet watermark so it never derives a
        #: decision the leader has not already landed, and resumes
        #: through the backlog the moment it takes over
        self._tick_gate = tick_gate
        self._pending: List[Tuple[int, Tuple[float, ...]]] = []
        self.recorder = recorder
        self.checkpoint_path = checkpoint_path
        self.digest = _digest(config.identity())
        self._wall = wall
        self.current_knobs = dict(config.initial_knobs)
        self.epoch = 0
        self.decisions: List[dict] = []
        self.last_actuation_tick = -10**9
        self.tick_stats: List[dict] = []
        self._lattice = config.lattice()
        if not any(p == config.initial_knobs for p in self._lattice):
            raise ValueError("initial_knobs must be a lattice point "
                             "(the controller only ever actuates "
                             "lattice points)")
        self._m_ticks = self.registry.counter("control.ticks")
        self._m_windows = self.registry.counter("control.windows")
        self._m_actuations = self.registry.counter(
            "control.actuations")
        self._g_epoch = self.registry.gauge("control.knob_epoch")
        self._g_headroom = self.registry.gauge("control.headroom")

    # -- persistence ----------------------------------------------------

    def checkpoint(self) -> None:
        if self.checkpoint_path is None:
            return
        atomic_write_json(self.checkpoint_path, {
            "digest": self.digest,
            "tick": len(self.decisions),
            "epoch": self.epoch,
            "current_knobs": self.current_knobs,
            "last_actuation_tick": self.last_actuation_tick,
            "decisions": self.decisions,
        })

    def resume(self) -> bool:
        """Restore from the checkpoint (digest-checked: a checkpoint
        written by a different controller configuration is refused,
        the search-resume contract).  The observation reducers are
        NOT checkpointed — the shard is replayed through them from
        the start, so the restored decision prefix is re-derived
        state, not trusted state."""
        if (self.checkpoint_path is None
                or not os.path.exists(self.checkpoint_path)):
            return False
        with open(self.checkpoint_path, encoding="utf-8") as fh:
            state = json.load(fh)
        if state.get("digest") != self.digest:
            raise ValueError(
                f"controller checkpoint {self.checkpoint_path} was "
                f"written by a different controller configuration — "
                f"not resuming against it")
        self.epoch = int(state["epoch"])
        self.current_knobs = dict(state["current_knobs"])
        self.decisions = [dict(d) for d in state["decisions"]]
        self.last_actuation_tick = int(state["last_actuation_tick"])
        self._g_epoch.set(self.epoch)
        return True

    # -- the loop -------------------------------------------------------

    def run_available(self) -> List[dict]:
        """Ingest everything new and tick once per closed window;
        returns the decisions made (resumed-prefix windows replay
        the recorded decision without re-forecasting — their
        decisions are already derived state, and their epochs are
        already actuated — but still feed the SLO evaluator, whose
        burn history is derived state too).  A ``tick_gate`` that
        answers False leaves the window (and everything after it)
        BUFFERED for a later call — ingest keeps draining the
        shards, so a paused standby stays hot, not behind."""
        t0 = self._wall()
        new_rows = self.ingest.poll()
        ingest_s = self._wall() - t0
        base = len(self.ingest.rows) - len(new_rows)
        self._pending.extend(
            (base + i, row) for i, row in enumerate(new_rows))
        made = []
        while self._pending:
            window, row = self._pending[0]
            if window < len(self.decisions):
                # resumed prefix: decision already derived; the SLO
                # history still replays (bit-identical by the same
                # argument as the decisions themselves)
                self._observe_slo(window, row)
                self._pending.pop(0)
                continue
            if self._tick_gate is not None \
                    and not self._tick_gate(window):
                break
            self._pending.pop(0)
            made.append(self._tick(window, row, ingest_s))
            ingest_s = 0.0  # charged to the first tick of the batch
        return made

    @property
    def pending_windows(self) -> int:
        """Closed-but-unticked windows (gate-paused backlog) — the
        console's standby-lag surface."""
        return len(self._pending)

    def _observe_slo(self, window: int,
                     row: Tuple[float, ...]) -> None:
        """Feed one closed window to the SLO evaluator and maintain
        the pending burn trigger: a rising-edge alert arms it, the
        alert's SLO dropping out of firing disarms it (an actuation
        consumes it — see :meth:`_tick`).  Pending-while-vetoed is
        deliberate: hysteresis may refuse the burn's first tick, and
        a budget still burning deserves the next one."""
        if self.slo is None:
            return
        shard_rows = None
        if self.ingest.shard_rows:
            shard_rows = {shard: rows[window]
                          for shard, rows
                          in self.ingest.shard_rows.items()}
        fired = self.slo.observe_window(
            row, shard_rows=shard_rows,
            peer_stall=self.ingest.peer_stall[window],
            peer_p2p=self.ingest.peer_p2p[window],
            excluded=self.ingest.exclusions[window])
        if fired:
            self._burn = fired[0]
        elif self._burn is not None:
            state = self.slo.state.get(self._burn.get("slo"), {})
            if not state.get("firing"):
                self._burn = None

    def _tick(self, window: int, row: Tuple[float, ...],
              ingest_s: float) -> dict:
        phases = {"ingest": ingest_s}
        self._m_ticks.inc()
        self._m_windows.inc()
        t_s = row[FRAME_COLUMNS.index("t_s")]
        self._observe_slo(window, row)

        if window < self.config.warmup_windows:
            phases.update(reconstruct=0.0, forecast=0.0, decide=0.0)
            decision = {
                "action": "hold", "reason": "warmup",
                "knobs": dict(self.current_knobs),
                "band": {"set": self.config.band_set, "metric": None,
                         "halfwidth": None, "delta": None},
                "headroom": None, "trigger": None,
                "slo_alert": None,
            }
        else:
            t0 = self._wall()
            from ..testing.twin import (forecast_group,
                                        scenario_from_observation)
            join_ms, leave_ms = self.ingest.membership_at(window)
            join_s, leave_s = scenario_from_observation(
                self.config.spec, join_ms, leave_ms)
            group = forecast_group(self.config.spec, join_s,
                                   self._lattice, leave_s=leave_s,
                                   device=self.device)
            phases["reconstruct"] = self._wall() - t0

            t0 = self._wall()
            trials = self._forecast(group)
            phases["forecast"] = self._wall() - t0

            t0 = self._wall()
            decision = decide_tick(trials, self.current_knobs,
                                   self.config.constraint,
                                   self.config.bands,
                                   self.config.band_set,
                                   burn_alert=self._burn)
            if decision["action"] == "actuate" and \
                    window - self.last_actuation_tick \
                    < self.config.hysteresis_ticks:
                # hysteresis veto: the forecast cleared the band but
                # the previous actuation is too recent — the swarm
                # has not converged enough to observe its effect
                decision["action"] = "veto"
                decision["reason"] = "hysteresis"
                decision["knobs"] = dict(self.current_knobs)
            phases["decide"] = self._wall() - t0

        decision["tick"] = window
        decision["t_s"] = round(t_s, 3)

        t0 = self._wall()
        if decision["action"] == "actuate":
            epoch = self.epoch + 1
            will_publish = getattr(self.actuator, "publishes", None)
            if self.recorder is not None and (
                    will_publish is None or will_publish(epoch)):
                # durable INTENT before the publish: a SIGKILL
                # between the knob publish and the checkpoint write
                # leaves this flushed event as the proof the epoch
                # was actuated — replay recovers it, so the window
                # the checkpoint misses can never double-actuate
                # fleet-wide (the fleet gate's exactly-once proof
                # reads these)
                self.recorder.mark(
                    "actuation", tick=window, epoch=epoch,
                    knobs=dict(sorted(decision["knobs"].items())),
                    trigger=decision.get("trigger"),
                    role=getattr(self.actuator, "role", "sole"))
                self.recorder.flush(fsync=False)
            if self.actuator.actuate(epoch, decision["knobs"]):
                self.epoch = epoch
                self.current_knobs = dict(decision["knobs"])
                self.last_actuation_tick = window
                self._m_actuations.inc()
                self._burn = None  # the burn trigger is consumed
            else:
                decision["action"] = "veto"
                decision["reason"] = "actuator_refused"
                self.registry.counter("control.vetoes",
                                      reason="actuator_refused").inc()
        elif self.epoch > 0 and getattr(self.actuator, "acked_epoch",
                                        self.epoch) < self.epoch:
            # convergence republish: the last publish has no tracker
            # ack yet (a chaos window may have eaten the SET_KNOBS
            # frame).  Re-sending the SAME epoch is idempotent end to
            # end — the tracker refuses it if the original landed,
            # clients gate on epoch — so this is pure repair, never a
            # new decision.
            self.actuator.actuate(self.epoch, self.current_knobs)
            self.registry.counter("control.republishes").inc()
        if decision["action"] == "hold":
            self.registry.counter("control.holds",
                                  reason=decision["reason"]).inc()
        elif decision["action"] == "veto" \
                and decision["reason"] == "hysteresis":
            self.registry.counter("control.vetoes",
                                  reason="hysteresis").inc()
        decision["epoch"] = self.epoch
        phases["actuate"] = self._wall() - t0

        self._g_epoch.set(self.epoch)
        if decision.get("headroom") is not None:
            self._g_headroom.set(decision["headroom"])
        self.decisions.append(decision)

        t0 = self._wall()
        self.checkpoint()
        phases["checkpoint"] = self._wall() - t0

        if self.recorder is not None:
            self.recorder.mark(
                "control_tick", tick=window,
                action=decision["action"], epoch=self.epoch,
                headroom=decision.get("headroom"),
                trigger=decision.get("trigger"),
                t_s=decision["t_s"])
            self.recorder.flush(fsync=False)
        self.tick_stats.append({"tick": window,
                                "action": decision["action"],
                                **{k: round(v, 6)
                                   for k, v in phases.items()}})
        return decision

    def _forecast(self, group) -> List[dict]:
        """One candidate-lattice forecast sweep: one
        ``stream_groups_chunked`` dispatch of the row-cache misses
        (the Evaluator contract from tools/optimize.py, inlined for
        the one-fidelity case)."""
        from ..ops.dispatch import stream_groups_chunked

        config, items, build = group
        spec = self.config.spec
        n_steps = int(round(spec.watch_s * 1000.0 / config.dt_ms))
        results: List[Optional[dict]] = [None] * len(items)
        stream = stream_groups_chunked(
            [group], n_steps, watch_s=spec.watch_s,
            chunk=min(self.config.forecast_chunk, len(items)),
            exact_chunk=True, warm_start=self.warm_start,
            trace=self.recorder)
        for event in stream:
            if event.metric is None:
                results[event.index] = {
                    "knobs": items[event.index], "offload": None,
                    "rebuffer": None, "failed": True,
                    "cached": False}
            else:
                results[event.index] = {
                    "knobs": items[event.index],
                    "offload": float(event.metric[0]),
                    "rebuffer": float(event.metric[1]),
                    "failed": False, "cached": bool(event.cached)}
            self.registry.counter(
                "control.forecast_rows",
                source="cache" if event.cached else "dispatch").inc()
        return [r for r in results if r is not None]
