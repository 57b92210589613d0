"""Live control plane service CLI: observe → predict → actuate, on the
port.

The reference's ``tools/control.py`` (``load_config``,
``_KillingActuator``, ``_KillingHAActuator`` and ``main``, :58-380) on
the port's ``engine/controller.py``: a :class:`ControlLoop` over a
flight-recorder shard — tail-follow the ``twin.*`` provenance stream,
close one control tick per observation window, forecast the
candidate-knob lattice on the warm-started dispatch (one
``stream_groups_chunked`` dispatch of the row-cache misses per tick, on
``--device``: the card by default), decide under the explicit
constraint with the committed-twin-band do-no-harm rule, and actuate —
either into an append-only fsync'd actuation log (``--actuate-log``,
the replay/offline mode the gate's kill/resume proof drives) or, in HA
mode, through a live TCP tracker (``--tracker-peer``: the port's
``engine/net.py`` ``TcpNetwork``, ``TransportActuator`` and
``LeaseClient``).

The controller state checkpoints atomically after every tick
(digest-checked, under the warm-start root), so a SIGKILL'd service
``--resume``-s: the shard is replayed through the same reducers, the
recorded decision prefix is re-derived (never trusted), and already-
actuated epochs are refused by the actuation log's idempotency — no
duplicate actuations, epochs strictly monotone.

Spec file (``--spec``, JSON)::

    {"scenario": {... TwinScenario fields ...},
     "knob_grid": {"urgent_margin_s": [0.5, 2.0, 4.0, 6.0, 8.0]},
     "initial_knobs": {"urgent_margin_s": 0.5},
     "constraint": "rebuffer<=0.02",
     "bands_path": "TWIN_r10.json", "band_set": "chaos",
     "swarm_id": "...", "warmup_windows": 2, "hysteresis_ticks": 2}

The warm-start root is ``--cache-dir``, else
``$HLSJS_P2P_TORCH_CACHE_DIR``.  The reference's persistent XLA
compilation cache has no counterpart: the kernel libraries are cached
by ``ops/_build.py`` whatever the root.  The run ends with one
standard-error line, ``# kernels: {...}``: its ``nvcc`` builds, CUDA
graph captures and kernel launches.  Without a card the tool exits 2
before any work unless given ``--device cpu``.

Usage::

    python -m hlsjs_p2p_wrapper_tpu_torch.tools.control --spec SPEC.json \\
        --shard SHARD.jsonl --actuate-log ACTS.jsonl --cache-dir CACHE \\
        --out DECISIONS.json
    python -m hlsjs_p2p_wrapper_tpu_torch.tools.control ... --resume
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import time

from . import add_device_flag, launch_counts, open_device, report_kernels
from ..engine.artifact_cache import (CompileCounter, WarmStart,
                                     atomic_write_json)
from ..engine.controller import (ControlConfig, ControlLoop, HAActuator,
                                 LeaseClient, LogActuator,
                                 TransportActuator,
                                 control_checkpoint_path)
from ..engine.search import Constraint
from ..testing.twin import TwinScenario


def load_config(spec_path: str) -> ControlConfig:
    """Spec JSON → :class:`ControlConfig` (bands resolved from the
    committed artifact the spec names)."""
    with open(spec_path, encoding="utf-8") as fh:
        spec = json.load(fh)
    scenario = TwinScenario(**spec["scenario"])
    bands_path = spec["bands_path"]
    if not os.path.isabs(bands_path):
        bands_path = os.path.join(os.path.dirname(
            os.path.abspath(spec_path)), bands_path)
    with open(bands_path, encoding="utf-8") as fh:
        artifact = json.load(fh)
    band_set = spec.get("band_set", "clean")
    return ControlConfig(
        spec=scenario,
        knob_grid=spec["knob_grid"],
        initial_knobs=spec["initial_knobs"],
        constraint=Constraint.parse(spec["constraint"]),
        bands=artifact["scenarios"][band_set]["bands"],
        band_set=band_set,
        swarm_id=spec.get("swarm_id", ""),
        warmup_windows=int(spec.get("warmup_windows", 2)),
        hysteresis_ticks=int(spec.get("hysteresis_ticks", 2)),
        forecast_chunk=int(spec.get("forecast_chunk", 8)),
        slo_specs=spec.get("slo_specs"),
        cohorts=spec.get("cohorts"),
        slo_warmup_windows=spec.get("slo_warmup_windows"))


class _KillingActuator:
    """Chaos hook: behave as the wrapped actuator, then SIGKILL the
    process after the N-th actuation — AFTER the actuation became
    durable, BEFORE the tick checkpoints (the nastiest point: a
    naive resume would re-derive the decision and actuate it
    twice)."""

    def __init__(self, inner, kill_at: int):
        self.inner = inner
        self.kill_at = kill_at
        self.count = 0

    def actuate(self, epoch: int, knobs) -> bool:
        ok = self.inner.actuate(epoch, knobs)
        self.count += 1
        if self.count >= self.kill_at:
            os.kill(os.getpid(), signal.SIGKILL)
        return ok

    def publishes(self, epoch: int) -> bool:
        return self.inner.publishes(epoch)


class _KillingHAActuator:
    """HA chaos hook: let the Nth PUBLISHED epoch land fleet-wide
    (wait for the tracker's ack — the epoch must be visible so the
    standby's takeover has a watermark to prove it against), then
    SIGKILL — after the actuation became durable and fleet-visible,
    BEFORE the tick checkpoints.  The nastiest leader death: the
    successor must neither repeat nor skip the epoch the dead
    leader's checkpoint never heard about."""

    def __init__(self, inner: HAActuator, kill_at: int):
        self.inner = inner
        self.kill_at = kill_at
        self.count = 0

    @property
    def acked_epoch(self) -> int:
        return self.inner.acked_epoch

    @property
    def role(self) -> str:
        return self.inner.role

    def publishes(self, epoch: int) -> bool:
        return self.inner.publishes(epoch)

    def actuate(self, epoch: int, knobs) -> bool:
        published = self.inner.publishes(epoch)
        ok = self.inner.actuate(epoch, knobs)
        if ok and published:
            self.count += 1
            if self.count >= self.kill_at:
                deadline = time.monotonic() + 15.0  # clock-ok: real wire
                while self.inner.inner.acked_epoch < epoch \
                        and time.monotonic() < deadline:  # clock-ok
                    self.inner.inner.actuate(
                        epoch, knobs,
                        generation=self.inner.lease.generation)
                    time.sleep(0.05)  # clock-ok: real-socket pacing
                os.kill(os.getpid(), signal.SIGKILL)
        return ok


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spec", required=True,
                    help="controller spec JSON (module docstring)")
    ap.add_argument("--shard", required=True, action="append",
                    help="flight-recorder shard to ingest; repeat "
                         "for a fleet's shard LIST (merged on the "
                         "window clock by the ShardMuxFollower — "
                         "decisions are bit-identical to the "
                         "single-shard ingest of the same traffic)")
    ap.add_argument("--actuate-log", default=None,
                    help="append-only fsync'd actuation JSONL (the "
                         "idempotent-by-epoch external effect; "
                         "required unless --tracker-peer routes "
                         "actuation onto the live wire)")
    ap.add_argument("--cache-dir", default=None,
                    help="warm-start cache root (forecast row cache "
                         "+ checkpoint; the kernel libraries live in "
                         "build/torch_kernels/ whatever the root)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the digest-checked checkpoint and "
                         "re-derive the decision prefix from the "
                         "shard")
    ap.add_argument("--out", default=None,
                    help="write the decisions artifact here "
                         "(atomic)")
    ap.add_argument("--sigkill-at-actuation", type=int, default=0,
                    metavar="N",
                    help="chaos hook: SIGKILL self after the N-th "
                         "actuation lands in the log, before the "
                         "tick checkpoints")
    ap.add_argument("--dead-after-polls", type=int, default=0,
                    metavar="N",
                    help="fleet ingest liveness: declare a shard "
                         "dead after N consecutive lagging "
                         "no-progress polls and close the remaining "
                         "windows WITHOUT it (excluded-and-counted; "
                         "the replay re-polls until the verdicts "
                         "settle).  0 (default) waits forever — a "
                         "truncated shard then truncates the "
                         "decision sequence too")
    ha = ap.add_argument_group(
        "HA fleet mode", "run as one member of a leader-fenced "
        "controller pair: lease arbitration and SET_KNOBS both ride "
        "a live TCP tracker (PSK from the P2P_SWARM_PSK env var, "
        "never argv)")
    ha.add_argument("--tracker-peer", default=None, metavar="HOST:PORT",
                    help="the tracker endpoint's dialable peer id; "
                         "presence selects HA mode")
    ha.add_argument("--controller-id", default="ctrl-a",
                    help="this member's identity (lease holder name, "
                         "recorder host id, checkpoint instance)")
    ha.add_argument("--lease-ttl-ms", type=float, default=1500.0)
    ha.add_argument("--trace-dir", default=None,
                    help="this member's flight-recorder shard root "
                         "(durable actuation intents + lease events "
                         "— the fleet gate's exactly-once stream)")
    ha.add_argument("--assume-leader-generation", type=int, default=0,
                    metavar="GEN",
                    help="CHAOS: believe we hold the lease at GEN "
                         "without asking the tracker (the "
                         "resurrected-zombie harness; lease pumping "
                         "is disabled so the delusion persists — "
                         "the tracker's generation fence must "
                         "refuse every resulting publish)")
    ha.add_argument("--kill-after-published-epochs", type=int,
                    default=0, metavar="N",
                    help="HA chaos: SIGKILL self once the N-th "
                         "published epoch is tracker-acked "
                         "(fleet-visible), before its checkpoint")
    ha.add_argument("--poll-interval-s", type=float, default=0.05)
    ha.add_argument("--idle-exit-polls", type=int, default=40,
                    help="exit once leading with no pending windows "
                         "and this many consecutive idle polls")
    ha.add_argument("--max-wall-s", type=float, default=300.0)
    add_device_flag(ap)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    dev = open_device(ap, args.device)
    if args.tracker_peer is None and args.actuate_log is None:
        ap.error("--actuate-log is required outside HA mode")
    launches = launch_counts()
    with CompileCounter() as probe:
        rc = _run(args, dev)
    report_kernels(probe, launches)
    return rc


def _run(args, dev) -> int:
    config = load_config(args.spec)
    warm = WarmStart(cache_dir=args.cache_dir)
    shards = (args.shard[0] if len(args.shard) == 1
              else list(args.shard))
    recorder = None
    lease = None
    network = None
    if args.tracker_peer:
        from ..engine.net import TcpNetwork
        from ..engine.tracer import FlightRecorder
        psk = os.environ.get("P2P_SWARM_PSK")
        network = TcpNetwork(psk=psk.encode() if psk else None,
                             registry=warm.registry)
        endpoint = network.register()
        inner = TransportActuator(endpoint, config.swarm_id,
                                  tracker_peer_id=args.tracker_peer,
                                  registry=warm.registry)
        if args.trace_dir:
            recorder = FlightRecorder(
                args.trace_dir, args.controller_id,
                registry=warm.registry,
                counter_filter=lambda name:
                name.startswith("control."))
        lease = LeaseClient(endpoint, config.swarm_id,
                            args.controller_id,
                            tracker_peer_id=args.tracker_peer,
                            ttl_ms=args.lease_ttl_ms,
                            registry=warm.registry,
                            recorder=recorder)
        if args.assume_leader_generation > 0:
            lease.assume(args.assume_leader_generation)
        actuator = HAActuator(inner, lease, registry=warm.registry)
        if args.kill_after_published_epochs > 0:
            actuator = _KillingHAActuator(
                actuator, args.kill_after_published_epochs)
    else:
        actuator = LogActuator(args.actuate_log)
        if args.sigkill_at_actuation > 0:
            actuator = _KillingActuator(actuator,
                                        args.sigkill_at_actuation)
    holder = {}

    def standby_gate(_window: int) -> bool:
        # the HOT-STANDBY pause: tick only what we lead, or what the
        # fleet watermark proves the leader already landed (so every
        # derived actuate shadow-applies, never publishes ahead)
        loop_, lease_ = holder["loop"], holder["lease"]
        return lease_.is_leader or loop_.epoch < lease_.knob_epoch

    loop = ControlLoop(
        config, shards, actuator, warm_start=warm,
        registry=warm.registry, recorder=recorder,
        checkpoint_path=control_checkpoint_path(
            warm.cache_dir, config,
            instance=(args.controller_id if args.tracker_peer
                      else "")),
        dead_after_polls=(args.dead_after_polls or None),
        tick_gate=(standby_gate if lease is not None
                   and args.assume_leader_generation <= 0 else None),
        device=dev)
    holder["loop"], holder["lease"] = loop, lease
    resumed = False
    if args.resume:
        resumed = loop.resume()
    if args.tracker_peer:
        # the HA drive loop: pump one lease claim/renewal per poll
        # (the tracker arbitrates; acks arrive on the reader
        # threads), tick what the gate allows, checkpoint-and-exit
        # once leading with a drained backlog and a settled mux
        deadline = time.monotonic() + args.max_wall_s  # clock-ok:
        # real-wire service loop (the engine stays injectable)
        idle = 0
        while time.monotonic() < deadline:  # clock-ok: ditto
            if args.assume_leader_generation <= 0:
                lease.request()
            if loop.run_available():
                idle = 0
            else:
                idle += 1
            if lease.is_leader and loop.pending_windows == 0 \
                    and idle >= args.idle_exit_polls:
                break
            time.sleep(args.poll_interval_s)  # clock-ok: ditto
    else:
        loop.run_available()
    if args.dead_after_polls and not args.tracker_peer:
        # offline replay against files that no longer grow: every
        # extra poll is pure stall evidence, so keep polling until
        # the dead-shard verdicts settle and no further merged
        # windows close — otherwise a truncated shard's stall fuse
        # (dead_after_polls consecutive lagging polls) never burns
        # and half the capture's ticks silently never happen
        idle = 0
        while idle <= args.dead_after_polls:
            if loop.run_available():
                idle = 0
            else:
                idle += 1

    if recorder is not None:
        recorder.close()
    if network is not None:
        network.close()
    doc = {
        "meta": {
            "spec": os.path.abspath(args.spec),
            "shard": [os.path.abspath(s) for s in args.shard],
            "resumed": resumed,
            "scenario": dataclasses.asdict(config.spec),
            "constraint": [config.constraint.metric,
                           config.constraint.bound,
                           config.constraint.objective],
            "band_set": config.band_set,
        },
        "ticks": len(loop.decisions),
        "epoch": loop.epoch,
        "current_knobs": loop.current_knobs,
        "decisions": loop.decisions,
        "tick_stats": loop.tick_stats,
        # fleet ingest visibility: which shards each merged window
        # closed WITHOUT (dead/lagging — excluded-and-counted)
        "excluded_windows": [{"tick": i, "shards": list(shards)}
                             for i, shards in
                             enumerate(loop.ingest.exclusions)
                             if shards],
    }
    if lease is not None:
        # the HA surface the console's --control panel renders
        doc["lease"] = {
            "controller_id": args.controller_id,
            "is_leader": lease.is_leader,
            "generation": lease.generation,
            "leader_id": lease.leader_id,
            "leader_generation": lease.leader_generation,
            "knob_epoch": lease.knob_epoch,
            "pending_windows": loop.pending_windows,
        }
    if args.out:
        atomic_write_json(args.out, doc)
    actions = [d["action"] for d in loop.decisions]
    print(f"# control: {len(loop.decisions)} ticks, "
          f"epoch {loop.epoch}, "
          f"{actions.count('actuate')} actuations / "
          f"{actions.count('hold')} holds / "
          f"{actions.count('veto')} vetoes"
          + (" (resumed)" if resumed else ""), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
