"""Replay driver: rebuild a node from its input log and re-drive it.

The replayed node is a full Application on a fresh VirtualClock in
VIRTUAL_TIME mode. The driver never calls ``crank()``: it re-creates
the live run's crank sequence from the log's TICK phase boundaries —
set virtual time to the recorded instant, drain posted actions at each
START, feed the records captured inside that crank at their stream
positions, run io pollers and due timers at each DISPATCH. Timestamps
alone cannot do this: a whole handshake-and-first-close storm shares
the virtual instant t=0, and whether the ledger trigger fired before
or after a given input arrived is exactly the phase sequence the TICK
records carry. Peers are ``ReplayPeer`` stubs:
the handshake replays from recorded HELLO/AUTH frames, sends are
discarded (their trace instants still fire, which is what the
divergence diff compares), and HMAC verdicts come from the log because
the ephemeral session keys cannot be re-derived. Node-level chaos
outcomes replay from recorded (point, node-local ordinal) pairs via
``ReplayChaosEngine``.

What must come out byte-identical across replays of one log — and,
for the header chain and controller decision log, identical to the
live run: see docs/REPLAY.md.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from ..main.application import Application
from ..main.config import Config
from ..overlay.peer import Peer
from ..overlay.peer_auth import PeerRole
from ..util import chaos, threads
from ..util.logging import get_logger
from ..util.timer import ClockMode, VirtualClock
from . import log as rlog
from .recorder import TRANSPORT_POINTS, config_from_snapshot

log = get_logger("Replay")


class ReplayError(Exception):
    """The log cannot be faithfully replayed (late-start connection,
    unsupported recorded chaos kind at a node seam, ...)."""


class ReplayPeer(Peer):
    """Peer stub for replay: transport is the input log. Outbound
    bytes are counted and discarded — the messages' trace instants and
    flow-control effects (what the divergence diff actually compares)
    happen before ``_send_bytes``."""

    def __init__(self, overlay, role: PeerRole, conn_id: int):
        super().__init__(overlay, role)
        self.conn_id = conn_id
        self.force_mac_fail = False
        self.sent_frames = 0
        self.sent_bytes = 0

    def _send_bytes(self, raw: bytes) -> None:
        self.sent_frames += 1
        self.sent_bytes += len(raw)

    def _verify_frame_mac(self, v0, frame) -> bool:
        # MAC keys derive from per-connection random nonces + ephemeral
        # session keys — unrecoverable on replay. The recorded verdict
        # (a MACFAIL record after the frame) substitutes for the check;
        # the deterministic sequence-number check still runs upstream.
        if self.force_mac_fail:
            self.force_mac_fail = False
            return False
        return True


class ReplayChaosEngine(chaos.ChaosEngine):
    """Scripted chaos: replays recorded fault outcomes at the same
    node-local matched-hit ordinals the live engine chose, using the
    exact counting rule the recorder used (non-transport points whose
    context names this node)."""

    def __init__(self, node_hex: str, events: List[dict]):
        super().__init__(seed=0, schedule=[])
        self.node_hex = node_hex
        self._counts: Dict[str, int] = {}
        self._script = {(d["point"], d["ordinal"]): d for d in events}
        self.replayed = 0

    def fire(self, point: str, payload, ctx: dict):
        if point in TRANSPORT_POINTS or ctx.get("node") != self.node_hex:
            return payload
        ordinal = self._counts.get(point, 0)
        self._counts[point] = ordinal + 1
        doc = self._script.get((point, ordinal))
        if doc is None:
            return payload
        self.replayed += 1
        kind = doc["kind"]
        key = f"chaos.injected.{kind}"
        self.injected[key] = self.injected.get(key, 0) + 1
        self.log.append((point, -1, ordinal, kind))
        if kind == "io_error":
            raise chaos.ChaosError(f"chaos injected io_error at {point}")
        if kind == "crash":
            raise chaos.SimulatedCrash(point, ctx)
        if kind == "churn":
            raise chaos.SimulatedChurn(point, ctx)
        if kind == "drop":
            return chaos.DROP
        if kind == "reorder":
            return chaos.REORDER
        if kind == "fail":
            return chaos.FAIL
        if kind == "hang":
            return chaos.HANG
        if kind == "equivocate":
            return chaos.EQUIVOCATE
        if kind == "bad_sig_flood":
            return chaos.BadSigBurst(int(doc.get("burst", 8)))
        if kind == "delay":
            return chaos.Delay(payload, float(doc.get("delay_s", 0.001)))
        # corrupt/malformed mangle bytes with the live engine's per-spec
        # RNG state, which a single-node replay cannot reconstruct; at
        # transport seams the mangled bytes were recorded anyway, and
        # node seams reject them loudly instead of diverging silently
        raise ReplayError(
            f"unsupported recorded chaos kind {kind!r} at node seam "
            f"{point} (docs/REPLAY.md: what is not captured)")


class ReplayResult:
    """Everything the determinism assertions compare."""

    def __init__(self, node: str):
        self.node = node
        self.crashed = False
        self.crash_point: Optional[str] = None
        self.lcl_seq = 0
        self.lcl_hash = ""
        self.header_chain: List[str] = []      # hashes for seq 2..lcl
        self.decisions: List[dict] = []        # controller decision log
        self.trace: List[tuple] = []           # normalized events
        self.end_matches: Optional[bool] = None  # vs the recorded END
        self.torn_tail = 0
        self.chaos_replayed = 0
        self.frames_fed = 0

    def decisions_json(self) -> str:
        return json.dumps(self.decisions, sort_keys=True)


def normalize_trace(recorder) -> List[tuple]:
    """Project a FlightRecorder buffer onto its deterministic core:
    ``(phase, name, canonical-args-json, correlation-id)``. Timestamps
    are wall-clock (perf_counter) and thread ids are process facts —
    both legally differ between byte-identical runs, so they are
    normalized away; everything else must match event-for-event."""
    out = []
    for ph, name, _ts, _tid, args, cid in list(recorder._buf):
        out.append((ph, name,
                    json.dumps(args, sort_keys=True, default=str)
                    if args is not None else "", cid or ""))
    return out


def first_divergence(a: List[tuple], b: List[tuple],
                     context: int = 8) -> Optional[dict]:
    """Align two normalized traces and pinpoint the first diverging
    event, with the shared evidence chain leading up to it. ``None``
    means byte-identical (same events, same order, same args)."""
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return {
                "index": i,
                "a": list(a[i]),
                "b": list(b[i]),
                "chain": [list(e) for e in a[max(0, i - context):i]],
            }
    if len(a) != len(b):
        longer, which = (a, "a") if len(a) > len(b) else (b, "b")
        return {
            "index": n,
            "a": list(a[n]) if len(a) > n else None,
            "b": list(b[n]) if len(b) > n else None,
            "tail_only_in": which,
            "chain": [list(e) for e in longer[max(0, n - context):n]],
        }
    return None


class NodeReplayer:
    """One replay run. Build → :meth:`run` → :class:`ReplayResult`."""

    def __init__(self, ilog: rlog.InputLog, trace: bool = True,
                 trace_capacity: Optional[int] = None):
        self.ilog = ilog
        self.trace = trace
        self.trace_capacity = trace_capacity
        self.clock = VirtualClock(ClockMode.VIRTUAL_TIME)
        self.cfg = self._build_config()
        self.app: Optional[Application] = None
        self.conns: Dict[int, ReplayPeer] = {}
        self._inputs: List[rlog.LogRecord] = [
            r for r in ilog.records
            if r.rtype in (rlog.RT_CONN, rlog.RT_FRAME, rlog.RT_INJECT,
                           rlog.RT_ADMIN, rlog.RT_PDROP, rlog.RT_TICK)]
        self._next = 0
        self.result = ReplayResult(ilog.node)
        end = ilog.end_record()
        self._end_doc = end.doc if end is not None else None

    def _build_config(self) -> Config:
        cfg = config_from_snapshot(self.ilog.header.get("config", {}))
        # never reattach to the live node's storage: the replayed node
        # rebuilds its whole state from genesis + inputs
        cfg.DATABASE = "sqlite3://:memory:"
        cfg.BUCKET_DIR_PATH = None
        return cfg

    # ------------------------------------------------------------ plumbing --
    def _make_peer(self, rec: rlog.LogRecord) -> None:
        doc = rec.doc or {}
        if doc.get("late"):
            raise ReplayError(
                "connection %d was established before recording "
                "started — its handshake is not in the log" % rec.conn)
        peer = ReplayPeer(self.app.overlay_manager,
                          PeerRole[doc["role"]], rec.conn)
        self.conns[rec.conn] = peer
        self.app.overlay_manager.add_pending_peer(peer)
        peer.connect_handler()

    def _feed(self, rec: rlog.LogRecord) -> None:  # thread-domain: crank
        if rec.rtype == rlog.RT_CONN:
            self._make_peer(rec)
        elif rec.rtype == rlog.RT_FRAME:
            peer = self.conns.get(rec.conn)
            if peer is None:
                raise ReplayError(f"frame for unknown conn {rec.conn}")
            from ..overlay.peer import PeerState
            if peer.state == PeerState.CLOSING:
                return
            if rec.mac_invalid:
                peer.force_mac_fail = True
            peer.recv_bytes(rec.data)
            self.result.frames_fed += 1
        elif rec.rtype == rlog.RT_INJECT:
            self._inject(rec.frames or [],
                         (rec.doc or {}).get("via", 0))
        elif rec.rtype == rlog.RT_ADMIN:
            doc = rec.doc or {}
            self.app.command_handler.handle(doc.get("cmd", ""),
                                            doc.get("params") or {})
        elif rec.rtype == rlog.RT_PDROP:
            peer = self.conns.get(rec.conn)
            if peer is not None:
                peer.drop((rec.doc or {}).get("reason", "replayed drop"))

    def _inject(self, raws: List[bytes], via: int) -> None:
        from ..tx.frame import make_frame
        from ..xdr.transaction import TransactionEnvelope
        frames = []
        net = self.cfg.network_id()
        for raw in raws:
            env = TransactionEnvelope.from_bytes(raw)
            frames.append(make_frame(env, net))
        if via == 1:
            # direct submission path — rolls the surge-shed gate
            # exactly like the live tx route / loadgen did
            for frame in frames:
                self.app.herder.recv_transaction(frame)
        else:
            self.app.herder.recv_transactions(frames)

    # ----------------------------------------------------------------- run --
    def run(self) -> ReplayResult:  # thread-domain: crank
        if threads.CHECK:
            # the replay driver IS the logical main thread — it drives
            # the same phases crank() would, just from the log
            threads.bind("crank")
        ilog = self.ilog
        self.result.torn_tail = ilog.torn_tail
        self.app = Application.create(self.clock, self.cfg)
        extras = ilog.header.get("extras", {})
        if extras.get("defer_completion") is False:
            # the recorded run forced the close-completion tail inline
            # (driver-level determinism setting, not a Config knob)
            self.app.ledger_manager.defer_completion = False
        # connections recorded before the first TICK predate the first
        # crank: the driver wired them before the node started, so they
        # are re-created before start(), in the same order
        while self._next < len(self._inputs) and \
                self._inputs[self._next].rtype == rlog.RT_CONN:
            self._make_peer(self._inputs[self._next])
            self._next += 1
        # the scripted chaos engine installs BEFORE start: the live
        # engine was installed before the node started, so seam fires
        # during genesis close count toward the recorded ordinals
        chaos_events = [r.doc for r in ilog.records
                        if r.rtype == rlog.RT_CHAOS]
        engine = None
        if chaos_events:
            engine = ReplayChaosEngine(ilog.node, chaos_events)
            chaos.install(engine)
        try:
            self.app.start()
            if self.trace:
                self.app.flight_recorder.start(
                    capacity=self.trace_capacity)
            self._drive()
        except chaos.SimulatedCrash as cr:
            self.result.crashed = True
            self.result.crash_point = cr.point
        finally:
            if engine is not None:
                self.result.chaos_replayed = engine.replayed
                chaos.uninstall()
        self._collect()
        self._teardown()
        return self.result

    def _drive(self) -> None:  # thread-domain: crank
        """Re-create the recorded crank sequence. Each TICK boundary
        runs its phase on the replay clock at the recorded instant:
        START drains posted actions, DISPATCH runs the replayed app's
        own io pollers (process/work polls — the live node's ran right
        before its dispatch too) and then fires due timers, JUMP
        advances time mid-crank and fires again. Non-TICK records feed
        at their stream position: between START and DISPATCH that is
        the live action/poller window, after END it is a driver acting
        between cranks — the exact interleaving timestamps can't carry
        because whole handshake storms share one virtual instant."""
        clock = self.clock
        try:
            while self._next < len(self._inputs):
                rec = self._inputs[self._next]
                self._next += 1
                if rec.rtype != rlog.RT_TICK:
                    self._feed(rec)
                    continue
                if rec.ts > clock.now():
                    clock.set_virtual_time(rec.ts)
                if rec.phase == rlog.TICK_START:
                    clock.drain_actions()
                elif rec.phase in (rlog.TICK_DISPATCH, rlog.TICK_JUMP):
                    if rec.phase == rlog.TICK_DISPATCH:
                        clock.poll_io()
                    clock.dispatch_due()
                # TICK_END is a pure boundary marker
        except chaos.SimulatedCrash as cr:
            self.result.crashed = True
            self.result.crash_point = cr.point

    def _collect(self) -> None:
        app, res = self.app, self.result
        lm = app.ledger_manager
        res.lcl_seq = lm.get_last_closed_ledger_num()
        res.lcl_hash = lm.get_last_closed_ledger_hash().hex()
        for seq in range(2, res.lcl_seq + 1):
            row = app.database.query_one(
                "SELECT ledgerhash FROM ledgerheaders WHERE ledgerseq=?",
                (seq,))
            res.header_chain.append(
                bytes(row[0]).hex() if row is not None else "")
        res.decisions = [dict(d) for d in app.controller.decisions]
        if self.trace:
            res.trace = normalize_trace(app.flight_recorder)
        if self._end_doc is not None:
            res.end_matches = (
                res.lcl_seq == int(self._end_doc.get("lcl_seq", -1))
                and res.lcl_hash == self._end_doc.get("lcl_hash", ""))

    def _teardown(self) -> None:
        app = self.app
        if not self.result.crashed:
            try:
                app.shutdown()
                return
            except BaseException:   # noqa: BLE001 — fall through to burial
                log.exception("replay shutdown failed; burying instead")
        # a crashed replay is buried the way Simulation.crash_node
        # buries a crashed node: silence timers, drop completion tails,
        # close storage — never the graceful drain
        from ..main.application import AppState
        app.state = AppState.APP_STOPPING_STATE
        try:
            if app.flight_recorder.active:
                app.flight_recorder.stop()
            app.ledger_manager.discard_pending_completion()
            app.herder.shutdown()
            app.maintainer.stop()
            app.work_scheduler.shutdown()
            app.process_manager.shutdown()
            app.query_service.shutdown()
            app.snapshots.shutdown()
            app.bucket_manager.shutdown()
            app.database.close()
            if app._tmp_bucket_dir is not None:
                app._tmp_bucket_dir.cleanup()
        except BaseException:       # noqa: BLE001 — dead is dead
            log.exception("ignoring error while burying replayed node")


def replay_log(ilog: rlog.InputLog, trace: bool = True,
               trace_capacity: Optional[int] = None) -> ReplayResult:
    """Replay one node's input log end-to-end and return the
    :class:`ReplayResult` carrying everything the determinism
    assertions compare."""
    return NodeReplayer(ilog, trace=trace,
                        trace_capacity=trace_capacity).run()
