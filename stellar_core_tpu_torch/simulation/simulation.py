"""Multi-node in-process networks for tests.

Reference: src/simulation/Simulation.{h,cpp} — N full Applications on a
shared VirtualClock, wired OVER_LOOPBACK (in-memory Peer pairs) so whole
consensus/flooding/catchup scenarios run hermetically and
deterministically. Loopback delivery is registered as an io-poller on
the clock, so `crank_until` advances timers and message queues together
exactly like the reference's crank loop.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

from ..crypto.keys import SecretKey
from ..crypto.sha import sha256
from ..main.application import Application
from ..main.config import Config, QuorumSetConfig
from ..overlay.loopback import LoopbackPeerConnection
from ..util.logging import get_logger
from ..util.timer import ClockMode, VirtualClock

log = get_logger("default")


class Simulation:
    OVER_LOOPBACK = 0
    OVER_TCP = 1  # arrives with TCPPeer

    def __init__(self, mode: int = OVER_LOOPBACK,
                 network_passphrase: str = "(V) (;,,;) (V)",
                 clock: Optional[VirtualClock] = None,
                 data_dir: Optional[str] = None):
        assert mode == Simulation.OVER_LOOPBACK
        self.mode = mode
        self.network_passphrase = network_passphrase
        self.clock = clock or VirtualClock(ClockMode.VIRTUAL_TIME)
        self.nodes: Dict[bytes, Application] = {}   # node id -> app
        self.connections: List[LoopbackPeerConnection] = []
        self.crashed: set = set()                   # node ids killed
        # file-backed node state (churn scenarios): each node gets its
        # own sqlite file + bucket dir under here, so crash_node →
        # restart_node can rebuild the Application from persisted state
        self.data_dir = data_dir
        # rebuild recipe per node: (index, seed, qset, configure)
        self._node_specs: Dict[bytes, tuple] = {}
        # desired topology: (a, b, latency_s, bandwidth_bps) — replayed
        # by restart_node to re-wire a restarted node to live neighbors
        self._adjacency: List[tuple] = []
        self.clock.add_io_poller(self._pump_connections)

    # --------------------------------------------------------------- nodes --
    def _make_config(self, index: int, seed: SecretKey,
                     qset: QuorumSetConfig,
                     configure: Optional[Callable[[Config], None]]
                     ) -> Config:
        cfg = Config()
        cfg.NETWORK_PASSPHRASE = self.network_passphrase
        cfg.NODE_SEED = seed
        cfg.NODE_IS_VALIDATOR = True
        cfg.RUN_STANDALONE = True
        cfg.FORCE_SCP = True
        cfg.MANUAL_CLOSE = False
        cfg.EXPECTED_LEDGER_CLOSE_TIME = 1.0
        cfg.MAX_TX_SET_SIZE = 1000
        cfg.INVARIANT_CHECKS = [".*"]
        cfg.PEER_PORT = 35000 + index
        cfg.QUORUM_SET = qset
        # telemetry sampling is opt-in per scenario (the get_test_config
        # discipline): a recurring timer on every sim node's shared
        # clock would keep idle crank_until loops stepping to their
        # timeouts; bench legs and telemetry tests re-enable it in
        # their `configure` callback
        cfg.TELEMETRY_SAMPLE_PERIOD = 0.0
        # same discipline for the adaptive controller's tick
        cfg.CONTROLLER_TICK_PERIOD = 0.0
        if self.data_dir is not None:
            cfg.DATABASE = "sqlite3://%s" % os.path.join(
                self.data_dir, "node-%d.db" % index)
            cfg.BUCKET_DIR_PATH = os.path.join(
                self.data_dir, "buckets-%d" % index)
        if configure is not None:
            configure(cfg)
        return cfg

    def add_node(self, seed: SecretKey, qset: QuorumSetConfig,
                 configure: Optional[Callable[[Config], None]] = None
                 ) -> Application:
        index = len(self.nodes)
        cfg = self._make_config(index, seed, qset, configure)
        app = Application.create(self.clock, cfg)
        self.nodes[cfg.node_id()] = app
        self._node_specs[cfg.node_id()] = (index, seed, qset, configure)
        return app

    def get_node(self, node_id: bytes) -> Application:
        return self.nodes[node_id]

    def apps(self) -> List[Application]:
        return list(self.nodes.values())

    # --------------------------------------------------------- connections --
    def add_pending_connection(self, a: bytes, b: bytes,
                               latency_s: float = 0.0,
                               bandwidth_bps: Optional[float] = None
                               ) -> None:
        self._adjacency.append((a, b, latency_s, bandwidth_bps))
        self.connections.append(
            LoopbackPeerConnection(self.nodes[a], self.nodes[b],
                                   latency_s=latency_s,
                                   bandwidth_bps=bandwidth_bps))

    def start_all_nodes(self) -> None:
        for app in self.nodes.values():
            app.start()

    def stop_all_nodes(self) -> None:
        for node_id, app in self.nodes.items():
            if node_id not in self.crashed:
                app.shutdown()
        self.clock.remove_io_poller(self._pump_connections)

    def record_all(self, extras: Optional[dict] = None) -> None:
        """Attach an in-memory input recorder (replay/recorder.py) to
        every node. Call BEFORE wiring connections so the recorded
        handshakes are complete — a late recorder flags its conns
        unreplayable. `extras` records driver-level determinism
        settings (e.g. {"defer_completion": False}) the replayer must
        re-apply."""
        from ..replay.recorder import InputRecorder
        for app in self.nodes.values():
            rec = InputRecorder(app, extras=extras)
            rec.begin()
            app.input_recorder = rec

    def finish_recording(self) -> Dict[bytes, "object"]:
        """End every live node's recording with an END marker and
        return {node_id: InputLog}. Crashed nodes' recorders were
        aborted mid-stream by crash_node — their logs end at the kill,
        like a real ``kill -9``, and are NOT returned here (read them
        from the aborted recorder's buffer if the tear itself is under
        test)."""
        logs: Dict[bytes, object] = {}
        for node_id, app in self.nodes.items():
            rec = getattr(app, "input_recorder", None)
            if rec is None or not rec.active:
                continue
            rec.finish(reason="ok")
            logs[node_id] = rec.to_log()
        return logs

    def crash_node(self, node_id: bytes) -> None:
        """Simulate a process kill (reference: Simulation::removeNode in
        the lost/restored-node tests): sever every loopback link without
        any goodbye bytes, then silence the dead app's timers and DROP
        its pending deferred-completion tails. Deliberately NOT the
        graceful Application.shutdown — draining completion, flushing
        meta and closing the database would persist exactly the
        in-memory state a real kill loses. The app object must not be
        reused."""
        app = self.nodes[node_id]
        for conn in list(self.connections):
            a, b = conn.initiator, conn.acceptor
            if a.app is not app and b.app is not app:
                continue
            dead, live = (a, b) if a.app is app else (b, a)
            # nothing more crosses the wire in either direction
            dead.partner = None
            live.partner = None
            live.drop("peer crashed")      # standard remote-vanished path
            self.connections.remove(conn)
        self.crashed.add(node_id)
        rec = getattr(app, "input_recorder", None)
        if rec is not None and rec.active:
            # kill semantics: detach with NO END marker — the log ends
            # mid-stream, exactly what a real kill -9 leaves on disk
            rec.abort()
        if app.flight_recorder.active:
            # a dead process takes its tracing refcount with it: without
            # this, the process-wide tracing.ENABLED flag stays latched
            # after the sim ends. The buffer stays dumpable.
            app.flight_recorder.stop()
        from ..main.application import AppState
        app.state = AppState.APP_STOPPING_STATE
        try:
            app.ledger_manager.discard_pending_completion()
            app.herder.shutdown()     # nomination/ballot/flood timers
            bv = getattr(app, "batch_verifier", None)
            if bv is not None and hasattr(bv, "breaker_state"):
                # the dead node's breaker must not keep probing the
                # device on the shared clock
                bv.shutdown()
            app.maintainer.stop()
            timer = getattr(app, "_self_check_timer", None)
            if timer is not None:
                timer.cancel()
                app._self_check_timer = None
            app.work_scheduler.shutdown()
            app.process_manager.shutdown()
        except BaseException:              # noqa: BLE001 — dead is dead
            log.exception("ignoring error while burying crashed node")

    def restart_node(self, node_id: bytes) -> Application:
        """Bring a crashed node back as a NEW process (reference: the
        lost/RESTORED-node simulation tests): rebuild the Application
        from its persisted sqlite file + bucket dir (requires the
        Simulation's `data_dir` — in-memory nodes have nothing to
        restart from), re-wire its recorded loopback links to the
        neighbors still alive, and start it. The restarted node's LCL
        is whatever its last durable commit was; it catches back up
        over the overlay (peers answer its GET_SCP_STATE with recent
        externalize envelopes) or through archive catchup — while any
        installed chaos schedule keeps running."""
        if node_id not in self.crashed:
            raise RuntimeError("restart_node: node is not crashed")
        if self.data_dir is None:
            raise RuntimeError(
                "restart_node requires a data_dir-backed Simulation "
                "(in-memory nodes lose everything on crash)")
        index, seed, qset, configure = self._node_specs[node_id]
        old = self.nodes[node_id]
        try:
            # the dead process's file descriptors are closed by the OS;
            # close its sqlite handle so the restarted node owns the
            # file (an uncommitted transaction rolls back — exactly
            # what the kill lost)
            old.database.close()
        except Exception:              # noqa: BLE001 — dead is dead
            log.exception("ignoring error closing crashed node's DB")
        cfg = self._make_config(index, seed, qset, configure)
        app = Application.create(self.clock, cfg, new_db=False)
        self.nodes[node_id] = app
        self.crashed.discard(node_id)
        app.start()
        for a, b, lat, bw in self._adjacency:
            if node_id not in (a, b):
                continue
            other = b if a == node_id else a
            if other in self.crashed or other not in self.nodes:
                continue
            self.connections.append(LoopbackPeerConnection(
                self.nodes[a], self.nodes[b], latency_s=lat,
                bandwidth_bps=bw))
        log.info("restarted node %s at ledger %d", node_id.hex()[:8],
                 app.ledger_manager.get_last_closed_ledger_num())
        return app

    def alive_apps(self) -> List[Application]:
        return [a for nid, a in self.nodes.items()
                if nid not in self.crashed]

    def _pump_connections(self) -> int:
        n = 0
        for conn in self.connections:
            n += conn.initiator.deliver_all()
            n += conn.acceptor.deliver_all()
        return n

    # ------------------------------------------------------------- cranking --
    def crank_until(self, pred: Callable[[], bool],
                    timeout_virtual_seconds: float = 120.0) -> bool:
        """Crank clock + connections until pred or virtual timeout
        (reference: Simulation::crankUntil)."""
        deadline = self.clock.now() + timeout_virtual_seconds
        while not pred() and self.clock.now() < deadline:
            if self.clock.crank(False) == 0:
                self.clock.crank(True)  # jump virtual time to next timer
        return pred()

    def crank_for_at_least(self, virtual_seconds: float) -> None:
        target = self.clock.now() + virtual_seconds
        self.crank_until(lambda: self.clock.now() >= target,
                         virtual_seconds + 60)

    # ------------------------------------------------------------- tracing --
    def start_tracing(self) -> None:
        """Begin flight recording on every node (mesh observatory):
        each node's recorder captures its own lane; `merged_trace`
        aligns and stitches them into one cluster-wide document."""
        for app in self.alive_apps():
            app.flight_recorder.start()

    def merged_trace(self) -> dict:
        """One Chrome trace for the whole mesh (util/tracemerge.py):
        per-node process lanes clock-aligned, per-node async tracks
        kept distinct, and hash-keyed flood hops stitched into flow
        chains that follow a tx / SCP envelope across node lanes."""
        from ..util.tracemerge import merge_recorders
        return merge_recorders(
            [a.flight_recorder for a in self.nodes.values()])

    def dump_merged_trace(self, path: str, stop: bool = True) -> dict:
        """Write the merged cluster trace to `path` (Perfetto /
        chrome://tracing / scripts/trace_report.py --slots/--flood);
        stops the recorders afterwards unless told otherwise."""
        import json
        doc = self.merged_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        if stop:
            for app in self.nodes.values():
                if app.flight_recorder.active:
                    app.flight_recorder.stop()
        return doc

    # -------------------------------------------------------------- helpers --
    def have_all_externalized(self, ledger_seq: int) -> bool:
        return all(a.ledger_manager.get_last_closed_ledger_num() >=
                   ledger_seq for a in self.nodes.values())

    def have_alive_externalized(self, ledger_seq: int) -> bool:
        """Like have_all_externalized but over surviving nodes only —
        chaos scenarios assert liveness on the quorum that's left."""
        return all(a.ledger_manager.get_last_closed_ledger_num() >=
                   ledger_seq for a in self.alive_apps())

    def ledger_hashes_agree(self, ledger_seq: int) -> bool:
        hashes = set()
        for app in self.nodes.values():
            row = app.database.query_one(
                "SELECT ledgerhash FROM ledgerheaders WHERE ledgerseq=?",
                (ledger_seq,))
            if row is None:
                return False
            hashes.add(bytes(row[0]))
        return len(hashes) == 1
