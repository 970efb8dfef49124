"""Per-Application input recorder.

Captures, in arrival order with virtual timestamps, everything that can
steer a node: inbound wire frames (the exact serialize-once recv bytes,
hooked at ``Peer.recv_bytes``), connection establishment/teardown,
external transaction injections, recorded admin commands, and the chaos
engine's injected faults (as node-local matched-hit ordinals, via the
chaos observer hook). The recorded config snapshot + NODE_SEED is
enough to rebuild the node; the log is enough to re-drive it
(replay/replayer.py).

Cost contract: with no recorder attached every hook is one
``getattr(app, "input_recorder", None) is None`` check. Recording
itself is append + CRC per input — the serialize-once cache means no
frame is ever re-encoded.
"""

from __future__ import annotations

from typing import Optional

from ..main.config import Config, QuorumSetConfig
from ..util import chaos
from ..util.logging import get_logger
from . import log as rlog

log = get_logger("Replay")

# Transport-level chaos seams fire in the loopback/tcp delivery path,
# which does not exist on replay (recorded frames already embody their
# effects: a dropped frame was never recorded, a corrupted one was
# recorded corrupted). Node-level seams DO fire on replay and need
# their outcomes scripted.
TRANSPORT_POINTS = ("overlay.send", "overlay.recv")

# Admin commands that mutate node state and must be re-driven on
# replay. `tx` is deliberately absent: its envelope is recorded as an
# INJECT at the submission site, bytes-exact. `generateload` IS here:
# the load generator is deterministic (RNG seeded from
# config.jitter_seed(), synchronous submission inside the route), so
# re-driving the command regenerates byte-identical transactions —
# recording its submissions as INJECTs too would replay them twice.
RECORDED_ADMIN = ("manualclose", "generateload", "upgrades",
                  "maintenance", "setcursor", "dropcursor")


def quorum_set_to_json(q: QuorumSetConfig) -> dict:
    return {"threshold": q.threshold,
            "validators": [v.hex() for v in q.validators],
            "inner_sets": [quorum_set_to_json(s) for s in q.inner_sets]}


def quorum_set_from_json(doc: dict) -> QuorumSetConfig:
    return QuorumSetConfig(
        threshold=int(doc.get("threshold", 0)),
        validators=[bytes.fromhex(v) for v in doc.get("validators", [])],
        inner_sets=[quorum_set_from_json(s)
                    for s in doc.get("inner_sets", [])])


def config_snapshot(cfg: Config) -> dict:
    """The reconstruction recipe: NODE_SEED (the node's whole identity
    — session keys and jitter_seed derive from it), the quorum set, and
    every JSON-able knob that differs from a fresh ``Config()``."""
    defaults = Config()
    knobs = {}
    for key, dval in vars(defaults).items():
        if not key.isupper() or key in ("NODE_SEED", "QUORUM_SET"):
            continue
        val = getattr(cfg, key, dval)
        if val == dval:
            continue
        if _jsonable(val):
            knobs[key] = val
        else:
            log.warning("config snapshot: skipping non-JSON knob %s", key)
    doc = {"knobs": knobs,
           "quorum_set": quorum_set_to_json(cfg.QUORUM_SET)}
    if cfg.NODE_SEED is not None:
        doc["node_seed"] = cfg.NODE_SEED.seed.hex()
    return doc


def config_from_snapshot(doc: dict) -> Config:
    from ..crypto.keys import SecretKey
    cfg = Config()
    for key, val in doc.get("knobs", {}).items():
        setattr(cfg, key, val)
    cfg.QUORUM_SET = quorum_set_from_json(doc.get("quorum_set", {}))
    seed = doc.get("node_seed")
    if seed:
        cfg.NODE_SEED = SecretKey.from_seed(bytes.fromhex(seed))
    return cfg


def _jsonable(val) -> bool:
    if isinstance(val, (bool, int, float, str, type(None))):
        return True
    if isinstance(val, (list, tuple)):
        return all(_jsonable(v) for v in val)
    if isinstance(val, dict):
        return all(isinstance(k, str) and _jsonable(v)
                   for k, v in val.items())
    return False


class InputRecorder:
    """Attach as ``app.input_recorder`` and call :meth:`begin`. Hooked
    call sites check ``active`` before paying anything."""

    def __init__(self, app, path: Optional[str] = None,
                 extras: Optional[dict] = None):
        self.app = app
        self.path = path
        # driver-level determinism settings that live outside Config
        # (e.g. {"defer_completion": false}) — the replayer re-applies
        # the ones it knows after building the Application
        self.extras = dict(extras or {})
        self.active = False
        self.node_hex = app.config.node_id().hex() \
            if app.config.NODE_SEED is not None else ""
        self._writer: Optional[rlog.LogWriter] = None
        self._next_conn = 0
        self._chaos_counts: dict = {}
        self.frames = 0
        self.injects = 0
        self.chaos_records = 0
        self.ticks = 0

    # ----------------------------------------------------------- lifecycle --
    def begin(self) -> None:
        stream = None
        if self.path is not None:
            # create-only, same contract as dumptrace: an admin route
            # must never be a truncate-arbitrary-file primitive
            stream = open(self.path, "xb")
        self._writer = rlog.LogWriter(stream)
        self._writer.write_json(rlog.RT_HEADER, {
            "version": 1,
            "node": self.node_hex,
            "config": config_snapshot(self.app.config),
            "extras": self.extras,
        })
        chaos.add_observer(self._on_chaos)
        self.app.clock.crank_hooks.append(self._on_crank)
        self.active = True

    def finish(self, reason: str = "ok") -> dict:
        """Write the END marker and detach. A killed node never gets
        here — that absence (plus any torn tail) is itself recorded
        state the loader reports."""
        if not self.active:
            return {"records": 0, "bytes": 0}
        lm = self.app.ledger_manager
        self._writer.write_json(rlog.RT_END, {
            "ts": self._now(),
            "reason": reason,
            "lcl_seq": lm.get_last_closed_ledger_num(),
            "lcl_hash": lm.get_last_closed_ledger_hash().hex(),
        })
        self.active = False
        chaos.remove_observer(self._on_chaos)
        self._detach_clock()
        out = {"records": self._writer.records, "bytes": self._writer.bytes,
               "frames": self.frames, "injects": self.injects,
               "chaos": self.chaos_records, "ticks": self.ticks}
        if self.path is not None:
            out["path"] = self.path
            self._writer.close()
        return out

    def abort(self) -> None:
        """Detach WITHOUT an END marker — the simulated-kill path
        (Simulation.crash_node). The log ends mid-stream exactly like a
        real ``kill -9`` leaves it; what was flushed is what replays."""
        if not self.active:
            return
        self.active = False
        chaos.remove_observer(self._on_chaos)
        self._detach_clock()

    def _detach_clock(self) -> None:
        hooks = self.app.clock.crank_hooks
        if self._on_crank in hooks:
            hooks.remove(self._on_crank)

    def to_bytes(self) -> bytes:
        return self._writer.to_bytes()

    def to_log(self) -> rlog.InputLog:
        return rlog.InputLog.from_bytes(self.to_bytes())

    def _now(self) -> float:
        return self.app.clock.now()

    # --------------------------------------------------------------- hooks --
    def record_conn(self, peer, late: bool = False) -> int:
        conn = self._next_conn
        self._next_conn += 1
        peer._replay_conn_id = conn
        doc = {"ts": self._now(), "conn": conn, "role": peer.role.name}
        if late:
            # recording started mid-connection: the handshake was not
            # captured, so this conn cannot be faithfully replayed —
            # flagged for the replayer to refuse loudly
            doc["late"] = True
        self._writer.write_json(rlog.RT_CONN, doc)
        return conn

    def record_frame(self, peer, raw: bytes) -> None:
        conn = getattr(peer, "_replay_conn_id", None)
        if conn is None:
            conn = self.record_conn(peer, late=True)
        self._writer.write(rlog.RT_FRAME, rlog.encode_frame_payload(
            self._now(), conn, raw))
        self.frames += 1

    def record_mac_fail(self, peer) -> None:
        conn = getattr(peer, "_replay_conn_id", None)
        if conn is None:
            return
        self._writer.write(rlog.RT_MACFAIL, rlog._U32.pack(conn))

    def record_pdrop(self, peer, reason: str) -> None:
        conn = getattr(peer, "_replay_conn_id", None)
        if conn is None:
            return
        self._writer.write_json(rlog.RT_PDROP, {
            "ts": self._now(), "conn": conn, "reason": reason})

    def record_inject(self, envelopes, direct: bool = False) -> None:
        """External transaction submission. `envelopes` is a list of
        envelope XDR byte strings (or frames carrying ``.envelope``).
        `direct` marks the single-tx ``recv_transaction`` path (admin
        tx route, loadgen) so replay re-enters through the same
        admission gate."""
        raws = []
        for e in envelopes:
            if isinstance(e, (bytes, bytearray)):
                raws.append(bytes(e))
            else:
                raws.append(e.envelope.to_bytes())
        self._writer.write(rlog.RT_INJECT, rlog.encode_inject_payload(
            self._now(), raws, via=1 if direct else 0))
        self.injects += 1

    def record_admin(self, cmd: str, params: dict) -> None:
        if cmd not in RECORDED_ADMIN:
            return
        self._writer.write_json(rlog.RT_ADMIN, {
            "ts": self._now(), "cmd": cmd,
            "params": {k: str(v) for k, v in (params or {}).items()}})

    def _on_crank(self, phase: int, now: float) -> None:
        """Crank-hook (util.timer.VirtualClock.crank_hooks): one TICK
        per phase boundary. This is what serializes intra-instant
        ordering — an input recorded between a crank's START and
        DISPATCH ticks arrived before that crank's timers fired, one
        recorded after its END came from a driver between cranks."""
        self._writer.write(rlog.RT_TICK,
                           rlog.encode_tick_payload(now, phase))
        self.ticks += 1

    # ------------------------------------------------------ chaos observer --
    def _on_chaos(self, point: str, ctx: dict, kind, spec) -> None:
        """Called by the chaos engine on EVERY fire (injected or not):
        node-local matched-hit ordinals must count pass-throughs too, so
        the replayer's scripted engine lands the same fault on the same
        call."""
        if point in TRANSPORT_POINTS:
            return
        if ctx.get("node") != self.node_hex:
            return
        ordinal = self._chaos_counts.get(point, 0)
        self._chaos_counts[point] = ordinal + 1
        if kind is None:
            return
        doc = {"ts": self._now(), "point": point, "ordinal": ordinal,
               "kind": kind}
        if kind == "delay":
            doc["delay_s"] = spec.delay_ms / 1000.0
        elif kind == "bad_sig_flood":
            doc["burst"] = spec.burst
        self._writer.write_json(rlog.RT_CHAOS, doc)
        self.chaos_records += 1
