"""Peer connection state machine.

Reference: src/overlay/Peer.{h,cpp} — handshake
(HELLO → HELLO → AUTH → AUTH, :125,350,907-914,1369-1430), HMAC-framed
`AuthenticatedMessage`s with per-direction sequence numbers
(:690,739-749), and the big message dispatch (:519-585). Transport
(loopback queues or TCP) lives in subclasses via `_send_bytes`;
everything protocol lives here.
"""

from __future__ import annotations

import os
import struct
from enum import Enum
from typing import Callable, Optional

from ..crypto.sha import hmac_sha256, hmac_sha256_verify
from ..util import chaos, tracing
from ..util.logging import get_logger
from ..xdr.overlay import (Auth, AuthenticatedMessage, Error, ErrorCode,
                           Hello, MessageType, StellarMessage,
                           _AuthenticatedMessageV0)
from ..xdr.types import PublicKey
from . import wire
from .flow_control import FlowControl, is_flow_controlled
from .peer_auth import PeerRole

log = get_logger("Overlay")

OVERLAY_VERSION = 29          # current overlay protocol (reference Config)
OVERLAY_MIN_VERSION = 27
VERSION_STR = b"stellar-core-tpu dev"


class PeerState(Enum):
    # reference: Peer.h PeerState
    CONNECTING = 0
    CONNECTED = 1
    GOT_HELLO = 2
    GOT_AUTH = 3
    CLOSING = 4


class Peer:
    def __init__(self, overlay, role: PeerRole):
        self.overlay = overlay
        self.app = overlay.app
        self.role = role
        self.state = PeerState.CONNECTING
        self.peer_id: Optional[bytes] = None     # remote node id (raw)
        self.remote_listening_port = 0
        self.remote_version = ""
        self.remote_overlay_version = 0
        self.local_nonce = os.urandom(32)
        self.remote_nonce: Optional[bytes] = None
        self.remote_pub: Optional[bytes] = None  # remote session X25519
        self.send_mac_key: Optional[bytes] = None
        self.recv_mac_key: Optional[bytes] = None
        self.send_mac_seq = 0
        self.recv_mac_seq = 0
        self.flow = FlowControl(self.app.config,
                                getattr(overlay, "encode_counters",
                                        None),
                                getattr(overlay, "flow_drop_counters",
                                        None))
        self._chaos_held: list = []   # messages held back by a reorder fault
        self.messages_read = 0
        self.messages_written = 0
        self.bytes_read = 0
        self.bytes_written = 0
        # redundant flood deliveries attributed to this peer (a tx or
        # SCP envelope this node had already seen): the per-link share
        # of the mesh's flood redundancy, on the `peers` route
        self.duplicate_messages = 0
        # invalid-signature transactions attributed to this peer
        # (overlay/manager.py batched-admission accounting): past
        # PEER_BAD_SIG_DROP_THRESHOLD the peer is dropped
        self.bad_sig_drops = 0
        # flood frames from this peer dropped by the adaptive
        # controller's surge gate BEFORE verify dispatch
        # (ops/controller.py) — load accounting, not a sanction
        self.shed_drops = 0
        # single-flight demand accounting (tx_advert.py
        # TxDemandsManager): FLOOD_DEMANDs we sent this peer, bodies
        # it answered with, demands it let time out, and demands
        # re-routed TO it after another peer timed out — the per-link
        # view of pull-mode flooding on the `peers` route
        self.demand_sent = 0
        self.demand_fulfilled = 0
        self.demand_timeout = 0
        self.demand_retry = 0
        # aggregate overlay.peer.* meters (per-peer counts live on the
        # peer object and surface via the `peers` admin route; the
        # registry meters feed `metrics` + the survey tooling)
        metrics = getattr(self.app, "metrics", None)
        if metrics is not None:
            self._msg_out_meter = metrics.new_meter(
                "overlay.peer.message.sent")
            self._msg_in_meter = metrics.new_meter(
                "overlay.peer.message.received")
            self._byte_out_meter = metrics.new_meter(
                "overlay.peer.byte.sent", "byte")
            self._byte_in_meter = metrics.new_meter(
                "overlay.peer.byte.received", "byte")
        else:
            self._msg_out_meter = self._msg_in_meter = None
            self._byte_out_meter = self._byte_in_meter = None

    def reset_traffic_counters(self) -> None:
        """`clearmetrics` hook: zero the per-peer message/byte/
        duplicate counters so bench legs in one process measure from a
        clean slate. Bad-sig accounting deliberately survives — it
        feeds the PEER_BAD_SIG_DROP_THRESHOLD security drop."""
        self.messages_read = self.messages_written = 0
        self.bytes_read = self.bytes_written = 0
        self.duplicate_messages = 0
        # shed accounting resets with the controller state (the
        # clearmetrics clean-slate contract); bad-sig survives above
        self.shed_drops = 0
        self.demand_sent = self.demand_fulfilled = 0
        self.demand_timeout = self.demand_retry = 0

    # ----------------------------------------------------------- identity --
    def is_authenticated(self) -> bool:
        return self.state == PeerState.GOT_AUTH

    def __repr__(self):
        pid = self.peer_id.hex()[:8] if self.peer_id else "?"
        return f"<Peer {pid} {self.role.name} {self.state.name}>"

    def _chaos_ctx(self) -> dict:
        """Context for chaos injection points: `node` is the local node
        running this peer object, `peer` the remote (when known)."""
        cfg = self.app.config
        return {
            "node": cfg.node_id().hex() if cfg.NODE_SEED is not None
            else "",
            "peer": self.peer_id.hex() if self.peer_id else "",
        }

    # ------------------------------------------------------------ lifecycle --
    def connect_handler(self) -> None:
        """Transport established; the caller speaks first (reference:
        connectHandler → sendHello)."""
        rec = getattr(self.app, "input_recorder", None)
        if rec is not None and rec.active:
            # input log (replay/recorder.py): connections are numbered
            # in establishment order; every recorded frame refers back
            # to its conn id
            rec.record_conn(self)
        self.state = PeerState.CONNECTED
        if self.role == PeerRole.WE_CALLED_REMOTE:
            self.send_hello()

    def drop(self, reason: str = "") -> None:
        if self.state == PeerState.CLOSING:
            return
        rec = getattr(self.app, "input_recorder", None)
        if rec is not None and rec.active:
            # protocol drops re-derive on replay (the PDROP is then an
            # idempotent no-op); driver drops — a crashed partner — only
            # exist in the log
            rec.record_pdrop(self, reason)
        self.state = PeerState.CLOSING
        log.debug("dropping peer %r: %s", self, reason)
        self.overlay.record_drop_reason(reason)
        self.overlay.peer_dropped(self)
        self._close_transport()

    def _close_transport(self) -> None:
        pass

    # ------------------------------------------------------------ sending --
    def send_hello(self) -> None:
        cfg = self.app.config
        lcl = self.app.ledger_manager.get_last_closed_ledger_header()
        hello = Hello(
            ledgerVersion=lcl.ledgerVersion,
            overlayVersion=cfg.OVERLAY_PROTOCOL_VERSION,
            overlayMinVersion=cfg.OVERLAY_PROTOCOL_MIN_VERSION,
            networkID=cfg.network_id(),
            versionStr=(cfg.VERSION_STR.encode()[:100]
                        if cfg.VERSION_STR else VERSION_STR),
            listeningPort=cfg.PEER_PORT,
            peerID=PublicKey.ed25519(cfg.node_id()),
            cert=self.overlay.peer_auth.get_auth_cert(),
            nonce=self.local_nonce)
        self._send_message(StellarMessage(MessageType.HELLO, hello))

    def send_auth(self) -> None:
        self._send_message(StellarMessage(MessageType.AUTH, Auth(flags=0)))

    def send_error_and_drop(self, code: ErrorCode, msg: str) -> None:
        try:
            self._send_message(StellarMessage(
                MessageType.ERROR_MSG,
                Error(code=code, msg=msg.encode()[:100])))
        finally:
            self.drop(msg)

    def send_message(self, msg: StellarMessage) -> None:
        """Public send — flood messages respect flow-control credit."""
        if self.state == PeerState.CLOSING:
            return
        if chaos.ENABLED:
            # link-level chaos seam: a `partition` or `flap`
            # spec matching this edge severs the connection outright —
            # the minority side stalls, the jittered redial re-knits
            # the mesh after heal. Checked per send because a link cut
            # is a condition, not an event: the first send inside the
            # window kills the link.
            link = chaos.point("overlay.link", None,
                               now=self.app.clock.now(),
                               **self._chaos_ctx())
            if link is chaos.DROP:
                self.drop("link down: chaos partition/flap")
                return
            # message-level chaos seam, BEFORE the HMAC sequence number
            # is assigned: a dropped or held-back message models a lossy
            # / reordering network without violating the MAC sequence
            # (transport-level loss is the `overlay.send` seam and —
            # correctly — kills the link like a real socket would)
            out = chaos.point("overlay.message", msg,
                              **self._chaos_ctx())
            if out is chaos.DROP:
                return
            if out is chaos.REORDER:
                self._chaos_held.append(msg)
                return
        ready = self.flow.try_send(msg)
        if ready is not None:
            self._send_message(ready)
        if self._chaos_held:
            # flush reorder-held messages AFTER the one just sent — a
            # deterministic one-slot delivery reordering. Deliberately
            # NOT gated on chaos.ENABLED (an empty-list check when
            # disabled): a message held when the engine is uninstalled
            # must still go out on the next send rather than silently
            # degrade the declared reorder into a drop. A reorder on a
            # peer's FINAL send does stay held — schedule reorders
            # mid-stream, not on the last message.
            held, self._chaos_held = self._chaos_held, []
            for m in held:
                ready = self.flow.try_send(m)
                if ready is not None:
                    self._send_message(ready)

    def _send_message(self, msg: StellarMessage) -> None:
        """Frame with sequence + HMAC and hand to the transport.

        Serialize-once: the body is encoded at most once
        per message OBJECT — a broadcast to N peers pays one XDR
        encoding, then each peer splices its own ~40 bytes of
        sequence + MAC around the shared body. Byte-identical to
        framing through `AuthenticatedMessage.to_bytes()` (parity
        pinned by tests/test_wire_path.py)."""
        if self.state == PeerState.CLOSING:
            return
        body = wire.body_bytes(msg, self.overlay.encode_counters)
        mac = b"\x00" * wire.MAC_LEN
        seq = 0
        if self.send_mac_key is not None and \
                msg.disc not in (MessageType.HELLO, MessageType.ERROR_MSG):
            seq = self.send_mac_seq
            mac = hmac_sha256(self.send_mac_key,
                              struct.pack(">Q", seq) + body)
            self.send_mac_seq += 1
        raw = wire.assemble_frame(seq, body, mac)
        self.messages_written += 1
        self.bytes_written += len(raw)
        if self._msg_out_meter is not None:
            self._msg_out_meter.mark()
            self._byte_out_meter.mark(len(raw))
        if tracing.ENABLED:
            rec = self.app.flight_recorder
            if rec.active:
                rec.instant("overlay.send", {
                    "type": msg.disc.name, "bytes": len(raw),
                    "peer": self.peer_id.hex()[:8]
                    if self.peer_id else "?"})
        try:
            self._send_bytes(raw)
        except OSError as e:
            # a transport error mid-write tears the peer down through
            # the standard drop path (flow-control state goes with the
            # peer, floodgate/fetchers unsubscribe in peer_dropped) and
            # must never unwind into the caller's scheduler loop
            self.drop(f"send error: {e}")

    def _send_bytes(self, raw: bytes) -> None:
        raise NotImplementedError

    # ----------------------------------------------------------- receiving --
    def recv_bytes(self, raw: bytes) -> None:
        rec = getattr(self.app, "input_recorder", None)
        if rec is not None and rec.active:
            # record BEFORE parsing: a malformed frame must replay as
            # the same malformed bytes (serialize-once — `raw` is the
            # exact wire slice, never re-encoded)
            rec.record_frame(self, raw)
        self.bytes_read += len(raw)
        if self._byte_in_meter is not None:
            self._byte_in_meter.mark(len(raw))
        try:
            amsg = AuthenticatedMessage.from_bytes(raw)
        except Exception as e:
            self.send_error_and_drop(ErrorCode.ERR_DATA,
                                     f"malformed message: {e}")
            return
        self.recv_authenticated_message(amsg.value, frame=raw)

    def recv_authenticated_message(self, v0: _AuthenticatedMessageV0,
                                   frame: Optional[bytes] = None
                                   ) -> None:
        """`frame`, when given, is the exact wire frame `v0` was parsed
        from: the MAC is verified over the received slice
        `frame[4:-32]` (sequence ‖ body as transmitted) instead of
        re-encoding the parsed message — one XDR encoding saved per
        delivery, and strictly more faithful: a corrupted byte the
        parser tolerates (e.g. a flipped padding byte the re-encoding
        would canonicalize away) now still fails the MAC, exactly as
        the reference verifying over the received buffer does."""
        msg = v0.message
        if msg.disc not in (MessageType.HELLO, MessageType.ERROR_MSG):
            if self.recv_mac_key is not None:
                if v0.sequence != self.recv_mac_seq:
                    self.send_error_and_drop(ErrorCode.ERR_AUTH,
                                             "unexpected auth sequence")
                    return
                if not self._verify_frame_mac(v0, frame):
                    rec = getattr(self.app, "input_recorder", None)
                    if rec is not None and rec.active:
                        # MAC keys derive from per-connection random
                        # nonces and ephemeral session keys, so replay
                        # cannot re-verify — the verdict itself is the
                        # recorded input (replay/log.py MACFAIL)
                        rec.record_mac_fail(self)
                    self.send_error_and_drop(ErrorCode.ERR_AUTH,
                                             "unexpected MAC")
                    return
                self.recv_mac_seq += 1
        if frame is not None:
            # the wire slice IS the body's canonical bytes: seed the
            # serialize-once cache so the rebroadcast path (SCP
            # gossip), the flood hash and flow-control sizing never
            # re-encode a message this node merely relays
            wire.seed_body(msg, frame[wire.BODY_OFFSET:-wire.MAC_LEN])
        self.messages_read += 1
        self.recv_message(msg)

    def _verify_frame_mac(self, v0: _AuthenticatedMessageV0,
                          frame: Optional[bytes]) -> bool:
        """Check the frame HMAC. A seam, not just a helper: MAC keys
        derive from per-connection random nonces + ephemeral session
        keys, so a replayed node cannot recompute them — the replay
        peer overrides this to return the verdict recorded live."""
        if frame is not None:
            return hmac_sha256_verify(
                self.recv_mac_key, frame[4:-wire.MAC_LEN],
                frame[-wire.MAC_LEN:])
        return hmac_sha256_verify(
            self.recv_mac_key,
            struct.pack(">Q", v0.sequence) + v0.message.to_bytes(),
            bytes(v0.mac.mac))

    def recv_message(self, msg: StellarMessage) -> None:
        """Dispatch (reference: Peer::recvMessage :519-585). When a
        trace is on, each dispatched message is a span on this thread's
        track — per-peer, per-type — so cross-subsystem causality
        (recv → herder → close) nests under it."""
        if self._msg_in_meter is not None:
            self._msg_in_meter.mark()
        if tracing.ENABLED:
            rec = self.app.flight_recorder
            if rec.active:
                rec.begin("overlay.recv", {
                    "type": msg.disc.name,
                    "peer": self.peer_id.hex()[:8]
                    if self.peer_id else "?"})
                try:
                    self._recv_message(msg)
                finally:
                    rec.end("overlay.recv")
                return
        self._recv_message(msg)

    def _recv_message(self, msg: StellarMessage) -> None:
        t = msg.disc
        # messages legal before full auth
        if self.state != PeerState.GOT_AUTH and t not in (
                MessageType.HELLO, MessageType.AUTH, MessageType.ERROR_MSG):
            self.send_error_and_drop(ErrorCode.ERR_MISC,
                                     "received before auth")
            return
        if t == MessageType.HELLO:
            self._recv_hello(msg.value)
            return
        if t == MessageType.AUTH:
            self._recv_auth()
            return
        if t == MessageType.ERROR_MSG:
            log.debug("peer %r sent error: %s", self, msg.value.msg)
            self.drop(f"remote error: {msg.value.msg}")
            return
        if not self.flow.on_message_received(msg):
            self.send_error_and_drop(ErrorCode.ERR_LOAD,
                                     "flood capacity exceeded")
            return
        if t in (MessageType.SEND_MORE, MessageType.SEND_MORE_EXTENDED):
            self._recv_send_more(msg)
            return
        # everything else is overlay/herder level
        self.overlay.handle_message(self, msg)
        reclaim = self.flow.maybe_send_more(msg)
        if reclaim is not None:
            self._send_message(reclaim)

    # ----------------------------------------------------------- handshake --
    def _recv_hello(self, hello: Hello) -> None:
        if self.state != PeerState.CONNECTED:
            self.send_error_and_drop(ErrorCode.ERR_MISC,
                                     "unexpected HELLO")
            return
        cfg = self.app.config
        if bytes(hello.networkID) != cfg.network_id():
            self.send_error_and_drop(ErrorCode.ERR_CONF,
                                     "wrong network passphrase")
            return
        our_version = cfg.OVERLAY_PROTOCOL_VERSION
        our_min = cfg.OVERLAY_PROTOCOL_MIN_VERSION
        if hello.overlayMinVersion > our_version or \
                hello.overlayVersion < our_min:
            self.send_error_and_drop(ErrorCode.ERR_CONF,
                                     "incompatible overlay version")
            return
        remote_id = bytes(hello.peerID.value)
        if remote_id == cfg.node_id():
            self.send_error_and_drop(ErrorCode.ERR_CONF,
                                     "connecting to self")
            return
        if not self.overlay.peer_auth.verify_remote_cert(
                remote_id, hello.cert):
            self.send_error_and_drop(ErrorCode.ERR_AUTH, "bad auth cert")
            return
        self.peer_id = remote_id
        self.remote_nonce = bytes(hello.nonce)
        self.remote_pub = bytes(hello.cert.pubkey.key)
        self.remote_listening_port = hello.listeningPort
        self.remote_version = bytes(hello.versionStr).decode("utf-8", "replace")
        self.remote_overlay_version = hello.overlayVersion
        pa = self.overlay.peer_auth
        self.send_mac_key = pa.get_sending_mac_key(
            self.remote_pub, self.local_nonce, self.remote_nonce, self.role)
        self.recv_mac_key = pa.get_receiving_mac_key(
            self.remote_pub, self.local_nonce, self.remote_nonce, self.role)
        self.send_mac_seq = 0
        self.recv_mac_seq = 0
        self.state = PeerState.GOT_HELLO
        if self.role == PeerRole.REMOTE_CALLED_US:
            self.send_hello()
        else:
            self.send_auth()

    def _recv_auth(self) -> None:
        if self.state != PeerState.GOT_HELLO:
            self.send_error_and_drop(ErrorCode.ERR_MISC, "unexpected AUTH")
            return
        self.state = PeerState.GOT_AUTH
        if self.role == PeerRole.REMOTE_CALLED_US:
            self.send_auth()
        # grant initial flood capacity (reference: sendSendMore post-auth)
        self._send_message(self.flow.initial_send_more(self.app.config))
        self.overlay.peer_authenticated(self)

    def _recv_send_more(self, msg: StellarMessage) -> None:
        if msg.disc == MessageType.SEND_MORE:
            n, b = msg.value.numMessages, 2**32 - 1
        else:
            n, b = msg.value.numMessages, msg.value.numBytes
        for ready in self.flow.on_send_more(n, b):
            self._send_message(ready)
