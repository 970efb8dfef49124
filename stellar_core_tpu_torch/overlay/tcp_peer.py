"""TCP transport for peers.

Reference: src/overlay/TCPPeer.{h,cpp} + PeerDoor.{h,cpp} — asio sockets
carrying length-prefixed AuthenticatedMessage frames. Here: non-blocking
stdlib sockets polled from the VirtualClock's io-poller hook, keeping
the single-main-thread discipline (docs/architecture.md:24-36). Frames
are 4-byte big-endian length + XDR bytes, matching the reference's
record-marking layout (high bit unused).
"""

from __future__ import annotations

import errno
import socket
import struct
from collections import deque
from typing import List, Optional

from ..util import chaos
from ..util.logging import get_logger
from .peer import Peer, PeerState
from .peer_auth import PeerRole

log = get_logger("Overlay")

MAX_FRAME = 32 * 1024 * 1024


class TCPPeer(Peer):
    def __init__(self, overlay, role: PeerRole, sock: socket.socket):
        super().__init__(overlay, role)
        self.sock = sock
        self.sock.setblocking(False)
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._rbuf = b""
        self._wbuf = b""
        # slow_link shaping (chaos.Shape at the overlay.send
        # seam): framed segments held until their release time, paced
        # by a byte/second token budget. Strictly FIFO — a shaped
        # frame never overtakes or is overtaken, so the MAC sequence
        # survives any latency/bandwidth shape. Empty (and unpaid for)
        # unless a slow_link spec is live on this edge.
        self._wqueue: deque = deque()     # (release_time, segment)
        self._shape_bps: Optional[float] = None
        self._shape_budget = 0.0
        self._shape_last: Optional[float] = None
        # crank-coalesced writes: frames buffered within a
        # crank flush as ONE socket write on the next crank's posted
        # actions — a 50-advert drain costs one syscall-shaped send,
        # not 50. The flush/frame counters make the coalescing ratio
        # observable (metrics route + Prometheus).
        self._flush_posted = False
        self._pending_frames = 0
        metrics = getattr(self.app, "metrics", None)
        if metrics is not None:
            self._flush_counter = metrics.new_counter(
                "overlay.tcp.write.flush")
            self._frames_counter = metrics.new_counter(
                "overlay.tcp.write.frames")
        else:
            self._flush_counter = self._frames_counter = None
        # socket deadlines (reference: Peer::startRecurrentTimer —
        # PEER_AUTHENTICATION_TIMEOUT / PEER_TIMEOUT): a black-holed
        # peer must not pin a connection slot forever. One recurrent
        # VirtualTimer per peer checks connect / handshake / idle
        # deadlines and tears the peer down through the standard drop
        # path on expiry. Loopback peers (virtual-time simulations)
        # carry no timer: their transport cannot black-hole.
        clock = self.app.clock
        self._t0 = clock.now()
        # inbound sockets arrive established; outbound ones are mid
        # non-blocking connect until the first byte moves
        self._established_at = self._t0 \
            if role == PeerRole.REMOTE_CALLED_US else None
        self._last_read = self._t0
        self._last_keepalive = self._t0
        self._deadline_timer = None
        cfg = self.app.config
        deadlines = [d for d in (cfg.PEER_CONNECT_TIMEOUT,
                                 cfg.PEER_AUTHENTICATION_TIMEOUT,
                                 cfg.PEER_TIMEOUT) if d and d > 0]
        if deadlines:
            from ..util.timer import VirtualTimer
            self._check_interval = max(0.1, min(1.0, min(deadlines) / 2))
            self._deadline_timer = VirtualTimer(clock)
            self._arm_deadline_timer()

    def _arm_deadline_timer(self) -> None:
        if self._deadline_timer is None:
            # the keepalive send inside _check_deadlines can itself hit
            # a dead socket and drop the peer (which clears the timer);
            # re-arming after that would dereference None
            return
        self._deadline_timer.expires_from_now(self._check_interval)
        self._deadline_timer.async_wait(self._check_deadlines)

    def _check_deadlines(self) -> None:
        if self.state == PeerState.CLOSING:
            return
        cfg = self.app.config
        now = self.app.clock.now()
        if self._established_at is None:
            if cfg.PEER_CONNECT_TIMEOUT > 0 and \
                    now - self._t0 > cfg.PEER_CONNECT_TIMEOUT:
                self.drop("connect timeout")
                return
        elif self.state != PeerState.GOT_AUTH:
            if cfg.PEER_AUTHENTICATION_TIMEOUT > 0 and \
                    now - self._established_at > \
                    cfg.PEER_AUTHENTICATION_TIMEOUT:
                self.drop("handshake timeout")
                return
        elif cfg.PEER_TIMEOUT > 0:
            idle = now - self._last_read
            if idle > cfg.PEER_TIMEOUT:
                self.drop("idle timeout")
                return
            if idle > cfg.PEER_TIMEOUT / 2 and \
                    now - self._last_keepalive > cfg.PEER_TIMEOUT / 2:
                # keepalive (reference: the recurrent timer PINGS as
                # well as drops, so an idle-but-healthy link generates
                # read traffic instead of being shot): GET_PEERS is
                # non-flood-controlled and elicits a PEERS reply that
                # refreshes _last_read on both ends; a black-holed
                # peer stays silent and still hits the full deadline
                self._last_keepalive = now
                from ..xdr.overlay import MessageType, StellarMessage
                self.send_message(
                    StellarMessage(MessageType.GET_PEERS))
            self._arm_deadline_timer()
            return
        self._arm_deadline_timer()

    # ----------------------------------------------------------- transport --
    def _send_bytes(self, raw: bytes) -> None:
        shape = None
        if chaos.ENABLED:
            # chaos seam: io_error raises (OSError — routed through the
            # standard drop path by _send_message), drop loses the
            # frame, corrupt flips one byte before framing, slow_link
            # returns a Shape (delay + bandwidth) this frame is paced
            # by; sentinels with no transport meaning (REORDER/FAIL)
            # leave it intact
            out = chaos.point("overlay.send", raw, transport="tcp",
                              now=self.app.clock.now(),
                              **self._chaos_ctx())
            if out is chaos.DROP:
                return
            if isinstance(out, chaos.Shape):
                shape = out
            elif isinstance(out, (bytes, bytearray)):
                raw = out
        framed = struct.pack(">I", len(raw)) + raw
        if shape is not None or self._wqueue:
            # shaped path. An unshaped frame arriving while shaped
            # segments are pending queues BEHIND them (release clamped
            # monotonic): FIFO survives the shape window's edges.
            now = self.app.clock.now()
            release = now + (shape.delay_s if shape is not None else 0.0)
            if self._wqueue and release < self._wqueue[-1][0]:
                release = self._wqueue[-1][0]
            self._wqueue.append((release, framed))
            if shape is not None:
                self._shape_bps = shape.bytes_per_s
        else:
            self._wbuf += framed
        self._pending_frames += 1
        # coalesce: don't write per frame — schedule ONE flush for the
        # crank boundary so every frame produced this crank (an advert
        # drain, an SCP broadcast burst, a demand answer batch) leaves
        # in a single buffered send
        if not self._flush_posted:
            self._flush_posted = True
            self.app.clock.post(self._posted_flush)

    def _posted_flush(self) -> None:
        self._flush_posted = False
        if self.state == PeerState.CLOSING:
            return
        self._flush()

    def _drain_shaped(self) -> None:
        """Move shaped segments whose release time has passed into the
        write buffer, paced by the token budget when the shape carries
        a bandwidth. Called from every flush: delivery granularity is
        the io-poll/crank cadence, which is exactly the granularity a
        real kernel-scheduled slow link shows the application."""
        if not self._wqueue:
            return
        now = self.app.clock.now()
        bps = self._shape_bps
        if bps:
            if self._shape_last is not None:
                self._shape_budget += (now - self._shape_last) * bps
            self._shape_last = now
            # cap the accumulated allowance: an idle gap must not bank
            # into a burst that defeats the throttle
            cap = max(bps * 0.25, 65536.0)
            if self._shape_budget > cap:
                self._shape_budget = cap
        while self._wqueue and self._wqueue[0][0] <= now:
            release, seg = self._wqueue[0]
            if bps:
                take = min(len(seg), int(self._shape_budget))
                if take <= 0:
                    break
                self._shape_budget -= take
            else:
                take = len(seg)
            self._wbuf += seg[:take]
            if take == len(seg):
                self._wqueue.popleft()
            else:
                self._wqueue[0] = (release, seg[take:])

    def _flush(self) -> int:
        self._drain_shaped()
        if self._pending_frames:
            if self._flush_counter is not None:
                self._flush_counter.inc()
                self._frames_counter.inc(self._pending_frames)
            self._pending_frames = 0
        sent = 0
        while self._wbuf:
            try:
                n = self.sock.send(self._wbuf)
            except BlockingIOError:
                break
            except OSError as e:
                self.drop(f"send error: {e}")
                return sent
            if n <= 0:
                break
            if self._established_at is None:
                # first byte moved: the non-blocking connect completed
                self._established_at = self.app.clock.now()
            self._wbuf = self._wbuf[n:]
            sent += n
        return sent

    def poll(self) -> int:
        """One io-poller pass: flush writes, drain reads, dispatch
        complete frames. Returns work units done."""
        if self.state == PeerState.CLOSING:
            return 0
        work = 1 if self._flush() else 0
        while True:
            try:
                chunk = self.sock.recv(65536)
            except BlockingIOError:
                break
            except OSError as e:
                self.drop(f"recv error: {e}")
                return work
            if not chunk:
                self.drop("connection closed by remote")
                return work
            now = self.app.clock.now()
            self._last_read = now
            if self._established_at is None:
                self._established_at = now
            if chaos.ENABLED:
                # the received chunk is the payload: io_error takes the
                # same drop path a real socket error would, drop loses
                # the chunk, corrupt flips one byte (lands as a framing
                # /MAC failure downstream)
                try:
                    out = chaos.point("overlay.recv", chunk,
                                      transport="tcp",
                                      **self._chaos_ctx())
                except OSError as e:
                    self.drop(f"recv error: {e}")
                    return work
                if out is chaos.DROP:
                    continue
                if isinstance(out, (bytes, bytearray)):
                    chunk = out
            self._rbuf += chunk
            work += 1
        while len(self._rbuf) >= 4:
            (length,) = struct.unpack(">I", self._rbuf[:4])
            if length > MAX_FRAME:
                self.drop("oversized frame")
                return work
            if len(self._rbuf) < 4 + length:
                break
            frame = self._rbuf[4:4 + length]
            self._rbuf = self._rbuf[4 + length:]
            self.recv_bytes(frame)
            work += 1
        return work

    def _close_transport(self) -> None:
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
            self._deadline_timer = None
        self._flush()
        try:
            self.sock.close()
        except OSError:
            pass


class PeerDoor:
    """Listening socket accepting inbound peers (reference:
    overlay/PeerDoor.{h,cpp})."""

    def __init__(self, overlay, port: int):
        self.overlay = overlay
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", port))
        self.sock.listen(16)
        self.sock.setblocking(False)
        self.port = self.sock.getsockname()[1]

    def poll(self) -> int:
        n = 0
        while True:
            try:
                conn, _addr = self.sock.accept()
            except BlockingIOError:
                break
            except OSError:
                break
            peer = TCPPeer(self.overlay, PeerRole.REMOTE_CALLED_US, conn)
            self.overlay.add_pending_peer(peer)
            self.overlay.register_tcp_peer(peer)
            peer.connect_handler()
            n += 1
        return n

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def connect_to(overlay, host: str, port: int) -> Optional[TCPPeer]:
    """Outbound connection (reference: OverlayManagerImpl::connectTo)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setblocking(False)
    try:
        sock.connect((host, port))
    except BlockingIOError:
        pass
    except OSError as e:
        if e.errno != errno.EINPROGRESS:
            log.debug("connect to %s:%d failed: %s", host, port, e)
            sock.close()
            return None
    peer = TCPPeer(overlay, PeerRole.WE_CALLED_REMOTE, sock)
    overlay.add_pending_peer(peer)
    overlay.register_tcp_peer(peer)
    peer.connect_handler()
    return peer
