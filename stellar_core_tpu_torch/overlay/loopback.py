"""In-memory peer pair for hermetic multi-node tests.

Reference: src/overlay/test/LoopbackPeer.{h,cpp} — two Peer objects
joined by in-memory queues, with fault-injection knobs: probabilistic
corruption, drops, duplication and reordering (LoopbackPeer.h:36-103).
Delivery is explicit (`deliver_all`/`deliver_one`) or scheduled on the
shared VirtualClock, keeping tests deterministic.
"""

from __future__ import annotations

import random
from collections import deque
from typing import Deque, Optional

from ..util import chaos
from ..util.logging import get_logger
from .peer import Peer, PeerRole

log = get_logger("Overlay")


class LoopbackPeer(Peer):
    def __init__(self, overlay, role: PeerRole):
        super().__init__(overlay, role)
        self.partner: Optional["LoopbackPeer"] = None
        self.out_queue: Deque[bytes] = deque()
        # fault injection (reference: LoopbackPeer.h damage/drop knobs)
        self.damage_prob = 0.0
        self.drop_prob = 0.0
        self.duplicate_prob = 0.0
        self.reorder_prob = 0.0
        self._rng = random.Random(0x5EED)
        self.corrupt_cert = False
        # per-link latency/bandwidth model: when latency (or
        # a bandwidth cap) is set, sends schedule delivery on the
        # shared VirtualClock instead of the immediate out_queue — 100
        # nodes × latency costs virtual time only, never wall time.
        # Same-latency messages keep FIFO order (the clock heap breaks
        # ties by schedule sequence).
        self.link_latency_s = 0.0
        self.link_bytes_per_s: Optional[float] = None
        # virtual arrival time of the last scheduled TRANSIT delivery:
        # a link transmits SERIALLY, so a later send never overtakes an
        # earlier one (else a small frame scheduled behind a large one
        # under the bandwidth model — or behind a delay-faulted one —
        # would arrive first and the MAC sequence check would kill the
        # authenticated link)
        self._last_arrival = 0.0
        # same clamp for the FINAL hop when a recv-side delay fault is
        # holding a message: later arrivals queue behind the held one
        self._final_hold = 0.0

    def _link_delay_s(self, nbytes: int) -> float:
        d = self.link_latency_s
        if self.link_bytes_per_s:
            d += nbytes / self.link_bytes_per_s
        return d

    def _schedule_delivery(self, raw: bytes, seconds: float) -> None:
        """Deliver `raw` to the partner `seconds` of VIRTUAL time from
        now — the shared path for the latency model and the chaos
        `delay` fault (docs/SIMULATION.md). Arrivals are clamped FIFO
        per link (serial transmission). The receive-side chaos seam
        still runs at delivery time, so latency and recv faults
        compose."""
        clock = self.app.clock
        arrival = max(clock.now() + seconds, self._last_arrival)
        self._last_arrival = arrival
        clock.schedule_at(arrival,
                          lambda err: self._deliver_to_partner(raw))

    def _send_bytes(self, raw: bytes) -> None:
        if chaos.ENABLED:
            # chaos seam (the scheduled, seeded superset of the
            # probabilistic knobs below): drop / corrupt / reorder /
            # delay / io_error on the send side
            out = chaos.point("overlay.send", raw, transport="loopback",
                              _can_delay=True, now=self.app.clock.now(),
                              **self._chaos_ctx())
            if out is chaos.DROP:
                return
            if isinstance(out, chaos.Shape):
                # slow_link: the Shape's latency+bandwidth
                # ride the same virtual-time transit path as the link
                # model — FIFO-clamped, so shaped frames never trip
                # the MAC sequence
                extra = (len(raw) / out.bytes_per_s
                         if out.bytes_per_s else 0.0)
                self._schedule_delivery(raw, out.delay_s + extra)
                return
            if out is chaos.REORDER:
                # deliver this message BEFORE the previously queued one
                self.out_queue.append(raw)
                if len(self.out_queue) > 1:
                    self.out_queue[-1], self.out_queue[-2] = \
                        self.out_queue[-2], self.out_queue[-1]
                return
            if isinstance(out, chaos.Delay):
                # virtual-time delay fault: delivery deferred on the
                # clock (never a wall sleep — the single-process sim
                # would stall every node at once)
                self._schedule_delivery(bytes(out.payload), out.seconds)
                return
            if isinstance(out, (bytes, bytearray)):
                raw = out
        if self._rng.random() < self.drop_prob:
            return
        if self._rng.random() < self.damage_prob and raw:
            i = self._rng.randrange(len(raw))
            raw = raw[:i] + bytes([raw[i] ^ 0xFF]) + raw[i + 1:]
        delay_s = self._link_delay_s(len(raw))
        if delay_s > 0.0 or self._last_arrival > self.app.clock.now():
            # modeled link — or an earlier delayed delivery still in
            # flight (a partial-coverage delay fault): transit rides
            # the clock, FIFO-clamped, so an undelayed send never
            # overtakes a delayed one and trips the MAC sequence
            # check. The queue-order knobs (duplicate/reorder) apply
            # only to undelayed links
            self._schedule_delivery(raw, delay_s)
            return
        self.out_queue.append(raw)
        if self._rng.random() < self.duplicate_prob:
            self.out_queue.append(raw)
        if len(self.out_queue) > 1 and \
                self._rng.random() < self.reorder_prob:
            i = self._rng.randrange(len(self.out_queue) - 1)
            q = list(self.out_queue)
            q[i], q[-1] = q[-1], q[i]
            self.out_queue = deque(q)

    def deliver_one(self) -> bool:
        if not self.out_queue or self.partner is None:
            return False
        raw = self.out_queue.popleft()
        self._deliver_to_partner(raw)
        return True

    def _deliver_to_partner(self, raw: bytes) -> None:
        """Terminal delivery step (immediate queue pump AND scheduled
        latency/delay arrivals): run the receive-side chaos seam, then
        hand the bytes to the partner. The link may have been severed
        (crash/churn) while a delivery was in flight — those bytes are
        gone, like packets to a dead host."""
        if self.partner is None:
            return
        if chaos.ENABLED:
            # receive-side seam: ctx `node` is the RECEIVER
            try:
                out = chaos.point("overlay.recv", raw,
                                  transport="loopback", _can_delay=True,
                                  **self.partner._chaos_ctx())
            except OSError as e:
                # same contract as a TCP recv error: the receiving
                # peer takes the standard drop path; the crank loop
                # never sees the exception (SimulatedCrash, a
                # BaseException, still unwinds to the app boundary)
                self.partner.drop(f"recv error: {e}")
                return
            if out is chaos.DROP:
                return
            if isinstance(out, chaos.Delay):
                # recv-side delay: schedule the FINAL hop directly —
                # re-running the seam at arrival would consume another
                # hit (a prob-1.0 delay spec would defer forever)
                self._schedule_final(bytes(out.payload), out.seconds)
                return
            if isinstance(out, (bytes, bytearray)):
                raw = out
        if self._final_hold > self.app.clock.now():
            # an earlier recv-delayed delivery is still being held:
            # keep the link FIFO past it
            self._schedule_final(raw, 0.0)
            return
        self._deliver_final(raw)

    def _schedule_final(self, raw: bytes, seconds: float) -> None:
        """Schedule the final hop (post-recv-seam), FIFO-clamped
        against other HELD finals — transit ordering was already
        guaranteed when the transit delivery was scheduled."""
        clock = self.app.clock
        arrival = max(clock.now() + seconds, self._final_hold)
        self._final_hold = arrival
        clock.schedule_at(arrival, lambda err: self._deliver_final(raw))

    def _deliver_final(self, raw: bytes) -> None:
        p = self.partner
        if p is not None and p.state.name != "CLOSING":
            p.recv_bytes(raw)

    def deliver_all(self) -> int:
        n = 0
        while self.deliver_one():
            n += 1
        return n

    def _close_transport(self) -> None:
        # queued bytes (e.g. a final ERROR_MSG) still flush to the
        # partner, as a real socket close would after send
        pass


class LoopbackPeerConnection:
    """Wire two applications' overlays together (reference:
    LoopbackPeerConnection in LoopbackPeer.h)."""

    def __init__(self, app_initiator, app_acceptor,
                 latency_s: float = 0.0,
                 bandwidth_bps: Optional[float] = None):
        self.initiator = LoopbackPeer(app_initiator.overlay_manager,
                                      PeerRole.WE_CALLED_REMOTE)
        self.acceptor = LoopbackPeer(app_acceptor.overlay_manager,
                                     PeerRole.REMOTE_CALLED_US)
        # symmetric per-link latency/bandwidth model (virtual time)
        for p in (self.initiator, self.acceptor):
            p.link_latency_s = latency_s
            p.link_bytes_per_s = (bandwidth_bps / 8.0
                                  if bandwidth_bps else None)
        self.initiator.partner = self.acceptor
        self.acceptor.partner = self.initiator
        app_initiator.overlay_manager.add_pending_peer(self.initiator)
        app_acceptor.overlay_manager.add_pending_peer(self.acceptor)
        self.acceptor.connect_handler()
        self.initiator.connect_handler()

    def crank(self, max_rounds: int = 100) -> int:
        """Ping-pong queued bytes until quiescent."""
        total = 0
        for _ in range(max_rounds):
            n = self.initiator.deliver_all() + self.acceptor.deliver_all()
            total += n
            if n == 0:
                break
        return total
