"""Credit-based flow control for flooded messages.

Reference: src/overlay/FlowControl.{h,cpp} + FlowControlCapacity — each
side grants its peer an initial reading capacity (messages and bytes);
flooded messages (TRANSACTION, SCP_MESSAGE, FLOOD_ADVERT, FLOOD_DEMAND)
consume capacity at the sender and queue when exhausted; the receiver
returns capacity in SEND_MORE_EXTENDED batches after processing.
Non-flood traffic is never throttled.

Outbound queueing is priority-aware and byte-budgeted: the
per-peer queue is three drop-priority classes — SCP envelopes (highest:
consensus halts without them), demanded transaction bodies (the peer
explicitly asked), advert/demand gossip (lowest: re-announcable) —
drained strictly in that order, FIFO within a class. Past the total
byte budget (OUTBOUND_QUEUE_BYTE_LIMIT) the enqueue sheds from the
lowest-priority non-empty class first; an SCP envelope is only ever
shed to make room for another SCP envelope, never for tx or gossip.
Shed counts are kept per class for the `peers` route and the
`overlay.flow.drop.*` counters, so a slow or partitioned link is
visible — and bounded — instead of ballooning a healthy node's memory.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Optional, Tuple

from ..util.logging import get_logger
from ..xdr.overlay import (MessageType, SendMoreExtended, StellarMessage)
from . import wire

log = get_logger("Overlay")

FLOW_CONTROLLED_TYPES = (MessageType.TRANSACTION, MessageType.SCP_MESSAGE,
                         MessageType.FLOOD_ADVERT, MessageType.FLOOD_DEMAND)

# drop-priority classes, highest priority first (lowest index sheds
# LAST). The names are the `overlay.flow.drop.<class>` suffixes and the
# `peers` route's drops keys.
CLASS_SCP = 0
CLASS_TX = 1
CLASS_GOSSIP = 2
CLASS_NAMES = ("scp", "tx", "gossip")


def msg_class(msg: StellarMessage) -> int:
    if msg.disc == MessageType.SCP_MESSAGE:
        return CLASS_SCP
    if msg.disc == MessageType.TRANSACTION:
        return CLASS_TX
    return CLASS_GOSSIP        # FLOOD_ADVERT / FLOOD_DEMAND


def is_flow_controlled(msg: StellarMessage) -> bool:
    return msg.disc in FLOW_CONTROLLED_TYPES


def msg_body_size(msg: StellarMessage, counters=None) -> int:
    # serialize-once: byte-level flow accounting sizes each
    # flooded message up to four times on its way through a peer
    # (try_send, queue caps, recv accounting, SEND_MORE bookkeeping) —
    # all hits on the message's cached canonical bytes now
    return len(wire.body_bytes(msg, counters))


class FlowControl:
    """One instance per peer connection, tracking both directions."""

    def __init__(self, config, encode_counters=None, drop_counters=None):
        # the overlay's (hit, miss) encode-cache counter pair: flow
        # control is often the FIRST consumer to serialize an outbound
        # flooded message, so the miss must be charged here for the
        # cache evidence to add up
        self._enc = encode_counters
        # aggregate overlay.flow.drop.<class> counters (one triple
        # shared by every peer; per-peer tallies live in `dropped`)
        self._drop_counters = drop_counters
        # what the remote may still send us before we SEND_MORE
        self.local_capacity_msgs = config.PEER_FLOOD_READING_CAPACITY
        self.local_capacity_bytes = config.PEER_FLOOD_READING_CAPACITY_BYTES
        # what we may still send the remote
        self.remote_capacity_msgs = 0
        self.remote_capacity_bytes = 0
        self.batch_msgs = config.FLOW_CONTROL_SEND_MORE_BATCH_SIZE
        self.batch_bytes = config.FLOW_CONTROL_SEND_MORE_BATCH_SIZE_BYTES
        self._processed_msgs = 0
        self._processed_bytes = 0
        # one FIFO per drop-priority class, drained SCP→tx→gossip
        self._queues: Tuple[Deque[StellarMessage], ...] = (
            deque(), deque(), deque())
        self._queued_bytes = [0, 0, 0]
        # cap on queued TRANSACTION bytes; oldest dropped first
        # (reference: OUTBOUND_TX_QUEUE_BYTE_LIMIT)
        self.tx_queue_byte_limit = config.OUTBOUND_TX_QUEUE_BYTE_LIMIT
        self.dropped_tx_msgs = 0
        # total outbound byte budget across all classes; 0 = unbounded
        self.queue_byte_limit = getattr(
            config, "OUTBOUND_QUEUE_BYTE_LIMIT", 0)
        self.queue_high_water = 0      # max total queued bytes observed
        self.dropped = [0, 0, 0]       # per-class shed counts
        # byte-level accounting off = message counts only (reference:
        # ENABLE_FLOW_CONTROL_BYTES)
        self.bytes_enabled = config.ENABLE_FLOW_CONTROL_BYTES

    # ----------------------------------------------------------- queueing --
    def _drop_oldest(self, cls: int) -> None:
        q = self._queues[cls]
        victim = q.popleft()
        self._queued_bytes[cls] -= msg_body_size(victim, self._enc)
        self.dropped[cls] += 1
        if cls == CLASS_TX:
            self.dropped_tx_msgs += 1
        if self._drop_counters is not None:
            self._drop_counters[cls].inc()

    def _enqueue(self, msg: StellarMessage) -> None:
        cls = msg_class(msg)
        size = msg_body_size(msg, self._enc)
        self._queues[cls].append(msg)
        self._queued_bytes[cls] += size
        # legacy per-class tx cap (reference semantics): oldest tx out
        if cls == CLASS_TX and self.tx_queue_byte_limit > 0:
            while self._queued_bytes[CLASS_TX] > self.tx_queue_byte_limit:
                self._drop_oldest(CLASS_TX)
        # total byte budget: shed from the lowest-priority non-empty
        # class. Never shed a class higher-priority than the incoming
        # message's own — an SCP enqueue may shed old SCP (the budget
        # is then all consensus traffic), but tx/gossip never evict SCP
        if self.queue_byte_limit > 0:
            while sum(self._queued_bytes) > self.queue_byte_limit:
                for shed_cls in (CLASS_GOSSIP, CLASS_TX, CLASS_SCP):
                    if shed_cls >= cls and self._queues[shed_cls]:
                        self._drop_oldest(shed_cls)
                        break
                else:
                    break    # only higher-priority bytes remain
        total = sum(self._queued_bytes)
        if total > self.queue_high_water:
            self.queue_high_water = total

    def _note_dequeued(self, cls: int, msg: StellarMessage) -> None:
        self._queued_bytes[cls] -= msg_body_size(msg, self._enc)

    # ------------------------------------------------------------ sending --
    def initial_send_more(self, config) -> StellarMessage:
        """The capacity grant sent right after AUTH (reference:
        sendSendMore at handshake completion)."""
        return StellarMessage(
            MessageType.SEND_MORE_EXTENDED,
            SendMoreExtended(
                numMessages=config.PEER_FLOOD_READING_CAPACITY,
                numBytes=config.PEER_FLOOD_READING_CAPACITY_BYTES))

    def try_send(self, msg: StellarMessage) -> Optional[StellarMessage]:
        """Returns the message if capacity allows sending now, else
        queues it (priority class, FIFO within) and returns None."""
        if not is_flow_controlled(msg):
            return msg
        if self._queues[msg_class(msg)]:
            # FIFO within a class: never overtake an earlier message of
            # the same priority (slow-link ordering, MAC seq safety)
            self._enqueue(msg)
            return None
        return self._consume_or_queue(msg)

    def _consume_or_queue(self, msg: StellarMessage
                          ) -> Optional[StellarMessage]:
        size = msg_body_size(msg, self._enc)
        if self.remote_capacity_msgs >= 1 and \
                (not self.bytes_enabled or
                 self.remote_capacity_bytes >= size):
            self.remote_capacity_msgs -= 1
            self.remote_capacity_bytes -= size
            return msg
        self._enqueue(msg)
        return None

    def on_send_more(self, num_messages: int, num_bytes: int) -> list:
        """Peer granted capacity; returns queued messages now sendable,
        highest priority class first, FIFO within a class. A class head
        too big for the byte grant blocks only its own class — lower
        classes may still fit (it keeps first claim on the next grant)."""
        self.remote_capacity_msgs += num_messages
        self.remote_capacity_bytes += num_bytes
        out = []
        for cls in (CLASS_SCP, CLASS_TX, CLASS_GOSSIP):
            q = self._queues[cls]
            while q:
                msg = q[0]
                size = msg_body_size(msg, self._enc)
                if self.remote_capacity_msgs >= 1 and \
                        (not self.bytes_enabled or
                         self.remote_capacity_bytes >= size):
                    self.remote_capacity_msgs -= 1
                    self.remote_capacity_bytes -= size
                    sent = q.popleft()
                    self._note_dequeued(cls, sent)
                    out.append(sent)
                else:
                    break
        return out

    # ---------------------------------------------------------- receiving --
    def on_message_received(self, msg: StellarMessage) -> bool:
        """Account an inbound flooded message against the capacity we
        granted; False = peer overflowed its allowance (protocol
        violation, reference: throwIfOutOfSyncRecv)."""
        if not is_flow_controlled(msg):
            return True
        size = msg_body_size(msg, self._enc)
        if self.local_capacity_msgs < 1 or \
                (self.bytes_enabled and self.local_capacity_bytes < size):
            return False
        self.local_capacity_msgs -= 1
        self.local_capacity_bytes -= size
        return True

    def maybe_send_more(self, msg: StellarMessage
                        ) -> Optional[StellarMessage]:
        """After processing an inbound flooded message, possibly return a
        SEND_MORE_EXTENDED replenishing the peer's budget."""
        if not is_flow_controlled(msg):
            return None
        self._processed_msgs += 1
        self._processed_bytes += msg_body_size(msg, self._enc)
        if self._processed_msgs >= self.batch_msgs or \
                self._processed_bytes >= self.batch_bytes:
            n, b = self._processed_msgs, self._processed_bytes
            self._processed_msgs = 0
            self._processed_bytes = 0
            self.local_capacity_msgs += n
            self.local_capacity_bytes += b
            return StellarMessage(
                MessageType.SEND_MORE_EXTENDED,
                SendMoreExtended(numMessages=n, numBytes=b))
        return None

    def outbound_queue_len(self) -> int:
        return sum(len(q) for q in self._queues)

    def queued_bytes(self) -> int:
        return sum(self._queued_bytes)

    def flow_stats(self) -> dict:
        """The `peers` route's per-link backpressure row: live queue
        depth, the budget, the high-water mark against it, and what was
        shed per drop-priority class."""
        return {
            "queued_msgs": self.outbound_queue_len(),
            "queued_bytes": self.queued_bytes(),
            "queue_budget": self.queue_byte_limit,
            "queue_high_water": self.queue_high_water,
            "drops": {CLASS_NAMES[c]: self.dropped[c]
                      for c in (CLASS_SCP, CLASS_TX, CLASS_GOSSIP)},
        }
