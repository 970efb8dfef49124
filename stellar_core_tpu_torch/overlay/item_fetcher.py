"""Anycast fetch of tx sets / quorum sets from peers.

Reference: src/overlay/ItemFetcher.{h,cpp} + Tracker — for each wanted
hash, ask one authenticated peer at a time; on DONT_HAVE or timeout move
to the next; stop when the item arrives (PendingEnvelopes is told by the
overlay manager, which then recycles ready envelopes into the herder).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..util.logging import get_logger
from ..util.timer import VirtualTimer
from ..xdr.overlay import MessageType, StellarMessage

log = get_logger("Overlay")

# reference: MS_TO_WAIT_FOR_FETCH_REPLY
FETCH_REPLY_TIMEOUT = 1.5


class _Tracker:
    def __init__(self, item_hash: bytes, msg_type: MessageType):
        self.item_hash = item_hash
        self.msg_type = msg_type
        self.asked: List[int] = []         # id(peer) already tried
        self.current_peer = None
        self.timer: Optional[VirtualTimer] = None
        self.tries = 0


class ItemFetcher:
    """One instance per item kind (GET_TX_SET / GET_SCP_QUORUMSET)."""

    def __init__(self, overlay, msg_type: MessageType):
        self.overlay = overlay
        self.msg_type = msg_type
        self._trackers: Dict[bytes, _Tracker] = {}

    def fetch(self, item_hash: bytes) -> None:
        if item_hash in self._trackers:
            return
        tracker = _Tracker(item_hash, self.msg_type)
        self._trackers[item_hash] = tracker
        self._try_next_peer(tracker)

    def stop_fetch(self, item_hash: bytes) -> None:
        tracker = self._trackers.pop(item_hash, None)
        if tracker is not None and tracker.timer is not None:
            tracker.timer.cancel()

    def recv(self, item_hash: bytes) -> None:
        """Item arrived (from any peer)."""
        self.stop_fetch(item_hash)

    def dont_have(self, item_hash: bytes, peer) -> None:
        tracker = self._trackers.get(item_hash)
        if tracker is not None and tracker.current_peer is peer:
            self._try_next_peer(tracker)

    def peer_dropped(self, peer) -> None:
        for tracker in list(self._trackers.values()):
            if tracker.current_peer is peer:
                self._try_next_peer(tracker)

    def fetching_count(self) -> int:
        return len(self._trackers)

    def _try_next_peer(self, tracker: _Tracker) -> None:
        if tracker.timer is not None:
            tracker.timer.cancel()
            tracker.timer = None
        peers = [p for p in self.overlay.get_authenticated_peers()
                 if id(p) not in tracker.asked]
        if not peers:
            # everyone asked: start over (reference: tryNextPeer wraps
            # around, envelopes referencing the item may still arrive)
            tracker.asked.clear()
            peers = self.overlay.get_authenticated_peers()
            if not peers:
                # no peers at all: retry when one connects
                tracker.current_peer = None
                return
        peer = peers[0]
        tracker.current_peer = peer
        tracker.asked.append(id(peer))
        tracker.tries += 1
        peer.send_message(StellarMessage(self.msg_type,
                                         tracker.item_hash))
        timer = VirtualTimer(self.overlay.app.clock)
        timer.expires_from_now(FETCH_REPLY_TIMEOUT)
        timer.async_wait(lambda: self._timeout(tracker))
        tracker.timer = timer

    def _timeout(self, tracker: _Tracker) -> None:
        tracker.timer = None
        if tracker.item_hash in self._trackers:
            self._try_next_peer(tracker)

    def peer_connected(self) -> None:
        """A peer authenticated: kick any stalled trackers."""
        for tracker in self._trackers.values():
            if tracker.current_peer is None:
                self._try_next_peer(tracker)
