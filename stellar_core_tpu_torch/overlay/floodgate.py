"""Flood dedup + rebroadcast bookkeeping.

Reference: src/overlay/Floodgate.{h,cpp} — records which peers already
saw each flooded message (keyed by message hash) so broadcast skips
them; records are GC'd by ledger seq.
"""

from __future__ import annotations

from typing import Dict, Set

from ..util.logging import get_logger
from ..xdr.overlay import StellarMessage
from . import wire

log = get_logger("Overlay")


class _FloodRecord:
    __slots__ = ("ledger_seq", "peers_told")

    def __init__(self, ledger_seq: int):
        self.ledger_seq = ledger_seq
        self.peers_told: Set[int] = set()   # id(peer)


def message_hash(msg: StellarMessage) -> bytes:
    """Flood key: sha256 over the message's canonical bytes —
    serialize-once: both the body encoding and the hash are
    cached on the message object, so hashing a message that is about
    to be broadcast (or was just received, cache seeded from the wire
    slice) costs nothing beyond the first call."""
    return wire.flood_hash(msg)


class Floodgate:
    def __init__(self):
        self._records: Dict[bytes, _FloodRecord] = {}
        # id(peer) -> hashes whose records name it in peers_told: the
        # disconnect path walks only what the peer actually saw,
        # O(records-told), instead of scanning every live record —
        # O(records × churn) measured in the cluster harness's churn
        # legs
        self._peer_index: Dict[int, Set[bytes]] = {}

    def _tell(self, rec: _FloodRecord, h: bytes, peer) -> None:
        rec.peers_told.add(id(peer))
        self._peer_index.setdefault(id(peer), set()).add(h)

    def add_record(self, msg: StellarMessage, from_peer,
                   ledger_seq: int, msg_hash: bytes = None) -> bool:
        """Returns True if the message is new (should be processed +
        forwarded). `msg_hash` lets a caller that already hashed the
        message (propagation tracking) skip the re-hash."""
        h = msg_hash if msg_hash is not None else message_hash(msg)
        rec = self._records.get(h)
        if rec is None:
            rec = self._records[h] = _FloodRecord(ledger_seq)
        new = not rec.peers_told
        if from_peer is not None:
            self._tell(rec, h, from_peer)
            new = len(rec.peers_told) == 1
        return new

    def note_told(self, msg_hash: bytes, peer, ledger_seq: int) -> None:
        """Record that `peer` already holds the message with this flood
        hash WITHOUT sending anything — the per-link SCP digest gate.
        Used when an envelope reaches a peer outside the
        flood path (a GET_SCP_STATE catchup response): a later
        broadcast of the same envelope must not re-push it down that
        link, which is exactly the push-gossip duplicate the
        dups/envelope floor is made of."""
        rec = self._records.get(msg_hash)
        if rec is None:
            rec = self._records[msg_hash] = _FloodRecord(ledger_seq)
        self._tell(rec, msg_hash, peer)

    def broadcast(self, msg: StellarMessage, peers, ledger_seq: int,
                  msg_hash: bytes = None) -> int:
        """Send to every authenticated peer that hasn't seen it."""
        h = msg_hash if msg_hash is not None else message_hash(msg)
        rec = self._records.get(h)
        if rec is None:
            rec = self._records[h] = _FloodRecord(ledger_seq)
        sent = 0
        for peer in peers:
            if not peer.is_authenticated():
                continue
            if id(peer) in rec.peers_told:
                continue
            self._tell(rec, h, peer)
            peer.send_message(msg)
            sent += 1
        return sent

    def clear_below(self, ledger_seq: int) -> None:
        for h in [h for h, r in self._records.items()
                  if r.ledger_seq + 10 < ledger_seq]:
            rec = self._records.pop(h)
            # keep the per-peer index in lockstep: a long-lived peer's
            # index set must not accumulate hashes of GC'd records
            for pid in rec.peers_told:
                told = self._peer_index.get(pid)
                if told is not None:
                    told.discard(h)

    def forget_peer(self, peer) -> None:
        told = self._peer_index.pop(id(peer), None)
        if not told:
            return
        for h in told:
            rec = self._records.get(h)
            if rec is not None:
                rec.peers_told.discard(id(peer))
