"""Pull-mode transaction flooding.

Reference: src/overlay/TxAdvertQueue.{h,cpp} + TxDemandsManager —
instead of pushing full transactions, peers advertise tx hashes
(FLOOD_ADVERT); the receiver queues unknown hashes and demands bodies
(FLOOD_DEMAND); the advertiser answers with TRANSACTION messages.
`TxDemandsManager` is the manager-level single-flight table: each
hash is demanded from exactly ONE peer at a time, however many peers
advertise it.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Set

from ..util.logging import get_logger
from ..xdr.overlay import (FloodAdvert, FloodDemand, MessageType,
                           StellarMessage, MAX_TX_ADVERT_VECTOR,
                           MAX_TX_DEMAND_VECTOR)

log = get_logger("Overlay")


class TxAdvertQueue:
    """Per-peer outgoing advert batching + incoming advert tracking."""

    def __init__(self, config):
        self._outgoing: List[bytes] = []
        self._incoming: Deque[bytes] = deque()
        self._seen_adverts: OrderedDict = OrderedDict()
        self._max_cache = config.MAX_ADVERT_CACHE_SIZE

    # ------------------------------------------------------------- outgoing --
    def queue_advert(self, tx_hash: bytes) -> StellarMessage | None:
        """Queue a hash for advertising; returns a FLOOD_ADVERT message
        to send now only when the batch is full. The flush cadence
        (cooldown-gated immediate send vs timer) is the manager's call —
        it owns the clock."""
        self._outgoing.append(tx_hash)
        if len(self._outgoing) >= MAX_TX_ADVERT_VECTOR:
            return self.flush_advert()
        return None

    def pending(self) -> bool:
        return bool(self._outgoing)

    def flush_advert(self) -> StellarMessage | None:
        if not self._outgoing:
            return None
        batch, self._outgoing = self._outgoing, []
        return StellarMessage(MessageType.FLOOD_ADVERT,
                              FloodAdvert(txHashes=batch))

    # ------------------------------------------------------------- incoming --
    def recv_advert(self, tx_hashes, known_fn) -> List[bytes]:
        """Track advertised hashes; returns those we should demand."""
        demand = []
        for h in tx_hashes:
            h = bytes(h)
            if h in self._seen_adverts:
                continue
            self._seen_adverts[h] = True
            while len(self._seen_adverts) > self._max_cache:
                self._seen_adverts.popitem(last=False)
            if not known_fn(h):
                demand.append(h)
        return demand

    @staticmethod
    def make_demand(tx_hashes: List[bytes]) -> StellarMessage:
        return StellarMessage(
            MessageType.FLOOD_DEMAND,
            FloodDemand(txHashes=tx_hashes[:MAX_TX_DEMAND_VECTOR]))


class _Demand:
    """One outstanding single-flight demand: who currently owes us the
    body, when we asked, how many attempts so far, and which OTHER
    peers advertised the hash (the retry rotation order)."""

    __slots__ = ("peer_key", "t", "attempts", "backups")

    def __init__(self, peer_key: int, now: float):
        self.peer_key = peer_key
        self.t = now
        self.attempts = 1
        self.backups: List[int] = []


class TxDemandsManager:
    """Single-flight outstanding-demand table (reference:
    TxDemandsManager).

    The per-peer `TxAdvertQueue` dedups adverts per LINK; this table
    dedups demands per NODE: when two peers advertise the same hash
    before the body arrives, the second (and every later) advertiser
    is recorded as a backup instead of being demanded too — each hash
    is in flight from exactly one peer at a time, which is the lever
    that pushes real-socket duplicate_ratio below 1.0 (every extra
    concurrent demand used to buy a guaranteed duplicate body).
    A peer that lets a demand time out is rotated out: the retry goes
    to the next backup advertiser (falling back to any other live
    peer when no advertiser remains), with per-peer
    `demand.{sent,fulfilled,timeout,retry}` accounting kept by the
    OverlayManager that drives this table."""

    def __init__(self, max_attempts: int = 3):
        self.max_attempts = max_attempts
        self._outstanding: Dict[bytes, _Demand] = {}

    def __len__(self) -> int:
        return len(self._outstanding)

    def outstanding_from(self, h: bytes) -> Optional[int]:
        d = self._outstanding.get(h)
        return d.peer_key if d is not None else None

    def note_advert(self, h: bytes, peer_key: int, now: float) -> bool:
        """Register an advert for `h` from `peer_key`. True = demand
        it from this peer now (first flight); False = a demand is
        already in flight, the peer was recorded as a backup."""
        d = self._outstanding.get(h)
        if d is None:
            self._outstanding[h] = _Demand(peer_key, now)
            return True
        if peer_key != d.peer_key and peer_key not in d.backups:
            d.backups.append(peer_key)
        return False

    def fulfilled(self, h: bytes) -> Optional[_Demand]:
        """A body for `h` arrived: retire the record (returns it for
        accounting, None when the body was never demanded)."""
        return self._outstanding.pop(h, None)

    def forget(self, h: bytes) -> None:
        self._outstanding.pop(h, None)

    def sweep(self, now: float, period_s: float, backoff_s: float,
              peers_by_key: Dict[int, object], any_peers: List,
              is_known=None):
        """One retry pass: returns `(retries, timeouts)` where
        `retries` maps target peer -> [hashes] to re-demand (records
        already rotated onto the target) and `timeouts` lists the
        peer_keys that let a demand expire (one entry per hash).
        Each attempt waits an extra `backoff_s` step before the next
        (reference: FLOOD_DEMAND_BACKOFF_DELAY_MS)."""
        retries: Dict[int, tuple] = {}
        timeouts: List[int] = []
        for h, d in list(self._outstanding.items()):
            if is_known is not None and is_known(h):
                del self._outstanding[h]
                continue
            if now - d.t < period_s + backoff_s * (d.attempts - 1):
                continue
            timeouts.append(d.peer_key)
            if d.attempts >= self.max_attempts:
                del self._outstanding[h]
                continue
            # rotation: the next LIVE backup advertiser wins; with no
            # advertiser left, any other live peer (round-robin by
            # attempt) keeps the fetch moving
            target = None
            while d.backups:
                cand = d.backups.pop(0)
                if cand in peers_by_key and cand != d.peer_key:
                    target = peers_by_key[cand]
                    break
            if target is None:
                others = [p for p in any_peers
                          if id(p) != d.peer_key]
                if not others:
                    del self._outstanding[h]
                    continue
                target = others[d.attempts % len(others)]
            d.peer_key = id(target)
            d.t = now
            d.attempts += 1
            retries.setdefault(id(target), (target, []))[1].append(h)
        return retries, timeouts
