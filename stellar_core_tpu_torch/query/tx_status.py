"""Transaction-status store fed from the deferred-completion stream.

``txstatus?hash=`` answers "what happened to my transaction" — the
single most common user query — without touching the tx-history SQL
tables on the serving path.  The store is fed on the completion worker
(LedgerManager.completion_hooks, the same deferred segment that emits
meta and tx-history), keyed by full tx hash, holding the result XDR
plus the ledger seq it applied in.  Bounded two ways, both borrowed
from ``ledger.transaction.e2e``'s pending-tracker hygiene: a hard
capacity ring (oldest ledger's entries evicted first) and a TTL prune
against ledger close time.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

__all__ = ["TxStatusStore"]


class TxStatusStore:
    """Bounded tx-hash -> (result XDR, ledger seq, close time) map."""

    def __init__(self, capacity: int = 65536, ttl_s: float = 600.0,
                 metrics=None):
        self.capacity = int(capacity)
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        # insertion-ordered: completion runs in ledger order, so the
        # front is always the oldest — capacity and TTL both pop left
        self._by_hash: "OrderedDict[bytes, Tuple[bytes, int, int]]" = \
            OrderedDict()
        self._hit_meter = self._miss_meter = None
        self._evicted_counter = None
        if metrics is not None:
            self._hit_meter = metrics.meter("query", "txstatus", "hit")
            self._miss_meter = metrics.meter("query", "txstatus", "miss")
            self._evicted_counter = metrics.counter(
                "query", "txstatus", "evicted")

    # -------------------------------------------------------------- feeding --
    def record_ledger(self, seq: int, close_time: int,
                      result_pairs) -> None:
        """Completion-side hook (LedgerManager.completion_hooks): store
        every result pair of one closed ledger.  Runs on the
        completion worker (or inline on crank when completion is not
        deferred) — never on the serving path."""
        evicted = 0
        with self._lock:
            for pair in result_pairs:
                self._by_hash[bytes(pair.transactionHash)] = (
                    pair.result.to_bytes(), seq, close_time)
            while len(self._by_hash) > self.capacity:
                self._by_hash.popitem(last=False)
                evicted += 1
            # TTL prune, oldest first (entries are in close order)
            if self.ttl_s > 0:
                horizon = close_time - self.ttl_s
                while self._by_hash:
                    _, _, ct = next(iter(self._by_hash.values()))
                    if ct >= horizon:
                        break
                    self._by_hash.popitem(last=False)
                    evicted += 1
        if evicted and self._evicted_counter is not None:
            self._evicted_counter.inc(evicted)

    # -------------------------------------------------------------- serving --
    def lookup(self, tx_hash: bytes) -> Optional[Tuple[bytes, int]]:
        """(result XDR bytes, ledger seq) or None.  Query-worker side."""
        with self._lock:
            rec = self._by_hash.get(bytes(tx_hash))
        if rec is None:
            if self._miss_meter is not None:
                self._miss_meter.mark()
            return None
        if self._hit_meter is not None:
            self._hit_meter.mark()
        return rec[0], rec[1]

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_hash)

    def clear(self) -> None:
        with self._lock:
            self._by_hash.clear()
