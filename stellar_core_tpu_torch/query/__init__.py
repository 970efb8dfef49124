"""Snapshot-consistent read-serving tier.

The write path (herder -> ledger close -> bucket list) serves
consensus; this package serves *users*: account lookups and
transaction-status queries answered against immutable, refcounted
bucket-list snapshots captured at each ledger close, behind a bounded
worker pool with per-request deadlines and hedged tail reads.

- :mod:`snapshot` — refcounted bucket-list snapshots + GC pinning
- :mod:`tx_status` — bounded tx-hash -> result store fed from the
  deferred-completion stream
- :mod:`service` — the query-worker pool (deadlines, hedging,
  controller-visible shedding)
"""

from .snapshot import LedgerSnapshot, SnapshotManager
from .tx_status import TxStatusStore
from .service import QueryService

__all__ = ["LedgerSnapshot", "SnapshotManager", "TxStatusStore",
           "QueryService"]
