"""Ledger state machine (reference: src/ledger/).

- ledger_txn: nested in-memory ledger transactions (LedgerTxn.h:20-120)
  with dict-backed and SQL-backed roots
- ledger_manager: closeLedger orchestration (LedgerManagerImpl.cpp:707)
"""

from .ledger_txn import (LedgerTxn, InMemoryLedgerTxnRoot, LedgerTxnRoot,
                         LedgerDelta)

__all__ = ["LedgerTxn", "InMemoryLedgerTxnRoot", "LedgerTxnRoot",
           "LedgerDelta"]
