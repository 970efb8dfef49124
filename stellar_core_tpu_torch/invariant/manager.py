"""Invariant framework.

Reference: src/invariant/InvariantManager.h:39-43 and Invariant.h — pluggable
post-apply checkers. `check_on_operation_apply` runs after every operation
(called from TransactionFrame apply, reference TransactionFrame.cpp:1557);
`check_on_bucket_apply` runs after a bucket is replayed into the DB during
catchup (reference catchup/ApplyBucketsWork.cpp:248,263). A failing invariant
raises InvariantDoesNotHold, which is deliberately NOT caught by the apply
path — corruption crashes the node (reference InvariantDoesNotHold semantics).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from ..util.logging import get_logger
from ..xdr.ledger_entries import LedgerEntry
from ..xdr.ledger import LedgerHeader

log = get_logger("Invariant")


class InvariantDoesNotHold(Exception):
    """Raised when ledger state violates an enabled invariant; crash-the-
    node semantics (reference: invariant/InvariantDoesNotHold.h)."""


class OperationDelta:
    """The (previous, current) entry pairs one operation (or one ledger
    close) produced, plus the header transition — what every invariant
    inspects (reference: the LedgerTxnDelta passed at
    TransactionFrame.cpp:1557)."""

    def __init__(self,
                 entries: Dict[bytes, Tuple[Optional[LedgerEntry],
                                            Optional[LedgerEntry]]],
                 header_prev: LedgerHeader, header_curr: LedgerHeader):
        self.entries = entries
        self.header_prev = header_prev
        self.header_curr = header_curr

    @classmethod
    def from_ledger_txn(cls, ltx) -> "OperationDelta":
        entries = {}
        for kb, curr in ltx._delta.items():
            # first-touch snapshot captured by the LedgerTxn — shared,
            # read-only (no chain re-walk)
            entries[kb] = (ltx._prev.get(kb), curr)
        return cls(entries, ltx._parent.get_header(), ltx.get_header())


class Invariant:
    """Base checker. `strict` invariants also run on bucket apply."""

    name: str = "Invariant"

    def check_on_operation_apply(self, operation, result,
                                 delta: OperationDelta) -> Optional[str]:
        """Return an error string if violated, else None."""
        return None

    def check_on_bucket_apply(self, bucket_entries, ledger_seq: int,
                              level: int, is_curr: bool) -> Optional[str]:
        return None


class InvariantManager:
    """Registry + dispatch (reference: InvariantManagerImpl)."""

    def __init__(self, metrics=None):
        self._registered: Dict[str, Invariant] = {}
        self._enabled: List[Invariant] = []
        self._failures = metrics and metrics.counter(
            "invariant", "checks", "failed")

    def register(self, inv: Invariant) -> None:
        if inv.name in self._registered:
            raise ValueError(f"duplicate invariant {inv.name}")
        self._registered[inv.name] = inv

    def enable(self, patterns: List[str]) -> None:
        """Enable registered invariants whose names match any regex in
        `patterns` (reference: Config INVARIANT_CHECKS regex list)."""
        for inv in self._registered.values():
            if any(re.fullmatch(p, inv.name) for p in patterns):
                if inv not in self._enabled:
                    self._enabled.append(inv)

    def enabled_invariants(self) -> List[str]:
        return [i.name for i in self._enabled]

    def check_on_operation_apply(self, operation, result,
                                 delta: OperationDelta) -> None:
        for inv in self._enabled:
            err = inv.check_on_operation_apply(operation, result, delta)
            if err is not None:
                self._on_failure(inv, err)

    def check_on_bucket_apply(self, bucket_entries, ledger_seq: int,
                              level: int, is_curr: bool) -> None:
        for inv in self._enabled:
            err = inv.check_on_bucket_apply(bucket_entries, ledger_seq,
                                            level, is_curr)
            if err is not None:
                self._on_failure(inv, err)

    def _on_failure(self, inv: Invariant, err: str) -> None:
        if self._failures is not None:
            self._failures.inc()
        msg = f"invariant {inv.name} does not hold: {err}"
        log.error(msg)
        raise InvariantDoesNotHold(msg)
