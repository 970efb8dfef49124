"""Maintainer + ExternalQueue: SQL history GC with consumer cursors.

Reference: src/main/Maintainer.{h,cpp} (cron-like deletion of old
txhistory/scphistory rows) and src/main/ExternalQueue.{h,cpp} (Horizon
et al. register cursors through `setcursor`; maintenance never deletes
past the lowest cursor).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..util.logging import get_logger
from ..util.timer import VirtualTimer

log = get_logger("History")


class ExternalQueue:
    """reference: ExternalQueue.h:14-37 — pubsub table of resource ids
    → last-read ledger."""

    def __init__(self, app):
        self.app = app

    def set_cursor_for_resource(self, resid: str, cursor: int) -> None:
        self.app.database.execute(
            "INSERT OR REPLACE INTO pubsub (resid, lastread) VALUES (?,?)",
            (resid, cursor))

    def get_cursor(self, resid: Optional[str] = None) -> Dict[str, int]:
        if resid is not None:
            row = self.app.database.query_one(
                "SELECT lastread FROM pubsub WHERE resid=?", (resid,))
            return {resid: row[0]} if row else {}
        return {r: c for r, c in self.app.database.query_all(
            "SELECT resid, lastread FROM pubsub")}

    def delete_cursor(self, resid: str) -> None:
        self.app.database.execute(
            "DELETE FROM pubsub WHERE resid=?", (resid,))

    def min_cursor(self) -> Optional[int]:
        row = self.app.database.query_one(
            "SELECT MIN(lastread) FROM pubsub")
        return row[0] if row and row[0] is not None else None


class Maintainer:
    """reference: Maintainer.h:16-25 — periodic `performMaintenance`
    deleting history rows older than what every consumer has read."""

    def __init__(self, app):
        self.app = app
        self.external_queue = ExternalQueue(app)
        self._timer: Optional[VirtualTimer] = None

    def start(self, period_seconds: float = 3600.0,
              count: int = 50000) -> None:
        self._timer = VirtualTimer(self.app.clock)
        self._timer.expires_from_now(period_seconds)

        def tick():
            self.perform_maintenance(count)
            self.start(period_seconds, count)

        self._timer.async_wait(tick)

    def stop(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def perform_maintenance(self, count: int) -> int:
        """Delete up to `count` ledgers' history below the safe floor:
        min(consumer cursors, last checkpointed ledger). Also the one
        sanctioned full-heap GC pass (util/gcpolicy.py): reference
        cycles from long runs are reclaimed here, at history-GC
        cadence, never inside a ledger close."""
        from ..util import gcpolicy
        gcpolicy.maintenance_collect()
        lcl = self.app.ledger_manager.get_last_closed_ledger_num()
        from ..history.archive import CHECKPOINT_FREQUENCY
        floor = max(1, lcl - 2 * CHECKPOINT_FREQUENCY)
        min_cursor = self.external_queue.min_cursor()
        if min_cursor is not None:
            floor = min(floor, min_cursor)
        low = max(1, floor - count)
        db = self.app.database
        deleted = 0
        for table in ("txhistory", "txfeehistory", "txsethistory",
                      "scphistory"):
            cur = db.execute(
                f"DELETE FROM {table} WHERE ledgerseq >= ? AND "
                f"ledgerseq < ?", (low, floor))
            deleted += cur.rowcount
        log.debug("maintenance deleted %d rows below ledger %d",
                  deleted, floor)
        return deleted
