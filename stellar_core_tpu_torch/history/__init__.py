"""History archives + checkpoint publish (reference: src/history)."""

from .archive import (CHECKPOINT_FREQUENCY, HistoryArchive,
                      HistoryArchiveState, checkpoint_containing,
                      is_checkpoint_ledger, make_tmpdir_archive)
from .manager import HistoryManager

__all__ = ["HistoryManager", "HistoryArchive", "HistoryArchiveState",
           "CHECKPOINT_FREQUENCY", "checkpoint_containing",
           "is_checkpoint_ledger", "make_tmpdir_archive"]
