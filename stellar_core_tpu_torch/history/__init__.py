"""History archives + checkpoint publish (reference: src/history).

Counterpart of stellar_core_tpu/history/__init__.py; the port has the
archive layer (`archive.py`) that every close persists its local HAS
through. `HistoryManager` (`manager.py`) comes with catchup.
"""

from .archive import (CHECKPOINT_FREQUENCY, HistoryArchive,
                      HistoryArchiveState, checkpoint_containing,
                      is_checkpoint_ledger, make_tmpdir_archive)

__all__ = ["HistoryArchive", "HistoryArchiveState",
           "CHECKPOINT_FREQUENCY", "checkpoint_containing",
           "is_checkpoint_ledger", "make_tmpdir_archive"]
