"""Refcounted bucket-list snapshots — the read tier's consistency unit.

Every read answered by the query tier is answered against exactly one
closed ledger: at each ledger close the crank thread captures the
bucket list's per-level ``(curr, snap)`` bucket references plus the
closed header into an immutable :class:`LedgerSnapshot`.  Buckets are
immutable once built, so a snapshot is just a tuple of references — no
copying — and stays byte-stable no matter how many ledgers close after
it (the BucketListDB snapshot idiom, bucket/readme.md:86-105).

Pinning: a bucket that only a live snapshot still references must
survive bucket GC until the last reader drops the snapshot.  The
manager exposes :meth:`pinned_bucket_hashes` and the application
registers it on ``BucketManager.gc_ref_providers`` beside the
publish-queue/catchup hot pins.
"""

from __future__ import annotations

import threading
from typing import Optional, Set

from ..xdr.ledger import BucketEntryType

__all__ = ["LedgerSnapshot", "SnapshotManager"]


class LedgerSnapshot:
    """Immutable view of the bucket list at one closed ledger.

    Reference-counted by the owning :class:`SnapshotManager`; readers
    must :meth:`SnapshotManager.release` what they acquired.  All
    fields are set once at capture and never mutated afterwards, so
    reads need no lock.
    """

    __slots__ = ("ledger_seq", "header", "lcl_hash", "levels", "refs")

    def __init__(self, header, lcl_hash: bytes, levels):
        self.ledger_seq = header.ledgerSeq
        self.header = header
        self.lcl_hash = bytes(lcl_hash)
        # ((curr, snap), ...) newest level first — captured WITHOUT
        # resolving pending merges: until a merge commits, the merge
        # inputs (level i's curr + level i-1's snap) still hold every
        # entry the merged bucket will, so the newest-first walk is
        # complete and, critically, side-effect free on the live list
        self.levels = tuple(levels)
        # guarded by the owning manager's lock
        self.refs = 0

    def read_entry(self, key):
        """Point lookup newest-first across the captured levels.

        Returns the live LedgerEntry, or None when unknown or the
        newest record is a DEADENTRY (known erased)."""
        for curr, snap in self.levels:
            for b in (curr, snap):
                if b.is_empty():
                    # most levels of a young list are empty — skip the
                    # bloom probes entirely (read-path hot loop)
                    continue
                be = b.get(key)
                if be is not None:
                    if be.disc == BucketEntryType.DEADENTRY:
                        return None
                    return be.value
        return None

    def bucket_hashes(self) -> Set[bytes]:
        """Hashes of every non-empty bucket this snapshot references."""
        out = set()
        for curr, snap in self.levels:
            for b in (curr, snap):
                if not b.is_empty():
                    out.add(b.hash)
        return out

    def buckets(self):
        """The distinct non-empty Bucket objects (index-stat drains)."""
        seen = set()
        for curr, snap in self.levels:
            for b in (curr, snap):
                if not b.is_empty() and id(b) not in seen:
                    seen.add(id(b))
                    yield b


class SnapshotManager:
    """Captures a snapshot per ledger close and hands refcounted
    handles to readers.

    The manager itself holds one reference on the newest snapshot (so
    `acquire` always has something to return); capturing seq N+1 drops
    that self-reference on N — N then lives exactly as long as its
    last outside reader."""

    def __init__(self, bucket_list, metrics=None):
        self._bucket_list = bucket_list
        self._lock = threading.Lock()
        self._current: Optional[LedgerSnapshot] = None
        # every snapshot any reader still holds (including current)
        self._open: Set[LedgerSnapshot] = set()
        self._captured_meter = None
        self._open_gauge = None
        self._pinned_gauge = None
        if metrics is not None:
            self._captured_meter = metrics.meter(
                "query", "snapshot", "captured")
            # counter-as-gauge (the breaker-state idiom)
            self._open_gauge = metrics.counter(
                "query", "snapshot", "open")
            self._pinned_gauge = metrics.counter(
                "query", "snapshot", "pinned-buckets")

    # ------------------------------------------------------------- capture --
    def on_ledger_closed(self, header, lcl_hash: bytes) -> None:
        """Crank-side close hook (LedgerManager.closed_hooks): capture
        the just-committed ledger.  Runs after the seal committed, so
        the captured buckets are exactly the state the header's
        bucketListHash names."""
        levels = [(lvl.curr, lvl.snap) for lvl in self._bucket_list.levels]
        snap = LedgerSnapshot(header, lcl_hash, levels)
        with self._lock:
            prev = self._current
            snap.refs += 1                      # the manager's own ref
            self._open.add(snap)
            self._current = snap
            if prev is not None:
                self._release_locked(prev)
            if self._captured_meter is not None:
                self._captured_meter.mark()
            self._refresh_gauges_locked()

    # ------------------------------------------------------------- readers --
    def acquire(self) -> Optional[LedgerSnapshot]:
        """Take a reference on the newest snapshot (None before the
        first capture).  Pair with :meth:`release`."""
        with self._lock:
            snap = self._current
            if snap is not None:
                snap.refs += 1
                self._refresh_gauges_locked()
            return snap

    def release(self, snap: LedgerSnapshot) -> None:
        with self._lock:
            self._release_locked(snap)
            self._refresh_gauges_locked()

    def _release_locked(self, snap: LedgerSnapshot) -> None:
        snap.refs -= 1
        if snap.refs <= 0:
            self._open.discard(snap)

    # ------------------------------------------------------------------ gc --
    def pinned_bucket_hashes(self) -> Set[bytes]:
        """Bucket hashes every live snapshot still references — the
        GC ref provider (BucketManager.gc_ref_providers)."""
        with self._lock:
            snaps = list(self._open)
        pinned: Set[bytes] = set()
        for s in snaps:
            pinned |= s.bucket_hashes()
        return pinned

    def live_buckets(self):
        """Distinct Bucket objects held by live snapshots (for
        bucket-index stat drains over buckets the live list already
        dropped)."""
        with self._lock:
            snaps = list(self._open)
        seen = set()
        for s in snaps:
            for b in s.buckets():
                if id(b) not in seen:
                    seen.add(id(b))
                    yield b

    # ------------------------------------------------------------- plumbing --
    def _refresh_gauges_locked(self) -> None:
        if self._open_gauge is not None:
            self._open_gauge.set_count(len(self._open))

    def refresh_pinned_gauge(self) -> None:
        """Recount the pinned-bucket gauge (telemetry cadence — the
        full recount is too heavy for every acquire/release)."""
        if self._pinned_gauge is not None:
            self._pinned_gauge.set_count(len(self.pinned_bucket_hashes()))

    def stats(self) -> dict:
        with self._lock:
            cur = self._current
            return {
                "ledger_seq": cur.ledger_seq if cur is not None else None,
                "open": len(self._open),
                "refs_current": cur.refs if cur is not None else 0,
            }

    def shutdown(self) -> None:
        """Drop the manager's own reference so shutdown-time bucket GC
        is not pinned by a node that no longer serves reads."""
        with self._lock:
            cur = self._current
            self._current = None
            if cur is not None:
                self._release_locked(cur)
            self._refresh_gauges_locked()
