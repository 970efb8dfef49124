"""Bucket-apply fast-forward: restore state at a checkpoint without
replaying history.

Reference: catchup/ApplyBucketsWork.{h,cpp} + BucketApplicator +
AssumeStateWork — download the HAS's buckets, write the live entries
into the database newest-version-first, adopt the bucket list levels,
and assume the checkpoint's header as the LCL.
"""

from __future__ import annotations

import io
import os
from typing import Dict, List, Optional

from ..bucket.bucket import Bucket
from ..history.archive import (HistoryArchive, HistoryArchiveState,
                               bucket_path, file_path, read_gz)
from ..ledger.ledger_manager import ledger_header_hash
from ..util.logging import get_logger
from ..util.xdr_stream import read_record
from ..work import State, Work
from ..xdr.ledger import BucketEntryType, LedgerHeaderHistoryEntry
from ..xdr.ledger_entries import LedgerEntry, LedgerKey
from .catchup_work import GetRemoteFileWork

log = get_logger("History")


def key_for_entry(le: LedgerEntry) -> LedgerKey:
    from ..xdr.ledger_entries import ledger_entry_key
    return ledger_entry_key(le)


class ApplyBucketsWork(Work):
    """Reference: ApplyBucketsWork — invariants' checkOnBucketApply runs
    per bucket (catchup/ApplyBucketsWork.cpp:248,263)."""

    def __init__(self, app, archive: HistoryArchive,
                 has: HistoryArchiveState, download_dir: str):
        super().__init__(app, "apply-buckets", max_retries=0)
        self.archive = archive
        self.has = has
        self.dir = download_dir
        self._spawned = False
        self._header: Optional[LedgerHeaderHistoryEntry] = None

    def _bucket_local(self, hex_hash: str) -> str:
        return os.path.join(self.dir, f"bucket-{hex_hash}.xdr.gz")

    def _ledger_local(self) -> str:
        return os.path.join(
            self.dir, f"ledger-{self.has.current_ledger:08x}.xdr.gz")

    def do_work(self) -> State:
        if not self._spawned:
            for hex_hash in self.has.bucket_hashes():
                self.add_work(GetRemoteFileWork(
                    self.app, self.archive, bucket_path(hex_hash),
                    self._bucket_local(hex_hash)))
            self.add_work(GetRemoteFileWork(
                self.app, self.archive,
                file_path("ledger", self.has.current_ledger),
                self._ledger_local()))
            self._spawned = True
            return State.WORK_RUNNING
        return self._apply()

    def _apply(self) -> State:
        # find the checkpoint header
        bio = io.BytesIO(read_gz(self._ledger_local()))
        while True:
            rec = read_record(bio)
            if rec is None:
                break
            hhe = LedgerHeaderHistoryEntry.from_bytes(rec)
            if hhe.header.ledgerSeq == self.has.current_ledger:
                self._header = hhe
        if self._header is None:
            log.error("checkpoint header %d not in ledger file",
                      self.has.current_ledger)
            return State.WORK_FAILURE

        # verify + adopt buckets (hot-archive buckets share the
        # content-addressed namespace but carry HotArchiveBucketEntry
        # records, so they are adopted separately)
        import hashlib
        import time as _time
        delay = self.app.config.\
            ARTIFICIALLY_DELAY_BUCKET_APPLICATION_FOR_TESTING
        hot_hashes = set(self.has.hot_bucket_hashes())
        buckets: Dict[str, Bucket] = {}
        for hex_hash in self.has.bucket_hashes():
            if delay > 0:
                # reference: ARTIFICIALLY_DELAY_BUCKET_APPLICATION —
                # models slow bucket IO per applied bucket
                _time.sleep(delay)
            raw = read_gz(self._bucket_local(hex_hash))
            if hashlib.sha256(raw).hexdigest() != hex_hash:
                log.error("bucket %s hash mismatch", hex_hash[:16])
                return State.WORK_FAILURE
            if hex_hash in hot_hashes:
                self.app.bucket_manager.adopt_hot_bucket_raw(
                    raw, digest=bytes.fromhex(hex_hash))
                continue
            bucket = Bucket.from_raw(raw)
            buckets[hex_hash] = \
                self.app.bucket_manager.adopt_bucket(bucket)

        # write live entries newest-first into the DB
        lm = self.app.ledger_manager
        from ..ledger.ledger_txn import LedgerTxn
        seen: set = set()
        level_buckets: List[Bucket] = []
        for lvl in self.has.current_buckets:
            for key in ("curr", "snap"):
                h = lvl[key]
                if h and set(h) != {"0"}:
                    level_buckets.append(buckets[h])
                else:
                    level_buckets.append(Bucket.empty())
        lm._set_root_header(self._header.header)
        with LedgerTxn(lm.root) as ltx:
            for bucket in level_buckets:
                for be in bucket.entries():
                    if be.disc in (BucketEntryType.LIVEENTRY,
                                   BucketEntryType.INITENTRY):
                        k = key_for_entry(be.value).to_bytes()
                        if k in seen:
                            continue
                        seen.add(k)
                        ltx.create(be.value)
                    elif be.disc == BucketEntryType.DEADENTRY:
                        seen.add(bytes(be.value.to_bytes()))
            ltx.commit()

        # assume the bucket list shape (reference: AssumeStateWork)
        bm = self.app.bucket_manager
        bl = bm.bucket_list
        for i, lvl in enumerate(self.has.current_buckets):
            bl.levels[i].curr = buckets.get(lvl["curr"], Bucket.empty())
            bl.levels[i].snap = buckets.get(lvl["snap"], Bucket.empty())
            bl.levels[i]._next = None

        # install the hot archive the protocol-23+ header commits to
        # (or an empty one if the target chain has none). The node's
        # previous levels are kept aside: a failed verification must
        # restore them, because the CURRENT LCL still commits to them.
        from ..bucket.hot_archive import HotArchiveBucketList
        old_hot_levels = bm.hot_archive.levels
        if self.has.hot_archive_buckets is not None:
            def hot_raw(hx: str) -> bytes:
                raw = bm.get_hot_bucket_raw(bytes.fromhex(hx))
                if raw is None:
                    raise RuntimeError(f"missing hot bucket {hx}")
                return raw

            bm.hot_archive.levels = HotArchiveBucketList \
                .from_level_states(self.has.hot_archive_buckets,
                                   hot_raw).levels
        else:
            bm.hot_archive.levels = HotArchiveBucketList().levels

        def fail_restoring_hot_archive() -> State:
            bm.hot_archive.levels = old_hot_levels
            bm.clear_hot_pins()
            return State.WORK_FAILURE

        # the header commits to the (combined, on p23+) bucket-list hash
        blh = bm.snapshot_ledger_hash(self._header.header.ledgerVersion)
        if blh != bytes(self._header.header.bucketListHash):
            log.error("assumed bucket list hash mismatch: %s vs header %s",
                      blh.hex()[:16],
                      bytes(self._header.header.bucketListHash).hex()[:16])
            return fail_restoring_hot_archive()

        lm._lcl_hash = ledger_header_hash(self._header.header)
        if bytes(self._header.hash) != lm._lcl_hash:
            log.error("assumed header hash mismatch")
            return fail_restoring_hot_archive()

        # all checks passed: only now may durable state change hands —
        # it must always describe a hash-verified arrangement
        if getattr(self.app, "persistent_state", None) is not None:
            from ..main.persistent_state import StateEntry
            if self.has.hot_archive_buckets is not None:
                hot = bm.persist_hot_archive()
                if hot is not None:
                    self.app.persistent_state.set(
                        StateEntry.HOT_ARCHIVE_STATE, hot)
            else:
                self.app.persistent_state.drop(
                    StateEntry.HOT_ARCHIVE_STATE)
        lm._store_header(self._header.header)
        # adopted hot files are now referenced by the installed levels;
        # the in-flight-catchup GC pins can go
        bm.clear_hot_pins()
        log.info("bucket-applied state at ledger %d",
                 self.has.current_ledger)
        return State.WORK_SUCCESS
