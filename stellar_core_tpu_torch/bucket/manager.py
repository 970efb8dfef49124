"""BucketManager: shared bucket directory with content-hash dedup and
refcount GC (reference: bucket/BucketManagerImpl.cpp — adoptFileAsBucket,
getBucketByHash, forgetUnreferencedBuckets)."""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Set

from ..util.logging import get_logger
from .bucket import Bucket, EMPTY_HASH
from .bucket_list import BucketList, BucketMergeMap
from .hot_archive import FIRST_PROTOCOL_STATE_ARCHIVAL

log = get_logger("Bucket")


class BucketManager:
    def __init__(self, bucket_dir: str, num_workers: int = 2,
                 pessimize_merges: bool = False,
                 disable_gc: bool = False,
                 disable_xdr_fsync: bool = False):
        self.dir = bucket_dir
        # reference: DISABLE_BUCKET_GC — unreferenced buckets stay
        self.disable_gc = disable_gc
        # reference: DISABLE_XDR_FSYNC — skip fsync on bucket files
        self.disable_xdr_fsync = disable_xdr_fsync
        os.makedirs(bucket_dir, exist_ok=True)
        self._buckets: Dict[bytes, Bucket] = {}
        self._lock = threading.Lock()
        self.executor = ThreadPoolExecutor(
            max_workers=num_workers, thread_name_prefix="bucket-merge")
        # shared merge futures + output memoization (reference:
        # BucketMergeMap wired through getMergeFuture/putMergeFuture)
        self.merge_map = BucketMergeMap()
        # extra GC roots: callables returning bucket hashes that must
        # survive forget_unreferenced_buckets even though no level
        # references them yet — the publish queue registers here
        # (reference: forgetUnreferencedBuckets' publish-queue refs)
        self.gc_ref_providers: list = []
        # hot-archive files adopted by an in-flight catchup BEFORE the
        # levels are installed; pinned until the catchup resolves
        self._hot_pins: Set[bytes] = set()
        # pessimize = no background executor: every merge resolves
        # synchronously on the closing thread, the worst legal schedule
        # (reference: ARTIFICIALLY_PESSIMIZE_MERGES_FOR_TESTING)
        self.bucket_list = BucketList(
            None if pessimize_merges else self.executor,
            merge_map=self.merge_map)
        # state-archival hot archive (protocol 23+): evicted persistent
        # entries land here; RestoreFootprint reads it back
        # (bucket/hot_archive.py; reference: the protocol-next hot
        # archive bucket list in src/bucket/)
        from .hot_archive import HotArchiveBucketList
        self.hot_archive = HotArchiveBucketList()
        # load any buckets already on disk (restart path; reference:
        # BucketManagerImpl::getBucketByHash lazy-load from dir)
        for fn in os.listdir(bucket_dir):
            if fn.startswith("bucket-") and fn.endswith(".xdr"):
                b = Bucket.from_file(os.path.join(bucket_dir, fn))
                self._buckets[b.hash] = b

    def _path_for(self, h: bytes) -> str:
        return os.path.join(self.dir, f"bucket-{h.hex()}.xdr")

    def adopt_bucket(self, bucket: Bucket) -> Bucket:
        """Deduplicate by content hash; persists to the shared dir."""
        if bucket.hash == EMPTY_HASH:
            return bucket
        with self._lock:
            existing = self._buckets.get(bucket.hash)
            if existing is not None:
                return existing
            bucket.write_to(self._path_for(bucket.hash),
                            fsync=not self.disable_xdr_fsync)
            self._buckets[bucket.hash] = bucket
            return bucket

    def get_bucket_by_hash(self, h: bytes) -> Optional[Bucket]:
        if h == EMPTY_HASH:
            return Bucket.empty()
        with self._lock:
            b = self._buckets.get(h)
        if b is None and os.path.exists(self._path_for(h)):
            b = Bucket.from_file(self._path_for(h))
            with self._lock:
                self._buckets[h] = b
        return b

    def add_batch(self, ledger_seq: int, protocol: int, init, live,
                  dead) -> None:
        self.bucket_list.add_batch(ledger_seq, protocol, init, live, dead)

    def hot_archive_add_batch(self, ledger_seq: int, protocol: int,
                              archived, restored) -> None:
        if archived or restored or not self.hot_archive.is_trivial():
            self.hot_archive.add_batch(ledger_seq, protocol, archived,
                                       restored, [])

    # -------------------------------------------- hot archive persistence --
    def _hot_path(self, h: bytes) -> str:
        return os.path.join(self.dir, f"hot-{h.hex()}.xdr")

    def persist_hot_archive(self) -> Optional[str]:
        """Write the hot archive's buckets to the shared dir and return
        its level-state JSON (stored in the node's persistent state so
        restarts — reference: assumeState — reload the archive the
        protocol-23 headers commit to). None while trivially empty."""
        if self.hot_archive.is_trivial():
            return None
        import json
        for lvl in self.hot_archive.levels:
            for b in (lvl.curr, lvl.snap):
                if not b.is_empty():
                    self._write_hot_file(b.hash, b.raw_bytes())
        return json.dumps(self.hot_archive.level_states())

    def _write_hot_file(self, h: bytes, raw: bytes) -> None:
        """Atomic tmp+replace write so a crash never leaves a truncated
        file at the content-addressed path."""
        path = self._hot_path(h)
        if os.path.exists(path):
            return
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(raw)
            if not self.disable_xdr_fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)

    def get_hot_bucket_raw(self, h: bytes) -> Optional[bytes]:
        """Raw bytes of a hot-archive bucket by content hash — from the
        in-memory list or the shared dir (publish + catchup lookups)."""
        for lvl in self.hot_archive.levels:
            for b in (lvl.curr, lvl.snap):
                if not b.is_empty() and b.hash == h:
                    return b.raw_bytes()
        path = self._hot_path(h)
        if os.path.exists(path):
            with open(path, "rb") as f:
                raw = f.read()
            import hashlib
            if hashlib.sha256(raw).digest() != h:
                log.error("corrupt hot-archive bucket file %s", path)
                return None
            return raw
        return None

    def adopt_hot_bucket_raw(self, raw: bytes,
                             digest: Optional[bytes] = None) -> None:
        """Persist a downloaded hot-archive bucket file to the shared
        dir (catchup's analogue of adopt_bucket). `digest` skips a
        re-hash when the caller already verified the content hash."""
        if digest is None:
            import hashlib
            digest = hashlib.sha256(raw).digest()
        # pin until the catchup installs (or abandons) its levels — GC
        # must not unlink a file the in-flight catchup just downloaded
        self._hot_pins.add(digest)
        self._write_hot_file(digest, raw)

    def clear_hot_pins(self) -> None:
        """Release in-flight-catchup pins (called when the catchup's
        hot-archive levels are installed or the attempt is abandoned)."""
        self._hot_pins.clear()

    def _extra_gc_refs(self) -> Set[bytes]:
        refs: Set[bytes] = set(self._hot_pins)
        for provider in self.gc_ref_providers:
            refs.update(provider())
        return refs

    def restore_hot_archive(self, level_states_json: str) -> None:
        """Rebuild the hot archive from persisted level state + bucket
        files (restart path)."""
        import json
        from .hot_archive import HotArchiveBucketList

        def bucket_for(hx: str) -> bytes:
            with open(self._hot_path(bytes.fromhex(hx)), "rb") as f:
                return f.read()

        rebuilt = HotArchiveBucketList.from_level_states(
            json.loads(level_states_json), bucket_for)
        # mutate in place: the LedgerTxn root holds a reference to this
        # object (RestoreFootprint's lookup path)
        self.hot_archive.levels = rebuilt.levels

    def snapshot_ledger_hash(self, protocol: Optional[int] = None) -> bytes:
        """bucketListHash for the ledger header (reference:
        LedgerManagerImpl::ledgerClosed -> BucketList::getHash). From
        the state-archival protocol on, the header commits to BOTH
        lists: sha256(live_hash ‖ hot_archive_hash)."""
        h = self.bucket_list.get_hash()
        # persist resolved buckets so restarts can reload them
        for lvl in self.bucket_list.levels:
            for b in (lvl.curr, lvl.snap):
                if not b.is_empty():
                    self.adopt_bucket(b)
        if protocol is not None and \
                protocol >= FIRST_PROTOCOL_STATE_ARCHIVAL:
            import hashlib
            return hashlib.sha256(h + self.hot_archive.get_hash()).digest()
        return h

    def referenced_hashes(self) -> Set[bytes]:
        """Committed curr/snap of every level, WITHOUT resolving
        pending merges (reference: forgetUnreferencedBuckets never
        blocks on in-flight merges) — a pending merge's inputs are the
        levels' current buckets (already referenced) plus whatever
        live_input_hashes() reports."""
        refs: Set[bytes] = set()
        for lvl in self.bucket_list.levels:
            for b in (lvl.curr, lvl.snap):
                if not b.is_empty():
                    refs.add(b.hash)
        return refs

    def forget_unreferenced_buckets(self) -> int:
        """Refcount GC (reference: forgetUnreferencedBuckets — inputs of
        in-progress merges count as referenced; DISABLE_BUCKET_GC keeps
        everything). Buckets referenced by queued-but-unpublished
        checkpoints (gc_ref_providers) and hot files adopted by an
        in-flight catchup (_hot_pins) count as referenced too — both
        are systematic with PUBLISH_TO_ARCHIVE_DELAY > 0."""
        if self.disable_gc:
            return 0
        extra = self._extra_gc_refs()
        refs = self.referenced_hashes() | \
            self.merge_map.live_input_hashes() | extra
        dropped = 0
        with self._lock:
            for h in list(self._buckets):
                if h not in refs:
                    b = self._buckets.pop(h)
                    if b.path and os.path.exists(b.path):
                        os.unlink(b.path)
                        # drop the persisted index sidecar with it
                        if os.path.exists(b.path + ".idx"):
                            os.unlink(b.path + ".idx")
                    dropped += 1
        # hot-archive files live outside self._buckets; drop any not in
        # the current level arrangement (spills leave stale hashes),
        # the publish queue, or the in-flight-catchup pins
        hot_refs = {b.hash for lvl in self.hot_archive.levels
                    for b in (lvl.curr, lvl.snap)
                    if not b.is_empty()} | extra
        for fn in os.listdir(self.dir):
            if fn.startswith("hot-") and fn.endswith(".xdr"):
                h = bytes.fromhex(fn[4:-4])
                if h not in hot_refs:
                    os.unlink(os.path.join(self.dir, fn))
                    dropped += 1
        if dropped:
            log.debug("dropped %d unreferenced buckets", dropped)
        return dropped

    def drain_index_meters(self, metrics, extra_buckets=()) -> dict:
        """Sum-and-reset every live BucketIndex's lookup tallies onto
        the registry's ``bucket.index.{hit,miss,bloom_fp}`` meters
        (telemetry cadence — collect_sample / Prometheus scrapes read
        the meters, indexes keep cheap local counters in between).

        ``extra_buckets`` covers buckets the live list already rotated
        out but read snapshots still hold (SnapshotManager.live_buckets).
        Only already-built indexes are drained — draining must never
        force an index build."""
        totals = {"lookups": 0, "hits": 0, "bloom_misses": 0,
                  "false_positives": 0}
        seen = set()
        buckets = [b for lvl in self.bucket_list.levels
                   for b in (lvl.curr, lvl.snap)]
        buckets.extend(extra_buckets)
        for b in buckets:
            idx = getattr(b, "_index", None)
            if idx is None or id(idx) in seen:
                continue
            seen.add(id(idx))
            stats = idx.take_stats()
            for k in totals:
                totals[k] += stats[k]
        out = {"lookups": totals["lookups"],
               "hit": totals["hits"],
               # miss = definitive "not in this bucket" answers, both
               # bloom short-circuits and false-positive probes
               "miss": totals["bloom_misses"] + totals["false_positives"],
               "bloom_fp": totals["false_positives"]}
        if metrics is not None:
            for name, n in (("hit", out["hit"]), ("miss", out["miss"]),
                            ("bloom_fp", out["bloom_fp"])):
                if n:
                    metrics.meter("bucket", "index", name).mark(n)
        return out

    def wait_merges(self) -> None:
        """Block until every in-flight level merge has resolved
        (reference: CATCHUP_WAIT_MERGES_TX_APPLY_FOR_TESTING — catchup
        applies the next ledger only after merges complete). Resolution
        only materializes the future's result; adoption still happens at
        the level's spill commit."""
        for lvl in self.bucket_list.levels:
            if lvl._next is not None:
                lvl._next.resolve()

    def shutdown(self) -> None:
        self.executor.shutdown(wait=True)
