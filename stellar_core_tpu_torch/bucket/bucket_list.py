"""The 11-level bucket list with background merges.

Reference design (bucket/BucketList.cpp:24-71 essay, BucketList.h:155-160):
levels of exponentially growing capacity, each split into curr/snap;
level i holds roughly levelSize(i) = 4^(i+1) ledgers of changes and
spills curr->snap every levelHalf(i) = levelSize(i)/2 ledgers, the spilled
snap merging asynchronously into level i+1's curr (FutureBucket,
FutureBucket.h:22-77 — a shared_future there, a ThreadPoolExecutor future
here). Tombstones are dropped only when merging into the bottom level.

Hash: sha256 over per-level sha256(curr.hash ‖ snap.hash) — same shape as
the reference's BucketList::getHash. `get_hash()` resolves pending merges
first, so the hash is a function of ledger sequence + contents only.
"""

from __future__ import annotations

import hashlib
import threading
from concurrent.futures import Executor, Future, ThreadPoolExecutor
from typing import Callable, List, Optional

from ..util.checks import releaseAssert
from .bucket import Bucket, merge_buckets

NUM_LEVELS = 11


_REDUCED_MERGE_COUNTS = [False]


def set_reduced_merge_counts(on: bool) -> None:
    """Shrink every level so spills/merges happen far more often
    (reference: ARTIFICIALLY_REDUCE_MERGE_COUNTS_FOR_TESTING). Consensus
    state depends on the level cadence — testing networks only."""
    _REDUCED_MERGE_COUNTS[0] = bool(on)


def level_size(level: int) -> int:
    return (2 if _REDUCED_MERGE_COUNTS[0] else 4) ** (level + 1)


def level_half(level: int) -> int:
    return level_size(level) // 2


def level_should_spill(ledger: int, level: int) -> bool:
    return ledger % level_half(level) == 0


class FutureBucket:
    """In-progress merge; resolves to a Bucket. Synchronous fallback when
    no executor is supplied (deterministic tests)."""

    def __init__(self, fn: Callable[[], Bucket],
                 executor: Optional[Executor] = None):
        self._fut: Optional[Future] = (
            executor.submit(fn) if executor is not None else None)
        self._fn = fn
        self._result: Optional[Bucket] = None

    def resolve(self) -> Bucket:
        if self._result is None:
            self._result = (self._fut.result() if self._fut is not None
                            else self._fn())
            # release the closure: it pins the merge inputs (curr/snap/
            # shadow buckets); only the output matters from here on
            self._fn = None
            self._fut = None
        return self._result

    def is_live(self) -> bool:
        return self._result is None


class MergeKey:
    """Identity of one merge: inputs + semantics knobs (reference:
    bucket/MergeKey.h — maxProtocolVersion, keepDeadEntries, input
    curr/snap/shadow hashes)."""

    __slots__ = ("key",)

    def __init__(self, keep_dead: bool, curr: Bucket, snap: Bucket,
                 shadows, protocol):
        self.key = (keep_dead, curr.hash, snap.hash,
                    tuple(s.hash for s in shadows), protocol)

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, MergeKey) and self.key == other.key


class BucketMergeMap:
    """Dedup of equivalent merges (reference: bucket/BucketMergeMap.h +
    BucketManagerImpl::getMergeFuture/putMergeFuture): two levels (or a
    restarted list) asking for the same merge share ONE future — and
    once resolved, the recorded future keeps serving the memoized
    output bucket for identical inputs."""

    def __init__(self, max_entries: int = 64):
        self._map = {}
        self._lock = threading.Lock()
        self._max = max_entries
        self.reused = 0
        self.started = 0

    def get_or_start(self, key: MergeKey, fn,
                     executor) -> "FutureBucket":
        with self._lock:
            fb = self._map.get(key)
            if fb is not None:
                self.reused += 1
                return fb
            if len(self._map) >= self._max:
                # drop resolved entries first; never a live future
                for k in [k for k, v in self._map.items()
                          if not v.is_live()][:self._max // 2]:
                    del self._map[k]
            fb = FutureBucket(fn, executor)
            self._map[key] = fb
            self.started += 1
            return fb

    def live_input_hashes(self):
        """Input hashes of unresolved merges (GC must retain them;
        reference: forgetUnreferencedBuckets' in-progress exclusion)."""
        with self._lock:
            out = set()
            for k, fb in self._map.items():
                if fb.is_live():
                    _keep, ch, sh, shadows, _p = k.key
                    out.add(ch)
                    out.add(sh)
                    out.update(shadows)
            return out


class BucketLevel:
    def __init__(self, level: int):
        self.level = level
        self.curr = Bucket.empty()
        self.snap = Bucket.empty()
        self._next: Optional[FutureBucket] = None

    def commit(self) -> None:
        """Resolve the pending merge into curr (reference:
        BucketLevel::commit)."""
        if self._next is not None:
            self.curr = self._next.resolve()
            self._next = None

    def prepare(self, fb: FutureBucket) -> None:
        releaseAssert(self._next is None,
                      f"level {self.level} already has a pending merge")
        self._next = fb

    def snap_curr(self) -> Bucket:
        """curr -> snap, curr emptied; returns the new snap."""
        self.commit()
        self.snap = self.curr
        self.curr = Bucket.empty()
        return self.snap

    def get_hash(self) -> bytes:
        self.commit()
        return hashlib.sha256(self.curr.hash + self.snap.hash).digest()


class BucketList:
    def __init__(self, executor: Optional[Executor] = None, perf=None,
                 merge_map: Optional[BucketMergeMap] = None):
        self.levels: List[BucketLevel] = [BucketLevel(i)
                                          for i in range(NUM_LEVELS)]
        self._executor = executor
        self.merge_map = merge_map
        self.perf = perf  # per-app zone registry (None = process default)

    def add_batch(self, ledger_seq: int, protocol: int, init, live,
                  dead) -> None:
        """Fold one closed ledger's delta into the list (reference:
        BucketList::addBatch, BucketList.cpp:707-806).  For
        pre-protocol-12 merges, the younger levels' buckets are passed
        as shadows: when level i-1 spills into level i, the shadow set
        is the curr/snap of levels 0..i-2 (the spilling level's own
        buckets are the merge inputs, not shadows — the reference pops
        two bucket pairs before considering shadows)."""
        from .bucket import FIRST_PROTOCOL_SHADOWS_REMOVED
        releaseAssert(ledger_seq > 0, "ledger seq must be positive")
        # top-down so a level's spill sees its own pending merge resolved
        # before the level below pushes new state into it
        for i in range(NUM_LEVELS - 1, 0, -1):
            if level_should_spill(ledger_seq, i - 1):
                below = self.levels[i - 1]
                snap = below.snap_curr()
                lvl = self.levels[i]
                lvl.commit()
                cur, keep = lvl.curr, i < NUM_LEVELS - 1
                if snap.is_empty():
                    continue
                if snap.meta_protocol >= FIRST_PROTOCOL_SHADOWS_REMOVED:
                    shadows = []      # reference: FutureBucket's
                    # shadowsBasedOnProtocol (BucketList.cpp:177-181)
                else:
                    shadows = []
                    for j in range(i - 1):
                        shadows.append(self.levels[j].curr)
                        shadows.append(self.levels[j].snap)
                fn = (lambda cur=cur, snap=snap, keep=keep, sh=shadows:
                      merge_buckets(cur, snap, keep_dead=keep,
                                    protocol=protocol, shadows=sh,
                                    perf=self.perf))
                if self.merge_map is not None:
                    fb = self.merge_map.get_or_start(
                        MergeKey(keep, cur, snap, shadows, protocol),
                        fn, self._executor)
                else:
                    fb = FutureBucket(fn, self._executor)
                lvl.prepare(fb)
        fresh = Bucket.fresh(protocol, init, live, dead)
        l0 = self.levels[0]
        l0.commit()
        l0.curr = merge_buckets(l0.curr, fresh, protocol=protocol,
                                perf=self.perf)

    def get_hash(self) -> bytes:
        h = hashlib.sha256()
        for lvl in self.levels:
            h.update(lvl.get_hash())
        return h.digest()

    def resolve_all_merges(self) -> None:
        for lvl in self.levels:
            lvl.commit()

    def get_entry(self, key) -> Optional:
        """Point lookup newest-first across levels (the BucketListDB
        read path, bucket/readme.md:86-105). Returns the BucketEntry or
        None if unknown; DEADENTRY means 'known erased'."""
        from ..xdr.ledger import BucketEntryType
        for lvl in self.levels:
            lvl.commit()
            for b in (lvl.curr, lvl.snap):
                be = b.get(key)
                if be is not None:
                    return be
        return None

    def visit_ledger_entries(self, accept, process,
                             min_last_modified=None) -> int:
        """Walk every live ledger entry newest-version-first (reference:
        BucketManager::visitLedgerEntries, used by dump-ledger).

        `accept(entry) -> bool` filters; `process(entry) -> bool`
        consumes and returns False to stop early.  Entries whose newest
        record is a DEADENTRY are skipped; `min_last_modified` skips
        entries older than the given ledger.  Returns the number of
        entries processed."""
        from ..xdr.ledger import BucketEntryType
        from ..xdr.ledger_entries import ledger_entry_key
        seen = set()
        count = 0
        for lvl in self.levels:
            lvl.commit()
            for b in (lvl.curr, lvl.snap):
                for be in b.entries():
                    if be.disc == BucketEntryType.METAENTRY:
                        continue
                    if be.disc == BucketEntryType.DEADENTRY:
                        seen.add(be.value.to_bytes())
                        continue
                    entry = be.value
                    kb = ledger_entry_key(entry).to_bytes()
                    if kb in seen:
                        continue  # newer version already visited
                    seen.add(kb)
                    if min_last_modified is not None and \
                            entry.lastModifiedLedgerSeq < min_last_modified:
                        continue
                    if not accept(entry):
                        continue
                    count += 1
                    if not process(entry):
                        return count
        return count

    def total_entry_count(self) -> int:
        n = 0
        for lvl in self.levels:
            lvl.commit()
            n += len(lvl.curr.entries()) + len(lvl.snap.entries())
        return n
