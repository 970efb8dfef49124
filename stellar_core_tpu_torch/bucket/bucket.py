"""Bucket: one immutable, sorted XDR flat file of ledger-entry lifecycle
records, identified by the SHA-256 of its stream.

Reference behavior being reproduced (not translated): bucket/Bucket.cpp —
METAENTRY protocol header first; entries sorted by ledger key so merges
are linear-time zips; INITENTRY/LIVEENTRY/DEADENTRY lifecycle with the
protocol>=11 annihilation rules (Bucket.cpp:252-453); merge output
deterministic for identical inputs (content-hash dedup depends on it).

Sort order: (entry type, canonical XDR of the LedgerKey) — deterministic
and total; this build defines its own canonical order rather than
replicating LedgerEntryIdCmp field-by-field.
"""

from __future__ import annotations

import hashlib
import io
import os
import threading
from typing import Dict, Iterable, List, Optional, Tuple

from ..util import xdr_stream
from ..util.checks import releaseAssert
from ..xdr.ledger import BucketEntry, BucketEntryType, BucketMetadata
from ..xdr.ledger_entries import LedgerEntry, LedgerKey, ledger_entry_key

EMPTY_HASH = bytes(32)

# protocol version stamped in METAENTRY (this build's ledger protocol)
CURRENT_BUCKET_PROTOCOL = 1

# the newest ledger protocol this build understands (the cadence used
# by ARTIFICIALLY_REPLAY_WITH_NEWEST_BUCKET_LOGIC_FOR_TESTING)
NEWEST_LEDGER_PROTOCOL = 23

# reference: Bucket.h:122-125 — INITENTRY/METAENTRY appear at protocol
# 11; shadow-based elision is retired at protocol 12
FIRST_PROTOCOL_SUPPORTING_INITENTRY_AND_METAENTRY = 11
FIRST_PROTOCOL_SHADOWS_REMOVED = 12


def ledger_key_index_key(k: LedgerKey) -> bytes:
    """THE canonical sortable key format — the bucket sort and the
    BucketIndex lookup both use this, so file order and index order
    cannot drift."""
    return bytes([k.disc & 0xFF]) + k.to_bytes()


def _entry_sort_key(be: BucketEntry) -> bytes:
    if be.disc == BucketEntryType.DEADENTRY:
        k = be.value
    else:
        k = ledger_entry_key(be.value)
    return ledger_key_index_key(k)


class Bucket:
    """Immutable; backed by a file when persisted, else by bytes."""

    def __init__(self, entries: List[BucketEntry], raw: bytes,
                 content_hash: bytes, path: Optional[str] = None,
                 meta_protocol: int = 0):
        self._entries = entries
        self._raw = raw
        self.hash = content_hash
        self.path = path
        # ledgerVersion from the METAENTRY; 0 = no meta (pre-protocol-11
        # bucket, reference: Bucket::getBucketVersion)
        self.meta_protocol = meta_protocol
        self._index = None           # lazy BucketIndex (bucket_index.py)
        # crank and query-worker both reach get() — the lazy build must
        # not race itself (the built index is immutable afterwards)
        self._index_lock = threading.Lock()
        self._sort_keys = None       # lazy per-entry merge keys
        self._rec_bytes = None       # lazy per-entry record payloads

    def sort_keys(self) -> List[bytes]:
        """Per-entry canonical sort keys, computed once — the merge
        loop compares keys O(n) times and key serialization dominated
        it before memoization."""
        if self._sort_keys is None:
            self._sort_keys = [_entry_sort_key(e) for e in self._entries]
        return self._sort_keys

    def rec_bytes(self) -> List[bytes]:
        """Per-entry serialized payloads, parallel to entries() — a
        merge re-emits most records verbatim, so their bytes are reused
        instead of re-serialized. Materialized LAZILY (only merge
        inputs pay the memory) by re-slicing the raw record stream; a
        bucket that never merges never duplicates its raw."""
        if self._rec_bytes is None:
            recs: List[bytes] = []
            if self._raw:
                bio = io.BytesIO(self._raw)
                while True:
                    rec = xdr_stream.read_record(bio)
                    if rec is None:
                        break
                    recs.append(rec)
                if len(recs) == len(self._entries) + 1:
                    recs = recs[1:]       # drop the METAENTRY record
            else:
                recs = [e.to_bytes() for e in self._entries]
            releaseAssert(len(recs) == len(self._entries),
                          "bucket raw/entry record count mismatch")
            self._rec_bytes = recs
        return self._rec_bytes

    # ------------------------------------------------------------ creation --
    @classmethod
    def empty(cls) -> "Bucket":
        return cls([], b"", EMPTY_HASH)

    @classmethod
    def from_entries(cls, entries: List[BucketEntry],
                     protocol: int = CURRENT_BUCKET_PROTOCOL,
                     sort_keys: Optional[List[bytes]] = None,
                     rec_bytes: Optional[List[bytes]] = None) -> "Bucket":
        """Build (and hash) a bucket from lifecycle records; sorts and
        prepends METAENTRY (protocol >= 11 only — older buckets have no
        meta record, reference: Bucket::fresh + checkProtocolLegality).
        `sort_keys` (parallel to `entries`) marks the input as already
        sorted — the merge produces output in order, so re-sorting and
        re-deriving keys there would be pure waste; `rec_bytes`
        (parallel) supplies already-serialized record payloads."""
        if sort_keys is None:
            keyed = sorted(((_entry_sort_key(e), e) for e in entries),
                           key=lambda t: t[0])
            sort_keys = [k for k, _ in keyed]
            entries = [e for _, e in keyed]
            rec_bytes = None
        if rec_bytes is None:
            rec_bytes = [e.to_bytes() for e in entries]
        buf = io.BytesIO()
        with_meta = protocol >= \
            FIRST_PROTOCOL_SUPPORTING_INITENTRY_AND_METAENTRY
        if with_meta and entries:
            meta = BucketEntry(BucketEntryType.METAENTRY,
                               BucketMetadata(ledgerVersion=protocol))
            xdr_stream.write_record(buf, meta.to_bytes())
        for rb in rec_bytes:
            xdr_stream.write_record(buf, rb)
        raw = buf.getvalue()
        h = hashlib.sha256(raw).digest() if raw else EMPTY_HASH
        b = cls(entries, raw, h,
                meta_protocol=protocol if with_meta and entries else 0)
        b._sort_keys = sort_keys
        # rec_bytes is NOT retained: rec_bytes() re-slices lazily from
        # raw, so only actual merge inputs pay the duplicate memory
        return b

    @classmethod
    def fresh(cls, protocol: int, init: Iterable[LedgerEntry],
              live: Iterable[LedgerEntry],
              dead: Iterable[LedgerKey]) -> "Bucket":
        """Level-0 bucket from one ledger close (reference:
        Bucket::fresh, Bucket.cpp:190-230).  Before protocol 11 there is
        no INITENTRY: creations are recorded as LIVEENTRY."""
        use_init = protocol >= \
            FIRST_PROTOCOL_SUPPORTING_INITENTRY_AND_METAENTRY
        recs: List[BucketEntry] = []
        for e in init:
            recs.append(BucketEntry(
                BucketEntryType.INITENTRY if use_init
                else BucketEntryType.LIVEENTRY, e))
        for e in live:
            recs.append(BucketEntry(BucketEntryType.LIVEENTRY, e))
        for k in dead:
            recs.append(BucketEntry(BucketEntryType.DEADENTRY, k))
        return cls.from_entries(recs, protocol=protocol)

    @classmethod
    def from_file(cls, path: str) -> "Bucket":
        with open(path, "rb") as f:
            raw = f.read()
        b = cls.from_raw(raw)
        b.path = path
        return b

    @classmethod
    def from_raw(cls, raw: bytes) -> "Bucket":
        entries = []
        meta_protocol = 0
        bio = io.BytesIO(raw)
        for be in xdr_stream.read_all(bio, BucketEntry):
            if be.disc != BucketEntryType.METAENTRY:
                entries.append(be)
            else:
                meta_protocol = be.value.ledgerVersion
        h = hashlib.sha256(raw).digest() if raw else EMPTY_HASH
        return cls(entries, raw, h, meta_protocol=meta_protocol)

    def write_to(self, path: str, fsync: bool = True) -> None:
        if not os.path.exists(path):
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(self._raw)
                if fsync:
                    # reference: DISABLE_XDR_FSYNC=false default — XDR
                    # files are durable before they are referenced
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, path)
        self.path = path

    # ------------------------------------------------------------- queries --
    def raw_bytes(self) -> bytes:
        return self._raw

    def is_empty(self) -> bool:
        return not self._entries

    def entries(self) -> List[BucketEntry]:
        return self._entries

    def size_bytes(self) -> int:
        return len(self._raw)

    def _build_index(self):
        """Lazy BucketIndex over the raw record stream (reference:
        BucketIndexImpl — bloom filter + IndividualIndex/RangeIndex by
        file size, bucket/readme.md:55-90). With persist-index enabled
        and a backing file, the built index round-trips through a
        sidecar keyed by the content-addressed path (immutable, so the
        sidecar can never go stale). The sidecar is a PASSIVE
        struct-packed format (bucket_index.dump_index_bytes) — it sits
        in a shared directory, so parsing it must never execute code,
        and damage is reported, not silently swallowed."""
        if self._index is not None:
            return self._index
        with self._index_lock:
            return self._build_index_locked()

    def _build_index_locked(self):
        if self._index is None:
            import struct

            from .bucket_index import (BucketIndex, current_tuning,
                                       dump_index_bytes, load_index_bytes,
                                       persist_enabled)
            sidecar = (self.path + ".idx") if (
                self.path and persist_enabled()) else None
            tuning = current_tuning()
            if sidecar and os.path.exists(sidecar):
                try:
                    with open(sidecar, "rb") as f:
                        loaded = load_index_bytes(f.read(), tuning)
                    # None = built under different index tuning; the
                    # operator's current knobs win — rebuild
                    if loaded is not None:
                        self._index = loaded
                        return self._index
                except (OSError, ValueError, struct.error) as exc:
                    from ..util.logging import get_logger
                    get_logger("Bucket").warning(
                        "rebuilding damaged index sidecar %s: %s",
                        sidecar, exc)
            self._index = BucketIndex.build(self._raw,
                                            entries=self._entries)
            if sidecar:
                try:
                    tmp = sidecar + ".tmp"
                    with open(tmp, "wb") as f:
                        f.write(dump_index_bytes(self._index, tuning))
                    os.replace(tmp, sidecar)
                except OSError:
                    pass
        return self._index

    def get(self, key: LedgerKey) -> Optional[BucketEntry]:
        return self._build_index().lookup(self._raw, key)


_NEWEST_MERGE_LOGIC = [False]


def set_newest_merge_logic(on: bool) -> None:
    """Force every merge to run at the CURRENT bucket protocol
    regardless of input metas (reference:
    ARTIFICIALLY_REPLAY_WITH_NEWEST_BUCKET_LOGIC_FOR_TESTING — replay
    old history with today's merge semantics)."""
    _NEWEST_MERGE_LOGIC[0] = bool(on)


def merge_protocol_version(old: Bucket, new: Bucket,
                           shadows=()) -> int:
    """The protocol a merge runs under: max of the input metas, plus any
    pre-protocol-12 shadow metas (reference:
    calculateMergeProtocolVersion, Bucket.cpp:566-605 — once any input
    is on the shadows-removed protocol, shadow versions no longer pull
    the merge version up)."""
    if _NEWEST_MERGE_LOGIC[0]:
        return NEWEST_LEDGER_PROTOCOL
    protocol = max(old.meta_protocol, new.meta_protocol)
    for s in shadows:
        if s.meta_protocol < FIRST_PROTOCOL_SHADOWS_REMOVED:
            protocol = max(protocol, s.meta_protocol)
    return protocol


def check_protocol_legality(be: BucketEntry, protocol: int) -> None:
    """INIT/META records may not appear in pre-11 merges (reference:
    Bucket::checkProtocolLegality)."""
    if protocol < FIRST_PROTOCOL_SUPPORTING_INITENTRY_AND_METAENTRY and \
            be.disc in (BucketEntryType.INITENTRY,
                        BucketEntryType.METAENTRY):
        raise ValueError(
            f"unsupported entry type {be.disc.name} in protocol "
            f"{protocol} bucket")


class _ShadowScanner:
    """Sorted-merge shadow membership: one advancing cursor per shadow
    bucket (reference: the shadowIterators in maybePut,
    Bucket.cpp:446-523).  Output keys arrive in sorted order, so each
    cursor only ever moves forward."""

    def __init__(self, shadows):
        self._iters = [(s.sort_keys(), [0]) for s in shadows if
                       not s.is_empty()]

    def shadows_key(self, key: bytes) -> bool:
        hit = False
        for keys, pos in self._iters:
            i = pos[0]
            n = len(keys)
            while i < n and keys[i] < key:
                i += 1
            pos[0] = i
            if i < n and keys[i] == key:
                hit = True
        return hit


def merge_buckets(old: Bucket, new: Bucket, keep_dead: bool = True,
                  protocol: Optional[int] = None,
                  shadows=(), perf=None) -> Bucket:
    """Deterministic linear merge, newer shadows older, with the
    INIT/LIVE/DEAD annihilation rules of protocol>=11
    (Bucket.cpp mergeCasesWithEqualKeys):

      old INIT + new LIVE -> INIT(new data)
      old INIT + new DEAD -> (annihilated)
      old LIVE + new DEAD -> DEAD
      old DEAD + new INIT -> LIVE(new data)
      otherwise           -> the newer record wins

    keep_dead=False additionally drops tombstones (only valid at the
    bottom level, where nothing older can resurrect a key).

    `shadows` (younger-level buckets) drive pre-protocol-12 shadow
    elision (reference: maybePut, Bucket.cpp:446-523): an output record
    whose key is present in any shadow is dropped — except that from
    protocol 11 INIT/DEAD lifecycle records are always kept so
    INIT+DEAD annihilation stays sound.  `protocol` is the cap
    (maxProtocolVersion; None = uncapped); the merge runs at the
    version derived from the inputs."""
    from ..util.perf import default_registry
    with (perf or default_registry).zone("bucket.merge"):
        merge_protocol = merge_protocol_version(old, new, shadows)
        if protocol is not None and merge_protocol > protocol:
            raise ValueError(
                f"bucket protocol {merge_protocol} exceeds max {protocol}")
        if merge_protocol >= FIRST_PROTOCOL_SHADOWS_REMOVED:
            shadows = ()
        return _merge_buckets_impl(old, new, keep_dead, merge_protocol,
                                   shadows)


def _merge_buckets_impl(old: Bucket, new: Bucket, keep_dead: bool,
                        protocol: int, shadows=()) -> Bucket:
    oi, ni = old.entries(), new.entries()
    ok_, nk_ = old.sort_keys(), new.sort_keys()
    ob_, nb_ = old.rec_bytes(), new.rec_bytes()
    out: List[BucketEntry] = []
    out_keys: List[bytes] = []
    out_recs: List[bytes] = []
    i = j = 0
    T = BucketEntryType
    # from protocol 11, lifecycle records (INIT/DEAD) are exempt from
    # shadow elision (reference: keepShadowedLifecycleEntries)
    keep_lifecycle = protocol >= \
        FIRST_PROTOCOL_SUPPORTING_INITENTRY_AND_METAENTRY
    scanner = _ShadowScanner(shadows) if shadows else None
    while i < len(oi) or j < len(ni):
        if j >= len(ni):
            pick, key, rec = oi[i], ok_[i], ob_[i]
            i += 1
            check_protocol_legality(pick, protocol)
        elif i >= len(oi):
            pick, key, rec = ni[j], nk_[j], nb_[j]
            j += 1
            check_protocol_legality(pick, protocol)
        else:
            ko, kn = ok_[i], nk_[j]
            if ko < kn:
                pick, key, rec = oi[i], ko, ob_[i]
                i += 1
                check_protocol_legality(pick, protocol)
            elif kn < ko:
                pick, key, rec = ni[j], kn, nb_[j]
                j += 1
                check_protocol_legality(pick, protocol)
            else:
                o, n = oi[i], ni[j]
                key, rec = ko, nb_[j]
                check_protocol_legality(o, protocol)
                check_protocol_legality(n, protocol)
                i, j = i + 1, j + 1
                if n.disc == T.INITENTRY:
                    # only legal with old DEAD: delete+create -> update
                    if o.disc != T.DEADENTRY:
                        raise ValueError(
                            "malformed bucket: old non-DEAD + new INIT")
                    pick = BucketEntry(T.LIVEENTRY, n.value)
                    rec = None       # transformed: re-serialize
                elif o.disc == T.INITENTRY and n.disc == T.LIVEENTRY:
                    pick = BucketEntry(T.INITENTRY, n.value)
                    rec = None
                elif o.disc == T.INITENTRY and n.disc == T.DEADENTRY:
                    continue
                else:
                    pick = n
        if pick.disc == T.DEADENTRY and not keep_dead:
            continue
        if scanner is not None:
            if keep_lifecycle and pick.disc in (T.INITENTRY, T.DEADENTRY):
                pass                 # lifecycle records never elided
            elif scanner.shadows_key(key):
                continue
        out.append(pick)
        out_keys.append(key)
        out_recs.append(rec if rec is not None else pick.to_bytes())
    return Bucket.from_entries(out, protocol=protocol,
                               sort_keys=out_keys, rec_bytes=out_recs)
