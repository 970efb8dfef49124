"""Disk-oriented bucket index: bloom filter + key→offset maps.

Reference: src/bucket/BucketIndexImpl.{h,cpp} + bucket/readme.md:55-90 —
the BucketListDB read path indexes each bucket file so point lookups do
one seek instead of a scan:

- **IndividualIndex** (buckets below the cutoff): every entry's key maps
  to its exact byte offset in the file.
- **RangeIndex** (large buckets): the file is split into fixed-size
  pages; the index keeps the first key of each page, and a lookup binary
  searches the page table then scans one page.
- A **bloom filter** over all keys short-circuits "definitely not here"
  before any file access (`bucketlistDB.bloom.misses` metric analogue).

Buckets are XDR record streams sorted by `_entry_sort_key`, so the page
table's keys are monotonically increasing and bisection is sound.
"""

from __future__ import annotations

import bisect
import hashlib
import io
import math
import struct
import threading
from typing import List, Optional, Tuple

from ..util.xdr_stream import read_record
from ..xdr.ledger import BucketEntry, BucketEntryType
from ..xdr.ledger_entries import LedgerKey
from .bucket import _entry_sort_key, ledger_key_index_key

# reference defaults: EXPERIMENTAL_BUCKETLIST_DB_INDEX_CUTOFF (MB) and
# EXPERIMENTAL_BUCKETLIST_DB_INDEX_PAGE_SIZE_EXPONENT
INDEX_CUTOFF_BYTES = 20 * 1024 * 1024
PAGE_SIZE = 1 << 14

# process-global tuning (reference:
# EXPERIMENTAL_BUCKETLIST_DB_INDEX_CUTOFF / _INDEX_PAGE_SIZE_EXPONENT —
# like the index itself, shared by every bucket in the process)
_TUNING = {"cutoff": INDEX_CUTOFF_BYTES, "page_size": PAGE_SIZE}


def configure_index(cutoff_mb: int, page_size_exponent: int) -> None:
    _TUNING["cutoff"] = int(cutoff_mb) * 1024 * 1024
    _TUNING["page_size"] = 1 << int(page_size_exponent)


_PERSIST = [False]


def set_persist_index(on: bool) -> None:
    """Persist built indexes beside their (content-addressed, immutable)
    bucket files and reload them on demand (reference:
    EXPERIMENTAL_BUCKETLIST_DB_PERSIST_INDEX)."""
    _PERSIST[0] = bool(on)


def persist_enabled() -> bool:
    return _PERSIST[0]


def current_tuning() -> tuple:
    return (_TUNING["cutoff"], _TUNING["page_size"])


def entry_index_key(be: BucketEntry) -> Optional[bytes]:
    """The sortable key bytes of one bucket entry (None for METAENTRY);
    delegates to the bucket's own sort key so file order and index order
    can never drift apart."""
    if be.disc == BucketEntryType.METAENTRY:
        return None
    return _entry_sort_key(be)


class BloomFilter:
    """Plain m-bit / k-hash bloom filter (reference vendored
    lib/bloom_filter.hpp); hashes derived from blake2b with per-probe
    salts so membership is deterministic across processes."""

    @classmethod
    def from_state(cls, m: int, k: int, bits: bytes) -> "BloomFilter":
        """Rebuild from persisted state (the passive sidecar format)."""
        bf = cls.__new__(cls)
        bf.m = m
        bf.k = k
        bf._bits = bytearray(bits)
        return bf

    def __init__(self, n_items: int, fp_rate: float = 0.01):
        n_items = max(1, n_items)
        m = max(64, int(-n_items * math.log(fp_rate) / (math.log(2) ** 2)))
        self.m = m
        # optimal k given the TARGET rate, independent of the m floor —
        # tiny buckets would otherwise get k≈44 probes from m=64/n=1
        self.k = max(1, math.ceil(-math.log2(fp_rate)))
        self._bits = bytearray((m + 7) // 8)

    def _probes(self, key: bytes):
        for i in range(self.k):
            h = hashlib.blake2b(key, digest_size=8,
                                salt=b"bloom%03d" % i).digest()
            yield int.from_bytes(h, "little") % self.m

    def add(self, key: bytes) -> None:
        for p in self._probes(key):
            self._bits[p >> 3] |= 1 << (p & 7)

    def __contains__(self, key: bytes) -> bool:
        return all(self._bits[p >> 3] & (1 << (p & 7))
                   for p in self._probes(key))


class BucketIndex:
    """Index over one bucket's raw record stream."""

    INDIVIDUAL = "individual"
    RANGE = "range"

    def __init__(self, kind: str, bloom: BloomFilter,
                 individual: Optional[dict] = None,
                 pages: Optional[List[Tuple[bytes, int]]] = None,
                 page_size: int = PAGE_SIZE,
                 entry_count: int = 0):
        self.kind = kind
        self.bloom = bloom
        self._individual = individual
        self._page_keys = [k for k, _ in (pages or [])]
        self._page_offsets = [o for _, o in (pages or [])]
        self.page_size = page_size
        self.entry_count = entry_count
        # lookup stats (bucketlistDB.bloom.misses analogue, plus the
        # hit/miss/false-positive split the read tier drains onto
        # bucket.index.* meters): crank AND query-worker both call
        # lookup, so tallies go under one stats lock
        self._stats_lock = threading.Lock()
        self.bloom_misses = 0
        self.bloom_lookups = 0
        self.hits = 0
        self.false_positives = 0

    # ------------------------------------------------------------- build --
    @classmethod
    def build(cls, raw: bytes, cutoff: Optional[int] = None,
              page_size: Optional[int] = None,
              entries: Optional[List[BucketEntry]] = None) -> "BucketIndex":
        """One pass over the record stream; picks the index style by
        file size (reference: BucketIndex::createIndex). When the caller
        already holds the parsed non-META entries (Bucket keeps them),
        pass them to skip re-decoding — only the record framing (and the
        4-byte METAENTRY discriminant) is inspected."""
        if cutoff is None:
            cutoff = _TUNING["cutoff"]
        if page_size is None:
            page_size = _TUNING["page_size"]
        # METAENTRY is -1 in the XDR enum: mask to its wire encoding
        meta_disc = (int(BucketEntryType.METAENTRY)
                     & 0xFFFFFFFF).to_bytes(4, "big")
        offsets: List[Tuple[bytes, int]] = []   # (sort key, offset)
        bio = io.BytesIO(raw)
        n_seen = 0
        while True:
            off = bio.tell()
            rec = read_record(bio)
            if rec is None:
                break
            if rec[:4] == meta_disc:
                continue
            if entries is not None:
                kb = entry_index_key(entries[n_seen])
                n_seen += 1
            else:
                kb = entry_index_key(BucketEntry.from_bytes(rec))
            if kb is not None:
                offsets.append((kb, off))
        bloom = BloomFilter(len(offsets))
        for kb, _ in offsets:
            bloom.add(kb)
        if len(raw) < cutoff:
            return cls(cls.INDIVIDUAL, bloom,
                       individual={kb: off for kb, off in offsets},
                       entry_count=len(offsets))
        pages: List[Tuple[bytes, int]] = []
        next_page = 0
        for kb, off in offsets:
            if off >= next_page or not pages:
                pages.append((kb, off))
                next_page = off + page_size
        return cls(cls.RANGE, bloom, pages=pages, page_size=page_size,
                   entry_count=len(offsets))

    # ------------------------------------------------------------ lookup --
    def lookup(self, raw: bytes, key: LedgerKey) -> Optional[BucketEntry]:
        """Point lookup against the raw stream this index was built on.
        Returns the BucketEntry (LIVE/INIT/DEAD) or None."""
        kb = ledger_key_index_key(key)
        if kb not in self.bloom:
            self._tally(bloom_miss=True)
            return None
        be = self._lookup_past_bloom(raw, kb)
        # the bloom said "maybe here" — an empty lookup past it is by
        # definition a bloom false positive
        self._tally(hit=be is not None, false_positive=be is None)
        return be

    def _lookup_past_bloom(self, raw: bytes,
                           kb: bytes) -> Optional[BucketEntry]:
        if self.kind == self.INDIVIDUAL:
            off = self._individual.get(kb)
            if off is None:
                return None
            bio = io.BytesIO(raw)
            bio.seek(off)
            return BucketEntry.from_bytes(read_record(bio))
        # range index: bisect to the page whose first key <= kb, then
        # scan until past it (entries are sorted)
        i = bisect.bisect_right(self._page_keys, kb) - 1
        if i < 0:
            return None
        bio = io.BytesIO(raw)
        bio.seek(self._page_offsets[i])
        end = self._page_offsets[i + 1] if i + 1 < len(self._page_offsets) \
            else len(raw)
        while bio.tell() <= end:
            rec = read_record(bio)
            if rec is None:
                break
            be = BucketEntry.from_bytes(rec)
            ekb = entry_index_key(be)
            if ekb == kb:
                return be
            if ekb is not None and ekb > kb:
                break
        return None

    # ------------------------------------------------------------- stats --
    def _tally(self, hit: bool = False, bloom_miss: bool = False,
               false_positive: bool = False) -> None:
        with self._stats_lock:
            self.bloom_lookups += 1
            if hit:
                self.hits += 1
            if bloom_miss:
                self.bloom_misses += 1
            if false_positive:
                self.false_positives += 1

    def take_stats(self) -> dict:
        """Atomically read-and-reset the lookup tallies (the metrics
        drain — BucketManager.drain_index_meters sums these across every
        live index onto the registry's bucket.index.* meters)."""
        with self._stats_lock:
            out = {"lookups": self.bloom_lookups,
                   "hits": self.hits,
                   "bloom_misses": self.bloom_misses,
                   "false_positives": self.false_positives}
            self.bloom_lookups = 0
            self.hits = 0
            self.bloom_misses = 0
            self.false_positives = 0
        return out


# --------------------------------------------------- sidecar persistence --
# Passive binary format for EXPERIMENTAL_BUCKETLIST_DB_PERSIST_INDEX
# sidecars (reference persists indexes in a passive on-disk layout too).
# Deliberately NOT pickle: a sidecar is untrusted input sitting in a
# shared bucket directory — parsing it must never execute code.
#
#   magic "TPUIDX02" | <Q cutoff> <Q page_size>      (tuning stamp)
#   <B kind> (0=individual, 1=range) | <Q bloom.m> <I bloom.k>
#   <Q len(bloom bits)> bits | <Q entry_count> | <Q page_size field>
#   <Q n_items> then n_items × (<H keylen> key <Q offset>)

SIDECAR_MAGIC = b"TPUIDX02"
_HDR = struct.Struct("<QQBQIQ")          # cutoff page_size kind m k nbits
_ITEM_HDR = struct.Struct("<H")
_OFFSET = struct.Struct("<Q")


def dump_index_bytes(index: BucketIndex, tuning: tuple) -> bytes:
    """Serialize an index + the tuning it was built under."""
    cutoff, page_size = tuning
    if index.kind == BucketIndex.INDIVIDUAL:
        items = sorted(index._individual.items())
        kind = 0
    else:
        items = list(zip(index._page_keys, index._page_offsets))
        kind = 1
    out = [SIDECAR_MAGIC,
           _HDR.pack(cutoff, page_size, kind, index.bloom.m,
                     index.bloom.k, len(index.bloom._bits)),
           bytes(index.bloom._bits),
           struct.pack("<QQQ", index.entry_count, index.page_size,
                       len(items))]
    for kb, off in items:
        out.append(_ITEM_HDR.pack(len(kb)))
        out.append(kb)
        out.append(_OFFSET.pack(off))
    return b"".join(out)


def load_index_bytes(raw: bytes, tuning: tuple) -> Optional[BucketIndex]:
    """Parse a sidecar; returns None when it was built under different
    tuning (the operator's current knobs win). Raises ValueError /
    struct.error on any structural damage — callers rebuild."""
    if raw[:len(SIDECAR_MAGIC)] != SIDECAR_MAGIC:
        raise ValueError("bad sidecar magic")
    pos = len(SIDECAR_MAGIC)
    cutoff, page_size, kind, m, k, nbits = _HDR.unpack_from(raw, pos)
    pos += _HDR.size
    if (cutoff, page_size) != tuple(tuning):
        return None
    if kind not in (0, 1) or len(raw) < pos + nbits:
        raise ValueError("truncated sidecar")
    bits = raw[pos:pos + nbits]
    pos += nbits
    entry_count, idx_page_size, n_items = struct.unpack_from(
        "<QQQ", raw, pos)
    pos += 24
    items: List[Tuple[bytes, int]] = []
    for _ in range(n_items):
        (klen,) = _ITEM_HDR.unpack_from(raw, pos)
        pos += _ITEM_HDR.size
        kb = raw[pos:pos + klen]
        if len(kb) != klen:
            raise ValueError("truncated sidecar key")
        pos += klen
        (off,) = _OFFSET.unpack_from(raw, pos)
        pos += _OFFSET.size
        items.append((kb, off))
    if pos != len(raw):
        raise ValueError("trailing bytes in sidecar")
    bloom = BloomFilter.from_state(m, k, bits)
    if kind == 0:
        return BucketIndex(BucketIndex.INDIVIDUAL, bloom,
                           individual=dict(items),
                           entry_count=entry_count)
    return BucketIndex(BucketIndex.RANGE, bloom, pages=items,
                       page_size=idx_page_size, entry_count=entry_count)
