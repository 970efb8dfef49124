"""The protocol-next hot-archive bucket list (state archival).

A second bucket list holding entries evicted from the live state:
ARCHIVED records carry the full evicted LedgerEntry; LIVE marks a
previously archived entry as restored (the hot archive's tombstone);
DELETED records deletion-while-archived.  Same exponential level
cadence and curr/snap split as the live list (bucket_list.level_size /
level_half / level_should_spill), newest-record-wins merges, and the
same hash shape so the HAS can carry both lists.

This is the next-protocol content grown from the curr/next split
mechanism (xdr/next_types.py; reference: src/protocol-next built and
CI'd alongside curr, Makefile.am:46-51 — the hot-archive design tracks
the in-development state-archival bucket work referenced by
BucketListType).  Wire types live in the next namespace only: nothing
here is imported by curr-protocol code paths, keeping curr's wire
language byte-identical (proved by tests/test_protocol_next.py).
"""

from __future__ import annotations

import hashlib
import io
from typing import Dict, List, Optional

from ..util.checks import releaseAssert
from ..util.xdr_stream import read_record, write_record
from ..xdr.ledger_entries import LedgerEntry, LedgerKey, ledger_entry_key
from ..xdr.next_types import (BucketListType, BucketMetadata,
                              _BucketMetadataExt, HotArchiveBucketEntry,
                              HotArchiveBucketEntryType)
from .bucket_list import NUM_LEVELS, level_should_spill

# first protocol whose ledgers run the eviction scan and commit to the
# hot archive (the protocol-next state-archival content)
FIRST_PROTOCOL_STATE_ARCHIVAL = 23

_META = HotArchiveBucketEntryType.HOT_ARCHIVE_METAENTRY
_ARCHIVED = HotArchiveBucketEntryType.HOT_ARCHIVE_ARCHIVED
_LIVE = HotArchiveBucketEntryType.HOT_ARCHIVE_LIVE
_DELETED = HotArchiveBucketEntryType.HOT_ARCHIVE_DELETED


def _entry_key_bytes(be: HotArchiveBucketEntry) -> Optional[bytes]:
    if be.disc == _META:
        return None
    if be.disc == _ARCHIVED:
        return ledger_entry_key(be.value).to_bytes()
    return be.value.to_bytes()


class HotArchiveBucket:
    """One sorted flat file of HotArchiveBucketEntry records, headed by
    a METAENTRY whose BucketMetadata.ext(1) = HOT_ARCHIVE."""

    def __init__(self, raw: bytes, entries: List[HotArchiveBucketEntry]):
        self._raw = raw
        self._entries = entries
        self.hash = hashlib.sha256(raw).digest() if raw else b"\x00" * 32

    @classmethod
    def empty(cls) -> "HotArchiveBucket":
        return cls(b"", [])

    @classmethod
    def from_entries(cls, entries: List[HotArchiveBucketEntry],
                     protocol: int) -> "HotArchiveBucket":
        if not entries:
            return cls.empty()
        meta = HotArchiveBucketEntry(_META, BucketMetadata(
            ledgerVersion=protocol,
            ext=_BucketMetadataExt(1, BucketListType.HOT_ARCHIVE)))
        body = sorted(entries, key=_entry_key_bytes)
        buf = io.BytesIO()
        for be in [meta] + body:
            write_record(buf, be.to_bytes())
        return cls(buf.getvalue(), [meta] + body)

    @classmethod
    def from_raw(cls, raw: bytes) -> "HotArchiveBucket":
        if not raw:
            return cls.empty()
        bio = io.BytesIO(raw)
        entries = []
        while True:
            rec = read_record(bio)
            if rec is None:
                break
            entries.append(HotArchiveBucketEntry.from_bytes(rec))
        return cls(raw, entries)

    def is_empty(self) -> bool:
        return not self._entries

    def entries(self) -> List[HotArchiveBucketEntry]:
        return self._entries

    def raw_bytes(self) -> bytes:
        return self._raw

    def get(self, key: LedgerKey) -> Optional[HotArchiveBucketEntry]:
        kb = key.to_bytes()
        for be in self._entries:
            if _entry_key_bytes(be) == kb:
                return be
        return None


def merge_hot_archive(old: HotArchiveBucket, new: HotArchiveBucket,
                      protocol: int,
                      bottom_level: bool = False) -> HotArchiveBucket:
    """Newest-record-wins linear merge. At the bottom level, LIVE
    (restored) records drop entirely: a restored entry needs no hot-
    archive trace once no older version can exist beneath it — the
    analogue of dropping DEADENTRYs when merging into the live list's
    bottom level."""
    merged: Dict[bytes, HotArchiveBucketEntry] = {}
    for be in old.entries():
        kb = _entry_key_bytes(be)
        if kb is not None:
            merged[kb] = be
    for be in new.entries():
        kb = _entry_key_bytes(be)
        if kb is not None:
            merged[kb] = be
    out = list(merged.values())
    if bottom_level:
        out = [be for be in out if be.disc != _LIVE]
    if not out:
        return HotArchiveBucket.empty()
    return HotArchiveBucket.from_entries(out, protocol)


class HotArchiveLevel:
    def __init__(self, level: int):
        self.level = level
        self.curr = HotArchiveBucket.empty()
        self.snap = HotArchiveBucket.empty()

    def get_hash(self) -> bytes:
        h = hashlib.sha256()
        h.update(self.curr.hash)
        h.update(self.snap.hash)
        return h.digest()


class HotArchiveBucketList:
    """Same level cadence as the live list; merges are synchronous (the
    hot archive's per-ledger deltas are eviction-scan sized, orders of
    magnitude smaller than live-state deltas)."""

    def __init__(self):
        self.levels = [HotArchiveLevel(i) for i in range(NUM_LEVELS)]

    def add_batch(self, ledger_seq: int, protocol: int,
                  archived: List[LedgerEntry],
                  restored: List[LedgerKey],
                  deleted: List[LedgerKey]) -> None:
        """Fold one closed ledger's eviction delta in — the exact spill
        cadence of BucketList.add_batch (top-down; level i-1's snap
        merges into level i's curr when i-1 spills)."""
        releaseAssert(ledger_seq > 0, "ledger seq must be positive")
        for i in range(NUM_LEVELS - 1, 0, -1):
            if level_should_spill(ledger_seq, i - 1):
                below = self.levels[i - 1]
                below.snap = below.curr
                below.curr = HotArchiveBucket.empty()
                snap = below.snap
                if snap.is_empty():
                    continue
                lvl = self.levels[i]
                lvl.curr = merge_hot_archive(
                    lvl.curr, snap, protocol,
                    bottom_level=(i == NUM_LEVELS - 1))
        entries = (
            [HotArchiveBucketEntry(_ARCHIVED, e) for e in archived]
            + [HotArchiveBucketEntry(_LIVE, k) for k in restored]
            + [HotArchiveBucketEntry(_DELETED, k) for k in deleted])
        fresh = HotArchiveBucket.from_entries(entries, protocol)
        lvl0 = self.levels[0]
        lvl0.curr = merge_hot_archive(lvl0.curr, fresh, protocol)

    def is_trivial(self) -> bool:
        """True while the archive has never held a record — lets the
        manager skip per-ledger batching until the first eviction, a
        predicate derived purely from (consensus-identical) list state
        so every node flips at the same ledger."""
        return all(lvl.curr.is_empty() and lvl.snap.is_empty()
                   for lvl in self.levels)

    def get_entry(self, key: LedgerKey) -> Optional[HotArchiveBucketEntry]:
        """Newest-first point lookup (LIVE = known restored)."""
        for lvl in self.levels:
            for b in (lvl.curr, lvl.snap):
                be = b.get(key)
                if be is not None:
                    return be
        return None

    def get_hash(self) -> bytes:
        h = hashlib.sha256()
        for lvl in self.levels:
            h.update(lvl.get_hash())
        return h.digest()

    # ------------------------------------------------------- HAS support --
    def level_states(self) -> List[dict]:
        return [{"curr": lvl.curr.hash.hex(), "snap": lvl.snap.hash.hex(),
                 "next": {"state": 0}} for lvl in self.levels]

    @classmethod
    def from_level_states(cls, states: List[dict],
                          bucket_for) -> "HotArchiveBucketList":
        """Reconstruct (assume-state / catchup): `bucket_for(hex_hash)
        -> raw bytes` resolves the referenced buckets."""
        hal = cls()
        for lvl, st in zip(hal.levels, states):
            for attr in ("curr", "snap"):
                hx = st[attr]
                if set(hx) == {"0"}:
                    continue
                b = HotArchiveBucket.from_raw(bucket_for(hx))
                releaseAssert(b.hash.hex() == hx,
                              "hot-archive bucket hash mismatch")
                setattr(lvl, attr, b)
        return hal
