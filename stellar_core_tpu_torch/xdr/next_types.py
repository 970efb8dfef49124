"""Protocol-next structural deltas — the second XDR type set.

Reference: `src/protocol-next/` carries the in-development protocol's
.x changes as a complete parallel tree (Makefile.am:46-51); builds
against curr and next must both compile and be hash-distinguishable.

The deltas below model the actual in-flight next-protocol change to the
bucket format (hot-archive bucket lists: BucketMetadata.ext v1 carries
a BucketListType discriminator).  They are STRUCTURAL — a new union
arm and enum — which the version-gate mechanism inside one merged tree
cannot represent; this namespace can.

Types here are standalone classes (not mutations of the curr classes),
so the curr build's wire language is untouched; `schema.next_namespace`
overlays them by name.
"""

from __future__ import annotations

from enum import IntEnum

from .ledger_entries import LedgerEntry, LedgerKey
from .runtime import Int32, Struct, Uint32, Union


class BucketListType(IntEnum):
    """next: which bucket list a bucket belongs to (live vs the
    hot-archive list introduced for state archival)."""
    LIVE = 0
    HOT_ARCHIVE = 1


# plain int-discriminated ext (v: 0 = void, 1 = bucketListType)
class _BucketMetadataExt(Union):
    SWITCH = Int32
    ARMS = {0: None, 1: ("bucketListType", BucketListType)}


class BucketMetadata(Struct):
    """next-protocol BucketMetadata: ext arm 1 discriminates the
    bucket-list kind."""
    FIELDS = [("ledgerVersion", Uint32), ("ext", _BucketMetadataExt)]


# --------------------------------------------------------------------------
# hot-archive bucket entries: the next protocol's second bucket list
# (state archival). Entry kinds mirror the in-development tree's shape:
# ARCHIVED carries the full evicted entry, LIVE marks an archived entry
# as restored (a hot-archive tombstone), DELETED records that the entry
# was deleted while archived; METAENTRY heads every bucket with the
# next BucketMetadata whose ext discriminates the list kind.
# Reference mechanism: src/protocol-next built+tested alongside curr
# (Makefile.am:46-51); the content here is this framework's next tree.
# --------------------------------------------------------------------------

class HotArchiveBucketEntryType(IntEnum):
    HOT_ARCHIVE_METAENTRY = -1
    HOT_ARCHIVE_ARCHIVED = 0
    HOT_ARCHIVE_LIVE = 1
    HOT_ARCHIVE_DELETED = 2


class HotArchiveBucketEntry(Union):
    SWITCH = HotArchiveBucketEntryType
    ARMS = {
        HotArchiveBucketEntryType.HOT_ARCHIVE_METAENTRY:
            ("metaEntry", BucketMetadata),
        HotArchiveBucketEntryType.HOT_ARCHIVE_ARCHIVED:
            ("archivedEntry", LedgerEntry),
        HotArchiveBucketEntryType.HOT_ARCHIVE_LIVE: ("key", LedgerKey),
        HotArchiveBucketEntryType.HOT_ARCHIVE_DELETED: ("key", LedgerKey),
    }


# the overlay consumed by schema.next_namespace(); keys replace the
# same-named curr types (new names extend the namespace)
NEXT_TYPES = {
    "BucketListType": BucketListType,
    "BucketMetadata": BucketMetadata,
    "_BucketMetadataExt": _BucketMetadataExt,
    "HotArchiveBucketEntryType": HotArchiveBucketEntryType,
    "HotArchiveBucketEntry": HotArchiveBucketEntry,
}
