"""History archives: layout, state manifest, checkpoint math.

Reference: src/history/HistoryArchive.{h,cpp} + history/readme.md —
archives are dumb blob stores driven by operator-templated shell
commands (`get {remote} {local}`, `put {local} {remote}`,
`mkdir {dir}`); the manifest is `.well-known/stellar-history.json`
(HistoryArchiveState: currentLedger + 11 levels of bucket hashes);
checkpoints occur every 64 ledgers (HistoryManager.h:51-57); files live
at category/ww/xx/yy/category-hex8.xdr.gz.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict, List, Optional

from ..util import chaos

# reference: HistoryManager::getCheckpointFrequency
CHECKPOINT_FREQUENCY = 64

HAS_PATH = ".well-known/stellar-history.json"
HISTORY_ARCHIVE_STATE_VERSION = 1


def checkpoint_containing(ledger: int) -> int:
    """Last ledger of the checkpoint containing `ledger` (reference:
    HistoryManager::checkpointContainingLedger)."""
    return (ledger // CHECKPOINT_FREQUENCY + 1) * CHECKPOINT_FREQUENCY - 1


def is_checkpoint_ledger(ledger: int) -> bool:
    return (ledger + 1) % CHECKPOINT_FREQUENCY == 0


def first_ledger_in_checkpoint(checkpoint: int) -> int:
    first = checkpoint - CHECKPOINT_FREQUENCY + 1
    return max(first, 1)


def file_path(category: str, checkpoint: int, ext: str = ".xdr.gz") -> str:
    """category/ww/xx/yy/category-wwxxyyzz.ext (reference:
    FileTransferInfo remoteName)."""
    hex8 = "%08x" % checkpoint
    return (f"{category}/{hex8[0:2]}/{hex8[2:4]}/{hex8[4:6]}/"
            f"{category}-{hex8}{ext}")


def bucket_path(bucket_hex: str) -> str:
    return (f"bucket/{bucket_hex[0:2]}/{bucket_hex[2:4]}/"
            f"{bucket_hex[4:6]}/bucket-{bucket_hex}.xdr.gz")


def note_archive_failure(app) -> None:
    """One counter for every archive-command failure, get or put
    (docs/ROBUSTNESS.md): operators alert on it long before the retry
    ladder gives up."""
    metrics = getattr(app, "metrics", None)
    if metrics is not None:
        metrics.counter("history", "archive", "failure").inc()


class HistoryArchiveState:
    """The JSON manifest (reference: HistoryArchive.h:33-123)."""

    def __init__(self, current_ledger: int = 0,
                 current_buckets: Optional[List[dict]] = None,
                 network_passphrase: str = "",
                 server: str = "stellar-core-tpu",
                 hot_archive_buckets: Optional[List[dict]] = None):
        self.version = HISTORY_ARCHIVE_STATE_VERSION
        self.server = server
        self.network_passphrase = network_passphrase
        self.current_ledger = current_ledger
        self.current_buckets = current_buckets or []
        # protocol-next: the hot-archive list's level states (absent on
        # curr-protocol archives so their JSON stays byte-identical)
        self.hot_archive_buckets = hot_archive_buckets

    @classmethod
    def from_bucket_list(cls, current_ledger: int, bucket_list,
                         network_passphrase: str,
                         hot_archive=None) -> "HistoryArchiveState":
        """`hot_archive` (a HotArchiveBucketList) is recorded when it has
        ever held a record — pre-state-archival archives stay
        byte-identical (reference: the HAS-v2 hot-archive bucket levels,
        HistoryArchive.h:33-123)."""
        levels = []
        for lvl in bucket_list.levels:
            lvl.commit()
            levels.append({
                "curr": lvl.curr.hash.hex(),
                "snap": lvl.snap.hash.hex(),
                "next": {"state": 0},
            })
        hot = None
        if hot_archive is not None and not hot_archive.is_trivial():
            hot = hot_archive.level_states()
        return cls(current_ledger, levels, network_passphrase,
                   hot_archive_buckets=hot)

    @staticmethod
    def _hashes_of(levels) -> List[str]:
        out = []
        for lvl in levels or []:
            for key in ("curr", "snap"):
                h = lvl[key]
                if h and set(h) != {"0"}:
                    out.append(h)
        return out

    def bucket_hashes(self) -> List[str]:
        """All non-empty bucket hex hashes referenced, live + hot
        (reference: HistoryArchiveState::allBuckets)."""
        return self._hashes_of(self.current_buckets) + \
            self._hashes_of(self.hot_archive_buckets)

    def live_bucket_hashes(self) -> List[str]:
        return self._hashes_of(self.current_buckets)

    def hot_bucket_hashes(self) -> List[str]:
        return self._hashes_of(self.hot_archive_buckets)

    def to_json(self) -> str:
        doc = {
            "version": self.version,
            "server": self.server,
            "networkPassphrase": self.network_passphrase,
            "currentLedger": self.current_ledger,
            "currentBuckets": self.current_buckets,
        }
        if self.hot_archive_buckets is not None:
            # hot-archive levels are the HAS-v2 format extension
            doc["version"] = max(self.version, 2)
            doc["hotArchiveBuckets"] = self.hot_archive_buckets
        return json.dumps(doc, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "HistoryArchiveState":
        doc = json.loads(text)
        has = cls(doc["currentLedger"], doc["currentBuckets"],
                  doc.get("networkPassphrase", ""),
                  doc.get("server", ""),
                  doc.get("hotArchiveBuckets"))
        has.version = doc.get("version", 1)
        return has


class HistoryArchive:
    """One configured archive: name + command templates (reference:
    HistoryArchive.h:152-167; commands use {0}/{1} placeholders like the
    reference's `{0}`/`{1}` template substitution)."""

    def __init__(self, name: str, get_cmd: str = "", put_cmd: str = "",
                 mkdir_cmd: str = ""):
        self.name = name
        self.get_cmd = get_cmd
        self.put_cmd = put_cmd
        self.mkdir_cmd = mkdir_cmd

    def has_get(self) -> bool:
        return bool(self.get_cmd)

    def has_put(self) -> bool:
        return bool(self.put_cmd)

    # `false` exits nonzero: an injected archive failure takes the real
    # command-failed path (retries, publish-queue retention) end to end
    _CHAOS_FAIL_CMD = "false"

    def get_file_cmd(self, remote: str, local: str) -> str:
        if chaos.ENABLED and chaos.point(
                "history.get", None, archive=self.name,
                remote=remote) is chaos.FAIL:
            return self._CHAOS_FAIL_CMD
        return self.get_cmd.format(remote, local)

    def put_file_cmd(self, local: str, remote: str) -> str:
        if chaos.ENABLED and chaos.point(
                "history.put", None, archive=self.name,
                remote=remote) is chaos.FAIL:
            return self._CHAOS_FAIL_CMD
        return self.put_cmd.format(local, remote)

    def mkdir_dir_cmd(self, d: str) -> str:
        return self.mkdir_cmd.format(d) if self.mkdir_cmd else ""


def make_tmpdir_archive(name: str, root: str) -> HistoryArchive:
    """Filesystem-backed archive for tests/local runs (reference:
    TmpDirHistoryConfigurator — get/put are plain cp)."""
    os.makedirs(root, exist_ok=True)
    return HistoryArchive(
        name,
        get_cmd=f"cp {root}/{{0}} {{1}}",
        put_cmd=f"mkdir -p $(dirname {root}/{{1}}) && cp {{0}} "
                f"{root}/{{1}}",
        mkdir_cmd=f"mkdir -p {root}/{{0}}")


def write_gz(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # mtime=0 keeps output deterministic across runs
    with open(path, "wb") as f:
        with gzip.GzipFile(fileobj=f, mode="wb", mtime=0) as gz:
            gz.write(data)


def read_gz(path: str) -> bytes:
    with gzip.open(path, "rb") as f:
        return f.read()
