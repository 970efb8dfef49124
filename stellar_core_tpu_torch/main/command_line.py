"""CLI subcommands.

Reference: src/main/CommandLine.cpp (subcommand list :1638-1698). We
implement the operator-facing core with argparse: run, new-db, gen-seed,
sec-to-pub, convert-id, version, http-command, offline-info, print-xdr,
sign-transaction, manualclose helpers arrive with their subsystems.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
from typing import List, Optional

from ..crypto.keys import SecretKey
from ..crypto.strkey import StrKey
from .config import Config

VERSION = "stellar-core-tpu 0.1.0"


def _load_config(args) -> Config:
    if args.conf:
        return Config.load(args.conf)
    return Config()


def cmd_version(args) -> int:
    print(VERSION)
    # XDR identity, as the reference prints its .x hashes in `version`
    from ..xdr.schema import identity
    for build, h in identity().items():
        print(f"xdr ({build}): {h}")
    return 0


def cmd_gen_seed(args) -> int:
    """reference: runGenSeed — print a fresh keypair."""
    import os
    sk = SecretKey.from_seed(os.urandom(32))
    print("Secret seed:", StrKey.encode_ed25519_seed(sk.seed))
    print("Public:", StrKey.encode_ed25519_public(sk.public_key().raw))
    return 0


def cmd_sec_to_pub(args) -> int:
    """reference: runSecToPub — seed on stdin → public key."""
    seed = input().strip()
    sk = SecretKey.from_seed(StrKey.decode_ed25519_seed(seed))
    print(StrKey.encode_ed25519_public(sk.public_key().raw))
    return 0


def cmd_convert_id(args) -> int:
    """reference: runConvertId — show every representation of a key."""
    s = args.id
    try:
        raw = StrKey.decode_ed25519_public(s)
        print(json.dumps({"strkey": s, "hex": raw.hex()}))
        return 0
    except Exception:
        pass
    raw = bytes.fromhex(s)
    print(json.dumps({"strkey": StrKey.encode_ed25519_public(raw),
                      "hex": s}))
    return 0


def cmd_new_db(args) -> int:
    """reference: runNewDB — initialize the database schema."""
    from ..db.database import create_database
    cfg = _load_config(args)
    db = create_database(cfg)
    db.initialize()
    db.close()
    print("database initialized")
    return 0


def cmd_run(args) -> int:
    """reference: runWithHelp → ApplicationUtils::runApp :274."""
    import os
    import signal

    from ..util.timer import ClockMode, VirtualClock
    from .application import Application
    from .command_handler import run_http_server

    cfg = _load_config(args)
    if cfg.LOG_FILE_PATH or cfg.LOG_COLOR:
        # before Application.create: startup (schema upgrade, bucket
        # adoption, catchup decisions) must reach the log file too
        from ..util.logging import init_logging
        init_logging(args.ll, log_file_path=cfg.LOG_FILE_PATH,
                     color=cfg.LOG_COLOR)
    clock = VirtualClock(ClockMode.REAL_TIME)
    app = Application.create(clock, cfg, new_db=args.new_db)
    app.start()
    http_thread = None
    if cfg.HTTP_PORT >= 0:
        # HTTP_PORT=0 binds an OS-assigned ephemeral port so parallel
        # harness nodes never collide; the actual bound port is
        # reported on stdout, on the `info` route, and (for a spawning
        # harness that can't parse stdout races) via --port-file
        http_thread = run_http_server(app.command_handler, cfg.HTTP_PORT,
                                      cfg.PUBLIC_HTTP_PORT,
                                      max_client=cfg.HTTP_MAX_CLIENT,
                                      clock=clock)
        bound_port = http_thread.server.server_address[1]
        app.http_port = bound_port
        print(f"HTTP port: {bound_port}", flush=True)
        if args.port_file:
            # write-then-rename: a poller must never read a torn file
            tmp = args.port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(bound_port))
            os.replace(tmp, args.port_file)
    # graceful SIGTERM: stop the crank loop so the finally-block
    # shutdown drains the deferred-completion queue and flushes the
    # flight recorder — harness teardown loses no tx-history/meta
    # tails. (kill -9 churn bypasses this by design: a real kill must
    # still lose the non-durable tails.)
    signal.signal(signal.SIGTERM, lambda *_: clock.stop())
    try:
        while not clock.stopped:
            app.crank(block=True)
    except KeyboardInterrupt:
        pass
    finally:
        if http_thread is not None:
            http_thread.server.shutdown()
        app.shutdown()
    return 0


def cmd_catchup(args) -> int:
    """reference: runCatchup — offline catchup from configured
    archives: `catchup <to>/<count>` (count currently ignored: full
    replay to <to>)."""
    from ..catchup import CatchupConfiguration, CatchupWork
    from ..history.archive import HistoryArchive
    from ..util.timer import ClockMode, VirtualClock
    from ..work import State, run_work_to_completion
    from .application import Application

    cfg = _load_config(args)
    to_ledger = int(args.destination.split("/")[0]) \
        if args.destination != "current" else 0
    clock = VirtualClock(ClockMode.REAL_TIME)
    app = Application.create(clock, cfg, new_db=args.new_db)
    app.start()
    try:
        if not app.history_manager.archives:
            print("no history archives configured")
            return 1
        archive = next(a for a in app.history_manager.archives
                       if a.has_get())
        work = CatchupWork(app, archive,
                           CatchupConfiguration(to_ledger=to_ledger))
        state = run_work_to_completion(app, work, timeout_virtual=86400)
        lcl = app.ledger_manager.get_last_closed_ledger_num()
        print(f"catchup {state.name}, LCL {lcl}")
        return 0 if state == State.WORK_SUCCESS else 1
    finally:
        app.shutdown()
    return 0


def cmd_publish(args) -> int:
    """reference: runPublish — flush the publish queue."""
    from ..util.timer import ClockMode, VirtualClock
    from .application import Application
    cfg = _load_config(args)
    app = Application.create(VirtualClock(ClockMode.REAL_TIME), cfg,
                             new_db=False)
    app.start()
    try:
        n = app.history_manager.publish_queued_history()
        print(f"published {n} checkpoints")
        return 0
    finally:
        app.shutdown()


def cmd_self_check(args) -> int:
    """reference: runSelfCheck (main/ApplicationUtils.cpp:487-517)."""
    from ..util.timer import ClockMode, VirtualClock
    from .application import Application
    from .self_check import self_check
    cfg = _load_config(args)
    app = Application.create(VirtualClock(ClockMode.REAL_TIME), cfg,
                             new_db=False)
    app.start()
    try:
        ok, report = self_check(app)
        print(json.dumps(report, indent=2))
        return 0 if ok else 1
    finally:
        app.shutdown()


def cmd_http_command(args) -> int:
    """reference: runHttpCommand — send a command to a running node."""
    import urllib.request
    cfg = _load_config(args)
    url = f"http://127.0.0.1:{cfg.HTTP_PORT}/{args.command}"
    with urllib.request.urlopen(url) as resp:
        print(resp.read().decode())
    return 0


def cmd_print_xdr(args) -> int:
    """reference: dumpXdrStream/printXdr — decode one XDR file to json."""
    from ..xdr import transaction as txxdr, ledger as ledgerxdr
    types = {
        "TransactionEnvelope": txxdr.TransactionEnvelope,
        "LedgerHeader": ledgerxdr.LedgerHeader,
        "TransactionSet": ledgerxdr.TransactionSet,
    }
    cls = types.get(args.filetype)
    if cls is None:
        print(f"unsupported filetype {args.filetype}", file=sys.stderr)
        return 1
    with open(args.file, "rb") as f:
        data = f.read()
    if args.base64:
        data = base64.b64decode(data)
    obj = cls.from_bytes(data)
    print(obj)
    return 0


def cmd_encode_asset(args) -> int:
    """reference: runEncodeAsset (CommandLine.cpp:1059-1090) — print a
    base64-encoded XDR Asset."""
    from ..crypto.strkey import StrKey
    from ..xdr.ledger_entries import Asset
    from ..xdr.types import PublicKey
    code, issuer = args.code, args.issuer
    if not code and not issuer:
        asset = Asset.native()
    elif not code or not issuer:
        print("If one of code or issuer is defined, the other must be "
              "defined", file=sys.stderr)
        return 1
    else:
        if len(code) > 12:
            print("asset code too long (max 12)", file=sys.stderr)
            return 1
        raw = StrKey.decode_ed25519_public(issuer)
        asset = Asset.credit(code.encode(), PublicKey.ed25519(raw))
    print(base64.b64encode(asset.to_bytes()).decode())
    return 0


def cmd_sign_transaction(args) -> int:
    """reference: signtxn (main/dumpxdr.cpp:377-460) — append a
    signature to a TransactionEnvelope and print it."""
    from ..crypto.keys import SecretKey
    from ..crypto.sha import sha256
    from ..crypto.strkey import StrKey
    from ..xdr.transaction import (DecoratedSignature, EnvelopeType,
                                   TransactionEnvelope,
                                   TransactionSignaturePayload,
                                   _TaggedTransaction)
    with open(args.file, "rb") as f:
        data = f.read()
    if args.base64:
        data = base64.b64decode(data)
    env = TransactionEnvelope.from_bytes(data)

    seed = args.seed
    if seed is None:
        seed = sys.stdin.readline().strip()
    sk = SecretKey.from_seed(StrKey.decode_ed25519_seed(seed))

    network_id = sha256(args.netid.encode())
    if env.disc == EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP:
        tagged = _TaggedTransaction(
            EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP, env.value.tx)
        sigs = env.value.signatures
    elif env.disc == EnvelopeType.ENVELOPE_TYPE_TX:
        tagged = _TaggedTransaction(
            EnvelopeType.ENVELOPE_TYPE_TX, env.value.tx)
        sigs = env.value.signatures
    else:
        print("unsupported envelope type", file=sys.stderr)
        return 1
    payload = TransactionSignaturePayload(
        networkId=network_id, taggedTransaction=tagged)
    h = sha256(payload.to_bytes())
    pub = sk.public_key().raw
    sigs.append(DecoratedSignature(hint=pub[-4:], signature=sk.sign(h)))
    out = env.to_bytes()
    if args.base64:
        print(base64.b64encode(out).decode())
    else:
        sys.stdout.buffer.write(out)
    return 0


def cmd_offline_info(args) -> int:
    """reference: runOfflineInfo — print the info JSON without running
    the node."""
    from ..util.timer import ClockMode, VirtualClock
    from .application import Application
    cfg = _load_config(args)
    app = Application.create(VirtualClock(ClockMode.VIRTUAL_TIME), cfg,
                             new_db=False)
    try:
        app.ledger_manager.load_last_known_ledger()
        print(json.dumps(app.info(), indent=2))
        return 0
    finally:
        app.shutdown()


def cmd_dump_ledger(args) -> int:
    """reference: dumpLedger (main/ApplicationUtils.cpp:549-640) —
    dump/aggregate the current ledger state from the bucket list,
    filtered by an xdrquery expression."""
    from ..util.timer import ClockMode, VirtualClock
    from ..util.xdrquery import (XDRAccumulator, XDRFieldExtractor,
                                 XDRMatcher)
    from ..xdr.json_repr import to_jsonable
    from .application import Application

    if args.group_by and not args.agg:
        print("--group-by without --agg is not allowed", file=sys.stderr)
        return 1
    cfg = _load_config(args)
    app = Application.create(VirtualClock(ClockMode.VIRTUAL_TIME), cfg,
                             new_db=False)
    try:
        lm = app.ledger_manager
        lm.load_last_known_ledger()
        min_ledger = None
        if args.last_modified_ledger_count is not None:
            lcl = lm.get_last_closed_ledger_num()
            # exactly `count` ledgers: [lcl - count + 1, lcl]
            min_ledger = max(0, lcl - args.last_modified_ledger_count + 1)
        # validate the queries before touching the output file so a bad
        # query can't truncate an existing dump
        matcher = XDRMatcher(args.filter_query) \
            if args.filter_query else None
        if matcher is not None:
            from ..xdr.ledger_entries import LedgerEntry
            matcher.match_xdr(LedgerEntry())
        group_by = XDRFieldExtractor(args.group_by) \
            if args.group_by else None
        if args.agg:
            XDRAccumulator(args.agg)  # parse check
        accumulators = {}
        out = open(args.output_file, "w") if args.output_file \
            else sys.stdout
        try:
            count = [0]

            def accept(entry) -> bool:
                return matcher is None or matcher.match_xdr(entry)

            def process(entry) -> bool:
                if args.agg:
                    key = tuple(group_by.extract_fields(entry)) \
                        if group_by else ()
                    acc = accumulators.get(key)
                    if acc is None:
                        acc = accumulators[key] = XDRAccumulator(args.agg)
                    acc.add_entry(entry)
                else:
                    out.write(json.dumps(to_jsonable(entry)) + "\n")
                count[0] += 1
                return args.limit is None or count[0] < args.limit

            bl = app.bucket_manager.bucket_list
            bl.visit_ledger_entries(accept, process,
                                    min_last_modified=min_ledger)
            if args.agg:
                for key, acc in sorted(accumulators.items(),
                                       key=lambda kv: str(kv[0])):
                    row = {}
                    if group_by is not None:
                        row.update(dict(zip(group_by.field_names(),
                                            key)))
                    row.update(acc.get_values())
                    out.write(json.dumps(row) + "\n")
        finally:
            if out is not sys.stdout:
                out.close()
        return 0
    finally:
        app.shutdown()


def cmd_report_last_history_checkpoint(args) -> int:
    """reference: reportLastHistoryCheckpoint
    (main/ApplicationUtils.cpp:752-800) — fetch and print the archive's
    current HAS."""
    from ..catchup import GetHistoryArchiveStateWork
    from ..util.timer import ClockMode, VirtualClock
    from ..work import State, run_work_to_completion
    from .application import Application
    cfg = _load_config(args)
    app = Application.create(VirtualClock(ClockMode.VIRTUAL_TIME), cfg,
                             new_db=False)
    try:
        archives = [a for a in app.history_manager.archives
                    if a.has_get()]
        if not archives:
            print("no readable history archives configured",
                  file=sys.stderr)
            return 1
        work = GetHistoryArchiveStateWork(app, archives[0])
        if run_work_to_completion(app, work) != State.WORK_SUCCESS:
            print("failed to fetch archive state", file=sys.stderr)
            return 1
        text = work.has.to_json()
        if args.output_file:
            with open(args.output_file, "w") as f:
                f.write(text)
        else:
            print(text)
        return 0
    finally:
        app.shutdown()


def cmd_verify_checkpoints(args) -> int:
    """reference: runWriteVerifiedCheckpointHashes
    (CommandLine.cpp:984-1050) — verify the archive's full hash chain
    and write trusted [ledger, hash] pairs for every checkpoint."""
    from ..catchup import GetHistoryArchiveStateWork
    from ..catchup.catchup_work import DownloadVerifyLedgerChainWork
    from ..history import CHECKPOINT_FREQUENCY, checkpoint_containing
    from ..util.timer import ClockMode, VirtualClock
    from ..work import State, run_work_to_completion
    from .application import Application
    import tempfile

    cfg = _load_config(args)
    app = Application.create(VirtualClock(ClockMode.VIRTUAL_TIME), cfg,
                             new_db=False)
    try:
        archives = [a for a in app.history_manager.archives
                    if a.has_get()]
        if not archives:
            print("no readable history archives configured",
                  file=sys.stderr)
            return 1
        archive = archives[0]
        has_work = GetHistoryArchiveStateWork(app, archive)
        if run_work_to_completion(app, has_work) != State.WORK_SUCCESS:
            print("failed to fetch archive state", file=sys.stderr)
            return 1
        tip = has_work.has.current_ledger
        first_cp = checkpoint_containing(1)
        cps = list(range(first_cp, checkpoint_containing(tip) + 1,
                         CHECKPOINT_FREQUENCY))
        tmp = tempfile.mkdtemp(prefix="verify-checkpoints-")
        try:
            chain = DownloadVerifyLedgerChainWork(app, archive, cps, tmp)
            ok = run_work_to_completion(
                app, chain, timeout_virtual=86400) == State.WORK_SUCCESS
        finally:
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)
        if not ok:
            print("ledger chain verification FAILED", file=sys.stderr)
            return 1
        # optional trusted anchor: both flags or neither
        if (args.trusted_hash is None) != (args.trusted_ledger is None):
            print("--trusted-ledger and --trusted-hash must be given "
                  "together", file=sys.stderr)
            return 1
        if args.trusted_hash is not None:
            anchor = chain.headers.get(args.trusted_ledger)
            if anchor is None or bytes(anchor.hash).hex() != \
                    args.trusted_hash.lower():
                print(f"trusted hash mismatch at ledger "
                      f"{args.trusted_ledger}", file=sys.stderr)
                return 1
        pairs = [[seq, bytes(chain.headers[seq].hash).hex()]
                 for seq in sorted(
                     (s for s in chain.headers if
                      (s + 1) % CHECKPOINT_FREQUENCY == 0 or s == tip),
                     reverse=True)]
        with open(args.output_file, "w") as f:
            json.dump(pairs, f, indent=1)
        print(f"verified {len(chain.headers)} headers; wrote "
              f"{len(pairs)} checkpoint hashes")
        return 0
    finally:
        app.shutdown()


def cmd_new_hist(args) -> int:
    """reference: initializeHistories →
    HistoryArchiveManager::initializeHistoryArchive
    (HistoryArchiveManager.cpp:200-240) — refuse if the archive already
    has a HAS, else put a fresh empty one."""
    import os as _os
    import tempfile
    from ..history.archive import HAS_PATH, HistoryArchiveState
    cfg = _load_config(args)
    from ..history.manager import HistoryManager

    class _A:  # minimal app facade for HistoryManager
        config = cfg
    archives = {a.name: a for a in HistoryManager(_A()).archives}
    for label in args.labels:
        archive = archives.get(label)
        if archive is None:
            print(f"unknown history archive '{label}'", file=sys.stderr)
            return 1
        if not archive.has_put():
            print(f"archive '{label}' has no put command",
                  file=sys.stderr)
            return 1
        # probe for existing state
        if archive.has_get():
            probe = tempfile.mktemp(prefix="has-probe-")
            if _os.system(archive.get_file_cmd(HAS_PATH, probe)) == 0 \
                    and _os.path.exists(probe):
                _os.unlink(probe)
                print(f"history archive '{label}' already initialized!",
                      file=sys.stderr)
                return 1
        from ..bucket.bucket_list import BucketList
        has = HistoryArchiveState.from_bucket_list(
            0, BucketList(), cfg.NETWORK_PASSPHRASE)
        local = tempfile.mktemp(prefix="has-init-")
        with open(local, "w") as f:
            f.write(has.to_json())
        rc = _os.system(archive.put_file_cmd(local, HAS_PATH))
        _os.unlink(local)
        if rc != 0:
            print(f"failed to initialize archive '{label}'",
                  file=sys.stderr)
            return 1
        print(f"initialized history archive '{label}'")
    return 0


def cmd_diag_bucket_stats(args) -> int:
    """reference: diagnostics::bucketStats (main/Diagnostics.cpp:16-100)
    — per-entry-type counts/bytes of one bucket file."""
    import io as _io
    from ..history.archive import read_gz
    from ..util.xdr_stream import read_record
    from ..xdr.ledger import BucketEntry, BucketEntryType

    if args.file.endswith(".gz"):
        data = read_gz(args.file)
    else:
        with open(args.file, "rb") as f:
            data = f.read()
    bio = _io.BytesIO(data)
    bucket_counts: dict = {}
    entry_counts: dict = {}
    entry_bytes: dict = {}
    per_account: dict = {}
    while True:
        rec = read_record(bio)
        if rec is None:
            break
        be = BucketEntry.from_bytes(rec)
        bucket_counts[be.disc.name] = bucket_counts.get(be.disc.name,
                                                        0) + 1
        if be.disc in (BucketEntryType.LIVEENTRY,
                       BucketEntryType.INITENTRY):
            le = be.value
            t = le.data.disc.name
            entry_counts[t] = entry_counts.get(t, 0) + 1
            entry_bytes[t] = entry_bytes.get(t, 0) + len(rec)
            if args.aggregate_account_stats:
                owner = None
                d = le.data
                if d.arm_name in ("account", "trustLine", "data"):
                    owner = bytes(d.value.accountID.value).hex()
                elif d.arm_name == "offer":
                    owner = bytes(d.value.sellerID.value).hex()
                if owner is not None:
                    pa = per_account.setdefault(owner,
                                                {"count": 0, "bytes": 0})
                    pa["count"] += 1
                    pa["bytes"] += len(rec)
    report = {"bucketEntries": bucket_counts,
              "ledgerEntriesCount": entry_counts,
              "ledgerEntriesSizeBytes": entry_bytes}
    if args.aggregate_account_stats:
        report["perAccount"] = per_account
    print(json.dumps(report, indent=2))
    return 0


def cmd_merge_bucketlist(args) -> int:
    """reference: mergeBucketList (main/ApplicationUtils.cpp:521-546) —
    merge the whole bucket list into one bucket file for diagnostics."""
    import os as _os
    from ..bucket.bucket import Bucket, merge_buckets
    from ..util.timer import ClockMode, VirtualClock
    from .application import Application
    cfg = _load_config(args)
    app = Application.create(VirtualClock(ClockMode.VIRTUAL_TIME), cfg,
                             new_db=False)
    try:
        if not app.ledger_manager.load_last_known_ledger():
            print("no last-known ledger in DB", file=sys.stderr)
            return 1
        bl = app.bucket_manager.bucket_list
        merged = Bucket.empty()
        buckets = []
        for lvl in bl.levels:
            lvl.commit()
            buckets.extend([lvl.curr, lvl.snap])
        # fold oldest -> newest so each newer bucket shadows the merged
        # older state; final fold drops tombstones (bottom-level merge)
        for b in reversed(buckets):
            merged = merge_buckets(merged, b)
        merged = merge_buckets(merged, Bucket.empty(), keep_dead=False)
        out = _os.path.join(args.output_dir,
                            f"bucket-{merged.hash.hex()}.xdr")
        merged.write_to(out)
        print(f"wrote merged bucket {out}")
        return 0
    finally:
        app.shutdown()


def cmd_rebuild_ledger_from_buckets(args) -> int:
    """reference: runRebuildLedgerFromBuckets (CommandLine.cpp:1541) —
    drop the SQL ledger-entry tables and repopulate them from the
    bucket list."""
    from ..ledger.ledger_txn import LedgerTxn
    from ..util.timer import ClockMode, VirtualClock
    from .application import Application
    cfg = _load_config(args)
    app = Application.create(VirtualClock(ClockMode.VIRTUAL_TIME), cfg,
                             new_db=False)
    try:
        lm = app.ledger_manager
        if not lm.load_last_known_ledger():
            print("no last-known ledger in DB", file=sys.stderr)
            return 1
        count = [0]
        with app.database.transaction():
            for t in app.database.entry_tables():
                app.database.execute(f"DELETE FROM {t}")
            with LedgerTxn(lm.root) as ltx:
                def process(entry) -> bool:
                    # work on a copy (create() would restamp
                    # lastModifiedLedgerSeq on the shared bucket object)
                    copy = entry.copy()
                    ltx.create(copy)
                    copy.lastModifiedLedgerSeq = \
                        entry.lastModifiedLedgerSeq
                    count[0] += 1
                    return True

                app.bucket_manager.bucket_list.visit_ledger_entries(
                    lambda e: True, process)
                ltx.commit()
        print(f"rebuilt {count[0]} ledger entries from buckets")
        return 0
    finally:
        app.shutdown()


def cmd_replay_debug_meta(args) -> int:
    """reference: runReplayDebugMeta (CommandLine.cpp:721-760) +
    catchup/ReplayDebugMetaWork — re-apply ledgers from the rotated
    debug-meta files under <meta-dir>/meta-debug."""
    import gzip
    import io as _io
    import os as _os
    from ..herder.tx_set import TxSetFrame
    from ..ledger.ledger_manager import LedgerCloseData
    from ..util.timer import ClockMode, VirtualClock
    from ..util.xdr_stream import read_record
    from ..xdr.ledger import LedgerCloseMeta
    from .application import Application

    cfg = _load_config(args)
    meta_dir = _os.path.join(args.meta_dir, "meta-debug")
    if not _os.path.isdir(meta_dir):
        print(f"no meta-debug dir under {args.meta_dir}",
              file=sys.stderr)
        return 1
    files = sorted(
        _os.path.join(meta_dir, f) for f in _os.listdir(meta_dir)
        if f.startswith("meta-debug-"))
    if not files:
        print("no debug meta files found", file=sys.stderr)
        return 1
    app = Application.create(VirtualClock(ClockMode.VIRTUAL_TIME), cfg,
                             new_db=False)
    try:
        lm = app.ledger_manager
        lm.meta_debug_dir = None  # don't write what we're reading
        if not lm.load_last_known_ledger():
            print("no last-known ledger in DB", file=sys.stderr)
            return 1
        applied = 0
        for path in files:
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rb") as f:
                while True:
                    try:
                        rec = read_record(f)
                    except OSError:
                        # a crash can truncate the tail record of the
                        # last segment; everything before it is intact
                        print("warning: truncated record at end of "
                              f"{path}", file=sys.stderr)
                        break
                    if rec is None:
                        break
                    meta = LedgerCloseMeta.from_bytes(rec)
                    v = meta.value
                    hdr = v.ledgerHeader.header
                    seq = hdr.ledgerSeq
                    lcl = lm.get_last_closed_ledger_num()
                    if seq <= lcl:
                        continue
                    if args.target_ledger and seq > args.target_ledger:
                        break
                    if seq != lcl + 1:
                        print(f"gap in debug meta: have LCL {lcl}, "
                              f"next record is ledger {seq}",
                              file=sys.stderr)
                        return 1
                    frame = TxSetFrame(v.txSet, cfg.network_id())
                    lm.close_ledger(LedgerCloseData(seq, frame,
                                                    hdr.scpValue))
                    if lm.get_last_closed_ledger_hash() != \
                            bytes(v.ledgerHeader.hash):
                        print(f"replay diverged at ledger {seq}",
                              file=sys.stderr)
                        return 1
                    applied += 1
        print(f"replayed {applied} ledgers from debug meta, LCL "
              f"{lm.get_last_closed_ledger_num()}")
        return 0
    finally:
        app.shutdown()


def cmd_upgrade_db(args) -> int:
    """reference: runUpgradeDB — apply pending schema upgrades."""
    import os as _os
    from ..db.database import create_database
    cfg = _load_config(args)
    if cfg.DATABASE.startswith("sqlite3://"):
        path = cfg.database_path()
        if path != ":memory:" and not _os.path.exists(path):
            print(f"database {path} does not exist", file=sys.stderr)
            return 1
    db = create_database(cfg)
    before = db.get_schema_version()
    db.upgrade_to_current_schema()
    after = db.get_schema_version()
    db.close()
    print(f"schema version {before} -> {after}")
    return 0


def cmd_gen_fuzz(args) -> int:
    """reference: runGenFuzz — write a random fuzzer input file."""
    import os as _os
    from .fuzzer import OverlayFuzzer, TransactionFuzzer
    seed = args.seed if args.seed is not None else \
        int.from_bytes(_os.urandom(4), "big")
    cls = TransactionFuzzer if args.mode == "tx" else OverlayFuzzer
    cls.gen_fuzz(args.file, seed)  # pure generation, no node needed
    print(f"wrote {args.mode} fuzz input (seed {seed}) to {args.file}")
    return 0


def cmd_fuzz(args) -> int:
    """reference: runFuzz (test/fuzz.cpp) — inject one input file into
    a prepared node; exit 0 = survived."""
    from .fuzzer import OverlayFuzzer, TransactionFuzzer
    fz = TransactionFuzzer() if args.mode == "tx" else OverlayFuzzer()
    try:
        interesting = fz.inject(args.file)
    finally:
        fz.shutdown()
    print("interesting input" if interesting
          else "uninteresting (malformed) input")
    return 0


def cmd_fuzz_coverage(args) -> int:
    """Coverage-guided loop (reference: the AFL harness of
    docs/fuzzing.md, with sys.monitoring instrumentation instead of
    afl-clang)."""
    from .fuzz_coverage import run_coverage_fuzz
    stats = run_coverage_fuzz(args.mode, runs=args.runs, seed=args.seed,
                              corpus_dir=args.corpus_dir,
                              time_budget=args.seconds)
    print(f"runs={stats.runs} interesting={stats.interesting} "
          f"corpus={stats.corpus_size} "
          f"locations={stats.total_locations} "
          f"crashes={len(stats.crashes)}")
    return 1 if stats.crashes else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="stellar-core-tpu")
    p.add_argument("--conf", help="config file (TOML)", default=None)
    p.add_argument("--ll", help="log level", default="info")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("version").set_defaults(fn=cmd_version)
    sub.add_parser("gen-seed").set_defaults(fn=cmd_gen_seed)
    sub.add_parser("sec-to-pub").set_defaults(fn=cmd_sec_to_pub)
    cid = sub.add_parser("convert-id")
    cid.add_argument("id")
    cid.set_defaults(fn=cmd_convert_id)
    sub.add_parser("new-db").set_defaults(fn=cmd_new_db)
    run = sub.add_parser("run")
    run.add_argument("--new-db", action="store_true")
    run.add_argument("--port-file", default=None,
                     help="write the bound admin HTTP port here "
                          "(useful with HTTP_PORT=0)")
    run.set_defaults(fn=cmd_run)
    http = sub.add_parser("http-command")
    http.add_argument("command")
    http.set_defaults(fn=cmd_http_command)
    cu = sub.add_parser("catchup")
    cu.add_argument("destination", help="<ledger>/<count> or 'current'")
    cu.add_argument("--new-db", action="store_true")
    cu.set_defaults(fn=cmd_catchup)
    sub.add_parser("publish").set_defaults(fn=cmd_publish)
    sub.add_parser("self-check").set_defaults(fn=cmd_self_check)
    pxdr = sub.add_parser("print-xdr")
    pxdr.add_argument("file")
    pxdr.add_argument("--filetype", default="TransactionEnvelope")
    pxdr.add_argument("--base64", action="store_true")
    pxdr.set_defaults(fn=cmd_print_xdr)
    ea = sub.add_parser("encode-asset")
    ea.add_argument("--code", default="")
    ea.add_argument("--issuer", default="")
    ea.set_defaults(fn=cmd_encode_asset)
    st = sub.add_parser("sign-transaction")
    st.add_argument("file")
    st.add_argument("--netid", required=True)
    st.add_argument("--base64", action="store_true")
    st.add_argument("--seed", default=None,
                    help="secret seed (read from stdin if omitted)")
    st.set_defaults(fn=cmd_sign_transaction)
    sub.add_parser("offline-info").set_defaults(fn=cmd_offline_info)
    dl = sub.add_parser("dump-ledger")
    dl.add_argument("--output-file", default=None)
    dl.add_argument("--filter-query", default=None)
    dl.add_argument("--last-modified-ledger-count", type=int, default=None)
    dl.add_argument("--limit", type=int, default=None)
    dl.add_argument("--group-by", default=None)
    dl.add_argument("--agg", default=None)
    dl.set_defaults(fn=cmd_dump_ledger)
    rl = sub.add_parser("report-last-history-checkpoint")
    rl.add_argument("--output-file", default=None)
    rl.set_defaults(fn=cmd_report_last_history_checkpoint)
    vc = sub.add_parser("verify-checkpoints")
    vc.add_argument("--output-file", required=True)
    vc.add_argument("--trusted-ledger", type=int, default=None)
    vc.add_argument("--trusted-hash", default=None)
    vc.set_defaults(fn=cmd_verify_checkpoints)
    nh = sub.add_parser("new-hist")
    nh.add_argument("labels", nargs="+")
    nh.set_defaults(fn=cmd_new_hist)
    dbs = sub.add_parser("diag-bucket-stats")
    dbs.add_argument("file")
    dbs.add_argument("--aggregate-account-stats", action="store_true")
    dbs.set_defaults(fn=cmd_diag_bucket_stats)
    mb = sub.add_parser("merge-bucketlist")
    mb.add_argument("--output-dir", default=".")
    mb.set_defaults(fn=cmd_merge_bucketlist)
    sub.add_parser("rebuild-ledger-from-buckets").set_defaults(
        fn=cmd_rebuild_ledger_from_buckets)
    rdm = sub.add_parser("replay-debug-meta")
    rdm.add_argument("--meta-dir", required=True,
                     help="directory containing meta-debug/")
    rdm.add_argument("--target-ledger", type=int, default=0)
    rdm.set_defaults(fn=cmd_replay_debug_meta)
    sub.add_parser("upgrade-db").set_defaults(fn=cmd_upgrade_db)
    gf = sub.add_parser("gen-fuzz")
    gf.add_argument("file")
    gf.add_argument("--mode", choices=["tx", "overlay"], default="tx")
    gf.add_argument("--seed", type=int, default=None)
    gf.set_defaults(fn=cmd_gen_fuzz)
    fz = sub.add_parser("fuzz")
    fz.add_argument("file")
    fz.add_argument("--mode", choices=["tx", "overlay"], default="tx")
    fz.set_defaults(fn=cmd_fuzz)
    cf = sub.add_parser("fuzz-coverage")
    cf.add_argument("--mode", choices=["tx", "overlay"], default="tx")
    cf.add_argument("--runs", type=int, default=500)
    cf.add_argument("--seconds", type=float, default=None)
    cf.add_argument("--seed", type=int, default=1)
    cf.add_argument("--corpus-dir", default="fuzz-corpus")
    cf.set_defaults(fn=cmd_fuzz_coverage)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    from ..util.logging import init_logging
    args = build_parser().parse_args(argv)
    init_logging(args.ll)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
