"""Node self-check.

Reference: main/ApplicationUtils.cpp selfCheck (:487-517) — four phases:
(1) history archive reachability / HAS sanity, (2) bucket↔database
consistency, (3) ledger-header chain integrity in the local DB,
(4) crypto benchmark (SecretKey::benchmarkOpsPerSecond — the hook where
the TPU backend's verifies/sec gets compared to CPU).
"""

from __future__ import annotations

import time
from typing import List, Tuple

from ..crypto.keys import PubKeyUtils, SecretKey
from ..ledger.ledger_manager import ledger_header_hash
from ..util.logging import get_logger
from ..xdr.ledger import LedgerHeader

log = get_logger("default")


def self_check(app, crypto_bench_seconds: float = 0.2,
               max_headers: int = 0) -> Tuple[bool, dict]:
    """max_headers > 0 bounds the header-chain scan to the most recent N
    rows — used by the AUTOMATIC_SELF_CHECK_PERIOD timer so a periodic
    check cannot stall the single-threaded crank loop for an unbounded
    full-table rehash."""
    report = {}
    ok = True

    # 1. history archives configured + writable state
    archives = app.history_manager.archives
    report["archives"] = {
        "configured": len(archives),
        "writable": sum(1 for a in archives if a.has_put()),
    }

    # 2. bucket list hash matches the LCL header
    lcl = app.ledger_manager.get_last_closed_ledger_header()
    bl_hash = app.bucket_manager.snapshot_ledger_hash(lcl.ledgerVersion)
    bucket_ok = bytes(lcl.bucketListHash) == bl_hash
    report["bucket_list_consistent"] = bucket_ok
    ok = ok and bucket_ok

    # 3. header chain in the DB
    if max_headers > 0:
        rows = app.database.query_all(
            "SELECT ledgerseq, ledgerhash, prevhash, data FROM ("
            "SELECT * FROM ledgerheaders ORDER BY ledgerseq DESC LIMIT ?)"
            " ORDER BY ledgerseq", (max_headers,))
    else:
        rows = app.database.query_all(
            "SELECT ledgerseq, ledgerhash, prevhash, data FROM "
            "ledgerheaders ORDER BY ledgerseq")
    chain_ok = True
    prev_hash = None
    prev_seq = None
    for seq, lhash, phash, data in rows:
        header = LedgerHeader.from_bytes(bytes(data))
        if ledger_header_hash(header) != bytes(lhash):
            chain_ok = False
            break
        if prev_seq is not None and seq == prev_seq + 1 and \
                bytes(phash) != prev_hash:
            chain_ok = False
            break
        prev_hash, prev_seq = bytes(lhash), seq
    report["header_chain_ok"] = chain_ok
    report["headers_checked"] = len(rows)
    ok = ok and chain_ok

    # 4. crypto benchmark (reference: benchmarkOpsPerSecond)
    sk = SecretKey.from_seed(b"\x42" * 32)
    msg = b"self-check benchmark message...."
    sig = sk.sign(msg)
    pub = sk.public_key().raw
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < crypto_bench_seconds:
        PubKeyUtils.verify_sig(pub, sig, msg)
        n += 1
    elapsed = time.perf_counter() - t0
    report["verify_per_second_cpu"] = int(n / elapsed)

    # 5. device batch-backend benchmark when configured (BASELINE.md
    # procedure: self-check reports verifies/sec for BOTH backends;
    # the report keeps the reference's key names)
    if getattr(app.config, "SIGNATURE_VERIFY_BACKEND", "") in ("cuda",
                                                               "tpu"):
        try:
            import numpy as np
            from ..ops.verifier import CudaBatchVerifier
            nb = 1024
            pubs = np.broadcast_to(
                np.frombuffer(pub, dtype=np.uint8), (nb, 32)).copy()
            sigs = np.broadcast_to(
                np.frombuffer(sig, dtype=np.uint8), (nb, 64)).copy()
            msgs = [msg] * nb
            v = CudaBatchVerifier(perf=getattr(app, "perf", None))
            res = v.verify_batch(pubs, sigs, msgs)   # compile + warm
            if not res.all():
                ok = False
                report["tpu_backend_ok"] = False
            else:
                t0 = time.perf_counter()
                v.verify_batch(pubs, sigs, msgs)
                report["verify_per_second_tpu_batch"] = int(
                    nb / (time.perf_counter() - t0))
                report["tpu_backend_ok"] = True
        except Exception as e:           # noqa: BLE001 — report, not crash
            report["tpu_backend_ok"] = False
            report["tpu_backend_error"] = str(e)
            ok = False

    # 6. coalescing verify service warmup: push a small batch
    # of fresh signatures through submit → flush → collect so the
    # service's dispatch path is exercised (and warm) before live
    # traffic needs it, and report its occupancy/queue-wait stats
    svc = getattr(app, "verify_service", None)
    if svc is not None:
        try:
            # size the batch to the device cutoff: a smaller batch
            # would take the native bypass and leave the service's
            # device bucket cold for the first live flush
            n_warm = max(4, getattr(app.batch_verifier,
                                    "_device_min_batch", 4))
            items = []
            for i in range(n_warm):
                # 32-byte messages: the tx-hash hot path (msg32
                # kernel) is what live flood flushes will hit
                m = (b"self-check vs %04d" % i).ljust(32, b".")
                items.append((pub, sk.sign(m), m))
            futs = svc.submit_many(items)
            svc_ok = all(f.result() for f in futs)
            report["verify_service_ok"] = svc_ok
            report["verify_service"] = svc.stats()
            ok = ok and svc_ok
        except Exception as e:           # noqa: BLE001 — report, not crash
            report["verify_service_ok"] = False
            report["verify_service_error"] = str(e)
            ok = False

    # 7. backend supervisor state (ops/backend_supervisor.py): degraded
    # mode (OPEN/HALF_OPEN) is an operational fact, not a check
    # failure — the whole point is that the node keeps validating —
    # but it must be visible in the report the operator reads
    bv = getattr(app, "batch_verifier", None)
    if bv is not None and hasattr(bv, "breaker_state"):
        report["verify_backend"] = bv.status()
        report["verify_backend_degraded"] = bv.state != "CLOSED"

    report["ok"] = ok
    return ok, report
