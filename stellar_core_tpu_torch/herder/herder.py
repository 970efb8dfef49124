"""Herder — drives ledger close from transaction submission.

Reference: src/herder/HerderImpl.{h,cpp}. Counterpart of
stellar_core_tpu/herder/herder.py; so far the port has only the piece
txset validation runs on, `_LazyBatchPrevalidator` (one device batch per
txset). `Herder` itself, with flood admission over the ported
VerifyService, comes in a later slice (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from ..util.logging import get_logger

log = get_logger("Herder")


class _LazyBatchPrevalidator:
    """Per-txset lazy device batch: dispatches the batch verify the first
    time a signature is actually checked, then serves per-signature
    lookups; misses fall back to the sync path (exact semantics)."""

    def __init__(self, batch_verifier, applicable, fallback):
        from ..tx.signature_checker import default_verify
        self._batch_verifier = batch_verifier
        self._applicable = applicable
        self._fallback = fallback or default_verify
        self._pv = None

    def __call__(self, pub: bytes, sig: bytes, msg: bytes) -> bool:
        if self._pv is None:
            from ..crypto.keys import probe_verify_cache, seed_verify_cache
            from ..tx.signature_checker import (PrevalidatedVerifier,
                                                collect_signature_tuples)
            pv = PrevalidatedVerifier(fallback=self._fallback)
            # envelope signatures only: check_valid never verifies auth
            # entries (those are consumed by catchup's apply-time batch)
            tuples = collect_signature_tuples(self._applicable.txs)
            # the verify cache already holds every signature this node
            # admitted through the live path (flood admission / HTTP
            # submit write through it), so only the cache MISSES ride
            # the device batch — a fully-admitted txset dispatches
            # nothing
            cached, missing = [], []
            for t in tuples:
                hit = probe_verify_cache(*t)
                (missing if hit is None else cached).append(
                    (t, hit))
            if cached:
                pv.add_results([t for t, _ in cached],
                               [ok for _, ok in cached])
            if missing:
                miss_tuples = [t for t, _ in missing]
                try:
                    results = self._batch_verifier.verify_tuples(
                        miss_tuples)
                    pv.add_results(miss_tuples, results)
                    # write-through: apply-time re-verification of the
                    # externalized set hits the cache instead of
                    # re-verifying natively
                    for (p, s, m), ok in zip(miss_tuples, results):
                        seed_verify_cache(p, s, m, ok)
                except Exception:
                    # device verifier down: accept/reject semantics are
                    # identical on the native path, so validation
                    # continues per-signature through the fallback
                    log.warning("batch verifier failed; falling back to "
                                "native per-signature verify",
                                exc_info=True)
            self._pv = pv
            self._applicable = None   # drop the reference once consumed
        return self._pv(pub, sig, msg)
