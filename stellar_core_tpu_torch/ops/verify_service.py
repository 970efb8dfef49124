"""Coalescing verification service: deadline micro-batching for the
live signature hot path.

The device batch verifier (ops/verifier.py) engages at the txset
validation and catchup-replay collection points, but the LIVE node
verifies flood-time tx admissions, SCP envelopes and StellarValue
signatures one at a time through PubKeyUtils.verify_sig. This module is
the dynamic-batching front-end that feeds the batch accelerator from
that stream of small independent requests — the Clipper / ORCA shape
from inference serving (PAPERS.md): deadline-bounded request coalescing
keeps device occupancy up without wrecking tail latency.

Mechanics: callers ``submit()`` (pub, sig, msg) tuples and get futures;
the pending queue drains into ONE ``verify_tuples_async`` dispatch when
the first of three triggers fires —

  - **batch_full** — pending count reached ``max_batch``;
  - **deadline**  — ``deadline_ms`` elapsed since the first pending
    submit (a VirtualTimer on the node clock, so virtual-time tests
    stay deterministic);
  - **demand**    — a caller blocked on ``result()`` of a pending
    future (the synchronous integration points: verify_envelope,
    verify_stellar_value_signature, batched flood admission).

Dispatch is double-buffered: a flush hands its tuples to the verifier's
async handle and returns immediately, so host prep + transfer of batch
i+1 overlaps device compute of batch i; collection happens when a
future is awaited (or at the deadline sweep).

Semantics contract — results are bit-identical to the sync path:

  - the device kernel's accept/reject is differentially pinned to the
    ed25519_ref oracle (tests/test_torch_verifier.py,
    tests/test_torch_gpu.py), and the service's parity suite pins it
    to the JAX package's service (tests/test_torch_verify_service.py);
  - ``submit`` probes a SERVICE-LOCAL result cache (same key
    derivation and capacity as the process-wide verify cache) and
    every batch result is written through BOTH caches, so flood-time
    verifies make close-time re-verification free. In a real
    deployment (one node per process) the local cache behaves exactly
    like probing the global one; in multi-node in-process simulations
    it keeps each node's coalescing honest — the global cache is
    shared across nodes there, and probing it would let one node's
    sync verifies short-circuit every other node's batches;
  - flushes below the verifier's device cutoff run the native
    per-signature path (VERIFY_DEVICE_MIN_BATCH, ops/verifier.py);
  - any device failure — at dispatch or at collection — falls back to
    native per-signature verify for that flush (the chaos contract;
    seam: ``ops.verify_service.flush``).

Observability: ``crypto.verify_service.occupancy`` histogram (tuples
per flush), ``crypto.verify_service.queue-wait`` timer (submit →
dispatch), ``crypto.verify_service.flush.<reason>`` counters,
``crypto.verify_service.fallback`` counter, and a
``crypto.verifyService.flush`` perf zone (batch/reason span args) that
rides the flight recorder like every other zone.

Threading: the node is single-logical-threaded (VirtualClock crank
loop); the internal lock only guards against admin-thread probes and
keeps the pending/inflight structures consistent if a future is
resolved from a different thread. Device collection happens outside
the lock.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

from ..crypto.keys import (VERIFY_CACHE_SIZE, PublicKey,
                           seed_verify_cache_by_key, verify_cache_key,
                           verify_sig_uncached)
from ..util import chaos, tracing
from ..util.cache import RandomEvictionCache
from ..util.logging import get_logger

log = get_logger("Herder")

# flush triggers (metric suffixes: crypto.verify_service.flush.<reason>)
FLUSH_REASONS = ("batch_full", "deadline", "demand", "drain")

DEFAULT_MAX_BATCH = 256
DEFAULT_DEADLINE_MS = 2.0


class VerifyFuture:
    """Handle for one submitted (pub, sig, msg) verify. ``result()``
    blocks (forcing a demand flush + collection if needed) and returns
    the bool; ``done()`` is a non-blocking probe."""

    __slots__ = ("_service", "_flush", "_value")

    def __init__(self, service: Optional["VerifyService"] = None):
        self._service = service
        self._flush: Optional["_Flush"] = None   # set at dispatch
        self._value: Optional[bool] = None

    def done(self) -> bool:
        return self._value is not None

    def result(self) -> bool:
        if self._value is None:
            self._service._resolve(self)
        return self._value


class _Flush:
    """One dispatched batch: the verifier's collect handle plus the
    tuples/keys/futures it will resolve. ``collect`` is None when the
    dispatch itself failed — the batch resolves through the native
    fallback at collection time (outside the service lock)."""

    __slots__ = ("collect", "tuples", "keys", "futures")

    def __init__(self, collect, tuples, keys, futures):
        self.collect = collect
        self.tuples = tuples
        self.keys = keys
        self.futures = futures


class VerifyService:
    def __init__(self, verifier, clock=None, metrics=None, perf=None,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 deadline_ms: float = DEFAULT_DEADLINE_MS):
        self._verifier = verifier
        self._clock = clock
        self._max_batch = max(1, int(max_batch))
        self._deadline_s = max(0.0, float(deadline_ms)) / 1000.0
        if perf is None:
            from ..util.perf import default_registry
            perf = default_registry
        self.perf = perf
        if metrics is None:
            from ..util.metrics import MetricsRegistry
            metrics = MetricsRegistry()
        self._occupancy = metrics.histogram(
            "crypto", "verify_service", "occupancy")
        self._queue_wait = metrics.timer(
            "crypto", "verify_service", "queue-wait")
        self._submitted = metrics.meter(
            "crypto", "verify_service", "submitted")
        self._fallbacks = metrics.counter(
            "crypto", "verify_service", "fallback")
        self._reasons = {
            r: metrics.counter("crypto", "verify_service", "flush", r)
            for r in FLUSH_REASONS}
        self._lock = threading.Lock()
        self._pending_tuples: List[Tuple[bytes, bytes, bytes]] = []
        self._pending_keys: List[bytes] = []
        self._pending_futures: List[VerifyFuture] = []
        self._pending_times: List[float] = []
        self._inflight: deque = deque()
        self._timer = None
        self._timer_armed = False
        self._abandoned = False
        # node-local view of the verify cache (see module docstring)
        self._local_cache: RandomEvictionCache = RandomEvictionCache(
            VERIFY_CACHE_SIZE)

    # ------------------------------------------------------------ submit --
    def submit(self, pub, sig: bytes, msg: bytes,
               use_cache: bool = True) -> VerifyFuture:
        """Queue one verify; returns a future. Malformed keys/signatures
        resolve False immediately (mirroring verify_sig); cache hits
        resolve without queueing."""
        raw = pub.raw if isinstance(pub, PublicKey) else bytes(pub)
        sig = bytes(sig)
        msg = bytes(msg)
        fut = VerifyFuture(self)
        if len(raw) != 32 or len(sig) != 64:
            fut._value = False
            return fut
        key = verify_cache_key(raw, sig, msg)
        if use_cache:
            hit = self._local_cache.maybe_get(key)
            if hit is not None:
                fut._value = hit
                return fut
        self._submitted.mark()
        with self._lock:
            if self._abandoned:
                # the node is dead: resolve immediately (False, no
                # cache seed) rather than queue work nobody will flush
                fut._value = False
                return fut
            self._pending_tuples.append((raw, sig, msg))
            self._pending_keys.append(key)
            self._pending_futures.append(fut)
            self._pending_times.append(time.perf_counter())
            if len(self._pending_tuples) >= self._max_batch:
                self._flush_locked("batch_full")
            else:
                self._arm_timer_locked()
        return fut

    def submit_many(self, items: Sequence[Tuple[bytes, bytes, bytes]]
                    ) -> List[VerifyFuture]:
        """Queue a burst. Crossing ``max_batch`` dispatches mid-loop, so
        a large burst pipelines: while the caller awaits (or keeps
        submitting) chunk i+1, chunk i is already on the device."""
        return [self.submit(p, s, m) for p, s, m in items]

    def verify(self, pub, sig: bytes, msg: bytes) -> bool:
        """Synchronous verify through the service: coalesces with
        whatever else is pending, then demand-flushes."""
        return self.submit(pub, sig, msg).result()

    # -------------------------------------------------------------- knobs --
    def set_knobs(self, max_batch: Optional[int] = None,
                  deadline_ms: Optional[float] = None) -> None:
        """Live re-tune from the adaptive controller
        (ops/controller.py). Mutable-safe: swapped under the service
        lock, so a concurrent submit sees either the old or the new
        value, never a torn pair. Shrinking ``max_batch`` below the
        current backlog dispatches it immediately — the tighter knob
        takes effect now, not one batch later. A shortened deadline
        applies from the next arm (the in-flight timer keeps the
        deadline the batch was promised)."""
        with self._lock:
            if max_batch is not None:
                self._max_batch = max(1, int(max_batch))
            if deadline_ms is not None:
                self._deadline_s = max(0.0, float(deadline_ms)) / 1000.0
            if len(self._pending_tuples) >= self._max_batch:
                self._flush_locked("batch_full")

    def knobs(self) -> dict:
        with self._lock:
            return {"max_batch": self._max_batch,
                    "deadline_ms": round(self._deadline_s * 1000, 4)}

    # ------------------------------------------------------------- flush --
    def flush(self, reason: str = "drain") -> None:
        with self._lock:
            self._flush_locked(reason)

    def _arm_timer_locked(self) -> None:
        if self._clock is None or self._timer_armed or self._abandoned:
            return
        from ..util.timer import VirtualTimer
        if self._timer is None:
            self._timer = VirtualTimer(self._clock)
        self._timer.expires_from_now(self._deadline_s)
        self._timer.async_wait(self._on_deadline)
        self._timer_armed = True

    def _on_deadline(self) -> None:
        with self._lock:
            self._timer_armed = False
            if self._abandoned:
                return
            self._flush_locked("deadline")
        # nobody is awaiting these futures (sync callers demand-flush),
        # so collect here: results resolve and write through the cache
        self._collect_all()

    def _flush_locked(self, reason: str) -> None:
        """Dispatch everything pending as one batch. Lock held; device
        collection does NOT happen here (double-buffering: the handle is
        queued on ``_inflight`` and collected when awaited)."""
        tuples = self._pending_tuples
        keys = self._pending_keys
        futures = self._pending_futures
        times = self._pending_times
        if not tuples:
            return
        self._pending_tuples = []
        self._pending_keys = []
        self._pending_futures = []
        self._pending_times = []
        if self._timer_armed:
            self._timer.cancel()
            self._timer_armed = False
        n = len(tuples)
        self._occupancy.update(n)
        self._reasons.get(reason, self._reasons["drain"]).inc()
        now = time.perf_counter()
        for t0 in times:
            self._queue_wait.update(now - t0)
        targs = None
        if tracing.ENABLED:
            targs = {"batch": n, "reason": reason}
        collect = None
        try:
            with self.perf.zone("crypto.verifyService.flush",
                                targs=targs):
                try:
                    if chaos.ENABLED:
                        # service fault seam (the chaos contract): an
                        # injected io_error raises before any dispatch
                        # — this flush falls back to native verify
                        chaos.point("ops.verify_service.flush", n=n,
                                    reason=reason)
                    collect = self._verifier.verify_tuples_async(tuples)
                except Exception:
                    # don't run the native fallback here: _flush_locked
                    # is called with the lock held, and a max_batch
                    # fallback is real work — mark the flush failed
                    # (collect=None) and resolve it at collection time,
                    # outside the lock
                    log.debug("verify service: dispatch failed "
                              "(batch=%d)", n, exc_info=True)
                    collect = None
        finally:
            # register the flush even when a SimulatedCrash
            # (BaseException) unwinds out of the chaos seam: the
            # futures must stay reachable so abandon() on the crash
            # path resolves them — a future must never be left unset
            fl = _Flush(collect, tuples, keys, futures)
            for f in futures:
                f._flush = fl
            self._inflight.append(fl)

    # ----------------------------------------------------------- collect --
    def _resolve(self, fut: VerifyFuture) -> None:
        """Block until `fut` has a value: demand-flush if it is still
        pending, then collect inflight batches in dispatch order (older
        batches finished first on the device anyway)."""
        with self._lock:
            if fut._value is None and fut._flush is None:
                self._flush_locked("demand")
        while fut._value is None:
            with self._lock:
                fl = self._inflight.popleft() if self._inflight else None
            if fl is None:
                if fut._value is None:   # pragma: no cover — invariant
                    raise RuntimeError("verify future lost its batch")
                return
            self._collect(fl)

    def _collect(self, fl: _Flush) -> None:
        if fl.collect is None:             # dispatch already failed
            self._fallback_resolve(fl)
            return
        try:
            results = fl.collect()
        except Exception:
            self._fallback_resolve(fl)
            return
        self._resolve_results(fl, results)

    def _resolve_results(self, fl: _Flush, results) -> None:
        """Resolve futures + write-through: the process-wide cache (so
        close-time verify_sig hits) AND the node-local one (so repeat
        submits resolve without queueing). Keys were derived once at
        submit."""
        for key, f, ok in zip(fl.keys, fl.futures, results):
            ok = bool(ok)
            f._value = ok
            f._flush = None
            seed_verify_cache_by_key(key, ok)
            self._local_cache.put(key, ok)

    def _collect_all(self) -> None:
        while True:
            with self._lock:
                fl = self._inflight.popleft() if self._inflight else None
            if fl is None:
                return
            self._collect(fl)

    def _fallback_resolve(self, fl: _Flush) -> None:
        """Device failure: resolve this batch through the native
        per-signature path — identical accept/reject, the chaos
        convergence scenario's contract. Runs outside the service lock
        (real per-signature work). A persistently-failing device (the
        chaos soak's always-on fault) logs once at warning, then debug
        — the fallback counter carries the tally."""
        self._fallbacks.inc()
        level = log.warning if self._fallbacks.count == 1 else log.debug
        level("verify service: device flush failed; falling back "
              "to native per-signature verify (batch=%d)",
              len(fl.tuples))
        self._resolve_results(
            fl, [verify_sig_uncached(p, s, m) for p, s, m in fl.tuples])

    # ---------------------------------------------------------- lifecycle --
    def drain(self) -> None:
        """Flush + collect everything (graceful shutdown, tests)."""
        self.flush("drain")
        self._collect_all()

    def abandon(self) -> None:
        """Hard stop: cancel the deadline timer and resolve EVERY
        pending and in-flight future to False — without touching the
        device or the caches (abandoned ≠ invalid; nothing is seeded).
        A crashed node loses in-flight verifies exactly like a real
        kill, but a caller blocked on ``result()`` from another thread
        must unblock rather than hang forever (Herder.shutdown routes
        here, including on the chaos crash path)."""
        with self._lock:
            self._abandoned = True
            if self._timer_armed:
                self._timer.cancel()
                self._timer_armed = False
            orphans = list(self._pending_futures)
            self._pending_tuples = []
            self._pending_keys = []
            self._pending_futures = []
            self._pending_times = []
            inflight, self._inflight = list(self._inflight), deque()
            for fl in inflight:
                orphans.extend(fl.futures)
            # resolve while STILL holding the lock: a result() caller
            # blocked on the lock must wake to a resolved future — if
            # it won the race instead, it would pop from the emptied
            # _inflight and die on the lost-its-batch invariant
            for f in orphans:
                if f._value is None:
                    f._value = False
                    f._flush = None

    # -------------------------------------------------------------- stats --
    def queue_depth(self) -> dict:
        """Live backlog snapshot for the telemetry sampler (Clipper's
        queue-occupancy signal, read per sample): tuples awaiting
        dispatch and tuples dispatched-but-uncollected."""
        with self._lock:
            return {"pending": len(self._pending_tuples),
                    "inflight": sum(len(fl.tuples)
                                    for fl in self._inflight)}

    def stats(self) -> dict:
        """Service counters for self-check / bench artifacts."""
        occ = self._occupancy.to_json()
        qw = self._queue_wait.to_json()
        return {
            "submitted": self._submitted.count,
            "flushes": occ["count"],
            "occupancy_mean": round(occ["mean"], 3),
            "occupancy_p50": occ["median"],
            "occupancy_p99": occ["99%"],
            "queue_wait_p50_ms": round(qw["median"] * 1000, 3),
            "queue_wait_p99_ms": round(qw["99%"] * 1000, 3),
            "flush_reasons": {r: c.count
                              for r, c in self._reasons.items()},
            "fallbacks": self._fallbacks.count,
        }
