"""QueryService — the bounded, deadline-aware read-serving pool.

Serving discipline is Tail-at-Scale (Dean & Barroso, CACM 2013) over
the Clipper bounded-admission shape the verify service already uses
(ops/verify_service.py):

- **bounded admission queue**: a read admitted past the queue limit
  would only wait, so it is shed at the door (``query.shed.queue-full``)
  — and the adaptive controller sheds reads BEFORE writes via
  ``roll_read_shed`` (``query.shed.controller``), keeping ledger close
  inside its SLO while the read tier degrades first;
- **per-request deadline**: a read that cannot answer inside its
  budget resolves as a timeout instead of occupying a worker
  (``query.read.deadline-timeout``);
- **hedged second lookup**: when the primary lookup has not answered
  within the rolling p95 latency estimate, the same work is enqueued
  once more and the first completion wins (``query.hedge.*``) — the
  canonical tied-request tail cut.

Workers are real threads in their own analyzer-declared domain
(``query-worker``), spawned lazily on first use so idle nodes and
tests pay nothing.  Every lookup is answered against exactly one
refcounted :class:`~stellar_core_tpu_torch.query.snapshot.LedgerSnapshot`.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from ..util import threads
from ..util.logging import get_logger
from ..xdr.ledger_entries import LedgerKey
from ..xdr.types import PublicKey

log = get_logger("Query")

__all__ = ["QueryService"]


class _ReadFuture:
    """First-resolve-wins completion cell (primary vs hedge race)."""

    __slots__ = ("_event", "_lock", "_result")

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result = None

    def settle(self, result: dict) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._result = result
            self._event.set()
            return True

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float) -> bool:
        return self._event.wait(timeout)

    def result(self) -> Optional[dict]:
        return self._result


class _Request:
    __slots__ = ("kind", "payload", "deadline", "snapshot", "future",
                 "is_hedge", "t_submit")

    def __init__(self, kind: str, payload, deadline: float, snapshot,
                 future: _ReadFuture, is_hedge: bool = False):
        self.kind = kind
        self.payload = payload
        self.deadline = deadline
        self.snapshot = snapshot
        self.future = future
        self.is_hedge = is_hedge
        self.t_submit = time.monotonic()

    def as_hedge(self) -> "_Request":
        return _Request(self.kind, self.payload, self.deadline,
                       self.snapshot, self.future, is_hedge=True)


class QueryService:
    """Snapshot-consistent account / tx-status read pool."""

    def __init__(self, app, snapshots, tx_status, metrics, config):
        self._app = app
        self._snapshots = snapshots
        self._tx_status = tx_status
        self._metrics = metrics
        self.workers = max(1, int(config.QUERY_WORKER_THREADS))
        self.queue_limit = max(1, int(config.QUERY_QUEUE_LIMIT))
        self.deadline_ms = float(config.QUERY_DEADLINE_MS)
        self.hedge_min_ms = float(config.QUERY_HEDGE_MIN_MS)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[_Request] = []
        self._threads: List[threading.Thread] = []
        self._stopped = False
        # rolling latency window feeding the hedge trigger: p95 of the
        # last 256 reads, recomputed every 16 completions (query-worker
        # is the only writer after __init__)
        self._recent_ms: List[float] = []
        self._p95_ms = 0.0
        self._since_p95 = 0

        self.read_timer = metrics.timer("query", "read", "latency")
        self.account_meter = metrics.meter("query", "read", "account")
        self.txstatus_meter = metrics.meter("query", "read", "txstatus")
        self.shed_counters = {
            k: metrics.counter("query", "shed", k)
            for k in ("controller", "queue-full")}
        self.timeout_counter = metrics.counter(
            "query", "read", "deadline-timeout")
        self.hedge_counters = {
            k: metrics.counter("query", "hedge", k)
            for k in ("issued", "won", "wasted")}
        self.depth_hist = metrics.histogram("query", "queue", "depth")

    # ------------------------------------------------------------- public --
    def query_account(self, account_id: bytes,
                      deadline_ms: Optional[float] = None,
                      snapshot=None) -> dict:
        """One account read: ``account_id`` is the raw 32-byte ed25519
        key.  Answers against the newest snapshot (or the given pinned
        one — the consistency checker's re-read path)."""
        self.account_meter.mark()
        return self._run("account", account_id, deadline_ms, snapshot)

    def query_accounts(self, account_ids, deadline_ms: Optional[float] = None,
                       snapshot=None) -> dict:
        """Batched account reads — one admission, one snapshot, one
        deadline for the whole batch (the Clipper batching lever: the
        queue/wakeup overhead amortizes across the batch while every
        lookup still answers from the same ledger seq)."""
        ids = list(account_ids)
        self.account_meter.mark(len(ids))
        return self._run("account_batch", ids, deadline_ms, snapshot)

    def query_tx_status(self, tx_hash: bytes,
                        deadline_ms: Optional[float] = None) -> dict:
        self.txstatus_meter.mark()
        return self._run("txstatus", bytes(tx_hash), deadline_ms, None)

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def stats(self) -> dict:
        with self._lock:
            depth = len(self._queue)
            workers = len(self._threads)
        return {
            "queue": depth,
            "workers": workers,
            "reads": self.read_timer.count,
            "p95_estimate_ms": round(self._p95_ms, 3),
            "shed": {k: c.count for k, c in self.shed_counters.items()},
            "timeouts": self.timeout_counter.count,
            "hedge": {k: c.count for k, c in self.hedge_counters.items()},
        }

    def reset_stats(self) -> None:
        """clearmetrics hook: forget the learned latency window (the
        metric objects themselves are reset by the registry)."""
        with self._lock:
            self._recent_ms = []
            self._p95_ms = 0.0
            self._since_p95 = 0

    def shutdown(self) -> None:
        with self._lock:
            self._stopped = True
            pending = self._queue
            self._queue = []
            self._cond.notify_all()
        for req in pending:
            req.future.settle({"shutdown": True, "found": False,
                                "ledger_seq": None})
        for t in self._threads:
            t.join(timeout=5.0)

    # ---------------------------------------------------------- admission --
    def _run(self, kind: str, payload, deadline_ms, snapshot) -> dict:
        deadline_ms = self.deadline_ms if deadline_ms is None \
            else float(deadline_ms)
        deadline = time.monotonic() + deadline_ms / 1000.0
        ctl = getattr(self._app, "controller", None)
        if ctl is not None and ctl.roll_read_shed():
            self.shed_counters["controller"].inc()
            return {"shed": "controller", "found": False,
                    "ledger_seq": None}
        fut = _ReadFuture()
        req = _Request(kind, payload, deadline, snapshot, fut)
        with self._lock:
            if self._stopped:
                return {"shutdown": True, "found": False,
                        "ledger_seq": None}
            if len(self._queue) >= self.queue_limit:
                self.shed_counters["queue-full"].inc()
                return {"shed": "queue-full", "found": False,
                        "ledger_seq": None}
            self._queue.append(req)
            self.depth_hist.update(len(self._queue))
            self._ensure_workers_locked()
            self._cond.notify()
        return self._await(req)

    def _ensure_workers_locked(self) -> None:
        """Lazy pool: first submit spawns the workers (the completion
        queue's discipline — apps that never serve reads pay nothing)."""
        if self._threads or self._stopped:
            return
        for i in range(self.workers):
            t = threading.Thread(target=self._worker,
                                 name=f"query-worker-{i}", daemon=True)
            self._threads.append(t)
            t.start()

    # -------------------------------------------------------------- hedging --
    def _hedge_delay_s(self) -> float:
        return max(self._p95_ms, self.hedge_min_ms) / 1000.0

    def _await(self, req: _Request) -> dict:
        fut = req.future
        budget = req.deadline - time.monotonic()
        hedge_delay = min(self._hedge_delay_s(), max(0.0, budget))
        if not fut.wait(hedge_delay):
            # tied request (Tail at Scale): enqueue the same work once
            # more; first completion wins, the loser is skipped
            with self._lock:
                if not self._stopped and \
                        len(self._queue) < self.queue_limit:
                    self._queue.append(req.as_hedge())
                    self.hedge_counters["issued"].inc()
                    self._cond.notify()
        # grace past the deadline covers a worker mid-lookup
        remaining = req.deadline - time.monotonic() + 0.25
        if not fut.wait(max(0.0, remaining)):
            if fut.settle(self._timeout_result(req)):
                self.timeout_counter.inc()
        return fut.result()

    def _timeout_result(self, req: _Request) -> dict:
        return {"timeout": True, "found": False, "ledger_seq": None,
                "latency_ms": round(
                    (time.monotonic() - req.t_submit) * 1000, 3)}

    # --------------------------------------------------------------- worker --
    def _worker(self) -> None:  # thread-domain: query-worker
        threads.bind("query-worker")
        while True:
            with self._lock:
                while not self._queue and not self._stopped:
                    self._cond.wait()
                if self._stopped and not self._queue:
                    return
                req = self._queue.pop(0)
            self._execute(req)

    def _execute(self, req: _Request) -> None:
        fut = req.future
        if fut.done():
            if req.is_hedge:
                self.hedge_counters["wasted"].inc()
            return
        now = time.monotonic()
        if now > req.deadline:
            if fut.settle(self._timeout_result(req)):
                self.timeout_counter.inc()
            return
        t0 = time.monotonic()
        try:
            result = self._perform(req)
        except Exception as e:                       # noqa: BLE001
            log.debug("query failed", exc_info=True)
            result = {"error": repr(e), "found": False,
                      "ledger_seq": None}
        elapsed = time.monotonic() - t0
        result["latency_ms"] = round(elapsed * 1000, 3)
        if fut.settle(result):
            if req.is_hedge:
                self.hedge_counters["won"].inc()
        elif req.is_hedge:
            self.hedge_counters["wasted"].inc()
        self._note_latency(elapsed)

    def _note_latency(self, seconds: float) -> None:
        ms = seconds * 1000
        # the rolling window is shared with reset_stats (crank) and the
        # hedge-delay read; all writes — including the timer's internal
        # reservoir — stay under the pool lock
        with self._lock:
            self.read_timer.update(seconds)
            self._recent_ms.append(ms)
            if len(self._recent_ms) > 256:
                del self._recent_ms[:-256]
            self._since_p95 += 1
            if self._since_p95 >= 16:
                self._since_p95 = 0
                ordered = sorted(self._recent_ms)
                self._p95_ms = ordered[int(0.95 * (len(ordered) - 1))]

    # -------------------------------------------------------------- lookups --
    def _perform(self, req: _Request) -> dict:
        if req.kind == "txstatus":
            rec = self._tx_status.lookup(req.payload)
            if rec is None:
                return {"found": False, "ledger_seq": None}
            result_xdr, seq = rec
            return {"found": True, "ledger_seq": seq,
                    "result_xdr": result_xdr}
        # account reads answer against exactly one snapshot
        snap = req.snapshot
        acquired = False
        if snap is None:
            snap = self._snapshots.acquire()
            acquired = True
        if snap is None:
            return {"found": False, "ledger_seq": None,
                    "error": "no snapshot"}
        try:
            if req.kind == "account":
                entry = snap.read_entry(
                    LedgerKey.account(PublicKey.ed25519(req.payload)))
                return {"found": entry is not None,
                        "ledger_seq": snap.ledger_seq,
                        "entry_xdr": entry.to_bytes()
                        if entry is not None else None}
            if req.kind == "account_batch":
                results = []
                for raw in req.payload:
                    entry = snap.read_entry(
                        LedgerKey.account(PublicKey.ed25519(raw)))
                    results.append(entry.to_bytes()
                                   if entry is not None else None)
                return {"found": any(r is not None for r in results),
                        "ledger_seq": snap.ledger_seq,
                        "entries_xdr": results}
            raise ValueError(f"unknown query kind {req.kind!r}")
        finally:
            if acquired:
                self._snapshots.release(snap)
