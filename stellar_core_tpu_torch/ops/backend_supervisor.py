"""Device-backend supervisor: PER-DEVICE circuit breakers + hung-
dispatch watchdog for the verify hot path.

The coalescing verify service (ops/verify_service.py) makes the LIVE
signature path depend on the device backend. Without a gate, every
flush would optimistically dispatch to the device and pay the full
failure latency again before falling back to native verify — a flapping
or dead backend would degrade every batch forever, and a *hung*
dispatch (a collect handle that never completes) would block the flush
path with no recourse. Clipper (NSDI 2017, PAPERS.md) treats
latency-deadline fallback as a first-class serving primitive and "The
Tail at Scale" (Dean & Barroso, CACM 2013) names the pattern: bound
every dependency with a deadline and a health gate so one slow
component cannot poison the whole request path.

This module is that gate, a copy of the JAX package's
(stellar_core_tpu/ops/backend_supervisor.py) with the same names,
metrics, chaos seams and semantics. ``BackendSupervisor`` wraps the
device batch verifier (here ``CudaBatchVerifier``) behind the same
``verify_tuples_async`` interface and is shared by EVERY device caller.
Unknown attributes delegate to the wrapped verifier, so callers that
peek at ``_device_min_batch`` keep working.

Health is per-device: a single whole-backend breaker would throw away
the other N−1 healthy cards the moment one got sick — exactly the
all-or-nothing failure mode Tail-at-Scale argues against. Every device
in the wrapped verifier's mesh carries its own breaker running the
classic state machine (a verifier without ``ndev`` is one device):

- **CLOSED** — the device participates in dispatches. Failures are
  classified: *transient* (OSError/IOError/TimeoutError — the shapes a
  flaky transport or runtime produces, including the chaos
  ``io_error``) count toward ``failure_threshold`` consecutive
  failures; *fatal* (anything else: shape errors, OOM, a failed CUDA
  launch, programming bugs — retrying the same dispatch cannot help)
  trip immediately. A failure attributable to ONE device (a
  device-matched chaos fault, a hang pinned to a card) counts against
  that device only; an unattributable whole-dispatch failure implicates
  every participant — the per-device canary probes sort out who is
  actually sick.
- **OPEN** — the device is excluded from the active set and receives
  ZERO dispatches. A per-device ``VirtualTimer`` re-probe is armed with
  exponential backoff plus deterministic seeded jitter (decorrelated
  across devices AND nodes, reproducible within one node — the chaos
  determinism contract).
- **HALF_OPEN** — the backoff timer fired: a small canary batch of
  known-good signatures probes THAT device alone (pinned dispatch
  through ``verify_tuples_async_on``). Probe success → CLOSED; probe
  failure → OPEN with the next backoff step.

Every failed flush still resolves through the native per-signature
fallback, so results are always produced and always identical. The
FULL native fallback path engages only when no device is CLOSED (the
only state the aggregate gauge reports as OPEN).

Hung-dispatch watchdog: collection of a device handle runs on a helper
thread bounded by ``dispatch_deadline_ms``. An overdue flush is
resolved through the native fallback, the handle is QUARANTINED with
the device it was pinned to when known (the helper thread parks on a
release event; ``status()`` lists the quarantined handles), and the
breaker records a timeout-class failure. The chaos fault kinds
``hang``/``io_error`` exercise this deterministically: the
``ops.backend.dispatch`` seam fires once per flush (whole-dispatch
faults), and the per-device ``ops.backend.dispatch.device`` seam fires
once per participating device with ``device=<index>`` in the context,
so a fault spec with a device-index match hits exactly one shard.

Observability: the aggregate ``crypto.verify_backend.*`` surface (state
gauge 0=CLOSED 1=OPEN 2=HALF_OPEN over the AGGREGATE state — CLOSED
while at least one device serves — transition counters, dispatch/skip
counters, failure classes, probe timer), plus per-device
``crypto.verify_backend.device<N>.{dispatch,skip}`` counters. Breaker
transitions append to a bounded log with PER-DEVICE dispatch-counter
snapshots — the zero-dispatch-while-OPEN evidence — and emit
flight-recorder instants (``backend.breaker``) on aggregate changes.
``force_trip``/``force_reset`` move one device or all of them.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence, Tuple

from .shard_math import shard_shares
from ..util import chaos, tracing
from ..util.logging import get_logger

log = get_logger("Herder")

# breaker states (gauge values follow this order)
CLOSED = "CLOSED"
OPEN = "OPEN"
HALF_OPEN = "HALF_OPEN"
_STATE_GAUGE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

# failure classes (metric suffixes: crypto.verify_backend.failure.<class>)
FAILURE_CLASSES = ("transient", "fatal", "timeout")

DEFAULT_FAILURE_THRESHOLD = 3
DEFAULT_DISPATCH_DEADLINE_MS = 2000.0
DEFAULT_PROBE_BASE_MS = 1000.0
DEFAULT_PROBE_MAX_MS = 30000.0
DEFAULT_CANARY_BATCH = 16
# jitter fraction on each backoff step: delay *= 1 + U[0, JITTER_FRAC)
JITTER_FRAC = 0.25


def classify_error(exc: BaseException) -> str:
    """Transient vs. fatal dispatch-error classification. I/O-shaped
    errors (a flaky transport/runtime, the chaos ``io_error``) are
    worth retrying after backoff; anything else — shape mismatches,
    OOM, programming errors — will fail identically on retry, so it
    trips the breaker immediately."""
    if isinstance(exc, (OSError, TimeoutError, ConnectionError)):
        return "transient"
    return "fatal"


class _CollectWorker:
    """Reusable watchdog helper: one long-lived thread running one
    collect job at a time off its own queue, so the healthy hot path
    (hundreds of deadline flushes per second) pays a queue put/get
    instead of a thread spawn per collect. A deadline overrun
    quarantines the worker — its thread is stuck inside the hung
    collect — and the None sentinel queued behind the hung job lets
    the thread exit once the handle finally releases."""

    __slots__ = ("jobs", "thread")

    def __init__(self):
        import queue
        self.jobs = queue.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="verify-collect")
        self.thread.start()

    def _run(self):  # thread-domain: verify-collect
        from ..util import threads
        if threads.CHECK:
            threads.bind("verify-collect")
        while True:
            job = self.jobs.get()
            if job is None:
                return
            fn, box, done = job
            try:
                box["r"] = fn()
            except BaseException as e:   # parked hung handles too
                box["e"] = e
            done.set()


class _Quarantined:
    """One hung collect handle: the helper thread that owns it parks on
    `release` so a long-lived process can let it go at shutdown.
    `device` is the chip the hang was pinned to (None when the whole
    collective launch hung without attribution)."""

    __slots__ = ("batch", "since", "thread", "device")

    def __init__(self, batch: int, since: float, thread: threading.Thread,
                 device: Optional[int] = None):
        self.batch = batch
        self.since = since
        self.thread = thread
        self.device = device


class _DeviceBreaker:
    """Per-device breaker state: one classic CLOSED→OPEN→HALF_OPEN
    machine, its own backoff RNG stream and probe timer, and its own
    dispatch/skip counters (the zero-dispatch-while-OPEN evidence)."""

    __slots__ = ("index", "state", "consecutive_failures", "probe_attempt",
                 "next_probe_at", "timer", "rng", "dispatches", "skips",
                 "last_probe_at")

    def __init__(self, index: int, rng, dispatches, skips):
        self.index = index
        self.state = CLOSED
        self.consecutive_failures = 0
        self.probe_attempt = 0
        self.next_probe_at: Optional[float] = None
        self.timer = None
        self.rng = rng
        self.dispatches = dispatches
        self.skips = skips
        self.last_probe_at: Optional[float] = None


class BackendSupervisor:
    """Per-device circuit breakers + watchdog around a device batch
    verifier.

    Drop-in for the wrapped verifier everywhere ``verify_tuples`` /
    ``verify_tuples_async`` are consumed; unknown attributes delegate
    to the wrapped instance. A wrapped verifier without a mesh
    (``TpuBatchVerifier``, test fakes) is supervised as a one-device
    mesh: one breaker for the whole backend.
    """

    # duck-type marker the admin route / self_check key on
    breaker_state = True

    def __init__(self, inner, clock=None, metrics=None, perf=None,
                 failure_threshold: int = DEFAULT_FAILURE_THRESHOLD,
                 dispatch_deadline_ms: float = DEFAULT_DISPATCH_DEADLINE_MS,
                 probe_base_ms: float = DEFAULT_PROBE_BASE_MS,
                 probe_max_ms: float = DEFAULT_PROBE_MAX_MS,
                 canary_batch: int = DEFAULT_CANARY_BATCH,
                 jitter_seed: int = 0, chaos_label: str = ""):
        self._inner = inner
        self._clock = clock
        self._lock = threading.RLock()
        self._threshold = max(1, int(failure_threshold))
        self._deadline_s = max(0.0, float(dispatch_deadline_ms)) / 1000.0
        self._probe_base_s = max(0.001, float(probe_base_ms)) / 1000.0
        self._probe_max_s = max(self._probe_base_s,
                                float(probe_max_ms) / 1000.0)
        self._canary_batch = max(1, int(canary_batch))
        self._canary: Optional[List[Tuple[bytes, bytes, bytes]]] = None
        self.chaos_label = chaos_label
        self._shut_down = False
        # [(clock time, from, to, reason, total dispatches so far,
        #   device index, THAT device's dispatches so far)] — the chaos
        # scenario and the MESH artifact assert zero dispatches while
        # OPEN from the per-device counter snapshots in here. Bounded
        # like the flight recorder's ring buffer: a flapping device
        # appends forever, and status() serializes the whole list on
        # every admin hit
        from collections import deque as _deque
        self.transitions = _deque(maxlen=64)
        self.transition_count = 0
        self._quarantined: List[_Quarantined] = []
        self._idle_workers: List[_CollectWorker] = []
        self._max_idle_workers = 4
        self._release = threading.Event()   # parks hung collect threads
        if perf is None:
            from ..util.perf import default_registry
            perf = default_registry
        self.perf = perf
        if metrics is None:
            from ..util.metrics import MetricsRegistry
            metrics = MetricsRegistry()
        self._state_gauge = metrics.counter("crypto", "verify_backend",
                                            "state")
        self._transition_counters = {
            s: metrics.counter("crypto", "verify_backend", "transition",
                               "to_" + s.lower())
            for s in (CLOSED, OPEN, HALF_OPEN)}
        self._dispatch_counter = metrics.counter(
            "crypto", "verify_backend", "dispatch")
        self._skip_counter = metrics.counter(
            "crypto", "verify_backend", "skip")
        self._failure_counters = {
            c: metrics.counter("crypto", "verify_backend", "failure", c)
            for c in FAILURE_CLASSES}
        self._probe_timer_metric = metrics.timer(
            "crypto", "verify_backend", "probe")
        # the per-device breaker array: decorrelated seeded jitter
        # streams per device (and per node via jitter_seed), per-device
        # dispatch/skip counters on the shared registry
        import random
        self._ndev = max(1, int(getattr(inner, "ndev", 1) or 1))
        self._breakers = [
            _DeviceBreaker(
                i, random.Random(jitter_seed * 1000003 + i),
                metrics.counter("crypto", "verify_backend",
                                "device%d" % i, "dispatch"),
                metrics.counter("crypto", "verify_backend",
                                "device%d" % i, "skip"))
            for i in range(self._ndev)]
        self._agg_state = CLOSED

    # ------------------------------------------------------- delegation --
    def __getattr__(self, name):
        # transparent proxy: callers probing verifier attributes
        # (_device_min_batch, mesh, ndev, …) reach the wrapped instance
        return getattr(self._inner, name)

    # ------------------------------------------------------- aggregates --
    @property
    def state(self) -> str:
        """Aggregate breaker state: CLOSED while at least one device
        serves (the mesh may be degraded — see ``mesh_status``),
        HALF_OPEN when no device serves but a probe is out, OPEN when
        the whole mesh is unavailable. For a one-device mesh this IS
        the device state."""
        return self._agg_state

    @property
    def consecutive_failures(self) -> int:
        return max(b.consecutive_failures for b in self._breakers)

    @property
    def probe_attempt(self) -> int:
        return max(b.probe_attempt for b in self._breakers)

    def _active_locked(self) -> Tuple[int, ...]:
        return tuple(b.index for b in self._breakers
                     if b.state == CLOSED)

    def mesh_status(self) -> dict:
        """Surviving-mesh summary for telemetry samples and the
        adaptive controller's capacity scaling."""
        with self._lock:
            active = self._active_locked()
            return {"devices": self._ndev, "active": len(active),
                    "active_indices": list(active)}

    # ----------------------------------------------------------- verify --
    def verify_tuples(
            self, items: Sequence[Tuple[bytes, bytes, bytes]]) -> List[bool]:
        return self.verify_tuples_async(items)()

    def verify_tuples_async(
            self, items: Sequence[Tuple[bytes, bytes, bytes]]):
        """The supervised dispatch: the active-device mesh when at
        least one device is CLOSED, straight to the native path when
        the mesh is empty (no device attempt, no failure latency).
        Always returns a zero-arg collect callable whose results are
        identical to PubKeyUtils.verify_sig."""
        if not items:
            return lambda: []
        with self._lock:
            if not self._active_locked():
                self._record_skip_locked()
                return self._native_handle(items)
        return self._dispatch(items)

    def _native_handle(self, items):
        def collect():
            from ..crypto.keys import verify_sig_uncached
            return [verify_sig_uncached(p, s, m) for p, s, m in items]
        return collect

    def _record_skip_locked(self) -> None:
        self._skip_counter.inc()
        for b in self._breakers:
            b.skips.inc()

    def _dispatch(self, items, probe_device: Optional[int] = None):
        """Dispatch to the active mesh (breakers permitting) and wrap
        the collect handle with the watchdog deadline. `probe_device`
        pins the dispatch to one device — the canary-probe path."""
        probe = probe_device is not None
        with self._lock:
            if probe:
                participants: Tuple[int, ...] = (probe_device,)
            else:
                # re-check under the same lock transitions take: a
                # caller that passed the fast-path check can race a
                # concurrent trip, and a dispatch slipping through to a
                # tripped device would both pay the failure latency
                # OPEN exists to eliminate and break the
                # zero-dispatch-while-OPEN counter invariant the chaos
                # verdicts audit
                participants = self._active_locked()
                if not participants:
                    self._record_skip_locked()
                    return self._native_handle(items)
            self._dispatch_counter.inc()
            for i in participants:
                self._breakers[i].dispatches.inc()
            if not probe:
                # a device outside the mesh sees this flush only as a
                # skip: its bucket share went to the survivors
                for b in self._breakers:
                    if b.state != CLOSED:
                        b.skips.inc()
        hung = False
        hung_device: Optional[int] = None
        try:
            if chaos.ENABLED:
                # whole-dispatch fault seam (one hit per flush):
                # io_error raises — a transient failure
                # implicating every participant — and `hang`
                # substitutes a handle that never completes, so only
                # the watchdog deadline resolves the flush
                out = chaos.point("ops.backend.dispatch", None,
                                  node=self.chaos_label, n=len(items),
                                  probe=probe)
                hung = out is chaos.HANG
                # per-device fault seam: one firing per participating
                # device, so a spec with match={"device": N} hits
                # exactly that shard (satellite: chaos seam targeting).
                # shard_shares is the SAME split the sharded verifier
                # performs, so n= describes that shard's actual rows
                shares = shard_shares(len(items), len(participants))
                for s, i in enumerate(participants):
                    try:
                        out = chaos.point(
                            "ops.backend.dispatch.device", None,
                            node=self.chaos_label, device=i,
                            n=shares[s], probe=probe)
                    except Exception as e:
                        # attributable: exactly this device is sick.
                        # A probe re-raises UNRECORDED — the outer
                        # handler records it against the same single
                        # device (one record per injected fault)
                        if probe:
                            raise
                        self._record_failure(classify_error(e), e,
                                             participants=(i,),
                                             probe=probe)
                        return self._native_handle(items)
                    if out is chaos.HANG:
                        hung, hung_device = True, i
            if hung:
                ev = self._release

                def inner_collect():
                    ev.wait()
                    raise TimeoutError("chaos: hung dispatch released")
            elif probe and hasattr(self._inner, "verify_tuples_async_on"):
                inner_collect = self._inner.verify_tuples_async_on(
                    probe_device, items)
            else:
                inner_collect = self._inner.verify_tuples_async(items)
        except Exception as e:
            self._record_failure(classify_error(e), e,
                                 participants=participants, probe=probe)
            if probe:
                raise
            return self._native_handle(items)
        return self._watched_collect(inner_collect, items, participants,
                                     probe, hung_device)

    def _watched_collect(self, inner_collect, items, participants,
                         probe: bool, hung_device: Optional[int]):
        """Bound collection by the dispatch deadline on a helper
        thread; on expiry quarantine the handle, record a timeout-class
        failure (pinned to the hung device when known, the whole
        participant set otherwise), and resolve the batch natively."""
        blame = (hung_device,) if hung_device is not None else participants

        def collect():
            if self._deadline_s <= 0:
                box = {}
                try:
                    box["r"] = inner_collect()
                except Exception as e:
                    self._record_failure(classify_error(e), e,
                                         participants=blame, probe=probe)
                    if probe:
                        raise
                    return self._native_handle(items)()
                self._record_success(participants=participants)
                return list(box["r"])
            with self._lock:
                w = self._idle_workers.pop() if self._idle_workers \
                    else None
            if w is None:
                w = _CollectWorker()
            box = {}
            done = threading.Event()
            w.jobs.put((inner_collect, box, done))
            if not done.wait(self._deadline_s):
                # the worker thread is stuck inside the hung collect;
                # the sentinel behind it lets the thread exit once the
                # handle finally releases
                w.jobs.put(None)
                with self._lock:
                    self._quarantined.append(_Quarantined(
                        len(items), time.monotonic(), w.thread,
                        hung_device))
                exc = TimeoutError(
                    f"device collect overran "
                    f"{self._deadline_s * 1000:.0f}ms deadline")
                self._record_failure("timeout", exc,
                                     participants=blame, probe=probe)
                if probe:
                    raise exc
                return self._native_handle(items)()
            with self._lock:
                if self._shut_down or \
                        len(self._idle_workers) >= self._max_idle_workers:
                    w.jobs.put(None)
                else:
                    self._idle_workers.append(w)
            if "e" in box:
                e = box["e"]
                self._record_failure(classify_error(e), e,
                                     participants=blame, probe=probe)
                if probe:
                    raise e
                return self._native_handle(items)()
            self._record_success(participants=participants)
            return list(box["r"])
        return collect

    # ------------------------------------------------------ state moves --
    def _now(self) -> float:
        return self._clock.now() if self._clock is not None \
            else time.monotonic()

    def _transition_device_locked(self, i: int, to: str,
                                  reason: str) -> None:
        b = self._breakers[i]
        frm = b.state
        if frm == to:
            return
        b.state = to
        self.transition_count += 1
        self.transitions.append(
            (self._now(), frm, to, reason,
             self._dispatch_counter.count, i, b.dispatches.count))
        self._sync_inner_active_locked(reason)
        self._update_aggregate_locked(reason)

    def _sync_inner_active_locked(self, reason: str) -> None:
        """Push the surviving set into the wrapped verifier's mesh —
        the shrink/regrow. A mesh-less inner (one device) has nothing
        to shrink; an EMPTY set is not pushed (dispatches are skipped
        at this layer, native fallback serves)."""
        active = self._active_locked()
        if not active or not hasattr(self._inner, "set_active_devices"):
            return
        if tuple(getattr(self._inner, "active_indices", tuple)()) \
                == active:
            return
        self._inner.set_active_devices(active)
        log.warning("verify mesh now %d/%d devices %s (%s)",
                    len(active), self._ndev, list(active), reason)

    def _update_aggregate_locked(self, reason: str) -> None:
        states = [b.state for b in self._breakers]
        if any(s == CLOSED for s in states):
            agg = CLOSED
        elif any(s == HALF_OPEN for s in states):
            agg = HALF_OPEN
        else:
            agg = OPEN
        frm = self._agg_state
        if agg == frm:
            return
        self._agg_state = agg
        self._state_gauge.set_count(_STATE_GAUGE[agg])
        self._transition_counters[agg].inc()
        lvl = log.warning if agg == OPEN else log.info
        lvl("verify backend breaker %s -> %s (%s)", frm, agg, reason)
        if tracing.ENABLED:
            rec = getattr(self.perf, "tracer", None)
            if rec is not None and rec.active:
                rec.instant("backend.breaker", {
                    "from": frm, "to": agg, "reason": reason})

    def _record_failure(self, cls: str, exc: BaseException,
                        participants: Sequence[int],
                        probe: bool = False) -> None:
        with self._lock:
            self._failure_counters[cls].inc()
            worst = 0
            for i in participants:
                b = self._breakers[i]
                b.consecutive_failures += 1
                worst = max(worst, b.consecutive_failures)
                if b.state == HALF_OPEN:
                    if probe:
                        # failed probe: back to OPEN, next backoff step
                        b.probe_attempt += 1
                        self._transition_device_locked(
                            i, OPEN, f"probe_{cls}")
                        self._arm_probe_locked(i)
                    # a late-collected pre-trip dispatch failing while
                    # the canary is out is NOT a probe verdict: count
                    # it but let the real probe decide the state
                elif b.state == CLOSED and (
                        cls == "fatal"
                        or b.consecutive_failures >= self._threshold):
                    self._trip_device_locked(
                        i, "fatal_error" if cls == "fatal"
                        else "failure_threshold")
            lvl = log.warning if worst <= self._threshold else log.debug
            lvl("verify backend %s failure on device(s) %s "
                "(%d consecutive): %r", cls, list(participants),
                worst, exc)

    def _record_success(self, participants: Sequence[int],
                        probe: bool = False) -> None:
        """Mirror of _record_failure's probe asymmetry: only the probe
        verdict — issued by the probe path AFTER checking the canary
        results' contents — may close a HALF_OPEN device. A collect
        that merely completes (the watchdog layer's notion of success,
        which a device answering wrong answers also satisfies) or a
        late-collected pre-trip dispatch succeeding while the canary
        is out resets the failure count but decides nothing."""
        with self._lock:
            for i in participants:
                b = self._breakers[i]
                b.consecutive_failures = 0
                if b.state == HALF_OPEN and probe:
                    self._close_device_locked(i, "probe_ok")

    def _trip_device_locked(self, i: int, reason: str) -> None:
        b = self._breakers[i]
        b.probe_attempt = 0
        self._transition_device_locked(i, OPEN, reason)
        self._arm_probe_locked(i)

    def _close_device_locked(self, i: int, reason: str) -> None:
        b = self._breakers[i]
        b.consecutive_failures = 0
        b.probe_attempt = 0
        b.next_probe_at = None
        if b.timer is not None:
            b.timer.cancel()
        self._transition_device_locked(i, CLOSED, reason)

    def _backoff_s(self, b: _DeviceBreaker) -> float:
        base = min(self._probe_base_s * (2 ** b.probe_attempt),
                   self._probe_max_s)
        return base * (1.0 + JITTER_FRAC * b.rng.random())

    def _arm_probe_locked(self, i: int) -> None:
        b = self._breakers[i]
        if self._clock is None or self._shut_down:
            # no clock (bare harnesses): probes only via probe_now()
            b.next_probe_at = None
            return
        from ..util.timer import VirtualTimer
        if b.timer is None:
            b.timer = VirtualTimer(self._clock)
        delay = self._backoff_s(b)
        b.next_probe_at = self._clock.now() + delay
        b.timer.expires_from_now(delay)
        b.timer.async_wait(lambda: self._on_probe_timer(i))

    def _on_probe_timer(self, i: int) -> None:
        if self._shut_down:
            return
        self._probe_device(i)

    # ------------------------------------------------------------ probe --
    def _canary_items(self) -> List[Tuple[bytes, bytes, bytes]]:
        """A batch of known-good signatures over 32-byte messages (the
        tx-hash hot-path shape). Built once; a probe succeeds iff every
        one verifies within the dispatch deadline."""
        if self._canary is None:
            import hashlib

            from ..crypto.keys import SecretKey
            sk = SecretKey.from_seed(
                b"backend-supervisor-canary".ljust(32, b"\x5c")[:32])
            pub = sk.public_key().raw
            items = []
            for i in range(self._canary_batch):
                msg = hashlib.sha256(b"canary-%d" % i).digest()
                items.append((pub, sk.sign(msg), msg))
            self._canary = items
        return self._canary

    def probe_now(self, device: Optional[int] = None) -> bool:
        """Run canary probes now (the manual hook for clock-less
        harnesses and the admin route): every non-CLOSED device, or
        just `device`. Returns the conjunction of probe verdicts (True
        when nothing needed probing)."""
        with self._lock:
            if self._shut_down:
                return True
            if device is not None:
                targets = [device] if \
                    self._breakers[device].state != CLOSED else []
            else:
                targets = [b.index for b in self._breakers
                           if b.state != CLOSED]
        ok = True
        for i in targets:
            ok = self._probe_device(i) and ok
        return ok

    def _probe_device(self, i: int) -> bool:
        """One HALF_OPEN canary probe pinned to device `i` (timer
        callback + probe_now). Returns the probe verdict."""
        with self._lock:
            b = self._breakers[i]
            if b.state == CLOSED or self._shut_down:
                return True
            self._transition_device_locked(i, HALF_OPEN, "probe_timer")
        items = self._canary_items()
        t0 = time.perf_counter()
        try:
            collect = self._dispatch(items, probe_device=i)
            results = collect()
            ok = bool(results) and all(bool(r) for r in results)
        except Exception:
            # _dispatch/_watched_collect already recorded the failure
            # and re-armed the probe timer (probe re-raises)
            self._probe_timer_metric.update(time.perf_counter() - t0)
            with self._lock:
                b.last_probe_at = self._now()
            return False
        self._probe_timer_metric.update(time.perf_counter() - t0)
        with self._lock:
            b.last_probe_at = self._now()
        if ok:
            self._record_success(participants=(i,), probe=True)
        else:
            # the device answered but rejected known-good signatures:
            # wrong results are worse than no results — treat as fatal
            self._record_failure(
                "fatal", RuntimeError("canary batch rejected"),
                participants=(i,), probe=True)
        return ok

    def refresh_gauge(self) -> None:
        """Re-assert the state gauge after a metrics clear: the gauge
        is a level, and `clearmetrics` zeroing it while the breaker is
        OPEN would read as CLOSED until the next transition."""
        with self._lock:
            self._state_gauge.set_count(_STATE_GAUGE[self._agg_state])

    # ---------------------------------------------------- forced control --
    def force_trip(self, device: Optional[int] = None) -> None:
        """Admin `backendstatus?action=trip[&device=N]`
        (ALLOW_CHAOS_INJECTION): trip one device, or the whole mesh."""
        with self._lock:
            targets = [device] if device is not None \
                else range(self._ndev)
            for i in targets:
                if self._breakers[i].state == CLOSED:
                    self._trip_device_locked(i, "forced_trip")

    def force_reset(self, device: Optional[int] = None) -> None:
        """Admin `backendstatus?action=reset[&device=N]`: straight to
        CLOSED for one device, or the whole mesh."""
        with self._lock:
            targets = [device] if device is not None \
                else range(self._ndev)
            for i in targets:
                self._close_device_locked(i, "forced_reset")

    # -------------------------------------------------------- lifecycle --
    def shutdown(self) -> None:
        """Cancel every probe timer and release parked hung-collect
        threads; a dead app must not probe the device."""
        with self._lock:
            self._shut_down = True
            for b in self._breakers:
                if b.timer is not None:
                    b.timer.cancel()
                    b.timer = None
                b.next_probe_at = None
            workers, self._idle_workers = self._idle_workers, []
        for w in workers:
            w.jobs.put(None)
        self._release.set()

    # ------------------------------------------------------------ report --
    def status(self) -> dict:
        """Live state document for the `backendstatus` admin route and
        self_check: the aggregate surface plus per-device
        rows and the surviving-mesh summary."""
        with self._lock:
            now = self._now()
            mono = time.monotonic()
            self._quarantined = [q for q in self._quarantined
                                 if q.thread.is_alive()]
            active = self._active_locked()
            probe_etas = [b.next_probe_at - now for b in self._breakers
                          if b.next_probe_at is not None]
            devices = []
            for b in self._breakers:
                devices.append({
                    "device": b.index,
                    "state": b.state,
                    "consecutive_failures": b.consecutive_failures,
                    "probe_attempt": b.probe_attempt,
                    "next_probe_in_s": (
                        round(max(0.0, b.next_probe_at - now), 3)
                        if b.next_probe_at is not None else None),
                    "last_probe_age_s": (
                        round(max(0.0, now - b.last_probe_at), 3)
                        if b.last_probe_at is not None else None),
                    "dispatches": b.dispatches.count,
                    "skips": b.skips.count,
                    "quarantined": sum(1 for q in self._quarantined
                                       if q.device == b.index),
                })
            return {
                "state": self._agg_state,
                "consecutive_failures": self.consecutive_failures,
                "failure_threshold": self._threshold,
                "dispatches": self._dispatch_counter.count,
                "skips": self._skip_counter.count,
                "failures": {c: m.count
                             for c, m in self._failure_counters.items()},
                "probe_attempt": self.probe_attempt,
                "next_probe_in_s": (
                    round(max(0.0, min(probe_etas)), 3)
                    if probe_etas else None),
                "dispatch_deadline_ms": self._deadline_s * 1000.0,
                "mesh": {"devices": self._ndev, "active": len(active),
                         "active_indices": list(active)},
                "devices": devices,
                "transition_count": self.transition_count,
                "transitions": [
                    {"t": round(t, 3), "from": frm, "to": to,
                     "reason": reason, "dispatches": d,
                     "device": dev, "device_dispatches": dd}
                    for t, frm, to, reason, d, dev, dd
                    in self.transitions],
                "quarantined": [
                    {"batch": q.batch,
                     "age_s": round(mono - q.since, 3),
                     "device": q.device}
                    for q in self._quarantined],
            }
