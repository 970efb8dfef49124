"""Deterministic chaos injection: seeded fault schedules at named seams.

The reference validates crash/partition behavior with simulation tests
(lost/restored nodes, stop-mid-catchup — src/simulation) and per-seam
fault knobs (LoopbackPeer damage/drop probabilities). This module is the
generalized form: one process-global engine holding a SEEDED
schedule of faults keyed by named injection points. Instrumented seams
ask ``chaos.point("overlay.send", raw, node=..., peer=...)`` and the
engine decides — deterministically — whether to drop, corrupt, delay,
fail or crash right there.

Cost contract: when chaos is disabled (the default, always in
production) every instrumented seam executes exactly one module-level
constant check (``if chaos.ENABLED:``) and nothing else — no config
lookup, no function call, no allocation.

Determinism contract: a fault schedule is keyed by per-spec *matched-hit
ordinals* (the Nth time a point fires with a matching context), plus an
optional per-spec seeded RNG for probabilistic firing and corruption
byte choice. Two runs that make the same sequence of point calls inject
the same faults at the same places — asserted by ``ChaosEngine.log``
equality. Hit ordinals are only well-defined when the instrumented code
runs single-threaded; deterministic scenarios therefore run nodes with
inline close completion and synchronous bucket merges (see
docs/CHAOS.md).
"""

from __future__ import annotations

import random
import threading
import time as _time
from typing import Dict, List, Optional

from .logging import get_logger

log = get_logger("Chaos")

# ---------------------------------------------------------------- guard --
# Module-level constant guard: hot paths check ONLY this before paying
# anything. install()/uninstall() are the sole writers.
ENABLED = False
_engine: Optional["ChaosEngine"] = None

# Fire observers (record/replay): called OUTSIDE the engine
# lock on every `fire` — injected or not, because input recorders key
# faults by node-local matched-hit ordinals and must count the
# pass-throughs too. Empty in production; one list-read when chaos is
# already enabled.
_observers: List = []


def add_observer(obs) -> None:
    """`obs(point, ctx, kind_or_None, spec_or_None)` on every fire."""
    if obs not in _observers:
        _observers.append(obs)


def remove_observer(obs) -> None:
    if obs in _observers:
        _observers.remove(obs)


# sentinels returned by point() for caller-interpreted faults
DROP = object()      # message/payload must be dropped by the caller
REORDER = object()   # caller should reorder delivery (loopback queues)
FAIL = object()      # caller should substitute its failure path
HANG = object()      # caller's async operation must never complete
EQUIVOCATE = object()  # caller signs+emits a CONFLICTING twin envelope

# fault kinds. `equivocate`/`bad_sig_flood`/`malformed_xdr`/`churn` are
# the Byzantine family: `equivocate` (two conflicting signed
# SCP envelopes for one slot), `bad_sig_flood` (bursts of well-formed
# payloads with invalid signatures), `malformed_xdr` (truncation /
# multi-byte mangling beyond the single-byte `corrupt`), and `churn`
# (kill + later restart from persisted state, vs `crash` which kills
# forever). `partition`/`flap`/`slow_link` are the wide-area link
# family: time-windowed rather than hit-ordinal-windowed —
# see TIMED_KINDS below.
KINDS = ("io_error", "drop", "corrupt", "delay", "reorder", "crash",
         "fail", "hang", "equivocate", "bad_sig_flood", "malformed_xdr",
         "churn", "partition", "flap", "slow_link")

# The link-fault family is driven by elapsed TIME, not matched-hit
# ordinals: a severed or shaped link is a condition that holds over a
# window, not an event that fires N times. Specs of these kinds ignore
# start/count/prob and instead fire on EVERY matched hit while their
# window is open. The time base is `ctx["now"]` when the seam provides
# one (the VirtualClock — loopback simulations stay deterministic in
# virtual time; real-socket nodes pass their monotonic run clock), else
# time.monotonic(). The window opens at the first matched hit.
TIMED_KINDS = frozenset({"partition", "flap", "slow_link"})


class Delay:
    """Deferred delivery: the caller must schedule `payload` on the
    VirtualClock `seconds` from now. NEVER a real sleep — a wall-clock
    sleep inside a single-process virtual-time simulation blocks every
    node at once and burns wall time proportional to nodes × latency
    (an early `delay` bug). Seams that cannot defer (TCP stream chunks,
    DB commits) treat an unhandled Delay as passthrough."""

    __slots__ = ("payload", "seconds")

    def __init__(self, payload, seconds: float):
        self.payload = payload
        self.seconds = seconds


class Shape:
    """Per-link traffic shaping verdict from a `slow_link` spec: the
    caller must hold `payload` for `delay_s` before release and pace the
    link at `bytes_per_s` (None = latency only). Returned on every
    matched hit while the spec's window is open, so callers stay
    stateless about the schedule — they shape exactly the frames the
    engine tells them to."""

    __slots__ = ("delay_s", "bytes_per_s")

    def __init__(self, delay_s: float, bytes_per_s: Optional[float]):
        self.delay_s = delay_s
        self.bytes_per_s = bytes_per_s


class BadSigBurst:
    """The caller forges `burst` well-formed payloads carrying INVALID
    signatures from a real template and feeds them down its normal
    admission path — modeling a flooder aimed at the verify service's
    batch admission."""

    __slots__ = ("burst",)

    def __init__(self, burst: int):
        self.burst = burst


class ChaosError(IOError):
    """An injected I/O fault. Subclasses IOError/OSError so it travels
    the same error paths a real transport/disk failure would."""


class SimulatedCrash(BaseException):
    """A simulated process kill. BaseException on purpose: generic
    ``except Exception`` recovery code must NOT swallow it — it unwinds
    to the application boundary (the crank loop / test harness), which
    treats the node as dead."""

    def __init__(self, point: str, ctx: Optional[dict] = None):
        super().__init__(f"chaos: simulated crash at {point}")
        self.point = point
        self.ctx = dict(ctx or {})


class SimulatedChurn(SimulatedCrash):
    """Kill + restart: unwinds exactly like a crash (the node is buried,
    in-memory state past the last durable commit is lost), but the
    scenario harness restarts the node from its persisted DB + bucket dir
    (`Simulation.restart_node`) after a delay and expects it to catch
    back up while chaos is still active."""


# Crash points at the ledger-close phase boundaries (the crash-point
# matrix). Points before/inside the consensus-critical SQL transaction
# roll the whole close back; points after it exercise the
# `lastclosecompleted` recovery path from the close pipeline.
CLOSE_CRASH_POINTS = (
    "ledger.close.crash.prepare",        # before the close transaction
    "ledger.close.crash.fees",           # after the fee pass (in-txn)
    "ledger.close.crash.applyTx",        # after the apply loop (in-txn)
    "ledger.close.crash.upgrades",       # after upgrades (in-txn)
    "ledger.close.crash.evictionScan",   # after the eviction scan (in-txn)
    "ledger.close.crash.seal",           # after seal, before COMMIT
    "ledger.close.crash.commit",         # header durable, nothing queued
    "ledger.close.crash.queued",         # checkpoint queued, tail pending
    "ledger.close.crash.complete.meta",  # meta emitted, marker pending
    "ledger.close.crash.complete.marker",  # marker durable, publish pending
)


class FaultSpec:
    """One scheduled fault: fire `kind` at `point` on matched hits
    [start, start+count), optionally with probability `prob` instead of
    the hit window, only when `match` is a subset of the call context."""

    __slots__ = ("point", "kind", "start", "count", "prob", "match",
                 "delay_ms", "burst", "window_s", "period_s", "duty",
                 "bps")

    def __init__(self, point: str, kind: str, start: int = 0,
                 count: int = 1, prob: Optional[float] = None,
                 match: Optional[dict] = None, delay_ms: float = 1.0,
                 burst: int = 8, window_s: float = 0.0,
                 period_s: float = 4.0, duty: float = 0.5,
                 bps: Optional[float] = None):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind: {kind}")
        self.point = point
        self.kind = kind
        self.start = start
        self.count = count
        self.prob = prob
        self.match = dict(match or {})
        self.delay_ms = delay_ms
        self.burst = burst
        # link-fault family (TIMED_KINDS): active window in seconds
        # from the first matched hit, 0 = until the engine is cleared
        # (the harness heals a partition either way — scheduled via
        # window_s, or explicitly via chaos?mode=clear)
        self.window_s = window_s
        self.period_s = period_s   # flap: one down+up cycle
        self.duty = duty           # flap: fraction of period spent DOWN
        self.bps = bps             # slow_link: bytes/second, None = ∞

    def to_json(self) -> dict:
        doc = {"point": self.point, "kind": self.kind,
               "start": self.start, "count": self.count}
        if self.prob is not None:
            doc["prob"] = self.prob
        if self.match:
            doc["match"] = dict(self.match)
        if self.kind == "delay":
            doc["delay_ms"] = self.delay_ms
        if self.kind == "bad_sig_flood":
            doc["burst"] = self.burst
        if self.kind in TIMED_KINDS:
            doc["window_s"] = self.window_s
        if self.kind == "flap":
            doc["period_s"] = self.period_s
            doc["duty"] = self.duty
        if self.kind == "slow_link":
            doc["delay_ms"] = self.delay_ms
            if self.bps is not None:
                doc["bps"] = self.bps
        return doc

    @classmethod
    def from_json(cls, doc: dict) -> "FaultSpec":
        bps = doc.get("bps")
        return cls(doc["point"], doc["kind"],
                   start=int(doc.get("start", 0)),
                   count=int(doc.get("count", 1)),
                   prob=doc.get("prob"),
                   match=doc.get("match"),
                   delay_ms=float(doc.get("delay_ms", 1.0)),
                   burst=int(doc.get("burst", 8)),
                   window_s=float(doc.get("window_s", 0.0)),
                   period_s=float(doc.get("period_s", 4.0)),
                   duty=float(doc.get("duty", 0.5)),
                   bps=float(bps) if bps is not None else None)


def schedule_from_json(docs: List[dict]) -> List[FaultSpec]:
    return [FaultSpec.from_json(d) for d in docs]


class ChaosEngine:
    """Process-global fault scheduler. One instance is installed at a
    time; every instrumented seam routes through `fire`."""

    def __init__(self, seed: int, schedule: Optional[List[FaultSpec]]
                 = None):
        self.seed = seed
        self.schedule: List[FaultSpec] = list(schedule or [])
        self._lock = threading.Lock()
        # per-spec seeded RNGs: independent streams, so adding a spec
        # never perturbs another spec's decisions
        self._rngs = [random.Random(seed * 1000003 + i)
                      for i in range(len(self.schedule))]
        self._spec_hits = [0] * len(self.schedule)
        # TIMED_KINDS: window-open timestamp, set at first matched hit
        self._spec_t0: List[Optional[float]] = [None] * len(self.schedule)
        self.point_hits: Dict[str, int] = {}   # observability
        self.injected: Dict[str, int] = {}     # chaos.injected.<kind>
        # reproducibility record: (point, spec index, matched hit, kind)
        self.log: List[tuple] = []

    # ------------------------------------------------------------- firing --
    def fire(self, point: str, payload, ctx: dict):
        chosen = None
        with self._lock:
            self.point_hits[point] = self.point_hits.get(point, 0) + 1
            for i, spec in enumerate(self.schedule):
                if spec.point != point:
                    continue
                if spec.match and any(ctx.get(k) != v
                                      for k, v in spec.match.items()):
                    continue
                hit = self._spec_hits[i]
                self._spec_hits[i] = hit + 1
                if spec.kind in TIMED_KINDS:
                    # time-windowed link faults: every matched hit
                    # inside the open window fires; start/count/prob
                    # do not apply (a severed link is a condition, not
                    # an event). Window opens at the first matched hit.
                    now = ctx.get("now")
                    if not isinstance(now, (int, float)):
                        now = _time.monotonic()
                    t0 = self._spec_t0[i]
                    if t0 is None:
                        t0 = self._spec_t0[i] = float(now)
                    elapsed = now - t0
                    if spec.window_s > 0 and elapsed >= spec.window_s:
                        continue    # window elapsed: the link healed
                    if spec.kind == "flap" and spec.period_s > 0 and \
                            (elapsed % spec.period_s) >= \
                            spec.duty * spec.period_s:
                        continue    # up-phase of the flap cycle
                    chosen = (i, spec, hit)
                    break
                if spec.prob is not None:
                    if self._rngs[i].random() >= spec.prob:
                        continue
                elif not spec.start <= hit < spec.start + spec.count:
                    continue
                if spec.kind in ("corrupt", "malformed_xdr") and not (
                        isinstance(payload, (bytes, bytearray))
                        and payload):
                    # nothing to corrupt at this point: the hit ordinal
                    # was consumed but no fault is injected — counting
                    # it would let injected/log claim an effect that
                    # never happened
                    continue
                if spec.kind == "delay" and not ctx.get("_can_delay"):
                    # same rule for delay: only seams that declare they
                    # can defer delivery (``_can_delay=True`` — the
                    # loopback transport) honor a Delay; elsewhere the
                    # hit passes through UNCOUNTED rather than letting
                    # injected/log claim a delay that never happened
                    continue
                chosen = (i, spec, hit)
                break
            if chosen is not None:
                i, spec, hit = chosen
                key = f"chaos.injected.{spec.kind}"
                self.injected[key] = self.injected.get(key, 0) + 1
                self.log.append((point, i, hit, spec.kind))
                mangled = None
                if spec.kind == "corrupt":
                    pos = self._rngs[i].randrange(len(payload))
                    b = bytearray(payload)
                    b[pos] ^= 0xFF
                    mangled = bytes(b)
                elif spec.kind == "malformed_xdr":
                    # deterministic per-spec-RNG mangling, one of three
                    # shapes beyond the single-byte `corrupt`: the
                    # result must still be handed to the XDR decoder —
                    # a Byzantine peer sends it as a framed message
                    mangled = self._mangle(self._rngs[i], bytes(payload))
        if _observers:
            kind = chosen[1].kind if chosen is not None else None
            spec_or_none = chosen[1] if chosen is not None else None
            for obs in list(_observers):
                obs(point, ctx, kind, spec_or_none)
        if chosen is None:
            return payload
        _, spec, _ = chosen
        log.debug("chaos: injecting %s at %s %s", spec.kind, point, ctx)
        if spec.kind == "io_error":
            raise ChaosError(f"chaos injected io_error at {point}")
        if spec.kind == "crash":
            raise SimulatedCrash(point, ctx)
        if spec.kind == "churn":
            raise SimulatedChurn(point, ctx)
        if spec.kind in ("drop", "partition", "flap"):
            # partition/flap land as DROP at the link seam: the caller
            # severs (or refuses) the connection while the window is
            # open and lets the jittered redial re-knit it after heal
            return DROP
        if spec.kind == "slow_link":
            return Shape(spec.delay_ms / 1000.0, spec.bps)
        if spec.kind == "reorder":
            return REORDER
        if spec.kind == "fail":
            return FAIL
        if spec.kind == "hang":
            # delay-forever: the caller substitutes a handle that never
            # completes, so only a dispatch deadline (the backend
            # supervisor's watchdog) can resolve the operation
            return HANG
        if spec.kind == "equivocate":
            return EQUIVOCATE
        if spec.kind == "bad_sig_flood":
            return BadSigBurst(spec.burst)
        if spec.kind == "delay":
            # virtual time only: the caller schedules delivery on the
            # clock (a real sleep here would stall the whole
            # single-process simulation — see Delay's docstring)
            return Delay(payload, spec.delay_ms / 1000.0)
        if spec.kind in ("corrupt", "malformed_xdr"):
            return mangled
        return payload

    @staticmethod
    def _mangle(rng: random.Random, payload: bytes) -> bytes:
        mode = rng.randrange(3)
        if mode == 0:
            # truncate: length-prefixed XDR arrays now read past the end
            return payload[:rng.randrange(len(payload))]
        if mode == 1:
            # flip several bytes: union discriminants / counts go wild
            b = bytearray(payload)
            for _ in range(min(4, len(b))):
                b[rng.randrange(len(b))] ^= 0xFF
            return bytes(b)
        # inflate: garbage appended past the declared structure
        extra = bytes(rng.randrange(256) for _ in range(8))
        return payload + extra

    # -------------------------------------------------------------- report --
    def status(self) -> dict:
        with self._lock:
            return {
                "enabled": True,
                "seed": self.seed,
                "schedule": [s.to_json() for s in self.schedule],
                "injected": dict(self.injected),
                "points": dict(self.point_hits),
                "log_entries": len(self.log),
            }


# ------------------------------------------------------------ module API --
def install(engine: ChaosEngine) -> None:
    """Enable chaos with `engine`'s schedule. Global and test-gated:
    production configs never call this."""
    global _engine, ENABLED
    _engine = engine
    ENABLED = True
    log.info("chaos engine installed (seed=%d, %d specs)", engine.seed,
             len(engine.schedule))


def uninstall() -> None:
    global _engine, ENABLED
    ENABLED = False
    _engine = None


def engine() -> Optional[ChaosEngine]:
    return _engine


def status() -> dict:
    eng = _engine
    if eng is None:
        return {"enabled": False}
    return eng.status()


def point(name: str, payload=None, **ctx):
    """Fire injection point `name`. Returns `payload` (possibly
    corrupted), or a sentinel (DROP / REORDER / FAIL / HANG), or raises
    (ChaosError / SimulatedCrash / sleeps) per the installed schedule.
    Callers MUST pre-guard with ``if chaos.ENABLED:`` so disabled runs
    pay one attribute read."""
    eng = _engine
    if eng is None:
        return payload
    return eng.fire(name, payload, ctx)
