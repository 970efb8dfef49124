"""Flight recorder: event-level span tracing with Chrome-trace export.

Reference: the Tracy frame profiler the reference vendors (602
``ZoneScoped`` annotations, zone values carrying the ledger seq —
SURVEY.md §5.1). Tracy needs a native GUI protocol; the shippable
Python analogue is an in-process ring buffer of begin/end span events
(thread id, monotonic timestamp, structured args) dumped as Chrome
trace-event JSON, loadable in Perfetto / chrome://tracing.

Layering: ``util/perf.py``'s ZoneRegistry keeps the cheap always-on
count/total/max aggregates; when a FlightRecorder is recording, every
zone ALSO emits a begin/end event pair here, so the ``ledger.close.*``
phases, completion-queue jobs, bucket merges and device-verifier
batches appear on the timeline for free. Subsystems without zones
(overlay send/recv, SCP lifecycle, tx end-to-end tracks) instrument
directly against their Application's recorder.

Cost contract (mirrors ``chaos.ENABLED``): when no recorder in the
process is recording — the default, always in production — every
instrumented site executes exactly one module-level constant check
(``if tracing.ENABLED:``) and nothing else: no config lookup, no
function call, no allocation. ``FlightRecorder.start()`` /``stop()``
are the sole writers of the constant (refcounted: multi-node in-process
simulations record several apps at once).

Each ``Application`` owns one FlightRecorder so multi-node simulations
don't cross-contaminate; the recorder's ``pid``/``label`` separate
nodes into distinct Perfetto process tracks.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

# ---------------------------------------------------------------- guard --
# Module-level constant guard: instrumented hot paths check ONLY this
# before paying anything. _retain()/_release() are the sole writers.
ENABLED = False
_active_count = 0
_state_lock = threading.Lock()

# default ring capacity: ~256k events ≈ tens of seconds of a busy node,
# a few MB of tuples — bounded no matter how long a trace stays on
DEFAULT_CAPACITY = 262_144


def _retain() -> None:
    global ENABLED, _active_count
    with _state_lock:
        _active_count += 1
        ENABLED = True


def _release() -> None:
    global ENABLED, _active_count
    with _state_lock:
        _active_count = max(0, _active_count - 1)
        if _active_count == 0:
            ENABLED = False


class FlightRecorder:
    """Per-Application ring buffer of trace events.

    Events are compact tuples ``(ph, name, ts, tid, args, id)`` with
    ``ph`` one of the Chrome trace-event phases we emit:

    - ``"B"``/``"E"`` — nested span begin/end on a thread track;
    - ``"i"`` — instant event (a point in time, e.g. one overlay send);
    - ``"b"``/``"e"`` — async track begin/end correlated by ``id``
      across threads (the tx end-to-end latency track).

    Appends are lock-free (deque append is atomic); the buffer is a
    ring, so a long recording keeps the newest events and counts what
    it overwrote.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 label: str = "", pid: int = 1):
        self.active = False
        self.label = label
        self.pid = pid
        self._capacity = capacity
        self._buf: deque = deque(maxlen=capacity)
        self._t0 = 0.0
        self._t0_wall = 0.0
        self._appended = 0
        self._lock = threading.Lock()   # start/stop/dump, not append

    # ----------------------------------------------------------- control --
    def start(self, capacity: Optional[int] = None) -> None:
        """Begin recording (admin route ``starttrace``). Clears any
        previous recording; flips the process-wide ENABLED constant."""
        with self._lock:
            if capacity is not None and capacity != self._capacity:
                self._capacity = max(1, capacity)
                self._buf = deque(maxlen=self._capacity)
            else:
                self._buf.clear()
            self._appended = 0
            self._t0 = time.perf_counter()
            # wall-clock anchor of the same instant: separate PROCESSES
            # have incomparable perf_counter domains, so the multi-
            # process trace merge aligns dumptrace exports by this
            # (util/tracemerge.merge_trace_docs)
            self._t0_wall = time.time()
            if not self.active:
                self.active = True
                _retain()

    def stop(self) -> dict:
        """Stop recording; the buffer stays dumpable until the next
        start(). Returns a summary for the admin route."""
        with self._lock:
            if self.active:
                self.active = False
                _release()
            return {"events": len(self._buf), "dropped": self.dropped,
                    "capacity": self._capacity}

    @property
    def dropped(self) -> int:
        return max(0, self._appended - len(self._buf))

    @property
    def t0(self) -> float:
        """perf_counter at the last start(): the zero of this
        recorder's timestamps. Recorders started at different times
        disagree on zero; util/tracemerge.py aligns a multi-node
        capture by shifting each node's events by (t0 - min t0)."""
        return self._t0

    def __len__(self) -> int:
        return len(self._buf)

    # ---------------------------------------------------------- recording --
    # Callers MUST pre-guard with ``if tracing.ENABLED:`` (and check
    # ``.active`` when several recorders share the process) so disabled
    # runs pay one module-constant read.
    def begin(self, name: str, args: Optional[dict] = None) -> None:
        self._appended += 1
        self._buf.append(("B", name, time.perf_counter() - self._t0,
                          threading.get_ident(), args, None))

    def end(self, name: Optional[str] = None) -> None:
        self._appended += 1
        self._buf.append(("E", name, time.perf_counter() - self._t0,
                          threading.get_ident(), None, None))

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        self._appended += 1
        self._buf.append(("i", name, time.perf_counter() - self._t0,
                          threading.get_ident(), args, None))

    def async_begin(self, name: str, correlation_id: str,
                    args: Optional[dict] = None) -> None:
        """Open an async span correlated by id — begin and end may land
        on different threads (tx submit → externalize)."""
        self._appended += 1
        self._buf.append(("b", name, time.perf_counter() - self._t0,
                          threading.get_ident(), args, correlation_id))

    def async_end(self, name: str, correlation_id: str,
                  args: Optional[dict] = None) -> None:
        self._appended += 1
        self._buf.append(("e", name, time.perf_counter() - self._t0,
                          threading.get_ident(), args, correlation_id))

    # ------------------------------------------------------------ export --
    def to_chrome_trace(self) -> dict:
        """Render the buffer as a Chrome trace-event JSON document
        (Perfetto / chrome://tracing / `scripts/trace_report.py`).

        The ring can orphan events (a "B" overwritten while its "E"
        survived, or spans still open at dump time); the dump
        reconciles per-thread so every emitted "B" has a matching "E"
        and per-thread timestamps are non-decreasing — consumers never
        see a malformed nesting.
        """
        with self._lock:
            events = sorted(self._buf, key=lambda e: e[2])
        out: List[dict] = []
        thread_names = {t.ident: t.name for t in threading.enumerate()}
        out.append({"ph": "M", "name": "process_name", "pid": self.pid,
                    "tid": 0, "args": {
                        "name": self.label or "stellar-core-tpu"}})
        named: set = set()
        open_stacks: Dict[int, List[dict]] = {}
        max_ts = events[-1][2] if events else 0.0
        for ph, name, ts, tid, args, cid in events:
            if tid not in named:
                named.add(tid)
                out.append({"ph": "M", "name": "thread_name",
                            "pid": self.pid, "tid": tid,
                            "args": {"name": thread_names.get(
                                tid, "thread-%d" % tid)}})
            ev = {"ph": ph, "name": name, "pid": self.pid, "tid": tid,
                  "ts": round(ts * 1e6, 3)}
            if ph == "B":
                ev["args"] = args or {}
                open_stacks.setdefault(tid, []).append(ev)
            elif ph == "E":
                stack = open_stacks.get(tid)
                if not stack:
                    continue        # orphaned end (begin overwritten)
                opened = stack.pop()
                if name is None:
                    ev["name"] = opened["name"]
            elif ph == "i":
                ev["s"] = "t"       # thread-scoped instant
                ev["args"] = args or {}
            else:                   # async b/e
                ev["cat"] = name.split(".", 1)[0]
                ev["id"] = cid
                ev["args"] = args or {}
            out.append(ev)
        # close anything still open, innermost first, at the dump edge
        for tid, stack in open_stacks.items():
            while stack:
                opened = stack.pop()
                out.append({"ph": "E", "name": opened["name"],
                            "pid": self.pid, "tid": tid,
                            "ts": round(max_ts * 1e6, 3)})
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              # cross-process merge metadata: label and
                              # wall-clock zero let merge_trace_docs
                              # align exports from separate node
                              # processes (in-process merges keep using
                              # the shared perf_counter t0)
                              "label": self.label,
                              "pid": self.pid,
                              "t0_wall": self._t0_wall}}


# process-default recorder for app-less contexts (CLI tools, scripts);
# mirrors perf.default_registry
default_recorder = FlightRecorder()
