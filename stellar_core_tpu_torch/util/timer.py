"""VirtualClock / VirtualTimer — the deterministic event loop.

Reference: src/util/Timer.h:64-260. The whole node runs on a single logical
thread cranking a VirtualClock: each crank dispatches due timers, pending I/O
callbacks, and Scheduler actions. In VIRTUAL_TIME mode the clock only advances
when cranked and jumps straight to the next scheduled event, which makes every
test deterministic and lets simulated networks run "at fast simulated time"
(docs/architecture.md:33-36).
"""

from __future__ import annotations

import heapq
import itertools
import threading as _threading
import time as _time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, List, Optional

from . import threads
from .checks import releaseAssert


class ClockMode(Enum):
    REAL_TIME = 0
    VIRTUAL_TIME = 1


# Error type passed to timer callbacks when cancelled, mirroring asio's
# operation_aborted convention the reference uses (util/Timer.h:244-310).
class TimerError(Enum):
    SUCCESS = 0
    CANCELLED = 1


# Crank phase boundaries reported to VirtualClock.crank_hooks. These
# values ARE the wire values of the replay input log's TICK records
# (replay/log.py mirrors them as TICK_*): the recorder writes one TICK
# per boundary and the replayer re-creates the phase machine from them.
CRANK_START = 0     # crank began; posted actions drain next
CRANK_DISPATCH = 1  # io pollers done; due timers dispatch next
CRANK_JUMP = 2      # idle blocked crank advanced virtual time; dispatching
CRANK_END = 3       # crank finished


@dataclass(order=True)
class _Event:
    when: float
    seq: int
    callback: Callable[[TimerError], None] = field(compare=False)
    cancelled: bool = field(default=False, compare=False)


class VirtualClock:
    """Deterministic time source + event dispatcher.

    crank(block=False) executes due work and returns the number of actions
    performed (reference: util/Timer.h:178-184). In VIRTUAL_TIME mode, a crank
    with no due work advances time to the next event.
    """

    def __init__(self, mode: ClockMode = ClockMode.VIRTUAL_TIME):
        self.mode = mode
        self._heap: List[_Event] = []
        self._seq = itertools.count()
        self._virtual_now = 0.0
        self._stopped = False
        # Callables polled every crank for ready work (I/O integration point;
        # the reference integrates asio's io_context here, Timer.h:120-140).
        self._io_pollers: List[Callable[[], int]] = []
        # One-shot actions posted to run "soon" (postToCurrentCrank
        # analogue). Lock-guarded: the admin HTTP server posts from its
        # socket threads (command_handler.run_http_server), and an
        # append racing crank()'s drain swap could silently lose the
        # posted command.
        self._actions: List[Callable[[], None]] = []
        self._actions_lock = _threading.Lock()
        self.scheduler = None  # attached by Application / tests
        # crank-phase observers: each hook is called (phase, now) at
        # every CRANK_* boundary of every crank. The input recorder
        # (replay/recorder.py) rides this to capture clock advances and
        # timer-firing order — intra-instant interleaving is invisible
        # to timestamps alone. Idle cost is one empty-list check.
        self.crank_hooks: List[Callable[[int, float], None]] = []

    # -- time ---------------------------------------------------------------
    def now(self) -> float:
        if self.mode is ClockMode.VIRTUAL_TIME:
            return self._virtual_now
        return _time.monotonic()

    def system_now(self) -> float:
        """Wall-clock seconds since epoch; virtual mode offsets from 0."""
        if self.mode is ClockMode.VIRTUAL_TIME:
            return self._virtual_now
        return _time.time()

    def set_virtual_time(self, t: float) -> None:
        releaseAssert(self.mode is ClockMode.VIRTUAL_TIME,
                      "set_virtual_time requires VIRTUAL_TIME mode")
        releaseAssert(t >= self._virtual_now, "time cannot move backwards")
        self._virtual_now = t

    # -- scheduling ---------------------------------------------------------
    def schedule_at(self, when: float, cb: Callable[[TimerError], None]) -> _Event:
        ev = _Event(when, next(self._seq), cb)
        heapq.heappush(self._heap, ev)
        return ev

    def post(self, action: Callable[[], None]) -> None:
        """Run `action` on the next crank (reference: postToCurrentCrank).
        Thread-safe: HTTP handler threads post admin commands here."""
        with self._actions_lock:
            self._actions.append(action)

    def add_io_poller(self, poller: Callable[[], int]) -> None:
        """Register a callable polled each crank; returns #actions it ran."""
        self._io_pollers.append(poller)

    def remove_io_poller(self, poller: Callable[[], int]) -> None:
        if poller in self._io_pollers:
            self._io_pollers.remove(poller)

    # -- crank loop ---------------------------------------------------------
    # The three phase methods below are public because the JAX
    # package's replayer (replay/replayer.py) re-creates the crank
    # sequence from recorded TICK boundaries instead of calling crank():
    # it drives exactly these phases at exactly the recorded instants.
    def drain_actions(self) -> int:
        """Run every pending posted action (the crank's first phase)."""
        with self._actions_lock:
            actions, self._actions = self._actions, []
        for a in actions:
            a()
        return len(actions)

    def poll_io(self) -> int:
        """Run every registered io poller once (second phase)."""
        n = 0
        for p in list(self._io_pollers):
            n += p()
        return n

    def dispatch_due(self) -> int:
        """Fire every due timer in (when, seq) order (third phase)."""
        return self._dispatch_due()

    def _notify_crank(self, phase: int) -> None:
        now = self.now()
        for h in list(self.crank_hooks):
            h(phase, now)

    def _dispatch_due(self) -> int:
        n = 0
        now = self.now()
        while self._heap and self._heap[0].when <= now:
            ev = heapq.heappop(self._heap)
            if not ev.cancelled:
                ev.callback(TimerError.SUCCESS)
                n += 1
        return n

    def crank(self, block: bool = False) -> int:  # thread-domain: crank
        """One iteration of the main loop; returns number of actions run."""
        if threads.CHECK:
            # whoever cranks IS the logical main thread: posted
            # actions, timers and scheduler work all run under it
            threads.bind("crank")
        if self._stopped:
            return 0
        if self.crank_hooks:
            self._notify_crank(CRANK_START)
        # posted actions first
        n = self.drain_actions()
        # I/O
        n += self.poll_io()
        if self.crank_hooks:
            self._notify_crank(CRANK_DISPATCH)
        # due timers
        n += self._dispatch_due()
        # scheduler actions: at most ONE per crank, as the reference
        # interleaves fairly between queues (util/Scheduler.h:100-221)
        if self.scheduler is not None:
            n += self.scheduler.run_one()
        if n == 0 and block:
            if self.mode is ClockMode.VIRTUAL_TIME:
                nxt = self.next_event_time()
                if nxt is not None:
                    self._virtual_now = max(self._virtual_now, nxt)
                    if self.crank_hooks:
                        self._notify_crank(CRANK_JUMP)
                    n += self._dispatch_due()
            else:
                nxt = self.next_event_time()
                now = self.now()
                if nxt is not None and nxt > now:
                    _time.sleep(min(nxt - now, 0.050))
                elif nxt is None:
                    # nothing scheduled: sleep briefly so real-time run
                    # loops waiting on io pollers don't busy-spin
                    _time.sleep(0.010)
                if self.crank_hooks:
                    self._notify_crank(CRANK_JUMP)
                n += self._dispatch_due()
        if self.crank_hooks:
            self._notify_crank(CRANK_END)
        return n

    def next_event_time(self) -> Optional[float]:
        while self._heap and self._heap[0].cancelled:
            heapq.heappop(self._heap)
        return self._heap[0].when if self._heap else None

    def stop(self) -> None:
        self._stopped = True

    @property
    def stopped(self) -> bool:
        return self._stopped

    # -- test helpers (reference: Simulation::crankUntil) --------------------
    def crank_until(self, pred: Callable[[], bool], timeout: float) -> bool:
        deadline = self.now() + timeout
        while not pred():
            if self.now() > deadline:
                return False
            if self.crank(block=True) == 0 and self.next_event_time() is None:
                if self.scheduler is not None and self.scheduler.size() > 0:
                    continue
                return pred()
        return True

    def crank_for(self, duration: float) -> int:
        """Crank until `duration` seconds elapse; returns actions run.

        Events scheduled beyond the window do NOT fire; in virtual mode the
        clock lands exactly on `now + duration`.
        """
        deadline = self.now() + duration
        total = 0
        if self.mode is ClockMode.VIRTUAL_TIME:
            while True:
                n = self.crank(block=False)
                total += n
                if n == 0:
                    nxt = self.next_event_time()
                    if nxt is not None and nxt <= deadline:
                        self._virtual_now = max(self._virtual_now, nxt)
                    else:
                        break
            self._virtual_now = max(self._virtual_now, deadline)
        else:
            while self.now() < deadline:
                total += self.crank(block=True)
        return total


class VirtualTimer:
    """One-shot timer bound to a VirtualClock (reference: util/Timer.h:244).

    expires_from_now(d) + async_wait(cb, on_cancel) schedules cb on expiry;
    cancel() invokes on_cancel (if given) and drops cb — the (onSuccess,
    onFailure) pair mirrors the reference's VirtualTimer::async_wait overload.
    """

    def __init__(self, clock: VirtualClock):
        self._clock = clock
        self._event: Optional[_Event] = None
        self._cancel_cb: Optional[Callable[[], None]] = None
        self._deadline: Optional[float] = None

    def expires_from_now(self, seconds: float) -> None:
        self.cancel()
        self._deadline = self._clock.now() + seconds

    def expires_at(self, when: float) -> None:
        self.cancel()
        self._deadline = when

    def async_wait(
        self,
        cb: Callable[[], None],
        on_cancel: Optional[Callable[[], None]] = None,
    ) -> None:
        releaseAssert(self._event is None, "timer already armed")
        releaseAssert(self._deadline is not None,
                      "timer not armed: call expires_* first")
        self._cancel_cb = on_cancel

        def wrapped(err: TimerError) -> None:
            self._event = None
            if err is TimerError.SUCCESS:
                cb()

        self._event = self._clock.schedule_at(self._deadline, wrapped)

    def cancel(self) -> None:
        if self._event is not None:
            self._event.cancelled = True
            self._event = None
            if self._cancel_cb is not None:
                cb, self._cancel_cb = self._cancel_cb, None
                cb()

    @property
    def armed(self) -> bool:
        return self._event is not None
