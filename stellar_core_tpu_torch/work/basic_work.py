"""Async task-DAG framework: the BasicWork state machine.

Reference: src/work/BasicWork.{h,cpp} — states PENDING → RUNNING ⇄
WAITING → SUCCESS/FAILURE/ABORTED with RETRYING between failures, retry
policies RETRY_NEVER/ONCE/A_FEW/A_LOT with exponential backoff
(BasicWork.h:96-248). Works crank cooperatively: `crank_work` calls
`on_run` which returns the next internal state; WAITING works are woken
by `wakeUp` (timer or event driven).
"""

from __future__ import annotations

from enum import Enum
from typing import Callable, Optional

from ..util.logging import get_logger
from ..util.timer import VirtualTimer

log = get_logger("Work")

RETRY_NEVER = 0
RETRY_ONCE = 1
RETRY_A_FEW = 5
RETRY_A_LOT = 32


class State(Enum):
    # reference: BasicWork::State (public states)
    WORK_RUNNING = 0
    WORK_WAITING = 1
    WORK_SUCCESS = 2
    WORK_FAILURE = 3
    WORK_ABORTED = 4


class InternalState(Enum):
    PENDING = 0
    RUNNING = 1
    WAITING = 2
    RETRYING = 3
    ABORTING = 4
    ABORTED = 5
    SUCCESS = 6
    FAILURE = 7


class BasicWork:
    def __init__(self, app, name: str, max_retries: int = RETRY_A_FEW):
        self.app = app
        self.name = name
        self.max_retries = max_retries
        self._state = InternalState.PENDING
        self._retries = 0
        self._retry_timer: Optional[VirtualTimer] = None
        self._notify_parent: Optional[Callable[[], None]] = None

    # -------------------------------------------------------------- status --
    def get_state(self) -> State:
        s = self._state
        if s in (InternalState.PENDING, InternalState.RUNNING):
            return State.WORK_RUNNING
        if s == InternalState.RETRYING:
            # dormant until the retry timer fires — anything cranking on
            # "is it RUNNING?" must park and wait for the wake notify, or
            # the event loop busy-spins and virtual time never advances
            # to the retry deadline (reference: BasicWork::getState maps
            # RETRYING to WAITING)
            return State.WORK_WAITING
        if s == InternalState.WAITING:
            return State.WORK_WAITING
        if s == InternalState.ABORTING:
            return State.WORK_RUNNING
        if s == InternalState.SUCCESS:
            return State.WORK_SUCCESS
        if s == InternalState.ABORTED:
            return State.WORK_ABORTED
        return State.WORK_FAILURE

    def is_done(self) -> bool:
        return self._state in (InternalState.SUCCESS, InternalState.FAILURE,
                               InternalState.ABORTED)

    def get_status(self) -> str:
        return f"{self.name}: {self._state.name}"

    # ----------------------------------------------------------- lifecycle --
    def start_work(self, notify_parent: Optional[Callable[[], None]] = None
                   ) -> None:
        assert self._state == InternalState.PENDING
        self._notify_parent = notify_parent
        self._retries = 0
        self.on_reset()
        self._state = InternalState.RUNNING

    def ensure_started(self, notify_parent: Optional[Callable[[], None]]
                       = None) -> None:
        """Idempotent start: begin a still-PENDING work, else no-op —
        for owners that lazily crank a child from several code paths."""
        if self._state == InternalState.PENDING:
            self.start_work(notify_parent)

    def crank_work(self) -> None:
        """One step; only meaningful while RUNNING."""
        if self._state != InternalState.RUNNING:
            return
        try:
            next_state = self.on_run()
        except Exception as e:
            log.error("work %s raised: %s", self.name, e)
            next_state = State.WORK_FAILURE
        self._transition(next_state)

    def shutdown(self) -> None:
        if self.is_done():
            return
        if self._retry_timer is not None:
            self._retry_timer.cancel()
            self._retry_timer = None
        self.on_abort()
        self._state = InternalState.ABORTED
        self._notify()

    def wake_up(self) -> None:
        """WAITING → RUNNING (reference: BasicWork::wakeUp)."""
        if self._state == InternalState.WAITING:
            self._state = InternalState.RUNNING
            self._notify()

    # ------------------------------------------------------------ override --
    def on_run(self) -> State:
        raise NotImplementedError

    def on_reset(self) -> None:
        pass

    def on_abort(self) -> None:
        pass

    def on_failure_raise(self) -> None:
        pass

    def on_success(self) -> None:
        pass

    # ------------------------------------------------------------ internal --
    def _transition(self, next_state: State) -> None:
        if next_state == State.WORK_RUNNING:
            self._state = InternalState.RUNNING
            self._notify()
        elif next_state == State.WORK_WAITING:
            self._state = InternalState.WAITING
        elif next_state == State.WORK_SUCCESS:
            self._state = InternalState.SUCCESS
            self.on_success()
            self._notify()
        elif next_state == State.WORK_ABORTED:
            self._state = InternalState.ABORTED
            self._notify()
        else:  # failure: maybe retry
            if self._retries < self.max_retries:
                self._schedule_retry()
            else:
                self._state = InternalState.FAILURE
                self.on_failure_raise()
                self._notify()

    def _schedule_retry(self) -> None:
        self._state = InternalState.RETRYING
        delay = self.get_retry_delay()
        self._retries += 1
        log.debug("work %s retry %d/%d in %.1fs", self.name, self._retries,
                  self.max_retries, delay)
        timer = VirtualTimer(self.app.clock)
        timer.expires_from_now(delay)

        def fire():
            self._retry_timer = None
            if self._state == InternalState.RETRYING:
                self.on_reset()
                self._state = InternalState.RUNNING
                self._notify()

        timer.async_wait(fire)
        self._retry_timer = timer

    def get_retry_delay(self) -> float:
        """Exponential backoff 1,2,4..32s (reference:
        BasicWork::getRetryETA / computeDelay)."""
        return float(min(2 ** self._retries, 32))

    def _notify(self) -> None:
        if self._notify_parent is not None:
            self._notify_parent()
