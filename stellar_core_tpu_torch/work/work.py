"""Work with children, the scheduler, and the common combinators.

Reference: src/work/Work.{h,cpp} (children + doWork), WorkScheduler
(cranks from the VirtualClock), WorkSequence, BatchWork (bounded
parallelism), ConditionalWork, WorkWithCallback.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional

from ..util.logging import get_logger
from .basic_work import BasicWork, InternalState, RETRY_A_FEW, State

log = get_logger("Work")


class Work(BasicWork):
    """A work with children: runs children first, then its own doWork
    (reference: Work::onRun crankChild logic)."""

    def __init__(self, app, name: str, max_retries: int = RETRY_A_FEW):
        super().__init__(app, name, max_retries)
        self._children: List[BasicWork] = []

    def add_work(self, child: BasicWork) -> BasicWork:
        child.start_work(self.wake_up)
        self._children.append(child)
        return child

    def has_children(self) -> bool:
        return bool(self._children)

    def all_children_successful(self) -> bool:
        return all(c.get_state() == State.WORK_SUCCESS
                   for c in self._children)

    def all_children_done(self) -> bool:
        return all(c.is_done() for c in self._children)

    def any_child_failed(self) -> bool:
        return any(c.get_state() == State.WORK_FAILURE
                   for c in self._children)

    def on_run(self) -> State:
        # crank internally-RUNNING children; RETRYING/WAITING children
        # wake us via their notify callback when they resume
        progressed = False
        for child in self._children:
            if child._state == InternalState.RUNNING:
                child.crank_work()
                progressed = True
        if self.any_child_failed():
            return self.on_child_failure()
        if not self.all_children_done():
            return State.WORK_RUNNING if progressed else State.WORK_WAITING
        return self.do_work()

    def on_child_failure(self) -> State:
        return State.WORK_FAILURE

    def do_work(self) -> State:
        """Own logic once children are done (reference: Work::doWork)."""
        return State.WORK_SUCCESS

    def on_abort(self) -> None:
        for child in self._children:
            child.shutdown()

    def on_reset(self) -> None:
        self._children = []
        self.do_reset()

    def do_reset(self) -> None:
        pass


class WorkScheduler(BasicWork):
    """Root of the work tree, cranked from the clock (reference:
    work/WorkScheduler.{h,cpp})."""

    def __init__(self, app):
        super().__init__(app, "work-scheduler", max_retries=0)
        self._works: List[BasicWork] = []
        self.start_work()
        app.clock.add_io_poller(self._poll)

    def schedule(self, work: BasicWork) -> BasicWork:
        work.start_work()
        self._works.append(work)
        return work

    def _poll(self) -> int:
        n = 0
        for work in list(self._works):
            if work._state == InternalState.RUNNING:
                work.crank_work()
                n += 1
            if work.is_done():
                self._works.remove(work)
        return n

    def on_run(self) -> State:
        return State.WORK_WAITING

    def shutdown(self) -> None:
        for work in self._works:
            work.shutdown()
        self._works = []
        self.app.clock.remove_io_poller(self._poll)
        super().shutdown()


class WorkSequence(BasicWork):
    """Run works strictly in order (reference: work/WorkSequence)."""

    def __init__(self, app, name: str, sequence: List[BasicWork],
                 max_retries: int = 0):
        super().__init__(app, name, max_retries)
        self._sequence = sequence
        self._index = 0

    def on_run(self) -> State:
        if self._index >= len(self._sequence):
            return State.WORK_SUCCESS
        current = self._sequence[self._index]
        if current._state == InternalState.PENDING:
            current.start_work(self.wake_up)
        if current._state == InternalState.RUNNING:
            current.crank_work()
            return State.WORK_RUNNING
        state = current.get_state()
        if state in (State.WORK_WAITING, State.WORK_RUNNING):
            return State.WORK_WAITING  # retrying/waiting child wakes us
        if state == State.WORK_SUCCESS:
            self._index += 1
            return State.WORK_RUNNING
        return State.WORK_FAILURE

    def on_abort(self) -> None:
        if self._index < len(self._sequence):
            self._sequence[self._index].shutdown()


class BatchWork(Work):
    """Yield-based bounded-parallel spawner (reference: work/BatchWork —
    keeps up to MAX_CONCURRENT children in flight from an iterator)."""

    MAX_CONCURRENT = 8

    def __init__(self, app, name: str):
        super().__init__(app, name, max_retries=0)

    def yield_more_work(self) -> Optional[BasicWork]:
        """Return the next child, or None when exhausted."""
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def do_work(self) -> State:
        # children (if any) all succeeded; top up the batch
        while self.has_next() and \
                len([c for c in self._children if not c.is_done()]) \
                < self.MAX_CONCURRENT:
            nxt = self.yield_more_work()
            if nxt is None:
                break
            self.add_work(nxt)
        if self._children and not self.all_children_done():
            return State.WORK_RUNNING
        if self.has_next():
            return State.WORK_RUNNING
        if self.any_child_failed():
            return State.WORK_FAILURE
        return State.WORK_SUCCESS


class ConditionalWork(BasicWork):
    """Gate a work behind a predicate (reference: work/ConditionalWork)."""

    def __init__(self, app, name: str, condition: Callable[[], bool],
                 work: BasicWork):
        super().__init__(app, name, max_retries=0)
        self._condition = condition
        self._work = work
        self._started = False

    def on_run(self) -> State:
        if not self._started:
            if not self._condition():
                return State.WORK_WAITING
            self._work.start_work(self.wake_up)
            self._started = True
        if self._work._state == InternalState.RUNNING:
            self._work.crank_work()
            return State.WORK_RUNNING
        state = self._work.get_state()
        if state in (State.WORK_WAITING, State.WORK_RUNNING):
            return State.WORK_WAITING
        return state

    def on_abort(self) -> None:
        if self._started:
            self._work.shutdown()


class WorkWithCallback(BasicWork):
    def __init__(self, app, name: str, cb: Callable[[], bool]):
        super().__init__(app, name, max_retries=0)
        self._cb = cb

    def on_run(self) -> State:
        try:
            ok = self._cb()
        except Exception as e:
            log.error("callback work %s failed: %s", self.name, e)
            return State.WORK_FAILURE
        return State.WORK_SUCCESS if ok else State.WORK_FAILURE


def run_work_to_completion(app, work: BasicWork,
                           timeout_virtual: float = 600.0) -> State:
    """Test/CLI helper: schedule and crank until done."""
    scheduler = getattr(app, "work_scheduler", None)
    owns = scheduler is None
    if owns:
        scheduler = WorkScheduler(app)
    scheduler.schedule(work)
    deadline = app.clock.now() + timeout_virtual
    while not work.is_done() and app.clock.now() < deadline:
        if app.clock.crank(False) == 0:
            app.clock.crank(True)
    if owns:
        app.clock.remove_io_poller(scheduler._poll)
    return work.get_state()
