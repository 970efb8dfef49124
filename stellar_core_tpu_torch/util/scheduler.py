"""Fair multi-queue action scheduler with load shedding.

Reference: src/util/Scheduler.h:100-221. The main thread interleaves overlay,
herder and ledger actions through named queues scheduled by accumulated
virtual runtime (least-run queue goes first); DROPPABLE actions are shed when
their queue's latency exceeds a limit, providing overload protection.
"""

from __future__ import annotations

import time
from collections import deque
from enum import Enum
from typing import Callable, Deque, Dict, Optional, Tuple


class ActionType(Enum):
    NORMAL = 0
    DROPPABLE = 1


class _Queue:
    __slots__ = ("name", "actions", "total_service_time")

    def __init__(self, name: str):
        self.name = name
        # (action, type, enqueue_time)
        self.actions: Deque[Tuple[Callable[[], None], ActionType, float]] = deque()
        self.total_service_time = 0.0


class Scheduler:
    """Fair scheduler over named action queues.

    enqueue(queue_name, action, action_type); run_one() picks the non-empty
    queue with the least accumulated service time and runs one action.
    DROPPABLE actions older than `latency_window` seconds are shed
    (reference: Scheduler::enqueue/runOne, util/Scheduler.cpp).
    """

    def __init__(self, clock=None, latency_window: float = 5.0):
        self._clock = clock
        self._queues: Dict[str, _Queue] = {}
        self.latency_window = latency_window
        # Highest service time across queues; new/idle queues are floored to
        # max - latency_window so they can't monopolize the scheduler
        # (reference: Scheduler.cpp:155,313 minTotalService clamp).
        self._max_total_service = 0.0
        self.stats_actions_enqueued = 0
        self.stats_actions_run = 0
        self.stats_actions_dropped = 0

    def _now(self) -> float:
        return self._clock.now() if self._clock is not None else time.monotonic()

    def enqueue(
        self,
        queue_name: str,
        action: Callable[[], None],
        action_type: ActionType = ActionType.NORMAL,
    ) -> None:
        q = self._queues.get(queue_name)
        if q is None:
            q = self._queues[queue_name] = _Queue(queue_name)
        if not q.actions:
            # queue was idle: floor its service time so it can't starve others
            q.total_service_time = max(
                q.total_service_time,
                self._max_total_service - self.latency_window)
        q.actions.append((action, action_type, self._now()))
        self.stats_actions_enqueued += 1

    def size(self) -> int:
        return sum(len(q.actions) for q in self._queues.values())

    def queue_length(self, queue_name: str) -> int:
        q = self._queues.get(queue_name)
        return len(q.actions) if q is not None else 0

    def _shed(self, q: _Queue, now: float) -> None:
        while q.actions:
            action, atype, t_enq = q.actions[0]
            if atype is ActionType.DROPPABLE and now - t_enq > self.latency_window:
                q.actions.popleft()
                self.stats_actions_dropped += 1
            else:
                break

    def run_one(self) -> int:
        """Run one action from the least-served non-empty queue. Returns 0/1."""
        now = self._now()
        best: Optional[_Queue] = None
        for q in self._queues.values():
            self._shed(q, now)
            if q.actions and (best is None
                              or q.total_service_time < best.total_service_time):
                best = q
        if best is None:
            return 0
        action, _, _ = best.actions.popleft()
        t0 = time.perf_counter()
        try:
            action()
        finally:
            best.total_service_time += time.perf_counter() - t0
            self._max_total_service = max(self._max_total_service,
                                          best.total_service_time)
            self.stats_actions_run += 1
        return 1

    def run_all(self, max_actions: int = 1_000_000) -> int:
        n = 0
        while n < max_actions and self.run_one():
            n += 1
        return n
