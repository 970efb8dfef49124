"""Async task-DAG framework (reference: src/work)."""

from .basic_work import (BasicWork, RETRY_A_FEW, RETRY_A_LOT, RETRY_NEVER,
                         RETRY_ONCE, State)
from .work import (BatchWork, ConditionalWork, Work, WorkScheduler,
                   WorkSequence, WorkWithCallback, run_work_to_completion)

__all__ = ["BasicWork", "Work", "WorkScheduler", "WorkSequence",
           "BatchWork", "ConditionalWork", "WorkWithCallback", "State",
           "RETRY_NEVER", "RETRY_ONCE", "RETRY_A_FEW", "RETRY_A_LOT",
           "run_work_to_completion"]
