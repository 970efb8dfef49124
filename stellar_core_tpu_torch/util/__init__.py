"""Util / runtime layer (reference: src/util — SURVEY.md layer 1)."""

from .timer import VirtualClock, VirtualTimer, ClockMode
from .scheduler import Scheduler, ActionType
from .cache import RandomEvictionCache
from .checks import releaseAssert, AssertionFailed

__all__ = [
    "VirtualClock",
    "VirtualTimer",
    "ClockMode",
    "Scheduler",
    "ActionType",
    "RandomEvictionCache",
    "releaseAssert",
    "AssertionFailed",
]
