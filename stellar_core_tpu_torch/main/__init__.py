"""Application layer: Config, Application facade, admin API, node state.

Reference: src/main — SURVEY.md §1 layer 10.
"""

from .application import Application, AppState
from .config import Config, QuorumSetConfig, get_test_config
from .persistent_state import PersistentState, StateEntry

__all__ = [
    "Application", "AppState", "Config", "QuorumSetConfig",
    "get_test_config", "PersistentState", "StateEntry",
]
