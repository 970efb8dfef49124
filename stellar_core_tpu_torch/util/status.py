"""Rolling node-status strings (reference: src/util/StatusManager.h).

Subsystems publish one current status line each (history catchup progress,
out-of-sync notices, ...) surfaced through the HTTP `info` endpoint.
"""

from __future__ import annotations

from enum import Enum
from typing import Dict


class StatusCategory(Enum):
    HISTORY_CATCHUP = "history-catchup"
    HISTORY_PUBLISH = "history-publish"
    NTP = "ntp"
    OUT_OF_SYNC_RECOVERY = "out-of-sync"
    REQUIRES_UPGRADES = "requires-upgrades"


class StatusManager:
    def __init__(self):
        self._status: Dict[StatusCategory, str] = {}

    def set_status(self, cat: StatusCategory, msg: str) -> None:
        self._status[cat] = msg

    def remove_status(self, cat: StatusCategory) -> None:
        self._status.pop(cat, None)

    def get_status(self, cat: StatusCategory) -> str:
        return self._status.get(cat, "")

    def to_list(self) -> list:
        return [f"{c.value}: {m}" for c, m in self._status.items()]
