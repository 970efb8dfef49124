"""Partitioned logging (reference: src/util/Logging.h + util/LogPartitions.def).

The reference routes spdlog through 14 named partitions with per-partition
runtime-adjustable levels (CLI `--ll`, HTTP `ll` endpoint). We mirror that on
top of the stdlib logging module.
"""

from __future__ import annotations

import logging as _pylogging
from typing import Dict

from .checks import releaseAssert

# reference: util/LogPartitions.def; "default" is the unpartitioned
# spdlog default logger the plain LOG(...) macros use
PARTITIONS = [
    "Fs", "SCP", "Bucket", "Database", "History", "Process", "Ledger",
    "Overlay", "Herder", "Tx", "LoadGen", "Work", "Invariant", "Perf",
    "Chaos", "Query", "Replay", "default",
]

_LEVELS = {
    "trace": 5,
    "debug": _pylogging.DEBUG,
    "info": _pylogging.INFO,
    "warning": _pylogging.WARNING,
    "error": _pylogging.ERROR,
    "fatal": _pylogging.CRITICAL,
    "none": _pylogging.CRITICAL + 10,
}
_pylogging.addLevelName(5, "TRACE")

_loggers: Dict[str, _pylogging.Logger] = {}


def get_logger(partition: str) -> _pylogging.Logger:
    releaseAssert(partition in PARTITIONS, f"unknown log partition {partition}")
    lg = _loggers.get(partition)
    if lg is None:
        lg = _pylogging.getLogger(f"stellar.{partition}")
        _loggers[partition] = lg
    return lg


def set_log_level(level: str, partition: str | None = None) -> None:
    """Set one or all partitions' levels (reference: Logging::setLogLevel)."""
    lvl = _LEVELS[level.lower()]
    targets = [partition] if partition else PARTITIONS
    for p in targets:
        get_logger(p).setLevel(lvl)


_FMT = "%(asctime)s [%(name)s %(levelname)s] %(message)s"

_COLORS = {"WARNING": "\x1b[33m", "ERROR": "\x1b[31m",
           "CRITICAL": "\x1b[41m", "INFO": "\x1b[32m"}


class _ColorFormatter(_pylogging.Formatter):
    """ANSI level colors (reference: LOG_COLOR, Config.h)."""

    def format(self, record):
        out = super().format(record)
        color = _COLORS.get(record.levelname)
        return f"{color}{out}\x1b[0m" if color else out


def init_logging(level: str = "info", log_file_path: str = "",
                 color: bool = False) -> None:
    """Configure handlers (reference: Logging::init + LOG_FILE_PATH /
    LOG_COLOR Config fields — file handler in addition to console)."""
    _pylogging.basicConfig(format=_FMT)
    root = _pylogging.getLogger()
    if color:
        for h in root.handlers:
            h.setFormatter(_ColorFormatter(_FMT))
    if log_file_path:
        fh = _pylogging.FileHandler(log_file_path)
        fh.setFormatter(_pylogging.Formatter(_FMT))
        root.addHandler(fh)
    set_log_level(level)


# CLOG_* macro analogues
def clog(partition: str, level: str, msg: str, *args) -> None:
    get_logger(partition).log(_LEVELS[level], msg, *args)
