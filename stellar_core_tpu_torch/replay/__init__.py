"""Whole-node deterministic record/replay.

A node's externally-visible nondeterminism is its *inputs*: inbound
wire frames, driver/admin injections, and the chaos engine's injected
faults. Everything else — timers, SCP, ledger close — is a pure
function of those inputs on the VirtualClock (the determinism analyzer
proves the consensus paths wall-clock- and iteration-order-clean).
Recording the inputs therefore makes every run an offline unit test:

- ``replay.log``      — the crash-tolerant framed input-log format
- ``replay.recorder`` — per-Application InputRecorder (hooked at
  Peer.recv_bytes / connect_handler / drop, chaos observers, and the
  external tx/admin submission sites)
- ``replay.replayer`` — rebuilds the node from the recorded config
  snapshot and re-feeds the log on a fresh VirtualClock
- ``replay.scenario`` — the recorded 4-node seeded chaos scenario the
  tier-1 round-trip test and ``bench.py --replay`` share

All four modules are in the determinism analyzer's STRICT scope
(analysis/determinism.py): a wall-clock or RNG read anywhere in this
package is a lint finding, because replay-of-a-replay must be
byte-stable. docs/REPLAY.md is the contract.
"""

from .log import (InputLog, LogRecord, LogWriter, RT_ADMIN, RT_CHAOS,
                  RT_CONN, RT_END, RT_FRAME, RT_INJECT, RT_MACFAIL,
                  RT_PDROP)
from .recorder import InputRecorder
from .replayer import ReplayResult, first_divergence, normalize_trace, replay_log

__all__ = [
    "InputLog", "LogRecord", "LogWriter", "InputRecorder",
    "ReplayResult", "replay_log", "normalize_trace", "first_divergence",
    "RT_CONN", "RT_FRAME", "RT_MACFAIL", "RT_INJECT", "RT_ADMIN",
    "RT_CHAOS", "RT_PDROP", "RT_END",
]
