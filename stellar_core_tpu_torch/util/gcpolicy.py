"""CPython GC policy: keep full-heap collections off the close path.

Measured on the reference's TPSMT leg: automatic generation-2
collections scanned the whole multi-app heap for 50-1600 ms apiece —
16.2 s of a 50 s measured window — and freed approximately nothing
(0-710 objects per pass), because the live set (ledger state, XDR type
tables, bucket indexes) only grows. Those pauses landed inside
`closeLedger` (the 3 s `fees`-phase outliers in the close-phase
report) and inside the overlay crank, where they also expire
single-flight FLOOD_DEMANDs that were answered promptly.

Policy (process-wide, installed once by the first Application):

- gen0/gen1 stay automatic — young-object churn is cheap to collect
  and actually yields garbage;
- the startup heap is frozen (`gc.freeze`) into the permanent
  generation so no future full collection re-walks imports, XDR type
  tables and constant pools;
- automatic gen2 collection is pushed out (threshold 1e6 instead of
  the heuristic) — a full scan may only run when something asks for
  it deliberately;
- `maintenance_collect()` runs the explicit full pass from the
  Maintainer's cron (reference: Maintainer::performMaintenance
  cadence, i.e. history-GC time, never close time) so reference
  cycles from long runs still get reclaimed.
"""

from __future__ import annotations

import gc

from .logging import get_logger

log = get_logger("Perf")

_installed = False


def install() -> bool:
    """Idempotent, process-wide. Returns True on the first install."""
    global _installed
    if _installed:
        return False
    _installed = True
    gc.collect()
    # everything alive at first-app construction is effectively
    # immortal (modules, XDR metaclass tables, jitted callables):
    # keep gen2 from ever re-scanning it
    gc.freeze()
    t0, t1, _t2 = gc.get_threshold()
    gc.set_threshold(t0, t1, 1_000_000)
    log.debug("gc policy installed: startup heap frozen, automatic "
              "full collections disabled")
    return True


def maintenance_collect() -> int:
    """Explicit full collection for maintenance windows (the sanctioned
    full-heap pass once `install` ran — the permanent generation stays
    excluded, so this scans only what the process allocated since
    startup). No re-freeze: freezing live node state (entry caches,
    flow-control queues) would make it immortal when it later becomes
    garbage. Returns the number of collected objects."""
    return gc.collect()


# reclaim cadence for app teardown: a full pass per shutdown measured
# ~150s across the 900-test suite (hundreds of app churns), while the
# leak window of deferring is a handful of dead app graphs — collect
# on the Nth teardown, not every one
TEARDOWN_COLLECT_EVERY = 8
_teardowns = 0


def teardown_collect(force: bool = False) -> int:
    """Application.shutdown hook: with automatic full collections
    disabled, torn-down apps' reference cycles (app↔herder↔overlay
    back-pointers) must be reclaimed HERE or a process that builds
    many short-lived apps — the test suite, multi-leg bench runs —
    accumulates every dead app until exit. Throttled to every
    `TEARDOWN_COLLECT_EVERY`th shutdown: the deferred window is a few
    dead app graphs, the saving is one full heap scan per test."""
    global _teardowns
    _teardowns += 1
    if not force and _teardowns % TEARDOWN_COLLECT_EVERY:
        return 0
    return gc.collect()
