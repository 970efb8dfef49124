"""Lightweight performance zones + slow-execution warnings.

Reference: §5.1 of the survey — the reference vendors the Tracy frame
profiler (602 ``ZoneScoped`` annotations, crypto/SecretKey.cpp:431 etc.)
and a ``LogSlowExecution`` scope timer (util/LogSlowExecution.h, used in
closeLedger :711).  Tracy needs a native GUI protocol; the in-process
equivalent is an in-process zone registry: cheap monotonic timers
aggregated per zone (count/total/max), dumped via the admin API or
logged.  CUDA device work is profiled separately with torch.profiler;
these zones cover the host-side runtime.

Each ``Application`` owns a ``ZoneRegistry`` so multi-node in-process
simulations don't cross-contaminate; the module-level helpers use a
process default registry for contexts with no app (CLI tools, library
calls).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional

from . import tracing
from .logging import get_logger

log = get_logger("Perf")


class _ZoneStats:
    __slots__ = ("count", "total", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0


class ZoneRegistry:
    def __init__(self):
        self._zones: Dict[str, _ZoneStats] = {}
        self._lock = threading.Lock()
        # the app's FlightRecorder (util/tracing.py), set by
        # Application: when it is recording, every zone ALSO emits a
        # begin/end span pair so the timeline gets the close phases,
        # completion jobs, bucket merges and verifier batches for free
        self.tracer = None

    @contextmanager
    def zone(self, name: str, targs: Optional[dict] = None):
        """Scoped timing zone (reference: Tracy ZoneScoped). `targs`
        are structured span args (ledger seq, tx count, …) recorded
        only while a trace is on — pass them pre-guarded by
        ``tracing.ENABLED`` so the disabled path allocates nothing."""
        tr = None
        if tracing.ENABLED:
            tr = self.tracer
            if tr is not None and tr.active:
                tr.begin(name, targs)
            else:
                tr = None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if tr is not None:
                tr.end(name)
            with self._lock:
                st = self._zones.get(name)
                if st is None:
                    st = self._zones[name] = _ZoneStats()
                st.count += 1
                st.total += dt
                if dt > st.max:
                    st.max = dt

    @contextmanager
    def zone_into(self, name: str, sink: Optional[dict] = None,
                  targs: Optional[dict] = None):
        """A zone that ALSO accumulates its duration into `sink[name]`
        — the per-close phase breakdown the slow-execution log prints,
        so a 2.5 s stall names the guilty phase instead of one opaque
        number."""
        t0 = time.perf_counter()
        try:
            with self.zone(name, targs=targs):
                yield
        finally:
            if sink is not None:
                sink[name] = sink.get(name, 0.0) + \
                    (time.perf_counter() - t0)

    @contextmanager
    def log_slow_execution(self, name: str,
                           threshold_seconds: float = 1.0,
                           detail: Optional[Callable[[], str]] = None):
        """Warn when a scope overruns (reference:
        util/LogSlowExecution.h). `detail` (evaluated only on overrun)
        appends a breakdown, e.g. the per-phase times of a slow close."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if dt > threshold_seconds:
                extra = ""
                if detail is not None:
                    try:
                        extra = " [%s]" % detail()
                    except Exception:   # noqa: BLE001 — best-effort log
                        pass
                log.warning("performance issue: %s took %.0f ms%s", name,
                            dt * 1000, extra)

    def report(self) -> Dict[str, dict]:
        with self._lock:
            return {
                name: {
                    "count": st.count,
                    "total_ms": round(st.total * 1000, 3),
                    "mean_ms": round(st.total / st.count * 1000, 3)
                    if st.count else 0.0,
                    "max_ms": round(st.max * 1000, 3),
                }
                for name, st in sorted(self._zones.items())
            }

    def reset(self) -> None:
        with self._lock:
            self._zones.clear()


# process-default registry for app-less contexts
default_registry = ZoneRegistry()


def zone(name: str):
    return default_registry.zone(name)


def log_slow_execution(name: str, threshold_seconds: float = 1.0):
    return default_registry.log_slow_execution(name, threshold_seconds)


def zone_report() -> Dict[str, dict]:
    return default_registry.report()


def reset_zones() -> None:
    default_registry.reset()
