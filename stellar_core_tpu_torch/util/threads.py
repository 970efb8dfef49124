"""Thread-domain declarations + opt-in runtime affinity assertions.

The JAX package's static analyzer (stellar_core_tpu/analysis/,
docs/ANALYSIS.md)
propagates *declared* thread domains through the call graph to find
cross-thread writes at analysis time. This module closes the loop at
runtime: entry points bind their thread to the declared domain, and
domain-sensitive code asserts it is running where the declaration says
it runs — so a wrong declaration (which would silently weaken the
static race check) fails a sim test instead of lying forever.

Domain names are the same four the analyzer knows, plus the worker
domains that grew since:

- ``crank``              the single logical main thread (VirtualClock)
- ``http``               admin-API socket threads (command_handler)
- ``completion-worker``  CloseCompletionQueue's FIFO worker
- ``verify-collect``     backend supervisor watchdog / collect helpers
- ``catchup-worker``     _AsyncResult batch-resolve threads
- ``pg-writer``          pg_stub's replication writer
- ``apply-worker``       staged-apply pool (ledger/parallel_apply.py)

Cost contract (same as ``chaos.ENABLED`` / ``tracing.ENABLED``): every
instrumented site pre-guards with ``if threads.CHECK:`` — one
module-constant check and nothing else when disabled, which is the
default everywhere outside debug/sim runs. ``enable()``/``disable()``
are the sole writers of CHECK, mirroring chaos.install/uninstall.

Static declaration convention (what the analyzer reads): a structured
comment on the entry point's ``def`` line, or the line directly above:

    def _run(self):  # thread-domain: completion-worker
        if threads.CHECK:
            threads.bind("completion-worker")

The comment is the declaration; the guarded ``bind`` makes it true at
runtime. Keep them adjacent so neither can drift alone.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Tuple

# ---------------------------------------------------------------- guard --
# Module-level constant guard: instrumented sites check ONLY this.
# enable()/disable() are the sole writers; SC_THREAD_CHECK=1 turns it
# on at import for whole-process debug runs.
CHECK = os.environ.get("SC_THREAD_CHECK", "") == "1"

# the declared-domain universe (analysis/domains.py validates against it)
DOMAINS = ("crank", "http", "completion-worker", "verify-collect",
           "catchup-worker", "pg-writer", "cluster-poll", "apply-worker",
           "query-worker")

_tls = threading.local()

# violations observed while raise_on_violation is False (sim tests that
# want to crank to completion and assert an empty list at the end)
_violations: list = []
_violations_lock = threading.Lock()
_raise = True


class ThreadDomainViolation(AssertionError):
    """Code declared for one domain executed on a thread bound to
    another. The static analyzer's domain propagation trusts the
    declarations — fix the declaration or the call path, never the
    assertion."""


def enable(raise_on_violation: bool = True) -> None:
    """Turn affinity checking on (debug builds / sim tests only)."""
    global CHECK, _raise
    _raise = raise_on_violation
    with _violations_lock:
        _violations.clear()
    CHECK = True


def disable() -> None:
    global CHECK
    CHECK = False
    with _violations_lock:
        _violations.clear()


def violations() -> list:
    """Violations recorded since enable() (raise_on_violation=False)."""
    with _violations_lock:
        return list(_violations)


def bind(domain: str) -> None:
    """Bind the calling thread to `domain` (entry points only).

    Rebinding the same thread is fine — the crank loop binds every
    crank, HTTP handler threads bind every request.
    """
    if domain not in DOMAINS:
        raise ValueError(f"unknown thread domain {domain!r}; "
                         f"add it to threads.DOMAINS")
    _tls.domain = domain


def current() -> Optional[str]:
    """The calling thread's bound domain, or None if never bound."""
    return getattr(_tls, "domain", None)


def assert_domain(*allowed: str) -> None:
    """Assert the calling thread is bound to one of `allowed`.

    Unbound threads pass: binding is opt-in per entry point, and an
    assertion must not fail just because a test drives the code
    directly from an undeclared pytest thread.
    """
    got = getattr(_tls, "domain", None)
    if got is None or got in allowed:
        return
    site = _caller_site()
    msg = (f"thread-domain violation at {site[0]}:{site[1]}: running in "
           f"{got!r}, declared for {allowed!r} — fix the declaration or "
           f"route the call through clock.post(...)")
    if _raise:
        raise ThreadDomainViolation(msg)
    with _violations_lock:
        _violations.append(msg)


def _caller_site() -> Tuple[str, int]:
    import inspect
    frame = inspect.currentframe()
    try:
        # assert_domain -> _caller_site: caller is two frames up
        f = frame.f_back.f_back if frame and frame.f_back else None
        if f is None:
            return ("<unknown>", 0)
        return (f.f_code.co_filename, f.f_lineno)
    finally:
        del frame
