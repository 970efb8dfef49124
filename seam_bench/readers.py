"""What the metric files under metrics/ read from a run (harness.Run).

Each returns the number, or None where the run holds nothing to read
it from (an untraced run, a trace without the kernel's events, a window
that completed nothing): the harness then leaves the metric out.
"""

from __future__ import annotations

import statistics

from . import bounds


def verifies_per_s(run):
    """Signatures whose verdicts came back inside the window, per second
    of the window."""
    return len(run.in_window()) * run.rows / run.seconds


def setup_s(run):
    """Process start to the window's first dispatch."""
    return run.setup_s


def host_dispatch_ms(run):
    """Mean host wall of the dispatch call, until it returns, over the
    window's dispatches."""
    if not run.t_call:
        return None
    return statistics.fmean(r - c for c, r in zip(run.t_call, run.t_return)) \
        * 1e3


def _traced(run, prefix):
    """Device seconds of the kernel events with this name prefix, where
    there is one event per dispatch of the traced window."""
    t = run.trace
    if t is None or run.imad_per_s is None or not run.batch:
        return None
    if t.count(prefix) != len(run.batch):
        return None
    s = t.device_s(prefix)
    return s if s > 0 else None


def prep_roofline(run):
    """Prep's bound (products the rows need at the card's IMAD rate) over
    the device time of its events, in %."""
    s = _traced(run, "ed25519_prep")
    if s is None:
        return None
    per_row = bounds.prep_products(int(run.cell.config["message_bytes"]))
    bound_s = per_row * run.rows * len(run.batch) / run.imad_per_s
    return 100.0 * bound_s / s


def ladder_roofline(run):
    """The ladder's bound over the device time of its events, in %."""
    s = _traced(run, "ed25519_ladder")
    if s is None:
        return None
    products = sum(run.ladder_products(b) for b in run.batch)
    return 100.0 * products / run.imad_per_s / s


def device_idle(run):
    """Share of the traced window in which no device event ran, in %."""
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * run.trace.idle_share()
