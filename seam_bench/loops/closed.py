"""The closed loop: a traffic file with `"loop": "closed"`.

Keeps `in_flight` dispatches out: dispatch i + 1 goes out before i is
collected, and a new one goes out as soon as one is collected, until
the window closes; then what is out is collected. The batches are
dispatched in turn.
"""

from __future__ import annotations

import contextlib
from collections import deque
from time import perf_counter


def warm_up(seam, corpus, traffic, verdicts):
    """Every batch once, in the cell's own pattern, and the in-flight
    pattern filled twice over."""
    count = len(corpus.batches) + 2 * int(traffic["in_flight"])
    drive(seam, corpus, traffic, verdicts, float("inf"), count=count)


def drive(seam, corpus, traffic, verdicts, t_end, count=None, mark=None,
          run=None):
    """Dispatch until `t_end` (or until `count` dispatches), then collect
    what is out. `mark(name)` wraps each call in a host span (traced
    runs); `run` records each dispatch's batch and times."""
    mark = mark or (lambda name: contextlib.nullcontext())
    in_flight = int(traffic["in_flight"])
    batches, dispatch = corpus.batches, seam.dispatch
    nb = len(batches)
    pending = deque()
    i = 0
    while True:
        while len(pending) < in_flight and (count is None or i < count) \
                and perf_counter() < t_end:
            b = i % nb
            i += 1
            t0 = perf_counter()
            with mark("seam"):
                h = dispatch(batches[b])
            pending.append((b, t0, perf_counter(), h))
        if not pending:
            return
        b, t0, t1, h = pending.popleft()
        with mark("collect"):
            v = h()
        t2 = perf_counter()
        verdicts.take(b, v)
        if run is not None:
            run.batch.append(b)
            run.t_call.append(t0)
            run.t_return.append(t1)
            run.t_collect.append(t2)
