"""The traced run's reading of the profiler: device intervals by name, the
idle share of the window, and the idle gaps by what the host was doing.

The harness marks three host spans with `record_function`: `window`
around the measured loop, and inside it `seam` around each dispatch call
and `collect` around each collect; the rest of the window is `harness`.
Every event comes from one `torch.profiler` run over CPU and CUDA
activity, so host spans and device events share one clock.
"""

from __future__ import annotations

HOST_SPANS = ("window", "seam", "collect")


def _span(ev):
    """(start, end) of a kineto event in seconds."""
    if hasattr(ev, "start_ns"):
        return ev.start_ns() * 1e-9, ev.end_ns() * 1e-9
    return ev.start_us() * 1e-6, (ev.start_us() + ev.duration_us()) * 1e-6


def read(prof):
    """(device events [(name, start, end)], host spans {name: [(start,
    end)]}) of a finished profiler run, in seconds on one clock."""
    device, host = [], {name: [] for name in HOST_SPANS}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        kind = str(ev.device_type())
        if name in host:
            # a host span also shows on the device's timeline, as the
            # annotation of the device work inside it: not device work
            if not kind.endswith("CUDA"):
                host[name].append(_span(ev))
        elif kind.endswith("CUDA"):
            device.append((name,) + _span(ev))
    device.sort(key=lambda e: e[1])
    for spans in host.values():
        spans.sort()
    return device, host


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


class Trace:
    """What a traced window shows."""

    def __init__(self, device, host):
        win = host["window"]
        if not win:
            raise ValueError("the trace holds no window span")
        self.lo, self.hi = win[0][0], win[-1][1]
        self.window_s = self.hi - self.lo
        self.device = [(n, s, e) for n, s, e in device
                       if e > self.lo and s < self.hi]
        self.busy = _union(_clip([(s, e) for _, s, e in self.device],
                                 self.lo, self.hi))
        self.busy_s = sum(e - s for s, e in self.busy)
        self.host = {k: _clip(v, self.lo, self.hi) for k, v in host.items()
                     if k != "window"}

    def device_s(self, prefix: str) -> float:
        """Device seconds of the events whose name starts with prefix."""
        return sum(e - s for n, s, e in self.device if n.startswith(prefix))

    def count(self, prefix: str) -> int:
        return sum(1 for n, _, _ in self.device if n.startswith(prefix))

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def device_ops(self, top: int = 10):
        by = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s)
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self):
        """[[what, seconds], ...]: the window's idle time split by the
        host span it overlaps (`seam`, `collect`, else `harness`), and
        the longest idle piece of each (`<what>.longest`)."""
        gaps, t = [], self.lo
        for s, e in self.busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.hi:
            gaps.append((t, self.hi))
        total = {"seam": 0.0, "collect": 0.0, "harness": 0.0}
        longest = dict.fromkeys(total, 0.0)
        for g0, g1 in gaps:
            rest = g1 - g0
            for what in ("seam", "collect"):
                for s, e in _overlaps(self.host[what], g0, g1):
                    total[what] += e - s
                    longest[what] = max(longest[what], e - s)
                    rest -= e - s
            total["harness"] += rest
            longest["harness"] = max(longest["harness"], rest)
        out = [[k, v] for k, v in total.items()]
        out += [[k + ".longest", v] for k, v in longest.items()]
        return sorted(out, key=lambda x: -x[1])[:10]


def _overlaps(spans, lo, hi):
    """The pieces of sorted, disjoint spans inside [lo, hi]."""
    import bisect
    i = max(0, bisect.bisect_left(spans, (lo,)) - 1)
    out = []
    while i < len(spans) and spans[i][0] < hi:
        s, e = spans[i]
        if e > lo:
            out.append((max(s, lo), min(e, hi)))
        i += 1
    return out
