"""Metrics registry — counters / meters / timers / histograms.

Reference: libmedida (lib/libmedida) as catalogued in docs/metrics.md (e.g.
`ledger.transaction.apply` timer, `scp.envelope.receive`, `overlay.flood.*`).
Exposed over the HTTP admin `metrics` endpoint and resettable via
`clearmetrics` (main/CommandHandler.cpp:114).
"""

from __future__ import annotations

import bisect
import math
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .checks import releaseAssert


class Counter:
    def __init__(self):
        self.count = 0

    def inc(self, n: int = 1) -> None:
        self.count += n

    def dec(self, n: int = 1) -> None:
        self.count -= n

    def set_count(self, n: int) -> None:
        self.count = n

    def reset(self) -> None:
        self.count = 0

    def to_json(self) -> dict:
        return {"type": "counter", "count": self.count}


class Meter:
    """Event rate meter with 1m/5m/15m EWMA rates (medida::Meter)."""

    _ALPHAS = {"1m": 1 - math.exp(-5.0 / 60),
               "5m": 1 - math.exp(-5.0 / 300),
               "15m": 1 - math.exp(-5.0 / 900)}

    def __init__(self, event_type: str = "event"):
        self.count = 0
        self.event_type = event_type
        self._rates = {k: 0.0 for k in self._ALPHAS}
        self._rates_initialized = False
        self._uncounted = 0
        self._start = self._last_tick = time.monotonic()

    def reset(self) -> None:
        self.__init__(self.event_type)

    def mark(self, n: int = 1) -> None:
        self._maybe_tick()
        self.count += n
        self._uncounted += n

    def _maybe_tick(self) -> None:
        now = time.monotonic()
        elapsed = now - self._last_tick
        if elapsed >= 5.0:
            ticks = int(elapsed // 5.0)
            inst = self._uncounted / elapsed
            self._uncounted = 0
            if not self._rates_initialized:
                # seed EWMAs with the first observed rate (Codahale/medida
                # convention) so early readings aren't ~alpha-times too low
                for k in self._ALPHAS:
                    self._rates[k] = inst
                self._rates_initialized = True
                ticks -= 1
                inst = 0.0
            for _ in range(min(ticks, 200)):
                for k, a in self._ALPHAS.items():
                    self._rates[k] += a * (inst - self._rates[k])
                inst = 0.0 if ticks > 1 else inst
            self._last_tick = now

    def mean_rate(self) -> float:
        dt = time.monotonic() - self._start
        return self.count / dt if dt > 0 else 0.0

    def one_minute_rate(self) -> float:
        self._maybe_tick()
        return self._rates["1m"]

    def five_minute_rate(self) -> float:
        self._maybe_tick()
        return self._rates["5m"]

    def fifteen_minute_rate(self) -> float:
        self._maybe_tick()
        return self._rates["15m"]

    def to_json(self) -> dict:
        # all three EWMA windows the meter already computes (medida
        # emits 1m/5m/15m; only surfacing 1m hid the slower windows
        # from the admin API and the Prometheus exposition)
        self._maybe_tick()
        return {"type": "meter", "count": self.count,
                "mean_rate": self.mean_rate(),
                "1_min_rate": self._rates["1m"],
                "5_min_rate": self._rates["5m"],
                "15_min_rate": self._rates["15m"]}


class Histogram:
    """Reservoir-sampled histogram (uniform reservoir,
    medida::Histogram); with `window_seconds` set, percentiles/mean/
    min/max reflect only the sliding window (reference:
    HISTOGRAM_WINDOW_SIZE — medida's sliding-window sample)."""

    def __init__(self, reservoir: int = 1028, seed: int = 0,
                 window_seconds: Optional[float] = None):
        self._reservoir = reservoir
        self._sample: List[float] = []
        self.count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._rng = random.Random(seed)
        self._window = window_seconds
        # bounded like medida's sliding-window sample: the window keeps
        # at most _reservoir recent events, so hot per-tx timers cannot
        # grow without bound
        self._events = deque(maxlen=reservoir)

    def reset(self) -> None:
        self._sample = []
        self.count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._events.clear()

    def update(self, value: float) -> None:
        self.count += 1
        self._sum += value
        self._min = min(self._min, value)
        self._max = max(self._max, value)
        if self._window is not None:
            now = time.monotonic()
            self._events.append((now, value))
            self._prune(now)
            return
        if len(self._sample) < self._reservoir:
            bisect.insort(self._sample, value)
        else:
            i = self._rng.randrange(self.count)
            if i < self._reservoir:
                del self._sample[self._rng.randrange(len(self._sample))]
                bisect.insort(self._sample, value)

    def _prune(self, now: float) -> None:
        cutoff = now - self._window
        ev = self._events
        while ev and ev[0][0] < cutoff:
            ev.popleft()

    def _window_values(self) -> List[float]:
        self._prune(time.monotonic())
        return sorted(v for _, v in self._events)

    @staticmethod
    def _pctl(sample: List[float], q: float) -> float:
        if not sample:
            return 0.0
        idx = min(len(sample) - 1, int(q * len(sample)))
        return sample[idx]

    def percentile(self, q: float) -> float:
        sample = self._window_values() if self._window is not None \
            else self._sample
        return self._pctl(sample, q)

    def mean(self) -> float:
        if self._window is not None:
            vals = self._window_values()
            return sum(vals) / len(vals) if vals else 0.0
        return self._sum / self.count if self.count else 0.0

    def to_json(self) -> dict:
        # "sum" is the LIFETIME total either way: the Prometheus
        # summary convention is windowed quantiles over a cumulative
        # _count/_sum pair — a windowed mean times a lifetime count
        # would make the exported _sum non-monotonic
        if self._window is not None:
            # ONE sort serves every stat, and min/max/mean reflect the
            # window like the percentiles do (lifetime totals would
            # contradict the window semantics operators read)
            vals = self._window_values()
            return {"type": "histogram", "count": self.count,
                    "sum": self._sum,
                    "mean": sum(vals) / len(vals) if vals else 0.0,
                    "min": vals[0] if vals else 0,
                    "max": vals[-1] if vals else 0,
                    "median": self._pctl(vals, 0.5),
                    "75%": self._pctl(vals, 0.75),
                    "99%": self._pctl(vals, 0.99)}
        return {"type": "histogram", "count": self.count,
                "sum": self._sum, "mean": self.mean(),
                "min": self._min if self.count else 0,
                "max": self._max if self.count else 0,
                "median": self.percentile(0.5),
                "75%": self.percentile(0.75), "99%": self.percentile(0.99)}


# cumulative-histogram bucket bounds for timers, in seconds: sub-ms
# verify flushes up to multi-second closes. Fixed process-wide so the
# exported `_bucket` families can be SUMMED across nodes — the whole
# point of exporting them (summary quantiles cannot be aggregated)
TIMER_BUCKET_BOUNDS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                       0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Timer(Histogram):
    """Duration metric: histogram of seconds + throughput meter.

    Besides the reservoir/window sample (summary quantiles), every
    update also lands in a fixed-bound cumulative bucket array —
    exported as a Prometheus `histogram` family (`_bucket{le=…}`)
    that, unlike the summary, aggregates across nodes."""

    def __init__(self, window_seconds: Optional[float] = None):
        super().__init__(window_seconds=window_seconds)
        self.meter = Meter()
        self._bucket_counts = [0] * (len(TIMER_BUCKET_BOUNDS) + 1)

    def reset(self) -> None:
        super().reset()
        self.meter.reset()
        self._bucket_counts = [0] * (len(TIMER_BUCKET_BOUNDS) + 1)

    def update(self, seconds: float) -> None:  # type: ignore[override]
        super().update(seconds)
        self.meter.mark()
        self._bucket_counts[
            bisect.bisect_left(TIMER_BUCKET_BOUNDS, seconds)] += 1

    def time_scope(self):
        return _TimerScope(self)

    def to_json(self) -> dict:
        j = super().to_json()
        j["type"] = "timer"
        j["rate"] = self.meter.to_json()
        # cumulative counts per le-bound; the implicit +Inf bucket is
        # the lifetime count (Prometheus histogram convention)
        cum = []
        running = 0
        for c in self._bucket_counts[:-1]:
            running += c
            cum.append(running)
        j["buckets"] = {"le": list(TIMER_BUCKET_BOUNDS),
                        "cumulative": cum}
        return j


class _TimerScope:
    def __init__(self, timer: Timer):
        self._timer = timer

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._timer.update(time.perf_counter() - self._t0)
        return False


class MetricsRegistry:
    """Dotted-name metric registry (reference: medida::MetricsRegistry)."""

    def __init__(self, window_minutes: Optional[float] = None):
        self._metrics: Dict[str, object] = {}
        # completion worker and crank both create metrics lazily; the
        # lock closes the create-create race (a lost metric object
        # would silently drop its counts)
        self._lock = threading.Lock()
        # reference: HISTOGRAM_WINDOW_SIZE (minutes) — applied to every
        # histogram/timer created through this registry
        self.window_seconds = (window_minutes * 60.0
                               if window_minutes else None)

    def _get(self, name: str, cls, *args, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = cls(*args, **kw)
        releaseAssert(type(m) is cls, f"metric {name} type mismatch")
        return m

    def new_counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def new_meter(self, name: str, event_type: str = "event") -> Meter:
        return self._get(name, Meter, event_type)

    def new_timer(self, name: str) -> Timer:
        return self._get(name, Timer,
                         window_seconds=self.window_seconds)

    def new_histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram,
                         window_seconds=self.window_seconds)

    # medida-style multi-part names: NewTimer({"ledger","transaction","apply"})
    def counter(self, *parts: str) -> Counter:
        return self.new_counter(".".join(parts))

    def meter(self, *parts: str) -> Meter:
        return self.new_meter(".".join(parts))

    def timer(self, *parts: str) -> Timer:
        return self.new_timer(".".join(parts))

    def histogram(self, *parts: str) -> Histogram:
        return self.new_histogram(".".join(parts))

    def to_json(self) -> dict:
        return {name: m.to_json() for name, m in sorted(self._metrics.items())}

    def clear(self) -> None:
        """Reset every metric IN PLACE (reference: clearMetrics clears
        each medida metric, it does not deregister). Subsystems cache
        metric objects at construction (apply/close timers, the e2e
        timer, per-peer meters); emptying the registry dict would
        orphan those references — still counting, never reported."""
        for m in self._metrics.values():
            m.reset()


# ------------------------------------------------- Prometheus exposition --

def _prom_name(name: str) -> str:
    """Sanitize a dotted medida name into a Prometheus metric name:
    `ledger.transaction.apply` → `ledger_transaction_apply`."""
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    if out and not (out[0].isalpha() or out[0] in "_:"):
        out = "_" + out
    return out


def _prom_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"') \
                .replace("\n", "\\n")


def _prom_num(v) -> str:
    f = float(v)
    if f != f:                       # NaN never reaches a scraper
        return "0"
    return repr(f) if not float(f).is_integer() else str(int(f))


def render_prometheus(metrics_json: Dict[str, dict],
                      zones: Optional[Dict[str, dict]] = None) -> str:
    """Render a MetricsRegistry.to_json() document (plus an optional
    ZoneRegistry.report()) in Prometheus text exposition format 0.0.4,
    for `metrics?format=prometheus` scraping.

    Mapping: counters are gauges (ours can dec); meters are a
    `<name>_total` counter plus `<name>_rate{window=…}` gauges; timers
    and histograms are summaries — quantiles as labeled samples plus
    `_count`/`_sum` (timers in seconds, `_seconds` suffix). Perf zones
    ride along as three labeled gauge families keyed by `zone=`.
    """
    lines: List[str] = []

    def family(pname: str, mtype: str, help_text: str) -> None:
        lines.append(f"# HELP {pname} {help_text}")
        lines.append(f"# TYPE {pname} {mtype}")

    for name in sorted(metrics_json):
        doc = metrics_json[name]
        p = _prom_name(name)
        t = doc.get("type")
        if t == "counter":
            family(p, "gauge", f"counter {name}")
            lines.append(f"{p} {_prom_num(doc['count'])}")
        elif t == "meter":
            family(f"{p}_total", "counter", f"meter {name} event count")
            lines.append(f"{p}_total {_prom_num(doc['count'])}")
            family(f"{p}_rate", "gauge",
                   f"meter {name} rates (events/sec)")
            lines.append(f'{p}_rate{{window="mean"}} '
                         f"{_prom_num(doc['mean_rate'])}")
            for window in ("1_min", "5_min", "15_min"):
                if f"{window}_rate" in doc:
                    lines.append(
                        f'{p}_rate{{window="{window[:-4]}m"}} '
                        f"{_prom_num(doc[f'{window}_rate'])}")
        elif t in ("timer", "histogram"):
            unit = "_seconds" if t == "timer" else ""
            family(f"{p}{unit}", "summary",
                   f"{t} {name}" + (" (seconds)" if unit else ""))
            for label, key in (("0.5", "median"), ("0.75", "75%"),
                               ("0.99", "99%")):
                lines.append(f'{p}{unit}{{quantile="{label}"}} '
                             f"{_prom_num(doc[key])}")
            lines.append(f"{p}{unit}_count {_prom_num(doc['count'])}")
            total = doc.get("sum", doc["mean"] * doc["count"])
            lines.append(f"{p}{unit}_sum {_prom_num(total)}")
            if t == "timer" and "buckets" in doc:
                # cumulative histogram family beside the summary: the
                # summary's quantile labels cannot be aggregated across
                # nodes, the fixed-bound buckets can (kept as a SEPARATE
                # `_hist` family — one family cannot be TYPEd twice)
                b = doc["buckets"]
                family(f"{p}{unit}_hist", "histogram",
                       f"timer {name} cumulative histogram (seconds)")
                for bound, c in zip(b["le"], b["cumulative"]):
                    lines.append(
                        f'{p}{unit}_hist_bucket{{le="{_prom_num(bound)}"'
                        f"}} {_prom_num(c)}")
                lines.append(f'{p}{unit}_hist_bucket{{le="+Inf"}} '
                             f"{_prom_num(doc['count'])}")
                lines.append(
                    f"{p}{unit}_hist_count {_prom_num(doc['count'])}")
                lines.append(f"{p}{unit}_hist_sum {_prom_num(total)}")
            if t == "timer":
                rate = doc.get("rate", {})
                family(f"{p}_rate", "gauge",
                       f"timer {name} throughput (events/sec)")
                for window, key in (("mean", "mean_rate"),
                                    ("1m", "1_min_rate"),
                                    ("5m", "5_min_rate"),
                                    ("15m", "15_min_rate")):
                    if key in rate:
                        lines.append(f'{p}_rate{{window="{window}"}} '
                                     f"{_prom_num(rate[key])}")
    if zones:
        family("perf_zone_count", "gauge",
               "perf zone hit count (util/perf.py)")
        for zname in sorted(zones):
            lines.append(f'perf_zone_count{{zone="{_prom_label(zname)}"}}'
                         f' {_prom_num(zones[zname]["count"])}')
        family("perf_zone_total_seconds", "gauge",
               "perf zone cumulative time")
        for zname in sorted(zones):
            lines.append(
                f'perf_zone_total_seconds{{zone="{_prom_label(zname)}"}} '
                f"{_prom_num(zones[zname]['total_ms'] / 1000.0)}")
        family("perf_zone_max_seconds", "gauge",
               "perf zone worst single hit")
        for zname in sorted(zones):
            lines.append(
                f'perf_zone_max_seconds{{zone="{_prom_label(zname)}"}} '
                f"{_prom_num(zones[zname]['max_ms'] / 1000.0)}")
    return "\n".join(lines) + "\n"
