"""Telemetry time-series: a bounded ring of periodic metric snapshots.

Every metric surface before this was a point-in-time snapshot — the
`metrics`/`clusterstatus` routes answer "what is the p99 NOW", the
flight recorder answers "what happened in THIS span". This module adds
the time dimension (Dean & Barroso, *The Tail at Scale*, CACM 2013:
tail behavior must be watched continuously, not sampled once): a
``TelemetrySampler`` periodically snapshots the node's health signals
— close/tx-e2e/slot-phase quantiles, verify-service occupancy and
queue depth, breaker state, flood duplicate ratio, per-dispatch device
batch size + padding waste, host loadavg — into a bounded
``TimeSeries`` ring.

Clock discipline: the sampler rides a recurring ``VirtualTimer`` on
the application clock, so an in-process simulation samples on the
VirtualClock (deterministic: the series and every SLO verdict derived
from it replay bit-identically under a seeded scenario) and a `run`
node samples on the wall clock. Samples are cheap — a handful of
windowed-timer reads — and the ring is strictly bounded, so telemetry
can stay always-on in production.

Scrape contract (the `timeseries` admin route): every sample carries a
monotonically increasing ``cursor`` within an ``epoch`` that changes on
process restart and on ``clearmetrics``. A scraper passes the opaque
``cursor`` token from the previous reply as ``since=``; the node
returns only newer samples — or the full buffer with ``reset: true``
when the epoch changed (restart, metrics clear) or the asked-for
cursor already fell off the ring. ``simulation/cluster.py`` polls this
per node into a merged cluster-wide series for CLUSTER artifacts.

Consumers: the `timeseries`/`slo` admin routes (main/command_handler),
the SLO watchdog (ops/slo.py observes every appended sample), bench
artifact summaries (bench.py), and the multi-process cluster harness.
"""

from __future__ import annotations

import itertools
import os
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

DEFAULT_CAPACITY = 600          # 10 minutes at the 1 Hz default period
DEFAULT_PERIOD_S = 1.0

_epoch_counter = itertools.count(1)


def _new_epoch() -> str:
    """Unique per (process, clear) epoch token: a restarted node or a
    cleared ring must invalidate every outstanding scrape cursor —
    pid + boot-millis + an in-process counter make collisions across
    restarts practically impossible."""
    return "%x.%x.%d" % (os.getpid(), time.time_ns() // 1_000_000,
                         next(_epoch_counter))


class TimeSeries:
    """Bounded ring of samples with epoch/cursor scrape bookkeeping.

    ``append`` stamps each sample with the next cursor; when the ring
    is full the oldest sample is evicted (counted in ``dropped`` — the
    scrape contract reports the loss, it never blocks the writer)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = max(1, int(capacity))
        self._ring: deque = deque()
        self.epoch = _new_epoch()
        self._next_cursor = 1
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._ring)

    def append(self, sample: dict) -> int:
        cursor = self._next_cursor
        self._next_cursor += 1
        sample["cursor"] = cursor
        self._ring.append(sample)
        if len(self._ring) > self.capacity:
            self._ring.popleft()
            self.dropped += 1
        return cursor

    def samples(self) -> List[dict]:
        return list(self._ring)

    def latest(self) -> Optional[dict]:
        return self._ring[-1] if self._ring else None

    def cursor_token(self) -> str:
        """Opaque resume token for the NEXT scrape: epoch + the last
        assigned cursor (not last-retained — an evicted tail must not
        be re-served)."""
        return f"{self.epoch}:{self._next_cursor - 1}"

    def since(self, token: Optional[str]
              ) -> Tuple[List[dict], bool]:
        """Samples newer than `token` (an earlier ``cursor_token()``).
        Returns ``(samples, reset)``: ``reset`` is True when the token
        was absent/foreign-epoch/fallen-off-the-ring — the full buffer
        is returned and the scraper must treat it as a fresh start."""
        if not token:
            return self.samples(), True
        epoch, _, cur = token.rpartition(":")
        try:
            cur = int(cur)
        except ValueError:
            return self.samples(), True
        if epoch != self.epoch:
            return self.samples(), True
        if self._ring and cur < self._ring[0]["cursor"] - 1:
            # the asked-for continuation point was evicted: serve the
            # whole ring and say so, rather than silently gap the series
            return self.samples(), True
        return [s for s in self._ring if s["cursor"] > cur], False

    def to_doc(self, since: Optional[str] = None,
               limit: Optional[int] = None) -> dict:
        samples, reset = self.since(since)
        truncated = False
        if limit is not None and 0 <= limit < len(samples):
            # serve the OLDEST `limit` of the newer samples, and point
            # the reply cursor at the last one actually served — the
            # next scrape continues from there. Truncating the head
            # while advancing the cursor to the newest sample would be
            # a permanent silent gap, the one thing this contract
            # promises never to do.
            samples = samples[:limit]
            truncated = True
        if samples:
            cursor = f"{self.epoch}:{samples[-1]['cursor']}"
        elif truncated and not reset:
            cursor = since       # limit=0: scraper stays where it was
        elif reset:
            # nothing served AND no valid continuation point (foreign
            # epoch / eviction with limit=0): resume from the ring start
            cursor = f"{self.epoch}:0"
        else:
            cursor = self.cursor_token()       # caught up
        return {
            "epoch": self.epoch,
            "cursor": cursor,
            "capacity": self.capacity,
            "dropped": self.dropped,
            "reset": reset,
            "truncated": truncated,
            "samples": samples,
        }

    def clear(self) -> None:
        """`clearmetrics` hook: empty the ring AND rotate the epoch so
        every outstanding scrape cursor resyncs from scratch — bench
        legs sharing one process start each window from a clean slate,
        and a scraper that cached `epoch:cursor` gets `reset: true` on
        its next poll instead of a silent gap."""
        self._ring.clear()
        self.dropped = 0
        self.epoch = _new_epoch()
        self._next_cursor = 1


# ------------------------------------------------------------- sampling --

def timer_quantiles(metrics, name: str) -> dict:
    """Windowed quantiles of one timer, ms. THE shared read
    discipline for per-timer health snapshots (clusterstatus route,
    telemetry samples): get-or-create keeps the families stable from
    boot, and reading the six-or-so consumed timers directly avoids a
    full registry to_json() (which would sort every reservoir) per
    poll."""
    doc = metrics.new_timer(name).to_json()
    if not doc.get("count"):
        return {"count": 0}
    return {"count": doc["count"],
            "median_ms": round(doc["median"] * 1000, 3),
            "p99_ms": round(doc["99%"] * 1000, 3),
            "max_ms": round(doc["max"] * 1000, 3)}


def collect_sample(app) -> dict:
    """One telemetry snapshot of an Application. Every field is read
    defensively: a node without an overlay / verify service / device
    backend simply omits that section (None), and the SLO rules treat
    a missing value as OK."""
    m = app.metrics
    sample: dict = {
        "t": round(app.clock.now(), 3),
        "wall": time.time(),
        "ledger": app.ledger_manager.get_last_closed_ledger_num(),
        "pending_txs": app.herder.tx_queue.size_txs(),
        # cumulative applied-tx count: the controller's per-tx close
        # cost estimate reads Δtx_applied/Δledger between samples
        "tx_applied": m.new_meter("ledger.transaction.count").count,
        "close": timer_quantiles(m, "ledger.ledger.close"),
        "tx_e2e": timer_quantiles(m, "ledger.transaction.e2e"),
        "slot_p99_ms": {
            p: timer_quantiles(m, "scp.slot." + p).get("p99_ms", 0.0)
            for p in ("nominate", "prepare", "confirm", "total")},
    }
    # verify service: batch occupancy + live queue depth (Clipper's
    # first-class monitored signals — occupancy and queue wait)
    svc = getattr(app, "verify_service", None)
    if svc is not None:
        occ = svc._occupancy.to_json()
        qw = svc._queue_wait.to_json()
        depth = svc.queue_depth()
        sample["verify"] = {
            "flushes": occ["count"],
            "occupancy_p99": occ["99%"] if occ["count"] else 0,
            # submit→dispatch wait p99 — the AIMD latency signal the
            # adaptive controller searches against (ops/controller.py)
            "queue_wait_p99_ms": round(qw["99%"] * 1000, 3)
            if qw.get("count") else 0.0,
            "queue_pending": depth["pending"],
            "queue_inflight": depth["inflight"],
        }
    else:
        sample["verify"] = None
    # per-dispatch device accounting (ops/verifier.py): batch size,
    # padding waste, dispatch wall time — the per-device telemetry
    # ROADMAP item 1's per-device breaker consumes
    bt = m.new_histogram("crypto.verify.dispatch.batch").to_json()
    if bt.get("count"):
        pad = m.new_histogram(
            "crypto.verify.dispatch.padding").to_json()
        wall = m.new_timer("crypto.verify.dispatch.wall").to_json()
        padded_lanes = bt["sum"] + pad["sum"]
        sample["dispatch"] = {
            "count": bt["count"],
            "batch_p50": bt["median"],
            "batch_p99": bt["99%"],
            "pad_waste_ratio": round(
                pad["sum"] / padded_lanes, 4) if padded_lanes else 0.0,
            "wall_p99_ms": round(wall["99%"] * 1000, 3)
            if wall.get("count") else 0.0,
        }
    else:
        sample["dispatch"] = None
    # breaker state (ops/backend_supervisor.py): level, not flow —
    # breaker_open is the numeric form the OPEN-dwell SLO rule reads.
    # The aggregate is OPEN only when the WHOLE mesh is unavailable; a
    # partially degraded mesh reads CLOSED here and shows in `mesh`
    # (devices vs active), which the adaptive controller scales its
    # capacity estimate by (ops/controller.py, replay-deterministic
    # because it reads the sample, not the live supervisor).
    sup = getattr(app, "batch_verifier", None)
    if sup is not None and hasattr(sup, "breaker_state"):
        sample["breaker"] = sup.state
        sample["breaker_open"] = 1.0 if sup.state == "OPEN" else 0.0
        mesh = sup.mesh_status()
        sample["mesh"] = {"devices": mesh["devices"],
                          "active": mesh["active"]}
    else:
        sample["breaker"] = None
        sample["breaker_open"] = 0.0
        sample["mesh"] = None
    prop = getattr(app, "propagation", None)
    if prop is not None:
        rep = prop.report()
        sample["flood"] = {k: rep[k] for k in
                           ("unique", "duplicates", "duplicate_ratio")}
    else:
        sample["flood"] = None
    # read-serving tier (query/): read latency quantiles feed the
    # read_p99 SLO rule; queue depth + shed/hedge tallies feed the
    # controller's read ladder and the ops routes
    qsvc = getattr(app, "query_service", None)
    if qsvc is not None:
        q = timer_quantiles(m, "query.read.latency") or {}
        st = qsvc.stats()
        sample["query"] = {
            "count": q.get("count", 0),
            "p50_ms": q.get("median_ms", 0.0),
            "p99_ms": q.get("p99_ms", 0.0),
            "queue": st["queue"],
            "p95_estimate_ms": st["p95_estimate_ms"],
            "shed": st["shed"],
            "hedge": st["hedge"],
            "timeouts": st["timeouts"],
        }
        snaps = getattr(app, "snapshots", None)
        if snaps is not None:
            # telemetry cadence is where the heavy pinned recount runs
            snaps.refresh_pinned_gauge()
            sample["query"]["snapshots"] = snaps.stats()
    else:
        sample["query"] = None
    try:
        load1 = os.getloadavg()[0]
    except (AttributeError, OSError):            # pragma: no cover
        load1 = 0.0
    sample["host"] = {"load1": round(load1, 2),
                      "ncpu": os.cpu_count() or 1}
    return sample


class TelemetrySampler:
    """Periodic snapshot pump: a recurring VirtualTimer on the app
    clock appends ``collect_sample(app)`` to the ring and feeds every
    registered observer (the SLO watchdog). ``period_s=0`` leaves the
    timer unarmed — ``sample_now()`` still works, which is how the
    manual-close benches and virtual-time tests drive deterministic
    sampling without a recurring event on the clock heap."""

    def __init__(self, app, capacity: int = DEFAULT_CAPACITY,
                 period_s: float = DEFAULT_PERIOD_S):
        self._app = app
        self.period_s = max(0.0, float(period_s))
        self.series = TimeSeries(capacity)
        self.observers: List[Callable[[dict], None]] = []
        self._timer = None
        self._stopped = False

    # ----------------------------------------------------------- sampling --
    def sample_now(self) -> dict:
        sample = collect_sample(self._app)
        self.series.append(sample)
        for obs in self.observers:
            obs(sample)
        return sample

    def _fire(self) -> None:
        from ..main.application import AppState
        if self._stopped or \
                self._app.state == AppState.APP_STOPPING_STATE:
            # a crashed/stopping node must not keep a recurring event
            # on the (possibly shared) simulation clock forever
            return
        try:
            self.sample_now()
        except Exception:                        # noqa: BLE001
            # telemetry must never take the node down; the next fire
            # retries with whatever subsystem state then exists
            from .logging import get_logger
            get_logger("default").debug(
                "telemetry sample failed", exc_info=True)
        self._arm()

    def _arm(self) -> None:
        from .timer import VirtualTimer
        if self._timer is None:
            self._timer = VirtualTimer(self._app.clock)
        self._timer.expires_from_now(self.period_s)
        self._timer.async_wait(self._fire)

    # ---------------------------------------------------------- lifecycle --
    def start(self) -> None:
        if self.period_s > 0 and not self._stopped:
            self._arm()

    def stop(self) -> None:
        self._stopped = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def clear(self) -> None:
        self.series.clear()


# ------------------------------------------------------------ summaries --

def summarize_samples(samples: List[dict]) -> dict:
    """Bounded per-node series summary for bench artifacts: the
    attributable facts (host-load envelope, worst tails, queue/backoff
    evidence) without shipping the whole ring into a committed JSON."""
    if not samples:
        return {"samples": 0}
    loads = [s["host"]["load1"] for s in samples if s.get("host")]
    closes = [s["close"]["p99_ms"] for s in samples
              if s.get("close", {}).get("count")]
    e2es = [s["tx_e2e"]["p99_ms"] for s in samples
            if s.get("tx_e2e", {}).get("count")]
    depths = [s["verify"]["queue_pending"] for s in samples
              if s.get("verify")]
    dups = [s["flood"]["duplicate_ratio"] for s in samples
            if s.get("flood")]
    pads = [s["dispatch"]["pad_waste_ratio"] for s in samples
            if s.get("dispatch")]
    out = {
        "samples": len(samples),
        "span_s": round(samples[-1]["t"] - samples[0]["t"], 3),
        "host_load": {
            "min": round(min(loads), 2),
            "mean": round(sum(loads) / len(loads), 2),
            "max": round(max(loads), 2),
        } if loads else None,
        "close_p99_ms_max": max(closes) if closes else None,
        "tx_e2e_p99_ms_max": max(e2es) if e2es else None,
        "queue_pending_max": max(depths) if depths else None,
        "duplicate_ratio_last": dups[-1] if dups else None,
        "pad_waste_ratio_last": pads[-1] if pads else None,
        "breaker_open_samples": sum(
            1 for s in samples if s.get("breaker_open")),
        # samples taken while the verify mesh was shrunk (some device's
        # breaker OPEN) — the graceful-degradation counterpart of the
        # whole-backend breaker_open count above
        "mesh_degraded_samples": sum(
            1 for s in samples
            if (s.get("mesh") or {}).get("active", 0)
            < (s.get("mesh") or {}).get("devices", 0)),
    }
    return out


def scenario_reports(apps) -> Tuple[dict, dict]:
    """THE shared artifact-section builder for in-process scenarios
    (bench legs, the byzantine runner): take a final sample of every
    app — manual-close scenarios barely advance the clock, so the
    series must reflect the end state — then return the merged
    ``(timeseries, slo)`` sections. One implementation, so a
    summary-shape change propagates to every artifact producer."""
    from ..ops.slo import aggregate_status
    summaries = []
    statuses = []
    for a in apps:
        try:
            a.telemetry.sample_now()
        except Exception:                        # noqa: BLE001
            pass
        summaries.append(summarize_samples(a.telemetry.series.samples()))
        statuses.append(a.slo.status())
    return aggregate_summaries(summaries), aggregate_status(statuses)


def aggregate_summaries(summaries: List[dict]) -> dict:
    """Merge per-node summaries into one cluster/scenario-wide doc:
    sums where the stat is volume, worst-case where it is a tail, the
    widest envelope for host load (the nodes shared one host)."""
    summaries = [s for s in summaries if s and s.get("samples")]
    if not summaries:
        return {"samples": 0, "nodes": 0}

    def _max(key):
        vals = [s[key] for s in summaries if s.get(key) is not None]
        return max(vals) if vals else None

    loads = [s["host_load"] for s in summaries if s.get("host_load")]
    total = sum(s["samples"] for s in summaries)
    return {
        "samples": total,
        "nodes": len(summaries),
        "span_s": _max("span_s"),
        "host_load": {
            "min": min(h["min"] for h in loads),
            "mean": round(sum(h["mean"] * s["samples"]
                              for h, s in zip(loads, summaries))
                          / max(1, sum(s["samples"]
                                       for s in summaries)), 2),
            "max": max(h["max"] for h in loads),
        } if loads else None,
        "close_p99_ms_max": _max("close_p99_ms_max"),
        "tx_e2e_p99_ms_max": _max("tx_e2e_p99_ms_max"),
        "queue_pending_max": _max("queue_pending_max"),
        "duplicate_ratio_last": _max("duplicate_ratio_last"),
        "pad_waste_ratio_last": _max("pad_waste_ratio_last"),
        "breaker_open_samples": sum(
            s.get("breaker_open_samples") or 0 for s in summaries),
        "mesh_degraded_samples": sum(
            s.get("mesh_degraded_samples") or 0 for s in summaries),
    }
