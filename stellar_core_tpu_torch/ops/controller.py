"""SLO-driven adaptive control plane: close the telemetry loop.

Every node has senses — the bounded telemetry time-series
(util/timeseries.py) and the declarative SLO watchdog (ops/slo.py) —
but the knobs they watch would stay hand-picked constants. This module is
the actuator: an ``AdaptiveController`` riding a recurring
``VirtualTimer`` on the APP clock (the exact ``TelemetrySampler``
discipline, so in-process simulations tick on the VirtualClock and
``run`` nodes on the wall clock) that each tick reads the newest
telemetry sample plus the watchdog's verdicts and moves three things:

**(a) AIMD batch-knob search** (Clipper, NSDI '17 — batch parameters
should be searched continuously from measured latency, not frozen at
config time), over the verify service's measured occupancy and
queue-wait p99:

  - queue-wait p99 above ``CONTROLLER_QUEUE_WAIT_TARGET_MS`` (or a
    pending backlog past 4x the batch ceiling) → **multiplicative
    decrease** of ``VERIFY_BATCH_DEADLINE_MS`` (dispatch sooner; the
    deadline is the latency knob) and of ``VERIFY_MAX_BATCH`` when the
    backlog itself is the signal;
  - queue-wait comfortably under target with batches filling
    (occupancy p99 ≥ 0.8 × max batch) → **additive increase** of
    ``VERIFY_MAX_BATCH`` (probe for more coalescing);
  - queue-wait under target but flushes too small to engage the device
    (occupancy p99 below the min-batch bypass) → stretch the deadline
    (× ``CONTROLLER_DEADLINE_GROW``) so batches fill toward device
    profitability;
  - ``VERIFY_DEVICE_MIN_BATCH`` follows the measured dispatch shape
    (judged only when new dispatches landed since the last tick — the
    accounting is cumulative): pad-waste ratio past 0.6 while
    dispatch batch p99 sits under 2× the cutoff raises it (tiny
    batches burn pow2 padding — keep them on the host); dispatch
    batch p99 past 4× the cutoff lowers it back toward the device.

**(b) graduated admission shedding** (The Tail at Scale, CACM '13: an
overloaded replica sheds to a good-enough answer now instead of
letting queues melt the p99): tx-submit and flood-admission drop
probabilities ramp from the SLO watchdog's WARN→BREACH verdicts on
``close_p99`` and ``tx_e2e_p99`` — WARN ramps the tx-submit gate
(backpressure local submitters first), BREACH ramps the flood gate
too; OK decays both toward zero. On top of the ladder sits the
**surge gate**: the controller learns the node's per-tx close cost
from the series (Δ applied txs / Δ ledgers vs the windowed close
median) and when the pending queue exceeds what would close inside
``SLO_CLOSE_P99_MS × CONTROLLER_BACKLOG_FACTOR`` it slams the
tx-submit shed to ``CONTROLLER_SHED_MAX`` — a million users arriving
in one burst are turned away BEFORE the node pays device time and
close latency for work it would drop anyway. Shedding engages at the
admission seams (herder tx submit, overlay flood admission), upstream
of the batched verify dispatch.

**(c) breaker interplay**: while the device breaker aggregate
(ops/backend_supervisor.py) is not CLOSED — which since the
per-device breaker array means the WHOLE mesh is unavailable
— the controller freezes batch-knob tuning: AIMD feedback measured
against the native fallback path would mis-train the device knobs.
The shed ladder keeps running either way: a degraded node needs
admission control more, not less. A PARTIALLY degraded mesh (sample
``mesh.active < mesh.devices``) does NOT freeze tuning — the batch
path is still the device path — but it scales the learned close
capacity (and with it the surge gate) by the surviving-device
fraction, read from the SAMPLE for replay determinism: a 7/8 mesh is
a 7/8 node until the canary probes regrow it.

Determinism contract: every decision reads the telemetry sample's own
``t`` (and the watchdog state derived from those samples), never the
wall clock, so identical seeded schedules on the VirtualClock replay
byte-identical decision logs; the only RNG (per-frame shed rolls) is
seeded from ``config.jitter_seed()`` and never feeds tick decisions.

Observability: ``controller.*`` counters/gauges (metrics route +
Prometheus), flight-recorder instants on every knob/shed change, a
bounded decision log, and the ``controller`` admin route
(``?action=freeze|reset`` behind ``ALLOW_CHAOS_INJECTION``) that
``simulation/cluster.py`` polls into CLUSTER artifacts.
``clearmetrics`` routes through ``reset()``: learned knob values,
shed probabilities and the decision log all drop and the controller
epoch rotates — exactly the time-series contract, so
back-to-back bench legs in one process cannot leak tuning.
"""

from __future__ import annotations

import random
from collections import deque
from typing import Optional

from ..util import tracing
from ..util.logging import get_logger

log = get_logger("default")

# knob bounds: the AIMD search must stay inside the envelope the
# verify service / device kernels were validated over
MAX_BATCH_FLOOR, MAX_BATCH_CEIL = 16, 4096
DEADLINE_FLOOR_MS, DEADLINE_CEIL_MS = 0.25, 64.0
MIN_BATCH_FLOOR, MIN_BATCH_CEIL = 1, 1024

DECISION_LOG_CAPACITY = 256


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


class AdaptiveController:
    """The closed loop: telemetry sample in, knob moves + shed levels
    out. One per Application, wired beside the sampler/watchdog."""

    def __init__(self, app, metrics=None, recorder=None):
        self._app = app
        cfg = app.config
        self.period_s = max(0.0, float(cfg.CONTROLLER_TICK_PERIOD))
        self._queue_wait_target_ms = float(
            cfg.CONTROLLER_QUEUE_WAIT_TARGET_MS)
        self._aimd_increase = int(cfg.CONTROLLER_AIMD_INCREASE)
        self._aimd_decrease = float(cfg.CONTROLLER_AIMD_DECREASE)
        self._deadline_grow = float(cfg.CONTROLLER_DEADLINE_GROW)
        self._shed_step = float(cfg.CONTROLLER_SHED_STEP)
        self._shed_decay = float(cfg.CONTROLLER_SHED_DECAY)
        self._shed_max = float(cfg.CONTROLLER_SHED_MAX)
        self._backlog_factor = float(cfg.CONTROLLER_BACKLOG_FACTOR)
        # config-anchored knob values: reset() restores these
        self._cfg_knobs = {
            "max_batch": int(cfg.VERIFY_MAX_BATCH),
            "deadline_ms": float(cfg.VERIFY_BATCH_DEADLINE_MS),
            "min_batch": int(cfg.VERIFY_DEVICE_MIN_BATCH),
        }
        self.knobs = dict(self._cfg_knobs)
        self.shed_tx = 0.0
        self.shed_flood = 0.0
        # read-tier shed: ramps FIRST and FASTEST — reads degrade
        # before the write path (ledger close) ever sheds
        self.shed_read = 0.0
        self.frozen = False          # admin freeze: pin everything
        self.epoch = 1
        self.ticks = 0
        self.decisions: deque = deque(maxlen=DECISION_LOG_CAPACITY)
        self._recorder = recorder
        self._timer = None
        self._stopped = False
        # scrape bookkeeping: a tick re-run against the same sample
        # must not double-apply a ramp
        self._last_sample_key = None
        self._prev_ledger: Optional[int] = None
        self._prev_tx_applied: Optional[int] = None
        # None = resync on next tick: the dispatch histogram is
        # cumulative, and judging its lifetime ratios without a
        # baseline would move knobs on stale evidence
        self._prev_dispatch_count: Optional[int] = None
        self._cost_ms_per_tx: Optional[float] = None
        self._safe_txset = 0
        # surviving-device fraction of the verify mesh, read from each
        # sample (1.0 = full mesh / no mesh): scales the surge gate's
        # capacity estimate while the mesh is shrunk
        self._mesh_frac = 1.0
        # per-frame shed rolls ride their own seeded stream so the
        # admission volume can never perturb tick decisions
        self._shed_rng = random.Random(cfg.jitter_seed() ^ 0xC0117801)
        if metrics is None:
            from ..util.metrics import MetricsRegistry
            metrics = MetricsRegistry()
        self._metrics = metrics
        self._tick_counter = metrics.counter("controller", "tick")
        self._tune_counters = {
            d: metrics.counter("controller", "tune", d)
            for d in ("up", "down")}
        self._freeze_counter = metrics.counter(
            "controller", "freeze", "tick")
        self._shed_change_counter = metrics.counter(
            "controller", "shed", "change")
        self._shed_dropped = {
            k: metrics.counter("controller", "shed", k, "dropped")
            for k in ("tx", "flood", "read")}
        # level gauges (counter-as-gauge, the breaker-state idiom):
        # permille so Prometheus integer counters carry the fraction
        self._shed_gauges = {
            k: metrics.counter("controller", "shed", k, "permille")
            for k in ("tx", "flood", "read")}
        self._knob_gauges = {
            k: metrics.counter("controller", "knob",
                               "deadline_us" if k == "deadline_ms"
                               else k)
            for k in self.knobs}
        self._refresh_gauges()

    # ------------------------------------------------------------ lifecycle --
    def start(self) -> None:
        if self.period_s > 0 and not self._stopped:
            self._arm()

    def stop(self) -> None:
        self._stopped = True
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _arm(self) -> None:
        from ..util.timer import VirtualTimer
        if self._timer is None:
            self._timer = VirtualTimer(self._app.clock)
        self._timer.expires_from_now(self.period_s)
        self._timer.async_wait(self._fire)

    def _fire(self) -> None:
        from ..main.application import AppState
        if self._stopped or \
                self._app.state == AppState.APP_STOPPING_STATE:
            # a dead node must not keep a recurring event on the
            # (possibly shared) simulation clock forever
            return
        try:
            self.tick()
        except Exception:                        # noqa: BLE001
            # control must never take the node down; the next fire
            # retries against whatever state then exists
            log.debug("controller tick failed", exc_info=True)
        self._arm()

    # ----------------------------------------------------------------- tick --
    def tick(self, sample: Optional[dict] = None) -> None:
        """One control step: read the newest telemetry sample (or the
        given one — the manual-tick benches/tests), judge, actuate.
        All timing reads the sample's ``t``; re-ticking against an
        already-consumed sample is a no-op."""
        if sample is None:
            sample = self._app.telemetry.series.latest()
        if sample is None:
            return
        # content-based identity: re-ticking against the same sample
        # (same epoch/cursor, or same `t` for cursor-less manual
        # samples) is a no-op — never id(), whose reuse after GC could
        # silently drop a control step
        key = (self._app.telemetry.series.epoch,
               sample.get("cursor"), sample.get("t"))
        if key == self._last_sample_key:
            return
        self._last_sample_key = key
        self.ticks += 1
        self._tick_counter.inc()
        t = sample.get("t", 0.0)
        self._learn_close_cost(sample)
        self._observe_mesh(sample, t)
        if self.frozen:
            self._freeze_counter.inc()
            return
        breaker = sample.get("breaker")
        if breaker is not None and breaker != "CLOSED":
            # breaker interplay: the aggregate leaves CLOSED only when
            # the WHOLE mesh is unavailable (per-device breakers,
            # ops/backend_supervisor.py) — every dispatch rides the
            # native fallback, so AIMD feedback would mis-train the
            # device knobs. Freeze tuning, keep shedding
            # (docs/ROBUSTNESS.md interaction table). A partial mesh
            # keeps tuning: the batch path is still the device path.
            self._freeze_counter.inc()
        else:
            self._tune(sample, t)
        self._shed(sample, t)
        self._refresh_gauges()

    def _observe_mesh(self, sample: dict, t: float) -> None:
        """Track the surviving-device fraction from the sample (never
        the live supervisor — replay determinism). Feeds the capacity
        scaling in _close_capacity_txs."""
        mesh = sample.get("mesh") or {}
        total = mesh.get("devices") or 0
        active = mesh.get("active")
        frac = (active / total) if total and active is not None else 1.0
        if frac != self._mesh_frac:
            self._record("mesh", "fraction",
                         round(self._mesh_frac, 4), round(frac, 4), t,
                         "verify mesh %s/%s devices"
                         % (active if total else "-",
                            total if total else "-"))
            self._mesh_frac = frac

    # ----------------------------------------------------------- AIMD tune --
    def _tune(self, sample: dict, t: float) -> None:
        v = sample.get("verify")
        if not v:
            return
        qw = v.get("queue_wait_p99_ms") or 0.0
        occ = v.get("occupancy_p99") or 0
        pending = v.get("queue_pending") or 0
        max_batch = self.knobs["max_batch"]
        deadline = self.knobs["deadline_ms"]
        min_batch = self.knobs["min_batch"]
        congested = qw > self._queue_wait_target_ms
        if congested:
            # multiplicative back-off on the latency knob
            self._set_knob("deadline_ms",
                           deadline * self._aimd_decrease, t,
                           "queue_wait_p99 %.2fms > %.2fms target"
                           % (qw, self._queue_wait_target_ms))
            if pending > 4 * max_batch:
                self._set_knob("max_batch",
                               int(max_batch * self._aimd_decrease), t,
                               "pending %d > 4x max_batch" % pending)
        elif v.get("flushes"):
            if occ >= 0.8 * max_batch:
                # batches filling with latency headroom: probe upward
                self._set_knob("max_batch",
                               max_batch + self._aimd_increase, t,
                               "occupancy_p99 %g >= 0.8x max_batch"
                               % occ)
            elif 0 < occ < min_batch:
                # flushes riding the host bypass: coalesce longer
                self._set_knob("deadline_ms",
                               deadline * self._deadline_grow, t,
                               "occupancy_p99 %g < min_batch %d"
                               % (occ, min_batch))
        disp = sample.get("dispatch")
        if disp:
            # only judge the dispatch shape when NEW dispatches landed
            # since the last tick: pad_waste_ratio is a lifetime
            # cumulative, so re-firing on stale evidence would ratchet
            # min_batch to the cap and silently disable the device
            count = disp.get("count") or 0
            if self._prev_dispatch_count is None:
                # resync tick (fresh controller, or reset() while the
                # cumulative dispatch accounting survived): record the
                # baseline, judge nothing
                fresh = False
            else:
                fresh = count > self._prev_dispatch_count
            self._prev_dispatch_count = count
            if not fresh:
                return
            waste = disp.get("pad_waste_ratio") or 0.0
            batch_p99 = disp.get("batch_p99") or 0
            if waste > 0.6 and batch_p99 < 2 * min_batch:
                self._set_knob("min_batch", min_batch * 2, t,
                               "pad_waste %.2f on small dispatches"
                               % waste)
            elif batch_p99 > 4 * min_batch and min_batch > \
                    self._cfg_knobs["min_batch"]:
                self._set_knob("min_batch", min_batch // 2, t,
                               "dispatch batch_p99 %g >> min_batch"
                               % batch_p99)

    def _set_knob(self, field: str, value, t: float,
                  reason: str) -> None:
        lo, hi = {"max_batch": (MAX_BATCH_FLOOR, MAX_BATCH_CEIL),
                  "deadline_ms": (DEADLINE_FLOOR_MS, DEADLINE_CEIL_MS),
                  "min_batch": (MIN_BATCH_FLOOR, MIN_BATCH_CEIL)}[field]
        if field == "deadline_ms":
            value = round(_clamp(float(value), lo, hi), 4)
        else:
            value = int(_clamp(int(value), lo, hi))
        old = self.knobs[field]
        if value == old:
            return
        self.knobs[field] = value
        self._tune_counters["up" if value > old else "down"].inc()
        self._apply_knobs()
        self._record("tune", field, old, value, t, reason)

    def _apply_knobs(self) -> None:
        """Push the searched values into the live subsystems —
        mutable-safe: the service swaps under its own lock, the
        verifier's bypass threshold is a plain attribute read
        per-flush."""
        svc = getattr(self._app, "verify_service", None)
        if svc is not None:
            svc.set_knobs(max_batch=self.knobs["max_batch"],
                          deadline_ms=self.knobs["deadline_ms"])
        bv = getattr(self._app, "batch_verifier", None)
        if bv is not None and hasattr(bv, "set_device_min_batch"):
            bv.set_device_min_batch(self.knobs["min_batch"])

    # ------------------------------------------------------------- shedding --
    def _shed(self, sample: dict, t: float) -> None:
        rules = self._app.slo.status().get("rules", {})
        from .slo import BREACH, WARN, _SEVERITY
        worst = "OK"
        for name in ("close_p99", "tx_e2e_p99"):
            verdict = rules.get(name, {}).get("verdict", "OK")
            if _SEVERITY.get(verdict, 0) > _SEVERITY.get(worst, 0):
                worst = verdict
        # read ladder FIRST: the read tier is the sacrificial layer.
        # It ramps on its own SLO (read_p99) AND on any write-path
        # pressure, twice as fast as the write ladders — by the time
        # close/tx_e2e would shed, reads are already mostly gone.
        read_verdict = rules.get("read_p99", {}).get("verdict", "OK")
        read_worst = read_verdict
        for name in ("close_p99", "tx_e2e_p99"):
            v = rules.get(name, {}).get("verdict", "OK")
            if _SEVERITY.get(v, 0) > _SEVERITY.get(read_worst, 0):
                read_worst = v
        read = self.shed_read
        if read_worst == BREACH:
            read = min(self._shed_max, read + 4 * self._shed_step)
        elif read_worst == WARN:
            read = min(self._shed_max, read + 2 * self._shed_step)
        else:
            read = max(0.0, read - self._shed_decay)
        tx, flood = self.shed_tx, self.shed_flood
        if worst == BREACH:
            tx = min(self._shed_max, tx + 2 * self._shed_step)
            flood = min(self._shed_max, flood + self._shed_step)
        elif worst == WARN:
            # backpressure local submitters first; flood relief
            # decays even under sustained WARN, or one BREACH tick
            # would pin flood drops at the high-water mark for as
            # long as the node hovers in the warn band
            tx = min(self._shed_max, tx + self._shed_step)
            flood = max(0.0, flood - self._shed_decay)
        else:
            tx = max(0.0, tx - self._shed_decay)
            flood = max(0.0, flood - self._shed_decay)
        # the surge gate: queue already holds more than can close
        # inside the SLO budget — slam the submit gate shut before the
        # node pays for work it would drop (Tail-at-Scale)
        capacity = self._close_capacity_txs()
        pending = sample.get("pending_txs") or 0
        if capacity is not None and pending > capacity:
            if self.shed_tx < self._shed_max:
                # record the gate ENGAGING, not every pinned tick
                self._record(
                    "shed", "backlog", round(self.shed_tx, 4),
                    self._shed_max, t,
                    "pending %d > close capacity %d" % (pending,
                                                        capacity))
            tx = self._shed_max
        if (tx, flood, read) != (self.shed_tx, self.shed_flood,
                                 self.shed_read):
            self._shed_change_counter.inc()
            if worst != "OK" or read_worst != "OK" or \
                    (tx, flood, read) == (0.0, 0.0, 0.0) or \
                    tx < self.shed_tx or flood < self.shed_flood or \
                    read < self.shed_read:
                reason = "slo %s/read %s" % (worst, read_verdict)
            else:
                reason = "ramp"
            self._record("shed", "levels",
                         [round(self.shed_tx, 4),
                          round(self.shed_flood, 4),
                          round(self.shed_read, 4)],
                         [round(tx, 4), round(flood, 4),
                          round(read, 4)], t, reason)
        self.shed_tx, self.shed_flood = round(tx, 4), round(flood, 4)
        self.shed_read = round(read, 4)

    def _learn_close_cost(self, sample: dict) -> None:
        """EWMA per-tx close cost from the series: Δ applied txs / Δ
        ledgers between ticks vs the windowed close median. Feeds the
        surge gate's capacity estimate; None until two ticks have seen
        a close."""
        ledger = sample.get("ledger")
        applied = sample.get("tx_applied")
        close = sample.get("close") or {}
        if ledger is None or applied is None:
            return
        prev_l, prev_a = self._prev_ledger, self._prev_tx_applied
        self._prev_ledger, self._prev_tx_applied = ledger, applied
        if prev_l is None or ledger <= prev_l or applied <= prev_a:
            return
        med = close.get("median_ms")
        if not med:
            return
        # closes measured on a SHRUNK mesh do not feed the cost model:
        # _close_capacity_txs already discounts by the surviving
        # fraction, and absorbing the degraded (higher) per-tx cost
        # too would double-count the outage — the EWMA must keep
        # meaning "full-mesh cost" for the discount to be sound. The
        # mesh state is read from THIS sample (not the live
        # supervisor) for replay determinism.
        mesh = sample.get("mesh") or {}
        if mesh.get("devices") and \
                mesh.get("active", mesh["devices"]) < mesh["devices"]:
            return
        avg_txset = (applied - prev_a) / (ledger - prev_l)
        if avg_txset <= 0:
            return
        cost = med / avg_txset
        if self._cost_ms_per_tx is None:
            self._cost_ms_per_tx = cost
        else:
            self._cost_ms_per_tx = round(
                0.7 * self._cost_ms_per_tx + 0.3 * cost, 6)
        # demonstrated-safe throughput: the largest average txset the
        # node closed while close p99 sat BELOW the warn band. The
        # average-cost model folds the fixed per-ledger overhead into
        # the per-tx cost, which understates capacity and would shed
        # baseline load the node demonstrably serves within SLO — the
        # floor keeps the gate honest, and because it only rises while
        # the verdict band is clean it self-regulates toward (never
        # past) the warn boundary.
        p99 = close.get("p99_ms") or med
        if p99 < 0.8 * self._app.config.SLO_CLOSE_P99_MS:
            self._safe_txset = max(self._safe_txset, int(avg_txset))

    def _close_capacity_txs(self) -> Optional[int]:
        if not self._cost_ms_per_tx:
            return None
        budget_ms = self._app.config.SLO_CLOSE_P99_MS \
            * self._backlog_factor
        # partial-mesh scaling: the cost model and the demonstrated-
        # safe floor were both learned on the full mesh — while the
        # verify mesh runs N-1/N, the surge gate must assume N-1/N of
        # that capacity or it admits a backlog the degraded node
        # cannot close inside the SLO budget
        return max(1, int(budget_ms / self._cost_ms_per_tx
                          * self._mesh_frac),
                   int(self._safe_txset * self._mesh_frac))

    # ------------------------------------------------------ admission rolls --
    def roll_tx_shed(self) -> bool:
        """One tx-submit admission decision (herder.recv_transaction,
        direct-submit path). True = shed this submission."""
        if self.shed_tx <= 0.0:
            return False
        if self._shed_rng.random() >= self.shed_tx:
            return False
        self._shed_dropped["tx"].inc()
        return True

    def roll_read_shed(self) -> bool:
        """One read-admission decision (query/service.py submit path,
        BEFORE the request queues). True = shed this read."""
        if self.shed_read <= 0.0:
            return False
        if self._shed_rng.random() >= self.shed_read:
            return False
        self._shed_dropped["read"].inc()
        return True

    def roll_flood_shed(self) -> bool:
        """One flood-admission decision (overlay _on_transaction,
        BEFORE the batched verify dispatch). True = shed this frame."""
        if self.shed_flood <= 0.0:
            return False
        if self._shed_rng.random() >= self.shed_flood:
            return False
        self._shed_dropped["flood"].inc()
        return True

    # ------------------------------------------------------------ recording --
    def _record(self, kind: str, field: str, old, new, t: float,
                reason: str) -> None:
        entry = {"t": round(t, 3), "kind": kind, "field": field,
                 "old": old, "new": new, "reason": reason}
        self.decisions.append(entry)
        if tracing.ENABLED:
            rec = self._recorder
            if rec is not None and rec.active:
                rec.instant("controller." + kind, dict(entry))

    def _refresh_gauges(self) -> None:
        self._shed_gauges["tx"].set_count(int(self.shed_tx * 1000))
        self._shed_gauges["flood"].set_count(
            int(self.shed_flood * 1000))
        self._shed_gauges["read"].set_count(
            int(self.shed_read * 1000))
        for k, v in self.knobs.items():
            if k == "deadline_ms":
                # exported in µs: the envelope reaches 0.25 ms, and an
                # integer ms gauge would read 0 across the whole
                # sub-millisecond half of the search space
                self._knob_gauges[k].set_count(int(v * 1000))
            else:
                self._knob_gauges[k].set_count(int(v))

    # --------------------------------------------------------------- control --
    def freeze(self) -> None:
        """Admin pin: no further tuning or shed-level moves; existing
        shed probabilities keep applying (the `controller` route)."""
        self.frozen = True

    def reset(self) -> None:
        """`clearmetrics` / `controller?action=reset` hook: drop every
        learned value — knobs back to config, shed probabilities to
        zero, decision log emptied, cost estimate forgotten — and
        rotate the epoch so a frozen or mis-trained controller cannot
        leak tuning into the next bench leg (the time-series epoch
        contract)."""
        self.knobs = dict(self._cfg_knobs)
        self._apply_knobs()
        self.shed_tx = self.shed_flood = self.shed_read = 0.0
        self.frozen = False
        self.decisions.clear()
        self.ticks = 0
        self.epoch += 1
        self._last_sample_key = None
        self._prev_ledger = self._prev_tx_applied = None
        self._prev_dispatch_count = None
        self._cost_ms_per_tx = None
        self._safe_txset = 0
        self._mesh_frac = 1.0
        self._refresh_gauges()

    # ----------------------------------------------------------------- view --
    def status(self) -> dict:
        """The `controller` admin route document (also what
        simulation/cluster.py polls into CLUSTER artifacts)."""
        return {
            "enabled": self.period_s > 0,
            "period_s": self.period_s,
            "frozen": self.frozen,
            "epoch": self.epoch,
            "ticks": self.ticks,
            "knobs": dict(self.knobs),
            "config_knobs": dict(self._cfg_knobs),
            "shed": {"tx": self.shed_tx, "flood": self.shed_flood,
                     "read": self.shed_read,
                     "tx_dropped": self._shed_dropped["tx"].count,
                     "flood_dropped":
                         self._shed_dropped["flood"].count,
                     "read_dropped":
                         self._shed_dropped["read"].count},
            "cost_ms_per_tx": self._cost_ms_per_tx,
            "safe_txset": self._safe_txset,
            "mesh_fraction": round(self._mesh_frac, 4),
            "close_capacity_txs": self._close_capacity_txs(),
            "decisions": {
                "total": len(self.decisions),
                "tune_up": self._tune_counters["up"].count,
                "tune_down": self._tune_counters["down"].count,
                "shed_changes": self._shed_change_counter.count,
                "tail": list(self.decisions)[-20:],
            },
        }
