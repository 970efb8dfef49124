"""Declarative SLO rules + watchdog over the telemetry time-series.

The Tail-at-Scale argument (Dean & Barroso, CACM 2013; PAPERS.md
§Robustness) is that tail behavior must be gated continuously with
deadlines and health state, not inspected after the fact. This module
is that gate: a small set of declarative rules — close-latency p99
ceiling, tx-e2e p99 ceiling, breaker-OPEN dwell, flood duplicate-ratio
ceiling — evaluated against every sample the ``TelemetrySampler``
(util/timeseries.py) appends, each emitting an OK / WARN / BREACH
verdict.

Rule semantics (deterministic under VirtualClock — all timing reads
the sample's own ``t``, never the wall):

- a rule extracts one numeric from the sample by key path (a missing
  section or zero-count timer is OK — no data is not a breach);
- value ≥ ``threshold`` starts (or continues) a breach window; the
  verdict turns BREACH once the window has lasted ``dwell_s``
  (``dwell_s=0`` breaches immediately). Below threshold the window
  resets;
- value ≥ ``warn_ratio × threshold`` (default 0.8) is WARN — the
  early-warning band; a breach window still inside its dwell also
  reads WARN (breaching-but-not-yet-sustained).

Verdicts surface three ways: ``slo.<rule>.{ok,warn,breach}`` metrics
counters (metrics route + Prometheus exposition, SUMmable across
nodes), flight-recorder instants (``slo.<rule>``) on every verdict
TRANSITION while a trace is recording, and the ``slo`` admin route's
structured status document (per rule: verdict, last value, threshold,
breach tally, since-when). ``clearmetrics`` resets the window state
via ``reset()`` — the reset contract: bench legs sharing one
process must start clean.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

OK = "OK"
WARN = "WARN"
BREACH = "BREACH"
_SEVERITY = {OK: 0, WARN: 1, BREACH: 2}


class SloRule:
    """One declarative objective: ``value(path) < threshold``,
    sustained-breach detection via ``dwell_s``."""

    __slots__ = ("name", "path", "threshold", "warn_ratio", "dwell_s",
                 "description")

    def __init__(self, name: str, path: Sequence[str], threshold: float,
                 warn_ratio: float = 0.8, dwell_s: float = 0.0,
                 description: str = ""):
        self.name = name
        self.path = tuple(path)
        self.threshold = float(threshold)
        self.warn_ratio = float(warn_ratio)
        self.dwell_s = max(0.0, float(dwell_s))
        self.description = description

    def value(self, sample: dict) -> Optional[float]:
        """Walk the key path; None when the section is absent (no
        overlay / no device backend / zero-count timer)."""
        node = sample
        for key in self.path:
            if not isinstance(node, dict) or key not in node \
                    or node[key] is None:
                return None
            node = node[key]
        if isinstance(node, bool) or not isinstance(node, (int, float)):
            return None
        return float(node)


class _RuleState:
    __slots__ = ("verdict", "value", "breach_since", "last_change_t",
                 "breaches", "warns")

    def __init__(self):
        self.verdict = OK
        self.value: Optional[float] = None
        self.breach_since: Optional[float] = None
        self.last_change_t: Optional[float] = None
        self.breaches = 0
        self.warns = 0


class SloWatchdog:
    """Evaluates every telemetry sample against the rule set; keeps
    per-rule sliding state keyed on sample time (VirtualClock in sims,
    wall clock in `run` mode — whatever stamped the sample)."""

    def __init__(self, rules: List[SloRule], metrics=None,
                 recorder=None):
        self.rules = list(rules)
        self._recorder = recorder
        self._metrics = metrics
        self._counters: Dict[Tuple[str, str], object] = {}
        if metrics is not None:
            for rule in self.rules:
                for verdict in (OK, WARN, BREACH):
                    self._counters[(rule.name, verdict)] = \
                        metrics.counter("slo", rule.name,
                                        verdict.lower())
        self._state: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules}
        self.evaluations = 0

    # ---------------------------------------------------------- evaluate --
    def observe(self, sample: dict) -> None:
        """TelemetrySampler observer hook: judge one sample."""
        self.evaluations += 1
        t = sample.get("t", 0.0)
        for rule in self.rules:
            st = self._state[rule.name]
            v = rule.value(sample)
            st.value = v
            if v is None or v < rule.threshold:
                st.breach_since = None
                verdict = WARN if (
                    v is not None
                    and rule.warn_ratio < 1.0
                    and v >= rule.warn_ratio * rule.threshold) else OK
            else:
                if st.breach_since is None:
                    st.breach_since = t
                verdict = BREACH if (t - st.breach_since
                                     >= rule.dwell_s) else WARN
            if verdict == BREACH:
                st.breaches += 1
            elif verdict == WARN:
                st.warns += 1
            counter = self._counters.get((rule.name, verdict))
            if counter is not None:
                counter.inc()
            if verdict != st.verdict:
                st.last_change_t = t
                self._instant(rule, verdict, v, t)
            st.verdict = verdict

    def _instant(self, rule: SloRule, verdict: str,
                 value: Optional[float], t: float) -> None:
        from ..util import tracing
        rec = self._recorder
        if tracing.ENABLED and rec is not None and rec.active:
            rec.instant("slo." + rule.name, {
                "verdict": verdict, "value": value,
                "threshold": rule.threshold, "t": t})

    # ------------------------------------------------------------ report --
    def overall(self) -> str:
        worst = OK
        for st in self._state.values():
            if _SEVERITY[st.verdict] > _SEVERITY[worst]:
                worst = st.verdict
        return worst

    def status(self) -> dict:
        """The `slo` admin route document."""
        rules = {}
        for rule in self.rules:
            st = self._state[rule.name]
            rules[rule.name] = {
                "verdict": st.verdict,
                "value": st.value,
                "threshold": rule.threshold,
                "warn_ratio": rule.warn_ratio,
                "dwell_s": rule.dwell_s,
                "breach_since": st.breach_since,
                "last_change_t": st.last_change_t,
                "breaches": st.breaches,
                "warns": st.warns,
                "description": rule.description,
            }
        return {"overall": self.overall(),
                "evaluations": self.evaluations,
                "rules": rules}

    def reset(self) -> None:
        """`clearmetrics` hook: drop every sliding window + tally (the
        slo.* counters live in the registry and reset with it)."""
        self.evaluations = 0
        for name in self._state:
            self._state[name] = _RuleState()


def default_rules(config) -> List[SloRule]:
    """The stock rule set, thresholds from config knobs (all
    docs/OBSERVABILITY.md §SLO watchdog)."""
    return [
        SloRule("close_p99", ("close", "p99_ms"),
                config.SLO_CLOSE_P99_MS,
                description="ledger close p99 ceiling (ms)"),
        SloRule("tx_e2e_p99", ("tx_e2e", "p99_ms"),
                config.SLO_TX_E2E_P99_MS,
                description="tx submit→externalize p99 ceiling (ms)"),
        SloRule("breaker_open_dwell", ("breaker_open",), 0.5,
                warn_ratio=1.0,
                dwell_s=config.SLO_BREAKER_OPEN_DWELL_S,
                description="device breaker OPEN longer than the "
                            "dwell (s) — degraded mode is no longer "
                            "transient"),
        SloRule("duplicate_ratio", ("flood", "duplicate_ratio"),
                config.SLO_DUPLICATE_RATIO_MAX,
                description="flood redundancy ceiling (duplicate "
                            "deliveries per unique message)"),
        SloRule("read_p99", ("query", "p99_ms"),
                config.SLO_READ_P99_MS,
                description="read-tier query latency p99 ceiling (ms) "
                            "— reads shed before writes on breach"),
    ]


def aggregate_status(docs: List[dict]) -> dict:
    """Merge per-node `slo` documents into one scenario-wide verdict
    section (bench artifacts, the cluster harness): worst verdict per
    rule across nodes, breach/warn tallies summed."""
    docs = [d for d in docs if d]
    if not docs:
        return {"overall": OK, "nodes": 0, "rules": {}}
    rules: Dict[str, dict] = {}
    overall = OK
    for doc in docs:
        doc_overall = doc.get("overall", OK)
        if _SEVERITY.get(doc_overall, 0) > _SEVERITY[overall]:
            overall = doc_overall
        for name, rd in doc.get("rules", {}).items():
            agg = rules.setdefault(name, {
                "verdict": OK, "breaches": 0, "warns": 0,
                "threshold": rd.get("threshold")})
            if _SEVERITY.get(rd.get("verdict"), 0) \
                    > _SEVERITY[agg["verdict"]]:
                agg["verdict"] = rd["verdict"]
            agg["breaches"] += rd.get("breaches", 0)
            agg["warns"] += rd.get("warns", 0)
    return {"overall": overall, "nodes": len(docs), "rules": rules}
