"""Multi-node trace merge: one Chrome trace for a whole mesh.

Per-node FlightRecorders (util/tracing.py) each capture their own
timeline with their own zero point (the perf_counter at start()).
This module merges them into ONE Chrome trace-event document:

- **clock alignment** — every node's events shift by (t0 - min t0),
  so events that happened at the same instant line up across process
  lanes (in-process simulations share one perf_counter domain;
  ``merge_trace_docs`` is the multi-process variant, aligning the
  `dumptrace` exports collected by simulation/cluster.py on the
  wall-clock anchor each recorder stamps into ``otherData.t0_wall``);
- **process lanes** — each node keeps its pid + process_name metadata
  (the recorder's label = node id prefix); colliding pids (bare test
  apps all defaulting to the same port) are reassigned;
- **async-id scoping** — legacy async events ("b"/"e") correlate
  globally by (cat, id), so two nodes' `tx.e2e` tracks for the same
  tx would merge into one malformed track; ids are prefixed with the
  node label to keep per-node tracks distinct;
- **flow stitching** — `flood.send`/`flood.recv` instants carry the
  message hash (overlay/propagation.py); every hash seen on 2+ nodes
  becomes a flow chain (ph "s"/"t"/"f", cat "flood", id = hash) whose
  arrows follow the message across node lanes in delivery order —
  the Dapper-style cross-process causal edge (PAPERS.md, Sigelman
  et al. 2010) drawn from hash-keyed hops instead of propagated
  request ids (no wire-format change).

Consumers: `Simulation.merged_trace()`, `bench.py --trace`, and
`scripts/trace_report.py --slots/--flood`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# instant names carrying the propagation hash key (overlay/manager.py)
FLOOD_SEND = "flood.send"
FLOOD_RECV = "flood.recv"


def merge_recorders(recorders) -> dict:
    """Merge FlightRecorder buffers into one clock-aligned Chrome
    trace document with flow chains stitched across node lanes.
    Recorders with no events are skipped; active recorders are dumped
    without being stopped (the caller owns their lifecycle)."""
    recs = [r for r in recorders if len(r) or r.active]
    if not recs:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    base = min(r.t0 for r in recs)
    # reassign colliding pids (all events of one recorder share one)
    pids = [r.pid for r in recs]
    remap = {}
    if len(set(pids)) < len(pids):
        remap = {id(r): i + 1 for i, r in enumerate(recs)}
    events: List[dict] = []
    dropped: Dict[str, int] = {}
    for r in recs:
        pid = remap.get(id(r), r.pid)
        # fallback label derives from the REMAPPED pid: two unlabeled
        # recorders must not share a label, or their async tracks merge
        label = r.label or "node-%d" % pid
        off_us = (r.t0 - base) * 1e6
        doc = r.to_chrome_trace()
        dropped[label] = doc["otherData"]["dropped_events"]
        for ev in doc["traceEvents"]:
            ev["pid"] = pid
            if "ts" in ev:
                ev["ts"] = round(ev["ts"] + off_us, 3)
            if ev.get("ph") in ("b", "e"):
                ev["id"] = "%s:%s" % (label, ev["id"])
            events.append(ev)
    events.extend(_stitch_flows(events))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"nodes": [r.label or str(r.pid) for r in recs],
                          "dropped_events": dropped}}


def merge_trace_docs(docs: List[dict],
                     labels: Optional[List[str]] = None) -> dict:
    """Merge already-exported Chrome trace documents — the `dumptrace`
    exports a multi-process cluster harness collects over HTTP — into
    one clock-aligned document with flow chains stitched across node
    lanes. Separate processes have incomparable perf_counter domains,
    so alignment uses the wall-clock anchor each FlightRecorder stamps
    into ``otherData.t0_wall`` at start() (the substitution the
    in-process merge above anticipated). NTP-grade wall skew between
    processes on one host is microseconds — well under a flood hop."""
    # pair docs with their labels BEFORE filtering empties, or a
    # skipped doc would shift every later lane onto the wrong label
    pairs = [(d, labels[i] if labels else None)
             for i, d in enumerate(docs or [])]
    pairs = [(d, lb) for d, lb in pairs if d and d.get("traceEvents")]
    if not pairs:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    anchors = [(d.get("otherData") or {}).get("t0_wall") or 0.0
               for d, _ in pairs]
    # a doc from a recorder that never start()ed reports anchor 0.0;
    # min() over it would shove every real lane an epoch into the
    # future, so unanchored docs merge at offset 0 instead
    real = [a for a in anchors if a > 0]
    base = min(real) if real else 0.0
    events: List[dict] = []
    dropped: Dict[str, int] = {}
    names: List[str] = []
    used_pids: set = set()
    for i, (doc, label_in) in enumerate(pairs):
        od = doc.get("otherData") or {}
        pid = od.get("pid") or i + 1
        while pid in used_pids:       # colliding lanes stay distinct
            pid += 1
        used_pids.add(pid)
        label = label_in or od.get("label") or "node-%d" % pid
        names.append(label)
        off_us = (anchors[i] - base) * 1e6 if anchors[i] > 0 else 0.0
        dropped[label] = od.get("dropped_events", 0)
        for ev in doc["traceEvents"]:
            ev = dict(ev)             # callers keep their doc intact
            ev["pid"] = pid
            if "ts" in ev:
                ev["ts"] = round(ev["ts"] + off_us, 3)
            if ev.get("ph") in ("b", "e"):
                # same scoping rule as the in-process merge: two nodes'
                # async tracks for one tx must not fuse into one track
                ev["id"] = "%s:%s" % (label, ev["id"])
            events.append(ev)
    events.extend(_stitch_flows(events))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"nodes": names, "dropped_events": dropped}}


def _stitch_flows(events: List[dict]) -> List[dict]:
    """Build flow chains from hash-keyed send/recv instants: for every
    hash observed on 2+ process lanes, emit one chronological chain
    "s" → "t"… → "f" visiting each instant's (pid, tid, ts)."""
    by_hash: Dict[str, List[dict]] = {}
    for ev in events:
        if ev.get("ph") == "i" and ev.get("name") in (FLOOD_SEND,
                                                      FLOOD_RECV):
            h = (ev.get("args") or {}).get("hash")
            if h:
                by_hash.setdefault(h, []).append(ev)
    flows: List[dict] = []
    for h, endpoints in by_hash.items():
        if len({e["pid"] for e in endpoints}) < 2:
            continue                      # never crossed a node boundary
        endpoints.sort(key=lambda e: e["ts"])
        last = len(endpoints) - 1
        prev_ts = None
        for i, ep in enumerate(endpoints):
            ts = ep["ts"]
            if prev_ts is not None and ts <= prev_ts:
                # flow steps of one chain must strictly advance
                ts = prev_ts + 0.001
            prev_ts = ts
            flows.append({
                "ph": "s" if i == 0 else ("f" if i == last else "t"),
                "cat": "flood", "id": h, "name": "flood.hop",
                "pid": ep["pid"], "tid": ep["tid"], "ts": ts,
                "bp": "e",
            })
    return flows
