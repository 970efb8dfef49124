"""Hash-keyed flood-propagation tracking (the mesh observatory core).

Every transaction frame and SCP envelope already carries a stable
hash (tx contents hash / sha256 of the flooded message), so each node
can record first-seen / send / recv / admitted / externalized instants
keyed by that hash with NO wire-format change — the Dapper insight
(PAPERS.md, Sigelman et al. 2010) applied to a gossip mesh: the
message id IS the trace id.

Always-on cost: one dict upsert per flood event into a bounded stamp
map — the same policy `ledger.transaction.e2e` uses (TTL prune past a
size threshold, `tracing.stamps.dropped` counts evictions), so a
never-externalized flood cannot grow memory. While a flight-recorder
trace is on, the overlay ALSO emits `flood.send`/`flood.recv`
instants carrying the hash; `util/tracemerge.py` stitches those into
cross-node flow chains.

Duplicate accounting answers ROADMAP item 3's question — how much of
the wire path is redundant delivery: `overlay.flood.unique` vs
`overlay.flood.duplicate` counters (metrics route + Prometheus),
per-peer `duplicates` on the `peers` route, and a redundancy ratio in
`report()` (surfaced by `clusterstatus` and the TPSM/TPSMT bench
artifacts as the before-picture for pull-mode flooding).
"""

from __future__ import annotations

import time
from typing import Dict, Optional


class _Stamp:
    __slots__ = ("first_seen", "recvs", "sends", "admitted",
                 "externalized")

    def __init__(self, now: float):
        self.first_seen = now
        self.recvs = 0
        self.sends = 0
        self.admitted: Optional[float] = None
        self.externalized: Optional[float] = None


class PropagationTracker:
    # mirror of Herder.TX_E2E_STAMP_TTL_SECONDS / _TX_E2E_PRUNE_THRESHOLD:
    # stamps older than the TTL are dropped once the map crosses the
    # threshold (banned / never-externalized floods must not accumulate)
    STAMP_TTL_SECONDS = 300.0
    PRUNE_THRESHOLD = 10_000

    def __init__(self, metrics=None):
        self._stamps: Dict[bytes, _Stamp] = {}
        self.unique = 0
        self.duplicates = 0
        if metrics is not None:
            self._dropped_counter = metrics.new_counter(
                "tracing.stamps.dropped")
            self._uniq_counter = metrics.new_counter(
                "overlay.flood.unique")
            self._dup_counter = metrics.new_counter(
                "overlay.flood.duplicate")
        else:
            self._dropped_counter = None
            self._uniq_counter = None
            self._dup_counter = None

    # ------------------------------------------------------------ stamps --
    def _get(self, h: bytes, now: float) -> _Stamp:
        st = self._stamps.get(h)
        if st is None:
            st = self._stamps[h] = _Stamp(now)
            if len(self._stamps) > self.PRUNE_THRESHOLD:
                self._prune_front(now)
        return st

    def on_recv(self, h: bytes, duplicate: Optional[bool] = None,
                now: Optional[float] = None) -> bool:
        """Record a delivery of hash `h`. `duplicate` overrides the
        stamp-based detection when the caller has an authority (the
        floodgate's dedup record for SCP messages); by default a
        delivery is a duplicate if this node already received or
        locally admitted the message. Returns the duplicate verdict."""
        if now is None:
            now = time.perf_counter()
        st = self._get(h, now)
        if duplicate is None:
            duplicate = st.recvs > 0 or st.admitted is not None
        st.recvs += 1
        if duplicate:
            self.duplicates += 1
            if self._dup_counter is not None:
                self._dup_counter.inc()
        else:
            self.unique += 1
            if self._uniq_counter is not None:
                self._uniq_counter.inc()
        return duplicate

    def on_send(self, h: bytes, n_peers: int = 1,
                now: Optional[float] = None) -> None:
        if now is None:
            now = time.perf_counter()
        self._get(h, now).sends += n_peers

    def on_admitted(self, h: bytes,
                    now: Optional[float] = None) -> None:
        if now is None:
            now = time.perf_counter()
        st = self._get(h, now)
        if st.admitted is None:
            st.admitted = now

    def on_externalized(self, h: bytes,
                        now: Optional[float] = None) -> None:
        """Update-only: a node that never saw the flood (catchup
        replay) must not grow the map with externalize-only stamps."""
        st = self._stamps.get(h)
        if st is not None and st.externalized is None:
            st.externalized = now if now is not None \
                else time.perf_counter()

    # ----------------------------------------------------------- hygiene --
    def _prune_front(self, now: float) -> None:
        """Entries are inserted with a monotonic first_seen, so the
        dict's insertion order IS first_seen order: scan from the
        front and stop at the first in-TTL entry — O(evicted), not a
        full map scan per flood event on the always-on hot path."""
        cutoff = now - self.STAMP_TTL_SECONDS
        stale = []
        for h, st in self._stamps.items():
            if st.first_seen >= cutoff:
                break
            stale.append(h)
        for h in stale:
            del self._stamps[h]
        if stale and self._dropped_counter is not None:
            self._dropped_counter.inc(len(stale))

    def clear(self) -> None:
        """`clearmetrics` hook: bench legs sharing a process start each
        measured window from a clean slate."""
        self._stamps.clear()
        self.unique = 0
        self.duplicates = 0

    def __len__(self) -> int:
        return len(self._stamps)

    # ------------------------------------------------------------ report --
    def report(self) -> dict:
        """Flood-redundancy snapshot (clusterstatus route, bench
        artifacts): duplicate_ratio is redundant deliveries per unique
        message — the number pull-mode flooding must drive toward 0."""
        total = self.unique + self.duplicates
        return {
            "unique": self.unique,
            "duplicates": self.duplicates,
            "duplicate_ratio": round(
                self.duplicates / max(1, self.unique), 4),
            "redundancy": round(total / max(1, self.unique), 4),
            "tracked": len(self._stamps),
            "dropped": self._dropped_counter.count
            if self._dropped_counter is not None else 0,
        }
