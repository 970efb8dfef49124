"""How many rows one dispatch of a cell holds.

A traffic file gives `rows_per_dispatch` itself, or gives `ledger_fill`
(the share of the configuration's `max_tx_set_ops` that each replayed
ledger holds) for catchup's prevalidation. Then the dispatch is what
the port's pipeline sends (catchup/pipeline.py `_pump_prevalidate`):
with replay bound by apply, the prevalidate window holds
`prevalidate_ahead` downloaded checkpoints of
`checkpoint_ledgers * ops * signatures_per_tx` rows each, and
`prevalidate_coalesce` fuses the first k of them. The rule below is a
frozen copy of ops/verifier.py's `_bucket_size` and
`prevalidate_coalesce`, so that a change to the program's rule does not
move the yardstick; a test holds the two equal.
"""

from __future__ import annotations

MIN_BUCKET = 8


def bucket_size(n: int, minimum: int = MIN_BUCKET) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def coalesce(counts, max_fuse: int, minimum: int = MIN_BUCKET) -> int:
    """How many of the pending checkpoints (their row counts, in replay
    order) the pipeline fuses into one dispatch: greedily, while fusing
    costs no more padded slots than separate dispatches would."""
    if not counts:
        return 0
    k = 1
    total = counts[0]
    while k < min(len(counts), max_fuse):
        nxt = counts[k]
        if nxt:
            fused = bucket_size(total + nxt, minimum)
            separate = (bucket_size(total, minimum) if total else 0) \
                + bucket_size(nxt, minimum)
            if fused > separate:
                break
            total += nxt
        k += 1
    return k


def checkpoint_rows(config: dict, ledger_fill: float) -> int:
    ops = int(round(int(config["max_tx_set_ops"]) * float(ledger_fill)))
    return int(config["checkpoint_ledgers"]) * ops \
        * int(config["signatures_per_tx"])


def rows_per_dispatch(config: dict, traffic: dict) -> int:
    if "rows_per_dispatch" in traffic:
        return int(traffic["rows_per_dispatch"])
    rows = checkpoint_rows(config, traffic["ledger_fill"])
    ahead = int(config["prevalidate_ahead"])
    return coalesce([rows] * ahead, ahead) * rows
