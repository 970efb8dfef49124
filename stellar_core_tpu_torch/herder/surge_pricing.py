"""Surge pricing — multi-lane fee-rate prioritisation.

Reference: src/herder/SurgePricingUtils.{h,cpp} — lane 0 is the generic lane
whose limit every tx counts against; extra lanes (e.g. DEX-op txs) have their
own sub-limits. Selection pops the highest fee-rate txs that still fit their
lane(s); the "clearing" fee rate per lane is the lowest included rate when a
lane overflowed, and absent otherwise.

Fee-rate comparison is exact rational comparison fee_a/ops_a vs fee_b/ops_b
(reference: SurgePricingUtils.cpp feeRate3WayCompare), tie-broken by full
hash for determinism.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

GENERIC_LANE = 0


def fee_rate_cmp(fee_a: int, ops_a: int, fee_b: int, ops_b: int) -> int:
    """3-way compare of fee rates as exact rationals
    (reference: feeRate3WayCompare)."""
    lhs = fee_a * ops_b
    rhs = fee_b * ops_a
    return (lhs > rhs) - (lhs < rhs)


def compute_per_op_fee(fee: int, ops: int, rounding_up: bool) -> int:
    ops = max(1, ops)
    if rounding_up:
        return -(-fee // ops)
    return fee // ops


class SurgePricingLaneConfig:
    """Lane limits + classifier. `lane_of(tx)` returns the lane index;
    `limits[lane]` is the op-count capacity of that lane; limits[0] is the
    total capacity (reference: DexLimitingLaneConfig)."""

    def __init__(self, limits: Sequence[int],
                 lane_of: Optional[Callable[[object], int]] = None):
        assert len(limits) >= 1
        self.limits = list(limits)
        self._lane_of = lane_of or (lambda tx: GENERIC_LANE)

    def lane_of(self, tx) -> int:
        lane = self._lane_of(tx)
        assert 0 <= lane < len(self.limits)
        return lane


def surge_pricing_filter(
        txs: Sequence[object],
        config: SurgePricingLaneConfig,
) -> Tuple[List[object], Dict[int, Optional[int]]]:
    """Pick the highest-paying txs that fit the lane limits, visiting
    each ACCOUNT's txs in seqnum order (reference:
    SurgePricingPriorityQueue::popTopTxs over per-account TxStacks —
    a stack's priority is its NEXT tx's fee rate, and a stack whose
    next tx doesn't fit is dropped whole, since the rest of the chain
    would be seqnum-gapped and invalid).

    Returns (included txs, {lane: clearing base_fee or None}). The
    clearing fee is set for a lane iff at least one tx was excluded from
    it (or from the generic capacity while the tx was in that lane)."""
    import heapq
    from fractions import Fraction

    by_acct: Dict[bytes, List[object]] = {}
    for tx in txs:
        by_acct.setdefault(tx.source_id.to_bytes(), []).append(tx)

    def head_key(tx):
        # max fee rate first; hash ascending tie-break (deterministic,
        # reference: TxStackComparator's hash tie-break)
        return (-Fraction(tx.inclusion_fee(),
                          max(1, tx.num_operations())), tx.full_hash())

    heads = []
    for acct, chain in by_acct.items():
        chain.sort(key=lambda t: t.seq_num)
        # duplicate seqnums (e.g. a replace-by-fee race in the queue)
        # can't both apply: keep the best-paying per seqnum so the
        # emitted set stays chain-valid
        dedup: List[object] = []
        for t in chain:
            if dedup and dedup[-1].seq_num == t.seq_num:
                if fee_rate_cmp(t.inclusion_fee(),
                                max(1, t.num_operations()),
                                dedup[-1].inclusion_fee(),
                                max(1, dedup[-1].num_operations())) > 0:
                    dedup[-1] = t
            else:
                dedup.append(t)
        by_acct[acct] = dedup
        heapq.heappush(heads, (*head_key(dedup[0]), acct, 0))

    remaining = list(config.limits)
    included: List[object] = []
    lane_overflowed: Dict[int, bool] = {}
    lane_min_rate: Dict[int, Tuple[int, int]] = {}

    while heads:
        _, _, acct, idx = heapq.heappop(heads)
        tx = by_acct[acct][idx]
        lane = config.lane_of(tx)
        ops = max(1, tx.num_operations())
        fits_generic = remaining[GENERIC_LANE] >= ops
        fits_lane = (lane == GENERIC_LANE or remaining[lane] >= ops)
        if fits_generic and fits_lane:
            remaining[GENERIC_LANE] -= ops
            if lane != GENERIC_LANE:
                remaining[lane] -= ops
            included.append(tx)
            r = (tx.inclusion_fee(), ops)
            cur = lane_min_rate.get(lane)
            if cur is None or fee_rate_cmp(r[0], r[1], cur[0], cur[1]) < 0:
                lane_min_rate[lane] = r
            if idx + 1 < len(by_acct[acct]):
                nxt = by_acct[acct][idx + 1]
                heapq.heappush(heads, (*head_key(nxt), acct, idx + 1))
        else:
            # the whole remaining chain of this account is excluded:
            # an excluded tx surges its own lane; if it failed on
            # generic capacity it surges every lane (reference:
            # popTopTxs hadTxNotFittingLane semantics)
            if not fits_generic:
                for ln in range(len(config.limits)):
                    lane_overflowed[ln] = True
            else:
                lane_overflowed[lane] = True

    base_fees: Dict[int, Optional[int]] = {}
    for lane in range(len(config.limits)):
        if lane_overflowed.get(lane) and lane in lane_min_rate:
            fee, ops = lane_min_rate[lane]
            base_fees[lane] = compute_per_op_fee(fee, ops, rounding_up=False)
        else:
            base_fees[lane] = None
    return included, base_fees


