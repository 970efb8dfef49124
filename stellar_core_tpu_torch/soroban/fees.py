"""Soroban resource + rent fee model.

Reference: the fee computations exported over the Rust bridge
(rust/src/lib.rs `compute_transaction_resource_fee`, `compute_rent_fee`,
`compute_write_fee_per_1kb`; implemented in soroban-env-host's
fees.rs). Deterministic integer math only.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

DATA_SIZE_1KB_INCREMENT = 1024
INSTRUCTIONS_INCREMENT = 10_000
MINIMUM_WRITE_FEE_PER_1KB = 1000
TTL_ENTRY_SIZE = 48  # serialized TTLEntry bytes, charged per write


def _num_increments(x: int, increment: int) -> int:
    return (x + increment - 1) // increment


def compute_write_fee_per_1kb(bucket_list_size: int, cost) -> int:
    """Write fee grows linearly up to the bucket-list target, then by
    the growth factor beyond it (reference: compute_write_fee_per_1kb)."""
    if cost is None:
        return MINIMUM_WRITE_FEE_PER_1KB
    low, high = cost.writeFee1KBBucketListLow, cost.writeFee1KBBucketListHigh
    target = max(1, cost.bucketListTargetSizeBytes)
    if bucket_list_size < target:
        fee = low + (high - low) * bucket_list_size // target
    else:
        fee = high + (bucket_list_size - target) * \
            cost.bucketListWriteFeeGrowthFactor * (high - low) // target
    return max(fee, MINIMUM_WRITE_FEE_PER_1KB)


def compute_transaction_resource_fee(resources, tx_size_bytes: int,
                                     events_size_bytes: int,
                                     config,
                                     bucket_list_size: int = 0
                                     ) -> Tuple[int, int]:
    """Returns (non_refundable_fee, refundable_fee) in stroops
    (reference: compute_transaction_resource_fee; refundable = events +
    rent portions, non-refundable = compute + IO + bandwidth +
    historical)."""
    compute_rate = config.fee_rate_per_instructions_increment
    cost = config.ledger_cost
    bw = config.bandwidth
    hist = config.historical
    ev = config.events_cfg

    fee = 0
    # compute
    fee += _num_increments(resources.instructions,
                           INSTRUCTIONS_INCREMENT) * compute_rate
    # ledger IO
    n_reads = len(resources.footprint.readOnly) + \
        len(resources.footprint.readWrite)
    n_writes = len(resources.footprint.readWrite)
    if cost is not None:
        fee += n_reads * cost.feeReadLedgerEntry
        fee += n_writes * cost.feeWriteLedgerEntry
        fee += _num_increments(resources.readBytes,
                               DATA_SIZE_1KB_INCREMENT) * cost.feeRead1KB
        write_fee_1kb = compute_write_fee_per_1kb(bucket_list_size, cost)
        fee += _num_increments(resources.writeBytes,
                               DATA_SIZE_1KB_INCREMENT) * write_fee_1kb
    # bandwidth + historical (tx size)
    if bw is not None:
        fee += _num_increments(tx_size_bytes,
                               DATA_SIZE_1KB_INCREMENT) * bw.feeTxSize1KB
    if hist is not None:
        fee += _num_increments(tx_size_bytes + TTL_ENTRY_SIZE,
                               DATA_SIZE_1KB_INCREMENT) * \
            hist.feeHistorical1KB
    # refundable: events
    refundable = 0
    if ev is not None:
        refundable += _num_increments(
            events_size_bytes, DATA_SIZE_1KB_INCREMENT) * \
            ev.feeContractEvents1KB
    return fee, refundable


def compute_rent_fee(entry_changes: List[dict], config,
                     bucket_list_size: int, current_ledger: int) -> int:
    """Rent for TTL extensions + size growth (reference:
    compute_rent_fee; entry_changes: [{is_persistent, old_size_bytes,
    new_size_bytes, old_live_until, new_live_until}])."""
    sa = config.state_archival
    cost = config.ledger_cost
    write_fee_1kb = compute_write_fee_per_1kb(bucket_list_size, cost)
    total = 0
    for ch in entry_changes:
        denom = sa.persistentRentRateDenominator if ch["is_persistent"] \
            else sa.tempRentRateDenominator
        old_until = ch.get("old_live_until", 0)
        new_until = ch["new_live_until"]
        size = max(ch["new_size_bytes"], 1)
        extension = max(0, new_until - max(old_until, current_ledger - 1))
        if extension > 0 and denom > 0:
            # fee = size * extension * writeFee / (1KB * denominator)
            total += (size * extension * write_fee_1kb) // \
                (DATA_SIZE_1KB_INCREMENT * denom)
        # size growth on already-live entries also pays rent
        growth = max(0, ch["new_size_bytes"] - ch.get("old_size_bytes", 0))
        if growth and old_until > current_ledger and denom > 0:
            remaining = old_until - current_ledger
            total += (growth * remaining * write_fee_1kb) // \
                (DATA_SIZE_1KB_INCREMENT * denom)
    return total
