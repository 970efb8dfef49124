from .manager import (Invariant, InvariantDoesNotHold, InvariantManager,
                      OperationDelta)
from .invariants import (AccountSubEntriesCountIsValid, ConservationOfLumens,
                         ConstantProductInvariant, LedgerEntryIsValid,
                         LiabilitiesMatchOffers, OrderBookIsNotCrossed,
                         SponsorshipCountIsValid,
                         BucketListIsConsistentWithDatabase,
                         register_default_invariants)

__all__ = [
    "Invariant", "InvariantDoesNotHold", "InvariantManager", "OperationDelta",
    "AccountSubEntriesCountIsValid", "ConservationOfLumens",
    "ConstantProductInvariant", "LedgerEntryIsValid",
    "LiabilitiesMatchOffers", "OrderBookIsNotCrossed",
    "SponsorshipCountIsValid", "BucketListIsConsistentWithDatabase",
    "register_default_invariants",
]
