from .tx_set import (ApplicableTxSet, TxSetFrame, make_tx_set_from_transactions)
from .tx_queue import TransactionQueue, AddResult
from .upgrades import Upgrades
from .surge_pricing import SurgePricingLaneConfig, surge_pricing_filter

__all__ = [
    "ApplicableTxSet", "TxSetFrame", "make_tx_set_from_transactions",
    "TransactionQueue", "AddResult", "Upgrades",
    "SurgePricingLaneConfig", "surge_pricing_filter",
]
