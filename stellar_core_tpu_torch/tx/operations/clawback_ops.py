"""Clawback operation.

Reference: transactions/ClawbackOpFrame.cpp — the asset issuer pulls
back `amount` from `from`'s trust line; requires the trust line's
TRUSTLINE_CLAWBACK_ENABLED flag; the clawed-back amount must fit the
line's available balance (balance minus selling liabilities).
"""

from __future__ import annotations

from ...xdr.ledger_entries import AssetType, LedgerKey, TrustLineFlags
from ...xdr.results import ClawbackResultCode
from ...xdr.transaction import OperationType
from .. import tx_utils
from ..operation_frame import OperationFrame, register_op


@register_op(OperationType.CLAWBACK)
class ClawbackOpFrame(OperationFrame):

    def do_check_valid(self, header, ledger_version: int) -> bool:
        b = self.body
        rc = ClawbackResultCode
        if b.amount <= 0 or not tx_utils.is_asset_valid(b.asset) or \
                b.asset.disc == AssetType.ASSET_TYPE_NATIVE:
            self.set_inner_result(rc.CLAWBACK_MALFORMED)
            return False
        issuer = tx_utils.asset_issuer(b.asset)
        if issuer.to_bytes() != self.source_id.to_bytes():
            self.set_inner_result(rc.CLAWBACK_MALFORMED)
            return False
        if b.from_.account_id().to_bytes() == self.source_id.to_bytes():
            self.set_inner_result(rc.CLAWBACK_MALFORMED)
            return False
        return True

    def do_apply(self, ltx, header, ctx) -> bool:
        b = self.body
        rc = ClawbackResultCode
        from_id = b.from_.account_id()
        tl_le = tx_utils.load_trustline(ltx, from_id, b.asset)
        if tl_le is None:
            self.set_inner_result(rc.CLAWBACK_NO_TRUST)
            return False
        tl = tl_le.data.value
        if not (tl.flags &
                TrustLineFlags.TRUSTLINE_CLAWBACK_ENABLED_FLAG):
            self.set_inner_result(rc.CLAWBACK_NOT_CLAWBACK_ENABLED)
            return False
        available = tl.balance - tx_utils._tl_selling_liabilities(tl)
        if available < b.amount:
            self.set_inner_result(rc.CLAWBACK_UNDERFUNDED)
            return False
        tl.balance -= b.amount
        self.set_inner_result(rc.CLAWBACK_SUCCESS)
        return True
