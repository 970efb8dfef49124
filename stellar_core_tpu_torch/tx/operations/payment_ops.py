"""Payment operation (direct credit/native transfer).

Reference: transactions/PaymentOpFrame.cpp — the reference routes
payment through a synthesized PathPaymentStrictReceive with an empty
path and rewrites result codes; since an empty-path payment never touches
the order book, this build implements the transfer directly with the same
semantics (self-payment instant success, issuer mint/burn, trustline
authorization and limit checks, protocol>=13 no-issuer-existence rule).
Path payments (with real paths) live in offer_ops alongside OfferExchange.
"""

from __future__ import annotations

from ...xdr.ledger_entries import AssetType, LedgerKey, TrustLineAsset
from ...xdr.transaction import OperationType
from ...xdr.results import PaymentResultCode
from .. import tx_utils
from ..operation_frame import OperationFrame, register_op
from ..sponsorship import ApplyContext


@register_op(OperationType.PAYMENT)
class PaymentOpFrame(OperationFrame):

    def do_check_valid(self, header, ledger_version: int) -> bool:
        b = self.body
        if b.amount <= 0:
            self.set_inner_result(PaymentResultCode.PAYMENT_MALFORMED)
            return False
        if not tx_utils.is_asset_valid(b.asset):
            self.set_inner_result(PaymentResultCode.PAYMENT_MALFORMED)
            return False
        return True

    def do_apply(self, ltx, header, ctx: ApplyContext) -> bool:
        b = self.body
        dest_id = b.destination.account_id()
        src_id = self.source_id
        native = b.asset.disc == AssetType.ASSET_TYPE_NATIVE

        # ed25519 raws compare directly — both are stripped PublicKeys
        if native and bytes(dest_id.value) == bytes(src_id.value):
            self.set_inner_result(PaymentResultCode.PAYMENT_SUCCESS)
            return True

        issuer = tx_utils.asset_issuer(b.asset)
        if not native and header.ledgerVersion < 13:
            if not ltx.entry_exists(LedgerKey.account(issuer)):
                self.set_inner_result(PaymentResultCode.PAYMENT_NO_ISSUER)
                return False

        # destination is credited BEFORE the source is debited (reference
        # routes through PathPaymentStrictReceive: updateDestBalance first)
        # so dest-side errors win and self-payments over one trustline work
        if native:
            # existence check folds into the (recording) load
            dest_le = ltx.load(LedgerKey.account(dest_id))
            if dest_le is None:
                self.set_inner_result(
                    PaymentResultCode.PAYMENT_NO_DESTINATION)
                return False
            if not tx_utils.add_balance_account(
                    header, dest_le.data.value, b.amount):
                self.set_inner_result(PaymentResultCode.PAYMENT_LINE_FULL)
                return False
        elif issuer.to_bytes() == dest_id.to_bytes():
            pass  # issuer burns: no destination trustline
        elif not ltx.entry_exists(LedgerKey.account(dest_id)):
            self.set_inner_result(PaymentResultCode.PAYMENT_NO_DESTINATION)
            return False
        else:
            tl_le = tx_utils.load_trustline(ltx, dest_id, b.asset)
            if tl_le is None:
                self.set_inner_result(PaymentResultCode.PAYMENT_NO_TRUST)
                return False
            tl = tl_le.data.value
            if not tx_utils.is_authorized(tl):
                self.set_inner_result(PaymentResultCode.
                                      PAYMENT_NOT_AUTHORIZED)
                return False
            if not tx_utils.add_balance_trustline(tl, b.amount):
                self.set_inner_result(PaymentResultCode.PAYMENT_LINE_FULL)
                return False

        # ---- debit the source ----
        if native:
            src_le = self.load_source_account(ltx)
            if not tx_utils.add_balance_account(
                    header, src_le.data.value, -b.amount):
                self.set_inner_result(PaymentResultCode.PAYMENT_UNDERFUNDED)
                return False
        elif issuer.to_bytes() == src_id.to_bytes():
            pass  # issuer mints: no source trustline
        else:
            tl_le = tx_utils.load_trustline(ltx, src_id, b.asset)
            if tl_le is None:
                self.set_inner_result(PaymentResultCode.PAYMENT_SRC_NO_TRUST)
                return False
            tl = tl_le.data.value
            if not tx_utils.is_authorized(tl):
                self.set_inner_result(PaymentResultCode.
                                      PAYMENT_SRC_NOT_AUTHORIZED)
                return False
            if not tx_utils.add_balance_trustline(tl, -b.amount):
                self.set_inner_result(PaymentResultCode.PAYMENT_UNDERFUNDED)
                return False

        self.set_inner_result(PaymentResultCode.PAYMENT_SUCCESS)
        return True
