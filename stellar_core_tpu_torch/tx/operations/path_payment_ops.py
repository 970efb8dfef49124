"""Path payments: strict receive + strict send.

Reference: transactions/PathPaymentOpFrameBase.cpp (shared dest/source
balance updates + convert filter), PathPaymentStrictReceiveOpFrame.cpp
(fixed destination amount, hops walked backwards computing what must be
sent), PathPaymentStrictSendOpFrame.cpp (fixed send amount, hops walked
forwards computing what arrives).
"""

from __future__ import annotations

from typing import List

from ...xdr.ledger_entries import Asset, AssetType, LedgerKey
from ...xdr.results import (ClaimAtom, PathPaymentStrictReceiveResultCode,
                            PathPaymentStrictSendResultCode,
                            SimplePaymentResult,
                            _PathPaymentStrictReceiveSuccess,
                            _PathPaymentStrictSendSuccess)
from ...xdr.transaction import OperationType
from ...ledger.ledger_txn import LedgerTxn
from .. import tx_utils
from ..offer_exchange import (ConvertResult, OfferFilterResult,
                              convert_with_offers_and_pools)
from ..offer_math import RoundingType
from ..operation_frame import OperationFrame, register_op
from .offer_ops import MAX_OFFERS_TO_CROSS

INT64_MAX = 2**63 - 1


class PathPaymentOpFrameBase(OperationFrame):
    RC = PathPaymentStrictReceiveResultCode
    PREFIX = "PATH_PAYMENT_STRICT_RECEIVE"

    def _rc(self, name: str):
        return getattr(self.RC, f"{self.PREFIX}_{name}")

    def _fail(self, name: str) -> bool:
        self.set_inner_result(self._rc(name))
        return False

    # ------------------------------------------------------------ balances --
    def _credit_dest(self, ltx, header, dest_id, asset, amount) -> bool:
        native = asset.disc == AssetType.ASSET_TYPE_NATIVE
        issuer = None if native else tx_utils.asset_issuer(asset)
        if not native and issuer.to_bytes() == dest_id.to_bytes():
            return True  # burn at the issuer
        if not ltx.entry_exists(LedgerKey.account(dest_id)):
            return self._fail("NO_DESTINATION")
        if native:
            dest_le = ltx.load(LedgerKey.account(dest_id))
            if not tx_utils.add_balance_account(header, dest_le.data.value,
                                                amount):
                return self._fail("LINE_FULL")
            return True
        tl_le = tx_utils.load_trustline(ltx, dest_id, asset)
        if tl_le is None:
            return self._fail("NO_TRUST")
        tl = tl_le.data.value
        if not tx_utils.is_authorized(tl):
            return self._fail("NOT_AUTHORIZED")
        if not tx_utils.add_balance_trustline(tl, amount):
            return self._fail("LINE_FULL")
        return True

    def _debit_source(self, ltx, header, asset, amount) -> bool:
        native = asset.disc == AssetType.ASSET_TYPE_NATIVE
        src_id = self.source_id
        if native:
            src_le = ltx.load(LedgerKey.account(src_id))
            if not tx_utils.add_balance_account(header, src_le.data.value,
                                                -amount):
                return self._fail("UNDERFUNDED")
            return True
        issuer = tx_utils.asset_issuer(asset)
        if issuer.to_bytes() == src_id.to_bytes():
            return True  # mint at the issuer
        tl_le = tx_utils.load_trustline(ltx, src_id, asset)
        if tl_le is None:
            return self._fail("SRC_NO_TRUST")
        tl = tl_le.data.value
        if not tx_utils.is_authorized(tl):
            return self._fail("SRC_NOT_AUTHORIZED")
        if not tx_utils.add_balance_trustline(tl, -amount):
            return self._fail("UNDERFUNDED")
        return True

    def _convert(self, ltx, sheep: Asset, max_sheep: int, wheat: Asset,
                 max_wheat: int, round_type, trail: List[ClaimAtom]):
        """One hop through book AND pool — whichever gives the taker the
        strictly better price wins (reference:
        PathPaymentOpFrameBase::convert → convertWithOffersAndPools;
        the protocol-18 gate + the pool-trading-disabled header flag
        live inside exchange_with_pool, so pre-18 ledgers cross offers
        only). The source crossing its own offer aborts the whole
        payment (OFFER_CROSS_SELF). The 1000-offer work limit is
        PER OPERATION: each hop gets only the remaining budget
        (reference passes getMaxOffersToCross() - offersCrossed)."""

        def offer_filter(entry):
            o = entry.data.value
            if o.sellerID.to_bytes() == self.source_id.to_bytes():
                return OfferFilterResult.eStopCrossSelf
            return OfferFilterResult.eKeep

        hop: List[ClaimAtom] = []
        # the 1000-offer work limit exists from protocol 11
        # (FIRST_PROTOCOL_SUPPORTING_OPERATION_LIMITS); it is PER
        # OPERATION, so each hop gets only the remaining budget
        # (reference passes getMaxOffersToCross() - offersCrossed)
        budget = MAX_OFFERS_TO_CROSS - len(trail) \
            if ltx.get_header().ledgerVersion >= 11 else INT64_MAX
        r, sheep_sent, wheat_received = convert_with_offers_and_pools(
            ltx, sheep, max_sheep, wheat, max_wheat, round_type,
            offer_filter, hop, budget)
        trail.extend(hop)
        return r, sheep_sent, wheat_received

    def _map_convert_error(self, r) -> bool:
        """Shared terminal ConvertResult mapping (reference:
        PathPaymentOpFrameBase::convert switch); True = result set."""
        if r == ConvertResult.eFilterStopCrossSelf:
            self._fail("OFFER_CROSS_SELF")
            return True
        if r == ConvertResult.eCrossedTooMany:
            from ...xdr.results import OperationResultCode
            self.set_outer_result(
                OperationResultCode.opEXCEEDED_WORK_LIMIT)
            return True
        return False

    # ------------------------------------------------------------ validity --
    def _check_common(self, send_asset, dest_asset, path,
                      amounts) -> bool:
        if any(a <= 0 for a in amounts):
            return self._fail("MALFORMED")
        if not tx_utils.is_asset_valid(send_asset) or \
                not tx_utils.is_asset_valid(dest_asset):
            return self._fail("MALFORMED")
        if any(not tx_utils.is_asset_valid(a) for a in path):
            return self._fail("MALFORMED")
        return True


@register_op(OperationType.PATH_PAYMENT_STRICT_RECEIVE)
class PathPaymentStrictReceiveOpFrame(PathPaymentOpFrameBase):
    RC = PathPaymentStrictReceiveResultCode
    PREFIX = "PATH_PAYMENT_STRICT_RECEIVE"

    def do_check_valid(self, header, ledger_version: int) -> bool:
        b = self.body
        return self._check_common(b.sendAsset, b.destAsset, list(b.path),
                                  [b.sendMax, b.destAmount])

    def do_apply(self, ltx_outer, header_outer, ctx) -> bool:
        b = self.body
        dest_id = b.destination.account_id()
        with LedgerTxn(ltx_outer) as ltx:
            header = ltx.load_header()
            if not self._credit_dest(ltx, header, dest_id, b.destAsset,
                                     b.destAmount):
                return False
            offer_trail: List[ClaimAtom] = []
            cur_amount = b.destAmount
            cur_asset = b.destAsset
            full_path = [b.sendAsset] + list(b.path)
            for asset in reversed(full_path):
                if asset.to_bytes() == cur_asset.to_bytes():
                    continue
                r, sheep_sent, wheat_received = self._convert(
                    ltx, asset, INT64_MAX, cur_asset, cur_amount,
                    RoundingType.PATH_PAYMENT_STRICT_RECEIVE, offer_trail)
                if self._map_convert_error(r):
                    return False
                if r != ConvertResult.eOK or wheat_received != cur_amount:
                    return self._fail("TOO_FEW_OFFERS")
                cur_amount = sheep_sent
                cur_asset = asset
            if cur_amount > b.sendMax:
                return self._fail("OVER_SENDMAX")
            if not self._debit_source(ltx, header, b.sendAsset,
                                      cur_amount):
                return False
            self.set_inner_result(
                self._rc("SUCCESS"),
                _PathPaymentStrictReceiveSuccess(
                    offers=offer_trail,
                    last=SimplePaymentResult(
                        destination=dest_id, asset=b.destAsset,
                        amount=b.destAmount)))
            ltx.commit()
            return True


@register_op(OperationType.PATH_PAYMENT_STRICT_SEND)
class PathPaymentStrictSendOpFrame(PathPaymentOpFrameBase):
    RC = PathPaymentStrictSendResultCode
    PREFIX = "PATH_PAYMENT_STRICT_SEND"

    def do_check_valid(self, header, ledger_version: int) -> bool:
        b = self.body
        return self._check_common(b.sendAsset, b.destAsset, list(b.path),
                                  [b.sendAmount, b.destMin])

    def do_apply(self, ltx_outer, header_outer, ctx) -> bool:
        b = self.body
        dest_id = b.destination.account_id()
        with LedgerTxn(ltx_outer) as ltx:
            header = ltx.load_header()
            if not self._debit_source(ltx, header, b.sendAsset,
                                      b.sendAmount):
                return False
            offer_trail: List[ClaimAtom] = []
            cur_amount = b.sendAmount
            cur_asset = b.sendAsset
            full_path = list(b.path) + [b.destAsset]
            for asset in full_path:
                if asset.to_bytes() == cur_asset.to_bytes():
                    continue
                r, sheep_sent, wheat_received = self._convert(
                    ltx, cur_asset, cur_amount, asset, INT64_MAX,
                    RoundingType.PATH_PAYMENT_STRICT_SEND, offer_trail)
                if self._map_convert_error(r):
                    return False
                if r != ConvertResult.eOK or sheep_sent != cur_amount:
                    return self._fail("TOO_FEW_OFFERS")
                cur_amount = wheat_received
                cur_asset = asset
            if cur_amount < b.destMin:
                return self._fail("UNDER_DESTMIN")
            if not self._credit_dest(ltx, header, dest_id, b.destAsset,
                                     cur_amount):
                return False
            self.set_inner_result(
                self._rc("SUCCESS"),
                _PathPaymentStrictSendSuccess(
                    offers=offer_trail,
                    last=SimplePaymentResult(
                        destination=dest_id, asset=b.destAsset,
                        amount=cur_amount)))
            ltx.commit()
            return True
