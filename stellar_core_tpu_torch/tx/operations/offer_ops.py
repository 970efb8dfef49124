"""Order-book operations: ManageSellOffer, ManageBuyOffer,
CreatePassiveSellOffer.

Reference: transactions/ManageOfferOpFrameBase.cpp (apply at :214 —
release old liabilities / pre-establish reserve, cross the book through
convertWithOffersAndPools with passive/self filters, settle balances,
adjust + recreate the residual offer, acquire liabilities),
ManageSellOfferOpFrame.cpp, ManageBuyOfferOpFrame.cpp (buy amount and
inverted price mapped onto the sell machinery),
CreatePassiveSellOfferOpFrame.cpp.
"""

from __future__ import annotations

from typing import List, Optional

from ...xdr.ledger_entries import (Asset, AssetType, LedgerEntry,
                                   LedgerEntryType, LedgerKey, OfferEntry,
                                   OfferEntryFlags, Price,
                                   _LedgerEntryData, _LedgerEntryExt)
from ...xdr.results import (ClaimAtom, ManageBuyOfferResultCode,
                            ManageOfferEffect, ManageOfferSuccessResult,
                            ManageSellOfferResultCode, OperationResultCode,
                            _ManageOfferEffectUnion)
from ...xdr.transaction import OperationType
from ...xdr.types import ExtensionPoint
from ...ledger.ledger_txn import LedgerTxn
from ..operation_frame import OperationFrame, register_op
from ..offer_exchange import (ConvertResult, OfferFilterResult,
                              can_buy_at_most, can_sell_at_most,
                              convert_with_offers)
from ..offer_math import (Rounding, RoundingType, adjust_offer_amount,
                          big_divide, exchange_v10_without_price_error_thresholds)
from .. import liabilities as liab
from .. import tx_utils
from ..sponsorship import (SponsorshipResult,
                           create_entry_with_possible_sponsorship,
                           remove_entry_with_possible_sponsorship)

INT64_MAX = 2**63 - 1
# reference: getMaxOffersToCross / MAX_OFFERS_TO_CROSS
MAX_OFFERS_TO_CROSS = 1000


def _price_cmp(a: Price, b: Price) -> int:
    """a.n/a.d vs b.n/b.d in exact integer math."""
    lhs = a.n * b.d
    rhs = b.n * a.d
    return (lhs > rhs) - (lhs < rhs)


class ManageOfferOpFrameBase(OperationFrame):
    """Shared apply machinery; subclasses define the (sheep, wheat,
    amount, price, offerID, passive) view and result codes."""

    RC = ManageSellOfferResultCode
    PREFIX = "MANAGE_SELL_OFFER"

    # ---- subclass view ----
    def sheep(self) -> Asset:
        return self.body.selling

    def wheat(self) -> Asset:
        return self.body.buying

    def offer_id(self) -> int:
        return self.body.offerID

    def sell_price(self) -> Price:
        return self.body.price

    def is_delete(self) -> bool:
        return self.body.amount == 0

    def set_passive_on_create(self) -> bool:
        return False

    def apply_operation_specific_limits(self, sheep_send_limit: int,
                                        sheep_sent: int,
                                        wheat_receive_limit: int,
                                        wheat_received: int) -> tuple:
        limit = min(sheep_send_limit, self.body.amount - sheep_sent)
        return limit, wheat_receive_limit


    # ---- result helpers ----
    def _rc(self, name: str):
        return getattr(self.RC, f"{self.PREFIX}_{name}")

    def _fail(self, name: str) -> bool:
        self.set_inner_result(self._rc(name))
        return False

    def _success(self) -> ManageOfferSuccessResult:
        self.set_inner_result(self._rc("SUCCESS"),
                              ManageOfferSuccessResult(
                                  offersClaimed=[],
                                  offer=_ManageOfferEffectUnion(
                                      ManageOfferEffect
                                      .MANAGE_OFFER_DELETED)))
        return self.result.value.value.value

    # ---- validity ----
    def do_check_valid(self, header, ledger_version: int) -> bool:
        sheep, wheat = self.sheep(), self.wheat()
        price = self.sell_price()
        if not tx_utils.is_asset_valid(sheep) or \
                not tx_utils.is_asset_valid(wheat):
            return self._fail("MALFORMED")
        if sheep.to_bytes() == wheat.to_bytes():
            return self._fail("MALFORMED")
        if self._raw_amount() < 0 or price.d <= 0 or price.n <= 0:
            return self._fail("MALFORMED")
        if self.offer_id() < 0:
            return self._fail("MALFORMED")
        if self.offer_id() == 0 and self.is_delete():
            return self._fail("NOT_FOUND")
        return True

    def _raw_amount(self) -> int:
        return self.body.amount

    # ---- apply ----
    def _check_offer_valid(self, ltx_outer, header) -> bool:
        """reference: checkOfferValid — rolled-back probe."""
        if self.is_delete():
            return True
        with LedgerTxn(ltx_outer) as ltx:
            if True:
                sheep, wheat = self.sheep(), self.wheat()
                if sheep.disc != AssetType.ASSET_TYPE_NATIVE and \
                        tx_utils.asset_issuer(sheep).to_bytes() != \
                        self.source_id.to_bytes():
                    tl = tx_utils.load_trustline(ltx, self.source_id, sheep)
                    if tl is None:
                        return self._fail("SELL_NO_TRUST")
                    if tl.data.value.balance == 0:
                        return self._fail("UNDERFUNDED")
                    if not tx_utils.is_authorized(tl.data.value):
                        return self._fail("SELL_NOT_AUTHORIZED")
                if wheat.disc != AssetType.ASSET_TYPE_NATIVE and \
                        tx_utils.asset_issuer(wheat).to_bytes() != \
                        self.source_id.to_bytes():
                    tl = tx_utils.load_trustline(ltx, self.source_id, wheat)
                    if tl is None:
                        return self._fail("BUY_NO_TRUST")
                    if not tx_utils.is_authorized(tl.data.value):
                        return self._fail("BUY_NOT_AUTHORIZED")
                return True  # with-exit rolls the probe back

    def _build_offer(self, amount: int, flags: int, ext) -> LedgerEntry:
        return LedgerEntry(
            lastModifiedLedgerSeq=0,
            data=_LedgerEntryData(LedgerEntryType.OFFER, OfferEntry(
                sellerID=self.source_id, offerID=self.offer_id(),
                selling=self.sheep(), buying=self.wheat(),
                amount=amount, price=self.sell_price(), flags=flags,
                ext=ExtensionPoint(0))),
            ext=ext)

    def _offer_buying_liabilities(self) -> int:
        ex = exchange_v10_without_price_error_thresholds(
            self.sell_price(), self._raw_amount(), INT64_MAX, INT64_MAX,
            INT64_MAX, RoundingType.NORMAL)
        return ex.num_sheep_send

    def _offer_selling_liabilities(self) -> int:
        ex = exchange_v10_without_price_error_thresholds(
            self.sell_price(), self._raw_amount(), INT64_MAX, INT64_MAX,
            INT64_MAX, RoundingType.NORMAL)
        return ex.num_wheat_received

    def do_apply(self, ltx_outer, header_outer, ctx) -> bool:
        with LedgerTxn(ltx_outer) as ltx:
            ok = self._do_apply_inner(ltx, ctx)
            if ok:
                ltx.commit()
            else:
                ltx.rollback()
            return ok

    def _do_apply_inner(self, ltx, ctx) -> bool:
        header = ltx.load_header()
        if not self._check_offer_valid(ltx, header):
            return False

        creating = False
        passive = False
        flags = 0
        extension = _LedgerEntryExt(0)

        if self.offer_id():
            offer_le = ltx.load(LedgerKey.offer(self.source_id,
                                                self.offer_id()))
            if offer_le is None:
                return self._fail("NOT_FOUND")
            liab.release_liabilities(ltx, header, offer_le)
            flags = offer_le.data.value.flags
            passive = bool(flags & OfferEntryFlags.PASSIVE_FLAG)
            extension = offer_le.ext
            ltx.erase(LedgerKey.offer(self.source_id, self.offer_id()))
        else:
            creating = True
            passive = self.set_passive_on_create()
            flags = OfferEntryFlags.PASSIVE_FLAG if passive else 0
            le = self._build_offer(0, 0, _LedgerEntryExt(0))
            source_le = ltx.load(LedgerKey.account(self.source_id))
            res = create_entry_with_possible_sponsorship(
                ltx, header, le, source_le, ctx)
            if res == SponsorshipResult.LOW_RESERVE:
                return self._fail("LOW_RESERVE")
            if res == SponsorshipResult.TOO_MANY_SUBENTRIES:
                self.set_outer_result(
                    OperationResultCode.opTOO_MANY_SUBENTRIES)
                return False
            if res == SponsorshipResult.TOO_MANY_SPONSORING:
                self.set_outer_result(
                    OperationResultCode.opTOO_MANY_SPONSORING)
                return False
            if res != SponsorshipResult.SUCCESS:
                raise RuntimeError("unexpected sponsorship result")
            extension = le.ext

        success = self._success()
        amount = 0
        sheep, wheat = self.sheep(), self.wheat()

        if not self.is_delete():
            # compute exchange caps on a rolled-back probe
            with LedgerTxn(ltx) as probe:
                ph = probe.load_header()
                max_wheat_receive = can_buy_at_most(
                    probe, ph, self.source_id, wheat)
                max_sheep_send = can_sell_at_most(
                    probe, ph, self.source_id, sheep)
                # liabilities must fit (reference: LINE_FULL /
                # UNDERFUNDED checks against available limit/balance)
                if max_wheat_receive < self._offer_buying_liabilities():
                    return self._fail("LINE_FULL")
                if max_sheep_send < self._offer_selling_liabilities():
                    return self._fail("UNDERFUNDED")
            if max_wheat_receive == 0:
                return self._fail("LINE_FULL")

            # reference: applyOperationSpecificLimits(maxSheepSend, 0,
            # maxWheatReceive, 0) — same virtual caps the crossing
            max_sheep_send, max_wheat_receive = \
                self.apply_operation_specific_limits(
                    max_sheep_send, 0, max_wheat_receive, 0)

            max_price = Price(n=self.sell_price().d,
                              d=self.sell_price().n)

            def offer_filter(entry):
                o = entry.data.value
                if o.offerID == self.offer_id():
                    raise RuntimeError("crossing own replaced offer")
                cmp = _price_cmp(o.price, max_price)
                if (passive and cmp >= 0) or cmp > 0:
                    return OfferFilterResult.eStopBadPrice
                if o.sellerID.to_bytes() == self.source_id.to_bytes():
                    return OfferFilterResult.eStopCrossSelf
                return OfferFilterResult.eKeep

            offer_trail: List[ClaimAtom] = []
            r, sheep_sent, wheat_received = convert_with_offers(
                ltx, sheep, max_sheep_send, wheat, max_wheat_receive,
                RoundingType.NORMAL, offer_filter, offer_trail,
                MAX_OFFERS_TO_CROSS)

            if r == ConvertResult.eFilterStopCrossSelf:
                return self._fail("CROSS_SELF")
            if r == ConvertResult.eCrossedTooMany:
                self.set_outer_result(
                    OperationResultCode.opEXCEEDED_WORK_LIMIT)
                return False
            sheep_stays = r in (ConvertResult.ePartial,
                                ConvertResult.eFilterStopBadPrice)

            success.offersClaimed = offer_trail
            header = ltx.load_header()
            if wheat_received > 0:
                from ..offer_exchange import _add_asset_balance
                if not _add_asset_balance(ltx, header, self.source_id,
                                          wheat, wheat_received):
                    raise RuntimeError("offer claimed over limit")
                if not _add_asset_balance(ltx, header, self.source_id,
                                          sheep, -sheep_sent):
                    raise RuntimeError("offer sold more than balance")

            if sheep_stays:
                sheep_send_limit = min(
                    can_sell_at_most(ltx, header, self.source_id, sheep),
                    INT64_MAX)
                wheat_receive_limit = can_buy_at_most(
                    ltx, header, self.source_id, wheat)
                sheep_send_limit, wheat_receive_limit = \
                    self.apply_operation_specific_limits(
                        sheep_send_limit, sheep_sent,
                        wheat_receive_limit, wheat_received)
                amount = adjust_offer_amount(
                    self.sell_price(), sheep_send_limit,
                    wheat_receive_limit)
            else:
                amount = 0

        header = ltx.load_header()
        if amount > 0:
            new_offer = self._build_offer(amount, flags, extension)
            if creating:
                header.idPool += 1
                new_offer.data.value.offerID = header.idPool
                success.offer = _ManageOfferEffectUnion(
                    ManageOfferEffect.MANAGE_OFFER_CREATED,
                    new_offer.data.value)
            else:
                success.offer = _ManageOfferEffectUnion(
                    ManageOfferEffect.MANAGE_OFFER_UPDATED,
                    new_offer.data.value)
            new_offer.lastModifiedLedgerSeq = header.ledgerSeq
            ltx.create(new_offer)
            offer_le = ltx.load(LedgerKey.offer(
                self.source_id, new_offer.data.value.offerID))
            if not liab.acquire_liabilities(ltx, header, offer_le):
                raise RuntimeError("could not acquire offer liabilities")
        else:
            success.offer = _ManageOfferEffectUnion(
                ManageOfferEffect.MANAGE_OFFER_DELETED)
            source_le = ltx.load(LedgerKey.account(self.source_id))
            le = self._build_offer(0, 0, extension)
            remove_entry_with_possible_sponsorship(
                ltx, header, le, source_le)
        return True


@register_op(OperationType.MANAGE_SELL_OFFER)
class ManageSellOfferOpFrame(ManageOfferOpFrameBase):
    RC = ManageSellOfferResultCode
    PREFIX = "MANAGE_SELL_OFFER"


@register_op(OperationType.CREATE_PASSIVE_SELL_OFFER)
class CreatePassiveSellOfferOpFrame(ManageOfferOpFrameBase):
    """reference: CreatePassiveSellOfferOpFrame — always creates, sets
    the passive flag; result shares the sell-offer shape."""
    RC = ManageSellOfferResultCode
    PREFIX = "MANAGE_SELL_OFFER"

    def offer_id(self) -> int:
        return 0

    def is_delete(self) -> bool:
        return False

    def set_passive_on_create(self) -> bool:
        return True

    def do_check_valid(self, header, ledger_version: int) -> bool:
        sheep, wheat = self.sheep(), self.wheat()
        price = self.sell_price()
        if not tx_utils.is_asset_valid(sheep) or \
                not tx_utils.is_asset_valid(wheat) or \
                sheep.to_bytes() == wheat.to_bytes() or \
                self.body.amount <= 0 or price.d <= 0 or price.n <= 0:
            return self._fail("MALFORMED")
        return True


@register_op(OperationType.MANAGE_BUY_OFFER)
class ManageBuyOfferOpFrame(ManageOfferOpFrameBase):
    """Buy semantics on the sell machinery: price inverted, the cap is
    on wheat received (reference: ManageBuyOfferOpFrame)."""
    RC = ManageBuyOfferResultCode
    PREFIX = "MANAGE_BUY_OFFER"

    def sheep(self) -> Asset:
        return self.body.selling

    def wheat(self) -> Asset:
        return self.body.buying

    def sell_price(self) -> Price:
        return Price(n=self.body.price.d, d=self.body.price.n)

    def is_delete(self) -> bool:
        return self.body.buyAmount == 0

    def _raw_amount(self) -> int:
        return self.body.buyAmount

    def _build_offer(self, amount: int, flags: int, ext) -> LedgerEntry:
        le = super()._build_offer(amount, flags, ext)
        # stored offers always carry the sell-side price of the
        # *original* buy price (reference: buildOffer in ManageBuyOffer)
        return le

    def _offer_buying_liabilities(self) -> int:
        # reference: exchangeV10WithoutPriceErrorThresholds(invPrice,
        # INT64_MAX, INT64_MAX, INT64_MAX, buyAmount, NORMAL)
        ex = exchange_v10_without_price_error_thresholds(
            self.sell_price(), INT64_MAX, INT64_MAX, INT64_MAX,
            self.body.buyAmount, RoundingType.NORMAL)
        return ex.num_sheep_send

    def _offer_selling_liabilities(self) -> int:
        ex = exchange_v10_without_price_error_thresholds(
            self.sell_price(), INT64_MAX, INT64_MAX, INT64_MAX,
            self.body.buyAmount, RoundingType.NORMAL)
        return ex.num_wheat_received

    def apply_operation_specific_limits(self, sheep_send_limit: int,
                                        sheep_sent: int,
                                        wheat_receive_limit: int,
                                        wheat_received: int) -> tuple:
        limit = min(wheat_receive_limit,
                    self.body.buyAmount - wheat_received)
        return sheep_send_limit, limit


    def do_check_valid(self, header, ledger_version: int) -> bool:
        sheep, wheat = self.sheep(), self.wheat()
        price = self.body.price
        if not tx_utils.is_asset_valid(sheep) or \
                not tx_utils.is_asset_valid(wheat) or \
                sheep.to_bytes() == wheat.to_bytes() or \
                self.body.buyAmount < 0 or price.d <= 0 or price.n <= 0 \
                or self.body.offerID < 0:
            return self._fail("MALFORMED")
        if self.body.offerID == 0 and self.is_delete():
            return self._fail("NOT_FOUND")
        return True
