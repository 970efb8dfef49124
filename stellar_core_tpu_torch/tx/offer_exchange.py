"""Order-book / liquidity-pool conversion engine.

Reference: transactions/OfferExchange.cpp — `convert_with_offers_and_pools`
walks the best-offer chain (crossOfferV10 per resting offer) or swaps
against the constant-product pool, choosing whichever gives the taker the
strictly better price (maybeConvertWithOffers/shouldConvertWithOffers).

Terminology follows the reference: the taker sends "sheep" and receives
"wheat"; resting offers sell wheat for sheep.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Callable, List, Optional, Tuple

from ..util.checks import releaseAssert
from ..xdr.ledger import LedgerHeaderFlags
from ..xdr.ledger_entries import (AssetType, LedgerEntry, LedgerKey,
                                  OfferEntry, Price)
from ..xdr.results import (ClaimAtom, ClaimAtomType, ClaimOfferAtom,
                           ClaimLiquidityAtom)
from ..xdr.types import AccountID
from . import liabilities as liab
from . import offer_math, tx_utils
from .offer_math import Rounding, RoundingType, exchange_v10
from .pool_trust import LIQUIDITY_POOL_FEE_V18, pool_id_for_assets
from .sponsorship import remove_entry_with_possible_sponsorship
from ..ledger.ledger_txn import LedgerTxn

INT64_MAX = 2**63 - 1
MAX_OFFERS_TO_CROSS = 1000


class ConvertResult(IntEnum):
    eOK = 0
    ePartial = 1
    eFilterStopBadPrice = 2
    eFilterStopCrossSelf = 3
    eCrossedTooMany = 4


class OfferFilterResult(IntEnum):
    eKeep = 0
    eStopBadPrice = 1
    eStopCrossSelf = 2


class CrossOfferResult(IntEnum):
    eOfferTaken = 0
    eOfferPartial = 1
    eOfferCantConvert = 2


# ---------------------------------------------------------- capacity limits --

def _load_tl(ltx, account_id: AccountID, asset):
    return tx_utils.load_trustline(ltx, account_id, asset)


def can_sell_at_most(ltx, header, account_id: AccountID, asset) -> int:
    """reference: OfferExchange canSellAtMost"""
    if asset.disc == AssetType.ASSET_TYPE_NATIVE:
        le = ltx.load_without_record(LedgerKey.account(account_id))
        return max(tx_utils.available_balance(header, le.data.value), 0)
    if tx_utils.asset_issuer(asset).to_bytes() == account_id.to_bytes():
        return INT64_MAX
    tl_le = _load_tl(ltx, account_id, asset)
    if tl_le is not None and tx_utils.is_authorized_to_maintain_liabilities(
            tl_le.data.value):
        tl = tl_le.data.value
        return max(tl.balance - tx_utils._tl_selling_liabilities(tl), 0)
    return 0


def can_buy_at_most(ltx, header, account_id: AccountID, asset) -> int:
    """reference: OfferExchange canBuyAtMost"""
    if asset.disc == AssetType.ASSET_TYPE_NATIVE:
        le = ltx.load_without_record(LedgerKey.account(account_id))
        acc = le.data.value
        return max(INT64_MAX - acc.balance -
                   tx_utils.buying_liabilities_account(acc), 0)
    if tx_utils.asset_issuer(asset).to_bytes() == account_id.to_bytes():
        return INT64_MAX
    tl_le = _load_tl(ltx, account_id, asset)
    if tl_le is None:
        return 0
    return max(tx_utils.max_receive_trustline(tl_le.data.value), 0)


def _add_asset_balance(ltx, header, account_id: AccountID, asset,
                       delta: int) -> bool:
    """Move `delta` of `asset` on the account's line; issuers mint/burn."""
    if asset.disc == AssetType.ASSET_TYPE_NATIVE:
        le = ltx.load(LedgerKey.account(account_id))
        return tx_utils.add_balance_account(header, le.data.value, delta)
    if tx_utils.asset_issuer(asset).to_bytes() == account_id.to_bytes():
        return True
    tl_le = _load_tl(ltx, account_id, asset)
    if tl_le is None:
        return False
    return tx_utils.add_balance_trustline(tl_le.data.value, delta)


# --------------------------------------------------------------- crossing ---

def _adjust_offer_in_place(ltx, header, offer_le: LedgerEntry) -> None:
    offer: OfferEntry = offer_le.data.value
    max_wheat = min(offer.amount, can_sell_at_most(
        ltx, header, offer.sellerID, offer.selling))
    max_sheep_recv = can_buy_at_most(ltx, header, offer.sellerID,
                                     offer.buying)
    offer.amount = offer_math.adjust_offer_amount(
        offer.price, max_wheat, max_sheep_recv)


def cross_offer_v10(ltx, offer_le: LedgerEntry, max_wheat_received: int,
                    max_sheep_send: int, round_type: RoundingType,
                    offer_trail: List[ClaimAtom]
                    ) -> Tuple[CrossOfferResult, int, int, bool]:
    """Cross one resting wheat-selling offer (reference: crossOfferV10).
    Returns (result, num_wheat_received, num_sheep_send, wheat_stays)."""
    releaseAssert(max_wheat_received > 0 and max_sheep_send > 0,
                  "crossOfferV10 with nothing to exchange")
    header = ltx.load_header()
    offer: OfferEntry = offer_le.data.value
    sheep, wheat = offer.buying, offer.selling
    account_b, offer_id = offer.sellerID, offer.offerID

    liab.release_liabilities(ltx, header, offer_le)
    _adjust_offer_in_place(ltx, header, offer_le)

    max_wheat_send = min(offer.amount, can_sell_at_most(
        ltx, header, account_b, wheat))
    max_sheep_receive = can_buy_at_most(ltx, header, account_b, sheep)
    ex = exchange_v10(offer.price, max_wheat_send, max_wheat_received,
                      max_sheep_send, max_sheep_receive, round_type)
    wheat_received, sheep_send = ex.num_wheat_received, ex.num_sheep_send

    if sheep_send:
        releaseAssert(_add_asset_balance(ltx, header, account_b, sheep,
                                         sheep_send),
                      "overflowed sheep balance")
    if wheat_received:
        releaseAssert(_add_asset_balance(ltx, header, account_b, wheat,
                                         -wheat_received),
                      "overflowed wheat balance")

    if ex.wheat_stays:
        offer.amount -= wheat_received
        _adjust_offer_in_place(ltx, header, offer_le)
    else:
        offer.amount = 0

    res = CrossOfferResult.eOfferTaken if offer.amount == 0 \
        else CrossOfferResult.eOfferPartial
    if res == CrossOfferResult.eOfferTaken:
        owner_le = ltx.load(LedgerKey.account(account_b))
        remove_entry_with_possible_sponsorship(ltx, header, offer_le,
                                               owner_le)
        ltx.erase(LedgerKey.offer(account_b, offer_id))
    else:
        ok = liab.acquire_liabilities(ltx, header, offer_le)
        releaseAssert(ok, "could not re-acquire offer liabilities")

    offer_trail.append(ClaimAtom(
        ClaimAtomType.CLAIM_ATOM_TYPE_ORDER_BOOK,
        ClaimOfferAtom(sellerID=account_b, offerID=offer_id,
                       assetSold=wheat, amountSold=wheat_received,
                       assetBought=sheep, amountBought=sheep_send)))
    return res, wheat_received, sheep_send, ex.wheat_stays


FilterFn = Callable[[LedgerEntry], OfferFilterResult]


def convert_with_offers(ltx_outer, sheep, max_sheep_send: int, wheat,
                        max_wheat_receive: int, round_type: RoundingType,
                        offer_filter: Optional[FilterFn],
                        offer_trail: List[ClaimAtom],
                        max_offers_to_cross: int
                        ) -> Tuple[ConvertResult, int, int]:
    """Walk the book best-offer-first (reference: convertWithOffers).
    Returns (result, sheep_send, wheat_received)."""
    releaseAssert(not offer_trail, "offerTrail must start empty")
    sheep_send = 0
    wheat_received = 0
    need_more = max_wheat_receive > 0 and max_sheep_send > 0
    # zero-budget fast-fail only from protocol 18 (the reference's
    # convertWithOffers pairs the check with V_18; earlier protocols walk
    # the book and report ePartial/filter results instead)
    if need_more and max_offers_to_cross <= 0 and \
            ltx_outer.get_header().ledgerVersion >= 18:
        return ConvertResult.eCrossedTooMany, 0, 0

    while need_more:
        with LedgerTxn(ltx_outer) as ltx:
            # resting offers SELL wheat and BUY sheep
            offer_le = ltx.load_best_offer(wheat, sheep)
            if offer_le is None:
                break
            if offer_filter:
                f = offer_filter(offer_le)
                if f == OfferFilterResult.eStopBadPrice:
                    return (ConvertResult.eFilterStopBadPrice, sheep_send,
                            wheat_received)
                if f == OfferFilterResult.eStopCrossSelf:
                    return (ConvertResult.eFilterStopCrossSelf, sheep_send,
                            wheat_received)
            if len(offer_trail) >= max_offers_to_cross:
                return (ConvertResult.eCrossedTooMany, sheep_send,
                        wheat_received)
            cor, num_wheat, num_sheep, wheat_stays = cross_offer_v10(
                ltx, offer_le, max_wheat_receive, max_sheep_send,
                round_type, offer_trail)
            need_more = not wheat_stays
            releaseAssert(0 <= num_sheep <= max_sheep_send,
                          "sheepSend out of range")
            releaseAssert(0 <= num_wheat <= max_wheat_receive,
                          "wheatReceived out of range")
            if cor == CrossOfferResult.eOfferCantConvert:
                return ConvertResult.ePartial, sheep_send, wheat_received
            ltx.commit()
        sheep_send += num_sheep
        max_sheep_send -= num_sheep
        wheat_received += num_wheat
        max_wheat_receive -= num_wheat
        need_more = need_more and max_wheat_receive > 0 and \
            max_sheep_send > 0
        if not need_more:
            return ConvertResult.eOK, sheep_send, wheat_received
        if cor == CrossOfferResult.eOfferPartial:
            return ConvertResult.ePartial, sheep_send, wheat_received
    # loop left: either the book ran out of offers, or there was nothing
    # to exchange in the first place
    if not need_more:
        return ConvertResult.eOK, sheep_send, wheat_received
    return ConvertResult.ePartial, sheep_send, wheat_received


# ------------------------------------------------------------ pool exchange --

def exchange_with_pool_amounts(reserves_to_pool: int, max_send_to_pool: int,
                               reserves_from_pool: int,
                               max_receive_from_pool: int, fee_bps: int,
                               round_type: RoundingType
                               ) -> Optional[Tuple[int, int]]:
    """Pure constant-product swap math (reference: exchangeWithPool int64
    overload). Returns (to_pool, from_pool) or None."""
    max_bps = 10_000
    releaseAssert(0 <= fee_bps < max_bps, "pool fee out of range")
    releaseAssert(reserves_to_pool > 0 and reserves_from_pool > 0,
                  "non-positive reserve")
    if round_type == RoundingType.PATH_PAYMENT_STRICT_SEND:
        releaseAssert(max_receive_from_pool == INT64_MAX,
                      "strict send with bounded receive")
        max_receive_from_pool = reserves_from_pool
        if max_send_to_pool > INT64_MAX - reserves_to_pool:
            return None
        to_pool = max_send_to_pool
        denom = max_bps * reserves_to_pool + (max_bps - fee_bps) * to_pool
        from_pool = ((max_bps - fee_bps) * reserves_from_pool * to_pool
                     ) // denom
        if from_pool > INT64_MAX:
            return None
        releaseAssert(0 <= from_pool <= max_receive_from_pool,
                      "pool payout out of range")
        if from_pool == 0:
            return None
        return to_pool, from_pool
    if round_type == RoundingType.PATH_PAYMENT_STRICT_RECEIVE:
        releaseAssert(max_send_to_pool == INT64_MAX,
                      "strict receive with bounded send")
        max_send_to_pool = INT64_MAX - reserves_to_pool
        if max_receive_from_pool >= reserves_from_pool:
            return None
        from_pool = max_receive_from_pool
        num = max_bps * reserves_to_pool * from_pool
        denom = (reserves_from_pool - from_pool) * (max_bps - fee_bps)
        to_pool = (num + denom - 1) // denom
        if to_pool > INT64_MAX:
            return None
        releaseAssert(to_pool >= 0, "toPool negative")
        if to_pool > max_send_to_pool:
            return None
        return to_pool, from_pool
    releaseAssert(False, "invalid rounding type for pool exchange")


def exchange_with_pool(ltx_outer, to_pool_asset, max_send_to_pool: int,
                       from_pool_asset, max_receive_from_pool: int,
                       round_type: RoundingType, max_offers_to_cross: int
                       ) -> Optional[Tuple[int, int]]:
    """Swap against the live pool entry; mutates reserves; returns
    (to_pool, from_pool) or None (reference: exchangeWithPool ltx
    overload). The protocol-18 gate and the voted
    DISABLE_LIQUIDITY_POOL_TRADING_FLAG live HERE, inside the shared
    primitive, so every caller inherits them (reference:
    OfferExchange isPoolTradingDisabled + the pre-V18 early-out)."""
    if round_type == RoundingType.NORMAL:
        return None
    if max_offers_to_cross <= 0:
        return None
    header = ltx_outer.get_header()
    if header.ledgerVersion < 18:
        return None
    if tx_utils.header_flags(header) & \
            LedgerHeaderFlags.DISABLE_LIQUIDITY_POOL_TRADING_FLAG:
        return None
    with LedgerTxn(ltx_outer) as ltx:
        pool_id = pool_id_for_assets(to_pool_asset, from_pool_asset)
        pool_le = ltx.load(LedgerKey.liquidity_pool(pool_id))
        if pool_le is None:
            return None
        cp = pool_le.data.value.body.value
        if cp.reserveA <= 0 or cp.reserveB <= 0:
            return None
        if to_pool_asset == cp.params.assetA and \
                from_pool_asset == cp.params.assetB:
            r = exchange_with_pool_amounts(
                cp.reserveA, max_send_to_pool, cp.reserveB,
                max_receive_from_pool, LIQUIDITY_POOL_FEE_V18, round_type)
            if r is None:
                return None
            to_pool, from_pool = r
            cp.reserveA += to_pool
            cp.reserveB -= from_pool
        elif from_pool_asset == cp.params.assetA and \
                to_pool_asset == cp.params.assetB:
            r = exchange_with_pool_amounts(
                cp.reserveB, max_send_to_pool, cp.reserveA,
                max_receive_from_pool, LIQUIDITY_POOL_FEE_V18, round_type)
            if r is None:
                return None
            to_pool, from_pool = r
            cp.reserveB += to_pool
            cp.reserveA -= from_pool
        else:
            releaseAssert(False, "pool does not match assets")
        releaseAssert(cp.reserveA >= 0 and cp.reserveB >= 0,
                      "negative pool reserve")
        ltx.commit()
        return to_pool, from_pool


def convert_with_offers_and_pools(
        ltx_outer, sheep, max_sheep_send: int, wheat,
        max_wheat_receive: int, round_type: RoundingType,
        offer_filter: Optional[FilterFn], offer_trail: List[ClaimAtom],
        max_offers_to_cross: int) -> Tuple[ConvertResult, int, int]:
    """Book vs pool, best taker price wins (reference:
    convertWithOffersAndPools + maybeConvertWithOffers)."""
    releaseAssert(not offer_trail, "offerTrail must start empty")

    # probe the pool without committing
    pool_quote: Optional[Tuple[int, int]] = None
    with LedgerTxn(ltx_outer) as probe:
        pool_quote = exchange_with_pool(
            probe, sheep, max_sheep_send, wheat, max_wheat_receive,
            round_type, max_offers_to_cross)
        # probe rolls back

    with LedgerTxn(ltx_outer) as book_ltx:
        trail: List[ClaimAtom] = []
        res, sheep_send, wheat_received = convert_with_offers(
            book_ltx, sheep, max_sheep_send, wheat, max_wheat_receive,
            round_type, offer_filter, trail, max_offers_to_cross)
        use_book = True
        if pool_quote is not None:
            if res != ConvertResult.eOK:
                use_book = False
            else:
                # book wins only on a strictly better price:
                # book.wR/book.sS > pool.fP/pool.tP
                use_book = (pool_quote[0] * wheat_received >
                            pool_quote[1] * sheep_send)
        if use_book:
            offer_trail.extend(trail)
            book_ltx.commit()
            return res, sheep_send, wheat_received

    # execute for real against the pool
    r = exchange_with_pool(ltx_outer, sheep, max_sheep_send, wheat,
                           max_wheat_receive, round_type,
                           max_offers_to_cross)
    releaseAssert(r is not None, "pool exchange vanished")
    to_pool, from_pool = r
    offer_trail.append(ClaimAtom(
        ClaimAtomType.CLAIM_ATOM_TYPE_LIQUIDITY_POOL,
        ClaimLiquidityAtom(
            liquidityPoolID=pool_id_for_assets(sheep, wheat),
            assetSold=wheat, amountSold=from_pool,
            assetBought=sheep, amountBought=to_pool)))
    return ConvertResult.eOK, to_pool, from_pool
