"""Offer liability bookkeeping.

Reference: transactions/TransactionUtils.cpp acquireLiabilities /
releaseLiabilities (:460-520) — every resting offer reserves selling
liabilities on the line of the asset it sells and buying liabilities on
the line of the asset it buys; native liabilities live on the account
entry (ext v1), credit liabilities on the trustline (ext v1). Removing an
offer releases both sides; `remove_offers_by_account_and_asset` is the
auth-revocation path (TrustFlagsOpFrameBase::removeOffers).
"""

from __future__ import annotations

from typing import Optional

from ..util.checks import releaseAssert
from ..xdr.ledger_entries import (AccountEntry, AssetType, LedgerEntry,
                                  LedgerKey, TrustLineEntry,
                                  TrustLineEntryV1, Liabilities)
from ..xdr.types import AccountID
from . import offer_math, tx_utils
from .sponsorship import ensure_account_ext_v1, remove_entry_with_possible_sponsorship

INT64_MAX = 2**63 - 1


def ensure_trustline_ext_v1(tl: TrustLineEntry) -> TrustLineEntryV1:
    if tl.ext.disc == 0:
        tl.ext = type(tl.ext)(1, TrustLineEntryV1(
            liabilities=Liabilities(buying=0, selling=0)))
    return tl.ext.value


def add_account_buying_liabilities(header, acc: AccountEntry,
                                   delta: int) -> bool:
    v1 = ensure_account_ext_v1(acc)
    new = v1.liabilities.buying + delta
    if new < 0 or acc.balance > INT64_MAX - new:
        return False
    v1.liabilities.buying = new
    return True


def add_account_selling_liabilities(header, acc: AccountEntry,
                                    delta: int) -> bool:
    v1 = ensure_account_ext_v1(acc)
    new = v1.liabilities.selling + delta
    if new < 0 or new > acc.balance - tx_utils.min_balance(header, acc):
        return False
    v1.liabilities.selling = new
    return True


def add_trustline_buying_liabilities(tl: TrustLineEntry, delta: int) -> bool:
    v1 = ensure_trustline_ext_v1(tl)
    new = v1.liabilities.buying + delta
    if new < 0 or tl.balance > tl.limit - new:
        return False
    v1.liabilities.buying = new
    return True


def add_trustline_selling_liabilities(tl: TrustLineEntry,
                                      delta: int) -> bool:
    v1 = ensure_trustline_ext_v1(tl)
    new = v1.liabilities.selling + delta
    if new < 0 or new > tl.balance:
        return False
    v1.liabilities.selling = new
    return True


def _adjust_asset_liabilities(ltx, header, account_le: LedgerEntry,
                              asset, selling_delta: int,
                              buying_delta: int) -> bool:
    """Apply liability deltas for one asset leg of an offer owned by
    account_le's account. The issuer of an asset holds no trustline and
    carries no liabilities for it (reference: TrustLineWrapper issuer)."""
    acc: AccountEntry = account_le.data.value
    if asset.disc == AssetType.ASSET_TYPE_NATIVE:
        ok = True
        if selling_delta:
            ok = ok and add_account_selling_liabilities(
                header, acc, selling_delta)
        if buying_delta:
            ok = ok and add_account_buying_liabilities(
                header, acc, buying_delta)
        return ok
    issuer = tx_utils.asset_issuer(asset)
    if issuer.to_bytes() == acc.accountID.to_bytes():
        return True
    tl_le = tx_utils.load_trustline(ltx, acc.accountID, asset)
    if tl_le is None:
        return False
    tl = tl_le.data.value
    ok = True
    if selling_delta:
        ok = ok and add_trustline_selling_liabilities(tl, selling_delta)
    if buying_delta:
        ok = ok and add_trustline_buying_liabilities(tl, buying_delta)
    return ok


def acquire_liabilities(ltx, header, offer_le: LedgerEntry) -> bool:
    return _apply_offer_liabilities(ltx, header, offer_le, acquire=True)


def release_liabilities(ltx, header, offer_le: LedgerEntry) -> None:
    ok = _apply_offer_liabilities(ltx, header, offer_le, acquire=False)
    releaseAssert(ok, "releasing liabilities cannot fail")


def _apply_offer_liabilities(ltx, header, offer_le: LedgerEntry,
                             acquire: bool) -> bool:
    offer = offer_le.data.value
    sell_liab = offer_math.offer_selling_liabilities(offer)
    buy_liab = offer_math.offer_buying_liabilities(offer)
    sign = 1 if acquire else -1
    acct_le = ltx.load(LedgerKey.account(offer.sellerID))
    releaseAssert(acct_le is not None, "offer owner must exist")
    ok = _adjust_asset_liabilities(
        ltx, header, acct_le, offer.selling, sign * sell_liab, 0)
    ok = ok and _adjust_asset_liabilities(
        ltx, header, acct_le, offer.buying, 0, sign * buy_liab)
    return ok


def erase_offer(ltx, header, offer_le: LedgerEntry) -> None:
    """Release liabilities, refund the reserve accounting, erase.
    (reference: eraseOfferWithPossibleSponsorship)"""
    offer = offer_le.data.value
    release_liabilities(ltx, header, offer_le)
    owner_le = ltx.load(LedgerKey.account(offer.sellerID))
    remove_entry_with_possible_sponsorship(ltx, header, offer_le, owner_le)
    ltx.erase(LedgerKey.offer(offer.sellerID, offer.offerID))


def remove_offers_by_account_and_asset(ltx, header, account_id: AccountID,
                                       asset) -> None:
    """Delete every offer owned by account_id buying or selling `asset`
    (reference: removeOffersByAccountAndAsset, the auth-revocation
    path)."""
    for offer_le in list(ltx.load_offers_by_account(account_id)):
        offer = offer_le.data.value
        if offer.selling == asset or offer.buying == asset:
            erase_offer(ltx, header, offer_le)
