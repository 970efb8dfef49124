"""Sponsorship accounting and reserve-checked entry lifecycle.

Reference: transactions/SponsorshipUtils.{h,cpp} — every subentry/account/
claimable-balance creation goes through `create_entry_with_possible_
sponsorship`, which decides who pays the base-reserve (owner or the active
sponsor from a BeginSponsoringFutureReserves scope), bumps numSubEntries /
numSponsoring / numSponsored, and enforces the reserve floor and count
limits. Removal reverses it.

Design difference from the reference: the active-sponsorship scopes are NOT
modelled as internal ledger entries (reference: LedgerTxn SPONSORSHIP
internal types); they live on the per-transaction `ApplyContext`, because
ops that fail never commit their LedgerTxn, which gives the same rollback
semantics with far less machinery.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Dict, List, Optional

from ..util.checks import releaseAssert
from ..xdr.ledger_entries import (AccountEntry, AccountEntryExtensionV1,
                                  AccountEntryExtensionV2,
                                  AccountEntryExtensionV3, LedgerEntry,
                                  LedgerEntryExtensionV1, LedgerEntryType,
                                  Liabilities, TrustLineAsset)
from ..xdr.ledger import LedgerHeader
from ..xdr.types import AccountID, PublicKey
from . import tx_utils

ACCOUNT_SUBENTRY_LIMIT = 1000
MAX_SIGNERS = 20


class SponsorshipResult(IntEnum):
    SUCCESS = 0
    LOW_RESERVE = -1
    TOO_MANY_SUBENTRIES = -2
    TOO_MANY_SPONSORING = -3
    TOO_MANY_SPONSORED = -4


class ApplyContext:
    """Per-transaction apply state shared by its operations: the active
    sponsorship scopes (sponsored account id bytes -> sponsor AccountID)
    plus identifiers ops need for hash-derived ids."""

    def __init__(self, network_id: bytes = b"\x00" * 32,
                 tx_source_id: Optional[AccountID] = None,
                 tx_seq_num: int = 0):
        self.network_id = network_id
        self.tx_source_id = tx_source_id
        self.tx_seq_num = tx_seq_num
        self.op_index = 0
        self.active_sponsorships: Dict[bytes, AccountID] = {}
        # Soroban apply state (set by TransactionFrame for contract txs)
        self.soroban_data = None
        self.fee_source_id: Optional[AccountID] = tx_source_id
        self.tx_size_bytes = 0
        self.verify = None
        self.soroban_events = []
        self.soroban_return_value = None
        self.soroban_diagnostic_events = []
        self.soroban_diagnostics_in_success = True

    def sponsor_for(self, account_id: AccountID) -> Optional[AccountID]:
        return self.active_sponsorships.get(account_id.to_bytes())


# ------------------------------------------------------- account extensions --

def ensure_account_ext_v1(acc: AccountEntry) -> AccountEntryExtensionV1:
    if acc.ext.disc == 0:
        acc.ext = type(acc.ext)(1, AccountEntryExtensionV1(
            liabilities=Liabilities(buying=0, selling=0)))
    return acc.ext.value


def ensure_account_ext_v2(acc: AccountEntry) -> AccountEntryExtensionV2:
    v1 = ensure_account_ext_v1(acc)
    if v1.ext.disc == 0:
        v2 = AccountEntryExtensionV2(
            numSponsored=0, numSponsoring=0,
            signerSponsoringIDs=[None] * len(acc.signers))
        v1.ext = type(v1.ext)(2, v2)
    v2 = v1.ext.value
    # keep the parallel signer-sponsor array sized with signers
    while len(v2.signerSponsoringIDs) < len(acc.signers):
        v2.signerSponsoringIDs.append(None)
    return v2


def ensure_account_ext_v3(acc: AccountEntry) -> AccountEntryExtensionV3:
    v2 = ensure_account_ext_v2(acc)
    if v2.ext.disc == 0:
        v2.ext = type(v2.ext)(3, AccountEntryExtensionV3(
            seqLedger=0, seqTime=0))
    return v2.ext.value


def num_sponsoring(acc: AccountEntry) -> int:
    if acc.ext.disc == 1 and acc.ext.value.ext.disc == 2:
        return acc.ext.value.ext.value.numSponsoring
    return 0


def num_sponsored(acc: AccountEntry) -> int:
    if acc.ext.disc == 1 and acc.ext.value.ext.disc == 2:
        return acc.ext.value.ext.value.numSponsored
    return 0


def account_seq_time(acc: AccountEntry) -> int:
    if (acc.ext.disc == 1 and acc.ext.value.ext.disc == 2
            and acc.ext.value.ext.value.ext.disc == 3):
        return acc.ext.value.ext.value.ext.value.seqTime
    return 0


def account_seq_ledger(acc: AccountEntry) -> int:
    if (acc.ext.disc == 1 and acc.ext.value.ext.disc == 2
            and acc.ext.value.ext.value.ext.disc == 3):
        return acc.ext.value.ext.value.ext.value.seqLedger
    return 0


# -------------------------------------------------------- entry sponsorship --

def is_sponsored(entry: LedgerEntry) -> bool:
    return entry.ext.disc == 1 and entry.ext.value.sponsoringID is not None


def get_sponsoring_id(entry: LedgerEntry) -> Optional[AccountID]:
    if entry.ext.disc == 1:
        return entry.ext.value.sponsoringID
    return None


def set_sponsoring_id(entry: LedgerEntry,
                      sponsor: Optional[AccountID]) -> None:
    if sponsor is None:
        if entry.ext.disc == 1:
            entry.ext.value.sponsoringID = None
        return
    if entry.ext.disc == 0:
        entry.ext = type(entry.ext)(1, LedgerEntryExtensionV1(
            sponsoringID=sponsor))
    else:
        entry.ext.value.sponsoringID = sponsor


def reserve_multiplier(entry: LedgerEntry) -> int:
    """How many base reserves the entry costs (reference:
    SponsorshipUtils computeMultiplier)."""
    t = entry.data.disc
    if t == LedgerEntryType.ACCOUNT:
        return 2
    if t == LedgerEntryType.CLAIMABLE_BALANCE:
        return len(entry.data.value.claimants)
    if t == LedgerEntryType.TRUSTLINE:
        tla: TrustLineAsset = entry.data.value.asset
        from ..xdr.ledger_entries import AssetType
        return 2 if tla.disc == AssetType.ASSET_TYPE_POOL_SHARE else 1
    if t in (LedgerEntryType.OFFER, LedgerEntryType.DATA):
        return 1
    releaseAssert(False, f"no reserve multiplier for {t!r}")


def _is_subentry(entry: LedgerEntry) -> bool:
    return entry.data.disc in (LedgerEntryType.TRUSTLINE,
                               LedgerEntryType.OFFER,
                               LedgerEntryType.DATA)


def _subentry_count(entry: LedgerEntry) -> int:
    """Pool-share trustlines count as 2 subentries (reference:
    ChangeTrustOpFrame / SponsorshipUtils)."""
    if entry.data.disc == LedgerEntryType.TRUSTLINE:
        from ..xdr.ledger_entries import AssetType
        if entry.data.value.asset.disc == AssetType.ASSET_TYPE_POOL_SHARE:
            return 2
    return 1


def _available_for_reserve(header: LedgerHeader, acc: AccountEntry,
                           extra_reserves: int) -> bool:
    """Can `acc` afford `extra_reserves` more base reserves on top of its
    current minimum balance + selling liabilities?"""
    needed = (tx_utils.min_balance(header, acc)
              + extra_reserves * header.baseReserve
              + tx_utils.selling_liabilities_account(acc))
    return acc.balance >= needed


def create_entry_with_possible_sponsorship(
        ltx, header: LedgerHeader, entry: LedgerEntry,
        owner_le: Optional[LedgerEntry],
        ctx: Optional[ApplyContext]) -> SponsorshipResult:
    """Reserve- and count-check the creation of `entry`, mutating the
    owner (and sponsor) accounts. Caller still calls ltx.create(entry).

    owner_le: the account LedgerEntry that owns the new entry (None only
    for claimable balances, which have no owning account after creation).
    """
    owner_acc: Optional[AccountEntry] = \
        owner_le.data.value if owner_le is not None else None
    mult = reserve_multiplier(entry)

    sponsor_id = None
    if ctx is not None:
        if entry.data.disc == LedgerEntryType.ACCOUNT:
            sponsor_id = ctx.sponsor_for(entry.data.value.accountID)
        elif entry.data.disc == LedgerEntryType.CLAIMABLE_BALANCE:
            # the creating op's source is "owner" for scope lookup
            if owner_acc is not None:
                sponsor_id = ctx.sponsor_for(owner_acc.accountID)
        elif owner_acc is not None:
            sponsor_id = ctx.sponsor_for(owner_acc.accountID)

    if entry.data.disc == LedgerEntryType.CLAIMABLE_BALANCE \
            and sponsor_id is None and owner_acc is not None:
        # claimable balances are always sponsored by their creator
        sponsor_id = owner_acc.accountID

    if sponsor_id is not None:
        from ..xdr.ledger_entries import LedgerKey
        sponsor_le = ltx.load(LedgerKey.account(sponsor_id))
        releaseAssert(sponsor_le is not None, "sponsor account must exist")
        sponsor_acc: AccountEntry = sponsor_le.data.value
        sp_v2 = ensure_account_ext_v2(sponsor_acc)
        if sp_v2.numSponsoring > 0xFFFFFFFF - mult:
            return SponsorshipResult.TOO_MANY_SPONSORING
        if not _available_for_reserve(header, sponsor_acc, mult):
            return SponsorshipResult.LOW_RESERVE
        if owner_acc is not None and \
                entry.data.disc != LedgerEntryType.ACCOUNT and \
                entry.data.disc != LedgerEntryType.CLAIMABLE_BALANCE:
            own_v2 = ensure_account_ext_v2(owner_acc)
            if own_v2.numSponsored > 0xFFFFFFFF - mult:
                return SponsorshipResult.TOO_MANY_SPONSORED
            own_v2.numSponsored += mult
        elif entry.data.disc == LedgerEntryType.ACCOUNT:
            new_acc: AccountEntry = entry.data.value
            nv2 = ensure_account_ext_v2(new_acc)
            nv2.numSponsored += mult
        sp_v2.numSponsoring += mult
        set_sponsoring_id(entry, sponsor_id)
    else:
        releaseAssert(owner_acc is not None,
                      "unsponsored entry needs an owner for the reserve")
        if entry.data.disc != LedgerEntryType.ACCOUNT and \
                not _available_for_reserve(header, owner_acc, mult):
            return SponsorshipResult.LOW_RESERVE

    if owner_acc is not None and _is_subentry(entry):
        cnt = _subentry_count(entry)
        if owner_acc.numSubEntries + cnt > ACCOUNT_SUBENTRY_LIMIT:
            return SponsorshipResult.TOO_MANY_SUBENTRIES
        owner_acc.numSubEntries += cnt
    return SponsorshipResult.SUCCESS


def remove_entry_with_possible_sponsorship(
        ltx, header: LedgerHeader, entry: LedgerEntry,
        owner_le: Optional[LedgerEntry]) -> None:
    """Reverse of create: decrement counts on owner and sponsor. Caller
    erases the entry afterwards."""
    mult = reserve_multiplier(entry)
    sponsor_id = get_sponsoring_id(entry)
    if sponsor_id is not None:
        from ..xdr.ledger_entries import LedgerKey
        sponsor_le = ltx.load(LedgerKey.account(sponsor_id))
        if sponsor_le is not None:
            sp_acc: AccountEntry = sponsor_le.data.value
            v2 = ensure_account_ext_v2(sp_acc)
            v2.numSponsoring = max(0, v2.numSponsoring - mult)
        if owner_le is not None and \
                entry.data.disc != LedgerEntryType.CLAIMABLE_BALANCE:
            own_acc: AccountEntry = owner_le.data.value
            v2 = ensure_account_ext_v2(own_acc)
            v2.numSponsored = max(0, v2.numSponsored - mult)
    if owner_le is not None and _is_subentry(entry):
        owner_le.data.value.numSubEntries -= _subentry_count(entry)


# -------------------------------------------------------- signer sponsorship --

def create_signer_with_possible_sponsorship(
        ltx, header: LedgerHeader, owner_le: LedgerEntry,
        ctx: Optional[ApplyContext]) -> SponsorshipResult:
    """Reserve/count accounting for adding one signer to owner (the
    caller inserts into acc.signers and the parallel sponsoring array)."""
    owner_acc: AccountEntry = owner_le.data.value
    sponsor_id = ctx.sponsor_for(owner_acc.accountID) if ctx else None
    if sponsor_id is not None and \
            sponsor_id.to_bytes() != owner_acc.accountID.to_bytes():
        from ..xdr.ledger_entries import LedgerKey
        sponsor_le = ltx.load(LedgerKey.account(sponsor_id))
        releaseAssert(sponsor_le is not None, "sponsor account must exist")
        sp_acc: AccountEntry = sponsor_le.data.value
        sp_v2 = ensure_account_ext_v2(sp_acc)
        if sp_v2.numSponsoring >= 0xFFFFFFFF:
            return SponsorshipResult.TOO_MANY_SPONSORING
        if not _available_for_reserve(header, sp_acc, 1):
            return SponsorshipResult.LOW_RESERVE
        own_v2 = ensure_account_ext_v2(owner_acc)
        if own_v2.numSponsored >= 0xFFFFFFFF:
            return SponsorshipResult.TOO_MANY_SPONSORED
        own_v2.numSponsored += 1
        sp_v2.numSponsoring += 1
        # caller records sponsor_id in signerSponsoringIDs at insert index
    else:
        if not _available_for_reserve(header, owner_acc, 1):
            return SponsorshipResult.LOW_RESERVE
        sponsor_id = None
    if owner_acc.numSubEntries + 1 > ACCOUNT_SUBENTRY_LIMIT:
        return SponsorshipResult.TOO_MANY_SUBENTRIES
    owner_acc.numSubEntries += 1
    return SponsorshipResult.SUCCESS


def remove_signer_sponsorship(ltx, owner_le: LedgerEntry,
                              signer_index: int) -> None:
    """Undo counts for removing signer at `signer_index` (caller pops from
    both parallel arrays afterwards)."""
    owner_acc: AccountEntry = owner_le.data.value
    sponsor_id = None
    if owner_acc.ext.disc == 1 and owner_acc.ext.value.ext.disc == 2:
        ids = owner_acc.ext.value.ext.value.signerSponsoringIDs
        if signer_index < len(ids):
            sponsor_id = ids[signer_index]
    if sponsor_id is not None:
        from ..xdr.ledger_entries import LedgerKey
        sponsor_le = ltx.load(LedgerKey.account(sponsor_id))
        if sponsor_le is not None:
            v2 = ensure_account_ext_v2(sponsor_le.data.value)
            v2.numSponsoring = max(0, v2.numSponsoring - 1)
        own_v2 = ensure_account_ext_v2(owner_acc)
        own_v2.numSponsored = max(0, own_v2.numSponsored - 1)
    owner_acc.numSubEntries -= 1
