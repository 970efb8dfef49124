"""Shared ledger-mutation helpers.

Reference: transactions/TransactionUtils.{h,cpp} — account/trustline
loading, balance changes with liability clamps, reserve math, threshold
accessors, sequence-number rules. Money is int64 stroops throughout;
all arithmetic is checked against the int64 range like the reference's
util/types.h addBalance helpers.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..util.checks import releaseAssert
from ..xdr.ledger_entries import (AccountEntry, AccountFlags, Asset,
                                  AssetType, LedgerEntry, LedgerEntryType,
                                  LedgerKey, ThresholdIndexes,
                                  TrustLineAsset, TrustLineEntry,
                                  TrustLineFlags, _LedgerEntryData)
from ..xdr.ledger import LedgerHeader
from ..xdr.types import PublicKey, SignerKey, SignerKeyType

INT64_MAX = 2**63 - 1
INT64_MIN = -(2**63)

# protocol constants (reference: LedgerManager::GENESIS_* and header)
GENESIS_LEDGER_BASE_FEE = 100
GENESIS_LEDGER_BASE_RESERVE = 100_000_000


def in_int64(v: int) -> bool:
    return INT64_MIN <= v <= INT64_MAX


# ------------------------------------------------------------- thresholds --

def threshold(account: AccountEntry, idx: ThresholdIndexes) -> int:
    return account.thresholds[idx]


def get_signers_with_master(
        account: AccountEntry) -> List[Tuple[SignerKey, int]]:
    """All signers incl. the implicit master key at masterWeight."""
    out: List[Tuple[SignerKey, int]] = []
    mw = account.thresholds[ThresholdIndexes.THRESHOLD_MASTER_WEIGHT]
    if mw > 0:
        out.append((SignerKey(SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                              account.accountID.value), mw))
    for s in account.signers:
        out.append((s.key, s.weight))
    return out


# ---------------------------------------------------------------- reserve --

def min_balance(header: LedgerHeader, account: AccountEntry) -> int:
    """(2 + numSubEntries + numSponsoring - numSponsored) * baseReserve
    (reference: LedgerTxnHeader::getMinBalance / getAvailableBalance)."""
    sponsoring = sponsored = 0
    ext = account.ext
    if ext.disc == 1 and ext.value.ext.disc == 2:
        v2 = ext.value.ext.value
        sponsoring, sponsored = v2.numSponsoring, v2.numSponsored
    count = 2 + account.numSubEntries + sponsoring - sponsored
    return count * header.baseReserve


def available_balance(header: LedgerHeader, account: AccountEntry) -> int:
    liab = selling_liabilities_account(account)
    return account.balance - min_balance(header, account) - liab


def header_flags(header: LedgerHeader) -> int:
    """LedgerHeader ext-v1 flags (reference: getHeaderFlags) — the
    DISABLE_LIQUIDITY_POOL_* bits voted in via LEDGER_UPGRADE_FLAGS."""
    return header.ext.value.flags if header.ext.disc == 1 else 0


def selling_liabilities_account(account: AccountEntry) -> int:
    if account.ext.disc == 1:
        return account.ext.value.liabilities.selling
    return 0


def buying_liabilities_account(account: AccountEntry) -> int:
    if account.ext.disc == 1:
        return account.ext.value.liabilities.buying
    return 0


# ---------------------------------------------------------------- balance --

def add_balance_account(header: LedgerHeader, account: AccountEntry,
                        delta: int) -> bool:
    """Clamped balance change; False (and no change) if it would break
    the reserve floor, liabilities, or int64."""
    new = account.balance + delta
    if not in_int64(new):
        return False
    if delta < 0:
        if new < min_balance(header, account) + \
                selling_liabilities_account(account):
            return False
    else:
        if new > INT64_MAX - buying_liabilities_account(account):
            return False
    account.balance = new
    return True


def add_balance_trustline(tl: TrustLineEntry, delta: int) -> bool:
    new = tl.balance + delta
    if not in_int64(new) or new < 0:
        return False
    if delta < 0:
        if new < _tl_selling_liabilities(tl):
            return False
    else:
        if new > tl.limit - _tl_buying_liabilities(tl):
            return False
    tl.balance = new
    return True


def _tl_selling_liabilities(tl: TrustLineEntry) -> int:
    if tl.ext.disc == 1:
        return tl.ext.value.liabilities.selling
    return 0


def _tl_buying_liabilities(tl: TrustLineEntry) -> int:
    if tl.ext.disc == 1:
        return tl.ext.value.liabilities.buying
    return 0


def max_receive_trustline(tl: TrustLineEntry) -> int:
    return tl.limit - tl.balance - _tl_buying_liabilities(tl)


def is_authorized(tl: TrustLineEntry) -> bool:
    return bool(tl.flags & TrustLineFlags.AUTHORIZED_FLAG)


def is_authorized_to_maintain_liabilities(tl: TrustLineEntry) -> bool:
    return bool(tl.flags & (
        TrustLineFlags.AUTHORIZED_FLAG |
        TrustLineFlags.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG))


def is_string_valid(s: bytes) -> bool:
    """No control characters (reference: util/types.cpp isStringValid)."""
    return all(c >= 0x20 and c != 0x7F for c in s)


# ----------------------------------------------------------------- assets --

def is_asset_valid(asset: Asset) -> bool:
    """Reference util/types.cpp isAssetValid: code chars must be
    [a-zA-Z0-9], zero-padded at the tail only; ALPHANUM4 codes are 1-4
    chars, ALPHANUM12 codes must be >4 chars."""
    if asset.disc == AssetType.ASSET_TYPE_NATIVE:
        return True
    code = asset.value.assetCode
    body = code.rstrip(b"\x00")
    if not body or b"\x00" in body:
        return False
    if asset.disc == AssetType.ASSET_TYPE_CREDIT_ALPHANUM12 and len(body) <= 4:
        return False
    return all(chr(c).isalnum() and c < 128 for c in body)


def asset_issuer(asset: Asset) -> Optional[PublicKey]:
    if asset.disc == AssetType.ASSET_TYPE_NATIVE:
        return None
    return asset.value.issuer


# ---------------------------------------------------------------- loaders --

def load_account(ltx, account_id: PublicKey) -> Optional[LedgerEntry]:
    # LedgerKey.account is interned with memoized bytes — no per-load
    # key serialization cost
    return ltx.load(LedgerKey.account(account_id))


def load_trustline(ltx, account_id: PublicKey,
                   asset: Asset) -> Optional[LedgerEntry]:
    tla = TrustLineAsset.from_asset(asset)
    return ltx.load(LedgerKey.trust_line(account_id, tla))


def account_entry(le: LedgerEntry) -> AccountEntry:
    releaseAssert(le.data.disc == LedgerEntryType.ACCOUNT, "not an account")
    return le.data.value


def make_account_ledger_entry(account_id: PublicKey, balance: int,
                              seq_num: int) -> LedgerEntry:
    ae = AccountEntry(accountID=account_id, balance=balance,
                      seqNum=seq_num,
                      thresholds=bytes([1, 0, 0, 0]))
    return LedgerEntry(lastModifiedLedgerSeq=0,
                       data=_LedgerEntryData(LedgerEntryType.ACCOUNT, ae))


# --------------------------------------------------------------- seqnums --

def starting_sequence_number(ledger_seq: int) -> int:
    """New accounts start at ledgerSeq << 32 (reference:
    getStartingSequenceNumber)."""
    return ledger_seq << 32


def is_bad_seq(account: AccountEntry, tx_seq: int) -> bool:
    return tx_seq <= account.seqNum or tx_seq > INT64_MAX
