"""Ledger entry types (reference: Stellar-ledger-entries.x; consumed by
src/ledger/LedgerTxn* and the per-type SQL backends).

Classic entry types are complete; Soroban entry types (CONTRACT_DATA,
CONTRACT_CODE, CONFIG_SETTING, TTL) are wired in by the soroban layer
(build-plan SURVEY.md §7 step 8 — classic protocol first).
"""

from __future__ import annotations

from enum import IntEnum

from .runtime import (
    Array, Bool, Int32, Int64, Lazy, Opaque, Optional, Struct, Uint32,
    Uint64, Union, VarArray, VarOpaque, XdrString,
)
from .types import AccountID, ExtensionPoint, Hash, PublicKey, SignerKey, Uint256

Thresholds = Opaque(4)
String32 = XdrString(32)
String64 = XdrString(64)
DataValue = VarOpaque(64)
PoolID = Hash  # opaque[32]

AssetCode4 = Opaque(4)
AssetCode12 = Opaque(12)

MAX_SIGNERS = 20
LIQUIDITY_POOL_FEE_V18 = 30

MASK_ACCOUNT_FLAGS = 0x7
MASK_ACCOUNT_FLAGS_V17 = 0xF
MASK_TRUSTLINE_FLAGS = 1
MASK_TRUSTLINE_FLAGS_V13 = 3
MASK_TRUSTLINE_FLAGS_V17 = 7
MASK_OFFERENTRY_FLAGS = 1
MASK_CLAIMABLE_BALANCE_FLAGS = 0x1
MASK_LEDGER_HEADER_FLAGS = 0x7


class AssetType(IntEnum):
    ASSET_TYPE_NATIVE = 0
    ASSET_TYPE_CREDIT_ALPHANUM4 = 1
    ASSET_TYPE_CREDIT_ALPHANUM12 = 2
    ASSET_TYPE_POOL_SHARE = 3


class AssetCode(Union):
    SWITCH = AssetType
    ARMS = {
        AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: ("assetCode4", AssetCode4),
        AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: ("assetCode12", AssetCode12),
    }

    def __init__(self, disc=AssetType.ASSET_TYPE_CREDIT_ALPHANUM4, value=b"\x00" * 4, **kw):
        super().__init__(disc, value, **kw)


class AlphaNum4(Struct):
    FIELDS = [("assetCode", AssetCode4), ("issuer", AccountID)]


class AlphaNum12(Struct):
    FIELDS = [("assetCode", AssetCode12), ("issuer", AccountID)]


class Asset(Union):
    SWITCH = AssetType
    ARMS = {
        AssetType.ASSET_TYPE_NATIVE: None,
        AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: ("alphaNum4", AlphaNum4),
        AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: ("alphaNum12", AlphaNum12),
    }

    @classmethod
    def native(cls) -> "Asset":
        return cls(AssetType.ASSET_TYPE_NATIVE)

    @classmethod
    def credit(cls, code: bytes, issuer) -> "Asset":
        """Alphanum4/12 credit asset from a short code (zero-padded)."""
        if len(code) <= 4:
            return cls(AssetType.ASSET_TYPE_CREDIT_ALPHANUM4,
                       AlphaNum4(assetCode=code.ljust(4, b"\x00"),
                                 issuer=issuer))
        return cls(AssetType.ASSET_TYPE_CREDIT_ALPHANUM12,
                   AlphaNum12(assetCode=code.ljust(12, b"\x00"),
                              issuer=issuer))


class Price(Struct):
    FIELDS = [("n", Int32), ("d", Int32)]


class Liabilities(Struct):
    FIELDS = [("buying", Int64), ("selling", Int64)]


class ThresholdIndexes(IntEnum):
    THRESHOLD_MASTER_WEIGHT = 0
    THRESHOLD_LOW = 1
    THRESHOLD_MED = 2
    THRESHOLD_HIGH = 3


class LedgerEntryType(IntEnum):
    ACCOUNT = 0
    TRUSTLINE = 1
    OFFER = 2
    DATA = 3
    CLAIMABLE_BALANCE = 4
    LIQUIDITY_POOL = 5
    CONTRACT_DATA = 6
    CONTRACT_CODE = 7
    CONFIG_SETTING = 8
    TTL = 9


class Signer(Struct):
    FIELDS = [("key", SignerKey), ("weight", Uint32)]


class AccountFlags(IntEnum):
    AUTH_REQUIRED_FLAG = 0x1
    AUTH_REVOCABLE_FLAG = 0x2
    AUTH_IMMUTABLE_FLAG = 0x4
    AUTH_CLAWBACK_ENABLED_FLAG = 0x8


SponsorshipDescriptor = Optional(AccountID)


class AccountEntryExtensionV3(Struct):
    FIELDS = [
        ("ext", ExtensionPoint),
        ("seqLedger", Uint32),
        ("seqTime", Uint64),
    ]


class _AccountEntryExtV2Ext(Union):
    SWITCH = Int32
    ARMS = {0: None, 3: ("v3", AccountEntryExtensionV3)}


class AccountEntryExtensionV2(Struct):
    FIELDS = [
        ("numSponsored", Uint32),
        ("numSponsoring", Uint32),
        ("signerSponsoringIDs", VarArray(SponsorshipDescriptor, MAX_SIGNERS)),
        ("ext", _AccountEntryExtV2Ext),
    ]


class _AccountEntryExtV1Ext(Union):
    SWITCH = Int32
    ARMS = {0: None, 2: ("v2", AccountEntryExtensionV2)}


class AccountEntryExtensionV1(Struct):
    FIELDS = [
        ("liabilities", Liabilities),
        ("ext", _AccountEntryExtV1Ext),
    ]


class _AccountEntryExt(Union):
    SWITCH = Int32
    ARMS = {0: None, 1: ("v1", AccountEntryExtensionV1)}


class AccountEntry(Struct):
    FIELDS = [
        ("accountID", AccountID),
        ("balance", Int64),
        ("seqNum", Int64),
        ("numSubEntries", Uint32),
        ("inflationDest", Optional(AccountID)),
        ("flags", Uint32),
        ("homeDomain", String32),
        ("thresholds", Thresholds),
        ("signers", VarArray(Signer, MAX_SIGNERS)),
        ("ext", _AccountEntryExt),
    ]


class TrustLineFlags(IntEnum):
    AUTHORIZED_FLAG = 1
    AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG = 2
    TRUSTLINE_CLAWBACK_ENABLED_FLAG = 4


class LiquidityPoolType(IntEnum):
    LIQUIDITY_POOL_CONSTANT_PRODUCT = 0


class TrustLineAsset(Union):
    SWITCH = AssetType
    ARMS = {
        AssetType.ASSET_TYPE_NATIVE: None,
        AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: ("alphaNum4", AlphaNum4),
        AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: ("alphaNum12", AlphaNum12),
        AssetType.ASSET_TYPE_POOL_SHARE: ("liquidityPoolID", PoolID),
    }

    @classmethod
    def from_asset(cls, asset: "Asset") -> "TrustLineAsset":
        if asset.disc == AssetType.ASSET_TYPE_NATIVE:
            return cls(AssetType.ASSET_TYPE_NATIVE)
        return cls(asset.disc, asset.value)


class TrustLineEntryExtensionV2(Struct):
    FIELDS = [
        ("liquidityPoolUseCount", Int32),
        ("ext", ExtensionPoint),
    ]


class _TrustLineEntryExtV1Ext(Union):
    SWITCH = Int32
    ARMS = {0: None, 2: ("v2", TrustLineEntryExtensionV2)}


class TrustLineEntryV1(Struct):
    FIELDS = [
        ("liabilities", Liabilities),
        ("ext", _TrustLineEntryExtV1Ext),
    ]


class _TrustLineEntryExt(Union):
    SWITCH = Int32
    ARMS = {0: None, 1: ("v1", TrustLineEntryV1)}


class TrustLineEntry(Struct):
    FIELDS = [
        ("accountID", AccountID),
        ("asset", TrustLineAsset),
        ("balance", Int64),
        ("limit", Int64),
        ("flags", Uint32),
        ("ext", _TrustLineEntryExt),
    ]


class OfferEntryFlags(IntEnum):
    PASSIVE_FLAG = 1


class OfferEntry(Struct):
    FIELDS = [
        ("sellerID", AccountID),
        ("offerID", Int64),
        ("selling", Asset),
        ("buying", Asset),
        ("amount", Int64),
        ("price", Price),
        ("flags", Uint32),
        ("ext", ExtensionPoint),
    ]


class DataEntry(Struct):
    FIELDS = [
        ("accountID", AccountID),
        ("dataName", String64),
        ("dataValue", DataValue),
        ("ext", ExtensionPoint),
    ]


class ClaimPredicateType(IntEnum):
    CLAIM_PREDICATE_UNCONDITIONAL = 0
    CLAIM_PREDICATE_AND = 1
    CLAIM_PREDICATE_OR = 2
    CLAIM_PREDICATE_NOT = 3
    CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME = 4
    CLAIM_PREDICATE_BEFORE_RELATIVE_TIME = 5


class ClaimPredicate(Union):
    SWITCH = ClaimPredicateType
    ARMS = {
        ClaimPredicateType.CLAIM_PREDICATE_UNCONDITIONAL: None,
        ClaimPredicateType.CLAIM_PREDICATE_AND:
            ("andPredicates", VarArray(Lazy(lambda: ClaimPredicate), 2)),
        ClaimPredicateType.CLAIM_PREDICATE_OR:
            ("orPredicates", VarArray(Lazy(lambda: ClaimPredicate), 2)),
        ClaimPredicateType.CLAIM_PREDICATE_NOT:
            ("notPredicate", Optional(Lazy(lambda: ClaimPredicate))),
        ClaimPredicateType.CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME:
            ("absBefore", Int64),
        ClaimPredicateType.CLAIM_PREDICATE_BEFORE_RELATIVE_TIME:
            ("relBefore", Int64),
    }


class ClaimantType(IntEnum):
    CLAIMANT_TYPE_V0 = 0


class ClaimantV0(Struct):
    FIELDS = [("destination", AccountID), ("predicate", ClaimPredicate)]


class Claimant(Union):
    SWITCH = ClaimantType
    ARMS = {ClaimantType.CLAIMANT_TYPE_V0: ("v0", ClaimantV0)}


class ClaimableBalanceIDType(IntEnum):
    CLAIMABLE_BALANCE_ID_TYPE_V0 = 0


class ClaimableBalanceID(Union):
    SWITCH = ClaimableBalanceIDType
    ARMS = {ClaimableBalanceIDType.CLAIMABLE_BALANCE_ID_TYPE_V0: ("v0", Hash)}


class ClaimableBalanceFlags(IntEnum):
    CLAIMABLE_BALANCE_CLAWBACK_ENABLED_FLAG = 0x1


class ClaimableBalanceEntryExtensionV1(Struct):
    FIELDS = [("ext", ExtensionPoint), ("flags", Uint32)]


class _ClaimableBalanceEntryExt(Union):
    SWITCH = Int32
    ARMS = {0: None, 1: ("v1", ClaimableBalanceEntryExtensionV1)}


class ClaimableBalanceEntry(Struct):
    FIELDS = [
        ("balanceID", ClaimableBalanceID),
        ("claimants", VarArray(Claimant, 10)),
        ("asset", Asset),
        ("amount", Int64),
        ("ext", _ClaimableBalanceEntryExt),
    ]


class LiquidityPoolConstantProductParameters(Struct):
    FIELDS = [("assetA", Asset), ("assetB", Asset), ("fee", Int32)]


class _LPConstantProduct(Struct):
    FIELDS = [
        ("params", LiquidityPoolConstantProductParameters),
        ("reserveA", Int64),
        ("reserveB", Int64),
        ("totalPoolShares", Int64),
        ("poolSharesTrustLineCount", Int64),
    ]


class _LiquidityPoolBody(Union):
    SWITCH = LiquidityPoolType
    ARMS = {
        LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT:
            ("constantProduct", _LPConstantProduct),
    }


class LiquidityPoolEntry(Struct):
    FIELDS = [
        ("liquidityPoolID", PoolID),
        ("body", _LiquidityPoolBody),
    ]


class _LedgerEntryData(Union):
    SWITCH = LedgerEntryType
    ARMS = {
        LedgerEntryType.ACCOUNT: ("account", AccountEntry),
        LedgerEntryType.TRUSTLINE: ("trustLine", TrustLineEntry),
        LedgerEntryType.OFFER: ("offer", OfferEntry),
        LedgerEntryType.DATA: ("data", DataEntry),
        LedgerEntryType.CLAIMABLE_BALANCE:
            ("claimableBalance", ClaimableBalanceEntry),
        LedgerEntryType.LIQUIDITY_POOL: ("liquidityPool", LiquidityPoolEntry),
    }


class LedgerEntryExtensionV1(Struct):
    FIELDS = [
        ("sponsoringID", SponsorshipDescriptor),
        ("ext", ExtensionPoint),
    ]


class _LedgerEntryExt(Union):
    SWITCH = Int32
    ARMS = {0: None, 1: ("v1", LedgerEntryExtensionV1)}


class LedgerEntry(Struct):
    FIELDS = [
        ("lastModifiedLedgerSeq", Uint32),
        ("data", _LedgerEntryData),
        ("ext", _LedgerEntryExt),
    ]


# --- LedgerKey -------------------------------------------------------------

class _LedgerKeyAccount(Struct):
    FIELDS = [("accountID", AccountID)]


class _LedgerKeyTrustLine(Struct):
    FIELDS = [("accountID", AccountID), ("asset", TrustLineAsset)]


class _LedgerKeyOffer(Struct):
    FIELDS = [("sellerID", AccountID), ("offerID", Int64)]


class _LedgerKeyData(Struct):
    FIELDS = [("accountID", AccountID), ("dataName", String64)]


class _LedgerKeyClaimableBalance(Struct):
    FIELDS = [("balanceID", ClaimableBalanceID)]


class _LedgerKeyLiquidityPool(Struct):
    FIELDS = [("liquidityPoolID", PoolID)]


class LedgerKey(Union):
    SWITCH = LedgerEntryType
    ARMS = {
        LedgerEntryType.ACCOUNT: ("account", _LedgerKeyAccount),
        LedgerEntryType.TRUSTLINE: ("trustLine", _LedgerKeyTrustLine),
        LedgerEntryType.OFFER: ("offer", _LedgerKeyOffer),
        LedgerEntryType.DATA: ("data", _LedgerKeyData),
        LedgerEntryType.CLAIMABLE_BALANCE:
            ("claimableBalance", _LedgerKeyClaimableBalance),
        LedgerEntryType.LIQUIDITY_POOL:
            ("liquidityPool", _LedgerKeyLiquidityPool),
    }

    # LedgerKeys are immutable by convention: they are constructed,
    # serialized, compared, and discarded.  The serialized form is
    # memoized per instance, and account keys (the hottest kind — every
    # fee/seqnum/signature/op phase re-loads source accounts) are
    # interned by raw public key.
    _ACCOUNT_KEYS: dict = {}

    def to_bytes(self) -> bytes:
        b = self.__dict__.get("_kb")
        if b is None:
            b = self.__dict__["_kb"] = Union.to_bytes(self)
        return b

    @classmethod
    def account(cls, account_id: PublicKey) -> "LedgerKey":
        raw = bytes(account_id.value)
        k = cls._ACCOUNT_KEYS.get(raw)
        if k is None:
            if len(cls._ACCOUNT_KEYS) > 65536:
                cls._ACCOUNT_KEYS.clear()
            k = cls(LedgerEntryType.ACCOUNT,
                    _LedgerKeyAccount(accountID=account_id))
            cls._ACCOUNT_KEYS[raw] = k
        return k

    @classmethod
    def trust_line(cls, account_id: PublicKey, asset: TrustLineAsset) -> "LedgerKey":
        return cls(LedgerEntryType.TRUSTLINE,
                   _LedgerKeyTrustLine(accountID=account_id, asset=asset))

    @classmethod
    def offer(cls, seller_id: PublicKey, offer_id: int) -> "LedgerKey":
        return cls(LedgerEntryType.OFFER,
                   _LedgerKeyOffer(sellerID=seller_id, offerID=offer_id))

    @classmethod
    def data(cls, account_id: PublicKey, name: bytes) -> "LedgerKey":
        return cls(LedgerEntryType.DATA,
                   _LedgerKeyData(accountID=account_id, dataName=name))

    @classmethod
    def claimable_balance(cls, balance_id: ClaimableBalanceID) -> "LedgerKey":
        return cls(LedgerEntryType.CLAIMABLE_BALANCE,
                   _LedgerKeyClaimableBalance(balanceID=balance_id))

    @classmethod
    def liquidity_pool(cls, pool_id: bytes) -> "LedgerKey":
        return cls(LedgerEntryType.LIQUIDITY_POOL,
                   _LedgerKeyLiquidityPool(liquidityPoolID=pool_id))


def ledger_entry_key(entry: LedgerEntry) -> LedgerKey:
    """LedgerKey for a LedgerEntry (reference: ledger/LedgerHashUtils usage,
    LedgerEntryKey in ledger/InternalLedgerEntry.cpp)."""
    t = entry.data.disc
    d = entry.data.value
    if t == LedgerEntryType.ACCOUNT:
        return LedgerKey.account(d.accountID)
    if t == LedgerEntryType.TRUSTLINE:
        return LedgerKey.trust_line(d.accountID, d.asset)
    if t == LedgerEntryType.OFFER:
        return LedgerKey.offer(d.sellerID, d.offerID)
    if t == LedgerEntryType.DATA:
        return LedgerKey.data(d.accountID, d.dataName)
    if t == LedgerEntryType.CLAIMABLE_BALANCE:
        return LedgerKey.claimable_balance(d.balanceID)
    if t == LedgerEntryType.LIQUIDITY_POOL:
        return LedgerKey.liquidity_pool(d.liquidityPoolID)
    # Soroban entry types: key helpers are registered by xdr.contract
    if t == LedgerEntryType.CONTRACT_DATA:
        return LedgerKey.contract_data(d.contract, d.key, d.durability)
    if t == LedgerEntryType.CONTRACT_CODE:
        return LedgerKey.contract_code(bytes(d.hash))
    if t == LedgerEntryType.CONFIG_SETTING:
        return LedgerKey.config_setting(d.disc)
    if t == LedgerEntryType.TTL:
        return LedgerKey.ttl(bytes(d.keyHash))
    raise ValueError(f"unsupported entry type {t}")
