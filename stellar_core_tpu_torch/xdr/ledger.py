"""Ledger-level types (reference: Stellar-ledger.x; consumed by
src/ledger/LedgerManagerImpl, src/herder/TxSetFrame, src/bucket/Bucket)."""

from __future__ import annotations

from enum import IntEnum

from .runtime import (
    Lazy,
    Array, Int32, Int64, Opaque, Optional, Struct, Uint32, Uint64, Union,
    VarArray, VarOpaque,
)
from .types import (
    ExtensionPoint, Hash, NodeID, PublicKey, Signature, Uint256,
)
from .ledger_entries import LedgerEntry, LedgerKey
from .transaction import TransactionEnvelope
from .results import TransactionResultPair, TransactionResultSet
from .scp import SCPHistoryEntry

UpgradeType = VarOpaque(128)

MAX_TX_SET_ALLOWANCE = 0xFFFFFFFF


class StellarValueType(IntEnum):
    STELLAR_VALUE_BASIC = 0
    STELLAR_VALUE_SIGNED = 1


class LedgerCloseValueSignature(Struct):
    FIELDS = [("nodeID", NodeID), ("signature", Signature)]


class _StellarValueExt(Union):
    SWITCH = StellarValueType
    ARMS = {
        StellarValueType.STELLAR_VALUE_BASIC: None,
        StellarValueType.STELLAR_VALUE_SIGNED:
            ("lcValueSignature", LedgerCloseValueSignature),
    }


class StellarValue(Struct):
    """The value SCP agrees on per ledger (reference: Stellar-ledger.x
    StellarValue; built in herder/HerderImpl::triggerNextLedger)."""
    FIELDS = [
        ("txSetHash", Hash),
        ("closeTime", Uint64),
        ("upgrades", VarArray(UpgradeType, 6)),
        ("ext", _StellarValueExt),
    ]


class LedgerHeaderFlags(IntEnum):
    DISABLE_LIQUIDITY_POOL_TRADING_FLAG = 0x1
    DISABLE_LIQUIDITY_POOL_DEPOSIT_FLAG = 0x2
    DISABLE_LIQUIDITY_POOL_WITHDRAWAL_FLAG = 0x4


class LedgerHeaderExtensionV1(Struct):
    FIELDS = [("flags", Uint32), ("ext", ExtensionPoint)]


class _LedgerHeaderExt(Union):
    SWITCH = Int32
    ARMS = {0: None, 1: ("v1", LedgerHeaderExtensionV1)}


class LedgerHeader(Struct):
    FIELDS = [
        ("ledgerVersion", Uint32),
        ("previousLedgerHash", Hash),
        ("scpValue", StellarValue),
        ("txSetResultHash", Hash),
        ("bucketListHash", Hash),
        ("ledgerSeq", Uint32),
        ("totalCoins", Int64),
        ("feePool", Int64),
        ("inflationSeq", Uint32),
        ("idPool", Uint64),
        ("baseFee", Uint32),
        ("baseReserve", Uint32),
        ("maxTxSetSize", Uint32),
        ("skipList", Array(Hash, 4)),
        ("ext", _LedgerHeaderExt),
    ]


class LedgerUpgradeType(IntEnum):
    LEDGER_UPGRADE_VERSION = 1
    LEDGER_UPGRADE_BASE_FEE = 2
    LEDGER_UPGRADE_MAX_TX_SET_SIZE = 3
    LEDGER_UPGRADE_BASE_RESERVE = 4
    LEDGER_UPGRADE_FLAGS = 5
    LEDGER_UPGRADE_CONFIG = 6
    LEDGER_UPGRADE_MAX_SOROBAN_TX_SET_SIZE = 7


def _config_upgrade_set_key():
    from .contract import ConfigUpgradeSetKey
    return ConfigUpgradeSetKey


class LedgerUpgrade(Union):
    SWITCH = LedgerUpgradeType
    ARMS = {
        LedgerUpgradeType.LEDGER_UPGRADE_VERSION: ("newLedgerVersion", Uint32),
        LedgerUpgradeType.LEDGER_UPGRADE_BASE_FEE: ("newBaseFee", Uint32),
        LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
            ("newMaxTxSetSize", Uint32),
        LedgerUpgradeType.LEDGER_UPGRADE_BASE_RESERVE:
            ("newBaseReserve", Uint32),
        LedgerUpgradeType.LEDGER_UPGRADE_FLAGS: ("newFlags", Uint32),
        LedgerUpgradeType.LEDGER_UPGRADE_CONFIG:
            ("newConfig", Lazy(lambda: _config_upgrade_set_key())),
        LedgerUpgradeType.LEDGER_UPGRADE_MAX_SOROBAN_TX_SET_SIZE:
            ("newMaxSorobanTxSetSize", Uint32),
    }


# --- Transaction sets ------------------------------------------------------

class TransactionSet(Struct):
    """Legacy (pre-protocol-20 wire) tx set (reference: herder/TxSetFrame)."""
    FIELDS = [
        ("previousLedgerHash", Hash),
        ("txs", VarArray(TransactionEnvelope)),
    ]


class _TxSetComponentTxsMaybeDiscountedFee(Struct):
    FIELDS = [
        ("baseFee", Optional(Int64)),
        ("txs", VarArray(TransactionEnvelope)),
    ]


class TxSetComponentType(IntEnum):
    TXSET_COMP_TXS_MAYBE_DISCOUNTED_FEE = 0


class TxSetComponent(Union):
    SWITCH = TxSetComponentType
    ARMS = {
        TxSetComponentType.TXSET_COMP_TXS_MAYBE_DISCOUNTED_FEE:
            ("txsMaybeDiscountedFee", _TxSetComponentTxsMaybeDiscountedFee),
    }


class TransactionPhase(Union):
    SWITCH = Int32
    ARMS = {0: ("v0Components", VarArray(TxSetComponent))}


class _TransactionSetV1(Struct):
    FIELDS = [
        ("previousLedgerHash", Hash),
        ("phases", VarArray(TransactionPhase)),
    ]


class GeneralizedTransactionSet(Union):
    """Protocol-20+ two-phase tx set (reference: herder/TxSetFrame.h:28-33 —
    phases CLASSIC and SOROBAN)."""
    SWITCH = Int32
    ARMS = {1: ("v1TxSet", _TransactionSetV1)}

    def __init__(self, disc=1, value=None, **kw):
        if value is None and not kw:
            value = _TransactionSetV1()
        super().__init__(disc, value, **kw)


TransactionSetV1 = _TransactionSetV1


# --- History entries -------------------------------------------------------

class _TxHistoryEntryExt(Union):
    SWITCH = Int32
    ARMS = {0: None, 1: ("generalizedTxSet", GeneralizedTransactionSet)}


class TransactionHistoryEntry(Struct):
    FIELDS = [
        ("ledgerSeq", Uint32),
        ("txSet", TransactionSet),
        ("ext", _TxHistoryEntryExt),
    ]


class TransactionHistoryResultEntry(Struct):
    FIELDS = [
        ("ledgerSeq", Uint32),
        ("txResultSet", TransactionResultSet),
        ("ext", ExtensionPoint),
    ]


class LedgerHeaderHistoryEntry(Struct):
    FIELDS = [
        ("hash", Hash),
        ("header", LedgerHeader),
        ("ext", ExtensionPoint),
    ]


# --- Ledger close meta -----------------------------------------------------

class LedgerEntryChangeType(IntEnum):
    LEDGER_ENTRY_CREATED = 0
    LEDGER_ENTRY_UPDATED = 1
    LEDGER_ENTRY_REMOVED = 2
    LEDGER_ENTRY_STATE = 3


class LedgerEntryChange(Union):
    SWITCH = LedgerEntryChangeType
    ARMS = {
        LedgerEntryChangeType.LEDGER_ENTRY_CREATED: ("created", LedgerEntry),
        LedgerEntryChangeType.LEDGER_ENTRY_UPDATED: ("updated", LedgerEntry),
        LedgerEntryChangeType.LEDGER_ENTRY_REMOVED: ("removed", LedgerKey),
        LedgerEntryChangeType.LEDGER_ENTRY_STATE: ("state", LedgerEntry),
    }


LedgerEntryChanges = VarArray(LedgerEntryChange)


class OperationMeta(Struct):
    FIELDS = [("changes", LedgerEntryChanges)]


class TransactionMetaV1(Struct):
    FIELDS = [
        ("txChanges", LedgerEntryChanges),
        ("operations", VarArray(OperationMeta)),
    ]


class TransactionMetaV2(Struct):
    FIELDS = [
        ("txChangesBefore", LedgerEntryChanges),
        ("operations", VarArray(OperationMeta)),
        ("txChangesAfter", LedgerEntryChanges),
    ]


class DiagnosticEvent(Struct):
    # reference: Stellar-ledger.x DiagnosticEvent
    FIELDS = [
        ("inSuccessfulContractCall", Lazy(lambda: _Bool())),
        ("event", Lazy(lambda: _contract().ContractEvent)),
    ]


class SorobanTransactionMeta(Struct):
    # reference: Stellar-ledger.x SorobanTransactionMeta — the soroban
    # leg of V3 meta: contract events, the host-fn return value, and
    # (off-consensus) diagnostic events
    FIELDS = [
        ("ext", ExtensionPoint),
        ("events", Lazy(lambda: VarArray(_contract().ContractEvent))),
        ("returnValue", Lazy(lambda: _contract().SCVal)),
        ("diagnosticEvents", VarArray(DiagnosticEvent)),
    ]


def _contract():
    from . import contract
    return contract


def _Bool():
    from .runtime import Bool
    return Bool


class TransactionMetaV3(Struct):
    # reference: Stellar-ledger.x TransactionMetaV3 (protocol 20+)
    FIELDS = [
        ("ext", ExtensionPoint),
        ("txChangesBefore", LedgerEntryChanges),
        ("operations", VarArray(OperationMeta)),
        ("txChangesAfter", LedgerEntryChanges),
        ("sorobanMeta", Optional(SorobanTransactionMeta)),
    ]


class TransactionMeta(Union):
    SWITCH = Int32
    ARMS = {
        0: ("operations", VarArray(OperationMeta)),
        1: ("v1", TransactionMetaV1),
        2: ("v2", TransactionMetaV2),
        3: ("v3", TransactionMetaV3),
    }


class TransactionResultMeta(Struct):
    FIELDS = [
        ("result", TransactionResultPair),
        ("feeProcessing", LedgerEntryChanges),
        ("txApplyProcessing", TransactionMeta),
    ]


class UpgradeEntryMeta(Struct):
    FIELDS = [
        ("upgrade", UpgradeType),
        ("changes", LedgerEntryChanges),
    ]


class LedgerCloseMetaV0(Struct):
    FIELDS = [
        ("ledgerHeader", LedgerHeaderHistoryEntry),
        ("txSet", TransactionSet),
        ("txProcessing", VarArray(TransactionResultMeta)),
        ("upgradesProcessing", VarArray(UpgradeEntryMeta)),
        ("scpInfo", VarArray(SCPHistoryEntry)),
    ]


class LedgerCloseMetaV1(Struct):
    """Protocol-20+ meta: generalized tx set + Soroban eviction info
    (reference: Stellar-ledger.x LedgerCloseMetaV1)."""
    FIELDS = [
        ("ext", ExtensionPoint),
        ("ledgerHeader", LedgerHeaderHistoryEntry),
        ("txSet", GeneralizedTransactionSet),
        ("txProcessing", VarArray(TransactionResultMeta)),
        ("upgradesProcessing", VarArray(UpgradeEntryMeta)),
        ("scpInfo", VarArray(SCPHistoryEntry)),
        ("totalByteSizeOfBucketList", Uint64),
        ("evictedTemporaryLedgerKeys", VarArray(LedgerKey)),
        ("evictedPersistentLedgerEntries", VarArray(LedgerEntry)),
    ]


class LedgerCloseMeta(Union):
    SWITCH = Int32
    ARMS = {0: ("v0", LedgerCloseMetaV0), 1: ("v1", LedgerCloseMetaV1)}


# --- Bucket entries --------------------------------------------------------

class BucketEntryType(IntEnum):
    METAENTRY = -1
    LIVEENTRY = 0
    DEADENTRY = 1
    INITENTRY = 2


class BucketMetadata(Struct):
    """First entry of every bucket from protocol 11 on (reference:
    bucket/Bucket.cpp METAENTRY handling, LedgerCmp.h)."""
    FIELDS = [("ledgerVersion", Uint32), ("ext", ExtensionPoint)]


class BucketEntry(Union):
    SWITCH = BucketEntryType
    ARMS = {
        BucketEntryType.LIVEENTRY: ("liveEntry", LedgerEntry),
        BucketEntryType.INITENTRY: ("liveEntry", LedgerEntry),
        BucketEntryType.DEADENTRY: ("deadEntry", LedgerKey),
        BucketEntryType.METAENTRY: ("metaEntry", BucketMetadata),
    }
