"""Smart-contract protocol types.

Reference: Stellar-contract.x, Stellar-contract-config-setting.x, and the
Soroban parts of Stellar-ledger-entries.x / Stellar-transaction.x
(consumed by transactions/InvokeHostFunctionOpFrame.cpp and the host in
src/rust/src/contract.rs). This is the wire-faithful subset the host
layer executes: SCVal's common arms, contract data/code/TTL entries,
resource declarations, host functions, and authorization entries.
"""

from __future__ import annotations

from enum import IntEnum

from .runtime import (
    Array, Bool, Int32, Int64, Lazy, Opaque, Optional, Struct, Uint32,
    Uint64, Union, VarArray, VarOpaque, XdrString,
)
from .types import AccountID, ExtensionPoint, Hash, PublicKey, Uint256
from .ledger_entries import LedgerEntryType, LedgerKey


# --- SCVal ------------------------------------------------------------------

class SCValType(IntEnum):
    SCV_BOOL = 0
    SCV_VOID = 1
    SCV_ERROR = 2
    SCV_U32 = 3
    SCV_I32 = 4
    SCV_U64 = 5
    SCV_I64 = 6
    SCV_TIMEPOINT = 7
    SCV_DURATION = 8
    SCV_U128 = 9
    SCV_I128 = 10
    SCV_U256 = 11
    SCV_I256 = 12
    SCV_BYTES = 13
    SCV_STRING = 14
    SCV_SYMBOL = 15
    SCV_VEC = 16
    SCV_MAP = 17
    SCV_ADDRESS = 18
    SCV_CONTRACT_INSTANCE = 19
    SCV_LEDGER_KEY_CONTRACT_INSTANCE = 20
    SCV_LEDGER_KEY_NONCE = 21


class SCErrorType(IntEnum):
    SCE_CONTRACT = 0
    SCE_WASM_VM = 1
    SCE_CONTEXT = 2
    SCE_STORAGE = 3
    SCE_OBJECT = 4
    SCE_CRYPTO = 5
    SCE_EVENTS = 6
    SCE_BUDGET = 7
    SCE_VALUE = 8
    SCE_AUTH = 9


class SCErrorCode(IntEnum):
    SCEC_ARITH_DOMAIN = 0
    SCEC_INDEX_BOUNDS = 1
    SCEC_INVALID_INPUT = 2
    SCEC_MISSING_VALUE = 3
    SCEC_EXISTING_VALUE = 4
    SCEC_EXCEEDED_LIMIT = 5
    SCEC_INVALID_ACTION = 6
    SCEC_INTERNAL_ERROR = 7
    SCEC_UNEXPECTED_TYPE = 8
    SCEC_UNEXPECTED_SIZE = 9


class SCError(Union):
    SWITCH = SCErrorType
    ARMS = {
        SCErrorType.SCE_CONTRACT: ("contractCode", Uint32),
        SCErrorType.SCE_WASM_VM: None,
        SCErrorType.SCE_CONTEXT: None,
        SCErrorType.SCE_STORAGE: None,
        SCErrorType.SCE_OBJECT: None,
        SCErrorType.SCE_CRYPTO: None,
        SCErrorType.SCE_EVENTS: None,
        SCErrorType.SCE_BUDGET: None,
        SCErrorType.SCE_VALUE: None,
        SCErrorType.SCE_AUTH: ("code", SCErrorCode),
    }


class SCAddressType(IntEnum):
    SC_ADDRESS_TYPE_ACCOUNT = 0
    SC_ADDRESS_TYPE_CONTRACT = 1


class SCAddress(Union):
    SWITCH = SCAddressType
    ARMS = {
        SCAddressType.SC_ADDRESS_TYPE_ACCOUNT: ("accountId", AccountID),
        SCAddressType.SC_ADDRESS_TYPE_CONTRACT: ("contractId", Hash),
    }


class UInt128Parts(Struct):
    FIELDS = [("hi", Uint64), ("lo", Uint64)]


class Int128Parts(Struct):
    FIELDS = [("hi", Int64), ("lo", Uint64)]


class UInt256Parts(Struct):
    FIELDS = [("hi_hi", Uint64), ("hi_lo", Uint64),
              ("lo_hi", Uint64), ("lo_lo", Uint64)]


class Int256Parts(Struct):
    FIELDS = [("hi_hi", Int64), ("hi_lo", Uint64),
              ("lo_hi", Uint64), ("lo_lo", Uint64)]


SCSymbol = XdrString(32)
SCString = XdrString()
SCBytes = VarOpaque()


class SCNonceKey(Struct):
    FIELDS = [("nonce", Int64)]


class SCMapEntry(Struct):
    FIELDS = [("key", Lazy(lambda: SCVal)), ("val", Lazy(lambda: SCVal))]


class SCContractInstance(Struct):
    FIELDS = [
        ("executable", Lazy(lambda: ContractExecutable)),
        ("storage", Optional(VarArray(SCMapEntry))),
    ]


class SCVal(Union):
    SWITCH = SCValType
    ARMS = {
        SCValType.SCV_BOOL: ("b", Bool),
        SCValType.SCV_VOID: None,
        SCValType.SCV_ERROR: ("error", SCError),
        SCValType.SCV_U32: ("u32", Uint32),
        SCValType.SCV_I32: ("i32", Int32),
        SCValType.SCV_U64: ("u64", Uint64),
        SCValType.SCV_I64: ("i64", Int64),
        SCValType.SCV_TIMEPOINT: ("timepoint", Uint64),
        SCValType.SCV_DURATION: ("duration", Uint64),
        SCValType.SCV_U128: ("u128", UInt128Parts),
        SCValType.SCV_I128: ("i128", Int128Parts),
        SCValType.SCV_U256: ("u256", UInt256Parts),
        SCValType.SCV_I256: ("i256", Int256Parts),
        SCValType.SCV_BYTES: ("bytes", SCBytes),
        SCValType.SCV_STRING: ("str", SCString),
        SCValType.SCV_SYMBOL: ("sym", SCSymbol),
        SCValType.SCV_VEC: ("vec", Optional(VarArray(Lazy(lambda: SCVal)))),
        SCValType.SCV_MAP: ("map", Optional(VarArray(SCMapEntry))),
        SCValType.SCV_ADDRESS: ("address", SCAddress),
        SCValType.SCV_CONTRACT_INSTANCE: ("instance", SCContractInstance),
        SCValType.SCV_LEDGER_KEY_CONTRACT_INSTANCE: None,
        SCValType.SCV_LEDGER_KEY_NONCE: ("nonce_key", SCNonceKey),
    }


# --- Contract entries -------------------------------------------------------

class ContractExecutableType(IntEnum):
    CONTRACT_EXECUTABLE_WASM = 0
    CONTRACT_EXECUTABLE_STELLAR_ASSET = 1


class ContractExecutable(Union):
    SWITCH = ContractExecutableType
    ARMS = {
        ContractExecutableType.CONTRACT_EXECUTABLE_WASM:
            ("wasm_hash", Hash),
        ContractExecutableType.CONTRACT_EXECUTABLE_STELLAR_ASSET: None,
    }


class ContractDataDurability(IntEnum):
    TEMPORARY = 0
    PERSISTENT = 1


class ContractDataEntry(Struct):
    FIELDS = [
        ("ext", ExtensionPoint),
        ("contract", SCAddress),
        ("key", SCVal),
        ("durability", ContractDataDurability),
        ("val", SCVal),
    ]


class ContractCodeEntry(Struct):
    FIELDS = [
        ("ext", ExtensionPoint),
        ("hash", Hash),
        ("code", VarOpaque()),
    ]


class TTLEntry(Struct):
    # keyHash = SHA256(LedgerKey of the extended entry)
    FIELDS = [
        ("keyHash", Hash),
        ("liveUntilLedgerSeq", Uint32),
    ]


# --- Ledger keys for contract entries (joined into LedgerKey by the
# soroban layer registering these arms) ------------------------------------

class LedgerKeyContractData(Struct):
    FIELDS = [
        ("contract", SCAddress),
        ("key", SCVal),
        ("durability", ContractDataDurability),
    ]


class LedgerKeyContractCode(Struct):
    FIELDS = [("hash", Hash)]


class LedgerKeyTtl(Struct):
    FIELDS = [("keyHash", Hash)]


# --- Soroban tx resources ---------------------------------------------------

class LedgerFootprint(Struct):
    FIELDS = [
        ("readOnly", VarArray(LedgerKey)),
        ("readWrite", VarArray(LedgerKey)),
    ]


class SorobanResources(Struct):
    FIELDS = [
        ("footprint", LedgerFootprint),
        ("instructions", Uint32),
        ("readBytes", Uint32),
        ("writeBytes", Uint32),
    ]


class SorobanTransactionData(Struct):
    FIELDS = [
        ("ext", ExtensionPoint),
        ("resources", SorobanResources),
        ("resourceFee", Int64),
    ]


# --- Host functions ---------------------------------------------------------

class ContractIDPreimageType(IntEnum):
    CONTRACT_ID_PREIMAGE_FROM_ADDRESS = 0
    CONTRACT_ID_PREIMAGE_FROM_ASSET = 1


class _ContractIDPreimageFromAddress(Struct):
    FIELDS = [("address", SCAddress), ("salt", Uint256)]


class ContractIDPreimage(Union):
    SWITCH = ContractIDPreimageType
    ARMS = {
        ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ADDRESS:
            ("fromAddress", _ContractIDPreimageFromAddress),
        ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ASSET:
            ("fromAsset", Lazy(lambda: _asset_type())),
    }


def _asset_type():
    from .ledger_entries import Asset
    return Asset


class CreateContractArgs(Struct):
    FIELDS = [
        ("contractIDPreimage", ContractIDPreimage),
        ("executable", ContractExecutable),
    ]


class InvokeContractArgs(Struct):
    FIELDS = [
        ("contractAddress", SCAddress),
        ("functionName", SCSymbol),
        ("args", VarArray(SCVal)),
    ]


class HostFunctionType(IntEnum):
    HOST_FUNCTION_TYPE_INVOKE_CONTRACT = 0
    HOST_FUNCTION_TYPE_CREATE_CONTRACT = 1
    HOST_FUNCTION_TYPE_UPLOAD_CONTRACT_WASM = 2


class HostFunction(Union):
    SWITCH = HostFunctionType
    ARMS = {
        HostFunctionType.HOST_FUNCTION_TYPE_INVOKE_CONTRACT:
            ("invokeContract", InvokeContractArgs),
        HostFunctionType.HOST_FUNCTION_TYPE_CREATE_CONTRACT:
            ("createContract", CreateContractArgs),
        HostFunctionType.HOST_FUNCTION_TYPE_UPLOAD_CONTRACT_WASM:
            ("wasm", VarOpaque()),
    }


# --- Authorization ----------------------------------------------------------

class SorobanAuthorizedFunctionType(IntEnum):
    SOROBAN_AUTHORIZED_FUNCTION_TYPE_CONTRACT_FN = 0
    SOROBAN_AUTHORIZED_FUNCTION_TYPE_CREATE_CONTRACT_HOST_FN = 1


class SorobanAuthorizedFunction(Union):
    SWITCH = SorobanAuthorizedFunctionType
    ARMS = {
        SorobanAuthorizedFunctionType
        .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CONTRACT_FN:
            ("contractFn", InvokeContractArgs),
        SorobanAuthorizedFunctionType
        .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CREATE_CONTRACT_HOST_FN:
            ("createContractHostFn", CreateContractArgs),
    }


class SorobanAuthorizedInvocation(Struct):
    FIELDS = [
        ("function", SorobanAuthorizedFunction),
        ("subInvocations",
         VarArray(Lazy(lambda: SorobanAuthorizedInvocation))),
    ]


class SorobanAddressCredentials(Struct):
    FIELDS = [
        ("address", SCAddress),
        ("nonce", Int64),
        ("signatureExpirationLedger", Uint32),
        ("signature", SCVal),
    ]


class SorobanCredentialsType(IntEnum):
    SOROBAN_CREDENTIALS_SOURCE_ACCOUNT = 0
    SOROBAN_CREDENTIALS_ADDRESS = 1


class SorobanCredentials(Union):
    SWITCH = SorobanCredentialsType
    ARMS = {
        SorobanCredentialsType.SOROBAN_CREDENTIALS_SOURCE_ACCOUNT: None,
        SorobanCredentialsType.SOROBAN_CREDENTIALS_ADDRESS:
            ("address", SorobanAddressCredentials),
    }


class SorobanAuthorizationEntry(Struct):
    FIELDS = [
        ("credentials", SorobanCredentials),
        ("rootInvocation", SorobanAuthorizedInvocation),
    ]


# --- Operations -------------------------------------------------------------

class InvokeHostFunctionOp(Struct):
    FIELDS = [
        ("hostFunction", HostFunction),
        ("auth", VarArray(SorobanAuthorizationEntry)),
    ]


class ExtendFootprintTTLOp(Struct):
    FIELDS = [
        ("ext", ExtensionPoint),
        ("extendTo", Uint32),
    ]


class RestoreFootprintOp(Struct):
    FIELDS = [("ext", ExtensionPoint)]


# --- Results ----------------------------------------------------------------

class InvokeHostFunctionResultCode(IntEnum):
    INVOKE_HOST_FUNCTION_SUCCESS = 0
    INVOKE_HOST_FUNCTION_MALFORMED = -1
    INVOKE_HOST_FUNCTION_TRAPPED = -2
    INVOKE_HOST_FUNCTION_RESOURCE_LIMIT_EXCEEDED = -3
    INVOKE_HOST_FUNCTION_ENTRY_ARCHIVED = -4
    INVOKE_HOST_FUNCTION_INSUFFICIENT_REFUNDABLE_FEE = -5


class InvokeHostFunctionResult(Union):
    SWITCH = InvokeHostFunctionResultCode
    ARMS = {
        InvokeHostFunctionResultCode.INVOKE_HOST_FUNCTION_SUCCESS:
            ("success", Hash),
        InvokeHostFunctionResultCode.INVOKE_HOST_FUNCTION_MALFORMED: None,
        InvokeHostFunctionResultCode.INVOKE_HOST_FUNCTION_TRAPPED: None,
        InvokeHostFunctionResultCode
        .INVOKE_HOST_FUNCTION_RESOURCE_LIMIT_EXCEEDED: None,
        InvokeHostFunctionResultCode
        .INVOKE_HOST_FUNCTION_ENTRY_ARCHIVED: None,
        InvokeHostFunctionResultCode
        .INVOKE_HOST_FUNCTION_INSUFFICIENT_REFUNDABLE_FEE: None,
    }


class ExtendFootprintTTLResultCode(IntEnum):
    EXTEND_FOOTPRINT_TTL_SUCCESS = 0
    EXTEND_FOOTPRINT_TTL_MALFORMED = -1
    EXTEND_FOOTPRINT_TTL_RESOURCE_LIMIT_EXCEEDED = -2
    EXTEND_FOOTPRINT_TTL_INSUFFICIENT_REFUNDABLE_FEE = -3


class ExtendFootprintTTLResult(Union):
    SWITCH = ExtendFootprintTTLResultCode
    ARMS = {
        ExtendFootprintTTLResultCode.EXTEND_FOOTPRINT_TTL_SUCCESS: None,
        ExtendFootprintTTLResultCode.EXTEND_FOOTPRINT_TTL_MALFORMED: None,
        ExtendFootprintTTLResultCode
        .EXTEND_FOOTPRINT_TTL_RESOURCE_LIMIT_EXCEEDED: None,
        ExtendFootprintTTLResultCode
        .EXTEND_FOOTPRINT_TTL_INSUFFICIENT_REFUNDABLE_FEE: None,
    }


class RestoreFootprintResultCode(IntEnum):
    RESTORE_FOOTPRINT_SUCCESS = 0
    RESTORE_FOOTPRINT_MALFORMED = -1
    RESTORE_FOOTPRINT_RESOURCE_LIMIT_EXCEEDED = -2
    RESTORE_FOOTPRINT_INSUFFICIENT_REFUNDABLE_FEE = -3


class RestoreFootprintResult(Union):
    SWITCH = RestoreFootprintResultCode
    ARMS = {
        RestoreFootprintResultCode.RESTORE_FOOTPRINT_SUCCESS: None,
        RestoreFootprintResultCode.RESTORE_FOOTPRINT_MALFORMED: None,
        RestoreFootprintResultCode
        .RESTORE_FOOTPRINT_RESOURCE_LIMIT_EXCEEDED: None,
        RestoreFootprintResultCode
        .RESTORE_FOOTPRINT_INSUFFICIENT_REFUNDABLE_FEE: None,
    }


# --- Events (diagnostic subset) --------------------------------------------

class ContractEventType(IntEnum):
    SYSTEM = 0
    CONTRACT = 1
    DIAGNOSTIC = 2


class _ContractEventV0(Struct):
    FIELDS = [
        ("topics", VarArray(SCVal)),
        ("data", SCVal),
    ]


class _ContractEventBody(Union):
    SWITCH = Int32
    ARMS = {0: ("v0", _ContractEventV0)}


class ContractEvent(Struct):
    FIELDS = [
        ("ext", ExtensionPoint),
        ("contractID", Optional(Hash)),
        ("type", ContractEventType),
        ("body", _ContractEventBody),
    ]


# --- Network config settings (reference: Stellar-contract-config-setting.x) --

class ConfigSettingID(IntEnum):
    CONFIG_SETTING_CONTRACT_MAX_SIZE_BYTES = 0
    CONFIG_SETTING_CONTRACT_COMPUTE_V0 = 1
    CONFIG_SETTING_CONTRACT_LEDGER_COST_V0 = 2
    CONFIG_SETTING_CONTRACT_HISTORICAL_DATA_V0 = 3
    CONFIG_SETTING_CONTRACT_EVENTS_V0 = 4
    CONFIG_SETTING_CONTRACT_BANDWIDTH_V0 = 5
    CONFIG_SETTING_CONTRACT_COST_PARAMS_CPU_INSTRUCTIONS = 6
    CONFIG_SETTING_CONTRACT_COST_PARAMS_MEMORY_BYTES = 7
    CONFIG_SETTING_CONTRACT_DATA_KEY_SIZE_BYTES = 8
    CONFIG_SETTING_CONTRACT_DATA_ENTRY_SIZE_BYTES = 9
    CONFIG_SETTING_STATE_ARCHIVAL = 10
    CONFIG_SETTING_CONTRACT_EXECUTION_LANES = 11
    CONFIG_SETTING_BUCKETLIST_SIZE_WINDOW = 12
    CONFIG_SETTING_EVICTION_ITERATOR = 13


class ConfigSettingContractComputeV0(Struct):
    FIELDS = [
        ("ledgerMaxInstructions", Int64),
        ("txMaxInstructions", Int64),
        ("feeRatePerInstructionsIncrement", Int64),
        ("txMemoryLimit", Uint32),
    ]


class ConfigSettingContractLedgerCostV0(Struct):
    FIELDS = [
        ("ledgerMaxReadLedgerEntries", Uint32),
        ("ledgerMaxReadBytes", Uint32),
        ("ledgerMaxWriteLedgerEntries", Uint32),
        ("ledgerMaxWriteBytes", Uint32),
        ("txMaxReadLedgerEntries", Uint32),
        ("txMaxReadBytes", Uint32),
        ("txMaxWriteLedgerEntries", Uint32),
        ("txMaxWriteBytes", Uint32),
        ("feeReadLedgerEntry", Int64),
        ("feeWriteLedgerEntry", Int64),
        ("feeRead1KB", Int64),
        ("bucketListTargetSizeBytes", Int64),
        ("writeFee1KBBucketListLow", Int64),
        ("writeFee1KBBucketListHigh", Int64),
        ("bucketListWriteFeeGrowthFactor", Uint32),
    ]


class ConfigSettingContractHistoricalDataV0(Struct):
    FIELDS = [("feeHistorical1KB", Int64)]


class ConfigSettingContractEventsV0(Struct):
    FIELDS = [
        ("txMaxContractEventsSizeBytes", Uint32),
        ("feeContractEvents1KB", Int64),
    ]


class ConfigSettingContractBandwidthV0(Struct):
    FIELDS = [
        ("ledgerMaxTxsSizeBytes", Uint32),
        ("txMaxSizeBytes", Uint32),
        ("feeTxSize1KB", Int64),
    ]


class ContractCostParamEntry(Struct):
    FIELDS = [
        ("ext", ExtensionPoint),
        ("constTerm", Int64),
        ("linearTerm", Int64),
    ]


class StateArchivalSettings(Struct):
    FIELDS = [
        ("maxEntryTTL", Uint32),
        ("minTemporaryTTL", Uint32),
        ("minPersistentTTL", Uint32),
        ("persistentRentRateDenominator", Int64),
        ("tempRentRateDenominator", Int64),
        ("maxEntriesToArchive", Uint32),
        ("bucketListSizeWindowSampleSize", Uint32),
        ("bucketListWindowSamplePeriod", Uint32),
        ("evictionScanSize", Uint32),
        ("startingEvictionScanLevel", Uint32),
    ]


class ConfigSettingContractExecutionLanesV0(Struct):
    FIELDS = [("ledgerMaxTxCount", Uint32)]


class EvictionIterator(Struct):
    FIELDS = [
        ("bucketListLevel", Uint32),
        ("isCurrBucket", Bool),
        ("bucketFileOffset", Uint64),
    ]


class ConfigSettingEntry(Union):
    SWITCH = ConfigSettingID
    ARMS = {
        ConfigSettingID.CONFIG_SETTING_CONTRACT_MAX_SIZE_BYTES:
            ("contractMaxSizeBytes", Uint32),
        ConfigSettingID.CONFIG_SETTING_CONTRACT_COMPUTE_V0:
            ("contractCompute", ConfigSettingContractComputeV0),
        ConfigSettingID.CONFIG_SETTING_CONTRACT_LEDGER_COST_V0:
            ("contractLedgerCost", ConfigSettingContractLedgerCostV0),
        ConfigSettingID.CONFIG_SETTING_CONTRACT_HISTORICAL_DATA_V0:
            ("contractHistoricalData",
             ConfigSettingContractHistoricalDataV0),
        ConfigSettingID.CONFIG_SETTING_CONTRACT_EVENTS_V0:
            ("contractEvents", ConfigSettingContractEventsV0),
        ConfigSettingID.CONFIG_SETTING_CONTRACT_BANDWIDTH_V0:
            ("contractBandwidth", ConfigSettingContractBandwidthV0),
        ConfigSettingID.CONFIG_SETTING_CONTRACT_COST_PARAMS_CPU_INSTRUCTIONS:
            ("contractCostParamsCpuInsns",
             VarArray(ContractCostParamEntry)),
        ConfigSettingID.CONFIG_SETTING_CONTRACT_COST_PARAMS_MEMORY_BYTES:
            ("contractCostParamsMemBytes",
             VarArray(ContractCostParamEntry)),
        ConfigSettingID.CONFIG_SETTING_CONTRACT_DATA_KEY_SIZE_BYTES:
            ("contractDataKeySizeBytes", Uint32),
        ConfigSettingID.CONFIG_SETTING_CONTRACT_DATA_ENTRY_SIZE_BYTES:
            ("contractDataEntrySizeBytes", Uint32),
        ConfigSettingID.CONFIG_SETTING_STATE_ARCHIVAL:
            ("stateArchivalSettings", StateArchivalSettings),
        ConfigSettingID.CONFIG_SETTING_CONTRACT_EXECUTION_LANES:
            ("contractExecutionLanes",
             ConfigSettingContractExecutionLanesV0),
        ConfigSettingID.CONFIG_SETTING_BUCKETLIST_SIZE_WINDOW:
            ("bucketListSizeWindow", VarArray(Uint64)),
        ConfigSettingID.CONFIG_SETTING_EVICTION_ITERATOR:
            ("evictionIterator", EvictionIterator),
    }

class ConfigUpgradeSetKey(Struct):
    """reference: Stellar-ledger.x ConfigUpgradeSetKey — points at a
    TEMPORARY contract-data entry holding the serialized upgrade set."""
    FIELDS = [("contractID", Hash), ("contentHash", Hash)]


class ConfigUpgradeSet(Struct):
    """reference: Stellar-contract-config-setting.x ConfigUpgradeSet."""
    FIELDS = [("updatedEntry", VarArray(ConfigSettingEntry))]



class LedgerKeyConfigSetting(Struct):
    FIELDS = [("configSettingID", ConfigSettingID)]


# --- Join contract arms into the core LedgerEntry/LedgerKey unions ----------

def register_soroban_ledger_arms() -> None:
    """Extend _LedgerEntryData and LedgerKey with the Soroban arms
    (ledger_entries.py defers these to this layer — SURVEY.md §7 step 8:
    classic first, contracts join the same unions when loaded)."""
    from .ledger_entries import _LedgerEntryData


    data_arms = {
        LedgerEntryType.CONTRACT_DATA: ("contractData", ContractDataEntry),
        LedgerEntryType.CONTRACT_CODE: ("contractCode", ContractCodeEntry),
        LedgerEntryType.CONFIG_SETTING:
            ("configSetting", ConfigSettingEntry),
        LedgerEntryType.TTL: ("ttl", TTLEntry),
    }
    key_arms = {
        LedgerEntryType.CONTRACT_DATA:
            ("contractData", LedgerKeyContractData),
        LedgerEntryType.CONTRACT_CODE:
            ("contractCode", LedgerKeyContractCode),
        LedgerEntryType.CONFIG_SETTING:
            ("configSetting", LedgerKeyConfigSetting),
        LedgerEntryType.TTL: ("ttl", LedgerKeyTtl),
    }
    for disc, (an, at) in data_arms.items():
        if disc not in _LedgerEntryData._ARMS:
            _LedgerEntryData.register_arm(disc, an, at)
    for disc, (an, at) in key_arms.items():
        if disc not in LedgerKey._ARMS:
            LedgerKey.register_arm(disc, an, at)

    if not hasattr(LedgerKey, "contract_data"):
        def contract_data(cls, contract: SCAddress, key: SCVal,
                          durability) -> "LedgerKey":
            return cls(LedgerEntryType.CONTRACT_DATA,
                       LedgerKeyContractData(contract=contract, key=key,
                                             durability=durability))

        def contract_code(cls, wasm_hash: bytes) -> "LedgerKey":
            return cls(LedgerEntryType.CONTRACT_CODE,
                       LedgerKeyContractCode(hash=wasm_hash))

        def ttl(cls, key_hash: bytes) -> "LedgerKey":
            return cls(LedgerEntryType.TTL, LedgerKeyTtl(keyHash=key_hash))

        def config_setting(cls, setting_id) -> "LedgerKey":
            return cls(LedgerEntryType.CONFIG_SETTING,
                       LedgerKeyConfigSetting(configSettingID=setting_id))

        LedgerKey.contract_data = classmethod(contract_data)
        LedgerKey.contract_code = classmethod(contract_code)
        LedgerKey.ttl = classmethod(ttl)
        LedgerKey.config_setting = classmethod(config_setting)


register_soroban_ledger_arms()


def register_soroban_tx_arms() -> None:
    """Extend the operation-body, operation-result, and tx-ext unions
    with the Soroban arms (reference: Stellar-transaction.x protocol 20
    additions)."""

    from .transaction import OperationType, _OperationBody, _TxExt
    from .results import _OperationResultTr

    body_arms = {
        OperationType.INVOKE_HOST_FUNCTION:
            ("invokeHostFunctionOp", InvokeHostFunctionOp),
        OperationType.EXTEND_FOOTPRINT_TTL:
            ("extendFootprintTTLOp", ExtendFootprintTTLOp),
        OperationType.RESTORE_FOOTPRINT:
            ("restoreFootprintOp", RestoreFootprintOp),
    }
    result_arms = {
        OperationType.INVOKE_HOST_FUNCTION:
            ("invokeHostFunctionResult", InvokeHostFunctionResult),
        OperationType.EXTEND_FOOTPRINT_TTL:
            ("extendFootprintTTLResult", ExtendFootprintTTLResult),
        OperationType.RESTORE_FOOTPRINT:
            ("restoreFootprintResult", RestoreFootprintResult),
    }
    for disc, (an, at) in body_arms.items():
        if disc not in _OperationBody._ARMS:
            _OperationBody.register_arm(disc, an, at)
    for disc, (an, at) in result_arms.items():
        if disc not in _OperationResultTr._ARMS:
            _OperationResultTr.register_arm(disc, an, at)
    # Transaction.ext arm 1 = SorobanTransactionData (protocol 20)
    if 1 not in _TxExt._ARMS:
        _TxExt.register_arm(1, "sorobanData", SorobanTransactionData)


register_soroban_tx_arms()
