"""Operation and transaction result types (reference: Stellar-transaction.x
result section; produced by src/transactions/*OpFrame::doApply and consumed by
history's TransactionHistoryResultEntry)."""

from __future__ import annotations

from enum import IntEnum

from .runtime import (
    Int32, Int64, Struct, Uint32, Uint64, Union, VarArray,
)
from .types import AccountID, ExtensionPoint, Hash, Uint256
from .ledger_entries import (
    Asset, ClaimableBalanceID, OfferEntry, PoolID,
)
from .transaction import OperationType


class ClaimAtomType(IntEnum):
    CLAIM_ATOM_TYPE_V0 = 0
    CLAIM_ATOM_TYPE_ORDER_BOOK = 1
    CLAIM_ATOM_TYPE_LIQUIDITY_POOL = 2


class ClaimOfferAtomV0(Struct):
    FIELDS = [
        ("sellerEd25519", Uint256),
        ("offerID", Int64),
        ("assetSold", Asset),
        ("amountSold", Int64),
        ("assetBought", Asset),
        ("amountBought", Int64),
    ]


class ClaimOfferAtom(Struct):
    FIELDS = [
        ("sellerID", AccountID),
        ("offerID", Int64),
        ("assetSold", Asset),
        ("amountSold", Int64),
        ("assetBought", Asset),
        ("amountBought", Int64),
    ]


class ClaimLiquidityAtom(Struct):
    FIELDS = [
        ("liquidityPoolID", PoolID),
        ("assetSold", Asset),
        ("amountSold", Int64),
        ("assetBought", Asset),
        ("amountBought", Int64),
    ]


class ClaimAtom(Union):
    SWITCH = ClaimAtomType
    ARMS = {
        ClaimAtomType.CLAIM_ATOM_TYPE_V0: ("v0", ClaimOfferAtomV0),
        ClaimAtomType.CLAIM_ATOM_TYPE_ORDER_BOOK:
            ("orderBook", ClaimOfferAtom),
        ClaimAtomType.CLAIM_ATOM_TYPE_LIQUIDITY_POOL:
            ("liquidityPool", ClaimLiquidityAtom),
    }


# --- per-operation result codes -------------------------------------------

class CreateAccountResultCode(IntEnum):
    CREATE_ACCOUNT_SUCCESS = 0
    CREATE_ACCOUNT_MALFORMED = -1
    CREATE_ACCOUNT_UNDERFUNDED = -2
    CREATE_ACCOUNT_LOW_RESERVE = -3
    CREATE_ACCOUNT_ALREADY_EXIST = -4


class CreateAccountResult(Union):
    SWITCH = CreateAccountResultCode
    ARMS = {CreateAccountResultCode.CREATE_ACCOUNT_SUCCESS: None}
    DEFAULT_ARM = None


class PaymentResultCode(IntEnum):
    PAYMENT_SUCCESS = 0
    PAYMENT_MALFORMED = -1
    PAYMENT_UNDERFUNDED = -2
    PAYMENT_SRC_NO_TRUST = -3
    PAYMENT_SRC_NOT_AUTHORIZED = -4
    PAYMENT_NO_DESTINATION = -5
    PAYMENT_NO_TRUST = -6
    PAYMENT_NOT_AUTHORIZED = -7
    PAYMENT_LINE_FULL = -8
    PAYMENT_NO_ISSUER = -9


class PaymentResult(Union):
    SWITCH = PaymentResultCode
    ARMS = {PaymentResultCode.PAYMENT_SUCCESS: None}
    DEFAULT_ARM = None


class SimplePaymentResult(Struct):
    FIELDS = [
        ("destination", AccountID),
        ("asset", Asset),
        ("amount", Int64),
    ]


class PathPaymentStrictReceiveResultCode(IntEnum):
    PATH_PAYMENT_STRICT_RECEIVE_SUCCESS = 0
    PATH_PAYMENT_STRICT_RECEIVE_MALFORMED = -1
    PATH_PAYMENT_STRICT_RECEIVE_UNDERFUNDED = -2
    PATH_PAYMENT_STRICT_RECEIVE_SRC_NO_TRUST = -3
    PATH_PAYMENT_STRICT_RECEIVE_SRC_NOT_AUTHORIZED = -4
    PATH_PAYMENT_STRICT_RECEIVE_NO_DESTINATION = -5
    PATH_PAYMENT_STRICT_RECEIVE_NO_TRUST = -6
    PATH_PAYMENT_STRICT_RECEIVE_NOT_AUTHORIZED = -7
    PATH_PAYMENT_STRICT_RECEIVE_LINE_FULL = -8
    PATH_PAYMENT_STRICT_RECEIVE_NO_ISSUER = -9
    PATH_PAYMENT_STRICT_RECEIVE_TOO_FEW_OFFERS = -10
    PATH_PAYMENT_STRICT_RECEIVE_OFFER_CROSS_SELF = -11
    PATH_PAYMENT_STRICT_RECEIVE_OVER_SENDMAX = -12


class _PathPaymentStrictReceiveSuccess(Struct):
    FIELDS = [
        ("offers", VarArray(ClaimAtom)),
        ("last", SimplePaymentResult),
    ]


class PathPaymentStrictReceiveResult(Union):
    SWITCH = PathPaymentStrictReceiveResultCode
    ARMS = {
        PathPaymentStrictReceiveResultCode.PATH_PAYMENT_STRICT_RECEIVE_SUCCESS:
            ("success", _PathPaymentStrictReceiveSuccess),
        PathPaymentStrictReceiveResultCode.PATH_PAYMENT_STRICT_RECEIVE_NO_ISSUER:
            ("noIssuer", Asset),
    }
    DEFAULT_ARM = None


class PathPaymentStrictSendResultCode(IntEnum):
    PATH_PAYMENT_STRICT_SEND_SUCCESS = 0
    PATH_PAYMENT_STRICT_SEND_MALFORMED = -1
    PATH_PAYMENT_STRICT_SEND_UNDERFUNDED = -2
    PATH_PAYMENT_STRICT_SEND_SRC_NO_TRUST = -3
    PATH_PAYMENT_STRICT_SEND_SRC_NOT_AUTHORIZED = -4
    PATH_PAYMENT_STRICT_SEND_NO_DESTINATION = -5
    PATH_PAYMENT_STRICT_SEND_NO_TRUST = -6
    PATH_PAYMENT_STRICT_SEND_NOT_AUTHORIZED = -7
    PATH_PAYMENT_STRICT_SEND_LINE_FULL = -8
    PATH_PAYMENT_STRICT_SEND_NO_ISSUER = -9
    PATH_PAYMENT_STRICT_SEND_TOO_FEW_OFFERS = -10
    PATH_PAYMENT_STRICT_SEND_OFFER_CROSS_SELF = -11
    PATH_PAYMENT_STRICT_SEND_UNDER_DESTMIN = -12


class _PathPaymentStrictSendSuccess(Struct):
    FIELDS = [
        ("offers", VarArray(ClaimAtom)),
        ("last", SimplePaymentResult),
    ]


class PathPaymentStrictSendResult(Union):
    SWITCH = PathPaymentStrictSendResultCode
    ARMS = {
        PathPaymentStrictSendResultCode.PATH_PAYMENT_STRICT_SEND_SUCCESS:
            ("success", _PathPaymentStrictSendSuccess),
        PathPaymentStrictSendResultCode.PATH_PAYMENT_STRICT_SEND_NO_ISSUER:
            ("noIssuer", Asset),
    }
    DEFAULT_ARM = None


class ManageSellOfferResultCode(IntEnum):
    MANAGE_SELL_OFFER_SUCCESS = 0
    MANAGE_SELL_OFFER_MALFORMED = -1
    MANAGE_SELL_OFFER_SELL_NO_TRUST = -2
    MANAGE_SELL_OFFER_BUY_NO_TRUST = -3
    MANAGE_SELL_OFFER_SELL_NOT_AUTHORIZED = -4
    MANAGE_SELL_OFFER_BUY_NOT_AUTHORIZED = -5
    MANAGE_SELL_OFFER_LINE_FULL = -6
    MANAGE_SELL_OFFER_UNDERFUNDED = -7
    MANAGE_SELL_OFFER_CROSS_SELF = -8
    MANAGE_SELL_OFFER_SELL_NO_ISSUER = -9
    MANAGE_SELL_OFFER_BUY_NO_ISSUER = -10
    MANAGE_SELL_OFFER_NOT_FOUND = -11
    MANAGE_SELL_OFFER_LOW_RESERVE = -12


class ManageOfferEffect(IntEnum):
    MANAGE_OFFER_CREATED = 0
    MANAGE_OFFER_UPDATED = 1
    MANAGE_OFFER_DELETED = 2


class _ManageOfferEffectUnion(Union):
    SWITCH = ManageOfferEffect
    ARMS = {
        ManageOfferEffect.MANAGE_OFFER_CREATED: ("offer", OfferEntry),
        ManageOfferEffect.MANAGE_OFFER_UPDATED: ("offer", OfferEntry),
    }
    DEFAULT_ARM = None


class ManageOfferSuccessResult(Struct):
    FIELDS = [
        ("offersClaimed", VarArray(ClaimAtom)),
        ("offer", _ManageOfferEffectUnion),
    ]


class ManageSellOfferResult(Union):
    SWITCH = ManageSellOfferResultCode
    ARMS = {
        ManageSellOfferResultCode.MANAGE_SELL_OFFER_SUCCESS:
            ("success", ManageOfferSuccessResult),
    }
    DEFAULT_ARM = None


class ManageBuyOfferResultCode(IntEnum):
    MANAGE_BUY_OFFER_SUCCESS = 0
    MANAGE_BUY_OFFER_MALFORMED = -1
    MANAGE_BUY_OFFER_SELL_NO_TRUST = -2
    MANAGE_BUY_OFFER_BUY_NO_TRUST = -3
    MANAGE_BUY_OFFER_SELL_NOT_AUTHORIZED = -4
    MANAGE_BUY_OFFER_BUY_NOT_AUTHORIZED = -5
    MANAGE_BUY_OFFER_LINE_FULL = -6
    MANAGE_BUY_OFFER_UNDERFUNDED = -7
    MANAGE_BUY_OFFER_CROSS_SELF = -8
    MANAGE_BUY_OFFER_SELL_NO_ISSUER = -9
    MANAGE_BUY_OFFER_BUY_NO_ISSUER = -10
    MANAGE_BUY_OFFER_NOT_FOUND = -11
    MANAGE_BUY_OFFER_LOW_RESERVE = -12


class ManageBuyOfferResult(Union):
    SWITCH = ManageBuyOfferResultCode
    ARMS = {
        ManageBuyOfferResultCode.MANAGE_BUY_OFFER_SUCCESS:
            ("success", ManageOfferSuccessResult),
    }
    DEFAULT_ARM = None


class SetOptionsResultCode(IntEnum):
    SET_OPTIONS_SUCCESS = 0
    SET_OPTIONS_LOW_RESERVE = -1
    SET_OPTIONS_TOO_MANY_SIGNERS = -2
    SET_OPTIONS_BAD_FLAGS = -3
    SET_OPTIONS_INVALID_INFLATION = -4
    SET_OPTIONS_CANT_CHANGE = -5
    SET_OPTIONS_UNKNOWN_FLAG = -6
    SET_OPTIONS_THRESHOLD_OUT_OF_RANGE = -7
    SET_OPTIONS_BAD_SIGNER = -8
    SET_OPTIONS_INVALID_HOME_DOMAIN = -9
    SET_OPTIONS_AUTH_REVOCABLE_REQUIRED = -10


class SetOptionsResult(Union):
    SWITCH = SetOptionsResultCode
    ARMS = {SetOptionsResultCode.SET_OPTIONS_SUCCESS: None}
    DEFAULT_ARM = None


class ChangeTrustResultCode(IntEnum):
    CHANGE_TRUST_SUCCESS = 0
    CHANGE_TRUST_MALFORMED = -1
    CHANGE_TRUST_NO_ISSUER = -2
    CHANGE_TRUST_INVALID_LIMIT = -3
    CHANGE_TRUST_LOW_RESERVE = -4
    CHANGE_TRUST_SELF_NOT_ALLOWED = -5
    CHANGE_TRUST_TRUST_LINE_MISSING = -6
    CHANGE_TRUST_CANNOT_DELETE = -7
    CHANGE_TRUST_NOT_AUTH_MAINTAIN_LIABILITIES = -8


class ChangeTrustResult(Union):
    SWITCH = ChangeTrustResultCode
    ARMS = {ChangeTrustResultCode.CHANGE_TRUST_SUCCESS: None}
    DEFAULT_ARM = None


class AllowTrustResultCode(IntEnum):
    ALLOW_TRUST_SUCCESS = 0
    ALLOW_TRUST_MALFORMED = -1
    ALLOW_TRUST_NO_TRUST_LINE = -2
    ALLOW_TRUST_TRUST_NOT_REQUIRED = -3
    ALLOW_TRUST_CANT_REVOKE = -4
    ALLOW_TRUST_SELF_NOT_ALLOWED = -5
    ALLOW_TRUST_LOW_RESERVE = -6


class AllowTrustResult(Union):
    SWITCH = AllowTrustResultCode
    ARMS = {AllowTrustResultCode.ALLOW_TRUST_SUCCESS: None}
    DEFAULT_ARM = None


class AccountMergeResultCode(IntEnum):
    ACCOUNT_MERGE_SUCCESS = 0
    ACCOUNT_MERGE_MALFORMED = -1
    ACCOUNT_MERGE_NO_ACCOUNT = -2
    ACCOUNT_MERGE_IMMUTABLE_SET = -3
    ACCOUNT_MERGE_HAS_SUB_ENTRIES = -4
    ACCOUNT_MERGE_SEQNUM_TOO_FAR = -5
    ACCOUNT_MERGE_DEST_FULL = -6
    ACCOUNT_MERGE_IS_SPONSOR = -7


class AccountMergeResult(Union):
    SWITCH = AccountMergeResultCode
    ARMS = {
        AccountMergeResultCode.ACCOUNT_MERGE_SUCCESS:
            ("sourceAccountBalance", Int64),
    }
    DEFAULT_ARM = None


class InflationResultCode(IntEnum):
    INFLATION_SUCCESS = 0
    INFLATION_NOT_TIME = -1


class InflationPayout(Struct):
    FIELDS = [("destination", AccountID), ("amount", Int64)]


class InflationResult(Union):
    SWITCH = InflationResultCode
    ARMS = {
        InflationResultCode.INFLATION_SUCCESS:
            ("payouts", VarArray(InflationPayout)),
    }
    DEFAULT_ARM = None


class ManageDataResultCode(IntEnum):
    MANAGE_DATA_SUCCESS = 0
    MANAGE_DATA_NOT_SUPPORTED_YET = -1
    MANAGE_DATA_NAME_NOT_FOUND = -2
    MANAGE_DATA_LOW_RESERVE = -3
    MANAGE_DATA_INVALID_NAME = -4


class ManageDataResult(Union):
    SWITCH = ManageDataResultCode
    ARMS = {ManageDataResultCode.MANAGE_DATA_SUCCESS: None}
    DEFAULT_ARM = None


class BumpSequenceResultCode(IntEnum):
    BUMP_SEQUENCE_SUCCESS = 0
    BUMP_SEQUENCE_BAD_SEQ = -1


class BumpSequenceResult(Union):
    SWITCH = BumpSequenceResultCode
    ARMS = {BumpSequenceResultCode.BUMP_SEQUENCE_SUCCESS: None}
    DEFAULT_ARM = None


class CreateClaimableBalanceResultCode(IntEnum):
    CREATE_CLAIMABLE_BALANCE_SUCCESS = 0
    CREATE_CLAIMABLE_BALANCE_MALFORMED = -1
    CREATE_CLAIMABLE_BALANCE_LOW_RESERVE = -2
    CREATE_CLAIMABLE_BALANCE_NO_TRUST = -3
    CREATE_CLAIMABLE_BALANCE_NOT_AUTHORIZED = -4
    CREATE_CLAIMABLE_BALANCE_UNDERFUNDED = -5


class CreateClaimableBalanceResult(Union):
    SWITCH = CreateClaimableBalanceResultCode
    ARMS = {
        CreateClaimableBalanceResultCode.CREATE_CLAIMABLE_BALANCE_SUCCESS:
            ("balanceID", ClaimableBalanceID),
    }
    DEFAULT_ARM = None


class ClaimClaimableBalanceResultCode(IntEnum):
    CLAIM_CLAIMABLE_BALANCE_SUCCESS = 0
    CLAIM_CLAIMABLE_BALANCE_DOES_NOT_EXIST = -1
    CLAIM_CLAIMABLE_BALANCE_CANNOT_CLAIM = -2
    CLAIM_CLAIMABLE_BALANCE_LINE_FULL = -3
    CLAIM_CLAIMABLE_BALANCE_NO_TRUST = -4
    CLAIM_CLAIMABLE_BALANCE_NOT_AUTHORIZED = -5


class ClaimClaimableBalanceResult(Union):
    SWITCH = ClaimClaimableBalanceResultCode
    ARMS = {
        ClaimClaimableBalanceResultCode.CLAIM_CLAIMABLE_BALANCE_SUCCESS: None,
    }
    DEFAULT_ARM = None


class BeginSponsoringFutureReservesResultCode(IntEnum):
    BEGIN_SPONSORING_FUTURE_RESERVES_SUCCESS = 0
    BEGIN_SPONSORING_FUTURE_RESERVES_MALFORMED = -1
    BEGIN_SPONSORING_FUTURE_RESERVES_ALREADY_SPONSORED = -2
    BEGIN_SPONSORING_FUTURE_RESERVES_RECURSIVE = -3


class BeginSponsoringFutureReservesResult(Union):
    SWITCH = BeginSponsoringFutureReservesResultCode
    ARMS = {
        BeginSponsoringFutureReservesResultCode
        .BEGIN_SPONSORING_FUTURE_RESERVES_SUCCESS: None,
    }
    DEFAULT_ARM = None


class EndSponsoringFutureReservesResultCode(IntEnum):
    END_SPONSORING_FUTURE_RESERVES_SUCCESS = 0
    END_SPONSORING_FUTURE_RESERVES_NOT_SPONSORED = -1


class EndSponsoringFutureReservesResult(Union):
    SWITCH = EndSponsoringFutureReservesResultCode
    ARMS = {
        EndSponsoringFutureReservesResultCode
        .END_SPONSORING_FUTURE_RESERVES_SUCCESS: None,
    }
    DEFAULT_ARM = None


class RevokeSponsorshipResultCode(IntEnum):
    REVOKE_SPONSORSHIP_SUCCESS = 0
    REVOKE_SPONSORSHIP_DOES_NOT_EXIST = -1
    REVOKE_SPONSORSHIP_NOT_SPONSOR = -2
    REVOKE_SPONSORSHIP_LOW_RESERVE = -3
    REVOKE_SPONSORSHIP_ONLY_TRANSFERABLE = -4
    REVOKE_SPONSORSHIP_MALFORMED = -5


class RevokeSponsorshipResult(Union):
    SWITCH = RevokeSponsorshipResultCode
    ARMS = {RevokeSponsorshipResultCode.REVOKE_SPONSORSHIP_SUCCESS: None}
    DEFAULT_ARM = None


class ClawbackResultCode(IntEnum):
    CLAWBACK_SUCCESS = 0
    CLAWBACK_MALFORMED = -1
    CLAWBACK_NOT_CLAWBACK_ENABLED = -2
    CLAWBACK_NO_TRUST = -3
    CLAWBACK_UNDERFUNDED = -4


class ClawbackResult(Union):
    SWITCH = ClawbackResultCode
    ARMS = {ClawbackResultCode.CLAWBACK_SUCCESS: None}
    DEFAULT_ARM = None


class ClawbackClaimableBalanceResultCode(IntEnum):
    CLAWBACK_CLAIMABLE_BALANCE_SUCCESS = 0
    CLAWBACK_CLAIMABLE_BALANCE_DOES_NOT_EXIST = -1
    CLAWBACK_CLAIMABLE_BALANCE_NOT_ISSUER = -2
    CLAWBACK_CLAIMABLE_BALANCE_NOT_CLAWBACK_ENABLED = -3


class ClawbackClaimableBalanceResult(Union):
    SWITCH = ClawbackClaimableBalanceResultCode
    ARMS = {
        ClawbackClaimableBalanceResultCode
        .CLAWBACK_CLAIMABLE_BALANCE_SUCCESS: None,
    }
    DEFAULT_ARM = None


class SetTrustLineFlagsResultCode(IntEnum):
    SET_TRUST_LINE_FLAGS_SUCCESS = 0
    SET_TRUST_LINE_FLAGS_MALFORMED = -1
    SET_TRUST_LINE_FLAGS_NO_TRUST_LINE = -2
    SET_TRUST_LINE_FLAGS_CANT_REVOKE = -3
    SET_TRUST_LINE_FLAGS_INVALID_STATE = -4
    SET_TRUST_LINE_FLAGS_LOW_RESERVE = -5


class SetTrustLineFlagsResult(Union):
    SWITCH = SetTrustLineFlagsResultCode
    ARMS = {SetTrustLineFlagsResultCode.SET_TRUST_LINE_FLAGS_SUCCESS: None}
    DEFAULT_ARM = None


class LiquidityPoolDepositResultCode(IntEnum):
    LIQUIDITY_POOL_DEPOSIT_SUCCESS = 0
    LIQUIDITY_POOL_DEPOSIT_MALFORMED = -1
    LIQUIDITY_POOL_DEPOSIT_NO_TRUST = -2
    LIQUIDITY_POOL_DEPOSIT_NOT_AUTHORIZED = -3
    LIQUIDITY_POOL_DEPOSIT_UNDERFUNDED = -4
    LIQUIDITY_POOL_DEPOSIT_LINE_FULL = -5
    LIQUIDITY_POOL_DEPOSIT_BAD_PRICE = -6
    LIQUIDITY_POOL_DEPOSIT_POOL_FULL = -7


class LiquidityPoolDepositResult(Union):
    SWITCH = LiquidityPoolDepositResultCode
    ARMS = {
        LiquidityPoolDepositResultCode.LIQUIDITY_POOL_DEPOSIT_SUCCESS: None,
    }
    DEFAULT_ARM = None


class LiquidityPoolWithdrawResultCode(IntEnum):
    LIQUIDITY_POOL_WITHDRAW_SUCCESS = 0
    LIQUIDITY_POOL_WITHDRAW_MALFORMED = -1
    LIQUIDITY_POOL_WITHDRAW_NO_TRUST = -2
    LIQUIDITY_POOL_WITHDRAW_UNDERFUNDED = -3
    LIQUIDITY_POOL_WITHDRAW_LINE_FULL = -4
    LIQUIDITY_POOL_WITHDRAW_UNDER_MINIMUM = -5


class LiquidityPoolWithdrawResult(Union):
    SWITCH = LiquidityPoolWithdrawResultCode
    ARMS = {
        LiquidityPoolWithdrawResultCode.LIQUIDITY_POOL_WITHDRAW_SUCCESS: None,
    }
    DEFAULT_ARM = None


# --- OperationResult -------------------------------------------------------

class OperationResultCode(IntEnum):
    opINNER = 0
    opBAD_AUTH = -1
    opNO_ACCOUNT = -2
    opNOT_SUPPORTED = -3
    opTOO_MANY_SUBENTRIES = -4
    opEXCEEDED_WORK_LIMIT = -5
    opTOO_MANY_SPONSORING = -6


class _OperationResultTr(Union):
    SWITCH = OperationType
    ARMS = {
        OperationType.CREATE_ACCOUNT:
            ("createAccountResult", CreateAccountResult),
        OperationType.PAYMENT: ("paymentResult", PaymentResult),
        OperationType.PATH_PAYMENT_STRICT_RECEIVE:
            ("pathPaymentStrictReceiveResult", PathPaymentStrictReceiveResult),
        OperationType.MANAGE_SELL_OFFER:
            ("manageSellOfferResult", ManageSellOfferResult),
        OperationType.CREATE_PASSIVE_SELL_OFFER:
            ("createPassiveSellOfferResult", ManageSellOfferResult),
        OperationType.SET_OPTIONS: ("setOptionsResult", SetOptionsResult),
        OperationType.CHANGE_TRUST: ("changeTrustResult", ChangeTrustResult),
        OperationType.ALLOW_TRUST: ("allowTrustResult", AllowTrustResult),
        OperationType.ACCOUNT_MERGE:
            ("accountMergeResult", AccountMergeResult),
        OperationType.INFLATION: ("inflationResult", InflationResult),
        OperationType.MANAGE_DATA: ("manageDataResult", ManageDataResult),
        OperationType.BUMP_SEQUENCE:
            ("bumpSeqResult", BumpSequenceResult),
        OperationType.MANAGE_BUY_OFFER:
            ("manageBuyOfferResult", ManageBuyOfferResult),
        OperationType.PATH_PAYMENT_STRICT_SEND:
            ("pathPaymentStrictSendResult", PathPaymentStrictSendResult),
        OperationType.CREATE_CLAIMABLE_BALANCE:
            ("createClaimableBalanceResult", CreateClaimableBalanceResult),
        OperationType.CLAIM_CLAIMABLE_BALANCE:
            ("claimClaimableBalanceResult", ClaimClaimableBalanceResult),
        OperationType.BEGIN_SPONSORING_FUTURE_RESERVES:
            ("beginSponsoringFutureReservesResult",
             BeginSponsoringFutureReservesResult),
        OperationType.END_SPONSORING_FUTURE_RESERVES:
            ("endSponsoringFutureReservesResult",
             EndSponsoringFutureReservesResult),
        OperationType.REVOKE_SPONSORSHIP:
            ("revokeSponsorshipResult", RevokeSponsorshipResult),
        OperationType.CLAWBACK: ("clawbackResult", ClawbackResult),
        OperationType.CLAWBACK_CLAIMABLE_BALANCE:
            ("clawbackClaimableBalanceResult", ClawbackClaimableBalanceResult),
        OperationType.SET_TRUST_LINE_FLAGS:
            ("setTrustLineFlagsResult", SetTrustLineFlagsResult),
        OperationType.LIQUIDITY_POOL_DEPOSIT:
            ("liquidityPoolDepositResult", LiquidityPoolDepositResult),
        OperationType.LIQUIDITY_POOL_WITHDRAW:
            ("liquidityPoolWithdrawResult", LiquidityPoolWithdrawResult),
    }


class OperationResult(Union):
    SWITCH = OperationResultCode
    ARMS = {OperationResultCode.opINNER: ("tr", _OperationResultTr)}
    DEFAULT_ARM = None


# --- TransactionResult -----------------------------------------------------

class TransactionResultCode(IntEnum):
    txFEE_BUMP_INNER_SUCCESS = 1
    txSUCCESS = 0
    txFAILED = -1
    txTOO_EARLY = -2
    txTOO_LATE = -3
    txMISSING_OPERATION = -4
    txBAD_SEQ = -5
    txBAD_AUTH = -6
    txINSUFFICIENT_BALANCE = -7
    txNO_ACCOUNT = -8
    txINSUFFICIENT_FEE = -9
    txBAD_AUTH_EXTRA = -10
    txINTERNAL_ERROR = -11
    txNOT_SUPPORTED = -12
    txFEE_BUMP_INNER_FAILED = -13
    txBAD_SPONSORSHIP = -14
    txBAD_MIN_SEQ_AGE_OR_GAP = -15
    txMALFORMED = -16
    txSOROBAN_INVALID = -17


class _InnerTxResultResult(Union):
    # The reference XDR enumerates every non-fee-bump code and has no
    # default, so txFEE_BUMP_INNER_SUCCESS/FAILED must fail strict decode
    # inside an inner result (Stellar-transaction.x InnerTransactionResult).
    SWITCH = TransactionResultCode
    ARMS = {
        TransactionResultCode.txSUCCESS:
            ("results", VarArray(OperationResult)),
        TransactionResultCode.txFAILED:
            ("results", VarArray(OperationResult)),
        **{code: None for code in TransactionResultCode
           if code not in (TransactionResultCode.txSUCCESS,
                           TransactionResultCode.txFAILED,
                           TransactionResultCode.txFEE_BUMP_INNER_SUCCESS,
                           TransactionResultCode.txFEE_BUMP_INNER_FAILED)},
    }


class InnerTransactionResult(Struct):
    FIELDS = [
        ("feeCharged", Int64),
        ("result", _InnerTxResultResult),
        ("ext", ExtensionPoint),
    ]


class InnerTransactionResultPair(Struct):
    FIELDS = [
        ("transactionHash", Hash),
        ("result", InnerTransactionResult),
    ]


class _TxResultResult(Union):
    SWITCH = TransactionResultCode
    ARMS = {
        TransactionResultCode.txFEE_BUMP_INNER_SUCCESS:
            ("innerResultPair", InnerTransactionResultPair),
        TransactionResultCode.txFEE_BUMP_INNER_FAILED:
            ("innerResultPair", InnerTransactionResultPair),
        TransactionResultCode.txSUCCESS:
            ("results", VarArray(OperationResult)),
        TransactionResultCode.txFAILED:
            ("results", VarArray(OperationResult)),
    }
    DEFAULT_ARM = None


class TransactionResult(Struct):
    FIELDS = [
        ("feeCharged", Int64),
        ("result", _TxResultResult),
        ("ext", ExtensionPoint),
    ]


class TransactionResultPair(Struct):
    FIELDS = [("transactionHash", Hash), ("result", TransactionResult)]


class TransactionResultSet(Struct):
    FIELDS = [("results", VarArray(TransactionResultPair))]
