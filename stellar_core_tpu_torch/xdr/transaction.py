"""Transaction types (reference: Stellar-transaction.x; consumed by
src/transactions/TransactionFrame* and the 24 operation frames).

Classic operations are complete. Soroban op bodies (INVOKE_HOST_FUNCTION,
EXTEND_FOOTPRINT_TTL, RESTORE_FOOTPRINT) arrive with the soroban layer
(SURVEY.md §7 step 8).
"""

from __future__ import annotations

from enum import IntEnum

from .runtime import (
    Array, Bool, Int32, Int64, Opaque, Optional, Struct, Uint32, Uint64,
    Union, VarArray, VarOpaque, XdrString,
)
from .types import (
    AccountID, CryptoKeyType, EnvelopeType, ExtensionPoint, Hash, PublicKey,
    Signature, SignatureHint, SignerKey, Uint256,
)
from .ledger_entries import (
    AlphaNum4, AlphaNum12, Asset, AssetCode, AssetType, ClaimableBalanceID,
    Claimant, LedgerKey, LiquidityPoolConstantProductParameters,
    LiquidityPoolType, OfferEntry, PoolID, Price, Signer, String32, String64,
    DataValue, TrustLineAsset,
)

MAX_OPS_PER_TX = 100
MAX_PATH_LENGTH = 5

class LiquidityPoolParameters(Union):
    SWITCH = LiquidityPoolType
    ARMS = {
        LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT:
            ("constantProduct", LiquidityPoolConstantProductParameters),
    }


_LPParams = LiquidityPoolParameters


class _MuxedAccountMed25519(Struct):
    FIELDS = [("id", Uint64), ("ed25519", Uint256)]


class MuxedAccount(Union):
    SWITCH = CryptoKeyType
    ARMS = {
        CryptoKeyType.KEY_TYPE_ED25519: ("ed25519", Uint256),
        CryptoKeyType.KEY_TYPE_MUXED_ED25519:
            ("med25519", _MuxedAccountMed25519),
    }

    @classmethod
    def from_ed25519(cls, raw: bytes) -> "MuxedAccount":
        return cls(CryptoKeyType.KEY_TYPE_ED25519, raw)

    def account_id(self) -> PublicKey:
        """Strip the mux (reference: transactions/TransactionUtils
        toAccountID). Memoized: the apply path asks ~18x per tx and the
        result is only ever read (entries that embed it clone first)."""
        memo = getattr(self, "_acct_memo", None)
        if memo is None:
            if self.disc == CryptoKeyType.KEY_TYPE_ED25519:
                memo = PublicKey.ed25519(self.value)
            else:
                memo = PublicKey.ed25519(self.value.ed25519)
            self._acct_memo = memo
        return memo


class DecoratedSignature(Struct):
    FIELDS = [("hint", SignatureHint), ("signature", Signature)]


class OperationType(IntEnum):
    CREATE_ACCOUNT = 0
    PAYMENT = 1
    PATH_PAYMENT_STRICT_RECEIVE = 2
    MANAGE_SELL_OFFER = 3
    CREATE_PASSIVE_SELL_OFFER = 4
    SET_OPTIONS = 5
    CHANGE_TRUST = 6
    ALLOW_TRUST = 7
    ACCOUNT_MERGE = 8
    INFLATION = 9
    MANAGE_DATA = 10
    BUMP_SEQUENCE = 11
    MANAGE_BUY_OFFER = 12
    PATH_PAYMENT_STRICT_SEND = 13
    CREATE_CLAIMABLE_BALANCE = 14
    CLAIM_CLAIMABLE_BALANCE = 15
    BEGIN_SPONSORING_FUTURE_RESERVES = 16
    END_SPONSORING_FUTURE_RESERVES = 17
    REVOKE_SPONSORSHIP = 18
    CLAWBACK = 19
    CLAWBACK_CLAIMABLE_BALANCE = 20
    SET_TRUST_LINE_FLAGS = 21
    LIQUIDITY_POOL_DEPOSIT = 22
    LIQUIDITY_POOL_WITHDRAW = 23
    INVOKE_HOST_FUNCTION = 24
    EXTEND_FOOTPRINT_TTL = 25
    RESTORE_FOOTPRINT = 26


class CreateAccountOp(Struct):
    FIELDS = [("destination", AccountID), ("startingBalance", Int64)]


class PaymentOp(Struct):
    FIELDS = [
        ("destination", MuxedAccount),
        ("asset", Asset),
        ("amount", Int64),
    ]


class PathPaymentStrictReceiveOp(Struct):
    FIELDS = [
        ("sendAsset", Asset),
        ("sendMax", Int64),
        ("destination", MuxedAccount),
        ("destAsset", Asset),
        ("destAmount", Int64),
        ("path", VarArray(Asset, MAX_PATH_LENGTH)),
    ]


class PathPaymentStrictSendOp(Struct):
    FIELDS = [
        ("sendAsset", Asset),
        ("sendAmount", Int64),
        ("destination", MuxedAccount),
        ("destAsset", Asset),
        ("destMin", Int64),
        ("path", VarArray(Asset, MAX_PATH_LENGTH)),
    ]


class ManageSellOfferOp(Struct):
    FIELDS = [
        ("selling", Asset),
        ("buying", Asset),
        ("amount", Int64),
        ("price", Price),
        ("offerID", Int64),
    ]


class ManageBuyOfferOp(Struct):
    FIELDS = [
        ("selling", Asset),
        ("buying", Asset),
        ("buyAmount", Int64),
        ("price", Price),
        ("offerID", Int64),
    ]


class CreatePassiveSellOfferOp(Struct):
    FIELDS = [
        ("selling", Asset),
        ("buying", Asset),
        ("amount", Int64),
        ("price", Price),
    ]


class SetOptionsOp(Struct):
    FIELDS = [
        ("inflationDest", Optional(AccountID)),
        ("clearFlags", Optional(Uint32)),
        ("setFlags", Optional(Uint32)),
        ("masterWeight", Optional(Uint32)),
        ("lowThreshold", Optional(Uint32)),
        ("medThreshold", Optional(Uint32)),
        ("highThreshold", Optional(Uint32)),
        ("homeDomain", Optional(String32)),
        ("signer", Optional(Signer)),
    ]


class ChangeTrustAsset(Union):
    SWITCH = AssetType
    ARMS = {
        AssetType.ASSET_TYPE_NATIVE: None,
        AssetType.ASSET_TYPE_CREDIT_ALPHANUM4: ("alphaNum4", AlphaNum4),
        AssetType.ASSET_TYPE_CREDIT_ALPHANUM12: ("alphaNum12", AlphaNum12),
        AssetType.ASSET_TYPE_POOL_SHARE: ("liquidityPool", _LPParams),
    }


class ChangeTrustOp(Struct):
    FIELDS = [("line", ChangeTrustAsset), ("limit", Int64)]


class AllowTrustOp(Struct):
    FIELDS = [
        ("trustor", AccountID),
        ("asset", AssetCode),
        ("authorize", Uint32),
    ]


class ManageDataOp(Struct):
    FIELDS = [("dataName", String64), ("dataValue", Optional(DataValue))]


class BumpSequenceOp(Struct):
    FIELDS = [("bumpTo", Int64)]


class CreateClaimableBalanceOp(Struct):
    FIELDS = [
        ("asset", Asset),
        ("amount", Int64),
        ("claimants", VarArray(Claimant, 10)),
    ]


class ClaimClaimableBalanceOp(Struct):
    FIELDS = [("balanceID", ClaimableBalanceID)]


class BeginSponsoringFutureReservesOp(Struct):
    FIELDS = [("sponsoredID", AccountID)]


class RevokeSponsorshipType(IntEnum):
    REVOKE_SPONSORSHIP_LEDGER_ENTRY = 0
    REVOKE_SPONSORSHIP_SIGNER = 1


class _RevokeSponsorshipSigner(Struct):
    FIELDS = [("accountID", AccountID), ("signerKey", SignerKey)]


class RevokeSponsorshipOp(Union):
    SWITCH = RevokeSponsorshipType
    ARMS = {
        RevokeSponsorshipType.REVOKE_SPONSORSHIP_LEDGER_ENTRY:
            ("ledgerKey", LedgerKey),
        RevokeSponsorshipType.REVOKE_SPONSORSHIP_SIGNER:
            ("signer", _RevokeSponsorshipSigner),
    }


class ClawbackOp(Struct):
    FIELDS = [
        ("asset", Asset),
        ("from_", MuxedAccount),
        ("amount", Int64),
    ]


class ClawbackClaimableBalanceOp(Struct):
    FIELDS = [("balanceID", ClaimableBalanceID)]


class SetTrustLineFlagsOp(Struct):
    FIELDS = [
        ("trustor", AccountID),
        ("asset", Asset),
        ("clearFlags", Uint32),
        ("setFlags", Uint32),
    ]


class LiquidityPoolDepositOp(Struct):
    FIELDS = [
        ("liquidityPoolID", PoolID),
        ("maxAmountA", Int64),
        ("maxAmountB", Int64),
        ("minPrice", Price),
        ("maxPrice", Price),
    ]


class LiquidityPoolWithdrawOp(Struct):
    FIELDS = [
        ("liquidityPoolID", PoolID),
        ("amount", Int64),
        ("minAmountA", Int64),
        ("minAmountB", Int64),
    ]


class _OperationBody(Union):
    SWITCH = OperationType
    ARMS = {
        OperationType.CREATE_ACCOUNT: ("createAccountOp", CreateAccountOp),
        OperationType.PAYMENT: ("paymentOp", PaymentOp),
        OperationType.PATH_PAYMENT_STRICT_RECEIVE:
            ("pathPaymentStrictReceiveOp", PathPaymentStrictReceiveOp),
        OperationType.MANAGE_SELL_OFFER:
            ("manageSellOfferOp", ManageSellOfferOp),
        OperationType.CREATE_PASSIVE_SELL_OFFER:
            ("createPassiveSellOfferOp", CreatePassiveSellOfferOp),
        OperationType.SET_OPTIONS: ("setOptionsOp", SetOptionsOp),
        OperationType.CHANGE_TRUST: ("changeTrustOp", ChangeTrustOp),
        OperationType.ALLOW_TRUST: ("allowTrustOp", AllowTrustOp),
        OperationType.ACCOUNT_MERGE: ("destination", MuxedAccount),
        OperationType.INFLATION: None,
        OperationType.MANAGE_DATA: ("manageDataOp", ManageDataOp),
        OperationType.BUMP_SEQUENCE: ("bumpSequenceOp", BumpSequenceOp),
        OperationType.MANAGE_BUY_OFFER:
            ("manageBuyOfferOp", ManageBuyOfferOp),
        OperationType.PATH_PAYMENT_STRICT_SEND:
            ("pathPaymentStrictSendOp", PathPaymentStrictSendOp),
        OperationType.CREATE_CLAIMABLE_BALANCE:
            ("createClaimableBalanceOp", CreateClaimableBalanceOp),
        OperationType.CLAIM_CLAIMABLE_BALANCE:
            ("claimClaimableBalanceOp", ClaimClaimableBalanceOp),
        OperationType.BEGIN_SPONSORING_FUTURE_RESERVES:
            ("beginSponsoringFutureReservesOp",
             BeginSponsoringFutureReservesOp),
        OperationType.END_SPONSORING_FUTURE_RESERVES: None,
        OperationType.REVOKE_SPONSORSHIP:
            ("revokeSponsorshipOp", RevokeSponsorshipOp),
        OperationType.CLAWBACK: ("clawbackOp", ClawbackOp),
        OperationType.CLAWBACK_CLAIMABLE_BALANCE:
            ("clawbackClaimableBalanceOp", ClawbackClaimableBalanceOp),
        OperationType.SET_TRUST_LINE_FLAGS:
            ("setTrustLineFlagsOp", SetTrustLineFlagsOp),
        OperationType.LIQUIDITY_POOL_DEPOSIT:
            ("liquidityPoolDepositOp", LiquidityPoolDepositOp),
        OperationType.LIQUIDITY_POOL_WITHDRAW:
            ("liquidityPoolWithdrawOp", LiquidityPoolWithdrawOp),
    }


class Operation(Struct):
    FIELDS = [
        ("sourceAccount", Optional(MuxedAccount)),
        ("body", _OperationBody),
    ]


class HashIDPreimageOperationID(Struct):
    FIELDS = [
        ("sourceAccount", AccountID),
        ("seqNum", Int64),
        ("opNum", Uint32),
    ]


class HashIDPreimageRevokeID(Struct):
    FIELDS = [
        ("sourceAccount", AccountID),
        ("seqNum", Int64),
        ("opNum", Uint32),
        ("liquidityPoolID", PoolID),
        ("asset", Asset),
    ]


class HashIDPreimage(Union):
    """Preimages for hash-derived ids (reference: Stellar-transaction.x
    HashIDPreimage; used for claimable-balance ids and pool-revoke ids)."""
    SWITCH = EnvelopeType
    ARMS = {
        EnvelopeType.ENVELOPE_TYPE_OP_ID:
            ("operationID", HashIDPreimageOperationID),
        EnvelopeType.ENVELOPE_TYPE_POOL_REVOKE_OP_ID:
            ("revokeID", HashIDPreimageRevokeID),
    }


class MemoType(IntEnum):
    MEMO_NONE = 0
    MEMO_TEXT = 1
    MEMO_ID = 2
    MEMO_HASH = 3
    MEMO_RETURN = 4


class Memo(Union):
    SWITCH = MemoType
    ARMS = {
        MemoType.MEMO_NONE: None,
        MemoType.MEMO_TEXT: ("text", XdrString(28)),
        MemoType.MEMO_ID: ("id", Uint64),
        MemoType.MEMO_HASH: ("hash", Hash),
        MemoType.MEMO_RETURN: ("retHash", Hash),
    }


class TimeBounds(Struct):
    FIELDS = [("minTime", Uint64), ("maxTime", Uint64)]


class LedgerBounds(Struct):
    FIELDS = [("minLedger", Uint32), ("maxLedger", Uint32)]


class PreconditionsV2(Struct):
    FIELDS = [
        ("timeBounds", Optional(TimeBounds)),
        ("ledgerBounds", Optional(LedgerBounds)),
        ("minSeqNum", Optional(Int64)),
        ("minSeqAge", Uint64),
        ("minSeqLedgerGap", Uint32),
        ("extraSigners", VarArray(SignerKey, 2)),
    ]


class PreconditionType(IntEnum):
    PRECOND_NONE = 0
    PRECOND_TIME = 1
    PRECOND_V2 = 2


class Preconditions(Union):
    SWITCH = PreconditionType
    ARMS = {
        PreconditionType.PRECOND_NONE: None,
        PreconditionType.PRECOND_TIME: ("timeBounds", TimeBounds),
        PreconditionType.PRECOND_V2: ("v2", PreconditionsV2),
    }


class _TxExt(Union):
    SWITCH = Int32
    ARMS = {0: None}


class Transaction(Struct):
    FIELDS = [
        ("sourceAccount", MuxedAccount),
        ("fee", Uint32),
        ("seqNum", Int64),
        ("cond", Preconditions),
        ("memo", Memo),
        ("operations", VarArray(Operation, MAX_OPS_PER_TX)),
        ("ext", _TxExt),
    ]


class TransactionV0(Struct):
    """Legacy pre-protocol-13 envelope body (reference: Stellar-transaction.x
    TransactionV0; still accepted on the wire, hashed as ENVELOPE_TYPE_TX with
    upgraded source account)."""
    FIELDS = [
        ("sourceAccountEd25519", Uint256),
        ("fee", Uint32),
        ("seqNum", Int64),
        ("timeBounds", Optional(TimeBounds)),
        ("memo", Memo),
        ("operations", VarArray(Operation, MAX_OPS_PER_TX)),
        ("ext", _TxExt),
    ]


class TransactionV0Envelope(Struct):
    FIELDS = [
        ("tx", TransactionV0),
        ("signatures", VarArray(DecoratedSignature, 20)),
    ]


class TransactionV1Envelope(Struct):
    FIELDS = [
        ("tx", Transaction),
        ("signatures", VarArray(DecoratedSignature, 20)),
    ]


class _FeeBumpInnerTx(Union):
    SWITCH = EnvelopeType
    ARMS = {EnvelopeType.ENVELOPE_TYPE_TX: ("v1", TransactionV1Envelope)}


class FeeBumpTransaction(Struct):
    FIELDS = [
        ("feeSource", MuxedAccount),
        ("fee", Int64),
        ("innerTx", _FeeBumpInnerTx),
        ("ext", _TxExt),
    ]


class FeeBumpTransactionEnvelope(Struct):
    FIELDS = [
        ("tx", FeeBumpTransaction),
        ("signatures", VarArray(DecoratedSignature, 20)),
    ]


class TransactionEnvelope(Union):
    SWITCH = EnvelopeType
    ARMS = {
        EnvelopeType.ENVELOPE_TYPE_TX_V0: ("v0", TransactionV0Envelope),
        EnvelopeType.ENVELOPE_TYPE_TX: ("v1", TransactionV1Envelope),
        EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP:
            ("feeBump", FeeBumpTransactionEnvelope),
    }


class _TaggedTransaction(Union):
    SWITCH = EnvelopeType
    ARMS = {
        EnvelopeType.ENVELOPE_TYPE_TX: ("tx", Transaction),
        EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP:
            ("feeBump", FeeBumpTransaction),
    }


class TransactionSignaturePayload(Struct):
    """The signed bytes: SHA256(networkId ‖ taggedTransaction) is what
    DecoratedSignatures sign (reference:
    transactions/TransactionFrame.cpp:99-107)."""
    FIELDS = [
        ("networkId", Hash),
        ("taggedTransaction", _TaggedTransaction),
    ]
