"""Operation frame base and registry.

Reference: transactions/OperationFrame.{h,cpp} — one frame per
OperationType, each with `doCheckValid` (stateless validity),
`doApply` (ledger mutation inside the op's own LedgerTxn), a threshold
level (LOW/MEDIUM/HIGH, OperationFrame.cpp:167-169 default MEDIUM), and
shared signature/account plumbing: the op's source (op override or tx
source), opNO_ACCOUNT when the source vanished, opBAD_AUTH when the
source account's signers don't reach the needed threshold.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Callable, Dict, Optional, Type

from ..util.checks import releaseAssert
from ..xdr.ledger_entries import LedgerKey, ThresholdIndexes
from ..xdr.transaction import MuxedAccount, Operation, OperationType
from ..xdr.results import OperationResult, OperationResultCode, \
    _OperationResultTr
from ..xdr.types import AccountID
from . import tx_utils
from .signature_checker import SignatureChecker
from .sponsorship import ApplyContext


class ThresholdLevel(IntEnum):
    LOW = 0
    MEDIUM = 1
    HIGH = 2


_THRESHOLD_INDEX = {
    ThresholdLevel.LOW: ThresholdIndexes.THRESHOLD_LOW,
    ThresholdLevel.MEDIUM: ThresholdIndexes.THRESHOLD_MED,
    ThresholdLevel.HIGH: ThresholdIndexes.THRESHOLD_HIGH,
}

_REGISTRY: Dict[OperationType, Type["OperationFrame"]] = {}


def register_op(op_type: OperationType):
    def deco(cls):
        cls.OP_TYPE = op_type
        _REGISTRY[op_type] = cls
        return cls
    return deco


def make_operation_frame(op: Operation, tx_source: MuxedAccount,
                         op_index: int) -> "OperationFrame":
    cls = _REGISTRY.get(op.body.disc)
    releaseAssert(cls is not None,
                  f"no operation frame registered for {op.body.disc!r}")
    return cls(op, tx_source, op_index)


class OperationFrame:
    OP_TYPE: OperationType = None

    def __init__(self, op: Operation, tx_source: MuxedAccount,
                 op_index: int):
        self.op = op
        self.tx_source = tx_source
        self.op_index = op_index
        self.result: Optional[OperationResult] = None

    # ----------------------------------------------------------- identities --
    @property
    def source(self) -> MuxedAccount:
        return self.op.sourceAccount if self.op.sourceAccount is not None \
            else self.tx_source

    @property
    def source_id(self) -> AccountID:
        return self.source.account_id()

    @property
    def body(self):
        return self.op.body.value

    # -------------------------------------------------------------- results --
    def _inner_result_type(self):
        arm = _OperationResultTr.ARMS[self.OP_TYPE]
        return arm[1] if arm else None

    def set_inner_result(self, code: IntEnum, value=None) -> None:
        """result = opINNER/tr/<this op's result union>(code, value)."""
        rt = self._inner_result_type()
        if rt is None:
            inner = None
        elif value is None and rt.ARMS.get(code, None) is None:
            inner = rt(code)  # void arm
        else:
            inner = rt(code, value)
        self.result = OperationResult(
            OperationResultCode.opINNER,
            _OperationResultTr(self.OP_TYPE, inner))

    def set_outer_result(self, code: OperationResultCode) -> None:
        releaseAssert(code != OperationResultCode.opINNER,
                      "opINNER is set via set_inner_result")
        self.result = OperationResult(code)

    def inner_code(self) -> Optional[int]:
        if self.result is not None and \
                self.result.disc == OperationResultCode.opINNER:
            return self.result.value.value.disc
        return None

    # ------------------------------------------------------------ overrides --
    def threshold_level(self) -> ThresholdLevel:
        return ThresholdLevel.MEDIUM

    def is_op_supported(self, header, ledger_version: int) -> bool:
        """Version/flag gate (reference: OperationFrame::isOpSupported —
        overloads take the LedgerHeader so voted header flags can
        disable ops, e.g. the liquidity-pool bits)."""
        return True

    def do_check_valid(self, header, ledger_version: int) -> bool:
        """Stateless validity; set a result and return False on failure."""
        raise NotImplementedError

    def do_apply(self, ltx, header, ctx: ApplyContext) -> bool:
        raise NotImplementedError

    # ------------------------------------------------------------- plumbing --
    def check_signature(self, checker: SignatureChecker, ltx,
                        forapply: bool) -> bool:
        """Reference: OperationFrame::checkSignature — the op source's
        signers must reach the op threshold; missing-account fallback only
        for validation of ops with an explicit source override."""
        source_le = ltx.load_without_record(LedgerKey.account(self.source_id))
        if source_le is not None:
            acc = source_le.data.value
            needed = acc.thresholds[_THRESHOLD_INDEX[self.threshold_level()]]
            signers = tx_utils.get_signers_with_master(acc)
            if not checker.check_signature(signers, needed):
                self.set_outer_result(OperationResultCode.opBAD_AUTH)
                return False
        else:
            if forapply or self.op.sourceAccount is None:
                self.set_outer_result(OperationResultCode.opNO_ACCOUNT)
                return False
            # validation-time with missing account: master key at weight 1
            # (reference: TransactionFrame::checkSignatureNoAccount)
            from ..xdr.types import SignerKey, SignerKeyType
            signers = [(SignerKey(SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                                  self.source_id.value), 1)]
            if not checker.check_signature(signers, 0):
                self.set_outer_result(OperationResultCode.opBAD_AUTH)
                return False
        return True

    def check_valid(self, checker: SignatureChecker, ltx,
                    forapply: bool) -> bool:
        """Reference: OperationFrame::checkValid — version gate, then
        signature check at validation time (apply-time signatures were
        settled in processSignatures, only existence is re-checked), then
        doCheckValid. Never mutates the caller's ltx."""
        header = ltx.get_header()
        ledger_version = header.ledgerVersion
        if not self.is_op_supported(header, ledger_version):
            self.set_outer_result(OperationResultCode.opNOT_SUPPORTED)
            return False
        if not forapply:
            if not self.check_signature(checker, ltx, False):
                return False
        else:
            if ltx.load_without_record(
                    LedgerKey.account(self.source_id)) is None:
                self.set_outer_result(OperationResultCode.opNO_ACCOUNT)
                return False
        return self.do_check_valid(header, ledger_version)

    def apply(self, checker: SignatureChecker, ltx,
              ctx: ApplyContext) -> bool:
        """Reference: OperationFrame::apply = checkValid(apply-mode) +
        doApply (caller wraps in a per-op LedgerTxn)."""
        if not self.check_valid(checker, ltx, True):
            return False
        ctx.op_index = self.op_index
        return self.do_apply(ltx, ltx.load_header(), ctx)

    # ------------------------------------------------------------- helpers --
    def load_source_account(self, ltx):
        return ltx.load(LedgerKey.account(self.source_id))
