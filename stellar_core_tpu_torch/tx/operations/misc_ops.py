"""ManageData and Inflation operations.

Reference: transactions/ManageDataOpFrame.cpp,
InflationOpFrame.cpp (LOW threshold :133-135; unsupported from
protocol 12, :127-130 — the pre-12 vote-tally payout logic is
deliberately not carried into this modern-protocol build).
"""

from __future__ import annotations

from ...xdr.ledger_entries import (DataEntry, LedgerEntry, LedgerEntryType,
                                   LedgerKey, _LedgerEntryData)
from ...xdr.transaction import OperationType
from ...xdr.results import (InflationResultCode, ManageDataResultCode,
                            OperationResultCode)
from ..operation_frame import OperationFrame, ThresholdLevel, register_op
from ..sponsorship import (ApplyContext, SponsorshipResult,
                           create_entry_with_possible_sponsorship,
                           remove_entry_with_possible_sponsorship)


from ..tx_utils import is_string_valid


@register_op(OperationType.MANAGE_DATA)
class ManageDataOpFrame(OperationFrame):

    def do_check_valid(self, header, ledger_version: int) -> bool:
        b = self.body
        if ledger_version < 2:
            self.set_inner_result(ManageDataResultCode.
                                  MANAGE_DATA_NOT_SUPPORTED_YET)
            return False
        if len(b.dataName) < 1 or not is_string_valid(b.dataName):
            self.set_inner_result(ManageDataResultCode.
                                  MANAGE_DATA_INVALID_NAME)
            return False
        return True

    def do_apply(self, ltx, header, ctx: ApplyContext) -> bool:
        b = self.body
        key = LedgerKey.data(self.source_id, b.dataName)
        data_le = ltx.load(key)
        if b.dataValue is not None:
            if data_le is None:
                de = DataEntry(accountID=self.source_id,
                               dataName=b.dataName, dataValue=b.dataValue)
                new_le = LedgerEntry(
                    lastModifiedLedgerSeq=header.ledgerSeq,
                    data=_LedgerEntryData(LedgerEntryType.DATA, de))
                source_le = self.load_source_account(ltx)
                sres = create_entry_with_possible_sponsorship(
                    ltx, header, new_le, source_le, ctx)
                if sres == SponsorshipResult.LOW_RESERVE:
                    self.set_inner_result(ManageDataResultCode.
                                          MANAGE_DATA_LOW_RESERVE)
                    return False
                if sres == SponsorshipResult.TOO_MANY_SUBENTRIES:
                    self.set_outer_result(OperationResultCode.
                                          opTOO_MANY_SUBENTRIES)
                    return False
                if sres == SponsorshipResult.TOO_MANY_SPONSORING:
                    self.set_outer_result(OperationResultCode.
                                          opTOO_MANY_SPONSORING)
                    return False
                ltx.create(new_le)
            else:
                data_le.data.value.dataValue = b.dataValue
        else:
            if data_le is None:
                self.set_inner_result(ManageDataResultCode.
                                      MANAGE_DATA_NAME_NOT_FOUND)
                return False
            source_le = self.load_source_account(ltx)
            remove_entry_with_possible_sponsorship(
                ltx, header, data_le, source_le)
            ltx.erase(key)
        self.set_inner_result(ManageDataResultCode.MANAGE_DATA_SUCCESS)
        return True


@register_op(OperationType.INFLATION)
class InflationOpFrame(OperationFrame):

    def threshold_level(self) -> ThresholdLevel:
        return ThresholdLevel.LOW

    def is_op_supported(self, header, ledger_version: int) -> bool:
        return ledger_version < 12

    def do_check_valid(self, header, ledger_version: int) -> bool:
        return True

    def do_apply(self, ltx, header, ctx: ApplyContext) -> bool:
        # Unreachable in this modern-protocol build (is_op_supported gates
        # anything >= v12); kept for result-code shape parity.
        self.set_inner_result(InflationResultCode.INFLATION_NOT_TIME)
        return False
