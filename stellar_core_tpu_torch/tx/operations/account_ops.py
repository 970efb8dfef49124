"""Account lifecycle operations: CreateAccount, AccountMerge, SetOptions,
BumpSequence.

Reference: transactions/CreateAccountOpFrame.cpp, MergeOpFrame.cpp,
SetOptionsOpFrame.cpp, BumpSequenceOpFrame.cpp. Behavior targets the
current protocol (>= 19); legacy-version branches the reference keeps for
replay of ancient ledgers are documented where omitted.
"""

from __future__ import annotations

from ...xdr.ledger_entries import (AccountFlags, LedgerEntry, LedgerKey,
                                   LedgerEntryType, Signer, ThresholdIndexes)
from ...xdr.transaction import OperationType
from ...xdr.results import (
    AccountMergeResult, AccountMergeResultCode, BumpSequenceResult,
    BumpSequenceResultCode, CreateAccountResult, CreateAccountResultCode,
    SetOptionsResult, SetOptionsResultCode,
)
from ...xdr.types import SignerKey, SignerKeyType
from .. import tx_utils
from ..operation_frame import (OperationFrame, ThresholdLevel, register_op)
from ..sponsorship import (
    ApplyContext, SponsorshipResult, account_seq_ledger, account_seq_time,
    create_entry_with_possible_sponsorship,
    create_signer_with_possible_sponsorship, ensure_account_ext_v2,
    ensure_account_ext_v3, num_sponsoring, remove_signer_sponsorship,
)

MAX_SIGNERS = 20
ALL_ACCOUNT_FLAGS = (AccountFlags.AUTH_REQUIRED_FLAG
                     | AccountFlags.AUTH_REVOCABLE_FLAG
                     | AccountFlags.AUTH_IMMUTABLE_FLAG
                     | AccountFlags.AUTH_CLAWBACK_ENABLED_FLAG)


@register_op(OperationType.CREATE_ACCOUNT)
class CreateAccountOpFrame(OperationFrame):
    """reference: transactions/CreateAccountOpFrame.cpp"""

    def do_check_valid(self, header, ledger_version: int) -> bool:
        b = self.body
        if b.startingBalance < 0:
            self.set_inner_result(CreateAccountResultCode.
                                  CREATE_ACCOUNT_MALFORMED)
            return False
        # startingBalance == 0 allowed from protocol 14 (sponsored creation)
        if b.startingBalance == 0 and ledger_version < 14:
            self.set_inner_result(CreateAccountResultCode.
                                  CREATE_ACCOUNT_MALFORMED)
            return False
        if b.destination.to_bytes() == self.source_id.to_bytes():
            self.set_inner_result(CreateAccountResultCode.
                                  CREATE_ACCOUNT_MALFORMED)
            return False
        return True

    def do_apply(self, ltx, header, ctx: ApplyContext) -> bool:
        b = self.body
        if ltx.entry_exists(LedgerKey.account(b.destination)):
            self.set_inner_result(CreateAccountResultCode.
                                  CREATE_ACCOUNT_ALREADY_EXIST)
            return False
        source_le = self.load_source_account(ltx)
        source = source_le.data.value
        if tx_utils.available_balance(header, source) < b.startingBalance:
            self.set_inner_result(CreateAccountResultCode.
                                  CREATE_ACCOUNT_UNDERFUNDED)
            return False

        new_le = tx_utils.make_account_ledger_entry(
            b.destination, b.startingBalance,
            tx_utils.starting_sequence_number(header.ledgerSeq))
        new_le.lastModifiedLedgerSeq = header.ledgerSeq

        sres = create_entry_with_possible_sponsorship(
            ltx, header, new_le, source_le, ctx)
        if sres != SponsorshipResult.SUCCESS:
            self.set_inner_result(CreateAccountResultCode.
                                  CREATE_ACCOUNT_LOW_RESERVE)
            return False
        # unsponsored accounts must fund their own 2-reserve minimum
        from ..sponsorship import is_sponsored
        if not is_sponsored(new_le) and \
                b.startingBalance < 2 * header.baseReserve:
            self.set_inner_result(CreateAccountResultCode.
                                  CREATE_ACCOUNT_LOW_RESERVE)
            return False
        ok = tx_utils.add_balance_account(header, source, -b.startingBalance)
        if not ok:
            self.set_inner_result(CreateAccountResultCode.
                                  CREATE_ACCOUNT_UNDERFUNDED)
            return False
        ltx.create(new_le)
        self.set_inner_result(CreateAccountResultCode.CREATE_ACCOUNT_SUCCESS)
        return True


@register_op(OperationType.ACCOUNT_MERGE)
class MergeOpFrame(OperationFrame):
    """reference: transactions/MergeOpFrame.cpp (threshold HIGH :30-32)"""

    def threshold_level(self) -> ThresholdLevel:
        return ThresholdLevel.HIGH

    def do_check_valid(self, header, ledger_version: int) -> bool:
        if self.body.account_id().to_bytes() == self.source_id.to_bytes():
            self.set_inner_result(AccountMergeResultCode.
                                  ACCOUNT_MERGE_MALFORMED)
            return False
        return True

    def do_apply(self, ltx, header, ctx: ApplyContext) -> bool:
        dest_id = self.body.account_id()
        dest_le = ltx.load(LedgerKey.account(dest_id))
        if dest_le is None:
            self.set_inner_result(AccountMergeResultCode.
                                  ACCOUNT_MERGE_NO_ACCOUNT)
            return False
        source_le = self.load_source_account(ltx)
        source = source_le.data.value

        if source.flags & AccountFlags.AUTH_IMMUTABLE_FLAG:
            self.set_inner_result(AccountMergeResultCode.
                                  ACCOUNT_MERGE_IMMUTABLE_SET)
            return False
        if source.numSubEntries != 0:
            self.set_inner_result(AccountMergeResultCode.
                                  ACCOUNT_MERGE_HAS_SUB_ENTRIES)
            return False
        if num_sponsoring(source) != 0:
            self.set_inner_result(AccountMergeResultCode.
                                  ACCOUNT_MERGE_IS_SPONSOR)
            return False
        # seqnum must not be reusable after re-creation (reference:
        # MergeOpFrame::doApply, protocol >= 10: maxSeq =
        # getStartingSequenceNumber(header) = ledgerSeq << 32)
        max_seq = tx_utils.starting_sequence_number(header.ledgerSeq)
        if source.seqNum >= max_seq:
            self.set_inner_result(AccountMergeResultCode.
                                  ACCOUNT_MERGE_SEQNUM_TOO_FAR)
            return False

        balance = source.balance
        dest = dest_le.data.value
        if not tx_utils.add_balance_account(header, dest, balance):
            self.set_inner_result(AccountMergeResultCode.
                                  ACCOUNT_MERGE_DEST_FULL)
            return False
        # release sponsorships on the account's signers before the account
        # itself (reference: MergeOpFrame removeSignersWithSponsorship)
        for i in range(len(source.signers) - 1, -1, -1):
            remove_signer_sponsorship(ltx, source_le, i)
        from ..sponsorship import remove_entry_with_possible_sponsorship
        remove_entry_with_possible_sponsorship(ltx, header, source_le, None)
        ltx.erase(LedgerKey.account(self.source_id))
        self.set_inner_result(AccountMergeResultCode.ACCOUNT_MERGE_SUCCESS,
                              balance)
        return True


@register_op(OperationType.SET_OPTIONS)
class SetOptionsOpFrame(OperationFrame):
    """reference: transactions/SetOptionsOpFrame.cpp (threshold HIGH when
    touching signers/weights/thresholds :33-42)"""

    def threshold_level(self) -> ThresholdLevel:
        b = self.body
        if (b.masterWeight is not None or b.lowThreshold is not None
                or b.medThreshold is not None or b.highThreshold is not None
                or b.signer is not None):
            return ThresholdLevel.HIGH
        return ThresholdLevel.MEDIUM

    def do_check_valid(self, header, ledger_version: int) -> bool:
        b = self.body
        set_f = b.setFlags or 0
        clear_f = b.clearFlags or 0
        if set_f & clear_f:
            self.set_inner_result(SetOptionsResultCode.SET_OPTIONS_BAD_FLAGS)
            return False
        allowed = ALL_ACCOUNT_FLAGS if ledger_version >= 17 else (
            AccountFlags.AUTH_REQUIRED_FLAG | AccountFlags.AUTH_REVOCABLE_FLAG
            | AccountFlags.AUTH_IMMUTABLE_FLAG)
        if (set_f | clear_f) & ~allowed:
            self.set_inner_result(SetOptionsResultCode.
                                  SET_OPTIONS_UNKNOWN_FLAG)
            return False
        for v in (b.masterWeight, b.lowThreshold, b.medThreshold,
                  b.highThreshold):
            if v is not None and v > 255:
                self.set_inner_result(SetOptionsResultCode.
                                      SET_OPTIONS_THRESHOLD_OUT_OF_RANGE)
                return False
        if b.signer is not None:
            sk: SignerKey = b.signer.key
            if sk.disc == SignerKeyType.SIGNER_KEY_TYPE_ED25519 and \
                    sk.value == self.source_id.value:
                self.set_inner_result(SetOptionsResultCode.
                                      SET_OPTIONS_BAD_SIGNER)
                return False
            if sk.disc == SignerKeyType.SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD \
                    and len(sk.value.payload) == 0:
                self.set_inner_result(SetOptionsResultCode.
                                      SET_OPTIONS_BAD_SIGNER)
                return False
            if ledger_version >= 10 and b.signer.weight > 255:
                self.set_inner_result(SetOptionsResultCode.
                                      SET_OPTIONS_BAD_SIGNER)
                return False
        if b.homeDomain is not None and not _valid_string32(b.homeDomain):
            self.set_inner_result(SetOptionsResultCode.
                                  SET_OPTIONS_INVALID_HOME_DOMAIN)
            return False
        return True

    def do_apply(self, ltx, header, ctx: ApplyContext) -> bool:
        b = self.body
        source_le = self.load_source_account(ltx)
        acc = source_le.data.value

        if b.inflationDest is not None:
            if not ltx.entry_exists(LedgerKey.account(b.inflationDest)):
                self.set_inner_result(SetOptionsResultCode.
                                      SET_OPTIONS_INVALID_INFLATION)
                return False
            acc.inflationDest = b.inflationDest

        # reference SetOptionsOpFrame: all auth flags (REQUIRED, REVOCABLE,
        # IMMUTABLE) are frozen once AUTH_IMMUTABLE is set
        all_auth = (AccountFlags.AUTH_REQUIRED_FLAG
                    | AccountFlags.AUTH_REVOCABLE_FLAG
                    | AccountFlags.AUTH_IMMUTABLE_FLAG)
        if b.clearFlags:
            if (b.clearFlags & all_auth) and \
                    (acc.flags & AccountFlags.AUTH_IMMUTABLE_FLAG):
                self.set_inner_result(SetOptionsResultCode.
                                      SET_OPTIONS_CANT_CHANGE)
                return False
            acc.flags &= ~b.clearFlags
        if b.setFlags:
            if (b.setFlags & all_auth) and \
                    (acc.flags & AccountFlags.AUTH_IMMUTABLE_FLAG):
                self.set_inner_result(SetOptionsResultCode.
                                      SET_OPTIONS_CANT_CHANGE)
                return False
            acc.flags |= b.setFlags
        # AUTH_REVOCABLE is required while AUTH_CLAWBACK_ENABLED is set
        if (acc.flags & AccountFlags.AUTH_CLAWBACK_ENABLED_FLAG) and \
                not (acc.flags & AccountFlags.AUTH_REVOCABLE_FLAG):
            self.set_inner_result(
                SetOptionsResultCode.SET_OPTIONS_AUTH_REVOCABLE_REQUIRED)
            return False

        th = bytearray(acc.thresholds)
        if b.masterWeight is not None:
            th[ThresholdIndexes.THRESHOLD_MASTER_WEIGHT] = b.masterWeight
        if b.lowThreshold is not None:
            th[ThresholdIndexes.THRESHOLD_LOW] = b.lowThreshold
        if b.medThreshold is not None:
            th[ThresholdIndexes.THRESHOLD_MED] = b.medThreshold
        if b.highThreshold is not None:
            th[ThresholdIndexes.THRESHOLD_HIGH] = b.highThreshold
        acc.thresholds = bytes(th)

        if b.homeDomain is not None:
            acc.homeDomain = b.homeDomain

        if b.signer is not None:
            if not self._apply_signer(ltx, header, source_le, b.signer, ctx):
                return False

        self.set_inner_result(SetOptionsResultCode.SET_OPTIONS_SUCCESS)
        return True

    def _apply_signer(self, ltx, header, source_le: LedgerEntry,
                      signer: Signer, ctx: ApplyContext) -> bool:
        acc = source_le.data.value
        weight = min(signer.weight, 255)
        idx = next((i for i, s in enumerate(acc.signers)
                    if s.key == signer.key), None)
        if weight == 0:
            if idx is None:
                self.set_inner_result(SetOptionsResultCode.
                                      SET_OPTIONS_BAD_SIGNER)
                return False
            remove_signer_sponsorship(ltx, source_le, idx)
            acc.signers.pop(idx)
            if acc.ext.disc == 1 and acc.ext.value.ext.disc == 2:
                ids = acc.ext.value.ext.value.signerSponsoringIDs
                if idx < len(ids):
                    ids.pop(idx)
            return True
        if idx is not None:
            acc.signers[idx].weight = weight
            return True
        if len(acc.signers) >= MAX_SIGNERS:
            self.set_inner_result(SetOptionsResultCode.
                                  SET_OPTIONS_TOO_MANY_SIGNERS)
            return False
        sres = create_signer_with_possible_sponsorship(
            ltx, header, source_le, ctx)
        if sres == SponsorshipResult.LOW_RESERVE:
            self.set_inner_result(SetOptionsResultCode.
                                  SET_OPTIONS_LOW_RESERVE)
            return False
        if sres != SponsorshipResult.SUCCESS:
            self.set_inner_result(SetOptionsResultCode.
                                  SET_OPTIONS_TOO_MANY_SIGNERS)
            return False
        # signers stay sorted by key bytes (reference: account entry
        # invariant enforced in SetOptionsOpFrame)
        new_signer = Signer(key=signer.key, weight=weight)
        sponsor = ctx.sponsor_for(acc.accountID) if ctx else None
        insert_at = len(acc.signers)
        for i, s in enumerate(acc.signers):
            if signer.key.to_bytes() < s.key.to_bytes():
                insert_at = i
                break
        acc.signers.insert(insert_at, new_signer)
        if sponsor is not None or (
                acc.ext.disc == 1 and acc.ext.value.ext.disc == 2):
            v2 = ensure_account_ext_v2(acc)
            # ensure_account_ext_v2 appended a slot; place it correctly
            v2.signerSponsoringIDs.pop()
            v2.signerSponsoringIDs.insert(insert_at, sponsor)
        return True


@register_op(OperationType.BUMP_SEQUENCE)
class BumpSequenceOpFrame(OperationFrame):
    """reference: transactions/BumpSequenceOpFrame.cpp (LOW threshold,
    supported from protocol 10)"""

    def threshold_level(self) -> ThresholdLevel:
        return ThresholdLevel.LOW

    def is_op_supported(self, header, ledger_version: int) -> bool:
        return ledger_version >= 10

    def do_check_valid(self, header, ledger_version: int) -> bool:
        if self.body.bumpTo < 0:
            self.set_inner_result(BumpSequenceResultCode.
                                  BUMP_SEQUENCE_BAD_SEQ)
            return False
        return True

    def do_apply(self, ltx, header, ctx: ApplyContext) -> bool:
        source_le = self.load_source_account(ltx)
        acc = source_le.data.value
        if self.body.bumpTo > acc.seqNum:
            acc.seqNum = self.body.bumpTo
            if header.ledgerVersion >= 19:
                v3 = ensure_account_ext_v3(acc)
                v3.seqLedger = header.ledgerSeq
                v3.seqTime = header.scpValue.closeTime
        self.set_inner_result(BumpSequenceResultCode.BUMP_SEQUENCE_SUCCESS)
        return True


def _valid_string32(s: bytes) -> bool:
    return len(s) <= 32 and tx_utils.is_string_valid(s)
