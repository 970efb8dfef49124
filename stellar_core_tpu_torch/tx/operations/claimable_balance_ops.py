"""Claimable balances: create, claim, clawback.

Reference: transactions/CreateClaimableBalanceOpFrame.cpp (balance id =
SHA256 of the ENVELOPE_TYPE_OP_ID preimage, relative predicates rebased
to absolute close time, clawback flag inherited from the source trust
line), ClaimClaimableBalanceOpFrame.cpp (predicate evaluation against
close time), ClawbackClaimableBalanceOpFrame.cpp.
"""

from __future__ import annotations

import struct
from typing import List, Optional

from ...crypto.sha import sha256
from ...xdr.ledger_entries import (AccountFlags, Asset, AssetType, Claimant,
                                   ClaimantType, ClaimantV0,
                                   ClaimPredicate, ClaimPredicateType,
                                   ClaimableBalanceEntry,
                                   ClaimableBalanceEntryExtensionV1,
                                   ClaimableBalanceID,
                                   ClaimableBalanceIDType,
                                   LedgerEntry, LedgerEntryType, LedgerKey,
                                   TrustLineFlags, _ClaimableBalanceEntryExt,
                                   _LedgerEntryData, _LedgerEntryExt)
from ...xdr.results import (ClaimClaimableBalanceResultCode,
                            ClawbackClaimableBalanceResultCode,
                            CreateClaimableBalanceResultCode)
from ...xdr.transaction import OperationType
from ...xdr.types import EnvelopeType, ExtensionPoint
from ...ledger.ledger_txn import LedgerTxn
from .. import tx_utils
from ..operation_frame import OperationFrame, register_op
from ..sponsorship import (SponsorshipResult,
                           create_entry_with_possible_sponsorship,
                           remove_entry_with_possible_sponsorship)
from ...xdr.results import OperationResultCode

# reference: ClaimableBalanceEntry v1 flags
CLAIMABLE_BALANCE_CLAWBACK_ENABLED_FLAG = 0x1

MAX_PREDICATE_DEPTH = 4


def operation_id(ctx, op_index: int) -> bytes:
    """SHA256(HashIDPreimage ENVELOPE_TYPE_OP_ID {sourceAccount, seqNum,
    opNum}) (reference: getBalanceID / HashIDPreimage)."""
    return sha256(
        struct.pack(">i", EnvelopeType.ENVELOPE_TYPE_OP_ID)
        + ctx.tx_source_id.to_bytes()
        + struct.pack(">q", ctx.tx_seq_num)
        + struct.pack(">I", op_index))


def validate_predicate(pred: ClaimPredicate, depth: int = 1) -> bool:
    """reference: validatePredicate — depth cap, arity, non-negative
    relative times."""
    if depth > MAX_PREDICATE_DEPTH:
        return False
    t = pred.disc
    if t == ClaimPredicateType.CLAIM_PREDICATE_UNCONDITIONAL:
        return True
    if t == ClaimPredicateType.CLAIM_PREDICATE_AND or \
            t == ClaimPredicateType.CLAIM_PREDICATE_OR:
        arms = list(pred.value)
        if len(arms) != 2:
            return False
        return all(validate_predicate(p, depth + 1) for p in arms)
    if t == ClaimPredicateType.CLAIM_PREDICATE_NOT:
        if pred.value is None:
            return False
        return validate_predicate(pred.value, depth + 1)
    if t == ClaimPredicateType.CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME:
        return pred.value >= 0
    if t == ClaimPredicateType.CLAIM_PREDICATE_BEFORE_RELATIVE_TIME:
        return pred.value >= 0
    return False


def rebase_predicate(pred: ClaimPredicate,
                     close_time: int) -> ClaimPredicate:
    """BEFORE_RELATIVE_TIME → BEFORE_ABSOLUTE_TIME(closeTime + rel)
    (reference: updatePredicatesForApply)."""
    t = pred.disc
    if t in (ClaimPredicateType.CLAIM_PREDICATE_AND,
             ClaimPredicateType.CLAIM_PREDICATE_OR):
        return ClaimPredicate(t, [rebase_predicate(p, close_time)
                                  for p in pred.value])
    if t == ClaimPredicateType.CLAIM_PREDICATE_NOT:
        return ClaimPredicate(t, rebase_predicate(pred.value, close_time))
    if t == ClaimPredicateType.CLAIM_PREDICATE_BEFORE_RELATIVE_TIME:
        when = min(close_time + pred.value, 2**63 - 1)
        return ClaimPredicate(
            ClaimPredicateType.CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME, when)
    return pred


def test_predicate(pred: ClaimPredicate, close_time: int) -> bool:
    """reference: evaluatePredicate at claim time."""
    t = pred.disc
    if t == ClaimPredicateType.CLAIM_PREDICATE_UNCONDITIONAL:
        return True
    if t == ClaimPredicateType.CLAIM_PREDICATE_AND:
        return all(test_predicate(p, close_time) for p in pred.value)
    if t == ClaimPredicateType.CLAIM_PREDICATE_OR:
        return any(test_predicate(p, close_time) for p in pred.value)
    if t == ClaimPredicateType.CLAIM_PREDICATE_NOT:
        return not test_predicate(pred.value, close_time)
    if t == ClaimPredicateType.CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME:
        return close_time < pred.value
    return False


@register_op(OperationType.CREATE_CLAIMABLE_BALANCE)
class CreateClaimableBalanceOpFrame(OperationFrame):

    def do_check_valid(self, header, ledger_version: int) -> bool:
        b = self.body
        rc = CreateClaimableBalanceResultCode
        if b.amount <= 0 or not tx_utils.is_asset_valid(b.asset) or \
                not b.claimants:
            self.set_inner_result(rc.CREATE_CLAIMABLE_BALANCE_MALFORMED)
            return False
        dests = set()
        for c in b.claimants:
            dest = c.value.destination.to_bytes()
            if dest in dests or not validate_predicate(c.value.predicate):
                self.set_inner_result(
                    rc.CREATE_CLAIMABLE_BALANCE_MALFORMED)
                return False
            dests.add(dest)
        return True

    def do_apply(self, ltx_outer, header_outer, ctx) -> bool:
        b = self.body
        rc = CreateClaimableBalanceResultCode
        with LedgerTxn(ltx_outer) as ltx:
            header = ltx.load_header()
            close_time = header.scpValue.closeTime

            # debit the source (reference: underfunded / trust checks)
            native = b.asset.disc == AssetType.ASSET_TYPE_NATIVE
            clawback = False
            if native:
                src_le = ltx.load(LedgerKey.account(self.source_id))
                if not tx_utils.add_balance_account(
                        header, src_le.data.value, -b.amount):
                    self.set_inner_result(
                        rc.CREATE_CLAIMABLE_BALANCE_UNDERFUNDED)
                    return False
            else:
                issuer = tx_utils.asset_issuer(b.asset)
                if issuer.to_bytes() == self.source_id.to_bytes():
                    # issuer mints; clawback follows the account flag
                    src_le = ltx.load(LedgerKey.account(self.source_id))
                    clawback = bool(src_le.data.value.flags &
                                    AccountFlags.AUTH_CLAWBACK_ENABLED_FLAG)
                else:
                    tl_le = tx_utils.load_trustline(ltx, self.source_id,
                                                    b.asset)
                    if tl_le is None:
                        self.set_inner_result(
                            rc.CREATE_CLAIMABLE_BALANCE_NO_TRUST)
                        return False
                    tl = tl_le.data.value
                    if not tx_utils.is_authorized(tl):
                        self.set_inner_result(
                            rc.CREATE_CLAIMABLE_BALANCE_NOT_AUTHORIZED)
                        return False
                    if not tx_utils.add_balance_trustline(tl, -b.amount):
                        self.set_inner_result(
                            rc.CREATE_CLAIMABLE_BALANCE_UNDERFUNDED)
                        return False
                    clawback = bool(
                        tl.flags &
                        TrustLineFlags.TRUSTLINE_CLAWBACK_ENABLED_FLAG)

            balance_id = ClaimableBalanceID(
                ClaimableBalanceIDType.CLAIMABLE_BALANCE_ID_TYPE_V0,
                operation_id(ctx, self.op_index))
            claimants = [
                Claimant(ClaimantType.CLAIMANT_TYPE_V0, ClaimantV0(
                    destination=c.value.destination,
                    predicate=rebase_predicate(c.value.predicate,
                                               close_time)))
                for c in b.claimants]
            ext = _ClaimableBalanceEntryExt(0)
            if clawback:
                ext = _ClaimableBalanceEntryExt(
                    1, ClaimableBalanceEntryExtensionV1(
                        ext=ExtensionPoint(0),
                        flags=CLAIMABLE_BALANCE_CLAWBACK_ENABLED_FLAG))
            entry = LedgerEntry(
                lastModifiedLedgerSeq=header.ledgerSeq,
                data=_LedgerEntryData(
                    LedgerEntryType.CLAIMABLE_BALANCE,
                    ClaimableBalanceEntry(
                        balanceID=balance_id, claimants=claimants,
                        asset=b.asset, amount=b.amount, ext=ext)),
                ext=_LedgerEntryExt(0))
            src_le = ltx.load(LedgerKey.account(self.source_id))
            res = create_entry_with_possible_sponsorship(
                ltx, header, entry, src_le, ctx)
            if res == SponsorshipResult.LOW_RESERVE:
                self.set_inner_result(
                    rc.CREATE_CLAIMABLE_BALANCE_LOW_RESERVE)
                return False
            if res != SponsorshipResult.SUCCESS:
                self.set_outer_result(
                    OperationResultCode.opTOO_MANY_SPONSORING)
                return False
            ltx.create(entry)
            self.set_inner_result(
                rc.CREATE_CLAIMABLE_BALANCE_SUCCESS, balance_id)
            ltx.commit()
            return True


@register_op(OperationType.CLAIM_CLAIMABLE_BALANCE)
class ClaimClaimableBalanceOpFrame(OperationFrame):

    def do_check_valid(self, header, ledger_version: int) -> bool:
        return True

    def do_apply(self, ltx_outer, header_outer, ctx) -> bool:
        b = self.body
        rc = ClaimClaimableBalanceResultCode
        with LedgerTxn(ltx_outer) as ltx:
            header = ltx.load_header()
            key = LedgerKey.claimable_balance(b.balanceID)
            le = ltx.load(key)
            if le is None:
                self.set_inner_result(
                    rc.CLAIM_CLAIMABLE_BALANCE_DOES_NOT_EXIST)
                return False
            cb: ClaimableBalanceEntry = le.data.value
            claimant = None
            for c in cb.claimants:
                if c.value.destination.to_bytes() == \
                        self.source_id.to_bytes():
                    claimant = c.value
                    break
            if claimant is None or not test_predicate(
                    claimant.predicate, header.scpValue.closeTime):
                self.set_inner_result(
                    rc.CLAIM_CLAIMABLE_BALANCE_CANNOT_CLAIM)
                return False

            # credit the claimant
            native = cb.asset.disc == AssetType.ASSET_TYPE_NATIVE
            if native:
                src_le = ltx.load(LedgerKey.account(self.source_id))
                if not tx_utils.add_balance_account(
                        header, src_le.data.value, cb.amount):
                    self.set_inner_result(
                        rc.CLAIM_CLAIMABLE_BALANCE_LINE_FULL)
                    return False
            else:
                issuer = tx_utils.asset_issuer(cb.asset)
                if issuer.to_bytes() != self.source_id.to_bytes():
                    tl_le = tx_utils.load_trustline(ltx, self.source_id,
                                                    cb.asset)
                    if tl_le is None:
                        self.set_inner_result(
                            rc.CLAIM_CLAIMABLE_BALANCE_NO_TRUST)
                        return False
                    tl = tl_le.data.value
                    if not tx_utils.is_authorized(tl):
                        self.set_inner_result(
                            rc.CLAIM_CLAIMABLE_BALANCE_NOT_AUTHORIZED)
                        return False
                    if not tx_utils.add_balance_trustline(tl, cb.amount):
                        self.set_inner_result(
                            rc.CLAIM_CLAIMABLE_BALANCE_LINE_FULL)
                        return False

            remove_entry_with_possible_sponsorship(
                ltx, header, le,
                ltx.load(LedgerKey.account(self.source_id)))
            ltx.erase(key)
            self.set_inner_result(rc.CLAIM_CLAIMABLE_BALANCE_SUCCESS)
            ltx.commit()
            return True


@register_op(OperationType.CLAWBACK_CLAIMABLE_BALANCE)
class ClawbackClaimableBalanceOpFrame(OperationFrame):

    def do_check_valid(self, header, ledger_version: int) -> bool:
        return True

    def do_apply(self, ltx_outer, header_outer, ctx) -> bool:
        b = self.body
        rc = ClawbackClaimableBalanceResultCode
        with LedgerTxn(ltx_outer) as ltx:
            header = ltx.load_header()
            key = LedgerKey.claimable_balance(b.balanceID)
            le = ltx.load(key)
            if le is None:
                self.set_inner_result(
                    rc.CLAWBACK_CLAIMABLE_BALANCE_DOES_NOT_EXIST)
                return False
            cb: ClaimableBalanceEntry = le.data.value
            issuer = tx_utils.asset_issuer(cb.asset)
            if issuer is None or \
                    issuer.to_bytes() != self.source_id.to_bytes():
                self.set_inner_result(
                    rc.CLAWBACK_CLAIMABLE_BALANCE_NOT_ISSUER)
                return False
            flags = cb.ext.value.flags if cb.ext.disc == 1 else 0
            if not (flags & CLAIMABLE_BALANCE_CLAWBACK_ENABLED_FLAG):
                self.set_inner_result(
                    rc.CLAWBACK_CLAIMABLE_BALANCE_NOT_CLAWBACK_ENABLED)
                return False
            remove_entry_with_possible_sponsorship(
                ltx, header, le,
                ltx.load(LedgerKey.account(self.source_id)))
            ltx.erase(key)
            self.set_inner_result(rc.CLAWBACK_CLAIMABLE_BALANCE_SUCCESS)
            ltx.commit()
            return True
