"""Sponsorship operations: begin/end sponsoring future reserves, revoke.

Reference: transactions/BeginSponsoringFutureReservesOpFrame.cpp
(records the ephemeral sponsorship scope; RECURSIVE if chains would
form), EndSponsoringFutureReservesOpFrame.cpp (the *sponsored* account
ends its scope), RevokeSponsorshipOpFrame.cpp (transfer or remove the
sponsorship of one entry/signer, updating counters and checking
reserves).
"""

from __future__ import annotations

from typing import Optional

from ...xdr.ledger_entries import (AccountEntry, LedgerEntry,
                                   LedgerEntryType, LedgerKey,
                                   _LedgerEntryExt, LedgerEntryExtensionV1)
from ...xdr.results import (BeginSponsoringFutureReservesResultCode,
                            EndSponsoringFutureReservesResultCode,
                            OperationResultCode,
                            RevokeSponsorshipResultCode)
from ...xdr.transaction import OperationType, RevokeSponsorshipType
from ...xdr.types import ExtensionPoint
from ...ledger.ledger_txn import LedgerTxn
from .. import tx_utils
from ..operation_frame import OperationFrame, register_op
from ..sponsorship import (ensure_account_ext_v2, get_sponsoring_id,
                           num_sponsored, num_sponsoring,
                           reserve_multiplier, set_sponsoring_id,
                           _available_for_reserve)


@register_op(OperationType.BEGIN_SPONSORING_FUTURE_RESERVES)
class BeginSponsoringFutureReservesOpFrame(OperationFrame):

    def do_check_valid(self, header, ledger_version: int) -> bool:
        rc = BeginSponsoringFutureReservesResultCode
        if self.body.sponsoredID.to_bytes() == self.source_id.to_bytes():
            self.set_inner_result(
                rc.BEGIN_SPONSORING_FUTURE_RESERVES_MALFORMED)
            return False
        return True

    def do_apply(self, ltx, header, ctx) -> bool:
        rc = BeginSponsoringFutureReservesResultCode
        sponsored = self.body.sponsoredID.to_bytes()
        source = self.source_id.to_bytes()
        if sponsored in ctx.active_sponsorships:
            self.set_inner_result(
                rc.BEGIN_SPONSORING_FUTURE_RESERVES_ALREADY_SPONSORED)
            return False
        # no chains: our sponsor-to-be can't itself be sponsored, and the
        # sponsored account can't be sponsoring anyone (reference:
        # RECURSIVE checks)
        if source in ctx.active_sponsorships or any(
                sp.to_bytes() == sponsored
                for sp in ctx.active_sponsorships.values()):
            self.set_inner_result(
                rc.BEGIN_SPONSORING_FUTURE_RESERVES_RECURSIVE)
            return False
        ctx.active_sponsorships[sponsored] = self.source_id
        self.set_inner_result(
            rc.BEGIN_SPONSORING_FUTURE_RESERVES_SUCCESS)
        return True


@register_op(OperationType.END_SPONSORING_FUTURE_RESERVES)
class EndSponsoringFutureReservesOpFrame(OperationFrame):

    def do_check_valid(self, header, ledger_version: int) -> bool:
        return True

    def do_apply(self, ltx, header, ctx) -> bool:
        rc = EndSponsoringFutureReservesResultCode
        source = self.source_id.to_bytes()
        if source not in ctx.active_sponsorships:
            self.set_inner_result(
                rc.END_SPONSORING_FUTURE_RESERVES_NOT_SPONSORED)
            return False
        del ctx.active_sponsorships[source]
        self.set_inner_result(
            rc.END_SPONSORING_FUTURE_RESERVES_SUCCESS)
        return True


def _entry_owner_id(key: LedgerKey):
    t = key.disc
    if t == LedgerEntryType.ACCOUNT:
        return key.value.accountID
    if t == LedgerEntryType.TRUSTLINE:
        return key.value.accountID
    if t == LedgerEntryType.OFFER:
        return key.value.sellerID
    if t == LedgerEntryType.DATA:
        return key.value.accountID
    return None  # claimable balances have no owner


@register_op(OperationType.REVOKE_SPONSORSHIP)
class RevokeSponsorshipOpFrame(OperationFrame):

    def do_check_valid(self, header, ledger_version: int) -> bool:
        return True

    def do_apply(self, ltx_outer, header_outer, ctx) -> bool:
        with LedgerTxn(ltx_outer) as ltx:
            if self.body.disc == \
                    RevokeSponsorshipType.REVOKE_SPONSORSHIP_LEDGER_ENTRY:
                ok = self._revoke_entry(ltx, ctx)
            else:
                ok = self._revoke_signer(ltx, ctx)
            if ok:
                ltx.commit()
            return ok

    # ------------------------------------------------------------- entries --
    def _revoke_entry(self, ltx, ctx) -> bool:
        rc = RevokeSponsorshipResultCode
        key = self.body.value
        header = ltx.load_header()
        le = ltx.load(key)
        if le is None:
            self.set_inner_result(rc.REVOKE_SPONSORSHIP_DOES_NOT_EXIST)
            return False
        owner_id = _entry_owner_id(key)
        old_sponsor = get_sponsoring_id(le)
        was_sponsored = old_sponsor is not None
        mult = reserve_multiplier(le)

        # permission (reference: source must be the current payer)
        if was_sponsored:
            if old_sponsor.to_bytes() != self.source_id.to_bytes():
                self.set_inner_result(rc.REVOKE_SPONSORSHIP_NOT_SPONSOR)
                return False
        else:
            if owner_id is None or \
                    owner_id.to_bytes() != self.source_id.to_bytes():
                self.set_inner_result(rc.REVOKE_SPONSORSHIP_NOT_SPONSOR)
                return False

        new_sponsor = None
        if owner_id is not None:
            new_sponsor = ctx.sponsor_for(owner_id)
        elif key.disc == LedgerEntryType.CLAIMABLE_BALANCE:
            # CBs can only be transferred to another sponsor
            new_sponsor = ctx.active_sponsorships.get(
                self.source_id.to_bytes())
            if new_sponsor is None:
                self.set_inner_result(
                    rc.REVOKE_SPONSORSHIP_ONLY_TRANSFERABLE)
                return False

        # release the old payer
        if was_sponsored:
            sp_le = ltx.load(LedgerKey.account(old_sponsor))
            if sp_le is not None:
                v2 = ensure_account_ext_v2(sp_le.data.value)
                v2.numSponsoring = max(0, v2.numSponsoring - mult)
            if owner_id is not None:
                own_le = ltx.load(LedgerKey.account(owner_id))
                if own_le is not None:
                    v2 = ensure_account_ext_v2(own_le.data.value)
                    v2.numSponsored = max(0, v2.numSponsored - mult)

        if new_sponsor is not None:
            # transfer: the new sponsor pays
            sp_le = ltx.load(LedgerKey.account(new_sponsor))
            if sp_le is None or not _available_for_reserve(
                    header, sp_le.data.value, mult):
                self.set_inner_result(rc.REVOKE_SPONSORSHIP_LOW_RESERVE)
                return False
            v2 = ensure_account_ext_v2(sp_le.data.value)
            v2.numSponsoring += mult
            if owner_id is not None:
                own_le = ltx.load(LedgerKey.account(owner_id))
                ov2 = ensure_account_ext_v2(own_le.data.value)
                ov2.numSponsored += mult
            set_sponsoring_id(le, new_sponsor)
        else:
            # remove: the owner pays its own reserve again
            own_le = ltx.load(LedgerKey.account(owner_id))
            if own_le is None or not _available_for_reserve(
                    header, own_le.data.value, mult):
                self.set_inner_result(rc.REVOKE_SPONSORSHIP_LOW_RESERVE)
                return False
            set_sponsoring_id(le, None)
        self.set_inner_result(rc.REVOKE_SPONSORSHIP_SUCCESS)
        return True

    # ------------------------------------------------------------- signers --
    def _revoke_signer(self, ltx, ctx) -> bool:
        rc = RevokeSponsorshipResultCode
        header = ltx.load_header()
        target = self.body.value
        acc_le = ltx.load(LedgerKey.account(target.accountID))
        if acc_le is None:
            self.set_inner_result(rc.REVOKE_SPONSORSHIP_DOES_NOT_EXIST)
            return False
        acc: AccountEntry = acc_le.data.value
        idx = None
        for i, s in enumerate(acc.signers):
            if s.key.to_bytes() == target.signerKey.to_bytes():
                idx = i
                break
        if idx is None:
            self.set_inner_result(rc.REVOKE_SPONSORSHIP_DOES_NOT_EXIST)
            return False
        from ..sponsorship import ensure_account_ext_v2 as _v2
        v2 = _v2(acc)
        sponsors = v2.ext.value.signerSponsoringIDs \
            if v2.ext.disc == 2 else None
        old_sponsor = sponsors[idx] if sponsors is not None else None

        if old_sponsor is not None:
            if old_sponsor.to_bytes() != self.source_id.to_bytes():
                self.set_inner_result(rc.REVOKE_SPONSORSHIP_NOT_SPONSOR)
                return False
        else:
            if target.accountID.to_bytes() != self.source_id.to_bytes():
                self.set_inner_result(rc.REVOKE_SPONSORSHIP_NOT_SPONSOR)
                return False

        new_sponsor = ctx.sponsor_for(target.accountID)
        if old_sponsor is not None:
            sp_le = ltx.load(LedgerKey.account(old_sponsor))
            if sp_le is not None:
                sv2 = _v2(sp_le.data.value)
                sv2.numSponsoring = max(0, sv2.numSponsoring - 1)
            v2.numSponsored = max(0, v2.numSponsored - 1)
        if new_sponsor is not None:
            sp_le = ltx.load(LedgerKey.account(new_sponsor))
            if sp_le is None or not _available_for_reserve(
                    header, sp_le.data.value, 1):
                self.set_inner_result(rc.REVOKE_SPONSORSHIP_LOW_RESERVE)
                return False
            sv2 = _v2(sp_le.data.value)
            sv2.numSponsoring += 1
            v2.numSponsored += 1
            if sponsors is not None:
                sponsors[idx] = new_sponsor
        else:
            if not _available_for_reserve(header, acc, 1):
                self.set_inner_result(rc.REVOKE_SPONSORSHIP_LOW_RESERVE)
                return False
            if sponsors is not None:
                sponsors[idx] = None
        self.set_inner_result(rc.REVOKE_SPONSORSHIP_SUCCESS)
        return True
