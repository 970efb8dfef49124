"""Trustline operations: ChangeTrust, AllowTrust, SetTrustLineFlags.

Reference: transactions/ChangeTrustOpFrame.cpp,
AllowTrustOpFrame.cpp, SetTrustLineFlagsOpFrame.cpp and the shared
TrustFlagsOpFrameBase.cpp (LOW threshold :22-25; auth-revocation pulls
the trustor's offers, :28-45). Pool-share trustlines are wired through
`pool_trust` hooks (liquidity-pool wave).
"""

from __future__ import annotations

from ...xdr.ledger_entries import (AccountFlags, AssetType, LedgerEntry,
                                   LedgerEntryType, LedgerKey,
                                   TrustLineAsset, TrustLineEntry,
                                   TrustLineFlags, _LedgerEntryData)
from ...xdr.transaction import OperationType
from ...xdr.results import (
    AllowTrustResultCode, ChangeTrustResultCode, OperationResultCode,
    SetTrustLineFlagsResultCode,
)
from .. import liabilities, tx_utils
from ..operation_frame import OperationFrame, ThresholdLevel, register_op
from ..sponsorship import (ApplyContext, SponsorshipResult,
                           create_entry_with_possible_sponsorship,
                           remove_entry_with_possible_sponsorship)

INT64_MAX = 2**63 - 1

TRUSTLINE_AUTH_FLAGS = (TrustLineFlags.AUTHORIZED_FLAG |
                        TrustLineFlags.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG)
ALL_TRUSTLINE_FLAGS = (TRUSTLINE_AUTH_FLAGS |
                       TrustLineFlags.TRUSTLINE_CLAWBACK_ENABLED_FLAG)


def trustline_flag_is_valid(flags: int, ledger_version: int) -> bool:
    """No unknown bits and not both auth levels at once (reference:
    TransactionUtils trustLineFlagIsValid/trustLineFlagAuthIsValid)."""
    mask = ALL_TRUSTLINE_FLAGS if ledger_version >= 17 else \
        TRUSTLINE_AUTH_FLAGS
    if flags & ~mask:
        return False
    both = (TrustLineFlags.AUTHORIZED_FLAG |
            TrustLineFlags.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG)
    return (flags & both) != both


def _change_trust_asset_to_tla(line) -> TrustLineAsset:
    if line.disc == AssetType.ASSET_TYPE_POOL_SHARE:
        from ..pool_trust import pool_id_for_params
        return TrustLineAsset(AssetType.ASSET_TYPE_POOL_SHARE,
                              pool_id_for_params(line.value.value))
    return TrustLineAsset(line.disc, line.value)


def _is_issuer_of(source_id, line) -> bool:
    if line.disc in (AssetType.ASSET_TYPE_NATIVE,
                     AssetType.ASSET_TYPE_POOL_SHARE):
        return False
    return line.value.issuer.to_bytes() == source_id.to_bytes()


@register_op(OperationType.CHANGE_TRUST)
class ChangeTrustOpFrame(OperationFrame):

    def do_check_valid(self, header, ledger_version: int) -> bool:
        b = self.body
        if b.limit < 0:
            self.set_inner_result(ChangeTrustResultCode.CHANGE_TRUST_MALFORMED)
            return False
        if not self._line_asset_valid(b.line, ledger_version):
            self.set_inner_result(ChangeTrustResultCode.CHANGE_TRUST_MALFORMED)
            return False
        if b.line.disc == AssetType.ASSET_TYPE_NATIVE:
            self.set_inner_result(ChangeTrustResultCode.CHANGE_TRUST_MALFORMED)
            return False
        if ledger_version >= 16 and _is_issuer_of(self.source_id, b.line):
            self.set_inner_result(ChangeTrustResultCode.CHANGE_TRUST_MALFORMED)
            return False
        return True

    @staticmethod
    def _line_asset_valid(line, ledger_version: int) -> bool:
        if line.disc == AssetType.ASSET_TYPE_POOL_SHARE:
            if ledger_version < 18:
                return False
            from ..pool_trust import pool_params_valid
            return pool_params_valid(line.value)
        from ...xdr.ledger_entries import Asset
        return tx_utils.is_asset_valid(
            Asset(line.disc, line.value)
            if line.disc != AssetType.ASSET_TYPE_NATIVE else Asset(line.disc))

    def do_apply(self, ltx, header, ctx: ApplyContext) -> bool:
        b = self.body
        if _is_issuer_of(self.source_id, b.line):
            self.set_inner_result(ChangeTrustResultCode.
                                  CHANGE_TRUST_SELF_NOT_ALLOWED)
            return False

        is_pool = b.line.disc == AssetType.ASSET_TYPE_POOL_SHARE
        tla = _change_trust_asset_to_tla(b.line)
        key = LedgerKey.trust_line(self.source_id, tla)
        tl_le = ltx.load(key)

        if tl_le is not None:
            tl: TrustLineEntry = tl_le.data.value
            min_limit = tl.balance + tx_utils._tl_buying_liabilities(tl)
            if b.limit < min_limit:
                self.set_inner_result(ChangeTrustResultCode.
                                      CHANGE_TRUST_INVALID_LIMIT)
                return False
            if b.limit == 0:
                if not is_pool and _pool_use_count(tl) != 0:
                    self.set_inner_result(ChangeTrustResultCode.
                                          CHANGE_TRUST_CANNOT_DELETE)
                    return False
                source_le = self.load_source_account(ltx)
                remove_entry_with_possible_sponsorship(
                    ltx, header, tl_le, source_le)
                ltx.erase(key)
                if is_pool:
                    from ..pool_trust import manage_pool_on_deleted_trustline
                    manage_pool_on_deleted_trustline(
                        ltx, tla, cp_params=b.line.value.value,
                        account_id=self.source_id)
            else:
                if not is_pool:
                    issuer = b.line.value.issuer
                    if not ltx.entry_exists(LedgerKey.account(issuer)):
                        self.set_inner_result(ChangeTrustResultCode.
                                              CHANGE_TRUST_NO_ISSUER)
                        return False
                tl.limit = b.limit
            self.set_inner_result(ChangeTrustResultCode.CHANGE_TRUST_SUCCESS)
            return True

        # --- new trustline ---
        if b.limit == 0:
            self.set_inner_result(ChangeTrustResultCode.
                                  CHANGE_TRUST_INVALID_LIMIT)
            return False
        flags = 0
        if not is_pool:
            issuer_le = ltx.load_without_record(
                LedgerKey.account(b.line.value.issuer))
            if issuer_le is None:
                self.set_inner_result(ChangeTrustResultCode.
                                      CHANGE_TRUST_NO_ISSUER)
                return False
            issuer_acc = issuer_le.data.value
            if not (issuer_acc.flags & AccountFlags.AUTH_REQUIRED_FLAG):
                flags = TrustLineFlags.AUTHORIZED_FLAG
            if issuer_acc.flags & AccountFlags.AUTH_CLAWBACK_ENABLED_FLAG:
                flags |= TrustLineFlags.TRUSTLINE_CLAWBACK_ENABLED_FLAG
        tl = TrustLineEntry(accountID=self.source_id, asset=tla,
                            balance=0, limit=b.limit, flags=flags)
        new_le = LedgerEntry(
            lastModifiedLedgerSeq=header.ledgerSeq,
            data=_LedgerEntryData(LedgerEntryType.TRUSTLINE, tl))
        if is_pool:
            from ..pool_trust import try_manage_pool_on_new_trustline
            if not try_manage_pool_on_new_trustline(self, ltx, header,
                                                    b.line, tla):
                return False
        source_le = self.load_source_account(ltx)
        sres = create_entry_with_possible_sponsorship(
            ltx, header, new_le, source_le, ctx)
        if sres == SponsorshipResult.LOW_RESERVE:
            self.set_inner_result(ChangeTrustResultCode.
                                  CHANGE_TRUST_LOW_RESERVE)
            return False
        if sres == SponsorshipResult.TOO_MANY_SUBENTRIES:
            self.set_outer_result(OperationResultCode.opTOO_MANY_SUBENTRIES)
            return False
        if sres == SponsorshipResult.TOO_MANY_SPONSORING:
            self.set_outer_result(OperationResultCode.opTOO_MANY_SPONSORING)
            return False
        ltx.create(new_le)
        self.set_inner_result(ChangeTrustResultCode.CHANGE_TRUST_SUCCESS)
        return True


def _pool_use_count(tl: TrustLineEntry) -> int:
    if tl.ext.disc == 1 and tl.ext.value.ext.disc == 2:
        return tl.ext.value.ext.value.liquidityPoolUseCount
    return 0


class _TrustFlagsOpFrameBase(OperationFrame):
    """Shared auth-flag machinery (reference:
    TrustFlagsOpFrameBase.cpp)."""

    def threshold_level(self) -> ThresholdLevel:
        return ThresholdLevel.LOW

    # subclass hooks -------------------------------------------------------
    def trustor(self):
        raise NotImplementedError

    def op_asset(self):
        raise NotImplementedError

    def expected_flag_value(self, tl: TrustLineEntry):
        """new flags value, or None + result already set on failure"""
        raise NotImplementedError

    def set_success(self):
        raise NotImplementedError

    def set_no_trust_line(self):
        raise NotImplementedError

    def set_cant_revoke(self):
        raise NotImplementedError

    def set_self_not_allowed(self):
        raise NotImplementedError

    # shared apply ---------------------------------------------------------
    def do_apply(self, ltx, header, ctx: ApplyContext) -> bool:
        if self.trustor().to_bytes() == self.source_id.to_bytes():
            self.set_self_not_allowed()
            return False
        source_le = self.load_source_account(ltx)
        auth_revocable = bool(source_le.data.value.flags &
                              AccountFlags.AUTH_REVOCABLE_FLAG)

        asset = self.op_asset()
        tla = TrustLineAsset.from_asset(asset)
        key = LedgerKey.trust_line(self.trustor(), tla)
        tl_le = ltx.load(key)
        if tl_le is None:
            self.set_no_trust_line()
            return False
        tl: TrustLineEntry = tl_le.data.value
        expected = self.expected_flag_value(tl)
        if expected is None:
            return False

        was_auth = tx_utils.is_authorized(tl)
        was_maintain = tx_utils.is_authorized_to_maintain_liabilities(tl)
        now_auth = bool(expected & TrustLineFlags.AUTHORIZED_FLAG)
        now_maintain = bool(expected & TRUSTLINE_AUTH_FLAGS)

        # any downgrade of authorization requires AUTH_REVOCABLE
        if (was_auth and not now_auth) or (was_maintain and not now_maintain):
            if not auth_revocable:
                self.set_cant_revoke()
                return False

        if was_maintain and not now_maintain:
            # full revocation pulls the trustor's offers in this asset
            liabilities.remove_offers_by_account_and_asset(
                ltx, header, self.trustor(), asset)
            tl_le = ltx.load(key)  # offers removal may have touched it
            tl = tl_le.data.value

        tl.flags = expected
        self.set_success()
        return True


@register_op(OperationType.ALLOW_TRUST)
class AllowTrustOpFrame(_TrustFlagsOpFrameBase):

    def trustor(self):
        return self.body.trustor

    def op_asset(self):
        from ...xdr.ledger_entries import Asset, AlphaNum4, AlphaNum12
        code = self.body.asset
        if code.disc == AssetType.ASSET_TYPE_CREDIT_ALPHANUM4:
            return Asset(AssetType.ASSET_TYPE_CREDIT_ALPHANUM4,
                         AlphaNum4(assetCode=code.value,
                                   issuer=self.source_id))
        return Asset(AssetType.ASSET_TYPE_CREDIT_ALPHANUM12,
                     AlphaNum12(assetCode=code.value, issuer=self.source_id))

    def do_check_valid(self, header, ledger_version: int) -> bool:
        b = self.body
        if b.asset.disc == AssetType.ASSET_TYPE_NATIVE:
            self.set_inner_result(AllowTrustResultCode.ALLOW_TRUST_MALFORMED)
            return False
        if b.authorize > TrustLineFlags.\
                AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG or \
                not trustline_flag_is_valid(b.authorize, ledger_version):
            self.set_inner_result(AllowTrustResultCode.ALLOW_TRUST_MALFORMED)
            return False
        if not tx_utils.is_asset_valid(self.op_asset()):
            self.set_inner_result(AllowTrustResultCode.ALLOW_TRUST_MALFORMED)
            return False
        if ledger_version >= 16 and \
                b.trustor.to_bytes() == self.source_id.to_bytes():
            self.set_inner_result(AllowTrustResultCode.ALLOW_TRUST_MALFORMED)
            return False
        return True

    def expected_flag_value(self, tl: TrustLineEntry):
        return (tl.flags & ~TRUSTLINE_AUTH_FLAGS) | self.body.authorize

    def set_success(self):
        self.set_inner_result(AllowTrustResultCode.ALLOW_TRUST_SUCCESS)

    def set_no_trust_line(self):
        self.set_inner_result(AllowTrustResultCode.ALLOW_TRUST_NO_TRUST_LINE)

    def set_cant_revoke(self):
        self.set_inner_result(AllowTrustResultCode.ALLOW_TRUST_CANT_REVOKE)

    def set_self_not_allowed(self):
        self.set_inner_result(AllowTrustResultCode.
                              ALLOW_TRUST_SELF_NOT_ALLOWED)


@register_op(OperationType.SET_TRUST_LINE_FLAGS)
class SetTrustLineFlagsOpFrame(_TrustFlagsOpFrameBase):

    def is_op_supported(self, header, ledger_version: int) -> bool:
        return ledger_version >= 17

    def trustor(self):
        return self.body.trustor

    def op_asset(self):
        return self.body.asset

    def do_check_valid(self, header, ledger_version: int) -> bool:
        b = self.body
        bad = SetTrustLineFlagsResultCode.SET_TRUST_LINE_FLAGS_MALFORMED
        if b.asset.disc == AssetType.ASSET_TYPE_NATIVE or \
                not tx_utils.is_asset_valid(b.asset):
            self.set_inner_result(bad)
            return False
        issuer = tx_utils.asset_issuer(b.asset)
        if issuer.to_bytes() != self.source_id.to_bytes():
            self.set_inner_result(bad)
            return False
        if b.trustor.to_bytes() == self.source_id.to_bytes():
            self.set_inner_result(bad)
            return False
        if b.setFlags & b.clearFlags:
            self.set_inner_result(bad)
            return False
        if not trustline_flag_is_valid(b.setFlags, ledger_version) or \
                (b.setFlags & TrustLineFlags.TRUSTLINE_CLAWBACK_ENABLED_FLAG):
            self.set_inner_result(bad)
            return False
        if b.clearFlags & ~ALL_TRUSTLINE_FLAGS:
            self.set_inner_result(bad)
            return False
        return True

    def expected_flag_value(self, tl: TrustLineEntry):
        expected = (tl.flags & ~self.body.clearFlags) | self.body.setFlags
        if not trustline_flag_is_valid(expected, 17):
            self.set_inner_result(SetTrustLineFlagsResultCode.
                                  SET_TRUST_LINE_FLAGS_INVALID_STATE)
            return None
        return expected

    def set_success(self):
        self.set_inner_result(SetTrustLineFlagsResultCode.
                              SET_TRUST_LINE_FLAGS_SUCCESS)

    def set_no_trust_line(self):
        self.set_inner_result(SetTrustLineFlagsResultCode.
                              SET_TRUST_LINE_FLAGS_NO_TRUST_LINE)

    def set_cant_revoke(self):
        self.set_inner_result(SetTrustLineFlagsResultCode.
                              SET_TRUST_LINE_FLAGS_CANT_REVOKE)

    def set_self_not_allowed(self):
        # unreachable: doCheckValid rejects trustor == source
        self.set_inner_result(SetTrustLineFlagsResultCode.
                              SET_TRUST_LINE_FLAGS_MALFORMED)
