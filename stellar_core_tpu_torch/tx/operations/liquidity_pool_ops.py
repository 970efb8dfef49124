"""Liquidity pool deposit/withdraw (constant-product AMM).

Reference: transactions/LiquidityPoolDepositOpFrame.cpp (empty-pool
bootstrap from maxAmountA/B with price bounds, proportional deposit
against reserves otherwise, shares = min over both axes),
LiquidityPoolWithdrawOpFrame.cpp (pro-rata redemption with minimums).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

from ...xdr.ledger_entries import (AssetType, LedgerKey, Price,
                                   TrustLineAsset)
from ...xdr.results import (LiquidityPoolDepositResultCode,
                            LiquidityPoolWithdrawResultCode)
from ...xdr.transaction import OperationType
from ...ledger.ledger_txn import LedgerTxn
from .. import tx_utils
from ..offer_math import Rounding, big_divide
from ..operation_frame import OperationFrame, register_op
from ..pool_trust import load_pool

INT64_MAX = 2**63 - 1


def _pool_share_tl(ltx, account_id, pool_id: bytes):
    key = LedgerKey.trust_line(
        account_id, TrustLineAsset(AssetType.ASSET_TYPE_POOL_SHARE,
                                   pool_id))
    return ltx.load(key)


def _asset_balance_available(ltx, header, account_id, asset) -> int:
    from ..offer_exchange import can_sell_at_most
    return can_sell_at_most(ltx, header, account_id, asset)


def _credit(ltx, header, account_id, asset, amount) -> bool:
    from ..offer_exchange import _add_asset_balance
    return _add_asset_balance(ltx, header, account_id, asset, amount)


@register_op(OperationType.LIQUIDITY_POOL_DEPOSIT)
class LiquidityPoolDepositOpFrame(OperationFrame):

    def do_check_valid(self, header, ledger_version: int) -> bool:
        b = self.body
        rc = LiquidityPoolDepositResultCode
        if b.maxAmountA <= 0 or b.maxAmountB <= 0 or \
                b.minPrice.n <= 0 or b.minPrice.d <= 0 or \
                b.maxPrice.n <= 0 or b.maxPrice.d <= 0:
            self.set_inner_result(rc.LIQUIDITY_POOL_DEPOSIT_MALFORMED)
            return False
        if b.minPrice.n * b.maxPrice.d > b.maxPrice.n * b.minPrice.d:
            self.set_inner_result(rc.LIQUIDITY_POOL_DEPOSIT_MALFORMED)
            return False
        return True

    def is_op_supported(self, header, ledger_version: int) -> bool:
        # reference: LiquidityPoolDepositOpFrame::isOpSupported —
        # protocol 18+ AND the voted disable flag is clear
        from ...xdr.ledger import LedgerHeaderFlags
        return ledger_version >= 18 and not (
            tx_utils.header_flags(header) &
            LedgerHeaderFlags.DISABLE_LIQUIDITY_POOL_DEPOSIT_FLAG)

    def do_apply(self, ltx_outer, header_outer, ctx) -> bool:
        b = self.body
        rc = LiquidityPoolDepositResultCode
        with LedgerTxn(ltx_outer) as ltx:
            header = ltx.load_header()
            pool_id = bytes(b.liquidityPoolID)
            ps_tl_le = _pool_share_tl(ltx, self.source_id, pool_id)
            if ps_tl_le is None:
                self.set_inner_result(rc.LIQUIDITY_POOL_DEPOSIT_NO_TRUST)
                return False
            pool_le = load_pool(ltx, pool_id)
            if pool_le is None:
                self.set_inner_result(rc.LIQUIDITY_POOL_DEPOSIT_NO_TRUST)
                return False
            cp = pool_le.data.value.body.value
            asset_a, asset_b = cp.params.assetA, cp.params.assetB

            # trustlines/auth for both assets (issuer accounts exempt)
            for asset in (asset_a, asset_b):
                if asset.disc == AssetType.ASSET_TYPE_NATIVE:
                    continue
                if tx_utils.asset_issuer(asset).to_bytes() == \
                        self.source_id.to_bytes():
                    continue
                tl = tx_utils.load_trustline(ltx, self.source_id, asset)
                if tl is None:
                    self.set_inner_result(
                        rc.LIQUIDITY_POOL_DEPOSIT_NO_TRUST)
                    return False
                if not tx_utils.is_authorized(tl.data.value):
                    self.set_inner_result(
                        rc.LIQUIDITY_POOL_DEPOSIT_NOT_AUTHORIZED)
                    return False

            if cp.totalPoolShares == 0:
                amount_a, amount_b = b.maxAmountA, b.maxAmountB
                # price = A/B must be within bounds
                if amount_a * b.minPrice.d < b.minPrice.n * amount_b or \
                        amount_a * b.maxPrice.d > b.maxPrice.n * amount_b:
                    self.set_inner_result(
                        rc.LIQUIDITY_POOL_DEPOSIT_BAD_PRICE)
                    return False
                total_shares = math.isqrt(amount_a * amount_b)
            else:
                # proportional to reserves (reference: bigDivide ROUND_DOWN
                # on each axis, pick the binding one)
                amount_b = big_divide(b.maxAmountA, cp.reserveB,
                                      cp.reserveA, Rounding.ROUND_UP)
                if amount_b <= b.maxAmountB:
                    amount_a = b.maxAmountA
                else:
                    amount_b = b.maxAmountB
                    amount_a = big_divide(b.maxAmountB, cp.reserveA,
                                          cp.reserveB, Rounding.ROUND_UP)
                    if amount_a > b.maxAmountA:
                        self.set_inner_result(
                            rc.LIQUIDITY_POOL_DEPOSIT_BAD_PRICE)
                        return False
                if amount_a <= 0 or amount_b <= 0:
                    self.set_inner_result(
                        rc.LIQUIDITY_POOL_DEPOSIT_BAD_PRICE)
                    return False
                # price bounds on the actual deposit ratio
                if amount_a * b.minPrice.d < b.minPrice.n * amount_b or \
                        amount_a * b.maxPrice.d > b.maxPrice.n * amount_b:
                    self.set_inner_result(
                        rc.LIQUIDITY_POOL_DEPOSIT_BAD_PRICE)
                    return False
                shares_a = big_divide(cp.totalPoolShares, amount_a,
                                      cp.reserveA, Rounding.ROUND_DOWN)
                shares_b = big_divide(cp.totalPoolShares, amount_b,
                                      cp.reserveB, Rounding.ROUND_DOWN)
                total_shares = min(shares_a, shares_b)

            if total_shares <= 0:
                self.set_inner_result(rc.LIQUIDITY_POOL_DEPOSIT_BAD_PRICE)
                return False
            if cp.totalPoolShares > INT64_MAX - total_shares or \
                    cp.reserveA > INT64_MAX - amount_a or \
                    cp.reserveB > INT64_MAX - amount_b:
                self.set_inner_result(rc.LIQUIDITY_POOL_DEPOSIT_POOL_FULL)
                return False

            # funding
            for asset, amount in ((asset_a, amount_a),
                                  (asset_b, amount_b)):
                if _asset_balance_available(ltx, header, self.source_id,
                                            asset) < amount:
                    self.set_inner_result(
                        rc.LIQUIDITY_POOL_DEPOSIT_UNDERFUNDED)
                    return False
            ps_tl = ps_tl_le.data.value
            if tx_utils.max_receive_trustline(ps_tl) < total_shares:
                self.set_inner_result(rc.LIQUIDITY_POOL_DEPOSIT_LINE_FULL)
                return False

            for asset, amount in ((asset_a, amount_a),
                                  (asset_b, amount_b)):
                if not _credit(ltx, header, self.source_id, asset,
                               -amount):
                    self.set_inner_result(
                        rc.LIQUIDITY_POOL_DEPOSIT_UNDERFUNDED)
                    return False
            cp.reserveA += amount_a
            cp.reserveB += amount_b
            cp.totalPoolShares += total_shares
            ps_tl.balance += total_shares
            self.set_inner_result(rc.LIQUIDITY_POOL_DEPOSIT_SUCCESS)
            ltx.commit()
            return True


@register_op(OperationType.LIQUIDITY_POOL_WITHDRAW)
class LiquidityPoolWithdrawOpFrame(OperationFrame):

    def do_check_valid(self, header, ledger_version: int) -> bool:
        b = self.body
        rc = LiquidityPoolWithdrawResultCode
        if b.amount <= 0 or b.minAmountA < 0 or b.minAmountB < 0:
            self.set_inner_result(rc.LIQUIDITY_POOL_WITHDRAW_MALFORMED)
            return False
        return True

    def is_op_supported(self, header, ledger_version: int) -> bool:
        from ...xdr.ledger import LedgerHeaderFlags
        return ledger_version >= 18 and not (
            tx_utils.header_flags(header) &
            LedgerHeaderFlags.DISABLE_LIQUIDITY_POOL_WITHDRAWAL_FLAG)

    def do_apply(self, ltx_outer, header_outer, ctx) -> bool:
        b = self.body
        rc = LiquidityPoolWithdrawResultCode
        with LedgerTxn(ltx_outer) as ltx:
            header = ltx.load_header()
            pool_id = bytes(b.liquidityPoolID)
            ps_tl_le = _pool_share_tl(ltx, self.source_id, pool_id)
            if ps_tl_le is None:
                self.set_inner_result(rc.LIQUIDITY_POOL_WITHDRAW_NO_TRUST)
                return False
            ps_tl = ps_tl_le.data.value
            if ps_tl.balance < b.amount:
                self.set_inner_result(
                    rc.LIQUIDITY_POOL_WITHDRAW_UNDERFUNDED)
                return False
            pool_le = load_pool(ltx, pool_id)
            if pool_le is None:
                self.set_inner_result(rc.LIQUIDITY_POOL_WITHDRAW_NO_TRUST)
                return False
            cp = pool_le.data.value.body.value

            amount_a = big_divide(cp.reserveA, b.amount,
                                  cp.totalPoolShares, Rounding.ROUND_DOWN)
            amount_b = big_divide(cp.reserveB, b.amount,
                                  cp.totalPoolShares, Rounding.ROUND_DOWN)
            if amount_a < b.minAmountA or amount_b < b.minAmountB:
                self.set_inner_result(
                    rc.LIQUIDITY_POOL_WITHDRAW_UNDER_MINIMUM)
                return False

            for asset, amount in ((cp.params.assetA, amount_a),
                                  (cp.params.assetB, amount_b)):
                if amount == 0:
                    continue
                if not _credit(ltx, header, self.source_id, asset,
                               amount):
                    self.set_inner_result(
                        rc.LIQUIDITY_POOL_WITHDRAW_LINE_FULL)
                    return False
            cp.reserveA -= amount_a
            cp.reserveB -= amount_b
            cp.totalPoolShares -= b.amount
            ps_tl.balance -= b.amount
            self.set_inner_result(rc.LIQUIDITY_POOL_WITHDRAW_SUCCESS)
            ltx.commit()
            return True
