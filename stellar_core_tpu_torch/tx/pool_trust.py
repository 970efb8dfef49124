"""Liquidity-pool lifecycle tied to pool-share trustlines.

Reference: transactions/ChangeTrustOpFrame.cpp
(tryManagePoolOnNewTrustLine / managePoolOnDeletedTrustLine /
tryIncrementPoolUseCount) and OfferExchange.cpp getPoolID:1371-1378 —
the pool LedgerEntry exists exactly while >=1 pool-share trustline
references it; each constituent credit-asset trustline tracks how many
pools use it via liquidityPoolUseCount (blocks deletion).
"""

from __future__ import annotations

from typing import Optional

from ..crypto.sha import sha256
from ..util.checks import releaseAssert
from ..xdr.ledger_entries import (AssetType, LedgerEntry, LedgerEntryType,
                                  LedgerKey, LiquidityPoolEntry,
                                  LiquidityPoolType, TrustLineAsset,
                                  TrustLineEntry, TrustLineEntryV1,
                                  TrustLineEntryExtensionV2, Liabilities,
                                  _LedgerEntryData)
from ..xdr.results import ChangeTrustResultCode
from . import tx_utils

LIQUIDITY_POOL_FEE_V18 = 30
INT32_MAX = 2**31 - 1
INT64_MAX = 2**63 - 1


def pool_id_for_params(cp_params) -> bytes:
    """PoolID = SHA256(xdr(LiquidityPoolParameters)) (reference:
    getPoolID, OfferExchange.cpp:1371; xdrSha256 of the params union)."""
    from ..xdr.transaction import LiquidityPoolParameters
    lpp = LiquidityPoolParameters(
        LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT, cp_params)
    return sha256(lpp.to_bytes())


def pool_id_for_assets(asset_a, asset_b,
                       fee: int = LIQUIDITY_POOL_FEE_V18) -> bytes:
    from ..xdr.ledger_entries import LiquidityPoolConstantProductParameters
    a, b = sorted([asset_a, asset_b], key=lambda x: x.to_bytes())
    return pool_id_for_params(LiquidityPoolConstantProductParameters(
        assetA=a, assetB=b, fee=fee))


def pool_params_valid(lpp) -> bool:
    """assetA < assetB strictly, both valid, canonical fee (reference:
    isAssetValid for ASSET_TYPE_POOL_SHARE in TransactionUtils)."""
    if lpp.disc != LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT:
        return False
    cp = lpp.value
    if cp.fee != LIQUIDITY_POOL_FEE_V18:
        return False
    for a in (cp.assetA, cp.assetB):
        if not tx_utils.is_asset_valid(a):
            return False
    return cp.assetA.to_bytes() < cp.assetB.to_bytes()


def prepare_trustline_ext_v2(tl: TrustLineEntry) -> TrustLineEntryExtensionV2:
    if tl.ext.disc == 0:
        tl.ext = type(tl.ext)(1, TrustLineEntryV1(
            liabilities=Liabilities(buying=0, selling=0)))
    v1 = tl.ext.value
    if v1.ext.disc == 0:
        v1.ext = type(v1.ext)(2, TrustLineEntryExtensionV2(
            liquidityPoolUseCount=0))
    return v1.ext.value


def load_pool(ltx, pool_id: bytes) -> Optional[LedgerEntry]:
    return ltx.load(LedgerKey.liquidity_pool(pool_id))


def _try_increment_use_count(op_frame, ltx, asset) -> bool:
    src = op_frame.source_id
    if asset.disc == AssetType.ASSET_TYPE_NATIVE:
        return True
    if tx_utils.asset_issuer(asset).to_bytes() == src.to_bytes():
        return True
    tl_le = tx_utils.load_trustline(ltx, src, asset)
    if tl_le is None:
        op_frame.set_inner_result(
            ChangeTrustResultCode.CHANGE_TRUST_TRUST_LINE_MISSING)
        return False
    tl = tl_le.data.value
    if not tx_utils.is_authorized_to_maintain_liabilities(tl):
        op_frame.set_inner_result(
            ChangeTrustResultCode.CHANGE_TRUST_NOT_AUTH_MAINTAIN_LIABILITIES)
        return False
    v2 = prepare_trustline_ext_v2(tl)
    releaseAssert(v2.liquidityPoolUseCount < INT32_MAX,
                  "liquidityPoolUseCount overflow")
    v2.liquidityPoolUseCount += 1
    return True


def _decrement_use_count(ltx, asset, account_id) -> None:
    if asset.disc == AssetType.ASSET_TYPE_NATIVE:
        return
    if tx_utils.asset_issuer(asset).to_bytes() == account_id.to_bytes():
        return
    tl_le = tx_utils.load_trustline(ltx, account_id, asset)
    if tl_le is None:
        return
    tl = tl_le.data.value
    if tl.ext.disc == 1 and tl.ext.value.ext.disc == 2:
        v2 = tl.ext.value.ext.value
        v2.liquidityPoolUseCount = max(0, v2.liquidityPoolUseCount - 1)


def try_manage_pool_on_new_trustline(op_frame, ltx, header, line,
                                     tla: TrustLineAsset) -> bool:
    """Create or ref-count the pool entry for a new pool-share trustline;
    sets the op result and returns False on failure."""
    if tla.disc != AssetType.ASSET_TYPE_POOL_SHARE:
        return True
    cp = line.value.value  # LiquidityPoolParameters -> constantProduct
    if not _try_increment_use_count(op_frame, ltx, cp.assetA):
        return False
    if not _try_increment_use_count(op_frame, ltx, cp.assetB):
        return False
    pool_le = load_pool(ltx, tla.value)
    if pool_le is not None:
        body = pool_le.data.value.body.value
        releaseAssert(body.poolSharesTrustLineCount < INT64_MAX,
                      "poolSharesTrustLineCount overflow")
        body.poolSharesTrustLineCount += 1
    else:
        from ..xdr.ledger_entries import (_LiquidityPoolBody,
                                          _LPConstantProduct)
        lp = LiquidityPoolEntry(
            liquidityPoolID=tla.value,
            body=_LiquidityPoolBody(
                LiquidityPoolType.LIQUIDITY_POOL_CONSTANT_PRODUCT,
                _LPConstantProduct(
                    params=cp, reserveA=0, reserveB=0, totalPoolShares=0,
                    poolSharesTrustLineCount=1)))
        ltx.create(LedgerEntry(
            lastModifiedLedgerSeq=header.ledgerSeq,
            data=_LedgerEntryData(LedgerEntryType.LIQUIDITY_POOL, lp)))
    return True


def manage_pool_on_deleted_trustline(ltx, tla: TrustLineAsset,
                                     cp_params=None, account_id=None) -> None:
    """Deref the pool when a pool-share trustline is deleted; erases the
    pool entry when the last trustline goes."""
    if tla.disc != AssetType.ASSET_TYPE_POOL_SHARE:
        return
    pool_le = load_pool(ltx, tla.value)
    releaseAssert(pool_le is not None, "liquidity pool is missing")
    body = pool_le.data.value.body.value
    if cp_params is None:
        cp_params = body.params
    if account_id is not None:
        _decrement_use_count(ltx, cp_params.assetA, account_id)
        _decrement_use_count(ltx, cp_params.assetB, account_id)
    body.poolSharesTrustLineCount -= 1
    if body.poolSharesTrustLineCount == 0:
        ltx.erase(LedgerKey.liquidity_pool(tla.value))
