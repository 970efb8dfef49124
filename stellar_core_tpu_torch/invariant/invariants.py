"""Invariant implementations.

Reference: src/invariant/{ConservationOfLumens,LedgerEntryIsValid,
AccountSubEntriesCountIsValid,LiabilitiesMatchOffers,OrderBookIsNotCrossed,
ConstantProductInvariant,SponsorshipCountIsValid,
BucketListIsConsistentWithDatabase}.cpp — behavior re-derived, not ported.
"""

from __future__ import annotations

from typing import Optional

from .manager import Invariant, OperationDelta
from ..xdr.ledger_entries import (AccountEntry, Asset, AssetType,
                                  LedgerEntryType, LedgerKey, TrustLineAsset,
                                  MAX_SIGNERS)
from ..tx.tx_utils import (buying_liabilities_account, is_asset_valid,
                           is_string_valid, selling_liabilities_account)

_INT64_MAX = (1 << 63) - 1


def _data(entry):
    return entry.data.value


def _etype(entry) -> LedgerEntryType:
    return entry.data.disc


def _native_amount(entry) -> int:
    """Native (XLM) lumens held by one ledger entry."""
    t = _etype(entry)
    if t == LedgerEntryType.ACCOUNT:
        return _data(entry).balance
    if t == LedgerEntryType.CLAIMABLE_BALANCE:
        cb = _data(entry)
        if cb.asset.disc == AssetType.ASSET_TYPE_NATIVE:
            return cb.amount
    return 0


class ConservationOfLumens(Invariant):
    """Sum of native-lumen deltas across entries must equal the
    totalCoins delta minus the feePool delta (reference:
    ConservationOfLumens.cpp: only INFLATION may change totalCoins)."""

    name = "ConservationOfLumens"

    def check_on_operation_apply(self, operation, result,
                                 delta: OperationDelta) -> Optional[str]:
        d_entries = 0
        for prev, curr in delta.entries.values():
            d_entries += ((_native_amount(curr) if curr else 0)
                          - (_native_amount(prev) if prev else 0))
        d_total = delta.header_curr.totalCoins - delta.header_prev.totalCoins
        d_fee = delta.header_curr.feePool - delta.header_prev.feePool
        # Inflation mints totalCoins into fee pool + payouts; every other
        # op must hold total lumens fixed (fee charging happens outside
        # the per-op delta, in processFeesSeqNums).
        if d_entries != d_total - d_fee:
            return (f"lumens not conserved: entry delta {d_entries}, "
                    f"totalCoins delta {d_total}, feePool delta {d_fee}")
        return None


class LedgerEntryIsValid(Invariant):
    """Structural validity of every created/updated entry (reference:
    LedgerEntryIsValid.cpp checkIsValid per entry type)."""

    name = "LedgerEntryIsValid"

    def check_on_operation_apply(self, operation, result,
                                 delta: OperationDelta) -> Optional[str]:
        version = delta.header_curr.ledgerVersion
        seq = delta.header_curr.ledgerSeq
        for _, curr in delta.entries.values():
            if curr is None:
                continue
            if curr.lastModifiedLedgerSeq != seq:
                return (f"entry lastModified {curr.lastModifiedLedgerSeq} "
                        f"!= ledgerSeq {seq}")
            err = self._check_entry(curr, version)
            if err:
                return err
        return None

    def _check_entry(self, entry, version: int) -> Optional[str]:
        t = _etype(entry)
        if t == LedgerEntryType.ACCOUNT:
            return self._check_account(_data(entry))
        if t == LedgerEntryType.TRUSTLINE:
            return self._check_trustline(_data(entry))
        if t == LedgerEntryType.OFFER:
            return self._check_offer(_data(entry))
        if t == LedgerEntryType.DATA:
            return self._check_data(_data(entry))
        if t == LedgerEntryType.CLAIMABLE_BALANCE:
            return self._check_claimable(_data(entry))
        if t == LedgerEntryType.LIQUIDITY_POOL:
            return self._check_pool(_data(entry))
        return None

    def _check_account(self, a: AccountEntry) -> Optional[str]:
        if a.balance < 0:
            return f"account balance {a.balance} < 0"
        if a.seqNum < 0:
            return "account seqNum < 0"
        if len(a.signers) > MAX_SIGNERS:
            return "too many signers"
        weights = [s.weight for s in a.signers]
        if any(w == 0 for w in weights):
            return "signer with zero weight"
        keys = [s.key.to_bytes() for s in a.signers]
        if sorted(keys) != keys or len(set(keys)) != len(keys):
            return "signers not sorted/unique"
        if not is_string_valid(a.homeDomain):
            return "invalid homeDomain"
        if buying_liabilities_account(a) < 0:
            return "account buying liabilities < 0"
        if selling_liabilities_account(a) < 0:
            return "account selling liabilities < 0"
        return None

    def _check_trustline(self, tl) -> Optional[str]:
        if tl.asset.disc == AssetType.ASSET_TYPE_NATIVE:
            return "trustline on native asset"
        if tl.balance < 0:
            return f"trustline balance {tl.balance} < 0"
        if tl.limit <= 0:
            return f"trustline limit {tl.limit} <= 0"
        if tl.balance > tl.limit:
            return f"trustline balance {tl.balance} > limit {tl.limit}"
        return None

    def _check_offer(self, o) -> Optional[str]:
        if o.offerID <= 0:
            return "offerID <= 0"
        if o.amount <= 0:
            return f"offer amount {o.amount} <= 0"
        if o.price.n <= 0 or o.price.d <= 0:
            return "non-positive offer price"
        if not is_asset_valid(o.selling) or not is_asset_valid(o.buying):
            return "offer with invalid asset"
        return None

    def _check_data(self, d) -> Optional[str]:
        if not is_string_valid(d.dataName) or len(d.dataName) == 0:
            return "invalid data name"
        return None

    def _check_claimable(self, cb) -> Optional[str]:
        if cb.amount <= 0:
            return f"claimable balance amount {cb.amount} <= 0"
        if len(cb.claimants) == 0:
            return "claimable balance with no claimants"
        return None

    def _check_pool(self, lp) -> Optional[str]:
        cp = lp.body.value
        if cp.reserveA < 0 or cp.reserveB < 0:
            return "negative pool reserve"
        if cp.totalPoolShares < 0:
            return "negative pool shares"
        if cp.poolSharesTrustLineCount < 0:
            return "negative pool trustline count"
        return None


class AccountSubEntriesCountIsValid(Invariant):
    """numSubEntries must move in lockstep with owned signers, trustlines,
    offers and data entries (reference:
    AccountSubEntriesCountIsValid.cpp)."""

    name = "AccountSubEntriesCountIsValid"

    def check_on_operation_apply(self, operation, result,
                                 delta: OperationDelta) -> Optional[str]:
        # per-account: delta(numSubEntries) - delta(signers) must equal
        # delta(owned trustlines + offers + data)
        change = {}

        def acc(aid_b: bytes):
            return change.setdefault(aid_b, [0, 0])  # [subentry+signer, owned]

        for kb, (prev, curr) in delta.entries.items():
            key = LedgerKey.from_bytes(kb)
            t = key.disc
            if t == LedgerEntryType.ACCOUNT:
                aid = key.value.accountID.to_bytes()
                c = acc(aid)
                if curr is not None:
                    c[0] += _data(curr).numSubEntries - len(_data(curr).signers)
                if prev is not None:
                    c[0] -= _data(prev).numSubEntries - len(_data(prev).signers)
            elif t in (LedgerEntryType.TRUSTLINE, LedgerEntryType.OFFER,
                       LedgerEntryType.DATA):
                if t == LedgerEntryType.OFFER:
                    aid = key.value.sellerID.to_bytes()
                else:
                    aid = key.value.accountID.to_bytes()
                c = acc(aid)
                # pool-share trustlines count double (reference: protocol 18)
                w = 1
                if (t == LedgerEntryType.TRUSTLINE
                        and key.value.asset.disc ==
                        AssetType.ASSET_TYPE_POOL_SHARE):
                    w = 2
                if curr is not None:
                    c[1] += w
                if prev is not None:
                    c[1] -= w
        for aid, (d_sub, d_owned) in change.items():
            if d_sub != d_owned:
                return (f"account subentry count delta {d_sub} != owned "
                        f"entry delta {d_owned}")
        return None


def _asset_key(a) -> bytes:
    return a.to_bytes()


class LiabilitiesMatchOffers(Invariant):
    """Per (account, asset): the sum of offer-implied liabilities must
    equal the recorded buying/selling liabilities delta-wise (reference:
    LiabilitiesMatchOffers.cpp, delta form)."""

    name = "LiabilitiesMatchOffers"

    def check_on_operation_apply(self, operation, result,
                                 delta: OperationDelta) -> Optional[str]:
        # accumulate liability deltas per (account, asset)
        deltas = {}

        def add(aid_b, asset, buying, selling):
            k = (aid_b, _asset_key(asset))
            d = deltas.setdefault(k, [0, 0])
            d[0] += buying
            d[1] += selling

        for kb, (prev, curr) in delta.entries.items():
            key = LedgerKey.from_bytes(kb)
            t = key.disc
            if t == LedgerEntryType.ACCOUNT:
                aid = key.value.accountID.to_bytes()
                native = Asset.native()
                for e, sign in ((prev, -1), (curr, +1)):
                    if e is None:
                        continue
                    a = _data(e)
                    add(aid, native, -sign * buying_liabilities_account(a),
                        -sign * selling_liabilities_account(a))
            elif t == LedgerEntryType.TRUSTLINE:
                if key.value.asset.disc == AssetType.ASSET_TYPE_POOL_SHARE:
                    continue
                aid = key.value.accountID.to_bytes()
                asset = _tl_asset_to_asset(key.value.asset)
                for e, sign in ((prev, -1), (curr, +1)):
                    if e is None:
                        continue
                    tl = _data(e)
                    add(aid, asset, -sign * _tl_buying(tl),
                        -sign * _tl_selling(tl))
            elif t == LedgerEntryType.OFFER:
                for e, sign in ((prev, -1), (curr, +1)):
                    if e is None:
                        continue
                    o = _data(e)
                    aid = o.sellerID.to_bytes()
                    add(aid, o.buying,
                        sign * _offer_buying_liabilities(o), 0)
                    add(aid, o.selling, 0,
                        sign * _offer_selling_liabilities(o))
        for (aid, ak), (b, s) in deltas.items():
            if b != 0 or s != 0:
                return (f"liabilities mismatch for account {aid.hex()[:16]} "
                        f"asset {ak.hex()[:16]}: buying {b}, selling {s}")
        return None


def _tl_buying(tl) -> int:
    ext = getattr(tl, "ext", None)
    if ext is not None and ext.disc == 1:
        return ext.value.liabilities.buying
    return 0


def _tl_selling(tl) -> int:
    ext = getattr(tl, "ext", None)
    if ext is not None and ext.disc == 1:
        return ext.value.liabilities.selling
    return 0


def _offer_buying_liabilities(o) -> int:
    # what the seller stands to receive: ceil(amount * n / d)
    return -(-o.amount * o.price.n // o.price.d)


def _offer_selling_liabilities(o) -> int:
    return o.amount


def _tl_asset_to_asset(tla: TrustLineAsset) -> Asset:
    return Asset.from_bytes(tla.to_bytes())


class OrderBookIsNotCrossed(Invariant):
    """After apply, for every traded asset pair the best bid must not
    cross the best ask (reference: OrderBookIsNotCrossed.cpp — test-only
    invariant in the reference, same here). Needs a live ltx snapshot, so
    it inspects only the offers in the delta against each other."""

    name = "OrderBookIsNotCrossed"

    def __init__(self, ltx_supplier=None):
        # ltx_supplier: callable returning an object with iter_offers()
        self._supplier = ltx_supplier

    def check_on_operation_apply(self, operation, result,
                                 delta: OperationDelta) -> Optional[str]:
        if self._supplier is None:
            return None
        books = {}
        for _, le in self._supplier().iter_offers():
            o = _data(le)
            k = (_asset_key(o.selling), _asset_key(o.buying))
            best = books.get(k)
            if best is None or (o.price.n * best.price.d
                                < best.price.n * o.price.d):
                books[k] = o
        for (sell, buy), o in books.items():
            rev = books.get((buy, sell))
            if rev is None:
                continue
            # crossed iff best_ab.price * best_ba.price < 1
            if (o.price.n * rev.price.n) < (o.price.d * rev.price.d):
                return (f"order book crossed for pair "
                        f"{sell.hex()[:8]}/{buy.hex()[:8]}")
        return None


class ConstantProductInvariant(Invariant):
    """AMM pools must never decrease their constant product k = A*B per
    pool-share (reference: ConstantProductInvariant.cpp)."""

    name = "ConstantProductInvariant"

    def check_on_operation_apply(self, operation, result,
                                 delta: OperationDelta) -> Optional[str]:
        for kb, (prev, curr) in delta.entries.items():
            if LedgerKey.from_bytes(kb).disc != LedgerEntryType.LIQUIDITY_POOL:
                continue
            if prev is None or curr is None:
                continue
            p = _data(prev).body.value
            c = _data(curr).body.value
            if p.totalPoolShares == c.totalPoolShares:
                # pure trade: product must not shrink
                if c.reserveA * c.reserveB < p.reserveA * p.reserveB:
                    return ("constant product decreased: "
                            f"{p.reserveA}*{p.reserveB} -> "
                            f"{c.reserveA}*{c.reserveB}")
        return None


class SponsorshipCountIsValid(Invariant):
    """numSponsored/numSponsoring must mirror sponsoringID annotations
    delta-wise (reference: SponsorshipCountIsValid.cpp)."""

    name = "SponsorshipCountIsValid"

    def check_on_operation_apply(self, operation, result,
                                 delta: OperationDelta) -> Optional[str]:
        d_sponsored = 0   # entries+signers that gained a sponsor
        d_sponsoring_claimed = {}  # per sponsor account
        d_counters_sponsored = {}  # per sponsored account

        def bump(dct, k, v):
            dct[k] = dct.get(k, 0) + v

        from ..tx.sponsorship import reserve_multiplier
        for kb, (prev, curr) in delta.entries.items():
            key = LedgerKey.from_bytes(kb)
            for e, sign in ((prev, -1), (curr, +1)):
                if e is None:
                    continue
                sid = _entry_sponsor(e)
                if sid is not None:
                    # same multiplier the apply path charges; claimable
                    # balances have no owner so never count as sponsored
                    # (reference: SponsorshipCountIsValid.cpp)
                    mult = reserve_multiplier(e)
                    if key.disc != LedgerEntryType.CLAIMABLE_BALANCE:
                        d_sponsored += sign * mult
                    bump(d_sponsoring_claimed, sid.to_bytes(), sign * mult)
                if key.disc == LedgerEntryType.ACCOUNT:
                    a = _data(e)
                    for sp in _signer_sponsors(a):
                        if sp is not None:
                            d_sponsored += sign
                            bump(d_sponsoring_claimed, sp.to_bytes(), sign)
            if key.disc == LedgerEntryType.ACCOUNT:
                for e, sign in ((prev, -1), (curr, +1)):
                    if e is None:
                        continue
                    a = _data(e)
                    bump(d_counters_sponsored, key.value.accountID.to_bytes(),
                         sign * _num_sponsored(a))
        total_counter_sponsored = sum(d_counters_sponsored.values())
        if d_sponsored != total_counter_sponsored:
            return (f"sponsored-entry delta {d_sponsored} != numSponsored "
                    f"counter delta {total_counter_sponsored}")
        # numSponsoring counters per account must match claims
        d_counters_sponsoring = {}
        for kb, (prev, curr) in delta.entries.items():
            key = LedgerKey.from_bytes(kb)
            if key.disc != LedgerEntryType.ACCOUNT:
                continue
            for e, sign in ((prev, -1), (curr, +1)):
                if e is None:
                    continue
                bump(d_counters_sponsoring, key.value.accountID.to_bytes(),
                     sign * _num_sponsoring(_data(e)))
        for aid, claimed in d_sponsoring_claimed.items():
            if claimed != d_counters_sponsoring.get(aid, 0):
                # the sponsor account may legitimately be outside the
                # delta only if its claim delta is zero
                return (f"numSponsoring delta mismatch for "
                        f"{aid.hex()[:16]}: entries claim {claimed}, "
                        f"counter {d_counters_sponsoring.get(aid, 0)}")
        for aid, cnt in d_counters_sponsoring.items():
            if cnt != d_sponsoring_claimed.get(aid, 0):
                return (f"numSponsoring counter moved without entries for "
                        f"{aid.hex()[:16]}")
        return None


def _entry_sponsor(entry):
    ext = entry.ext
    if ext.disc == 1 and ext.value.sponsoringID is not None:
        return ext.value.sponsoringID
    return None


def _signer_sponsors(a: AccountEntry):
    ext = a.ext
    if ext.disc == 1 and ext.value.ext.disc == 2:
        return list(ext.value.ext.value.signerSponsoringIDs)
    return []


def _num_sponsored(a: AccountEntry) -> int:
    ext = a.ext
    if ext.disc == 1 and ext.value.ext.disc == 2:
        return ext.value.ext.value.numSponsored
    return 0


def _num_sponsoring(a: AccountEntry) -> int:
    ext = a.ext
    if ext.disc == 1 and ext.value.ext.disc == 2:
        return ext.value.ext.value.numSponsoring
    return 0


class BucketListIsConsistentWithDatabase(Invariant):
    """On bucket apply during catchup, replayed entries must match what
    lands in the DB (reference: BucketListIsConsistentWithDatabase.cpp).
    Checked via a callback supplied by the catchup driver."""

    name = "BucketListIsConsistentWithDatabase"

    def __init__(self, db_lookup=None):
        self._lookup = db_lookup  # callable(kb) -> Optional[LedgerEntry]

    def check_on_bucket_apply(self, bucket_entries, ledger_seq: int,
                              level: int, is_curr: bool) -> Optional[str]:
        if self._lookup is None:
            return None
        from ..ledger.ledger_txn import entry_key_bytes
        for be in bucket_entries:
            if be.disc in (0, 1):  # LIVEENTRY / INITENTRY
                le = be.value
                got = self._lookup(entry_key_bytes(le))
                if got is None or got.to_bytes() != le.to_bytes():
                    return (f"bucket entry missing/mismatched in DB at "
                            f"level {level} seq {ledger_seq}")
        return None


def register_default_invariants(manager, order_book_supplier=None,
                                db_lookup=None) -> None:
    """Register the full reference set (reference:
    InvariantManagerImpl registration in ApplicationImpl)."""
    manager.register(ConservationOfLumens())
    manager.register(LedgerEntryIsValid())
    manager.register(AccountSubEntriesCountIsValid())
    manager.register(LiabilitiesMatchOffers())
    manager.register(SponsorshipCountIsValid())
    manager.register(ConstantProductInvariant())
    manager.register(OrderBookIsNotCrossed(order_book_supplier))
    manager.register(BucketListIsConsistentWithDatabase(db_lookup))
